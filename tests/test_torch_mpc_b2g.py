"""One B2G + Z1 arm tick (whole_body_rnea, N=3, hot config, batch 2) of
the port against tpu_locoman's batched tick, from the same carry — the arm
EE and external-force rows through the whole solver. The JAX tick is
recorded (tests/test_torch_mpc.py's ROLLOUTS). Measured gap on the
CPU: x within 8.2e-5, max_violation within 2.3e-4 absolute; the
tolerances are test_torch_mpc.py's (x atol 1e-3, max_violation 5% + 1e-3,
alpha and status equal)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import numpy as np  # noqa: E402

from test_torch_mpc import _check_tick, _rollout_pair  # noqa: E402


def test_b2g_tick_matches_jax():
    targets = np.array([[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0]],
                       np.float32)
    ticks = list(_rollout_pair("B2G", 3, 1, targets))
    assert len(ticks) == 1
    _check_tick(*ticks[0])
