"""The port's native runtime bindings (``tpu_locoman_torch.native``), the
counterpart of tests/test_native.py: the C++ gait, schedule and packing
plumbing against the port's own Python/torch implementations, built into
the port's build directory and never into native/."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tpu_locoman_torch import native  # noqa: E402
from tpu_locoman_torch.gait import GaitSequence, get_spline_vel_z  # noqa: E402
from tpu_locoman_torch.mpc import geometric_dts  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def build_lib():
    native.lib()  # builds on first use


def test_library_lives_in_the_port_build_directory():
    path = native.library_path()
    assert os.path.exists(path)
    assert os.sep + "_build" + os.sep in path
    assert os.path.dirname(os.path.dirname(path)).endswith(
        os.path.join("tpu_locoman_torch", "_build"))


def test_geometric_dts_parity():
    for dt_min, dt_max, nodes in [(0.01, 0.08, 14), (0.02, 0.05, 8)]:
        c = native.geometric_dts(dt_min, dt_max, nodes)
        py = geometric_dts(dt_min, dt_max, nodes, device="cpu").numpy()
        np.testing.assert_allclose(c, py, rtol=1e-6)


def test_gait_schedule_parity():
    dts = native.geometric_dts(0.01, 0.08, 14)
    for gait, period in [("trot", 0.8), ("walk", 0.6), ("stand", 0.5)]:
        gs = GaitSequence(gait, period)
        t0s = np.array([0.0, 0.17, 0.43, 1.21], np.float32)
        c_p, s_p = gs.get_gait_schedule(torch.tensor(t0s),
                                        torch.tensor(dts, dtype=torch.float32))
        for k, t0 in enumerate(t0s):
            c_c, s_c = native.gait_schedule(gait, period, float(t0), dts)
            np.testing.assert_array_equal(c_c, c_p[k].numpy().T)
            np.testing.assert_allclose(s_c, s_p[k].numpy().T, atol=2e-5)


def test_spline_vel_z_parity():
    for phase in [0.0, 0.2, 0.49, 0.51, 0.8, 0.99]:
        c = native.spline_vel_z(phase, 0.4, 0.07, 0.1, -0.2)
        p = float(get_spline_vel_z(torch.tensor(phase), 0.4, 0.07, 0.1,
                                   -0.2))
        np.testing.assert_allclose(c, p, atol=1e-5)


def test_pack_params_layout_from_tensors():
    rng = np.random.default_rng(0)
    x = rng.normal(size=49)
    contact = rng.integers(0, 2, size=(4, 14)).astype(float)
    swing = rng.uniform(size=(4, 14))
    bv, ef, av = rng.normal(size=6), rng.normal(size=3), rng.normal(size=3)
    tau = rng.normal(size=18)
    out = native.pack_params(torch.tensor(x), contact, swing, bv, ef, av,
                             torch.tensor(tau))
    assert out.shape == (49 + 8 * 14 + 12 + 18,)
    np.testing.assert_allclose(out[:49], x)
    np.testing.assert_allclose(out[49:49 + 56], contact.ravel())
    np.testing.assert_allclose(out[-18:], tau)


def test_state_ring():
    ring = native.StateRing(width=5, slots=4)
    v, seq = ring.read_latest()
    assert v is None and seq == 0
    for i in range(10):
        ring.push(np.full(5, float(i)))
    v, seq = ring.read_latest()
    assert seq == 10
    np.testing.assert_allclose(v, np.full(5, 9.0))
