"""Replays of the JAX fixtures of this slice's paths on the port's plain
path (the CPU): the flagship with the factorizer "sequential", a
Ruiz-scaled cold start (examples/run_mpc.py's defaults with
scaling_iters=3) and B2 with the front payload, each B2G/B2 N=14, batch 2,
written by tools/make_torch_golden.py --case sequential|scaled|b2.

The replay is chip_smoke.replay_golden, the same function and tolerances
the card's phases 17-20 apply; each fixture carries its "spread", JAX with
another factorizer against it (--against), stated below. ``-m slow`` adds
the live-JAX check that each committed fixture is current."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tpu_locoman_torch import convert  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

# (fixture, the port's factorizer on the plain path, setup fields)
CASES = {
    "sequential": (chip_smoke.GOLDEN_SEQ, "sequential",
                   dict(robot="B2G", sqp_iters=1, admm_iters=10, corrector=5,
                        factorizer="sequential")),
    "scaled": (chip_smoke.GOLDEN_SCALED, "cholinv",
               dict(robot="B2G", sqp_iters=2, admm_iters=100, corrector=0,
                    ls_trials=8, scaling_iters=3, factorizer="cholinv")),
    "b2": (chip_smoke.GOLDEN_B2, "cholinv",
           dict(robot="B2", robot_kwargs={"payload": "front"}, sqp_iters=1,
                admm_iters=10, corrector=5, factorizer="cholinv")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixture_setup(case):
    path, _, fields = CASES[case]
    gold = convert.load_golden(path)
    s = gold["setup"]
    for k, v in fields.items():
        assert s[k] == v, k
    assert s["nodes"] == 14 and len(gold["ticks"]) == s["ticks"]
    assert gold["spread"]["factorizer"] != s["factorizer"]
    for tick in gold["ticks"]:
        assert tick["x"].shape[0] == 2 and np.all(np.isfinite(tick["x"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_golden_replay_plain_path(case):
    """Within the hot-config replay bounds (x 1e-3, 40% + 1e-3 per tick,
    10% on the rollout mean, alpha and status equal). JAX against itself
    (the fixture's spread): "sequential" fixture, JAX "cholinv" 3.2e-4 in
    x and 12.9% per tick; the others in their files. The port on the CPU:
    "sequential" 4.9e-4 in x and 14.7% per tick."""
    path, fz, _ = CASES[case]
    gx, gv, grel, ticks, batch = chip_smoke.replay_golden(
        torch.device("cpu"), fz, path)
    assert batch == 2 and gx <= 1e-3 and grel <= 0.1


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CASES))
def test_fixture_reproduces_from_jax(case):
    """Regenerate each fixture's first two ticks with JAX on the CPU (a
    B2G/B2 N=14 jit: a minute or more each) and check the committed file
    is current."""
    import jax.numpy as jnp

    from tpu_locoman import parallel as jpar

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_torch_golden

    path = CASES[case][0]
    gold = convert.load_golden(path)
    s = gold["setup"]
    mpc = make_torch_golden.make_mpc(s)
    carry = jpar.batched_init(mpc, 2)
    step = jpar.batched_step(mpc, donate=False)
    for k in range(2):
        carry, _ = step(carry, jnp.float32(k * s["dt_min"]),
                        jnp.asarray(gold["targets"]))
        np.testing.assert_allclose(np.asarray(carry.x_init),
                                   gold["ticks"][k]["x"], atol=1e-6)
