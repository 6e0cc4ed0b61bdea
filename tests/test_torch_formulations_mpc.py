"""The port's MPC tick with the four formulations of this slice against
tpu_locoman, tick by tick from the same initial carry.

The JAX side comes from tests/data/torch_golden_formulations.json, written
by ``tools/make_torch_golden.py --formulations`` (JAX on the CPU; the JAX
tick compiles for 40-110 s per formulation there, so the tier-1 tests
replay its results): Go2 N=3 for 3 ticks with whole_body_aba,
whole_body_acc, centroidal_acc and centroidal_vel; B2G whole_body_aba N=3
for one tick; whole_body_rnea with flip_reset="aba", Go2 N=6, 5 ticks.
Each on the hot config (1 SQP iteration, 10 ADMM sweeps, corrector 5, 2
line-search trials, warm shift), JAX factorizer "cholinv", batch 2 (target
vx 0.2, and vx 0.1 with yaw rate 0.2). The ``slow`` tests run the same
rollouts against a live JAX tick.

Tolerances are tests/test_torch_mpc.py's: x atol 1e-3, max_violation 5%
relative + 1e-3 absolute, alpha and status equal; ``MPC.retract`` of the
fixture's last solution atol 1e-4 * (max|ref| + 1) (a decode of the same
Z in f32). Measured on the CPU: x within 1.1e-4, max_violation within
1.2% (whole_body_aba's first tick; the others within 0.2%).

The whole_body_aba golden fixture (tests/data/torch_golden_b2g_n14_aba.json,
B2G N=14) is replayed on the plain path at chip_smoke.py's bounds."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import convert  # noqa: E402

from test_torch_mpc import _check_tick, _hot  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data",
                       "torch_golden_formulations.json")
GO2_CASES = ["go2_aba", "go2_acc", "go2_cacc", "go2_cvel"]


def _gold():
    return convert.load_golden(FIXTURE)


def _port_mpc(s, flip_reset=None):
    robot = getattr(T, s["robot"])()
    robot.set_gait_sequence(s["gait"], s["gait_period"])
    return T.MPC(robot, dynamics=s["dynamics"], nodes=s["nodes"],
                 flip_reset=s["flip_reset"] if flip_reset is None
                 else flip_reset, warm_shift=s["warm_shift"],
                 config=_hot(T, "cholinv_pb"), device="cpu")


class _Ref:
    """A fixture tick in the shape _check_tick reads."""

    def __init__(self, tick):
        self.x_init = tick["x"]
        self.stats = {k: tick[k] for k in ("max_violation", "alpha",
                                           "status")}


def _replay(case, flip_reset=None):
    """Tick the port through the fixture's case; returns the port's
    carries, one per tick."""
    gold = _gold()
    c = gold[case]
    s = c["setup"]
    tm = _port_mpc(s, flip_reset)
    tc = convert.carry_from_numpy(c["init"], "cpu")
    targets = torch.tensor(gold["targets"])
    step = T.batched_step(tm)
    assert len(c["ticks"]) == s["ticks"]
    carries = []
    for k, tick in enumerate(c["ticks"]):
        tc, ts = step(tc, torch.tensor(np.float32(k * s["dt_min"])), targets)
        ref = _Ref(tick)
        if flip_reset is None:
            _check_tick(k, ref, ref.stats, tc, ts)
        carries.append(tc)
    return tm, c, carries


def _check_retract(tm, ret):
    """The port's retract of the fixture's last solution against JAX's."""
    out = tm.retract(torch.tensor(ret["Z"])[None],
                     torch.tensor(ret["x_init"])[None])
    assert set(out) == {"q", "v", "a", "forces", "tau"}
    for key, o in out.items():
        r = ret[key]
        np.testing.assert_allclose(o[0].numpy(), r,
                                   atol=1e-4 * (np.abs(r).max() + 1),
                                   err_msg=key)


@pytest.mark.parametrize("case", GO2_CASES)
def test_go2_rollout_and_retract_match_jax(case):
    tm, c, _ = _replay(case)
    assert c["setup"]["dynamics"] == tm.form.name
    _check_retract(tm, c["retract"])


def test_b2g_whole_body_aba_tick_matches_jax():
    tm, c, _ = _replay("b2g_aba")
    assert (c["setup"]["robot"], tm.form.nu, tm.trans.s) == ("B2G", 33, 81)
    _check_retract(tm, c["retract"])


def test_flip_reset_aba_matches_jax():
    """whole_body_rnea with flip_reset="aba" (the flipped nodes'
    acceleration slots seeded with ABA at the warm start); the reset acts,
    since the same ticks with "zero" land elsewhere."""
    tm, c, aba_carries = _replay("go2_rnea_flip_aba")
    assert tm.flip_reset == "aba"
    _check_retract(tm, c["retract"])
    _, _, zero_carries = _replay("go2_rnea_flip_aba", flip_reset="zero")
    gap = max(float((a.solver_state.Z - z.solver_state.Z).abs().max())
              for a, z in zip(aba_carries, zero_carries))
    assert gap > 1e-3


def test_flip_reset_unknown_raises():
    robot = T.Go2()
    robot.set_gait_sequence("trot", 0.8)
    with pytest.raises(ValueError, match="flip_reset"):
        T.MPC(robot, nodes=3, flip_reset="bogus", device="cpu")


def test_golden_aba_fixture_setup():
    """The whole_body_aba fixture (tools/make_torch_golden.py --dynamics
    whole_body_aba): B2G N=14, the hot config with JAX "cholinv", batch 2,
    5 ticks, stage width 81."""
    gold = convert.load_golden(os.path.join(
        ROOT, "tests", "data", "torch_golden_b2g_n14_aba.json"))
    s = gold["setup"]
    assert (s["robot"], s["nodes"], s["dynamics"], s["corrector"],
            s["ls_trials"], s["admm_iters"], s["factorizer"]) == (
        "B2G", 14, "whole_body_aba", 5, 2, 10, "cholinv")
    assert gold["init"]["solver_state"]["Z"].shape == (2, 15, 81)
    assert len(gold["ticks"]) == s["ticks"] == 5
    for tick in gold["ticks"]:
        assert tick["x"].shape == (2, 49) and np.all(np.isfinite(tick["x"]))
        assert np.all(tick["status"] == 0)


def test_golden_aba_replay_plain_path():
    """B2G whole_body_aba N=14 (batch 2, 5 ticks) on the plain path against
    the JAX fixture, at the bounds chip_smoke.py states and applies on the
    GPU (replay_golden)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    gx, gv, grel, ticks, batch = chip_smoke.replay_golden(
        torch.device("cpu"), "cholinv_pb", chip_smoke.GOLDEN_ABA)
    assert (ticks, batch) == (5, 2)
    assert gx <= chip_smoke.ABA_X_TOL and grel <= chip_smoke.ABA_MEAN_REL


@pytest.mark.slow
@pytest.mark.parametrize("case", GO2_CASES + ["b2g_aba",
                                              "go2_rnea_flip_aba"])
def test_rollout_matches_live_jax(case):
    """The fixture's cases against a live JAX tick. Slow: the JAX tick
    compiles for 40-110 s per formulation on a CPU."""
    import jax
    import jax.numpy as jnp

    import tpu_locoman as J
    from tpu_locoman import parallel as jpar

    s = _gold()[case]["setup"]
    jrob = getattr(J, s["robot"])()
    jrob.set_gait_sequence(s["gait"], s["gait_period"])
    jm = J.MPC(jrob, dynamics=s["dynamics"], nodes=s["nodes"],
               flip_reset=s["flip_reset"], warm_shift=s["warm_shift"],
               config=_hot(J, "cholinv"))
    tm = _port_mpc(s)
    targets = np.asarray(_gold()["targets"])
    jc = jpar.batched_init(jm, 2)
    tc = convert.carry_from_numpy(jax.device_get(jc), "cpu")
    jstep = jpar.batched_step(jm, donate=False)
    tstep = T.batched_step(tm)
    for k in range(s["ticks"]):
        t = np.float32(k * s["dt_min"])
        jc, js = jstep(jc, jnp.float32(t), jnp.asarray(targets))
        tc, ts = tstep(tc, torch.tensor(t), torch.tensor(targets))
        _check_tick(k, jc, js, tc, ts)
    Z, x0 = jc.solver_state.Z[0], jc.x_init[0]
    ref = jax.device_get(jm.retract(Z, x0))
    _check_retract(tm, dict(ref, Z=np.asarray(Z), x_init=np.asarray(x0)))
