"""Rollouts of the MPC options and targets that no other port test sets,
the port's batched tick against tpu_locoman's, tick by tick from JAX's
initial carry, on the hot config (1 SQP iteration, 10 ADMM sweeps,
corrector 5, 2 line-search trials; JAX "cholinv", the port "cholinv_pb",
whose CPU path is the plain recursion):

- b2g_targets: B2G N=3, trot 0.8, nonzero ext_force_des (0, 0, -20) and
  arm_vel_des (0.1, 0, 0.05), batch 2 (vx 0.2 and 0.1), 3 ticks;
- go2_no_warm_shift, go2_no_flip_reset and go2_dt_swing: Go2 N=6, trot
  0.5, vx 0.2 and yaw rate 0.1, 4 ticks, under warm_shift=False, under
  flip_reset=False, and under dt_min=0.02, dt_max=0.05, swing_height=0.1;
- go2_stand and go2_walk: the same Go2 rollout under the stand and the
  walk gait;
- b2_rear: B2 with the rear payload, N=6, trot 0.8, vx 0.2 and yaw rate
  0.1, 4 ticks.

JAX's ticks are recorded in tests/data/torch_unheld_jax.npz
(``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_unheld.py``
rewrites it, ~6 min: a JAX compile per case); the tests here compile no
JAX.

Bounds. Each case holds x and max_violation at SPREAD_FACTOR (3) times
JAX's own spread: JAX with the factorizer "sequential" against the
recording, per case the largest |dx| and the largest per-tick
|dviol| / |viol| over the ticks (``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_unheld.py --spread`` prints them; alpha and status did
not move). Measured on the CPU, JAX's spread and the port's gap:

    case               JAX x      JAX viol   port x     port viol
    b2g_targets        4.38e-04   8.76e-04   1.50e-04   1.58e-03
    go2_no_warm_shift  1.29e-05   8.75e-04   1.28e-05   1.01e-04
    go2_no_flip_reset  1.20e-05   6.34e-05   1.11e-05   5.77e-06
    go2_dt_swing       1.76e-05   5.19e-04   3.10e-05   3.59e-04
    go2_stand          1.05e-05   7.16e-05   8.58e-06   6.99e-05
    go2_walk           5.63e-05   3.80e-03   3.09e-05   1.95e-03
    b2_rear            1.08e-04   9.21e-02   9.70e-05   7.06e-02

b2_rear's violation moves 9.2% at its worst tick in JAX itself (the worst
row at the ADMM iteration floor; the port lands 7.1% off, 6.7% at tick 2),
so its bound is 27.6% of the tick's violation. alpha and status are held
equal in every case.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import convert  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDING = os.path.join(ROOT, "tests", "data", "torch_unheld_jax.npz")
SPREAD_FACTOR = 3.0

_GO2 = dict(robot=("Go2", {}), nodes=6, gait=("trot", 0.5), ticks=4,
            targets=[[0.2, 0, 0, 0, 0, 0.1]], ext=None, arm=None, mpc={})
#: case -> setup
CASES = {
    "b2g_targets": dict(robot=("B2G", {}), nodes=3, gait=("trot", 0.8),
                        ticks=3, targets=[[0.2, 0, 0, 0, 0, 0],
                                          [0.1, 0, 0, 0, 0, 0]],
                        ext=[0.0, 0.0, -20.0], arm=[0.1, 0.0, 0.05], mpc={}),
    "go2_no_warm_shift": dict(_GO2, mpc={"warm_shift": False}),
    "go2_no_flip_reset": dict(_GO2, mpc={"flip_reset": False}),
    "go2_dt_swing": dict(_GO2, mpc={"dt_min": 0.02, "dt_max": 0.05,
                                    "swing_height": 0.1}),
    "go2_stand": dict(_GO2, gait=("stand", 0.5)),
    "go2_walk": dict(_GO2, gait=("walk", 0.5)),
    "b2_rear": dict(_GO2, robot=("B2", {"payload": "rear"}),
                    gait=("trot", 0.8)),
}
#: case -> (JAX's spread in x, in max_violation relative), from --spread
SPREAD = {
    "b2g_targets": (4.38e-04, 8.76e-04),
    "go2_no_warm_shift": (1.29e-05, 8.75e-04),
    "go2_no_flip_reset": (1.20e-05, 6.34e-05),
    "go2_dt_swing": (1.76e-05, 5.19e-04),
    "go2_stand": (1.05e-05, 7.16e-05),
    "go2_walk": (5.63e-05, 3.80e-03),
    "b2_rear": (1.08e-04, 9.21e-02),
}
_STATS = ("max_violation", "alpha", "status")


def _config(mod, factorizer):
    return mod.SQPConfig(sqp_iters=1, n_trials=2, corrector_iters=5,
                         admm=mod.ADMMConfig(iters=10, factorizer=factorizer))


def _mpc(mod, case, factorizer, **kw):
    s = CASES[case]
    robot = getattr(mod, s["robot"][0])(**s["robot"][1])
    robot.set_gait_sequence(*s["gait"])
    return mod.MPC(robot, dynamics="whole_body_rnea", nodes=s["nodes"],
                   config=_config(mod, factorizer), **s["mpc"], **kw)


def _inputs(case):
    """(base_vel_des (B, 6), ext_force_des (B, 3), arm_vel_des (B, 3)) as
    float32 numpy, zero where the case sets no target."""
    s = CASES[case]
    base = np.asarray(s["targets"], np.float32)
    per = [np.tile(np.asarray(s[k] or [0.0] * 3, np.float32),
                   (len(base), 1)) for k in ("ext", "arm")]
    return base, *per


def _jax_rollout(case, factorizer="cholinv"):
    """tpu_locoman's batched rollout of ``case``: its initial carry and,
    per tick, x and the stats."""
    import jax
    import jax.numpy as jnp

    import tpu_locoman as J
    from tpu_locoman import parallel as jpar

    jm = _mpc(J, case, factorizer)
    base, ext, arm = _inputs(case)
    jc = jpar.batched_init(jm, len(base))
    c0 = jax.device_get(jc)
    out = {"init/x_init": np.asarray(c0.x_init),
           "init/tau_prev": np.asarray(c0.tau_prev),
           **{"init/" + k: np.asarray(getattr(c0.solver_state, k))
              for k in ("Z", "z_admm", "y_admm")}}
    step = jax.jit(jax.vmap(jm.step, in_axes=(0, None, 0, 0, 0)))
    for k in range(CASES[case]["ticks"]):
        jc, js = step(jc, jnp.float32(np.float32(k * jm.dt_min)),
                      jnp.asarray(base), jnp.asarray(ext), jnp.asarray(arm))
        out[f"{k}/x"] = np.asarray(jc.x_init)
        out.update({f"{k}/{n}": np.asarray(js[n]) for n in _STATS})
    return out


def _recording():
    """_jax_rollout of every case, as RECORDING holds it."""
    return {f"{case}/{k}": v for case in CASES
            for k, v in _jax_rollout(case).items()}


def _spread():
    """JAX "sequential" against the recording, per case: the largest |dx|
    and per-tick |dviol| / |viol|; alpha and status must not move."""
    rec = _load()
    for case in CASES:
        seq = _jax_rollout(case, "sequential")
        ref = rec[case]
        ex = ev = 0.0
        for k in range(CASES[case]["ticks"]):
            ex = max(ex, float(np.abs(seq[f"{k}/x"] - ref[f"{k}/x"]).max()))
            rv = ref[f"{k}/max_violation"]
            ev = max(ev, float((np.abs(seq[f"{k}/max_violation"] - rv)
                                / np.abs(rv)).max()))
            for n in ("alpha", "status"):
                if not np.array_equal(seq[f"{k}/{n}"], ref[f"{k}/{n}"]):
                    print(case, k, n, "moved:", seq[f"{k}/{n}"],
                          ref[f"{k}/{n}"])
        print(f"{case:18s} x {ex:.3g} viol rel {ev:.3g}", flush=True)


def _load():
    """{case: {key: array}} of the recording."""
    out = {case: {} for case in CASES}
    with np.load(RECORDING) as d:
        for key in d.files:
            case, rest = key.split("/", 1)
            out[case][rest] = d[key]
    return out


def _port_rollout(case, rec):
    """The port's rollout from the recording's initial carry, on the CPU;
    yields (tick, carry, stats)."""
    tm = _mpc(T, case, "cholinv_pb", device="cpu")
    tc = convert.carry_from_numpy(
        {"x_init": rec["init/x_init"], "tau_prev": rec["init/tau_prev"],
         "solver_state": {k: rec["init/" + k]
                          for k in ("Z", "z_admm", "y_admm")}}, "cpu")
    base, ext, arm = (torch.tensor(x) for x in _inputs(case))
    for k in range(CASES[case]["ticks"]):
        t = torch.tensor(np.float32(k * tm.dt_min))
        tc, ts = tm.step(tc, t, base, ext, arm)
        yield k, tc, ts


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_matches_jax_recording(case):
    rec = _load()[case]
    x_tol, viol_rel = (SPREAD_FACTOR * e for e in SPREAD[case])
    n = 0
    for k, tc, ts in _port_rollout(case, rec):
        np.testing.assert_allclose(tc.x_init.numpy(), rec[f"{k}/x"], rtol=0,
                                   atol=x_tol, err_msg=f"{case} x, tick {k}")
        np.testing.assert_allclose(ts["max_violation"].numpy(),
                                   rec[f"{k}/max_violation"], rtol=viol_rel,
                                   atol=0, err_msg=f"{case} violation, tick {k}")
        for name in ("alpha", "status"):
            np.testing.assert_array_equal(ts[name].numpy(),
                                          rec[f"{k}/{name}"],
                                          err_msg=f"{case} {name}, tick {k}")
        n += 1
    assert n == CASES[case]["ticks"]


def test_targets_move_the_rollout():
    """The targets case is live: without ext_force_des and arm_vel_des the
    recorded JAX rollout's x would be elsewhere, and the port's too."""
    rec = _load()["b2g_targets"]
    tm = _mpc(T, "b2g_targets", "cholinv_pb", device="cpu")
    tc = convert.carry_from_numpy(
        {"x_init": rec["init/x_init"], "tau_prev": rec["init/tau_prev"],
         "solver_state": {k: rec["init/" + k]
                          for k in ("Z", "z_admm", "y_admm")}}, "cpu")
    base = torch.tensor(_inputs("b2g_targets")[0])
    for k in range(CASES["b2g_targets"]["ticks"]):
        tc, _ = tm.step(tc, torch.tensor(np.float32(k * tm.dt_min)), base)
    last = CASES["b2g_targets"]["ticks"] - 1
    assert float(np.abs(tc.x_init.numpy() - rec[f"{last}/x"]).max()) > 0.1


def test_targets_fixture_replay_plain_path():
    """The B2G N=14 flagship with the same force and arm targets (batch 2,
    3 ticks) against its JAX fixture tests/data/torch_golden_b2g_n14_
    targets.json, at the bounds chip_smoke.py holds it to on the card
    (replay_golden: 3x JAX "sequential" against the fixture)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    gx, gv, grel, ticks, batch = chip_smoke.replay_golden(
        torch.device("cpu"), "cholinv_pb", chip_smoke.GOLDEN_TARGETS)
    assert (ticks, batch) == (3, 2)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if "--spread" in sys.argv:
        _spread()
    else:
        np.savez_compressed(RECORDING, **_recording())
        print("wrote", RECORDING)
