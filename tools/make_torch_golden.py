"""Write the JAX golden fixtures that the PyTorch port is replayed against.

Runs the JAX tick on the CPU — B2G + Z1 arm, whole_body_rnea, trot 0.8 s,
N=14, flip reset, warm shift, factorizer "cholinv" — over 5 ticks, and
writes the setup, the initial carry, and per tick x, max_violation, alpha
and status:

- default: the hot config (1 SQP iteration, 10 ADMM sweeps, corrector 5,
  2 line-search trials), batch 2 (target vx 0.2 and 0.1), to
  tests/data/torch_golden_b2g_n14.json;
- ``--accurate``: ``SQPConfig.accurate()`` (1 SQP iteration, 10 ADMM
  sweeps, 4 equality-projection passes, no corrector, 8 line-search
  trials), batch 1 (target vx 0.2), to
  tests/data/torch_golden_b2g_n14_accurate.json;
- ``--dynamics whole_body_aba``: the hot config and batch of the default,
  with the forward-dynamics formulation (no flip reset acts: it has no
  acceleration slots), to tests/data/torch_golden_b2g_n14_aba.json;
- ``--formulations``: short rollouts of the other formulations, for the
  CPU tests of the port (tests/test_torch_formulations_mpc.py): Go2 N=3,
  3 ticks, for each of whole_body_aba, whole_body_acc, centroidal_acc and
  centroidal_vel; B2G whole_body_aba N=3, 1 tick; and whole_body_rnea with
  flip_reset="aba", Go2 N=6, 5 ticks. Each on the hot config with
  "cholinv", batch 2 (target vx 0.2 and (0.1, yaw rate 0.2)), with the
  per-tick results and ``MPC.retract`` of scenario 0's last solution, to
  tests/data/torch_golden_formulations.json.

Two checks that write nothing, for setting a replay's bounds and gates:

- ``--against`` replays the fixture with JAX itself at the factorizer
  AGAINST ("sequential": the same math in another f32 summation order)
  and prints the largest x error, the largest per-tick max_violation
  error (absolute and relative) and the rollout mean's relative error —
  how far JAX lands from itself;
- ``--violation-survey`` runs the fixture's configuration at batch
  SURVEY_BATCH, target vx 0.2 for every scenario, for SURVEY_TICKS ticks,
  and prints the batch-mean max_violation per tick and its mean over the
  ticks after the first two (the chip run's warm-up).

The machine with the GPU has no JAX, so these fixtures are how a run there
is held against the reference (chip_smoke.py replays the B2G N=14 ones; so
do CPU tests, tests/test_torch_mpc.py and
tests/test_torch_formulations_mpc.py). Arrays are stored as base64 of their
float32/int32 bytes; tpu_locoman_torch.convert.load_golden reads them.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [--accurate]
        [--dynamics whole_body_aba] [--formulations] [--against]
        [--violation-survey]
"""

import argparse
import base64
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")

SETUP = {
    "robot": "B2G", "dynamics": "whole_body_rnea", "gait": "trot",
    "gait_period": 0.8, "nodes": 14, "sqp_iters": 1, "admm_iters": 10,
    "corrector": 5, "ls_trials": 2, "flip_reset": True, "warm_shift": True,
    "factorizer": "cholinv", "targets_vx": [0.2, 0.1], "ticks": 5,
    "dt_min": 0.01,
}
# SQPConfig.accurate() with the factorizer named, for one robot
ACCURATE = dict(SETUP, corrector=0, ls_trials=8, eq_projection=4,
                targets_vx=[0.2])
# the forward-dynamics formulation on the hot config
ABA = dict(SETUP, dynamics="whole_body_aba")
# --formulations: (case, robot, dynamics, nodes, ticks, flip_reset)
FORM_CASES = [
    ("go2_aba", "Go2", "whole_body_aba", 3, 3, True),
    ("go2_acc", "Go2", "whole_body_acc", 3, 3, True),
    ("go2_cacc", "Go2", "centroidal_acc", 3, 3, True),
    ("go2_cvel", "Go2", "centroidal_vel", 3, 3, True),
    ("b2g_aba", "B2G", "whole_body_aba", 3, 1, True),
    ("go2_rnea_flip_aba", "Go2", "whole_body_rnea", 6, 5, "aba"),
]
FORM_TARGETS = [[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0.2]]
# --against: the factorizer JAX is held against itself with
AGAINST = "sequential"
# --violation-survey: a small batch, over the ticks of chip_smoke.py's
# whole_body_aba phase (2 warm and 10 timed)
SURVEY_BATCH = 8
SURVEY_TICKS = 12


def pack(x):
    x = np.ascontiguousarray(x)
    return {"dtype": str(x.dtype), "shape": list(x.shape),
            "b64": base64.b64encode(x.tobytes()).decode()}


def fixture_path(accurate, dynamics):
    if accurate:
        return os.path.join(DATA, "torch_golden_b2g_n14_accurate.json")
    if dynamics == "whole_body_aba":
        return os.path.join(DATA, "torch_golden_b2g_n14_aba.json")
    return os.path.join(DATA, "torch_golden_b2g_n14.json")


def make_mpc(s, factorizer=None):
    import tpu_locoman
    from tpu_locoman import MPC, ADMMConfig, SQPConfig

    robot = getattr(tpu_locoman, s["robot"])()
    robot.set_gait_sequence(s["gait"], s["gait_period"])
    return MPC(robot, dynamics=s["dynamics"], nodes=s["nodes"],
               flip_reset=s["flip_reset"], warm_shift=s["warm_shift"],
               config=SQPConfig(sqp_iters=s["sqp_iters"],
                                n_trials=s["ls_trials"],
                                corrector_iters=s["corrector"],
                                eq_projection=s.get("eq_projection", 0),
                                admm=ADMMConfig(
                                    iters=s["admm_iters"],
                                    factorizer=factorizer or s["factorizer"])))


def rollout(mpc, carry, targets, ticks, dt_min):
    """Yield (tick, carry, stats as numpy) over the ticks."""
    import jax
    import jax.numpy as jnp

    from tpu_locoman.parallel import batched_step

    step = batched_step(mpc, donate=False)
    for k in range(ticks):
        carry, stats = step(carry, jnp.float32(k * dt_min),
                            jnp.asarray(targets))
        yield k, carry, jax.device_get(stats)


def against(path, factorizer=AGAINST):
    """JAX at another factorizer against the fixture at ``path``."""
    import jax

    from tpu_locoman_torch.convert import load_golden

    gold = load_golden(path)
    s = gold["setup"]
    mpc = make_mpc(s, factorizer)
    carry = _carry(gold["init"])
    gx = gv = gr = 0.0
    vs, refs = [], []
    for k, carry, st in rollout(mpc, carry, gold["targets"], s["ticks"],
                                s["dt_min"]):
        ref = gold["ticks"][k]
        x = np.asarray(jax.device_get(carry.x_init))
        v = np.asarray(st["max_violation"])
        dv = np.abs(v - ref["max_violation"])
        gx = max(gx, float(np.abs(x - ref["x"]).max()))
        gv = max(gv, float(dv.max()))
        gr = max(gr, float((dv / np.abs(ref["max_violation"])).max()))
        vs.append(v)
        refs.append(ref["max_violation"])
        print(k, "x err", float(np.abs(x - ref["x"]).max()), "violation", v,
              "fixture", ref["max_violation"], flush=True)
    mean_rel = abs(float(np.mean(vs)) / float(np.mean(refs)) - 1.0)
    print(f"JAX {factorizer} against the fixture ({s['factorizer']}): x max "
          f"abs err {gx:.6g}, violation max abs err {gv:.6g}, max rel err "
          f"{gr:.6g}, rollout mean rel err {mean_rel:.6g}")


def violation_survey(s, batch=SURVEY_BATCH, ticks=SURVEY_TICKS):
    """Batch-mean max_violation per tick at batch ``batch``, target vx 0.2."""
    from tpu_locoman.parallel import batched_init

    mpc = make_mpc(s)
    targets = np.zeros((batch, 6), np.float32)
    targets[:, 0] = 0.2
    per_tick = []
    for k, _, st in rollout(mpc, batched_init(mpc, batch), targets, ticks,
                            s["dt_min"]):
        v = np.asarray(st["max_violation"])
        per_tick.append(float(v.mean()))
        print(k, "max_violation mean", per_tick[-1], "worst", float(v.max()),
              "status", np.asarray(st["status"]).tolist(), flush=True)
    print(f"{s['dynamics']} batch {batch}: max_violation mean over ticks "
          f"2..{ticks - 1} {float(np.mean(per_tick[2:])):.6g}, worst tick "
          f"{max(per_tick[2:]):.6g}")


def formulations():
    """The --formulations fixture: {case: {setup, init, ticks, retract}}."""
    import jax

    from tpu_locoman.parallel import batched_init

    out = {}
    targets = np.asarray(FORM_TARGETS, np.float32)
    for case, robot, dyn, nodes, n_ticks, flip in FORM_CASES:
        s = dict(SETUP, robot=robot, dynamics=dyn, nodes=nodes,
                 ticks=n_ticks, flip_reset=flip,
                 targets_vx=[t[0] for t in FORM_TARGETS])
        mpc = make_mpc(s)
        carry = batched_init(mpc, len(targets))
        init = jax.device_get(carry)
        ticks = []
        for k, carry, st in rollout(mpc, carry, targets, n_ticks,
                                    s["dt_min"]):
            ticks.append(_tick(carry, st))
            print(case, k, np.asarray(st["max_violation"]), flush=True)
        Z, x0 = carry.solver_state.Z[0], carry.x_init[0]
        ret = jax.device_get(jax.jit(mpc.retract)(Z, x0))
        out[case] = {"setup": s, "init": _init(init), "ticks": ticks,
                     "retract": {"Z": pack(np.asarray(Z, np.float32)),
                                 "x_init": pack(np.asarray(x0, np.float32)),
                                 **{k: pack(np.asarray(v, np.float32))
                                    for k, v in ret.items()}}}
    out["targets"] = pack(targets)
    path = os.path.join(DATA, "torch_golden_formulations.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print("wrote", path, os.path.getsize(path), "bytes")


def _tick(carry, st):
    import jax

    return {
        "x": pack(np.asarray(jax.device_get(carry.x_init), np.float32)),
        "max_violation": pack(np.asarray(st["max_violation"], np.float32)),
        "alpha": pack(np.asarray(st["alpha"], np.float32)),
        "status": pack(np.asarray(st["status"], np.int32)),
    }


def _init(init):
    return {
        "x_init": pack(np.asarray(init.x_init, np.float32)),
        "solver_state": {k: pack(np.asarray(getattr(init.solver_state, k),
                                            np.float32))
                         for k in ("Z", "z_admm", "y_admm")},
        "tau_prev": pack(np.asarray(init.tau_prev, np.float32)),
    }


def _carry(init):
    import jax.numpy as jnp

    from tpu_locoman.mpc import MPCCarry
    from tpu_locoman.solver import SolverState

    st = init["solver_state"]
    return MPCCarry(x_init=jnp.asarray(init["x_init"]),
                    solver_state=SolverState(*(jnp.asarray(st[k]) for k in (
                        "Z", "z_admm", "y_admm"))),
                    tau_prev=jnp.asarray(init["tau_prev"]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--accurate", action="store_true",
                    help="write the accurate-mode fixture (batch 1)")
    ap.add_argument("--dynamics", default="whole_body_rnea",
                    choices=("whole_body_rnea", "whole_body_aba"),
                    help="formulation of the hot-config fixture")
    ap.add_argument("--formulations", action="store_true",
                    help="write the short rollouts of the other "
                         "formulations (Go2 and B2G, N=3 and 6)")
    ap.add_argument("--against", action="store_true",
                    help=f"replay the fixture with JAX at factorizer "
                         f"{AGAINST!r} and print the gaps; write nothing")
    ap.add_argument("--violation-survey", action="store_true",
                    help=f"print the max_violation of the configuration at "
                         f"batch {SURVEY_BATCH}; write nothing")
    args = ap.parse_args()
    accurate = args.accurate
    out_path = fixture_path(accurate, args.dynamics)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpu_locoman.parallel import batched_init

    s = ACCURATE if accurate else (ABA if args.dynamics == "whole_body_aba"
                                   else SETUP)
    if args.formulations:
        return formulations()
    if args.against:
        return against(out_path)
    if args.violation_survey:
        return violation_survey(s)
    mpc = make_mpc(s)
    batch = len(s["targets_vx"])
    targets = np.zeros((batch, 6), np.float32)
    targets[:, 0] = s["targets_vx"]
    carry = batched_init(mpc, batch)
    init = jax.device_get(carry)
    ticks = []
    for k, carry, st in rollout(mpc, carry, targets, s["ticks"],
                                s["dt_min"]):
        ticks.append(_tick(carry, st))
        print(k, np.asarray(st["max_violation"]), flush=True)
    out = {"setup": s, "targets": pack(targets), "init": _init(init),
           "ticks": ticks}
    os.makedirs(DATA, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f)
    print("wrote", out_path, os.path.getsize(out_path), "bytes")


if __name__ == "__main__":
    main()
