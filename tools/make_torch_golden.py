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
  tests/data/torch_golden_b2g_n14_accurate.json.

The machine with the GPU has no JAX, so this fixture is how a run there is
held against the reference (chip_smoke.py replays it; so does a CPU test,
tests/test_torch_mpc.py). Arrays are stored as base64 of their
float32/int32 bytes; tpu_locoman_torch.convert.load_golden reads them.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [--accurate]
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


def pack(x):
    x = np.ascontiguousarray(x)
    return {"dtype": str(x.dtype), "shape": list(x.shape),
            "b64": base64.b64encode(x.tobytes()).decode()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--accurate", action="store_true",
                    help="write the accurate-mode fixture (batch 1)")
    accurate = ap.parse_args().accurate
    out_path = os.path.join(DATA, "torch_golden_b2g_n14_accurate.json"
                            if accurate else "torch_golden_b2g_n14.json")
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from tpu_locoman import B2G, MPC, ADMMConfig, SQPConfig
    from tpu_locoman.parallel import batched_init, batched_step

    s = ACCURATE if accurate else SETUP
    robot = B2G()
    robot.set_gait_sequence(s["gait"], s["gait_period"])
    mpc = MPC(robot, dynamics=s["dynamics"], nodes=s["nodes"],
              flip_reset=s["flip_reset"], warm_shift=s["warm_shift"],
              config=SQPConfig(sqp_iters=s["sqp_iters"],
                               n_trials=s["ls_trials"],
                               corrector_iters=s["corrector"],
                               eq_projection=s.get("eq_projection", 0),
                               admm=ADMMConfig(iters=s["admm_iters"],
                                               factorizer=s["factorizer"])))
    batch = len(s["targets_vx"])
    targets = np.zeros((batch, 6), np.float32)
    targets[:, 0] = s["targets_vx"]
    carry = batched_init(mpc, batch)
    init = jax.device_get(carry)
    step = batched_step(mpc, donate=False)
    ticks = []
    for k in range(s["ticks"]):
        carry, stats = step(carry, jnp.float32(k * s["dt_min"]),
                            jnp.asarray(targets))
        st = jax.device_get(stats)
        ticks.append({
            "x": pack(np.asarray(jax.device_get(carry.x_init), np.float32)),
            "max_violation": pack(np.asarray(st["max_violation"], np.float32)),
            "alpha": pack(np.asarray(st["alpha"], np.float32)),
            "status": pack(np.asarray(st["status"], np.int32)),
        })
        print(k, np.asarray(st["max_violation"]), flush=True)
    out = {
        "setup": s,
        "targets": pack(targets),
        "init": {
            "x_init": pack(np.asarray(init.x_init, np.float32)),
            "solver_state": {k: pack(np.asarray(getattr(init.solver_state, k),
                                                np.float32))
                             for k in ("Z", "z_admm", "y_admm")},
            "tau_prev": pack(np.asarray(init.tau_prev, np.float32)),
        },
        "ticks": ticks,
    }
    os.makedirs(DATA, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f)
    print("wrote", out_path, os.path.getsize(out_path), "bytes")


if __name__ == "__main__":
    main()
