"""Write the JAX golden fixture that the PyTorch port is replayed against.

Runs the JAX flagship tick on the CPU — B2G + Z1 arm, whole_body_rnea,
trot 0.8 s, N=14, the hot config (1 SQP iteration, 10 ADMM sweeps,
corrector 5, 2 line-search trials, flip reset, warm shift) with factorizer
"cholinv" — for a batch of 2 scenarios (target vx 0.2 and 0.1) over 5
ticks, and writes tests/data/torch_golden_b2g_n14.json: the setup, the
initial carry, and per tick x, max_violation, alpha and status.

The machine with the GPU has no JAX, so this fixture is how a run there is
held against the reference (chip_smoke.py replays it; so does a CPU test,
tests/test_torch_mpc.py). Arrays are stored as base64 of their
float32/int32 bytes; tpu_locoman_torch.convert.load_golden reads them.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py
"""

import base64
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_golden_b2g_n14.json")

SETUP = {
    "robot": "B2G", "dynamics": "whole_body_rnea", "gait": "trot",
    "gait_period": 0.8, "nodes": 14, "sqp_iters": 1, "admm_iters": 10,
    "corrector": 5, "ls_trials": 2, "flip_reset": True, "warm_shift": True,
    "factorizer": "cholinv", "targets_vx": [0.2, 0.1], "ticks": 5,
    "dt_min": 0.01,
}


def pack(x):
    x = np.ascontiguousarray(x)
    return {"dtype": str(x.dtype), "shape": list(x.shape),
            "b64": base64.b64encode(x.tobytes()).decode()}


def main():
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from tpu_locoman import B2G, MPC, ADMMConfig, SQPConfig
    from tpu_locoman.parallel import batched_init, batched_step

    s = SETUP
    robot = B2G()
    robot.set_gait_sequence(s["gait"], s["gait_period"])
    mpc = MPC(robot, dynamics=s["dynamics"], nodes=s["nodes"],
              flip_reset=s["flip_reset"], warm_shift=s["warm_shift"],
              config=SQPConfig(sqp_iters=s["sqp_iters"],
                               n_trials=s["ls_trials"],
                               corrector_iters=s["corrector"],
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
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f)
    print("wrote", OUT, os.path.getsize(OUT), "bytes")


if __name__ == "__main__":
    main()
