"""Single-OCP solve example: the port's counterpart of
``examples/run_ocp.py`` (the analog of the reference run_ocp.py).

Solves one trajectory-optimization problem (several SQP iterations, the
Fatrop-quality path) and prints the solve time, the horizon length, the
max violation and, with ``--debug``, the EOM-against-RNEA check of the
reference's run_ocp.py:106-161 (M a + nle - J^T f against rnea(q, v, a, f)
at every node of the retracted solution).

    python -m tpu_locoman_torch.examples.run_ocp --debug      # on the card
    python -m tpu_locoman_torch.examples.run_ocp --device cpu --robot go2 \\
        --dynamics centroidal_vel --nodes 6 --sqp-iters 4 --admm-iters 80 \\
        --debug

The flags and defaults are those of ``examples/run_ocp.py``, plus
``--device`` and ``--batch``.
"""

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robot", default="b2g", choices=["go2", "b2", "b2g"])
    ap.add_argument("--dynamics", default="whole_body_rnea")
    ap.add_argument("--gait", default="trot")
    ap.add_argument("--gait-period", type=float, default=0.8)
    ap.add_argument("--nodes", type=int, default=14)
    ap.add_argument("--dt-min", type=float, default=0.01)
    ap.add_argument("--dt-max", type=float, default=0.08)
    ap.add_argument("--sqp-iters", type=int, default=5)
    ap.add_argument("--admm-iters", type=int, default=100)
    ap.add_argument("--vx", type=float, default=0.2)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1)
    return ap.parse_args(argv)


def eom_check(mpc, sol):
    """(mean |tau_all - tau_rnea|, mean |tau_all base rows|) over the nodes
    of the retracted solution, tau_all = M a + nle - sum J^T f."""
    import torch

    from tpu_locoman_torch import rbda

    model, form = mpc.form.model, mpc.form
    q, v, a, forces = sol["q"], sol["v"], sol["a"], sol["forces"]
    tau_ext = torch.zeros_like(v)
    for idx, fname in enumerate(form.ee_frames):
        J = rbda.frame_jacobian_lwa(model, fname, q)
        tau_ext = tau_ext + (J[..., :3, :].transpose(-1, -2)
                             @ forces[..., 3 * idx:3 * idx + 3, None])[..., 0]
    M = rbda.crba(model, q)
    tau_all = ((M @ a[..., None])[..., 0] + rbda.nonlinear_effects(model, q, v)
               - tau_ext)
    tau_rnea = rbda.rnea(model, q, v, a, tuple(form.ee_frames), forces)
    diff = torch.linalg.norm(tau_all - tau_rnea, dim=-1)
    base = torch.linalg.norm(tau_all[..., :6], dim=-1)
    return float(diff.mean()), float(base.mean())


def main(argv=None):
    """Run the example; returns a dict of what it printed."""
    import torch

    import tpu_locoman_torch as T

    args = parse_args(argv)
    robot = {"go2": T.Go2, "b2": T.B2, "b2g": T.B2G}[args.robot]()
    robot.set_gait_sequence(args.gait, args.gait_period)
    mpc = T.MPC(robot, dynamics=args.dynamics, nodes=args.nodes,
                dt_min=args.dt_min, dt_max=args.dt_max, device=args.device,
                config=T.SQPConfig(sqp_iters=args.sqp_iters,
                                   admm=T.ADMMConfig(iters=args.admm_iters)))
    base_vel_des = torch.tensor([args.vx, 0, 0, 0, 0, 0], device=mpc.device)
    sync = (torch.cuda.synchronize if mpc.device.type == "cuda"
            else lambda: None)

    carry = mpc.init_carry(args.batch)
    t = torch.zeros((), device=mpc.device)
    res = {}
    for label in ("first_ms", "ms"):
        sync()
        t0 = time.time()
        carry, stats = mpc.step(carry, t, base_vel_des)
        sync()
        res[label] = (time.time() - t0) * 1e3
    print("Solve time, first call (ms):", round(res["first_ms"], 1))
    print("Solve time (ms):", round(res["ms"], 1))
    print("Horizon length (s):", float(mpc.dts.sum()))
    res["max_violation"] = float(stats["max_violation"].max())
    print("Max violation:", res["max_violation"])

    if args.debug:
        sol = mpc.retract(carry.solver_state.Z, carry.x_init)
        res["tau_diff"], res["tau_b_norm"] = eom_check(mpc, sol)
        print("Avg tau_diff:", res["tau_diff"])
        print("Avg tau_b_norm:", res["tau_b_norm"])
    res["carry"], res["mpc"] = carry, mpc
    return res


if __name__ == "__main__":
    main()
