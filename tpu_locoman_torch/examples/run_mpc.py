"""Receding-horizon MPC example: the port's counterpart of
``examples/run_mpc.py`` (the analog of the reference run_mpc.py).

Runs the MPC loop for a batch of scenarios, prints solve statistics, and
optionally dumps the executed trajectory for host-side visualization.

    python -m tpu_locoman_torch.examples.run_mpc            # on the card
    python -m tpu_locoman_torch.examples.run_mpc --device cpu --robot go2 \\
        --nodes 6 --mpc-loops 30 --admm-iters 15

The flags and defaults are those of ``examples/run_mpc.py``, plus
``--device`` and ``--batch`` (scenarios, all with the same target; the
statistics are over all of them, the trajectory is scenario 0's).
"""

import argparse
import json
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robot", default="b2g", choices=["go2", "b2", "b2g"])
    ap.add_argument("--dynamics", default="whole_body_rnea")
    ap.add_argument("--gait", default="trot")
    ap.add_argument("--gait-period", type=float, default=0.8)
    ap.add_argument("--nodes", type=int, default=14)
    ap.add_argument("--mpc-loops", type=int, default=100)
    ap.add_argument("--sqp-iters", type=int, default=2)
    ap.add_argument("--admm-iters", type=int, default=100)
    ap.add_argument("--vx", type=float, default=0.2)
    ap.add_argument("--dump", default=None, help="write trajectory JSON here")
    ap.add_argument("--viz", default=None,
                    help="write a self-contained 3D replay HTML here")
    ap.add_argument("--live", action="store_true",
                    help="serve a live 3D viewer and stream ticks to it "
                         "(the MeshCat live-display analog)")
    ap.add_argument("--live-port", type=int, default=8765)
    ap.add_argument("--warm-shift", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="time-consistent warm-start shift (see "
                    "mpc._shift_Z); --no-warm-shift for the reference's "
                    "same-node warm start")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1)
    return ap.parse_args(argv)


def build(args):
    import tpu_locoman_torch as T

    robot = {"go2": T.Go2, "b2": T.B2, "b2g": T.B2G}[args.robot]()
    robot.set_gait_sequence(args.gait, args.gait_period)
    return T.MPC(robot, dynamics=args.dynamics, nodes=args.nodes,
                 warm_shift=args.warm_shift, device=args.device,
                 config=T.SQPConfig(sqp_iters=args.sqp_iters,
                                    admm=T.ADMMConfig(iters=args.admm_iters)))


def q_of(mpc, x):
    """The configuration part of states x (..., nx)."""
    return x[..., :mpc.form.nq] if mpc.form.name != "centroidal_vel" \
        else x[..., 6:]


def main(argv=None):
    """Run the example; returns a dict of what it printed."""
    import torch

    args = parse_args(argv)
    mpc = build(args)
    base_vel_des = torch.tensor([args.vx, 0, 0, 0, 0, 0], device=mpc.device)

    if args.live:
        # each executed state is streamed to the browser as it happens:
        # the reference's robot.init_visualizer() + display(q) loop
        # (run_mpc.py:163-165)
        from tpu_locoman_torch.viz import LiveViewer

        viewer = LiveViewer(mpc.form.model,
                            frame_names=tuple(mpc.form.foot_frames),
                            dt=mpc.dt_min, port=args.live_port,
                            device=mpc.device)
        print("Live viewer serving at", viewer.url)
        carry = mpc.init_carry(args.batch)
        for k in range(args.mpc_loops):
            t_tick = time.time()
            t = torch.tensor(float(k), device=mpc.device) * mpc.dt_min
            carry, stats = mpc.step(carry, t, base_vel_des)
            viewer.push(q_of(mpc, carry.x_init[0]))
            time.sleep(max(0.0, mpc.dt_min - (time.time() - t_tick)))
        print("Live run done (streamed", args.mpc_loops, "ticks)")
        viewer.close()
        return {"live_ticks": args.mpc_loops}

    sync = (torch.cuda.synchronize if mpc.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.time()
    carry, outs = mpc.run(args.mpc_loops, base_vel_des, batch=args.batch)
    sync()
    total = time.time() - t0
    res = {"wall_s": total, "ms_per_tick": total / args.mpc_loops * 1e3}
    print("Total wall (s):", round(total, 2))
    print("Avg solve time (ms):", round(res["ms_per_tick"], 2))
    v = outs["max_violation"].cpu().numpy()
    res["viol_median"], res["viol_max"] = float(np.median(v)), float(v.max())
    print("Violation median/max:", round(res["viol_median"], 4),
          round(res["viol_max"], 4))
    x = outs["x"][:, 0].cpu().numpy()  # scenario 0
    res["final_pos"] = x[-1, :3].tolist()
    print("Final base pos:", x[-1, :3].round(3))
    vx = (x[-1, 0] - x[len(x) // 3, 0]) / ((len(x) - len(x) // 3)
                                          * mpc.dt_min)
    res["vx"] = float(vx)
    print("Tracked vx (m/s):", round(float(vx), 3))

    if args.dump:
        with open(args.dump, "w") as f:
            json.dump({"x": x.tolist(), "dt": mpc.dt_min}, f)
        print("Trajectory dumped to", args.dump)

    if args.viz:
        from tpu_locoman_torch import viz

        scene = viz.dump_scene(
            args.viz + ".json", mpc.form.model, q_of(mpc, outs["x"][:, 0]),
            mpc.dt_min, frame_names=tuple(mpc.form.foot_frames),
            device=mpc.device)
        html = viz.write_player_html(args.viz, scene)
        print("3D replay written to", html, "(open in a browser)")
    res["carry"], res["outs"], res["mpc"] = carry, outs, mpc
    return res


if __name__ == "__main__":
    main()
