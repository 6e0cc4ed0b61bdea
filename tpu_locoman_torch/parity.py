"""Parity ABI v1 dumps of the port's rollout, and their diff.

The port's counterpart of ``make_dump`` and ``diff`` in
``tools/parity_check.py``: the same schema, the same recording rules and
the same comparison, so that a dump of the port and one of the JAX package
(or of a reference Fatrop run) are diffed by either tool.

    python -m tpu_locoman_torch.parity --dump-out OUT.json [--ticks T]
        [--hot] [--robot go2|b2|b2g] [--nodes N] [--device cpu]
        [--hold DUMP.json] [--factorizer NAME]
    python -m tpu_locoman_torch.parity --diff A.json B.json [--ticks T]

ABI v1 (the schema in ``tools/parity_check.py``): ``abi_version`` 1, the
rollout's ``config`` (robot, gait, gait_period, dynamics, nodes, dt_min,
dt_max, base_vel_des, ticks), a free-form ``solver`` description, and per
tick ``t``, the applied state ``x`` after the tick, the solver's
``max_violation``, and under ``node0`` / ``node1`` the retracted solution
(q, v, a, forces, tau) at nodes 0 and 1, retracted from the state the tick
solved at. Quaternions are (x, y, z, w) after the base translation.

The rollout is one scenario through ``MPC.step``, on the card unless
``device="cpu"``, with the reference's configurations: ``--hot`` is 1 SQP
iteration of 10 ADMM sweeps, the default is accurate mode (6 SQP
iterations of 400 sweeps and 2 equality projections). The factorizer is
"auto", as in the reference: "cholinv_pb" on the card, "sequential" on the
CPU. The rollout is closed loop unless ``--hold`` gives a dump whose states
every tick after the first solves from.
"""

import argparse
import json
import sys

import numpy as np

QUANTITIES = ("q", "v", "a", "forces", "tau")
# the reference's rollout: whole-body dynamics, a 0.8 s trot, 0.2 m/s ahead
DYNAMICS, GAIT, GAIT_PERIOD = "whole_body_rnea", "trot", 0.8
BASE_VEL_DES = (0.2, 0, 0, 0, 0, 0)


def solver_config(hot, factorizer="auto"):
    """(SQPConfig, the dump's solver description) of the reference's hot or
    accurate dump."""
    from .solver import ADMMConfig, SQPConfig

    if hot:
        return (SQPConfig(sqp_iters=1, admm=ADMMConfig(
                    iters=10, factorizer=factorizer)),
                {"mode": "hot", "sqp_iters": 1, "admm_iters": 10})
    return (SQPConfig(sqp_iters=6, eq_projection=2,
                      admm=ADMMConfig(iters=400, factorizer=factorizer)),
            {"mode": "accurate", "sqp_iters": 6, "admm_iters": 400,
             "eq_projection": 2})


def make_dump(out_path=None, ticks=100, hot=False, robot_name="b2g",
              nodes=14, device="cuda", log=None, hold=None,
              factorizer="auto"):
    """Roll the port out for ``ticks`` ticks and return its ABI v1 dump
    (written to ``out_path`` when given). ``log``, if given, is called with
    (tick, max_violation) after every tick. ``hold``, an ABI v1 dump (path
    or dict), holds the rollout open loop: every tick after the first
    solves from that dump's state after the tick before, so each tick's
    solution is compared from the same state as the dump's.
    ``factorizer`` replaces the reference's "auto"."""
    import torch

    from . import robots
    from .mpc import MPC

    robot = {"go2": robots.Go2, "b2": robots.B2, "b2g": robots.B2G}[
        robot_name]()
    robot.set_gait_sequence(GAIT, GAIT_PERIOD)
    cfg, solver_desc = solver_config(hot, factorizer)
    mpc = MPC(robot, dynamics=DYNAMICS, nodes=nodes, config=cfg,
              device=device)
    bvd = torch.tensor(BASE_VEL_DES, dtype=torch.float32,
                       device=mpc.device)[None]
    held = None if hold is None else _load(hold)["x"]
    carry = mpc.init_carry(1)
    rec = {"t": [], "x": [], "max_violation": [],
           "node0": {k: [] for k in QUANTITIES},
           "node1": {k: [] for k in QUANTITIES}}
    for k in range(ticks):
        t = torch.tensor(k * mpc.dt_min, dtype=torch.float32)
        if held is not None and k > 0:
            carry = carry._replace(x_init=torch.tensor(
                held[k - 1], dtype=torch.float32, device=mpc.device)[None])
        x_solve = carry.x_init  # the state this tick's solution retracts from
        carry, stats = mpc.step(carry, t.to(mpc.device), bvd)
        sol = mpc.retract(carry.solver_state.Z, x_solve, num_steps=2)
        rec["t"].append(float(t))
        rec["x"].append(carry.x_init[0].double().cpu().tolist())
        rec["max_violation"].append(float(stats["max_violation"][0]))
        for node in (0, 1):
            for key in QUANTITIES:
                rec[f"node{node}"][key].append(
                    sol[key][0, node].double().cpu().tolist())
        if log is not None:
            log(k, rec["max_violation"][-1])
    dump = {
        "abi_version": 1,
        "config": {
            "robot": robot_name, "gait": GAIT, "gait_period": GAIT_PERIOD,
            "dynamics": DYNAMICS, "nodes": nodes,
            "dt_min": float(mpc.dt_min), "dt_max": float(mpc.dts[-1]),
            "base_vel_des": list(map(float, BASE_VEL_DES)), "ticks": ticks,
        },
        "solver": solver_desc,
        **rec,
    }
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(dump, f)
    return dump


def _load(d):
    if isinstance(d, str):
        with open(d) as f:
            return json.load(f)
    return d


def diff(a, b, ticks=None, warn=True):
    """Tick-by-tick comparison of two ABI v1 dumps (paths or dicts): for x,
    max_violation and each node quantity present in both, over the ticks
    both have (at most ``ticks``), the max and rms absolute error and the
    second dump's largest magnitude, as ``tools/parity_check.py --diff``
    reports them. Differences of abi_version or config go to stderr."""
    a, b = _load(a), _load(b)
    if warn:
        for d, name in ((a, "first"), (b, "second")):
            if d.get("abi_version") != 1:
                print(f"warning: the {name} dump has abi_version="
                      f"{d.get('abi_version')!r}, expected 1", file=sys.stderr)
        if a.get("config") != b.get("config"):
            print("warning: configs differ", file=sys.stderr)
            for key in set(a.get("config", {})) | set(b.get("config", {})):
                va, vb = a["config"].get(key), b["config"].get(key)
                if va != vb:
                    print(f"  config.{key}: {va!r} vs {vb!r}", file=sys.stderr)
    out = {}

    def cmp(key, arr_a, arr_b):
        ta, tb = np.asarray(arr_a, float), np.asarray(arr_b, float)
        n = min(ta.shape[0], tb.shape[0])
        if ticks is not None:
            n = min(n, ticks)
        ta, tb = ta[:n], tb[:n]
        err = np.abs(ta - tb)
        out[key] = {"ticks_compared": int(n),
                    "max_abs_err": float(err.max()),
                    "rms_err": float(np.sqrt((err ** 2).mean())),
                    "ref_scale": float(np.abs(tb).max())}

    for key in ("x", "max_violation"):
        if key in a and key in b:
            cmp(key, a[key], b[key])
    for node in ("node0", "node1"):
        if node in a and node in b:
            for q in set(a[node]) & set(b[node]):
                cmp(f"{node}.{q}", a[node][q], b[node][q])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump-out", metavar="OUT.json",
                    help="write a parity ABI v1 dump of the port's rollout")
    ap.add_argument("--ticks", type=int,
                    help="ticks to roll out (default 100), or with --diff "
                         "the first ticks to compare (default all)")
    ap.add_argument("--hot", action="store_true",
                    help="the real-time config instead of accurate mode")
    ap.add_argument("--robot", default="b2g", choices=("go2", "b2", "b2g"))
    ap.add_argument("--nodes", type=int, default=14)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu"')
    ap.add_argument("--hold", metavar="DUMP.json",
                    help="solve every tick after the first from this "
                         "dump's state after the tick before (open loop)")
    ap.add_argument("--factorizer", default="auto",
                    help='the ADMM factorizer (default "auto", as the '
                         'reference)')
    ap.add_argument("--diff", nargs=2, metavar=("OURS", "THEIRS"),
                    help="compare two parity ABI dumps (no solver run)")
    args = ap.parse_args(argv)
    if args.diff:
        print(json.dumps(diff(*args.diff, ticks=args.ticks), indent=2,
                         sort_keys=True))
    elif args.dump_out:
        ticks = 100 if args.ticks is None else args.ticks

        def log(k, v):
            if (k + 1) % 10 == 0:
                print(f"tick {k + 1}/{ticks} viol={v:.2e}", flush=True)

        d = make_dump(args.dump_out, ticks=ticks, hot=args.hot,
                      robot_name=args.robot, nodes=args.nodes,
                      device=args.device, log=log, hold=args.hold,
                      factorizer=args.factorizer)
        v = np.asarray(d["max_violation"])
        print(f"wrote {args.dump_out} (mean viol {v.mean():.2e}, worst "
              f"{v.max():.2e})")
    else:
        ap.error("give --dump-out or --diff")
    return 0


if __name__ == "__main__":
    sys.exit(main())
