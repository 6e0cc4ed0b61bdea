"""Multi-process dry run: the port's counterpart of ``dryrun_multichip`` in
``__graft_entry__.py``.

``dryrun_multichip(n_procs)`` starts ``n_procs`` processes, one rank each,
joined by ``torch.distributed`` (NCCL, or gloo, whose collectives on CUDA
tensors go through host copies, so that several ranks can share one card).
Each rank runs its slice of a scenario batch of the flagship (B2G + Z1,
``whole_body_rnea``, trot 0.8 s, N=14, one SQP iteration of 10
warm-started ADMM sweeps) for 2 ticks; the slices are all-gathered, and
rank 0 runs the same batch unsharded in its own process and holds the two
elementwise at the JAX dry run's bounds (x rtol = atol = 2e-3: f32
reassociation across batch sizes; violation rtol 0.3, atol 5e-2). A
sharding fault moves x by O(0.1). To tell the two apart, rank 0 also runs
each rank's slice unsharded at the local batch size in its own process:
the sharded result against those runs (``x_gap_local``) sees only the
sharding and the gather, and the full-batch run against them
(``x_gap_batch``) only the change of batch size.

    python -m tpu_locoman_torch.dryrun --procs 2 --backend gloo
    python -m tpu_locoman_torch.dryrun --procs 2 --device cpu --config tiny

Rank 0 prints the result as one line ``dryrun {...}`` (JSON), which
``dryrun_multichip`` returns as a dict.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name -> (robot, gait period, nodes, ADMM sweeps, global batch)
CONFIGS = {"flagship": ("B2G", 0.8, 14, 10, 512),
           "tiny": ("Go2", 0.5, 3, 3, 4)}
TICKS = 2
X_TOL = 2e-3  # rtol = atol on x, as the JAX dry run
VIOL_RTOL, VIOL_ATOL = 0.3, 5e-2


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def build_mpc(config, device):
    import tpu_locoman_torch as T

    robot, period, nodes, iters, _ = CONFIGS[config]
    rob = getattr(T, robot)()
    rob.set_gait_sequence("trot", period)
    return T.MPC(rob, dynamics="whole_body_rnea", nodes=nodes,
                 config=T.SQPConfig(sqp_iters=1,
                                    admm=T.ADMMConfig(iters=iters)),
                 device=device)


def _ticks(mpc, carries, targets, ticks):
    """Run ``ticks`` ticks; (carries, stats of the last, ms of each tick;
    the first includes the process's first launches)."""
    import torch

    sync = (torch.cuda.synchronize if mpc.device.type == "cuda"
            else lambda: None)
    ms = []
    for k in range(ticks):
        sync()
        t0 = time.perf_counter()
        t = torch.tensor(float(k), device=mpc.device) * mpc.dt_min
        carries, stats = mpc.step(carries, t, targets)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return carries, stats, ms


def worker(rank, world, address, backend, device, config):
    """One rank of the dry run; rank 0 returns the result dict."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from . import distributed, parallel
    from .solver import chol_base, fac_whole
    from . import rnea_derivs

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)
    distributed.init_group(backend, world, rank, address)
    try:
        mesh = parallel.make_mesh()
        n = distributed.warmup_collectives(mesh)
        mpc = build_mpc(config, device)
        batch = CONFIGS[config][4]
        sh = parallel.batch_sharding(mesh, device=device)
        targets = torch.zeros(batch, 6)
        targets[:, 0] = 0.2
        carries = parallel.shard_batch(parallel.batched_init(mpc, batch),
                                       mesh, device=device)
        local_t = parallel.shard_batch(targets, mesh, device=device)
        chol_base.launches = rnea_derivs.launches = fac_whole.launches = 0
        carries, stats, ms = _ticks(mpc, carries, local_t, TICKS)
        launches = (chol_base.launches, rnea_derivs.launches,
                    fac_whole.launches)
        x_sh = parallel.gather(carries.x_init, sh)
        mv = stats["max_violation"]
        total = mv.sum().reshape(1)
        total = total.cpu() if backend == "gloo" else total
        dist.all_reduce(total)
        mean = float(total) / batch
        print(f"rank {rank}: world {n}, mesh {tuple(mesh.shape)}, scenarios "
              f"{sh.slice(batch).start}:{sh.slice(batch).stop}, "
              f"ticks {', '.join(f'{x:.2f}' for x in ms)} ms, launches K1 "
              f"{launches[0]} K2 {launches[1]} K3 {launches[2]}, global mean "
              f"violation {mean:.8f}",
              flush=True)
        mv_sh = parallel.gather(mv, sh)
        if rank != 0:
            return None
        full, st_full, ms_full = _ticks(
            mpc, parallel.batched_init(mpc, batch), targets.to(device), TICKS)
        per = batch // sh.count
        x_loc = np.concatenate([_ticks(
            mpc, parallel.batched_init(mpc, per),
            targets[r * per:(r + 1) * per].to(device), TICKS)[0]
            .x_init.cpu().numpy() for r in range(sh.count)])
        x_sh, x_un = x_sh.cpu().numpy(), full.x_init.cpu().numpy()
        v_sh = mv_sh.cpu().numpy()
        v_un = st_full["max_violation"].cpu().numpy()
        if not np.isfinite(v_sh).all():
            raise AssertionError("the sharded step gave non-finite stats")
        if v_sh.mean() >= 5.0:
            raise AssertionError(f"sharded violations off the rails: "
                                 f"{v_sh.mean()}")
        np.testing.assert_allclose(x_sh, x_un, rtol=X_TOL, atol=X_TOL)
        np.testing.assert_allclose(v_sh, v_un, rtol=VIOL_RTOL,
                                   atol=VIOL_ATOL)
        return {"world": n, "backend": backend, "batch": batch,
                "ticks": TICKS, "config": config,
                "x_gap": float(np.abs(x_sh - x_un).max()),
                "x_gap_local": float(np.abs(x_sh - x_loc).max()),
                "x_gap_batch": float(np.abs(x_un - x_loc).max()),
                "viol_gap": float(np.abs(v_sh - v_un).max()),
                "viol_mean": float(v_sh.mean()),
                "viol_mean_unsharded": float(v_un.mean()),
                "global_mean": mean, "rank0_tick_ms": ms,
                "unsharded_tick_ms": ms_full,
                "rank0_launches": list(launches)}
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_procs, backend=None, device="cuda", config="flagship",
                     timeout=900):
    """Start ``n_procs`` ranks of the dry run and wait for them (each within
    ``timeout`` seconds); raise if any fails. Returns rank 0's result
    with every rank's output line under "ranks"."""
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        from . import _build

        _build.build()  # once here, not in every rank
    address = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "tpu_locoman_torch.dryrun", "--worker",
           "--procs", str(n_procs), "--address", address, "--backend",
           backend, "--device", device, "--config", config]
    # each rank's output goes to a file: a full pipe would stall a rank
    # that the others wait for in a collective
    logs = [tempfile.TemporaryFile("w+") for _ in range(n_procs)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(n_procs)]
    outs = []
    try:
        for p, log in zip(procs, logs):
            p.wait(timeout=timeout)
            log.seek(0)
            outs.append(log.read())
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dry run rank {r} failed:\n{out}")
    res = next(json.loads(ln[len("dryrun "):]) for ln in outs[0].splitlines()
               if ln.startswith("dryrun "))
    res["ranks"] = [ln for out in outs for ln in out.splitlines()
                    if ln.startswith("rank ")]
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="flagship", choices=sorted(CONFIGS))
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        res = worker(args.rank, args.procs, args.address, args.backend,
                     args.device, args.config)
        if res is not None:
            print("dryrun " + json.dumps(res), flush=True)
        return 0
    res = dryrun_multichip(args.procs, args.backend, args.device, args.config)
    print("\n".join(res.pop("ranks")))
    print(f"dryrun_multichip ok: {res['world']} processes ({res['backend']})"
          f", batch {res['batch']}, {res['ticks']} ticks, max_violation mean "
          f"{res['viol_mean']:.4f} (unsharded "
          f"{res['viol_mean_unsharded']:.4f}), sharded == unsharded "
          f"elementwise: x gap {res['x_gap']:.3g} (tol {X_TOL}), violation "
          f"gap {res['viol_gap']:.3g}; x against each slice unsharded at the "
          f"local batch: sharded {res['x_gap_local']:.3g}, full batch "
          f"{res['x_gap_batch']:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
