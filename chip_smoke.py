#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_locoman_torch) on one GPU.

    python3 chip_smoke.py                  # the whole check, ~1 min on an H100
    python3 chip_smoke.py --profile FILE   # also write a torch.profiler table
                                           # of three flagship ticks to FILE

Phases, one line each (any failure raises; exit code non-zero):
 1. device: nvidia-smi name and power limit, torch and CUDA versions;
 2. build the CUDA kernels from tpu_locoman_torch/csrc (nvcc, sm_90a);
 3. K1 (chol_inv_base) against its plain version on the card;
 4. K2 (rnea_derivs) against its plain version on the card;
 5. the flagship main path: B2G + Z1 whole_body_rnea, N=14, trot 0.8 s,
    the SHIPPING.json bench_defaults, batch 512, target vx 0.2 — 2 warm-up
    and 20 timed ticks, with the kernel launch counts of that run;
 6. the kernel path against the plain path on the card (batch 8, 3 ticks);
 7. replay of the JAX golden fixture tests/data/torch_golden_b2g_n14.json;
 8. one JSON line with each kernel's error, times and launch count.
The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits non-zero before printing any result. It never imports JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_b2g_n14.json")
K1_TOL = 1e-4  # max |kernel - plain| / (max |plain| + 1), f32 roundoff
K2_TOL = 2e-4  # the same normalization tests/test_pallas_rbda.py uses
VIOL_GATE = 0.35  # shipping quality gate on the mean max_violation


def log(*parts):
    print(*parts, flush=True)


def check(ok, msg):
    """Fail the run (also under python -O, which drops asserts)."""
    if not ok:
        raise RuntimeError(msg)


def median_ms(torch, fn, reps=30, warm=3):
    """Median device time of fn over reps runs, with CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in evs)
    return times[len(times) // 2]


def hot_mpc(T, device, factorizer, nodes=14, ship=None):
    ship = ship or {}
    robot = T.B2G()
    robot.set_gait_sequence("trot", 0.8)
    cfg = T.SQPConfig(
        sqp_iters=1, n_trials=int(ship.get("ls_trials", 2)),
        corrector_iters=int(ship.get("corrector", 5)),
        admm=T.ADMMConfig(iters=int(ship.get("admm_iters", 10)),
                          factorizer=factorizer))
    return T.MPC(robot, dynamics="whole_body_rnea", nodes=nodes,
                 flip_reset=True, warm_shift=bool(ship.get("warm_shift", True)),
                 config=cfg, device=device)


def k2_samples(np, robot, B, seed):
    m = robot.model
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(robot.q0, np.float32), (B, 1))
    q[:, :3] += rng.standard_normal((B, 3)).astype(np.float32) * 0.1
    quat = rng.standard_normal((B, 4)).astype(np.float32)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] += rng.standard_normal((B, m.nq - 7)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, m.nv)).astype(np.float32)
    a = rng.standard_normal((B, m.nv)).astype(np.float32)
    return q, v, a, rng


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_flagship(dev, ship, batch, warm, timed):
    """Drive the main path through its user entry points: MPC, then
    batched_init and batched_step, ticking every scenario; each tick is
    bracketed by a device synchronize."""
    import numpy as np
    import torch

    import tpu_locoman_torch as T

    mpc = hot_mpc(T, dev, ship["factorizer"], ship=ship)
    carries = T.batched_init(mpc, batch)
    targets = torch.tensor([0.2, 0, 0, 0, 0, 0], device=dev).repeat(batch, 1)
    step = T.batched_step(mpc)
    tick_ms, viol_ticks = [], []
    status = {0: 0, 1: 0, 2: 0}
    for k in range(warm + timed):
        _sync(dev)
        t0 = time.perf_counter()
        carries, stats = step(carries, k * mpc.dt_min, targets)
        _sync(dev)
        dt = (time.perf_counter() - t0) * 1e3
        for x in (carries.x_init, carries.solver_state.Z,
                  stats["max_violation"], stats["alpha"]):
            check(bool(torch.isfinite(x).all()), f"non-finite at tick {k}")
        if k >= warm:
            tick_ms.append(dt)
            viol_ticks.append(float(stats["max_violation"].mean()))
            for s_ in stats["status"].tolist():
                status[int(s_)] += 1
    return {"tick_ms": tick_ms, "viol_mean": float(np.mean(viol_ticks)),
            "viol_worst": float(np.max(viol_ticks)), "status": status}


def profile_flagship(dev, ship, batch, path, ticks=3):
    """torch.profiler table of a few flagship ticks (after one warm-up
    tick), written to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tpu_locoman_torch as T

    mpc = hot_mpc(T, dev, ship["factorizer"], ship=ship)
    carries = T.batched_init(mpc, batch)
    targets = torch.tensor([0.2, 0, 0, 0, 0, 0], device=dev).repeat(batch, 1)
    step = T.batched_step(mpc)
    carries, _ = step(carries, 0.0, targets)
    _sync(dev)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for k in range(ticks):
            carries, _ = step(carries, (k + 1) * mpc.dt_min, targets)
        _sync(dev)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    key = "cuda_time_total" if dev.type == "cuda" else "cpu_time_total"
    with open(path, "w") as fh:
        fh.write(prof.key_averages().table(sort_by=key, row_limit=80))


def compare_paths(dev, ship, batch=8, ticks=3):
    """The kernel path against the plain path (K1's and K2's plain
    versions swapped in) from the same carry: (max |dx|, max normalized
    |dZ|) over the ticks."""
    import torch

    import tpu_locoman_torch as T
    from tpu_locoman_torch import rnea_derivs
    from tpu_locoman_torch.ocp import transcribe

    tg = torch.zeros(batch, 6, device=dev)
    tg[:, 0] = torch.linspace(0.0, 0.3, batch, device=dev)
    mk = hot_mpc(T, dev, "cholinv_pb", ship=ship)
    mp = hot_mpc(T, dev, "cholinv", ship=ship)
    ck = cp = T.batched_init(mk, batch)
    orig = transcribe.rnea_derivatives
    ex = ez = 0.0
    for k in range(ticks):
        ck, _ = mk.step(ck, k * mk.dt_min, tg)
        transcribe.rnea_derivatives = rnea_derivs.rnea_derivatives_plain
        try:
            cp, _ = mp.step(cp, k * mp.dt_min, tg)
        finally:
            transcribe.rnea_derivatives = orig
        ex = max(ex, float((ck.x_init - cp.x_init).abs().max()))
        zk, zp = ck.solver_state.Z, cp.solver_state.Z
        ez = max(ez, float((zk - zp).abs().max()) / (float(zp.abs().max()) + 1))
    return ex, ez


def replay_golden(dev, factorizer):
    """Replay the JAX golden fixture tick by tick; raises on a mismatch.

    Tolerances (measured on the CPU, B2G N=14, 5 ticks x 2 scenarios): the
    port's plain path lands within 2.1e-4 of the fixture's x and within 26%
    of each tick's max_violation (rollout mean within 3.2%); JAX itself with
    another factorizer (same math, other f32 summation order) lands within
    3.2e-4 and 11%. max_violation at 10 ADMM sweeps is the worst row at the
    iteration floor, so it moves with summation order. Held: x atol 1e-3,
    per tick |dviol| <= 40% + 1e-3, rollout mean within 10%, alpha and
    status equal. Returns (max x err, max violation err, mean violation
    rel err, ticks, batch)."""
    import numpy as np
    import torch

    import tpu_locoman_torch as T
    from tpu_locoman_torch import convert

    gold = convert.load_golden(GOLDEN)
    s = gold["setup"]
    mg = hot_mpc(T, dev, factorizer, nodes=s["nodes"], ship={
        "ls_trials": s["ls_trials"], "corrector": s["corrector"],
        "admm_iters": s["admm_iters"], "warm_shift": s["warm_shift"]})
    cg = convert.carry_from_numpy(gold["init"], dev)
    tg = torch.tensor(gold["targets"], device=dev)
    gx = gv = 0.0
    vs, refs = [], []
    for k, ref in enumerate(gold["ticks"]):
        cg, st = mg.step(cg, k * s["dt_min"], tg)
        dx = float(np.abs(cg.x_init.cpu().numpy() - ref["x"]).max())
        v = st["max_violation"].cpu().numpy()
        dv = np.abs(v - ref["max_violation"])
        check(dx <= 1e-3, f"golden tick {k}: x err {dx}")
        check(np.all(dv <= 0.4 * np.abs(ref["max_violation"]) + 1e-3),
              f"golden tick {k}: violation {v} vs {ref['max_violation']}")
        check(np.array_equal(st["alpha"].cpu().numpy(), ref["alpha"]),
              f"golden tick {k}: alpha")
        check(np.array_equal(st["status"].cpu().numpy(), ref["status"]),
              f"golden tick {k}: status")
        gx, gv = max(gx, dx), max(gv, float(dv.max()))
        vs.append(v)
        refs.append(ref["max_violation"])
    mean_rel = abs(float(np.mean(vs)) / float(np.mean(refs)) - 1.0)
    check(mean_rel <= 0.1, f"golden rollout mean violation off by {mean_rel}")
    return gx, gv, mean_rel, len(gold["ticks"]), len(s["targets_vx"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="FILE",
                    help="write a torch.profiler table of three flagship "
                         "ticks to FILE")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import tpu_locoman_torch as T
    from tpu_locoman_torch import _build, rnea_derivs
    from tpu_locoman_torch.solver import chol_base

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[1 device] nvidia-smi: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is on")

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    _build.load()
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    log(f"[2 build] kernels built and loaded in {time.time() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s); ptxas: {' | '.join(regs)}")

    # ---- 3. K1 against its plain version ---------------------------------
    rng = np.random.default_rng(0)
    k1_err = 0.0
    for b in (13, 14, 16):
        for B in (512, 5):
            A = rng.standard_normal((B, b, b)).astype(np.float32)
            S = torch.tensor(A @ A.transpose(0, 2, 1)
                             + b * np.eye(b, dtype=np.float32), device=dev)
            out = chol_base.chol_inv_base(S)
            ref = chol_base.chol_inv_base_plain(S)
            torch.cuda.synchronize()
            e = float((out - ref).abs().max())
            nrm = e / (float(ref.abs().max()) + 1.0)
            check(nrm <= K1_TOL, f"K1 b={b} B={B}: normalized error {nrm}")
            k1_err = max(k1_err, e)
    bad = torch.eye(14, device=dev).repeat(4, 1, 1)
    bad[1] = -bad[1]
    out = chol_base.chol_inv_base(bad)
    check(torch.isnan(out[1]).any() and torch.isfinite(out[0]).all(),
          "K1 must keep NaN for a non-SPD block")
    A = rng.standard_normal((512, 14, 14)).astype(np.float32)
    S = torch.tensor(A @ A.transpose(0, 2, 1) + 14 * np.eye(14, dtype=np.float32),
                     device=dev)
    k1_ms = median_ms(torch, lambda: chol_base.chol_inv_base(S))
    k1_plain_ms = median_ms(torch, lambda: chol_base.chol_inv_base_plain(S))
    log(f"[3 K1] chol_inv_base == plain for b in (13, 14, 16), B in (512, 5): "
        f"max abs err {k1_err:.3g} (normalized tol {K1_TOL}); NaN kept for a "
        f"non-SPD block; B=512 b=14: kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.4f} ms")

    # ---- 4. K2 against its plain version ---------------------------------
    robot = T.B2G()
    robot.set_gait_sequence("trot", 0.8)
    m = robot.model
    ee = tuple(robot.FOOT_FRAMES) + (robot.ext_force_frame,)
    k2_err = 0.0
    k2_inputs = None
    for B in (7168, 5):
        q, v, a, r2 = k2_samples(np, robot, B, seed=B)
        f = r2.standard_normal((B, 3 * len(ee))).astype(np.float32) * 50.0
        qt, vt, at, ft = (torch.tensor(x, device=dev) for x in (q, v, a, f))
        for with_f in (True, False):
            args_ = (m, qt, vt, at, ee, ft) if with_f else (m, qt, vt, at)
            out = rnea_derivs.rnea_derivatives(*args_)
            ref = rnea_derivs.rnea_derivatives_plain(*args_)
            torch.cuda.synchronize()
            check(len(out) == len(ref) == (4 if with_f else 3),
                  f"K2 outputs: {len(out)} from the kernel, {len(ref)} plain")
            for name, o, r in zip(("dq", "dv", "da", "df"), out, ref):
                e = float((o - r).abs().max())
                tol = K2_TOL * (float(r.abs().max()) + 1.0)
                check(e <= tol,
                      f"K2 {name} B={B} forces={with_f}: {e} > {tol}")
                k2_err = max(k2_err, e)
        if B == 7168:
            k2_inputs = (m, qt, vt, at, ee, ft)
    m_, q_, v_, a_, ee_, f_ = k2_inputs
    fq = rnea_derivs.forward_quantities(m_, q_, v_, a_, ee_, f_)
    k2_ms = median_ms(torch, lambda: rnea_derivs.derivative_pass(
        m_, fq, v_, a_, ee_, f_), reps=20)
    k2_plain_ms = median_ms(torch, lambda: rnea_derivs.derivative_pass_plain(
        m_, fq, v_, a_, ee_, f_), reps=20)
    fwd_ms = median_ms(torch, lambda: rnea_derivs.forward_quantities(
        m_, q_, v_, a_, ee_, f_), reps=20)
    log(f"[4 K2] rnea_derivatives == plain for B2G B in (7168, 5), with and "
        f"without forces: max abs err {k2_err:.3g} (tol {K2_TOL}*(max+1)); "
        f"B=7168 with forces, derivative pass: kernel {k2_ms:.3f} ms, plain "
        f"{k2_plain_ms:.3f} ms; the plain-torch forward pass both take "
        f"first: {fwd_ms:.3f} ms")

    # ---- 5. the flagship main path -----------------------------------------
    with open(os.path.join(ROOT, "SHIPPING.json")) as fh:
        ship = json.load(fh)["bench_defaults"]
    batch, warm, timed = 512, 2, 20
    chol_base.launches = 0
    rnea_derivs.launches = 0
    fl = run_flagship(dev, ship, batch, warm, timed)
    k1_launches, k2_launches = chol_base.launches, rnea_derivs.launches
    ticks = warm + timed
    check(k1_launches == 120 * ticks, f"K1 launches {k1_launches}")
    check(k2_launches == ticks, f"K2 launches {k2_launches}")
    check(fl["viol_mean"] <= VIOL_GATE,
          f"violation mean {fl['viol_mean']} > {VIOL_GATE}")
    tick_ms = fl["tick_ms"]
    ms_mean = float(np.mean(tick_ms))
    log(f"[5 flagship] B2G whole_body_rnea N=14 batch {batch} "
        f"({ship['factorizer']}, admm {ship['admm_iters']}, corrector "
        f"{ship['corrector']}, ls {ship['ls_trials']}): {ms_mean:.2f} ms/tick "
        f"mean, {float(np.median(tick_ms)):.2f} p50, min {min(tick_ms):.2f}, "
        f"max {max(tick_ms):.2f} over {timed} ticks; "
        f"{batch * 1e3 / ms_mean:.1f} solves/s; max_violation mean "
        f"{fl['viol_mean']:.4f} worst tick {fl['viol_worst']:.4f} (gate "
        f"{VIOL_GATE}); status {fl['status']}; launches K1 {k1_launches} "
        f"K2 {k2_launches} over {ticks} ticks; host load average "
        f"{os.getloadavg()[0]:.2f} on {os.cpu_count()} cores")
    if args.profile:
        profile_flagship(dev, ship, batch, args.profile)
        log(f"[5b profile] three flagship ticks profiled -> {args.profile}")

    # ---- 6. kernel path against plain path ---------------------------------
    ex, ez = compare_paths(dev, ship, batch=8, ticks=3)
    check(ex <= 1e-3 and ez <= 1e-3, f"kernel vs plain path: x {ex} Z {ez}")
    log(f"[6 paths] kernel path == plain path on the card, batch 8, 3 "
        f"ticks: x max abs err {ex:.3g} (tol 1e-3), Z normalized err "
        f"{ez:.3g} (tol 1e-3)")

    # ---- 7. JAX golden fixture -----------------------------------------------
    gx, gv, grel, n_ticks, n_b = replay_golden(dev, "cholinv_pb")
    log(f"[7 golden] JAX fixture replayed ({n_ticks} ticks, batch {n_b}): x "
        f"max abs err {gx:.3g} (tol 1e-3), violation max abs err {gv:.3g} "
        f"(tol 40% + 1e-3 per tick), rollout mean violation off by "
        f"{100 * grel:.2f}% (tol 10%), alpha and status equal")

    # ---- 8. kernels ------------------------------------------------------------
    kernels = [
        {"name": "chol_inv_base", "route": "cuda",
         "source": "tpu_locoman_torch/csrc/chol_inv_base.cu",
         "replaces": "tpu_locoman/solver/pallas_base.py:101",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "rnea_derivs", "route": "cuda",
         "source": "tpu_locoman_torch/csrc/rnea_derivs.cu",
         "replaces": "tpu_locoman/pallas_rbda.py:227",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
