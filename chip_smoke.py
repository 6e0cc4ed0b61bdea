#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_locoman_torch) on one GPU.

    python3 chip_smoke.py                  # the whole check, a few minutes
                                           # on an H100
    python3 chip_smoke.py --profile FILE   # also write torch.profiler tables
                                           # of three flagship ticks to FILE
                                           # and of three accurate ones to
                                           # FILE.accurate

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
 8. K3 (fac_whole) against its plain version on the card, at the two
    shapes of the accurate path, batch 1 and 512;
 9. the accurate single-robot path: B2G N=14, SQPConfig.accurate() with
    factorizer "pallas", batch 1 — 2 warm-up and 20 timed MPC.step ticks,
    then one MPC.run rollout, with the launch counts of each;
10. accurate mode at production batch: config="accurate" (cholinv_pb),
    batch 512, 1 warm-up and 5 timed ticks;
11. the factorizers "pallas" and "babe_pb" against "cholinv_pb" (hot
    config, batch 8, 3 ticks), and each one's solve error on that run's
    KKT blocks against a float64 solve;
12. replay of the accurate JAX golden fixture
    tests/data/torch_golden_b2g_n14_accurate.json with "pallas";
13. one JSON line with each kernel's error, times, bound and launch count.
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
GOLDEN_ACC = os.path.join(ROOT, "tests", "data",
                          "torch_golden_b2g_n14_accurate.json")
K1_TOL = 1e-4  # max |kernel - plain| / (max |plain| + 1), f32 roundoff
K2_TOL = 2e-4  # the same normalization tests/test_pallas_rbda.py uses
K3_TOL = 1e-4  # as K1, on Linv, W, V and one solve_factorized
VIOL_GATE = 0.35  # shipping quality gate on the mean max_violation
ACC_GATE = 1e-3  # the accurate preset's contract on the mean max_violation
ACC_X_TOL = 5e-3  # accurate golden: x (see replay_golden)
ACC_VIOL_TOL = 2e-4  # accurate golden: per tick |dviol| (see replay_golden)
# NVIDIA's data sheet, H100 SXM: memory rate, and the f32 rate outside the
# tensor cores (the solver runs no TF32)
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12


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


def bound(nbytes, ops):
    """(ms, what bounds it): the least time the card could take to move
    nbytes and do ops f32 operations."""
    t_b, t_o = nbytes / H100_BYTES_PER_S, ops / H100_F32_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def hot_mpc(T, device, factorizer, nodes=14, ship=None):
    """B2G MPC with the hot config (or, with ship["eq_projection"], the
    accurate one) read from a SHIPPING.json-style dict."""
    ship = ship or {}
    robot = T.B2G()
    robot.set_gait_sequence("trot", 0.8)
    cfg = T.SQPConfig(
        sqp_iters=1, n_trials=int(ship.get("ls_trials", 2)),
        corrector_iters=int(ship.get("corrector", 5)),
        eq_projection=int(ship.get("eq_projection", 0)),
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


def run_ticks(step, carry, target, dt, warm, timed):
    """Tick with step(carry, t, target) from carry, each tick bracketed by a
    device synchronize; every output must be finite."""
    import numpy as np
    import torch

    tick_ms, viol_ticks = [], []
    status = {0: 0, 1: 0, 2: 0}
    for k in range(warm + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, stats = step(carry, k * dt, target)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for x in (carry.x_init, carry.solver_state.Z, stats["max_violation"],
                  stats["alpha"]):
            check(bool(torch.isfinite(x).all()), f"non-finite at tick {k}")
        if k >= warm:
            tick_ms.append(ms)
            viol_ticks.append(float(stats["max_violation"].mean()))
            for s_ in stats["status"].tolist():
                status[int(s_)] += 1
    return {"tick_ms": tick_ms, "viol_mean": float(np.mean(viol_ticks)),
            "viol_worst": float(np.max(viol_ticks)), "status": status}


def run_flagship(dev, ship, batch, warm, timed):
    """Drive the main path through its user entry points: MPC, then
    batched_init and batched_step, ticking every scenario."""
    import torch

    import tpu_locoman_torch as T

    mpc = hot_mpc(T, dev, ship["factorizer"], ship=ship)
    targets = torch.tensor([0.2, 0, 0, 0, 0, 0], device=dev).repeat(batch, 1)
    return run_ticks(T.batched_step(mpc), T.batched_init(mpc, batch), targets,
                     mpc.dt_min, warm, timed)


def profile_ticks(step, carry, target, dt, path, ticks=3):
    """torch.profiler table of a few ticks (after one warm-up tick),
    written to ``path``. Returns per tick: the device time of all kernels
    (ms), the kernel launches, and the host time under the profiler (ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    carry, _ = step(carry, 0.0, target)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(ticks):
            carry, _ = step(carry, (k + 1) * dt, target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total", row_limit=80))
    return (device_us / 1e3 / ticks, sum(e.count for e in kernels) / ticks,
            wall_ms)


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


def replay_golden(dev, factorizer, path=GOLDEN):
    """Replay a JAX golden fixture tick by tick; raises on a mismatch.

    Hot fixture (measured on the CPU, B2G N=14, 5 ticks x 2 scenarios): the
    port's plain path lands within 2.1e-4 of the fixture's x and within 26%
    of each tick's max_violation (rollout mean within 3.2%); JAX itself with
    another factorizer (same math, other f32 summation order) lands within
    3.2e-4 and 11%. max_violation at 10 ADMM sweeps is the worst row at the
    iteration floor, so it moves with summation order. Held: x atol 1e-3,
    per tick |dviol| <= 40% + 1e-3, rollout mean within 10%, alpha and
    status equal.

    Accurate fixture (its setup has eq_projection > 0; B2G N=14, batch 1,
    5 ticks): the four equality projections per tick take max_violation to
    1.1e-4 - 1.7e-4 in the fixture, and carry f32 roundoff into the
    state. Measured on the CPU: the port ("pallas" and "cholinv") lands
    within 1.7e-3 of the fixture's x and 9.9e-5 of each tick's
    max_violation; JAX itself with the "sequential" or "babe" factorizer
    lands within 1.7e-3 and 1.1e-4. Held: x atol ACC_X_TOL, per tick max_violation <=
    ACC_GATE on both sides and within ACC_VIOL_TOL absolute of the fixture,
    alpha and status equal.

    Returns (max x err, max violation err, mean violation rel err, ticks,
    batch)."""
    import numpy as np
    import torch

    import tpu_locoman_torch as T
    from tpu_locoman_torch import convert

    gold = convert.load_golden(path)
    s = gold["setup"]
    accurate = s.get("eq_projection", 0) > 0
    mg = hot_mpc(T, dev, factorizer, nodes=s["nodes"], ship={
        "ls_trials": s["ls_trials"], "corrector": s["corrector"],
        "admm_iters": s["admm_iters"], "warm_shift": s["warm_shift"],
        "eq_projection": s.get("eq_projection", 0)})
    cg = convert.carry_from_numpy(gold["init"], dev)
    tg = torch.tensor(gold["targets"], device=dev)
    gx = gv = 0.0
    vs, refs = [], []
    for k, ref in enumerate(gold["ticks"]):
        cg, st = mg.step(cg, k * s["dt_min"], tg)
        dx = float(np.abs(cg.x_init.cpu().numpy() - ref["x"]).max())
        v = st["max_violation"].cpu().numpy()
        rv = ref["max_violation"]
        dv = np.abs(v - rv)
        check(dx <= (ACC_X_TOL if accurate else 1e-3),
              f"golden tick {k}: x err {dx}")
        if accurate:
            ok = (np.all(v <= ACC_GATE) and np.all(rv <= ACC_GATE)
                  and np.all(dv <= ACC_VIOL_TOL))
        else:
            ok = np.all(dv <= 0.4 * np.abs(rv) + 1e-3)
        check(ok, f"golden tick {k}: violation {v} vs {rv}")
        check(np.array_equal(st["alpha"].cpu().numpy(), ref["alpha"]),
              f"golden tick {k}: alpha")
        check(np.array_equal(st["status"].cpu().numpy(), ref["status"]),
              f"golden tick {k}: status")
        gx, gv = max(gx, dx), max(gv, float(dv.max()))
        vs.append(v)
        refs.append(rv)
    mean_rel = abs(float(np.mean(vs)) / float(np.mean(refs)) - 1.0)
    if not accurate:
        check(mean_rel <= 0.1,
              f"golden rollout mean violation off by {mean_rel}")
    return gx, gv, mean_rel, len(gold["ticks"]), len(s["targets_vx"])


def k3_work(Bs, K, s):
    """(bytes, f32 operations) of one factorize_whole call. Operations per
    scenario: Cholesky and inverse 2s^3/3 on every node; the Schur update
    F^T F and W = Linv F_prev^T, s^2(s+1) each, on the K-1 nodes with a
    predecessor; F = Linv U and V = Linv^T F, s^2(s+1) each, on the K-1
    nodes with a successor. Bytes: H and U read once, Linv, W, V written
    once."""
    tri = s * s * (s + 1)
    ops = K * 2 * s ** 3 / 3 + 4 * (K - 1) * tri
    return 4 * Bs * s * s * (K + (K - 1) + 3 * K), Bs * ops


def k3_inputs(torch, dev, Bs, K, s, seed):
    """Seeded SPD node blocks and couplings, as tests/test_qp.py makes
    them: H = A A^T / s + 3 I, U = 0.1 N(0, 1), and a right-hand side."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(Bs, K, s, s, generator=g, device=dev)
    H = A @ A.transpose(-1, -2) / s + 3.0 * torch.eye(s, device=dev)
    U = 0.1 * torch.randn(Bs, K - 1, s, s, generator=g, device=dev)
    b = torch.randn(Bs, K, s, generator=g, device=dev)
    return H, U, b


def accurate_mpc(T, config):
    """The accurate entry point as a user builds it: B2G + Z1,
    whole_body_rnea, N=14, trot 0.8 s, on the default device (the card)."""
    robot = T.B2G()
    robot.set_gait_sequence("trot", 0.8)
    return T.MPC(robot, dynamics="whole_body_rnea", nodes=14, config=config)


def ms_summary(tick_ms):
    import numpy as np

    return (f"{float(np.mean(tick_ms)):.2f} ms/tick mean, "
            f"{float(np.median(tick_ms)):.2f} p50, min {min(tick_ms):.2f}, "
            f"max {max(tick_ms):.2f} over {len(tick_ms)} ticks")


def compare_factorizers(dev, ship, names, batch=8, ticks=3):
    """Each factorizer in names against "cholinv_pb" on the hot config from
    the same carry. Returns ({name: (max |dx|, max normalized |dZ|)},
    {name: solve error}): the second, for "cholinv_pb" and each name, is
    the worst relative error max |x - x64| / max |x64| of one seeded solve
    of each KKT system that the reference run factorized (the flagship's
    real blocks), against the plain recursion in float64."""
    import torch

    import tpu_locoman_torch as T
    from tpu_locoman_torch.solver import fac_whole
    from tpu_locoman_torch.solver import qp as tqp

    tg = torch.zeros(batch, 6, device=dev)
    tg[:, 0] = torch.linspace(0.0, 0.3, batch, device=dev)
    ref = hot_mpc(T, dev, "cholinv_pb", ship=ship)
    c0 = T.batched_init(ref, batch)
    refs, blocks, cr = [], [], c0
    by_name = tqp._factorize_by_name

    def keep(H, U, factorizer="auto", base=16):
        blocks.append((H.clone(), U.clone()))
        return by_name(H, U, factorizer, base)

    tqp._factorize_by_name = keep
    try:
        for k in range(ticks):
            cr, _ = ref.step(cr, k * ref.dt_min, tg)
            refs.append(cr)
    finally:
        tqp._factorize_by_name = by_name
    solve_err = dict.fromkeys(("cholinv_pb",) + tuple(names), 0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for H, U in blocks:
        s = H.shape[-1]
        Uf = torch.cat([U, U.new_zeros(U.shape[:-1] + (s - U.shape[-1],))], -1)
        b = torch.randn(H.shape[:-1], generator=gen, device=dev)
        x64 = tqp.solve_factorized(fac_whole.factorize_whole_plain(
            H.double(), Uf.double()), b.double())
        for name in solve_err:
            fac = by_name(H, Uf if name == "pallas" else U, name)
            x = tqp._solver_for(fac)(fac, b).double()
            solve_err[name] = max(solve_err[name], float(
                (x - x64).abs().max() / x64.abs().max()))
    out = {}
    for name in names:
        m = hot_mpc(T, dev, name, ship=ship)
        c, ex, ez = c0, 0.0, 0.0
        for k in range(ticks):
            c, _ = m.step(c, k * m.dt_min, tg)
            zr = refs[k].solver_state.Z
            ex = max(ex, float((c.x_init - refs[k].x_init).abs().max()))
            ez = max(ez, float((c.solver_state.Z - zr).abs().max())
                     / (float(zr.abs().max()) + 1))
        out[name] = (ex, ez)
    return out, solve_err


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="FILE",
                    help="write torch.profiler tables of three flagship "
                         "ticks to FILE and of three accurate single-robot "
                         "ticks to FILE.accurate")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import tpu_locoman_torch as T
    from tpu_locoman_torch import _build, rnea_derivs
    from tpu_locoman_torch.solver import chol_base, fac_whole
    from tpu_locoman_torch.solver import qp as tqp

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
    # yardstick (the port never calls it): no one PyTorch call gives L^-1
    # from S, so cholesky followed by a triangular solve against I
    eye14 = torch.eye(14, device=dev).expand(512, 14, 14)
    k1_lib_ms = median_ms(torch, lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky(S), eye14, upper=False))
    # bytes: S read, L^-1 written; operations: Cholesky and inverse, b^3/3
    # each
    k1_bound = bound(2 * S.numel() * 4, 512 * 2 * 14 ** 3 / 3)
    log(f"[3 K1] chol_inv_base == plain for b in (13, 14, 16), B in (512, 5): "
        f"max abs err {k1_err:.3g} (normalized tol {K1_TOL}); NaN kept for a "
        f"non-SPD block; B=512 b=14: kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.4f} ms, cholesky + solve_triangular "
        f"{k1_lib_ms:.4f} ms, bound {k1_bound[0]:.6f} ms ({k1_bound[1]})")

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
    # bytes: the kernel's inputs (forward quantities, v, a, forces) read and
    # its four outputs written; operations: per live (link, dof) pair of the
    # ancestry, 6 spatial-inertia products (72 each), 8 spatial cross
    # products (30 each) and its share of the three subtree sums (36)
    k2_in = [fq[k] for k in ("Sw", "Iw", "sdot", "Vl", "A", "Iv", "IA", "f",
                             "pf")] + [v_, a_, f_]
    nv, nfr = m_.nv, len(ee_)
    k2_out = 7168 * (3 * nv * nv + nv * 3 * nfr)
    pairs = float(m_.tensors(dev)["anc"].sum())
    k2_bound = bound(4 * (sum(t.numel() for t in k2_in) + k2_out),
                     7168 * pairs * (6 * 72 + 8 * 30 + 36))
    log(f"[4 K2] rnea_derivatives == plain for B2G B in (7168, 5), with and "
        f"without forces: max abs err {k2_err:.3g} (tol {K2_TOL}*(max+1)); "
        f"B=7168 with forces, derivative pass: kernel {k2_ms:.3f} ms, plain "
        f"{k2_plain_ms:.3f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]}); "
        f"the plain-torch forward pass both take first: {fwd_ms:.3f} ms")

    # ---- 5. the flagship main path -----------------------------------------
    with open(os.path.join(ROOT, "SHIPPING.json")) as fh:
        ship = json.load(fh)["bench_defaults"]
    batch, warm, timed = 512, 2, 20
    chol_base.launches = rnea_derivs.launches = fac_whole.launches = 0
    fl = run_flagship(dev, ship, batch, warm, timed)
    k1_launches, k2_launches = chol_base.launches, rnea_derivs.launches
    ticks = warm + timed
    check(k1_launches == 120 * ticks, f"K1 launches {k1_launches}")
    check(k2_launches == ticks, f"K2 launches {k2_launches}")
    check(fac_whole.launches == 0, f"K3 launches {fac_whole.launches}")
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
        mpc = hot_mpc(T, dev, ship["factorizer"], ship=ship)
        targets = torch.tensor([0.2, 0, 0, 0, 0, 0], device=dev).repeat(
            batch, 1)
        dev_ms, n_k, wall = profile_ticks(
            T.batched_step(mpc), T.batched_init(mpc, batch), targets,
            mpc.dt_min, args.profile)
        log(f"[5b profile] three flagship ticks -> {args.profile}: device "
            f"{dev_ms:.2f} ms/tick in {n_k:.0f} kernels; {wall:.2f} ms/tick "
            f"under the profiler, {ms_mean:.2f} without (idle "
            f"{100 * (1 - dev_ms / ms_mean):.1f}% of the unprofiled tick)")

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

    # ---- 8. K3 against its plain version ---------------------------------
    k3_err, k3_rows = 0.0, []
    for K, s_ in ((15, 105), (14, 110)):
        for Bs in (1, 512):
            H, U, b = k3_inputs(torch, dev, Bs, K, s_, seed=K * Bs)
            out = fac_whole.factorize_whole(H, U)
            ref = fac_whole.factorize_whole_plain(H, U)
            pairs = [(name, getattr(out, name), getattr(ref, name))
                     for name in ("Linv", "W", "V")]
            pairs.append(("solve", tqp.solve_factorized(out, b),
                          tqp.solve_factorized(ref, b)))
            torch.cuda.synchronize()
            for name, o, r in pairs:
                e = float((o - r).abs().max())
                nrm = e / (float(r.abs().max()) + 1.0)
                check(nrm <= K3_TOL,
                      f"K3 {name} K={K} s={s_} Bs={Bs}: normalized {nrm}")
                k3_err = max(k3_err, e)
            reps = 10 if Bs > 1 else 30
            k_ms = median_ms(torch, lambda: fac_whole.factorize_whole(H, U),
                             reps=reps)
            p_ms = median_ms(torch, lambda: fac_whole.factorize_whole_plain(
                H, U), reps=reps)
            pb_ms = median_ms(torch, lambda: tqp.factorize(
                H, U, chol_impl="cholinv_pb"), reps=reps)
            nbytes, ops = k3_work(Bs, K, s_)
            k3_rows.append({"K": K, "s": s_, "Bs": Bs, "ms": k_ms,
                            "plain_ms": p_ms, "cholinv_pb_ms": pb_ms,
                            "bound": bound(nbytes, ops), "mflop": ops / 1e6,
                            "mb": nbytes / 1e6})
            del H, U, b, out, ref, pairs
    bad = torch.eye(10, device=dev).repeat(2, 4, 1, 1)
    bad[1, 2] = -bad[1, 2]
    out = fac_whole.factorize_whole(bad, torch.zeros(2, 3, 10, 10, device=dev))
    check(torch.isnan(out.Linv[1, 2]).any() and torch.isfinite(out.Linv[0]).all(),
          "K3 must keep NaN for a non-SPD block")
    log(f"[8 K3] factorize_whole == plain (Linv, W, V, solve) for (K, s) in "
        f"((15, 105), (14, 110)), Bs in (1, 512): max abs err {k3_err:.3g} "
        f"(normalized tol {K3_TOL}); NaN kept for a non-SPD block; " + "; ".join(
            f"K={r['K']} s={r['s']} Bs={r['Bs']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, cholinv_pb {r['cholinv_pb_ms']:.4f}"
            f" ms, bound {r['bound'][0]:.6f} ms ({r['bound'][1]}: "
            f"{r['mflop']:.1f} MFLOP, {r['mb']:.2f} MB)" for r in k3_rows))

    # ---- 9. the accurate single-robot path -----------------------------------
    acc_cfg = T.SQPConfig.accurate()._replace(
        admm=T.ADMMConfig(iters=10, factorizer="pallas"))
    chol_base.launches = rnea_derivs.launches = fac_whole.launches = 0
    acc_mpc = accurate_mpc(T, acc_cfg)
    check(acc_mpc.device.type == "cuda", "MPC did not default to the card")
    warm, timed = 2, 20
    target = torch.tensor([[0.2, 0, 0, 0, 0, 0]], device=dev)
    acc = run_ticks(acc_mpc.step, acc_mpc.init_carry(1), target,
                    acc_mpc.dt_min, warm, timed)
    acc_launches = (chol_base.launches, rnea_derivs.launches,
                    fac_whole.launches)
    ticks = warm + timed
    check(acc_launches == (0, 5 * ticks, 5 * ticks),
          f"accurate path launches K1, K2, K3 = {acc_launches}")
    check(acc["viol_mean"] <= ACC_GATE,
          f"accurate violation mean {acc['viol_mean']} > {ACC_GATE}")
    chol_base.launches = rnea_derivs.launches = fac_whole.launches = 0
    _, outs = acc_mpc.run(10, target)
    run_launches = (chol_base.launches, rnea_derivs.launches,
                    fac_whole.launches)
    check(run_launches == (0, 50, 50), f"MPC.run launches {run_launches}")
    for k_, x in outs.items():
        check(bool(torch.isfinite(x.float()).all()), f"MPC.run: non-finite {k_}")
    run_viol = float(outs["max_violation"].mean())
    check(run_viol <= ACC_GATE, f"MPC.run violation mean {run_viol}")
    log(f"[9 accurate] B2G whole_body_rnea N=14 batch 1, SQPConfig.accurate() "
        f"with factorizer pallas: {ms_summary(acc['tick_ms'])}; max_violation "
        f"mean {acc['viol_mean']:.3g} worst tick {acc['viol_worst']:.3g} "
        f"(gate {ACC_GATE}); status {acc['status']}; launches K1 "
        f"{acc_launches[0]} K2 {acc_launches[1]} K3 {acc_launches[2]} over "
        f"{ticks} ticks; MPC.run(10): max_violation mean {run_viol:.3g}, "
        f"status {outs['status'].flatten().tolist()}, launches K1 "
        f"{run_launches[0]} K2 {run_launches[1]} K3 {run_launches[2]}")
    if args.profile:
        path = args.profile + ".accurate"
        acc_ms = float(np.mean(acc["tick_ms"]))
        dev_ms, n_k, wall = profile_ticks(
            acc_mpc.step, acc_mpc.init_carry(1), target, acc_mpc.dt_min, path)
        log(f"[9b profile] three accurate single-robot ticks -> {path}: "
            f"device {dev_ms:.2f} ms/tick in {n_k:.0f} kernels; {wall:.2f} "
            f"ms/tick under the profiler, {acc_ms:.2f} without (idle "
            f"{100 * (1 - dev_ms / acc_ms):.1f}% of the unprofiled tick)")
    del acc_mpc

    # ---- 10. accurate mode at production batch --------------------------------
    chol_base.launches = rnea_derivs.launches = fac_whole.launches = 0
    warm, timed = 1, 5
    prod_mpc = accurate_mpc(T, "accurate")
    prod = run_ticks(prod_mpc.step, prod_mpc.init_carry(512),
                     target.repeat(512, 1), prod_mpc.dt_min, warm, timed)
    ticks = warm + timed
    prod_launches = (chol_base.launches, rnea_derivs.launches,
                     fac_whole.launches)
    check(prod_launches[0] > 0 and prod_launches[1] == 5 * ticks
          and prod_launches[2] == 0,
          f"accurate batch 512 launches K1, K2, K3 = {prod_launches}")
    check(prod["viol_mean"] <= ACC_GATE,
          f"accurate batch 512 violation mean {prod['viol_mean']}")
    prod_ms = float(np.mean(prod["tick_ms"]))
    log(f"[10 accurate b512] config=\"accurate\" (cholinv_pb) batch 512: "
        f"{ms_summary(prod['tick_ms'])}; {512e3 / prod_ms:.1f} solves/s; "
        f"max_violation mean {prod['viol_mean']:.3g} worst tick "
        f"{prod['viol_worst']:.3g} (gate {ACC_GATE}); status "
        f"{prod['status']}; launches per tick K1 {prod_launches[0] // ticks} "
        f"K2 {prod_launches[1] // ticks} K3 {prod_launches[2] // ticks}")

    # ---- 11. factorizers against each other -----------------------------------
    fz, fz_solve = compare_factorizers(dev, ship, ("pallas", "babe_pb"))
    for name, (ex, ez) in fz.items():
        check(ex <= 1e-3 and ez <= 1e-3,
              f"{name} vs cholinv_pb: x {ex} Z {ez}")
    log("[11 factorizers] hot config batch 8, 3 ticks, against cholinv_pb: "
        + "; ".join(f"{n} x max abs err {ex:.3g}, Z normalized err {ez:.3g}"
                    for n, (ex, ez) in fz.items()) + " (tol 1e-3 each); "
        "solve error on the run's KKT blocks against float64, worst tick: "
        + ", ".join(f"{n} {e:.3g}" for n, e in fz_solve.items()))

    # ---- 12. accurate JAX golden fixture -----------------------------------------
    gx, gv, _, n_ticks, n_b = replay_golden(dev, "pallas", GOLDEN_ACC)
    log(f"[12 golden accurate] JAX fixture replayed with pallas ({n_ticks} "
        f"ticks, batch {n_b}): x max abs err {gx:.3g} (tol {ACC_X_TOL}), violation "
        f"max abs err {gv:.3g} (tol {ACC_VIOL_TOL}, and <= {ACC_GATE} on "
        f"both sides), alpha and status equal")

    # ---- 13. kernels ------------------------------------------------------------
    k3_main = next(r for r in k3_rows if (r["K"], r["Bs"]) == (14, 1))
    kernels = [
        {"name": "chol_inv_base", "route": "cuda",
         "source": "tpu_locoman_torch/csrc/chol_inv_base.cu",
         "replaces": "tpu_locoman/solver/pallas_base.py:101",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": k1_lib_ms,
         "at": "B=512 b=14; launches: flagship, 22 ticks"},
        {"name": "rnea_derivs", "route": "cuda",
         "source": "tpu_locoman_torch/csrc/rnea_derivs.cu",
         "replaces": "tpu_locoman/pallas_rbda.py:227",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None,
         "at": "B=7168 with forces; launches: flagship, 22 ticks"},
        {"name": "fac_whole", "route": "cuda",
         "source": "tpu_locoman_torch/csrc/fac_whole.cu",
         "replaces": "tpu_locoman/solver/pallas_fac.py:155",
         "launches": acc_launches[2], "max_abs_err": k3_err,
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"],
         "bound_ms": k3_main["bound"][0], "bound_by": k3_main["bound"][1],
         "library_ms": None,
         "at": "Bs=1 K=14 s=110; launches: accurate single robot, 22 ticks"},
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
