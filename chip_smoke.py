#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_locoman_torch) on one GPU.

    python3 chip_smoke.py                  # the whole check, a few minutes
                                           # on an H100
    python3 chip_smoke.py --profile FILE   # also write torch.profiler tables
                                           # of three flagship ticks to FILE,
                                           # of three accurate ones to
                                           # FILE.accurate, of three
                                           # whole_body_aba ones to FILE.aba,
                                           # of three sequential flagship
                                           # ones to FILE.seq and of three
                                           # ticks of each variant path to
                                           # FILE.rnea_noacc, .acc_nobase and
                                           # .euler, after every timed phase

Phases, one line each (any failure raises; exit code non-zero):
 1. device: nvidia-smi name and power limit, torch and CUDA versions;
 2. build the CUDA kernels from tpu_locoman_torch/csrc (nvcc, sm_90a);
 3. K1 (chol_inv_node: a whole node block per CTA) against its plain
    version on the card, at the path's node shapes;
 4. K2 (rnea_derivs) against its plain version on the card, B2G at the
    flagship's and the accurate path's flat batches and Go2, with the device
    ms of the plain-torch forward pass that feeds it;
 5. the flagship main path: B2G + Z1 whole_body_rnea, N=14, trot 0.8 s,
    the SHIPPING.json bench_defaults, batch 512, target vx 0.2 — 2 warm-up
    and 20 timed ticks, with the kernel launch counts of that run;
 6. the kernel path against the plain path on the card (batch 8, 3 ticks);
 7. replay of the JAX golden fixture tests/data/torch_golden_b2g_n14.json;
 8. K3 (fac_whole) against its plain version on the card, at the two
    shapes of the accurate path, batch 1 and 512, beside the times of its
    first, column-by-column design;
 9. the accurate single-robot path: B2G N=14, SQPConfig.accurate() with
    factorizer "pallas", batch 1 — 2 warm-up and 20 timed MPC.step ticks,
    then one MPC.run rollout, with the launch counts of each;
10. accurate mode at production batch: config="accurate" (cholinv_pb),
    batch 512, 1 warm-up and 5 timed ticks;
11. the factorizers "pallas" and "babe_pb" against "cholinv_pb" (hot
    config, batch 8, 3 ticks), and each one's solve error on that run's
    KKT blocks against a float64 solve, beside the plain f32 "cholinv";
12. replay of the accurate JAX golden fixture
    tests/data/torch_golden_b2g_n14_accurate.json with "pallas";
13. rbda.aba_derivatives (one K1 and one K2 launch) against its plain
    route on the card, B2G at the flat batch of the whole_body_aba path
    (7168) with forces; the identity aba(q, v, rnea(q, v, a, f), f) = a;
    K1's device ms at that path's mass-matrix shapes (7168, 24) and
    (14336, 24);
14. the whole_body_aba path: B2G + Z1 whole_body_aba, N=14, the hot config,
    batch 512 — 2 warm-up and 10 timed ticks, then one MPC.retract, with
    the launch counts of each;
15. replay of the JAX golden fixture
    tests/data/torch_golden_b2g_n14_aba.json (whole_body_aba);
16. whole_body_acc, centroidal_acc and centroidal_vel on B2G N=14, batch 8,
    3 ticks each, and whole_body_acc's kernel path against its plain path;
17. the flagship with the factorizer "sequential" (bench.py's in-code
    default), batch 512, 2 warm-up and 10 timed ticks (no K1), and its
    agreement with "cholinv_pb" at batch 8;
18. N=30 with "sequential" and with "cyclic", batch 512, 1 warm-up and 5
    timed ticks each, and cyclic's agreement with sequential at batch 8;
19. a Ruiz-scaled cold start (examples/run_mpc.py's defaults with
    scaling_iters=3, cholinv_pb), batch 512, 5 ticks from init_carry, and
    the replay of its JAX fixture;
20. B2 with the front payload on the hot config, batch 512, 2 warm-up and
    10 timed ticks, and the replay of its JAX fixture;
21. the parity ABI v1 dump of the port (B2G N=14, accurate, batch 1) over
    the first ticks of tools/golden_b2g_rnea_n14.json, held open loop to
    its states, diffed against it and against JAX's dump held the same way;
22. whole_body_rnea(include_acc=False) (the whole-stage linearize, K2
    through rnea_ad's forward-mode rule), 23. whole_body_acc(include_base=
    False) and 24. B2G(use_quaternion=False) whole_body_rnea (the split
    linearize with AD through the plain recursion): B2G N=14, the hot
    config, batch 512, 2 warm-up and 5 timed ticks each, with launches,
    peak device memory and the tick time against the flagship's, gated
    at JAX's survey (survey_gate), and each one's JAX fixture replayed;
25. the six variants' kernel path against their plain path (batch 8, 3
    ticks), and include_acc=False's whole-stage linearize at batch 512
    with K2 launched inside torch.func against K2's plain pass;
26. checkpoint save / load / resume on the card, diagnostics.structure_check
    of the flagship and of include_acc=False, and rnea_wf, crba_wf and
    ccrba_wf against the recursions at B=7168;
27. the exported step (tpu_locoman_torch.aot): the flagship at batch 512
    and the accurate single robot (pallas) at batch 1, each exported with
    its retraction, saved to bytes and loaded by a worker process started
    after phase 2 (minutes of host work that overlap phases 3-26), then,
    on the idle card, 3 ticks of the artifact against 3 eager ticks from
    the same carry, with the artifact's launches (K1 15 and K2 1 per
    flagship tick, K2 5 and K3 5 per accurate tick) and the export, load
    and tick times; then (27b) the flagship and include_acc=False timed
    again with the workers gone, against phases 5 and 22;
28. tpu_locoman_torch.dryrun.dryrun_multichip at the flagship's width,
    batch 512, 2 ticks: NCCL over the card count (1 here) and two gloo
    processes sharing the card, each sharded == unsharded, and each slice
    run unsharded at the local batch (a sharding fault against a change
    of batch size);
29. the run_mpc example at its defaults (batch 1, 100 loops) with --dump
    and --viz, held to the verify skill's health criteria, its scene
    against the same scene computed on the CPU;
30. the run_ocp example --debug at its defaults, and native.pack_params of
    its state;
31. one JSON line with each kernel's error, times, bound and launch counts
    (per path under "path_launches").
The bounds of 17, 18 and 21 are SPREAD_FACTOR times JAX against itself,
and the gates of 19 and 20 JAX's own violation widened by that (see
survey_gate), each read from the files tools/make_torch_golden.py writes.
Kernel times come in two kinds: device ms, the device's time for one
call from a CUDA-graph replay of 20 calls (what ranks and bounds a
kernel), and call ms, the median host-inclusive time of one call between
CUDA events.
The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits non-zero before printing any result. It never imports JAX.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_b2g_n14.json")
GOLDEN_ACC = os.path.join(ROOT, "tests", "data",
                          "torch_golden_b2g_n14_accurate.json")
K1_TOL = 1e-4  # max |kernel - plain| / (max |plain| + 1), f32 roundoff
K2_TOL = 2e-4  # the same normalization tests/test_pallas_rbda.py uses
K3_TOL = 1e-4  # as K1, on Linv, W, V and one solve_factorized
# aba(q, v, rnea(q, v, a, f), f) against a, normalized by max |a| + 1: f32
# roundoff times the condition of M; phase 13 prints 1.09e-3 on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md), so about 5x that
ABA_ID_TOL = 5e-3
# the solve error of the kernels' factorizations may exceed the plain f32
# recursion's ("cholinv") by at most this factor (phase 11)
SOLVE_ERR_RATIO = 1.25
# K3's first design (column-by-column Cholesky and substitution, scalar
# products), device-and-host ms per call on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md): (K, s, Bs) -> ms
K3_FIRST_MS = {(15, 105, 1): 3.8687, (15, 105, 512): 15.6523,
               (14, 110, 1): 3.8514, (14, 110, 512): 15.5858}
# K2's first design (one CTA per element, dense masked sums), (device ms,
# call ms) per call with forces on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md), by B2G flat batch
K2_FIRST_MS = {7168: (0.6427, 0.6460), 14: (0.0270, 0.0739)}
# K1's shapes on the path: the flagship's node (s = 105 at batch 512), the
# eq-projection node (110), Go2's (78), the old leaf shape (14) and the
# whole_body_aba node (81)
K1_SHAPES = ((512, 105), (512, 110), (5, 78), (512, 14), (512, 81))
# K2's cases in phase 4: (robot, keyword arguments, flat batch)
K2_CASES = (("B2G", {}, 7168), ("B2G", {}, 14), ("B2G", {}, 5),
            ("Go2", {}, 7168), ("B2", {"payload": "front"}, 7168),
            ("B2G", {}, 15360))
# the cases that phase 4 times, by label
K2_TIMED = {("B2G", 7168): "B2G 7168", ("B2G", 14): "B2G 14",
            ("B2", 7168): "B2 7168", ("B2G", 15360): "B2G 15360"}
VIOL_GATE = 0.35  # shipping quality gate on the mean max_violation
ACC_GATE = 1e-3  # the accurate preset's contract on the mean max_violation
ACC_X_TOL = 5e-3  # accurate golden: x (see replay_golden)
ACC_VIOL_TOL = 2e-4  # accurate golden: per tick |dviol| (see replay_golden)
ABA_X_TOL = 3e-5  # whole_body_aba golden: x (see replay_golden)
ABA_VIOL_REL = 0.03  # whole_body_aba golden: per tick |dviol| / viol
ABA_MEAN_REL = 0.01  # whole_body_aba golden: rollout mean violation
GOLDEN_ABA = os.path.join(ROOT, "tests", "data",
                          "torch_golden_b2g_n14_aba.json")
GOLDEN_SEQ = os.path.join(ROOT, "tests", "data",
                          "torch_golden_b2g_n14_seq.json")
GOLDEN_SCALED = os.path.join(ROOT, "tests", "data",
                             "torch_golden_b2g_n14_scaled.json")
GOLDEN_B2 = os.path.join(ROOT, "tests", "data",
                         "torch_golden_b2_front_n14.json")
# the formulation variants' B2G N=14 fixtures (tools/make_torch_golden.py
# --case NAME), by case
VARIANT_FIXTURES = {name: os.path.join(ROOT, "tests", "data",
                                       f"torch_golden_b2g_n14_{name}.json")
                    for name in ("rnea_noacc", "acc_nobase", "euler")}
# JAX against itself at batch 8 (agreement bounds) and JAX's violation
# surveys (gates), written by tools/make_torch_golden.py --agreement and
# --case ... --violation-survey
SPREADS = os.path.join(ROOT, "tests", "data", "torch_spreads.json")
# JAX's accurate dumps with "sequential" and "cholinv", held open loop to
# the golden dump, against it and against each other over the parity
# phase's ticks, and the "sequential" dump (tools/make_torch_golden.py
# --parity-spread 4: the ticks before any f32 summation order takes another
# line-search step inside a tick, see PARITY_B2G_AGAINST there)
PARITY_SPREAD = os.path.join(ROOT, "tests", "data", "torch_parity_b2g_n14.json")
PARITY_JAX = os.path.join(ROOT, "tests", "data",
                          "torch_parity_b2g_n14_jax_seq.json")
PARITY_GOLDEN = os.path.join(ROOT, "tools", "golden_b2g_rnea_n14.json")
# a parity bound wider than this share of the quantity's largest magnitude
# would pass an answer that far off: such a quantity is printed, not held
PARITY_SCALE_SHARE = 0.25
# a bound set from JAX against itself is this many times its spread, as the
# whole_body_aba replay's are
SPREAD_FACTOR = 3.0
# NVIDIA's data sheet, H100 SXM: memory rate, and the f32 rate outside the
# tensor cores (the solver runs no TF32)
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12
# an exported step against the eager step from the same carry: the same
# operations and kernels in the same order (0 on the CPU)
EXPORT_TOL = 1e-4


def log(*parts):
    print(*parts, flush=True)


def check(ok, msg):
    """Fail the run (also under python -O, which drops asserts)."""
    if not ok:
        raise RuntimeError(msg)


def median_ms(torch, fn, reps=30, warm=3):
    """Call ms: the median time of one call of fn between two CUDA events,
    recorded around the call from an idle device, so it includes the
    host's enqueue time."""
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


def device_ms(torch, fn, reps=20, warm=3, mode="relaxed"):
    """Device ms: CUDA events around one replay of a CUDA graph that holds
    reps calls of fn, divided by reps: the device's time for one call
    without the host's enqueue. fn must be capturable (no host sync and no
    copy from the host); mode is the capture's error mode ("global" also
    refuses unsafe calls from other threads)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode=mode):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / reps
    del graph
    return ms


def times(torch, fn, reps=20, mode="relaxed"):
    """(device ms, call ms) of fn."""
    return device_ms(torch, fn, reps, mode=mode), median_ms(torch, fn, reps)


def bound(nbytes, ops):
    """(ms, what bounds it): the least time the card could take to move
    nbytes and do ops f32 operations."""
    t_b, t_o = nbytes / H100_BYTES_PER_S, ops / H100_F32_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def nonfinite_pattern(torch, M):
    """Counts of NaN, inf and finite entries of the square matrix M below,
    on and above its diagonal: {"below": (nan, inf, finite), ...}."""
    n = M.shape[-1]
    r = torch.arange(n, device=M.device)
    parts = {"below": r[:, None] > r[None, :], "diag": r[:, None] == r[None, :],
             "above": r[:, None] < r[None, :]}
    return {k: (int(torch.isnan(M[m]).sum()), int(torch.isinf(M[m]).sum()),
                int(torch.isfinite(M[m]).sum())) for k, m in parts.items()}


def hot_mpc(T, device, factorizer, nodes=14, ship=None,
            dynamics="whole_body_rnea", robot=("B2G", {}), form_kwargs=None):
    """An MPC with the hot config (or, with ship["eq_projection"], the
    accurate one; ship may also set "sqp_iters" and "scaling_iters") read
    from a SHIPPING.json-style dict, for the formulation ``dynamics`` (with
    ``form_kwargs``, e.g. include_acc=False) and ``robot`` = (class name,
    keyword arguments), B2G by default."""
    ship = ship or {}
    robot = getattr(T, robot[0])(**robot[1])
    robot.set_gait_sequence("trot", 0.8)
    cfg = T.SQPConfig(
        sqp_iters=int(ship.get("sqp_iters", 1)),
        n_trials=int(ship.get("ls_trials", 2)),
        corrector_iters=int(ship.get("corrector", 5)),
        eq_projection=int(ship.get("eq_projection", 0)),
        admm=T.ADMMConfig(iters=int(ship.get("admm_iters", 10)),
                          scaling_iters=int(ship.get("scaling_iters", 0)),
                          factorizer=factorizer))
    return T.MPC(robot, dynamics=dynamics, nodes=nodes,
                 flip_reset=True, warm_shift=bool(ship.get("warm_shift", True)),
                 config=cfg, device=device, **(form_kwargs or {}))


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


def artifact_ticks(step, carry, targets, dt, ticks, zeros):
    """``ticks`` ticks of an exported step (or of MPC.step with the same
    arguments) from carry, each bracketed by a device synchronize; returns
    (carry, max_violation of the last tick, ms per tick)."""
    import numpy as np
    import torch

    B = targets.shape[0]
    ms = []
    for k in range(ticks):
        t = torch.full((B,), float(np.float32(k * dt)), device=targets.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, viol = step(carry, t, targets, zeros, zeros)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return carry, viol, ms


# the exported paths of phase 27: label -> (launches (K1, K2, K3) per tick
# of the artifact, batch)
EXPORTS = {"flagship": ((15, 1, 0), 512), "accurate b1": ((0, 5, 5), 1)}


def export_mpc(T, dev, label):
    """The MPC of an exported path, as phases 5 and 9 build it."""
    if label == "flagship":
        with open(os.path.join(ROOT, "SHIPPING.json")) as fh:
            ship = json.load(fh)["bench_defaults"]
        return hot_mpc(T, dev, ship["factorizer"], ship=ship)
    return accurate_mpc(T, T.SQPConfig.accurate()._replace(
        admm=T.ADMMConfig(iters=10, factorizer="pallas")))


def export_worker(label, workdir, ticks=3, wait_s=1500):
    """Phase 27's work for one path, in its own process (chip_smoke.py
    --export-worker LABEL DIR): export the step and the retraction on the
    card, save to bytes and load them, which is host work (tracing with
    fake tensors launches nothing) that overlaps phases 3-26 of the main
    process, pinned to the upper half of the host's cores so that the
    main process keeps the lower half; then, once the main process creates
    DIR/go-LABEL (the card idle), one warm-up tick of the artifact and of
    the eager step and ``ticks`` ticks of each from the same carry, with
    the artifact's launches. Writes DIR/LABEL.json."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 4:
        os.sched_setaffinity(0, cpus[len(cpus) // 2:])
    import torch

    torch.set_num_threads(max(1, len(cpus) // 4))
    sys.path.insert(0, ROOT)
    import tpu_locoman_torch as T
    from tpu_locoman_torch import aot

    dev = torch.device("cuda")
    expect, batch = EXPORTS[label]
    mpc = export_mpc(T, dev, label)
    t0 = time.time()
    data = aot.export_mpc_step(mpc, batch)
    export_s = time.time() - t0
    t0 = time.time()
    step = aot.load_artifact(data)
    load_s = time.time() - t0
    rdata = aot.export_retract(mpc, batch)
    retract = aot.load_artifact(rdata)
    go = os.path.join(workdir, f"go-{label}")
    t0 = time.time()
    while not os.path.exists(go):
        check(time.time() - t0 < wait_s, f"export worker {label}: no go")
        time.sleep(0.5)
    targets = torch.zeros(batch, 6, device=dev)
    targets[:, 0] = 0.2
    zeros = torch.zeros(batch, 3, device=dev)

    def eager(c, t, b, e, a):
        c, stats = mpc.step(c, t, b, e, a)
        return c, stats["max_violation"]

    carry = mpc.init_carry(batch)
    artifact_ticks(step, carry, targets, mpc.dt_min, 1, zeros)
    artifact_ticks(eager, carry, targets, mpc.dt_min, 1, zeros)
    reset_launches()
    ca, va, ms_a = artifact_ticks(step, carry, targets, mpc.dt_min, ticks,
                                  zeros)
    launches = read_launches()
    ce, ve, ms_e = artifact_ticks(eager, carry, targets, mpc.dt_min, ticks,
                                  zeros)
    out = retract(ca.solver_state.Z, ca.x_init)
    ref = mpc.retract(ca.solver_state.Z, ca.x_init, num_steps=3)
    r = {"label": label, "batch": batch, "ticks": ticks, "expect": expect,
         "export_s": export_s, "load_s": load_s, "bytes": len(data),
         "retract_bytes": len(rdata),
         "nodes": sum(1 for _ in step.graph.nodes),
         "gaps": {"x": float((ca.x_init - ce.x_init).abs().max()),
                  "Z": float((ca.solver_state.Z
                              - ce.solver_state.Z).abs().max()),
                  "max_violation": float((va - ve).abs().max())},
         "retract_gap": max(float((o - ref[k]).abs().max()) for o, k in zip(
             out, ("q", "v", "a", "forces", "tau"))),
         "artifact_ms": ms_a, "eager_ms": ms_e, "launches": launches}
    with open(os.path.join(workdir, f"{label}.json"), "w") as f:
        json.dump(r, f)
    return 0


def start_export_workers(workdir):
    """One export_worker process per exported path, started right after
    the build so that their host work overlaps the card's phases."""
    procs = {}
    for label in EXPORTS:
        with open(os.path.join(workdir, f"{label}.log"), "w") as log_:
            procs[label] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--export-worker",
                 label, workdir], stdout=log_, stderr=subprocess.STDOUT)
    return procs


def phase_export(workers, workdir, timeout=1000):
    """27: each exported path's worker, run one after the other on the idle
    card: the artifact's ticks against the eager ticks (x, Z and
    max_violation within EXPORT_TOL), its launches per tick, and the
    export, load and tick times. Returns ({label: summary}, line)."""
    res, parts = {}, []
    for label, proc in workers.items():
        open(os.path.join(workdir, f"go-{label}"), "w").close()
        try:
            proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(os.path.join(workdir, f"{label}.log")) as f:
            out = f.read()
        check(proc.returncode == 0, f"export worker {label} failed:\n{out}")
        with open(os.path.join(workdir, f"{label}.json")) as f:
            r = json.load(f)
        n = r["ticks"]
        check(tuple(r["launches"]) == tuple(n * k for k in r["expect"]),
              f"{label} artifact launches {r['launches']}, expected "
              f"{r['expect']} per tick")
        for k, g in list(r["gaps"].items()) + [("retract",
                                                 r["retract_gap"])]:
            check(g <= EXPORT_TOL, f"{label} artifact {k} off the eager by "
                  f"{g}")
        g, la = r["gaps"], r["launches"]
        res[label] = r
        parts.append(
            f"{label} (batch {r['batch']}): export (make_fx + torch.export + "
            f"save) {r['export_s']:.1f} s, {r['bytes']} bytes, {r['nodes']} "
            f"graph nodes, load {r['load_s']:.1f} s; {n} ticks from one "
            f"carry, artifact against eager: x {g['x']:.3g}, Z {g['Z']:.3g}, "
            f"max_violation {g['max_violation']:.3g} (tol {EXPORT_TOL}); "
            f"artifact {ms_summary(r['artifact_ms'])} against eager "
            f"{ms_summary(r['eager_ms'])}; artifact launches K1 {la[0]} K2 "
            f"{la[1]} K3 {la[2]}; retract artifact ({r['retract_bytes']} "
            f"bytes) off by {r['retract_gap']:.3g}")
    return res, "[27 export, in worker processes] " + "; ".join(parts)


def phase_quiet_host(dev, ship, batch, flagship_ms, noacc_ms):
    """27b: the flagship (host-bound) and whole_body_rnea(include_acc=False)
    (device-bound) timed again as phases 5 and 22 time them, now that the
    export workers have exited: whether their host work beside phases 3-26
    moved those phases' tick times (no gate)."""
    import numpy as np

    fl, _ = run_flagship(dev, ship, batch, 2, 20)
    na, _ = run_flagship(dev, ship, batch, 2, 5,
                         form_kwargs={"include_acc": False})
    fl_ms, na_ms = float(np.mean(fl["tick_ms"])), float(np.mean(
        na["tick_ms"]))
    return (f"[27b quiet host] after the export workers exited, ms/tick mean: "
            f"flagship {fl_ms:.2f} (phase 5, beside them: {flagship_ms:.2f}; "
            f"ratio {flagship_ms / fl_ms:.3f}), include_acc=False {na_ms:.2f} "
            f"(phase 22: {noacc_ms:.2f}; ratio {noacc_ms / na_ms:.3f})")


def phase_dryrun():
    """28: dryrun_multichip at the flagship's full width: NCCL at world
    size = the card count, and two gloo processes sharing the one card
    (collectives through host copies), each against the unsharded batch."""
    import torch

    from tpu_locoman_torch.dryrun import CONFIGS, X_TOL, dryrun_multichip

    runs = {}
    n = torch.cuda.device_count()
    for label, procs, backend in ((f"nccl x{n}", n, "nccl"),
                                  ("gloo x2 on one card", 2, "gloo")):
        t0 = time.time()
        r = dryrun_multichip(procs, backend=backend, device="cuda",
                             timeout=600)
        r["wall_s"] = time.time() - t0
        check(r["x_gap"] <= X_TOL, f"dry run {label}: x gap {r['x_gap']}")
        runs[label] = r
    return runs, "[28 dryrun] flagship (B2G N=14, 10 warm-started sweeps, " + (
        f"2 ticks) batch {CONFIGS['flagship'][4]}: " + "; ".join(
            f"{k}: sharded == unsharded, x gap {r['x_gap']:.3g} (tol "
            f"{X_TOL}), violation gap {r['viol_gap']:.3g} (rtol 0.3, atol "
            f"0.05), max_violation mean {r['viol_mean']:.4f} (unsharded "
            f"{r['viol_mean_unsharded']:.4f}), rank 0's ticks "
            f"{', '.join(f'{x:.2f}' for x in r['rank0_tick_ms'])} ms (the "
            f"first with the process's first launches), unsharded "
            f"{', '.join(f'{x:.2f}' for x in r['unsharded_tick_ms'])} ms, "
            f"rank 0 launches K1 {r['rank0_launches'][0]} K2 "
            f"{r['rank0_launches'][1]} K3 {r['rank0_launches'][2]}; x against "
            f"each slice unsharded at the local batch in rank 0's process: "
            f"sharded {r['x_gap_local']:.3g}, full batch "
            f"{r['x_gap_batch']:.3g}; "
            + " | ".join(r["ranks"]) + f"; {r['wall_s']:.1f} s"
            for k, r in runs.items()))


def phase_examples(dev):
    """29: python -m tpu_locoman_torch.examples.run_mpc at its defaults on
    the card (B2G whole_body_rnea N=14, 2 SQP iterations of 100 sweeps,
    batch 1, 100 loops) with --dump and --viz, held to the verify skill's
    health criteria; the scene's points against the same scene computed
    on the CPU by the port (atol 1e-5)."""
    import tempfile

    import numpy as np

    from tpu_locoman_torch import viz
    from tpu_locoman_torch.examples import run_mpc

    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        dump, html = os.path.join(tmp, "traj.json"), os.path.join(
            tmp, "replay.html")
        r = run_mpc.main(["--dump", dump, "--viz", html])
        with open(dump) as f:
            d = json.load(f)
        with open(html + ".json") as f:
            scene = json.load(f)
        mpc = r["mpc"]
        cpu = viz.dump_scene(os.path.join(tmp, "cpu.json"), mpc.form.model,
                             run_mpc.q_of(mpc, np.asarray(d["x"])),
                             mpc.dt_min,
                             frame_names=tuple(mpc.form.foot_frames),
                             device="cpu")
        with open(cpu) as f:
            ref = json.load(f)
    launches = read_launches()
    scene_gap = float(np.abs(np.asarray(scene["points"])
                             - np.asarray(ref["points"])).max())
    check(scene_gap <= 1e-5, f"scene on the card vs the CPU: {scene_gap}")
    check(r["viol_median"] < 0.5, f"run_mpc violation median "
          f"{r['viol_median']}")
    check(abs(r["vx"] - 0.2) <= 0.3 * 0.2, f"run_mpc vx {r['vx']}")
    check(abs(r["final_pos"][2] - 0.55) <= 0.05,
          f"run_mpc final z {r['final_pos'][2]}")
    return r, launches, (
        f"[29 examples] run_mpc defaults on the card (batch 1, 100 loops): "
        f"{r['ms_per_tick']:.2f} ms/tick, violation median "
        f"{r['viol_median']:.4f} (< 0.5) max {r['viol_max']:.4f}, tracked vx "
        f"{r['vx']:.3f} (0.2 +- 30%), final base z {r['final_pos'][2]:.3f} "
        f"(0.55 +- 0.05); --dump {len(d['x'])} states, --viz scene "
        f"{np.asarray(scene['points']).shape} against the CPU's: max abs "
        f"{scene_gap:.3g} (tol 1e-5); launches K1 {launches[0]} K2 "
        f"{launches[1]} K3 {launches[2]}")


def phase_ocp_native(dev):
    """30: python -m tpu_locoman_torch.examples.run_ocp --debug at its
    defaults on the card, and native.pack_params of that run's state."""
    import numpy as np

    from tpu_locoman_torch import native
    from tpu_locoman_torch.examples import run_ocp

    r = run_ocp.main(["--debug"])
    check(r["max_violation"] < 0.05, f"run_ocp violation {r['max_violation']}")
    check(r["tau_diff"] < 1e-3, f"run_ocp EOM vs RNEA {r['tau_diff']}")
    mpc, c = r["mpc"], r["carry"]
    sp = mpc.make_stage_params(c.x_init.new_zeros(1))
    nx, N, nj = mpc.form.nx, mpc.nodes, mpc.form.nj
    packed = native.pack_params(
        c.x_init[0], sp.contact[0].T, sp.swing[0].T, [0.2, 0, 0, 0, 0, 0],
        np.zeros(3), np.zeros(3), c.tau_prev[0])
    check(packed.shape == (nx + 8 * N + 12 + nj,),
          f"pack_params length {packed.shape}")
    check(np.allclose(packed[:nx], c.x_init[0].cpu().numpy()),
          "pack_params x_init")
    return (f"[30 ocp+native] run_ocp --debug defaults on the card: first "
            f"call {r['first_ms']:.1f} ms, then {r['ms']:.1f} ms, max "
            f"violation {r['max_violation']:.4g} (< 0.05), avg tau_diff "
            f"{r['tau_diff']:.3g} (< 1e-3), avg tau_b_norm "
            f"{r['tau_b_norm']:.3g}; native.pack_params of its state: "
            f"{packed.shape[0]} values (library "
            f"{os.path.relpath(native.library_path(), ROOT)})")


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
            "viol_worst": float(np.max(viol_ticks)), "status": status,
            "carry": carry}


def run_flagship(dev, ship, batch, warm, timed, dynamics="whole_body_rnea",
                 nodes=14, robot=("B2G", {}), form_kwargs=None):
    """Drive the main path (or another formulation's, variant, horizon or
    robot) through its user entry points: MPC, then batched_init and
    batched_step, ticking every scenario. Returns run_ticks' summary and
    the MPC."""
    import torch

    import tpu_locoman_torch as T

    mpc = hot_mpc(T, dev, ship["factorizer"], nodes=nodes, ship=ship,
                  dynamics=dynamics, robot=robot, form_kwargs=form_kwargs)
    targets = torch.tensor([0.2, 0, 0, 0, 0, 0], device=dev).repeat(batch, 1)
    return run_ticks(T.batched_step(mpc), T.batched_init(mpc, batch), targets,
                     mpc.dt_min, warm, timed), mpc


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


@contextlib.contextmanager
def plain_kernels():
    """Swap the plain versions in for K2 (``rnea_derivs.rnea_derivatives``,
    which the formulations and rbda.aba_derivatives call) and for K1 where
    ``qp.chol_inv`` hands it a whole block (ABA's mass matrix; the
    "cholinv" factorizer never calls it)."""
    from tpu_locoman_torch import rnea_derivs
    from tpu_locoman_torch.solver import chol_base
    from tpu_locoman_torch.solver import qp as tqp

    saved = rnea_derivs.rnea_derivatives, tqp.chol_inv_node
    rnea_derivs.rnea_derivatives = rnea_derivs.rnea_derivatives_plain
    tqp.chol_inv_node = chol_base.chol_inv_node_plain
    try:
        yield
    finally:
        rnea_derivs.rnea_derivatives, tqp.chol_inv_node = saved


def compare_paths(dev, ship, batch=8, ticks=3, dynamics="whole_body_rnea",
                  pair=("cholinv_pb", "cholinv"), plain=True, nodes=14,
                  robot=("B2G", {}), form_kwargs=None):
    """The kernel path against the plain path (K1's and K2's plain
    versions swapped in) from the same carry; or, with plain=False, one
    factorizer against another (pair), both on the kernels. Returns (max
    |dx|, max normalized |dZ|) over the ticks, targets vx 0 to 0.3."""
    import torch

    import tpu_locoman_torch as T

    tg = torch.zeros(batch, 6, device=dev)
    tg[:, 0] = torch.linspace(0.0, 0.3, batch, device=dev)
    mk, mp = (hot_mpc(T, dev, fz, nodes=nodes, ship=ship, dynamics=dynamics,
                      robot=robot, form_kwargs=form_kwargs) for fz in pair)
    ck = cp = T.batched_init(mk, batch)
    ex = ez = 0.0
    for k in range(ticks):
        ck, _ = mk.step(ck, k * mk.dt_min, tg)
        with plain_kernels() if plain else contextlib.nullcontext():
            cp, _ = mp.step(cp, k * mp.dt_min, tg)
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

    whole_body_aba fixture (its setup's dynamics; B2G N=14, hot config,
    batch 2, 5 ticks): JAX itself with "sequential" against the fixture's
    "cholinv" lands within 9.7e-6 in x, 0.99% of each tick's max_violation
    and 0.26% of the rollout mean (tools/make_torch_golden.py --dynamics
    whole_body_aba --against). Held at about three times that,
    as the accurate bounds are: x atol ABA_X_TOL, per tick |dviol| <=
    ABA_VIOL_REL of the fixture's, rollout mean within ABA_MEAN_REL,
    alpha and status equal. The port's plain path on the CPU lands within
    3.7e-6 in x and 0.94% per tick.

    A fixture with a "spread" (JAX at another factorizer against it,
    tools/make_torch_golden.py --case ... --against: the "sequential",
    scaled and B2 fixtures) is held at SPREAD_FACTOR times it: x atol, and
    per tick |dviol| of the fixture's (which bounds the rollout mean as
    well), alpha and status equal. The rollout mean is not held to its own
    spread: that is a difference of sums that nearly cancel (1.7e-4 for the
    "sequential" fixture, whose ticks differ by up to 12.9%).

    Returns (max x err, max violation err, mean violation rel err, ticks,
    batch)."""
    import numpy as np
    import torch

    import tpu_locoman_torch as T
    from tpu_locoman_torch import convert

    gold = convert.load_golden(path)
    s = gold["setup"]
    x_tol, viol_rel, viol_abs, mean_rel_tol = golden_tolerances(gold)
    accurate = s.get("eq_projection", 0) > 0
    mg = hot_mpc(T, dev, factorizer, nodes=s["nodes"], ship={
        "ls_trials": s["ls_trials"], "corrector": s["corrector"],
        "admm_iters": s["admm_iters"], "warm_shift": s["warm_shift"],
        "sqp_iters": s["sqp_iters"],
        "scaling_iters": s.get("scaling_iters", 0),
        "eq_projection": s.get("eq_projection", 0)}, dynamics=s["dynamics"],
        robot=(s["robot"], s.get("robot_kwargs", {})),
        form_kwargs=s.get("form_kwargs"))
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
        check(dx <= x_tol, f"golden tick {k}: x err {dx} > {x_tol}")
        if accurate:
            ok = (np.all(v <= ACC_GATE) and np.all(rv <= ACC_GATE)
                  and np.all(dv <= ACC_VIOL_TOL))
        else:
            ok = np.all(dv <= viol_rel * np.abs(rv) + viol_abs)
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
        check(mean_rel <= mean_rel_tol,
              f"golden rollout mean violation off by {mean_rel}")
    return gx, gv, mean_rel, len(gold["ticks"]), len(s["targets_vx"])


def golden_tolerances(gold):
    """(x atol, per tick violation tolerance relative to the fixture's and
    absolute, rollout mean relative tolerance) of a fixture, as
    replay_golden states them (the accurate fixture's violation is held by
    ACC_GATE and ACC_VIOL_TOL instead)."""
    s = gold["setup"]
    variant = bool(s.get("form_kwargs")) or not s.get(
        "robot_kwargs", {}).get("use_quaternion", True)
    if "spread" in gold and variant:
        # the hot fixture's bounds, or SPREAD_FACTOR x JAX's spread where
        # that is wider (whole_body_rnea(include_acc=False): JAX lands
        # 1.2e-2 in x from itself), the rollout mean's at most 10%
        sp = gold["spread"]
        return (max(1e-3, SPREAD_FACTOR * sp["x"]),
                max(0.4, SPREAD_FACTOR * sp["viol_rel"]), 1e-3, 0.1)
    if "spread" in gold:
        sp = gold["spread"]
        return (SPREAD_FACTOR * sp["x"], SPREAD_FACTOR * sp["viol_rel"], 0.0,
                min(0.1, SPREAD_FACTOR * sp["viol_rel"]))
    if s.get("eq_projection", 0) > 0:
        return ACC_X_TOL, None, None, None
    if s["dynamics"] == "whole_body_aba":
        return ABA_X_TOL, ABA_VIOL_REL, 0.0, ABA_MEAN_REL
    return 1e-3, 0.4, 1e-3, 0.1


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


def compare_factorizers(dev, ship, names, batch=8, ticks=3, solve_only=()):
    """Each factorizer in names against "cholinv_pb" on the hot config from
    the same carry. Returns ({name: (max |dx|, max normalized |dZ|)},
    {name: solve error}): the second, for "cholinv_pb", each name and each
    of solve_only, is the worst relative error max |x - x64| / max |x64| of
    one seeded solve of each KKT system that the reference run factorized
    (the flagship's real blocks), against the plain recursion in float64;
    "cholinv" (the plain recursion in float32, no kernel) is the
    yardstick."""
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
    solve_err = dict.fromkeys(("cholinv", "cholinv_pb") + tuple(names)
                              + tuple(solve_only), 0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for H, U in blocks:
        s = H.shape[-1]
        Uf = torch.cat([U, U.new_zeros(U.shape[:-1] + (s - U.shape[-1],))], -1)
        b = torch.randn(H.shape[:-1], generator=gen, device=dev)
        x64 = tqp.solve_factorized(fac_whole.factorize_whole_plain(
            H.double(), Uf.double()), b.double())
        for name in solve_err:
            fac = by_name(H, Uf if name in ("pallas", "cyclic") else U, name)
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


def reset_launches():
    from tpu_locoman_torch import rnea_derivs
    from tpu_locoman_torch.solver import chol_base, fac_whole

    chol_base.launches = rnea_derivs.launches = fac_whole.launches = 0


def read_launches():
    """(K1, K2, K3) launches since reset_launches."""
    from tpu_locoman_torch import rnea_derivs
    from tpu_locoman_torch.solver import chol_base, fac_whole

    return chol_base.launches, rnea_derivs.launches, fac_whole.launches


def load_spreads():
    with open(SPREADS) as fh:
        return json.load(fh)


def path_line(r, batch, launches, ticks):
    """The common part of a new path's line: ms/tick, solves/s,
    max_violation, status and launches."""
    import numpy as np

    ms = float(np.mean(r["tick_ms"]))
    return (f"{ms_summary(r['tick_ms'])}; {batch * 1e3 / ms:.1f} solves/s; "
            f"max_violation mean {r['viol_mean']:.6g} worst tick "
            f"{r['viol_worst']:.4g}; status {r['status']}; launches K1 "
            f"{launches[0]} K2 {launches[1]} K3 {launches[2]} over {ticks} "
            f"ticks")


def phase_sequential(dev, ship, spreads, batch=512, warm=2, timed=10):
    """17: the battery's 01_default factorizer on the flagship: "sequential"
    (the library Cholesky by panels; no K1), then its agreement with
    "cholinv_pb" at batch 8 over the spread's ticks, within SPREAD_FACTOR x
    JAX "sequential" against JAX "cholinv" on the same ticks."""
    reset_launches()
    r, _ = run_flagship(dev, dict(ship, factorizer="sequential"), batch, warm,
                        timed)
    launches, ticks = read_launches(), warm + timed
    check(launches == (0, ticks, 0), f"sequential launches {launches}")
    check(r["viol_mean"] <= VIOL_GATE,
          f"sequential violation mean {r['viol_mean']} > {VIOL_GATE}")
    sp = spreads["flagship"]
    ex, ez = compare_paths(dev, ship, batch=sp["batch"], ticks=sp["ticks"],
                           pair=("sequential", "cholinv_pb"), plain=False)
    tx, tz = SPREAD_FACTOR * sp["x"], SPREAD_FACTOR * sp["Z"]
    check(ex <= tx and ez <= tz, f"sequential vs cholinv_pb: x {ex} > {tx} "
          f"or Z {ez} > {tz}")
    return r, launches, (
        f"[17 sequential] B2G whole_body_rnea N=14 batch {batch}, "
        f"bench_defaults with sequential: {path_line(r, batch, launches, ticks)}"
        f" (gate {VIOL_GATE}); against cholinv_pb at batch {sp['batch']}, "
        f"{sp['ticks']} ticks: x {ex:.3g} (tol {tx:.3g}), Z normalized "
        f"{ez:.3g} (tol {tz:.3g}) = {SPREAD_FACTOR:g} x JAX sequential "
        f"against JAX cholinv (x {sp['x']:.3g}, Z {sp['Z']:.3g})")


def phase_n30(dev, ship, spreads, batch=512, warm=1, timed=5):
    """18: the long horizon of the battery's 09_n30_seq and 10_n30_cyclic:
    N=30 with "sequential", then "cyclic" (31 blocks padded to 32), and
    cyclic's agreement with sequential at batch 8 within SPREAD_FACTOR x
    JAX cyclic against JAX sequential."""
    runs, parts = {}, []
    for fz in ("sequential", "cyclic"):
        reset_launches()
        r, _ = run_flagship(dev, dict(ship, factorizer=fz), batch, warm,
                            timed, nodes=30)
        launches, ticks = read_launches(), warm + timed
        check(launches == (0, ticks, 0), f"N=30 {fz} launches {launches}")
        check(r["viol_mean"] <= VIOL_GATE,
              f"N=30 {fz} violation mean {r['viol_mean']} > {VIOL_GATE}")
        runs[fz] = (r, launches)
        parts.append(f"{fz}: {path_line(r, batch, launches, ticks)}")
    sp = spreads["n30"]
    ex, ez = compare_paths(dev, ship, batch=sp["batch"], ticks=sp["ticks"],
                           pair=("cyclic", "sequential"), plain=False,
                           nodes=30)
    tx, tz = SPREAD_FACTOR * sp["x"], SPREAD_FACTOR * sp["Z"]
    check(ex <= tx and ez <= tz, f"N=30 cyclic vs sequential: x {ex} > {tx} "
          f"or Z {ez} > {tz}")
    return runs, (
        f"[18 n30] B2G whole_body_rnea N=30 batch {batch}, bench_defaults; "
        + "; ".join(parts) + f" (gate {VIOL_GATE} each); cyclic against "
        f"sequential at batch {sp['batch']}, {sp['ticks']} ticks: x {ex:.3g} "
        f"(tol {tx:.3g}), Z normalized {ez:.3g} (tol {tz:.3g}) = "
        f"{SPREAD_FACTOR:g} x JAX's (x {sp['x']:.3g}, Z {sp['Z']:.3g})")


#: examples/run_mpc.py's defaults (2 SQP iterations of 100 ADMM sweeps, no
#: corrector, 8 line-search trials) with Ruiz scaling
SCALED_SHIP = {"sqp_iters": 2, "admm_iters": 100, "corrector": 0,
               "ls_trials": 8, "scaling_iters": 3, "warm_shift": True,
               "factorizer": "cholinv_pb"}


def survey_gate(survey, fixture):
    """(gate, per tick relative spread) on a path's mean max_violation:
    JAX's survey mean widened by SPREAD_FACTOR x the largest per tick
    relative change of max_violation under another f32 summation order
    (the fixture's spread: JAX against the fixture), at most VIOL_GATE
    unless JAX's own mean is above it (a property of the formulation:
    whole_body_rnea(include_acc=False)). A mean of ticks that each move by
    at most that share moves by at most that share too."""
    from tpu_locoman_torch import convert

    rel = convert.load_golden(fixture)["spread"]["viol_rel"]
    gate = (1 + SPREAD_FACTOR * rel) * survey["mean"]
    return (gate if survey["mean"] > VIOL_GATE else min(VIOL_GATE, gate)), rel


def gate_text(gate, rel, survey):
    cap = (f"JAX's own mean is above {VIOL_GATE}: not capped"
           if survey["mean"] > VIOL_GATE else f"at most {VIOL_GATE}")
    return (f"gate {gate:.6g} = JAX's {survey['mean']:.6g} at batch "
            f"{survey['batch']} x (1 + {SPREAD_FACTOR:g} x {100 * rel:.3g}%), "
            f"{cap}")


def replay_text(dev, fz, fixture):
    """Replay ``fixture`` (replay_golden) and describe the result."""
    from tpu_locoman_torch import convert

    gx, gv, grel, n_ticks, n_b = replay_golden(dev, fz, fixture)
    tol = golden_tolerances(convert.load_golden(fixture))
    return (f"JAX fixture replayed ({n_ticks} ticks, batch {n_b}): x {gx:.3g} "
            f"(tol {tol[0]:.3g}), violation {gv:.3g} (tol "
            f"{100 * tol[1]:.3g}% per tick), rollout mean off by "
            f"{100 * grel:.3g}% (tol {100 * tol[3]:.3g}%), alpha and status "
            f"equal (tolerances {SPREAD_FACTOR:g} x JAX against the fixture, "
            f"the mean's at most 10%)")


def phase_scaled(dev, spreads, batch=512, ticks=5):
    """19: a Ruiz-scaled cold start, 5 ticks from init_carry (K1 15 per
    factorization and K2 one per linearize, two of each per tick), within
    survey_gate of JAX's violation survey of the configuration; then the
    JAX fixture of the configuration replayed."""
    reset_launches()
    r, _ = run_flagship(dev, SCALED_SHIP, batch, 0, ticks)
    launches = read_launches()
    check(launches == (30 * ticks, 2 * ticks, 0),
          f"scaled launches {launches}")
    sv = spreads["survey_scaled"]
    gate, rel = survey_gate(sv, GOLDEN_SCALED)
    check(r["viol_mean"] <= gate,
          f"scaled violation mean {r['viol_mean']} > {gate}")
    return r, launches, (
        f"[19 scaled] B2G whole_body_rnea N=14 batch {batch}, run_mpc "
        f"defaults (sqp 2 x admm 100) with scaling_iters 3 and cholinv_pb, "
        f"from init_carry: {path_line(r, batch, launches, ticks)} "
        f"({gate_text(gate, rel, sv)}); "
        + replay_text(dev, "cholinv_pb", GOLDEN_SCALED))


def phase_b2(dev, ship, spreads, batch=512, warm=2, timed=10):
    """20: B2 with the front payload (examples/run_mpc.py --robot b2's
    family) on the hot config: K1 one launch per node at s = 81 and K2's
    general instance on B2's 13-link tree with the payload force; within
    survey_gate of JAX's survey; then its JAX fixture replayed."""
    reset_launches()
    r, _ = run_flagship(dev, ship, batch, warm, timed,
                        robot=("B2", {"payload": "front"}))
    launches, ticks = read_launches(), warm + timed
    check(launches == (15 * ticks, ticks, 0), f"B2 launches {launches}")
    sv = spreads["survey_b2"]
    gate, rel = survey_gate(sv, GOLDEN_B2)
    check(r["viol_mean"] <= gate, f"B2 violation mean {r['viol_mean']} > "
          f"{gate}")
    return r, launches, (
        f"[20 b2] B2(payload=front) whole_body_rnea N=14 batch {batch}, "
        f"bench_defaults: {path_line(r, batch, launches, ticks)} "
        f"({gate_text(gate, rel, sv)}); "
        + replay_text(dev, "cholinv_pb", GOLDEN_B2))


def held_bounds(spread):
    """{quantity: bound} of the quantities a parity diff is held to, from
    ``spread`` (a diff of JAX against the same reference): SPREAD_FACTOR x
    JAX's max abs error, where that is positive (node 0's q and v are the
    held state itself) and at most PARITY_SCALE_SHARE of the reference's
    largest magnitude. The other quantities are printed, not held."""
    return {k: SPREAD_FACTOR * e["max_abs_err"] for k, e in spread.items()
            if 0 < SPREAD_FACTOR * e["max_abs_err"]
            <= PARITY_SCALE_SHARE * e["ref_scale"]}


def phase_parity(dev):
    """21: the port's parity ABI v1 dump of the golden dump's configuration
    (B2G N=14, accurate: sqp 6 x admm 400, eq_projection 2, batch 1, on the
    card with "auto" = "cholinv_pb") over the spread's first T ticks, held
    open loop to the golden's states, diffed with the port's diff against
    the golden and against JAX "sequential"'s dump held the same way, each
    within held_bounds of JAX against the same reference."""
    import numpy as np

    from tpu_locoman_torch import parity

    with open(PARITY_SPREAD) as fh:
        spread = json.load(fh)
    with open(PARITY_GOLDEN) as fh:
        golden = json.load(fh)
    with open(PARITY_JAX) as fh:
        jax_dump = json.load(fh)
    n = spread["ticks"]
    tick_s = []
    t_last = [time.perf_counter()]

    def log_tick(k, v):
        now = time.perf_counter()
        tick_s.append(now - t_last[0])
        t_last[0] = now

    reset_launches()
    dump = parity.make_dump(None, ticks=n, device=dev.type, log=log_tick,
                            hold=golden)
    launches = read_launches()
    check(launches[0] > 0 and launches[1] > 0 and launches[2] == 0,
          f"parity launches {launches}")
    check(dump["config"] == dict(golden["config"], ticks=n)
          == jax_dump["config"], f"parity config {dump['config']}")
    parts = []
    for ref, name, sp in ((golden, "golden", spread["spread"]),
                          (jax_dump, "JAX sequential", spread["jax_spread"])):
        d = parity.diff(dump, ref, ticks=n, warn=False)
        bounds = held_bounds(sp)
        check(set(d) == set(sp), f"parity quantities {sorted(d)}")
        for k, b in bounds.items():
            check(d[k]["max_abs_err"] <= b,
                  f"parity against {name}, {k}: {d[k]['max_abs_err']} > {b}")
        worst = max(bounds, key=lambda k: d[k]["max_abs_err"] / bounds[k])
        parts.append(
            f"against {name}, held: " + ", ".join(
                f"{k} {d[k]['max_abs_err']:.3g} ({bounds[k]:.3g})"
                for k in sorted(bounds)) + "; printed only: " + ", ".join(
                f"{k} {d[k]['max_abs_err']:.3g} (JAX "
                f"{sp[k]['max_abs_err']:.3g}, scale {sp[k]['ref_scale']:.3g})"
                for k in sorted(set(d) - set(bounds)))
            + f"; closest to its bound: {worst}")
    v = np.asarray(dump["max_violation"])
    return d, launches, (
        f"[21 parity] ABI v1 dump of B2G N=14 accurate (sqp 6 x admm 400, "
        f"eq_projection 2, batch 1, cholinv_pb) over {n} ticks held open "
        f"loop to tools/golden_b2g_rnea_n14.json: "
        f"{float(np.mean(tick_s)) * 1e3:.1f} ms/tick mean, "
        f"{float(np.median(tick_s)) * 1e3:.1f} p50; max_violation mean "
        f"{v.mean():.3g} worst tick {v.max():.3g}; launches K1 {launches[0]} "
        f"K2 {launches[1]} K3 {launches[2]}; max abs err (bound = "
        f"{SPREAD_FACTOR:g} x JAX's against the same reference, held where "
        f"at most {PARITY_SCALE_SHARE:g} of its scale) " + "; ".join(parts))

#: the variant phases: case -> (phase, what, dynamics, robot, formulation
#: keyword arguments, (K1, K2) launches per tick). K2 runs where the JAX
#: package's rnea_ad does: in include_acc=False's RNEA rows, once per
#: linearize through rnea_ad's forward-mode rule; whole_body_acc with
#: include_base=False takes its base acceleration from crba,
#: nonlinear_effects and the frame Jacobians (no K2), and the Euler base's
#: RNEA derivatives come from AD over the plain recursion (no K2)
VARIANTS = {
    "rnea_noacc": ("22", "whole_body_rnea(include_acc=False)",
                   "whole_body_rnea", ("B2G", {}), {"include_acc": False},
                   (15, 1)),
    "acc_nobase": ("23", "whole_body_acc(include_base=False)",
                   "whole_body_acc", ("B2G", {}), {"include_base": False},
                   (15, 0)),
    "euler": ("24", "B2G(use_quaternion=False) whole_body_rnea",
              "whole_body_rnea", ("B2G", {"use_quaternion": False}), {},
              (15, 0)),
}
#: phase 25's kernel-path-against-plain-path runs: (label, dynamics, robot,
#: formulation keyword arguments)
PATH_VARIANTS = (
    ("rnea_noacc", "whole_body_rnea", ("B2G", {}), {"include_acc": False}),
    ("acc_nobase", "whole_body_acc", ("B2G", {}), {"include_base": False}),
    ("cacc_nobase", "centroidal_acc", ("B2G", {}), {"include_base": False}),
    ("cvel_nobase", "centroidal_vel", ("B2G", {}), {"include_base": False}),
    ("euler", "whole_body_rnea", ("B2G", {"use_quaternion": False}), {}),
    ("euler_cacc", "centroidal_acc", ("B2G", {"use_quaternion": False}), {}),
)
# the world-frame variants against the recursions: tests/test_rbda_worldframe.py's
WF_TOL = 5e-4


def phase_variant(dev, ship, spreads, name, flagship_ms, batch=512, warm=2,
                  timed=5):
    """22-24: a formulation variant at full width on the hot config
    (bench_defaults), with its launches per tick, its peak device memory,
    its tick time against the flagship's in this run, within survey_gate
    of JAX's violation survey of the configuration; then its JAX fixture
    replayed."""
    import numpy as np
    import torch

    tag, what, dyn, robot, fkw, per_tick = VARIANTS[name]
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r, mpc = run_flagship(dev, ship, batch, warm, timed, dynamics=dyn,
                          robot=robot, form_kwargs=fkw)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, ticks = read_launches(), warm + timed
    check(launches == (per_tick[0] * ticks, per_tick[1] * ticks, 0),
          f"{name} launches {launches}")
    check(mpc.trans.split_ok == (name == "euler"),
          f"{name}: split linearize {mpc.trans.split_ok}")
    sv = spreads["survey_" + name]
    gate, rel = survey_gate(sv, VARIANT_FIXTURES[name])
    check(r["viol_mean"] <= gate,
          f"{name} violation mean {r['viol_mean']} > {gate}")
    ms = float(np.mean(r["tick_ms"]))
    lin = "split" if mpc.trans.split_ok else "whole-stage"
    return r, launches, peak, mpc, (
        f"[{tag} {name}] {what} N=14 batch {batch}, bench_defaults, {lin} "
        f"linearize: {path_line(r, batch, launches, ticks)}; "
        f"{ms / flagship_ms:.2f}x the flagship's {flagship_ms:.2f} ms/tick "
        f"in this run; peak device memory {peak:.2f} GiB "
        f"({gate_text(gate, rel, sv)}); "
        + replay_text(dev, "cholinv_pb", VARIANT_FIXTURES[name]))


def phase_variant_paths(dev, ship, mpc, carry):
    """25: each variant's kernel path against its plain path at batch 8
    (3 ticks, within 1e-3, or SPREAD_FACTOR x JAX against itself on the
    variant's fixture where that is wider); then one whole-stage linearize
    of include_acc=False at full width (``mpc`` and ``carry`` from phase
    22) with K2 launched inside torch.func's vmap over tangents of jvp,
    against the same linearize on K2's plain pass: (g, G, B, C) within
    K2_TOL * (max|plain| + 1), with the call ms of each."""
    import torch

    from tpu_locoman_torch import convert

    parts = []
    for label, dyn, robot, fkw in PATH_VARIANTS:
        tol = 1e-3
        if label in VARIANT_FIXTURES:
            sp_ = convert.load_golden(VARIANT_FIXTURES[label])["spread"]
            tol = max(tol, SPREAD_FACTOR * sp_["x"])
        reset_launches()
        ex, ez = compare_paths(dev, ship, batch=8, ticks=3, dynamics=dyn,
                               robot=robot, form_kwargs=fkw)
        launches = read_launches()
        check(ex <= tol and ez <= tol,
              f"{label} kernel vs plain path: x {ex} Z {ez} > {tol}")
        parts.append(f"{label} x {ex:.3g} Z {ez:.3g} (tol {tol:.3g}; K1 "
                     f"{launches[0]} K2 {launches[1]})")
    B = carry.x_init.shape[0]
    t = torch.full((B,), 7 * mpc.dt_min, device=dev)
    target = torch.tensor([0.2, 0, 0, 0, 0, 0], device=dev).repeat(B, 1)
    sh = mpc.make_shared(carry.x_init, target, tau_prev=carry.tau_prev)
    sp = mpc.make_stage_params(t)
    Z = mpc.warm_start_Z(carry.solver_state.Z, sp, sh)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = mpc.trans.linearize(Z, sp, sh)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = read_launches()
    check(launches == (0, 1, 0), f"whole-stage linearize launches {launches}")
    with plain_kernels():
        ref = mpc.trans.linearize(Z, sp, sh)
    errs = {}
    for lab, o, r in zip(("g", "G", "B", "C"), out, ref):
        check(bool(torch.isfinite(o).all()), f"linearize {lab} non-finite")
        e = float((o - r).abs().max()) / (float(r.abs().max()) + 1.0)
        check(e <= K2_TOL, f"linearize {lab}: K2 vs plain normalized {e}")
        errs[lab] = e
    del out, ref
    k_ms = median_ms(torch, lambda: mpc.trans.linearize(Z, sp, sh), reps=5,
                     warm=1)
    with plain_kernels():
        p_ms = median_ms(torch, lambda: mpc.trans.linearize(Z, sp, sh),
                         reps=5, warm=1)
    return (f"[25 variant paths] kernel path == plain path on the card, "
            f"batch 8, 3 ticks: " + "; ".join(parts)
            + f"; whole-stage linearize of include_acc=False at batch {B} "
            f"(B*N = {B * mpc.nodes} nodes, {mpc.trans.ndx * 2 + mpc.trans.nu}"
            f" tangents) with K2 ({launches[1]} launch, inside torch.func) "
            f"== with K2's plain pass: normalized err " + ", ".join(
                f"{k} {e:.3g}" for k, e in errs.items())
            + f" (tol {K2_TOL}); call ms {k_ms:.2f} (plain pass {p_ms:.2f}); "
            f"peak device memory {peak:.2f} GiB")


def phase_ops(dev, ship, E=512 * 14):
    """26: checkpoint resume (the flagship at batch 8: 2 ticks, save, load,
    the third tick against the uninterrupted third tick, within 1e-6);
    diagnostics.structure_check of the flagship and of include_acc=False;
    rnea_wf, crba_wf and ccrba_wf against the recursions at B2G B = 7168
    with forces, within WF_TOL (relative, as the CPU tests)."""
    import tempfile

    import numpy as np
    import torch

    import tpu_locoman_torch as T
    from tpu_locoman_torch import checkpoint, diagnostics, rbda

    mpc = hot_mpc(T, dev, ship["factorizer"], ship=ship)
    tg = torch.zeros(8, 6, device=dev)
    tg[:, 0] = torch.linspace(0.0, 0.3, 8, device=dev)
    c = T.batched_init(mpc, 8)
    for k in range(2):
        c, _ = mpc.step(c, k * mpc.dt_min, tg)
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save_carry(os.path.join(tmp, "carry"), c)
        restored = checkpoint.load_carry(path)
    check(restored.x_init.device == c.x_init.device, "load_carry off the card")
    c1, _ = mpc.step(c, 2 * mpc.dt_min, tg)
    c2, _ = mpc.step(restored, 2 * mpc.dt_min, tg)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        torch.utils._pytree.tree_leaves(c1),
        torch.utils._pytree.tree_leaves(c2)))
    check(diff <= 1e-6, f"resumed tick off by {diff}")
    reps = {"flagship": diagnostics.structure_check(mpc),
            "include_acc=False": diagnostics.structure_check(hot_mpc(
                T, dev, ship["factorizer"], ship=ship,
                form_kwargs={"include_acc": False}))}
    for k, rep in reps.items():
        check(rep["finite"], f"structure_check {k}: non-finite")
    rob = T.B2G()
    m = rob.model
    ee = tuple(rob.FOOT_FRAMES) + (rob.ext_force_frame,)
    q, v, a, r2 = k2_samples(np, rob, E, seed=26)
    f = r2.standard_normal((E, 3 * len(ee))).astype(np.float32) * 50.0
    qt, vt, at, ft = (torch.tensor(x, device=dev) for x in (q, v, a, f))
    wf = {}
    for name, o, r in (
            ("rnea_wf", rbda.rnea_wf(m, qt, vt, at, ee, ft),
             rbda.rnea(m, qt, vt, at, ee, ft)),
            ("crba_wf", rbda.crba_wf(m, qt), rbda.crba(m, qt)),
            ("ccrba_wf", rbda.ccrba_wf(m, qt), rbda.ccrba(m, qt))):
        e = float((o - r).abs().max()) / (float(r.abs().max()) + 1.0)
        check(e <= WF_TOL, f"{name} vs the recursion: normalized {e}")
        wf[name] = e
    return ("[26 ops] checkpoint: flagship batch 8, save after 2 ticks, "
            f"load_carry onto the card, tick 3 against the uninterrupted tick "
            f"3: max abs diff {diff:.3g} (tol 1e-6); structure_check: "
            + "; ".join(f"{k} {rep}" for k, rep in reps.items())
            + f"; world-frame variants against the recursions, B2G B={E} "
            f"with forces, normalized err " + ", ".join(
                f"{k} {e:.3g}" for k, e in wf.items()) + f" (tol {WF_TOL})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="FILE",
                    help="write torch.profiler tables of three flagship "
                         "ticks to FILE, of three accurate single-robot "
                         "ticks to FILE.accurate, of three whole_body_aba "
                         "ticks to FILE.aba, of three sequential flagship "
                         "ticks to FILE.seq and of three ticks of each "
                         "variant path to FILE.rnea_noacc, FILE.acc_nobase "
                         "and FILE.euler, after every timed phase")
    ap.add_argument("--export-worker", nargs=2, metavar=("LABEL", "DIR"),
                    help=argparse.SUPPRESS)  # phase 27's worker processes
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if args.export_worker:
        return export_worker(*args.export_worker)
    with contextlib.ExitStack() as stack:
        return run(args, stack)


def run(args, stack):
    """Phases 1-31; ``stack`` ends the export workers and their files."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)

    import tpu_locoman_torch as T
    from tpu_locoman_torch import _build, rbda, rnea_derivs
    from tpu_locoman_torch.solver import chol_base, fac_whole
    from tpu_locoman_torch.solver import qp as tqp

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    clock = [time.time()]

    def plog(msg):
        """One phase's line, with the seconds since the previous one."""
        now = time.time()
        log(f"{msg}; {now - clock[0]:.1f} s")
        clock[0] = now

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    plog(f"[1 device] nvidia-smi: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is on")

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    _build.load()
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    plog(f"[2 build] kernels built and loaded in {time.time() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s); ptxas: {' | '.join(regs)}")
    export_dir = stack.enter_context(tempfile.TemporaryDirectory())
    workers = start_export_workers(export_dir)
    stack.callback(lambda: [p.kill() for p in workers.values()
                            if p.poll() is None])

    # ---- 3. K1 against its plain version ---------------------------------
    rng = np.random.default_rng(0)
    k1_err, k1_rows = 0.0, []
    for B, s in K1_SHAPES:
        A = rng.standard_normal((B, s, s)).astype(np.float32)
        S = torch.tensor(A @ A.transpose(0, 2, 1)
                         + s * np.eye(s, dtype=np.float32), device=dev)
        out = chol_base.chol_inv_node(S)
        ref = chol_base.chol_inv_node_plain(S)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        nrm = e / (float(ref.abs().max()) + 1.0)
        check(nrm <= K1_TOL, f"K1 B={B} s={s}: normalized error {nrm}")
        k1_err = max(k1_err, e)
        if B < 512:
            continue
        # yardstick (the port never calls it): no one PyTorch call gives
        # L^-1 from S, so cholesky_ex (no host sync) and a triangular solve
        # against I
        eye = torch.eye(s, device=dev).expand(B, s, s)
        row = {"B": B, "s": s,
               "kernel": times(torch, lambda: chol_base.chol_inv_node(S)),
               "plain": times(torch,
                              lambda: chol_base.chol_inv_node_plain(S), 10),
               "library": times(torch, lambda: torch.linalg.solve_triangular(
                   torch.linalg.cholesky_ex(S).L, eye, upper=False)),
               # bytes: S read, L^-1 written; operations: Cholesky and
               # inverse, s^3/3 each
               "bound": bound(2 * S.numel() * 4, B * 2 * s ** 3 / 3)}
        k1_rows.append(row)
    bad = torch.eye(105, device=dev).repeat(4, 1, 1)
    bad[1] = -bad[1]
    out = chol_base.chol_inv_node(bad)
    check(torch.isnan(out[1]).any() and torch.isfinite(out[0]).all(),
          "K1 must keep NaN for a non-SPD block")
    nan_pattern = {"kernel": nonfinite_pattern(torch, out[1]),
                   "plain": nonfinite_pattern(
                       torch, chol_base.chol_inv_node_plain(bad)[1])}
    k1_main = k1_rows[0]
    k1_81 = next(r for r in k1_rows if r["s"] == 81)
    plog(f"[3 K1] chol_inv_node == plain for (B, s) in {K1_SHAPES}: max abs "
        f"err {k1_err:.3g} (normalized tol {K1_TOL}); NaN kept for a "
        f"non-SPD block (-I, s=105; NaN / inf / finite entries below, on "
        f"and above the diagonal: kernel {nan_pattern['kernel']}, plain "
        f"{nan_pattern['plain']}); device ms / call ms: " + "; ".join(
            f"B={r['B']} s={r['s']}: kernel {r['kernel'][0]:.4f} / "
            f"{r['kernel'][1]:.4f}, plain {r['plain'][0]:.4f} / "
            f"{r['plain'][1]:.4f}, cholesky_ex + solve_triangular "
            f"{r['library'][0]:.4f} / {r['library'][1]:.4f}, bound "
            f"{r['bound'][0]:.6f} ({r['bound'][1]})" for r in k1_rows))

    # ---- 4. K2 against its plain version ---------------------------------
    # B2G at the flagship's flat batch (512 x 14), at accurate batch 1's
    # (14), at a ragged 5 and at the N=30 path's (512 x 30); Go2 and B2
    # with the front payload (the general instance on a 13-link tree with a
    # fifth force frame) at 7168: with and without forces
    k2_err, k2_inputs = 0.0, {}
    for name, kw, B in K2_CASES:
        rob = getattr(T, name)(**kw)
        m = rob.model
        ee = tuple(rob.FOOT_FRAMES) + ((rob.ext_force_frame,)
                                       if rob.ext_force_frame else ())
        q, v, a, r2 = k2_samples(np, rob, B, seed=B + len(ee))
        f = r2.standard_normal((B, 3 * len(ee))).astype(np.float32) * 50.0
        qt, vt, at, ft = (torch.tensor(x, device=dev) for x in (q, v, a, f))
        for with_f in (True, False):
            args_ = (m, qt, vt, at, ee, ft) if with_f else (m, qt, vt, at)
            out = rnea_derivs.rnea_derivatives(*args_)
            ref = rnea_derivs.rnea_derivatives_plain(*args_)
            torch.cuda.synchronize()
            check(len(out) == len(ref) == (4 if with_f else 3),
                  f"K2 outputs: {len(out)} from the kernel, {len(ref)} plain")
            for oname, o, r in zip(("dq", "dv", "da", "df"), out, ref):
                e = float((o - r).abs().max())
                tol = K2_TOL * (float(r.abs().max()) + 1.0)
                check(e <= tol,
                      f"K2 {name} {oname} B={B} forces={with_f}: {e} > {tol}")
                k2_err = max(k2_err, e)
        if (name, B) in K2_TIMED:
            k2_inputs[K2_TIMED[(name, B)]] = (m, qt, vt, at, ee, ft)
    k2_rows = {}
    for label, (m_, q_, v_, a_, ee_, f_) in k2_inputs.items():
        B = q_.shape[0]
        fq = rnea_derivs.forward_quantities(m_, q_, v_, a_, ee_, f_)
        reps = 20 if B > 14 else 100
        # the forward pass and the plain pass copy nothing from the host,
        # so a CUDA graph holds them as it holds the kernel
        row = {"kernel": times(torch, lambda: rnea_derivs.derivative_pass(
            m_, fq, v_, a_, ee_, f_), reps, "global"),
               "plain": times(torch, lambda: rnea_derivs.derivative_pass_plain(
                   m_, fq, v_, a_, ee_, f_), min(reps, 20), "global"),
               "forward": times(torch, lambda: rnea_derivs.forward_quantities(
                   m_, q_, v_, a_, ee_, f_), min(reps, 20), "global")}
        # bytes: the kernel's inputs (forward quantities, v, a, forces) read
        # and its four outputs written; operations: per live (link, dof)
        # pair of the ancestry, 6 spatial-inertia products (72 each), 8
        # spatial cross products (30 each) and its share of the three
        # subtree sums (36)
        k2_in = [fq[k] for k in ("Sw", "Iw", "sdot", "Vl", "A", "Iv", "IA",
                                 "f", "pf")] + [v_, a_, f_]
        nv, nfr = m_.nv, len(ee_)
        k2_out = B * (3 * nv * nv + nv * 3 * nfr)
        pairs = float(m_.tensors(dev)["anc"].sum())
        row["bound"] = bound(4 * (sum(t.numel() for t in k2_in) + k2_out),
                             B * pairs * (6 * 72 + 8 * 30 + 36))
        row["B"] = B
        row["first"] = K2_FIRST_MS.get(B) if label.startswith("B2G") else None
        k2_rows[label] = row
        del fq
    plog("[4 K2] rnea_derivatives == plain for " + ", ".join(
        f"{n}{'(' + str(kw) + ')' if kw else ''} B={B}" for n, kw, B in K2_CASES)
        + f", with and without forces: max abs err {k2_err:.3g} (tol "
        f"{K2_TOL}*(max+1)); with forces, device ms / call ms: " + "; ".join(
            f"{label} ({rnea_derivs.lanes_per_element(r['B'], dev)} threads per "
            f"element): kernel {r['kernel'][0]:.4f} / {r['kernel'][1]:.4f} (first "
            f"design: {'not measured' if r['first'] is None else '%.4f / %.4f' % r['first']}"
            f"), plain pass {r['plain'][0]:.4f} / {r['plain'][1]:.4f}, bound "
            f"{r['bound'][0]:.6f} ({r['bound'][1]}), the plain-torch forward "
            f"pass before it {r['forward'][0]:.4f} / {r['forward'][1]:.4f}"
            for label, r in k2_rows.items()))

    # ---- 5. the flagship main path -----------------------------------------
    with open(os.path.join(ROOT, "SHIPPING.json")) as fh:
        ship = json.load(fh)["bench_defaults"]
    batch, warm, timed = 512, 2, 20
    chol_base.launches = rnea_derivs.launches = fac_whole.launches = 0
    fl, _ = run_flagship(dev, ship, batch, warm, timed)
    k1_launches, k2_launches, k3_flag = read_launches()
    ticks = warm + timed
    # one K1 launch per node of the one factorization per tick (N+1 = 15)
    check(k1_launches == 15 * ticks, f"K1 launches {k1_launches}")
    check(k2_launches == ticks, f"K2 launches {k2_launches}")
    check(k3_flag == 0, f"K3 launches {k3_flag}")
    check(fl["viol_mean"] <= VIOL_GATE,
          f"violation mean {fl['viol_mean']} > {VIOL_GATE}")
    tick_ms = fl["tick_ms"]
    ms_mean = float(np.mean(tick_ms))
    plog(f"[5 flagship] B2G whole_body_rnea N=14 batch {batch} "
        f"({ship['factorizer']}, admm {ship['admm_iters']}, corrector "
        f"{ship['corrector']}, ls {ship['ls_trials']}): {ms_mean:.2f} ms/tick "
        f"mean, {float(np.median(tick_ms)):.2f} p50, min {min(tick_ms):.2f}, "
        f"max {max(tick_ms):.2f} over {timed} ticks; "
        f"{batch * 1e3 / ms_mean:.1f} solves/s; max_violation mean "
        f"{fl['viol_mean']:.4f} worst tick {fl['viol_worst']:.4f} (gate "
        f"{VIOL_GATE}); status {fl['status']}; launches K1 {k1_launches} "
        f"K2 {k2_launches} over {ticks} ticks; host load average "
        f"{os.getloadavg()[0]:.2f} on {os.cpu_count()} cores")

    def batched_ticks(dynamics, factorizer=ship["factorizer"],
                      robot=("B2G", {}), form_kwargs=None):
        mpc = hot_mpc(T, dev, factorizer, ship=ship, dynamics=dynamics,
                      robot=robot, form_kwargs=form_kwargs)
        targets = torch.tensor([0.2, 0, 0, 0, 0, 0], device=dev).repeat(
            batch, 1)
        return (T.batched_step(mpc), T.batched_init(mpc, batch), targets,
                mpc.dt_min)

    # (tag, what, file, unprofiled ms/tick, step arguments), profiled after
    # every timed phase: a torch.profiler session leaves state behind in
    # the process (it stopped recording device time after the first large
    # profile), so no timed tick follows one
    profiles = [("5b", "three flagship ticks", args.profile, ms_mean,
                 lambda: batched_ticks("whole_body_rnea"))]

    # ---- 6. kernel path against plain path ---------------------------------
    ex, ez = compare_paths(dev, ship, batch=8, ticks=3)
    check(ex <= 1e-3 and ez <= 1e-3, f"kernel vs plain path: x {ex} Z {ez}")
    plog(f"[6 paths] kernel path == plain path on the card, batch 8, 3 "
        f"ticks: x max abs err {ex:.3g} (tol 1e-3), Z normalized err "
        f"{ez:.3g} (tol 1e-3)")

    # ---- 7. JAX golden fixture -----------------------------------------------
    gx, gv, grel, n_ticks, n_b = replay_golden(dev, "cholinv_pb")
    plog(f"[7 golden] JAX fixture replayed ({n_ticks} ticks, batch {n_b}): x "
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
            reps = 10 if Bs > 1 else 20
            k_t = times(torch, lambda: fac_whole.factorize_whole(H, U), reps)
            p_t = times(torch, lambda: fac_whole.factorize_whole_plain(H, U),
                        5)
            pb_t = times(torch, lambda: tqp.factorize(
                H, U, chol_impl="cholinv_pb"), reps)
            nbytes, ops = k3_work(Bs, K, s_)
            k3_rows.append({"K": K, "s": s_, "Bs": Bs, "t": k_t,
                            "plain": p_t, "cholinv_pb": pb_t,
                            "first_ms": K3_FIRST_MS[(K, s_, Bs)],
                            "bound": bound(nbytes, ops), "mflop": ops / 1e6,
                            "mb": nbytes / 1e6})
            del H, U, b, out, ref, pairs
    bad = torch.eye(10, device=dev).repeat(2, 4, 1, 1)
    bad[1, 2] = -bad[1, 2]
    out = fac_whole.factorize_whole(bad, torch.zeros(2, 3, 10, 10, device=dev))
    check(torch.isnan(out.Linv[1, 2]).any() and torch.isfinite(out.Linv[0]).all(),
          "K3 must keep NaN for a non-SPD block")
    plog(f"[8 K3] factorize_whole == plain (Linv, W, V, solve) for (K, s) in "
        f"((15, 105), (14, 110)), Bs in (1, 512): max abs err {k3_err:.3g} "
        f"(normalized tol {K3_TOL}); NaN kept for a non-SPD block; device "
        f"ms / call ms: " + "; ".join(
            f"K={r['K']} s={r['s']} Bs={r['Bs']}: kernel {r['t'][0]:.4f} / "
            f"{r['t'][1]:.4f} (first design {r['first_ms']:.4f} call ms, "
            f"PERF.md), plain {r['plain'][0]:.4f} / {r['plain'][1]:.4f}, "
            f"cholinv_pb {r['cholinv_pb'][0]:.4f} / {r['cholinv_pb'][1]:.4f}"
            f", bound {r['bound'][0]:.6f} ({r['bound'][1]}: "
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
    plog(f"[9 accurate] B2G whole_body_rnea N=14 batch 1, SQPConfig.accurate() "
        f"with factorizer pallas: {ms_summary(acc['tick_ms'])}; max_violation "
        f"mean {acc['viol_mean']:.3g} worst tick {acc['viol_worst']:.3g} "
        f"(gate {ACC_GATE}); status {acc['status']}; launches K1 "
        f"{acc_launches[0]} K2 {acc_launches[1]} K3 {acc_launches[2]} over "
        f"{ticks} ticks; MPC.run(10): max_violation mean {run_viol:.3g}, "
        f"status {outs['status'].flatten().tolist()}, launches K1 "
        f"{run_launches[0]} K2 {run_launches[1]} K3 {run_launches[2]}")
    del acc_mpc

    def accurate_ticks():
        mpc = accurate_mpc(T, acc_cfg)
        return mpc.step, mpc.init_carry(1), target, mpc.dt_min

    profiles.append(("9b", "three accurate single-robot ticks",
                     f"{args.profile}.accurate",
                     float(np.mean(acc["tick_ms"])), accurate_ticks))

    # ---- 10. accurate mode at production batch --------------------------------
    chol_base.launches = rnea_derivs.launches = fac_whole.launches = 0
    warm, timed = 1, 5
    prod_mpc = accurate_mpc(T, "accurate")
    prod = run_ticks(prod_mpc.step, prod_mpc.init_carry(512),
                     target.repeat(512, 1), prod_mpc.dt_min, warm, timed)
    ticks = warm + timed
    prod_launches = (chol_base.launches, rnea_derivs.launches,
                     fac_whole.launches)
    # K1: 15 nodes in prepare and 14 in each of four eq_project passes
    check(prod_launches[0] == 71 * ticks and prod_launches[1] == 5 * ticks
          and prod_launches[2] == 0,
          f"accurate batch 512 launches K1, K2, K3 = {prod_launches}")
    check(prod["viol_mean"] <= ACC_GATE,
          f"accurate batch 512 violation mean {prod['viol_mean']}")
    prod_ms = float(np.mean(prod["tick_ms"]))
    plog(f"[10 accurate b512] config=\"accurate\" (cholinv_pb) batch 512: "
        f"{ms_summary(prod['tick_ms'])}; {512e3 / prod_ms:.1f} solves/s; "
        f"max_violation mean {prod['viol_mean']:.3g} worst tick "
        f"{prod['viol_worst']:.3g} (gate {ACC_GATE}); status "
        f"{prod['status']}; launches per tick K1 {prod_launches[0] // ticks} "
        f"K2 {prod_launches[1] // ticks} K3 {prod_launches[2] // ticks}")

    # ---- 11. factorizers against each other -----------------------------------
    fz, fz_solve = compare_factorizers(dev, ship, ("pallas", "babe_pb"),
                                       solve_only=("sequential", "cyclic"))
    plog("[11 factorizers] hot config batch 8, 3 ticks, against cholinv_pb: "
        + "; ".join(f"{n} x max abs err {ex:.3g}, Z normalized err {ez:.3g}"
                    for n, (ex, ez) in fz.items()) + " (tol 1e-3 each); "
        "solve error on the run's KKT blocks against float64, worst tick: "
        + ", ".join(f"{n} {e:.3g}" for n, e in fz_solve.items())
        + f" (cholinv_pb and pallas <= {SOLVE_ERR_RATIO} x cholinv)")
    for name, (ex, ez) in fz.items():
        check(ex <= 1e-3 and ez <= 1e-3,
              f"{name} vs cholinv_pb: x {ex} Z {ez}")
    for name in ("cholinv_pb", "pallas"):
        check(fz_solve[name] <= SOLVE_ERR_RATIO * fz_solve["cholinv"],
              f"{name} solve error {fz_solve[name]} > {SOLVE_ERR_RATIO} x "
              f"the plain f32 recursion's {fz_solve['cholinv']}")

    # ---- 12. accurate JAX golden fixture -----------------------------------------
    gx, gv, _, n_ticks, n_b = replay_golden(dev, "pallas", GOLDEN_ACC)
    plog(f"[12 golden accurate] JAX fixture replayed with pallas ({n_ticks} "
        f"ticks, batch {n_b}): x max abs err {gx:.3g} (tol {ACC_X_TOL}), violation "
        f"max abs err {gv:.3g} (tol {ACC_VIOL_TOL}, and <= {ACC_GATE} on "
        f"both sides), alpha and status equal")

    # ---- 13. aba_derivatives: K1 and K2 at the ABA path's shapes -----------
    rob = T.B2G()
    m = rob.model
    ee = tuple(rob.FOOT_FRAMES) + (rob.ext_force_frame,)
    E = 512 * 14  # the whole_body_aba path's flat batch of nodes
    q, v, a, r2 = k2_samples(np, rob, E, seed=13)
    f = r2.standard_normal((E, 3 * len(ee))).astype(np.float32) * 50.0
    qt, vt, at, ft = (torch.tensor(x, device=dev) for x in (q, v, a, f))
    tau = rbda.rnea(m, qt, vt, at, ee, ft)
    chol_base.launches = rnea_derivs.launches = 0
    out = rbda.aba_derivatives(m, qt, vt, tau, ee, ft)
    torch.cuda.synchronize()
    aba_launches = (chol_base.launches, rnea_derivs.launches)
    check(aba_launches == (1, 1),
          f"aba_derivatives launched K1, K2 {aba_launches} times")
    with plain_kernels():
        ref = rbda.aba_derivatives(m, qt, vt, tau, ee, ft)
    torch.cuda.synchronize()
    aba_err = {}
    for name, o, r in zip(("a", "da/dq", "da/dv", "da/dtau", "da/df"), out,
                          ref):
        e = float((o - r).abs().max())
        scale = float(r.abs().max()) + 1.0
        check(e <= K2_TOL * scale,
              f"aba_derivatives {name}: {e} > {K2_TOL} * {scale}")
        aba_err[name] = e / scale
    id_err = float((out[0] - at).abs().max()) / (float(at.abs().max()) + 1.0)
    check(id_err <= ABA_ID_TOL, f"aba(rnea(a)) - a: normalized {id_err}")
    nv = m.nv
    Mm = rbda.crba(m, qt) + 1e-6 * torch.eye(nv, device=dev)
    o1, r1 = chol_base.chol_inv_node(Mm), chol_base.chol_inv_node_plain(Mm)
    torch.cuda.synchronize()
    k1_aba_err = float((o1 - r1).abs().max())
    check(k1_aba_err <= K1_TOL * (float(r1.abs().max()) + 1.0),
          f"K1 at ({E}, {nv}): {k1_aba_err}")
    eye = torch.eye(nv, device=dev).expand(E, nv, nv)
    k1_aba = {"B": E, "s": nv,
              "kernel": times(torch, lambda: chol_base.chol_inv_node(Mm)),
              "plain": times(torch,
                             lambda: chol_base.chol_inv_node_plain(Mm), 10),
              "library": times(torch, lambda: torch.linalg.solve_triangular(
                  torch.linalg.cholesky_ex(Mm).L, eye, upper=False)),
              "bound": bound(2 * Mm.numel() * 4, E * 2 * nv ** 3 / 3)}
    # the line search's mass matrices: both trials of every node in one
    # launch, at twice the flat batch
    q2, _, _, _ = k2_samples(np, rob, 2 * E, seed=14)
    M2 = rbda.crba(m, torch.tensor(q2, device=dev)) + 1e-6 * torch.eye(
        nv, device=dev)
    o2, r2_ = chol_base.chol_inv_node(M2), chol_base.chol_inv_node_plain(M2)
    torch.cuda.synchronize()
    k1_aba2_err = float((o2 - r2_).abs().max())
    check(k1_aba2_err <= K1_TOL * (float(r2_.abs().max()) + 1.0),
          f"K1 at ({2 * E}, {nv}): {k1_aba2_err}")
    eye2 = torch.eye(nv, device=dev).expand(2 * E, nv, nv)
    k1_aba2 = {"B": 2 * E, "s": nv,
               "kernel": times(torch, lambda: chol_base.chol_inv_node(M2)),
               "plain": times(torch,
                              lambda: chol_base.chol_inv_node_plain(M2), 10),
               "library": times(torch, lambda: torch.linalg.solve_triangular(
                   torch.linalg.cholesky_ex(M2).L, eye2, upper=False)),
               "bound": bound(2 * M2.numel() * 4, 2 * E * 2 * nv ** 3 / 3)}
    del M2, o2, r2_, eye2
    aba_call = median_ms(torch, lambda: rbda.aba_derivatives(
        m, qt, vt, tau, ee, ft), reps=10)
    with plain_kernels():
        aba_plain_call = median_ms(torch, lambda: rbda.aba_derivatives(
            m, qt, vt, tau, ee, ft), reps=5)
    del out, ref, Mm, o1, r1
    plog(f"[13 aba_derivatives] B2G E={E} with forces, kernel route (K1 "
        f"{aba_launches[0]}, K2 {aba_launches[1]} launches) == plain route, "
        f"normalized err " + ", ".join(f"{k} {e:.3g}"
                                       for k, e in aba_err.items())
        + f" (tol {K2_TOL}); aba(q, v, rnea(q, v, a, f), f) - a normalized "
        f"{id_err:.3g} (tol {ABA_ID_TOL}); call ms {aba_call:.4f} (plain "
        f"route {aba_plain_call:.4f}); K1 at ({E}, {nv}) max abs err "
        f"{k1_aba_err:.3g}, device ms / call ms: kernel "
        f"{k1_aba['kernel'][0]:.4f} / {k1_aba['kernel'][1]:.4f}, plain "
        f"{k1_aba['plain'][0]:.4f} / {k1_aba['plain'][1]:.4f}, cholesky_ex + "
        f"solve_triangular {k1_aba['library'][0]:.4f} / "
        f"{k1_aba['library'][1]:.4f}, bound {k1_aba['bound'][0]:.6f} "
        f"({k1_aba['bound'][1]}); K1 at ({2 * E}, {nv}) max abs err "
        f"{k1_aba2_err:.3g}, device ms / call ms: kernel "
        f"{k1_aba2['kernel'][0]:.4f} / {k1_aba2['kernel'][1]:.4f}, plain "
        f"{k1_aba2['plain'][0]:.4f} / {k1_aba2['plain'][1]:.4f}, cholesky_ex "
        f"+ solve_triangular {k1_aba2['library'][0]:.4f} / "
        f"{k1_aba2['library'][1]:.4f}, bound {k1_aba2['bound'][0]:.6f} "
        f"({k1_aba2['bound'][1]})")

    # ---- 14. the whole_body_aba path -----------------------------------------
    warm, timed = 2, 10
    chol_base.launches = rnea_derivs.launches = fac_whole.launches = 0
    ab, ab_mpc = run_flagship(dev, ship, batch, warm, timed,
                              dynamics="whole_body_aba")
    ab_launches = (chol_base.launches, rnea_derivs.launches,
                   fac_whole.launches)
    ticks = warm + timed
    # K1 per tick: the 15 node blocks of the factorization, and ABA's mass
    # matrix once in linearize, once for all line-search trials and once
    # in the corrector's evaluation
    check(ab_launches == (18 * ticks, ticks, 0),
          f"whole_body_aba launches K1, K2, K3 = {ab_launches}")
    check(ab["viol_mean"] <= VIOL_GATE,
          f"whole_body_aba violation mean {ab['viol_mean']} > {VIOL_GATE}")
    chol_base.launches = rnea_derivs.launches = 0
    ret = ab_mpc.retract(ab["carry"].solver_state.Z, ab["carry"].x_init)
    torch.cuda.synchronize()
    ret_launches = (chol_base.launches, rnea_derivs.launches)
    check(ret_launches == (1, 0), f"retract launches K1, K2 {ret_launches}")
    for k_, x in ret.items():
        check(x.shape[:2] == (batch, 14) and bool(torch.isfinite(x).all()),
              f"retract: {k_} {tuple(x.shape)} or non-finite")
    ab_ms = float(np.mean(ab["tick_ms"]))
    plog(f"[14 whole_body_aba] B2G whole_body_aba N=14 batch {batch} "
        f"({ship['factorizer']}, admm {ship['admm_iters']}, corrector "
        f"{ship['corrector']}, ls {ship['ls_trials']}): "
        f"{ms_summary(ab['tick_ms'])}; {batch * 1e3 / ab_ms:.1f} solves/s; "
        f"max_violation mean {ab['viol_mean']:.4f} worst tick "
        f"{ab['viol_worst']:.4f} (gate {VIOL_GATE}); status {ab['status']}; "
        f"launches K1 {ab_launches[0]} K2 {ab_launches[1]} K3 "
        f"{ab_launches[2]} over {ticks} ticks; MPC.retract: K1 "
        f"{ret_launches[0]} K2 {ret_launches[1]}, finite")
    del ab_mpc, ret
    profiles.append(("14b", "three whole_body_aba ticks",
                     f"{args.profile}.aba", ab_ms,
                     lambda: batched_ticks("whole_body_aba")))

    # ---- 15. whole_body_aba JAX golden fixture ---------------------------------
    gx, gv, grel, n_ticks, n_b = replay_golden(dev, "cholinv_pb", GOLDEN_ABA)
    plog(f"[15 golden aba] JAX fixture replayed ({n_ticks} ticks, batch "
        f"{n_b}): x max abs err {gx:.3g} (tol {ABA_X_TOL}), violation max "
        f"abs err {gv:.3g} (tol {100 * ABA_VIOL_REL:.0f}% per tick), rollout "
        f"mean violation off by {100 * grel:.2f}% (tol "
        f"{100 * ABA_MEAN_REL:.0f}%), alpha and status equal")

    # ---- 16. the other three formulations --------------------------------------
    tg8 = torch.zeros(8, 6, device=dev)
    tg8[:, 0] = torch.linspace(0.0, 0.3, 8, device=dev)
    others = []
    for name, k2_per_tick in (("whole_body_acc", 1), ("centroidal_acc", 0),
                              ("centroidal_vel", 0)):
        chol_base.launches = rnea_derivs.launches = 0
        mpc = hot_mpc(T, dev, "cholinv_pb", ship=ship, dynamics=name)
        r = run_ticks(mpc.step, mpc.init_carry(8), tg8, mpc.dt_min, 0, 3)
        launches = (chol_base.launches, rnea_derivs.launches)
        check(launches == (15 * 3, k2_per_tick * 3),
              f"{name} launches K1, K2 = {launches}")
        ret = mpc.retract(r["carry"].solver_state.Z, r["carry"].x_init)
        for k_, x in ret.items():
            check(bool(torch.isfinite(x).all()), f"{name} retract: {k_}")
        others.append(f"{name} max_violation mean {r['viol_mean']:.4f} worst "
                      f"tick {r['viol_worst']:.4f}, status {r['status']}, "
                      f"launches K1 {launches[0]} K2 {launches[1]}")
    ex, ez = compare_paths(dev, ship, batch=8, ticks=3,
                           dynamics="whole_body_acc")
    check(ex <= 1e-3 and ez <= 1e-3,
          f"whole_body_acc kernel vs plain path: x {ex} Z {ez}")
    plog(f"[16 formulations] B2G N=14 batch 8, 3 ticks, hot config: "
        + "; ".join(others) + f"; retract finite; whole_body_acc kernel "
        f"path == plain path: x max abs err {ex:.3g} (tol 1e-3), Z "
        f"normalized err {ez:.3g} (tol 1e-3)")

    # ---- 17-21. the sequential and cyclic factorizers, Ruiz scaling, B2
    # and the parity dump ----------------------------------------------------
    spreads = load_spreads()
    sq, sq_launches, line = phase_sequential(dev, ship, spreads, batch)
    plog(line)
    profiles.append(("17b", "three sequential flagship ticks",
                     f"{args.profile}.seq", float(np.mean(sq["tick_ms"])),
                     lambda: batched_ticks("whole_body_rnea", "sequential")))
    n30, line = phase_n30(dev, ship, spreads, batch)
    plog(line)
    sc, sc_launches, line = phase_scaled(dev, spreads, batch)
    plog(line)
    b2, b2_launches, line = phase_b2(dev, ship, spreads, batch)
    plog(line)
    _, par_launches, line = phase_parity(dev)
    plog(line)

    # ---- 22-26. the formulation variants and the ops modules ---------------
    var_launches, var_peak, var_ms = {}, {}, {}
    for name in VARIANTS:
        r, var_launches[name], var_peak[name], vmpc, line = phase_variant(
            dev, ship, spreads, name, ms_mean, batch)
        plog(line)
        var_ms[name] = float(np.mean(r["tick_ms"]))
        _, _, dyn, robot, fkw, _ = VARIANTS[name]
        profiles.append((VARIANTS[name][0] + "b", f"three {name} ticks",
                         f"{args.profile}.{name}", float(np.mean(
                             r["tick_ms"])),
                         lambda d=dyn, rb=robot, k=fkw: batched_ticks(
                             d, robot=rb, form_kwargs=k)))
        if name == "rnea_noacc":
            noacc = (vmpc, r["carry"])
        del vmpc, r
    plog(phase_variant_paths(dev, ship, *noacc))
    del noacc
    plog(phase_ops(dev, ship))

    # ---- 27-30. export, the dry run, the examples and the native runtime ---
    exported, line = phase_export(workers, export_dir)
    plog(line)
    plog(phase_quiet_host(dev, ship, batch, ms_mean, var_ms["rnea_noacc"]))
    dry, line = phase_dryrun()
    plog(line)
    _, ex_launches, line = phase_examples(dev)
    plog(line)
    plog(phase_ocp_native(dev))

    for tag, what, path, tick_ms, ticks_of in (profiles if args.profile
                                                else []):
        dev_ms, n_k, wall = profile_ticks(*ticks_of(), path)
        plog(f"[{tag} profile] {what} -> {path}: device {dev_ms:.2f} ms/tick "
             f"in {n_k:.0f} kernels; {wall:.2f} ms/tick under the profiler, "
             f"{tick_ms:.2f} without (idle {100 * (1 - dev_ms / tick_ms):.1f}%"
             f" of the unprofiled tick)")

    # ---- 31. kernels ------------------------------------------------------------
    k3_main = next(r for r in k3_rows if (r["K"], r["Bs"]) == (14, 1))
    k2_main = k2_rows["B2G 7168"]
    # (K1, K2, K3) launches of every path's driven run
    paths = {"flagship": (k1_launches, k2_launches, k3_flag),
             "accurate_b1": acc_launches, "accurate_b512": prod_launches,
             "whole_body_aba": ab_launches, "sequential": sq_launches,
             "n30_sequential": n30["sequential"][1],
             "n30_cyclic": n30["cyclic"][1], "scaled": sc_launches,
             "b2": b2_launches, "parity": par_launches, **var_launches,
             "export_flagship": tuple(exported["flagship"]["launches"]),
             "export_accurate_b1": tuple(
                 exported["accurate b1"]["launches"]),
             "dryrun_gloo_rank0": tuple(
                 dry["gloo x2 on one card"]["rank0_launches"]),
             "run_mpc": ex_launches}

    def per_path(i):
        return {name: n[i] for name, n in paths.items()}

    def k2_row(label):
        r = k2_rows[label]
        return {"ms": r["kernel"][0], "call_ms": r["kernel"][1],
                "plain_ms": r["plain"][0], "plain_call_ms": r["plain"][1],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "forward_ms": r["forward"][0]}
    # ms, plain_ms and library_ms are device ms;
    # *_call_ms the host-inclusive time of one call
    kernels = [
        {"name": "chol_inv_node", "route": "cuda",
         "source": "tpu_locoman_torch/csrc/chol_inv_node.cu",
         "replaces": "tpu_locoman/solver/pallas_base.py:101",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_main["kernel"][0], "plain_ms": k1_main["plain"][0],
         "bound_ms": k1_main["bound"][0], "bound_by": k1_main["bound"][1],
         "library_ms": k1_main["library"][0],
         "call_ms": k1_main["kernel"][1],
         "plain_call_ms": k1_main["plain"][1],
         "library_call_ms": k1_main["library"][1],
         "at": "B=512 s=105 (cholesky_ex + solve_triangular as library); "
               "launches: flagship, 22 ticks",
         "path_launches": per_path(0),
         "callers": "factorize(cholinv_pb) on every hot path, the variants "
                    "included (15 per tick at batch 512); ABA's mass "
                    "matrix (rbda._mass_factor)",
         "aba14336": {"ms": k1_aba2["kernel"][0],
                      "call_ms": k1_aba2["kernel"][1],
                      "plain_ms": k1_aba2["plain"][0],
                      "library_ms": k1_aba2["library"][0],
                      "bound_ms": k1_aba2["bound"][0],
                      "bound_by": k1_aba2["bound"][1],
                      "max_abs_err": k1_aba2_err, "shape": [2 * E, nv]},
         "aba": {"launches": ab_launches[0], "at": "whole_body_aba path, "
                 f"{warm + timed} ticks, per tick 15 at (512, 81), 2 at "
                 f"(7168, 24) (linearize, corrector) and 1 at (14336, 24) "
                 f"(both line-search trials); timed at (7168, 24)",
                 "ms": k1_aba["kernel"][0], "call_ms": k1_aba["kernel"][1],
                 "plain_ms": k1_aba["plain"][0],
                 "bound_ms": k1_aba["bound"][0],
                 "bound_by": k1_aba["bound"][1],
                 "library_ms": k1_aba["library"][0],
                 "max_abs_err": k1_aba_err, "shape": [E, nv],
                 "s81": {"ms": k1_81["kernel"][0],
                         "b2_launches": b2_launches[0],
                         "call_ms": k1_81["kernel"][1],
                         "plain_ms": k1_81["plain"][0],
                         "bound_ms": k1_81["bound"][0],
                         "library_ms": k1_81["library"][0]}}},
        {"name": "rnea_derivs", "route": "cuda",
         "source": "tpu_locoman_torch/csrc/rnea_derivs.cu",
         "replaces": "tpu_locoman/pallas_rbda.py:227",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_main["kernel"][0], "plain_ms": k2_main["plain"][0],
         "bound_ms": k2_main["bound"][0], "bound_by": k2_main["bound"][1],
         "library_ms": None, "call_ms": k2_main["kernel"][1],
         "plain_call_ms": k2_main["plain"][1],
         "forward_ms": k2_main["forward"][0],
         "b14": {"ms": k2_rows["B2G 14"]["kernel"][0],
                 "call_ms": k2_rows["B2G 14"]["kernel"][1],
                 "bound_ms": k2_rows["B2G 14"]["bound"][0]},
         "b2": dict(k2_row("B2 7168"), launches=b2_launches[1],
                    at="B2(payload=front) B=7168 with forces (the general "
                       "instance, 5 force frames); launches: phase 20"),
         "n30": dict(k2_row("B2G 15360"),
                     launches=n30["sequential"][1][1]
                     + n30["cyclic"][1][1],
                     at="B2G B=15360 with forces; launches: phase 18"),
         "path_launches": per_path(1),
         "callers": "the split linearize's RNEA rows (rbda.rnea_jacobians), "
                    "rbda.aba_derivatives, and rbda.rnea_ad's forward-mode "
                    "rule inside the whole-stage linearize of "
                    "whole_body_rnea(include_acc=False) (phases 22, 25)",
         "at": "B=7168 with forces; launches: flagship, 22 ticks",
         "aba": {"launches": ab_launches[1], "at": "whole_body_aba path, "
                 f"{warm + timed} ticks, at B=7168 with forces (timed in "
                 f"phase 4)"}},
        {"name": "fac_whole", "route": "cuda",
         "source": "tpu_locoman_torch/csrc/fac_whole.cu",
         "replaces": "tpu_locoman/solver/pallas_fac.py:155",
         "launches": acc_launches[2], "max_abs_err": k3_err,
         "ms": k3_main["t"][0], "plain_ms": k3_main["plain"][0],
         "bound_ms": k3_main["bound"][0], "bound_by": k3_main["bound"][1],
         "library_ms": None, "call_ms": k3_main["t"][1],
         "plain_call_ms": k3_main["plain"][1],
         "at": "Bs=1 K=14 s=110; launches: accurate single robot, 22 ticks",
         "path_launches": per_path(2),
         "aba": {"launches": ab_launches[2]}},
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
