"""One run of one cell: load, build the cell's MPC on the card from its
configuration file, warm up the cell's own shapes, tick closed loop for
``--seconds``, check a sample of the window's ticks against the plain
reference, and print one JSON line.

A tick is what a user's loop waits for: the call into
``batched_step(mpc)`` and the copy of every scenario's next state,
max_violation and status to the host. Each tick starts after the previous
one has returned. ``--trace 1`` puts spans around the layer calls
(``spans.py``), profiles the window's first ticks and reports the
per-layer metrics instead of the end-to-end ones."""

import argparse
import contextlib
import gc
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import build, check, spans, traffic
from .cell import Cell, reader, window_reads

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_locoman")


class Run(NamedTuple):
    """What a run measured, as the metric readers take it."""

    setup_s: float
    window_s: float
    tick_s: list  # every tick's latency, seconds (for latency metrics)
    tick_violation: list  # every tick's mean max_violation over the batch
    scenario_ticks: int
    settings: dict  # the cell's ``workloads/<cell>.json``
    trace: dict  # spans.summarize's summary, or None
    #: by metric name, what its ``window_read`` read at ``quality_ticks``
    #: (``--trace 1``)
    snapshots: dict = None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _tick(step, carry, t, base_vel):
    """One tick as the user's loop sees it: the step, then every
    scenario's next state, max_violation and status on the host."""
    out, stats = step(carry, t, base_vel)
    host = torch.cat([out.x_init, stats["max_violation"][:, None],
                      stats["status"][:, None].float()], 1).cpu().numpy()
    return out, stats, host


def window(step, carry, inputs, dt, k0, seconds, keep, *, late=None,
           prof=None, prof_ticks=0, ticks=0, snapshot=None):
    """Tick closed loop from tick ``k0`` until ``seconds`` have passed and
    at least ``ticks`` ticks have run. With ``prof`` the first
    ``prof_ticks`` + 1 ticks run under the profiler, each in a tick span
    (the first one warms the profiler up). With ``snapshot`` = (n, read),
    ``read()`` is called once between window ticks n - 1 and n (after the
    last tick where the window holds fewer). Returns a dict of what was
    measured, with ``records``: (k, carry in, t, carry out, stats) of the
    window's first tick, of those in ``keep`` (every tick where ``keep``
    is None) and of tick ``min(last, late)``, and ``snapshot``: what
    ``read()`` returned."""
    tick_s, tick_viol, records = [], [], []
    scen, failed = 0, 0
    snap = None
    if prof is not None:
        prof.__enter__()
    w0 = time.perf_counter()
    k = 0
    while True:
        t = inputs.time(k0 + k, dt)
        span = (torch.profiler.record_function(spans.TICK) if prof is not None
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with span:
            out, stats, host = _tick(step, carry, t, inputs.base_vel)
        t1 = time.perf_counter()
        tick_s.append(t1 - t0)
        scen += host.shape[0]
        tick_viol.append(float(host[:, -2].astype(np.float64).mean()))
        bad = (host[:, -1] == 2) | ~np.isfinite(host[:, :-1]).all(1)
        failed += int(bad.sum())
        last = (k, carry, t, out, stats)
        if k == 0 or keep is None or k in keep or k == late:
            records.append(last)
        carry = out
        k += 1
        if prof is not None and k == prof_ticks + 1:
            prof.__exit__(None, None, None)
            prof = None
        if snapshot is not None and k == snapshot[0]:
            snap = snapshot[1]()
        if t1 - w0 >= seconds and k >= ticks and prof is None:
            break
    if snapshot is not None and k < snapshot[0]:
        snap = snapshot[1]()
    if records[-1][0] != last[0] and (late is None or last[0] < late):
        records.append(last)
    return {"w0": w0, "window_s": t1 - w0, "tick_s": tick_s,
            "tick_violation": tick_viol, "scenario_ticks": scen,
            "failed": failed, "records": records, "snapshot": snap}


class Prepared(NamedTuple):
    """A cell's program built, its inputs made and its shapes warmed up:
    what the window starts from."""

    step: object  # (carry, t, base_vel) -> (carry, stats)
    carry: object
    inputs: traffic.Inputs
    dt: float
    k0: int  # the window's first tick on the clock: after the warm-up
    t_built: float  # perf_counter when the MPC was built
    warm_s: list  # each warm-up tick's seconds


def prepare(cell, seed, dev, batch=None, program=None):
    """Build ``cell``'s MPC of ``program`` (the program by default) on
    ``dev``, make the seed's inputs at the cell's batch (or ``batch``) and
    run the mix's warm-up ticks."""
    mix = dict(cell.traffic, **({} if batch is None else {"batch": batch}))
    pkg = program or build.program()
    mpc = build.build_mpc(pkg, cell.config, dev)
    t_built = time.perf_counter()
    inputs = traffic.make(mix, seed, dev)
    step = pkg.batched_step(mpc, per_scenario_time=inputs.per_scenario)
    carry = pkg.batched_init(mpc, int(mix["batch"]))
    dt = cell.config["dt_min"]
    warm = int(mix["warmup_ticks"])
    warm_s = []
    for k in range(warm):
        t0 = time.perf_counter()
        carry, _, _ = _tick(step, carry, inputs.time(k, dt), inputs.base_vel)
        warm_s.append(time.perf_counter() - t0)
    return Prepared(step, carry, inputs, dt, warm, t_built, warm_s)


def run_cell(name, seed, seconds, trace, t_start, device="cuda", batch=None,
             program=None, ticks=0):
    """One run of cell ``name``; returns the result's dict. ``device``,
    ``batch``, ``program`` (a ``build.Package`` put in the program's
    place) and ``ticks`` (the fewest window ticks) serve the harness's own
    tests and calibration."""
    cell = Cell(name)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_load = time.perf_counter()
    p = prepare(cell, seed, dev, batch, program)
    print(f"set-up: {t_load - t_start:.2f} s to load, "
          f"{p.t_built - t_load:.2f} s to build the MPC, warm-up ticks "
          + ", ".join(f"{x:.2f}" for x in p.warm_s) + " s", file=sys.stderr)
    ck = cell.settings["check"]
    keep = check.pick_ticks(p.inputs.rng, ck["horizon"], ck["ticks"])
    trace_ticks = cell.settings["trace_ticks"] if trace else 0
    reads = window_reads(cell.per_layer) if trace else {}
    snapshot = ((cell.settings["quality_ticks"],
                 lambda: {n: read() for n, read in reads.items()})
                if reads else None)
    if cuda:
        torch.cuda.synchronize(dev)
    with spans.installed() if trace else contextlib.nullcontext():
        prof = spans.profiler() if trace else None
        w = window(p.step, p.carry, p.inputs, p.dt, p.k0, seconds, keep,
                   late=ck["late"], prof=prof, prof_ticks=trace_ticks,
                   ticks=ticks, snapshot=snapshot)
    setup_s = w["w0"] - t_start
    mem = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    summary = spans.summarize_profile(prof, trace_ticks) if trace else None
    if summary is not None:
        print(f"trace: {summary['device_ops']} device operations, "
              f"{summary['op_us']:.0f} us, of which "
              f"{summary['device_us']['tick']:.0f} us found under the tick "
              f"spans", file=sys.stderr)
    inputs = p.inputs
    del prof, p
    records = w.pop("records")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = build.build_mpc(build.reference(), cell.config, dev)
    each = check.compare_each(records, ref, inputs.base_vel)
    del records
    print(f"check: {len(each)} of {len(w['tick_s'])} ticks against the "
          f"reference in {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    for k, g in each.items():
        print(f"check tick {k}: " + ", ".join(f"{n} {v!r}" for n, v in
                                               g.items()), file=sys.stderr)
    correct, shown = check.verdict(check.worst(each), ck["limits"])

    run = Run(setup_s, w["window_s"], w["tick_s"], w["tick_violation"],
              w["scenario_ticks"], cell.settings, summary, w["snapshot"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": mem}
    result = {"correct": bool(correct), "attempted": w["scenario_ticks"],
              "failed": w["failed"], "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = summary["busy_us"] * 1e-6
        dev_info["window_s"] = summary["window_us"] * 1e-6
        result["breakdown"] = {
            "device_ops": [[n[:120], us * 1e-6] for n, us in
                           summary["top_ops"]],
            "idle_gaps": [[n, us * 1e-6] for n, us in summary["idle_gaps"]]}
    result["check_ticks"] = {str(k): g for k, g in each.items()}
    result["check"] = shown
    return result


def main(argv, t_start):
    args = parse(argv)
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import tpu_locoman_torch  # noqa: F401
    except ImportError as exc:
        print(f"no result: the program does not load: {exc}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      t_start)
    bad = forbidden_modules()
    if bad:
        print(f"no result: the run loaded {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
