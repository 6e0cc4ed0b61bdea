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
from .cell import Cell, reader

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


def window(step, carry, inputs, dt, k0, seconds, keep, prof=None,
           prof_ticks=0):
    """Tick closed loop from tick ``k0`` until ``seconds`` have passed.
    With ``prof`` the first ``prof_ticks`` + 1 ticks run under the
    profiler, each in a tick span (the first one warms the profiler up).
    Returns a dict of what was measured, with ``records``: (k, carry in,
    t, carry out, stats) of the first and last tick of the window and of
    those in ``keep``."""
    tick_s, tick_viol, records = [], [], []
    scen, failed = 0, 0
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
        if k == 0 or k in keep:
            records.append(last)
        carry = out
        k += 1
        if prof is not None and k == prof_ticks + 1:
            prof.__exit__(None, None, None)
            prof = None
        if t1 - w0 >= seconds and prof is None:
            break
    if records[-1][0] != last[0]:
        records.append(last)
    return {"w0": w0, "window_s": t1 - w0, "tick_s": tick_s,
            "tick_violation": tick_viol, "scenario_ticks": scen,
            "failed": failed, "records": records}


def run_cell(name, seed, seconds, trace, t_start, device="cuda", batch=None,
             program=None):
    """One run of cell ``name``; returns the result's dict. ``device``,
    ``batch`` and ``program`` (a ``build.Package`` put in the program's
    place) serve the harness's own tests and calibration."""
    cell = Cell(name)
    mix = dict(cell.traffic, **({} if batch is None else {"batch": batch}))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_load = time.perf_counter()
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
    print(f"set-up: {t_load - t_start:.2f} s to load, "
          f"{t_built - t_load:.2f} s to build the MPC, warm-up ticks "
          + ", ".join(f"{x:.2f}" for x in warm_s) + " s", file=sys.stderr)
    ck = cell.settings["check"]
    keep = check.pick_ticks(inputs.rng, ck["horizon"], ck["ticks"])
    trace_ticks = cell.settings["trace_ticks"] if trace else 0
    if cuda:
        torch.cuda.synchronize(dev)
    with spans.installed() if trace else contextlib.nullcontext():
        prof = spans.profiler() if trace else None
        w = window(step, carry, inputs, dt, warm, seconds, keep, prof,
                   trace_ticks)
    setup_s = w["w0"] - t_start
    mem = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    summary = spans.summarize_profile(prof, trace_ticks) if trace else None
    if summary is not None:
        print(f"trace: {summary['device_ops']} device operations, "
              f"{summary['op_us']:.0f} us, of which "
              f"{summary['device_us']['tick']:.0f} us found under the tick "
              f"spans", file=sys.stderr)
    del prof, mpc, step, carry
    records = w.pop("records")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = build.build_mpc(build.reference(), cell.config, dev)
    values = check.compare(records, ref, inputs.base_vel)
    print(f"check: {len(records)} of {len(w['tick_s'])} ticks against the "
          f"reference in {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    correct, shown = check.verdict(values, ck["limits"])

    run = Run(setup_s, w["window_s"], w["tick_s"], w["tick_violation"],
              w["scenario_ticks"], cell.settings, summary)
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
