"""A cell's traced ticks read through the program's own spans
(``tpu_locoman_torch.trace``, reduced by ``program_trace.py``), beside the
traced run's ``bench/`` reduction; or the tracer's cost.

    python3 benchmark/trace_program.py --workload <cell> --seed <n>
    python3 benchmark/trace_program.py --workload <cell> --seed <n> \\
        --pairs 6

The first form builds the cell's MPC with the tracer on (so the first
warm-up tick is recorded), warms up as a run does, profiles the cell's
``trace_ticks`` ticks (one more warms the profiler up) under the
``bench/`` spans, prints the table of the program's spans on stderr and
one JSON line: the traced run's per-layer metrics read as ``harness.py``
reads them, the five that the program's spans give, and the device time
that both reductions charge to the solve, the linearize and the QP.

With ``--pairs`` the profiler stays off: the window alternates blocks of
``--block`` ticks with the tracer on and off (on first in even pairs) and
prints the quartiles of the tick in each state.

A program without ``tpu_locoman_torch.trace`` exits 2 at once."""

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import cell  # noqa: E402

cell.use_checkout_caches()

import torch  # noqa: E402

from benchmark import (build, harness, program_trace, spans,  # noqa: E402
                       traffic)
from benchmark.cell import Cell, reader  # noqa: E402

#: the bench/ span of each layer that both reductions see
SAME_LAYER = {"sqp.solve": "SQPSolver.solve",
              "ocp.linearize": "Transcription.linearize",
              "qp.admm_solve": "admm_solve"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=0)
    ap.add_argument("--block", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None)
    return ap.parse_args(argv)


def _profiler(cuda):
    if cuda:
        return spans.profiler()
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def _start(args, trace):
    """The cell's MPC built with the tracer on, warmed up: (cell, mpc,
    step, carry, inputs, dt, warm)."""
    c = Cell(args.workload)
    mix = dict(c.traffic, **({} if args.batch is None
                             else {"batch": args.batch}))
    dev = torch.device(args.device)
    pkg = build.program()
    trace.reset()
    trace.enable()
    mpc = build.build_mpc(pkg, c.config, dev)
    inputs = traffic.make(mix, args.seed, dev)
    step = pkg.batched_step(mpc, per_scenario_time=inputs.per_scenario)
    carry = pkg.batched_init(mpc, int(mix["batch"]))
    dt = c.config["dt_min"]
    warm = int(mix["warmup_ticks"])
    for k in range(warm):
        carry, _, _ = harness._tick(step, carry, inputs.time(k, dt),
                                    inputs.base_vel)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return c, mpc, step, carry, inputs, dt, warm


def traced(args, trace):
    c, mpc, step, carry, inputs, dt, warm = _start(args, trace)
    cuda = mpc.device.type == "cuda"
    ticks = c.settings["trace_ticks"]
    with spans.installed():
        prof = _profiler(cuda)
        w = harness.window(step, carry, inputs, dt, warm, 0.0, set(),
                           prof=prof, prof_ticks=ticks)
    trace.disable()
    recorded = trace.spans()
    summary = spans.summarize_profile(prof, ticks)
    prog = program_trace.from_profile(prof, recorded, ticks)
    print(program_trace.table(prog), file=sys.stderr)
    run = harness.Run(0.0, w["window_s"], w["tick_s"], w["tick_violation"],
                      w["scenario_ticks"], c.settings, summary)
    values = {}
    for m in c.per_layer:
        v = reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = v
    values.update(program_trace.metrics(prog, recorded))
    rows = prog["rows"]
    same = {name: [rows.get(name, {}).get("device_us", 0.0) / 1e3 / ticks,
                   summary["device_us"][other] / 1e3 / ticks]
            for name, other in SAME_LAYER.items()}
    first = program_trace.first_step_s(recorded)
    return {"workload": c.name, "seed": args.seed, "ticks": ticks,
            "metrics": values, "same_layer_device_ms": same,
            "first_step": {"s": first[0], "built": first[1]},
            "spans_per_tick": sum(r["calls"] for r in rows.values()) / ticks,
            "counters": trace.counters(), "device": _device(mpc.device)}


def overhead(args, trace):
    c, mpc, step, carry, inputs, dt, k = _start(args, trace)
    trace.disable()
    ticks = {True: [], False: []}
    medians = []
    for p in range(args.pairs):
        med = {}
        for on in ((True, False) if p % 2 == 0 else (False, True)):
            (trace.enable if on else trace.disable)()
            trace.reset()
            block = []
            for _ in range(args.block):
                t0 = time.perf_counter()
                carry, _, _ = harness._tick(step, carry, inputs.time(k, dt),
                                            inputs.base_vel)
                block.append(time.perf_counter() - t0)
                k += 1
            ticks[on] += block
            med[on] = sorted(block)[len(block) // 2]
        medians.append([med[True], med[False]])
    trace.disable()
    q = {("on" if on else "off"): program_trace.quartiles(v)
         for on, v in ticks.items()}
    ratio = [a / b for a, b in medians]
    return {"workload": c.name, "seed": args.seed, "pairs": args.pairs,
            "block": args.block, "tick_s_quartiles": q,
            "block_medians_on_off": medians,
            "on_over_off": program_trace.quartiles(ratio),
            "device": _device(mpc.device)}


def _device(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv):
    args = parse(argv)
    try:
        from tpu_locoman_torch import trace
    except ImportError as exc:
        print(f"no result: the program has no tracer: {exc}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = overhead(args, trace) if args.pairs else traced(args, trace)
    out["wall_s"] = time.perf_counter() - T_START
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
