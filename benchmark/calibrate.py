"""Readings that the check's limits and its late tick are set from, for one
cell, in one process on the card:

    python3 benchmark/calibrate.py --workload hot_b512 --seconds 8 \\
        --seeds 11,12,13 --control-seeds 21,22,23 [--faults 31,32,33]

prints one JSON line per run: the program (``program``), the control (the
plain reference with TF32 products put in the program's place,
``control``) and each fault of ``faults.py`` (``fault:<name>``), each
with the check's numbers, worst and per kept tick. Every window stays open
until it has reached the cell's late tick (``check.late``), however short
``--seconds``, so that each run keeps the sample that the benchmark's runs
keep.

    python3 benchmark/calibrate.py --workload accurate_b512 --scan \\
        --seconds 50 --seeds 11 [--scan-to 80] [--control-every 10]

runs one window of the program per seed (held open to ``--scan-to``),
keeps every tick (up to ``--scan-to``, and the last), and then prints for each the check's
numbers of three things, each against the plain reference run from the
program's own carry: the program (``program``), the reference itself run
as two half-batches stacked back together (an honest f32 reordering,
``halves``) and the control (``control``, on every
``--control-every``-th tick). A last line per seed gives the largest of
each by band of ticks, and ``late_max``: the highest tick at and before
which ``halves`` reads at most a fifth of every limit. The benchmark's own
runs never run these."""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import cell  # noqa: E402

cell.use_checkout_caches()

import torch  # noqa: E402

from benchmark import build, check, faults, harness  # noqa: E402

#: ticks per band of the scan's summary
BAND = 10
#: the share of a limit that an honest reordering may read up to the late tick
HONEST_SHARE = 0.2


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def _map(fn, *carries):
    """``fn`` over the tensors of carries alike (nested named tuples)."""
    if torch.is_tensor(carries[0]):
        return fn(*carries)
    return type(carries[0])(*(_map(fn, *f) for f in zip(*carries)))


def halves_step(ref, carry, t, base_vel):
    """One tick of the reference ``ref`` run as two half-batches from
    ``carry``, stacked back together: the same arithmetic per scenario in
    another f32 order. Returns (carry, stats) as ``check.reference_step``
    does, with ``max_violation`` the only stat."""
    c = check.reference_carry(carry)
    h = c.x_init.shape[0] // 2
    (a, sa), (b, sb) = (
        check.reference_step(ref, _map(lambda x: x[sl], c),
                             t[sl] if torch.is_tensor(t) else t, base_vel[sl])
        for sl in (slice(None, h), slice(h, None)))
    cat = lambda x, y: torch.cat([x, y])  # noqa: E731
    return _map(cat, a, b), {"max_violation": cat(sa["max_violation"],
                                                  sb["max_violation"])}


def late_max(rows, limits):
    """The highest tick at and before which ``halves`` reads at most
    ``HONEST_SHARE`` of every limit (None where the first tick does not)."""
    best = None
    for row in rows:
        if row["k"] != (-1 if best is None else best) + 1 or any(
                row["halves"][n] > HONEST_SHARE * lim
                for n, lim in limits.items()):
            break
        best = row["k"]
    return best


def bands(rows):
    """The largest of each number of each kind by band of ``BAND`` ticks."""
    out = {}
    for row in rows:
        lo = row["k"] // BAND * BAND
        band = out.setdefault(f"{lo}-{lo + BAND - 1}", {})
        for kind in ("program", "halves", "control"):
            if kind not in row:
                continue
            b = band.setdefault(kind, dict.fromkeys(check.NAMES, 0.0))
            for n in check.NAMES:
                b[n] = max(b[n], row[kind][n])
        band["violation"] = max(band.get("violation", 0.0),
                                row["violation"])
    return out


def scan(workload, seed, seconds, device, batch, to=None, control_every=1):
    """The per-tick scan of one window of the program on ``seed``: every
    tick up to ``to`` (all where None), the control on every
    ``control_every``-th."""
    c = cell.Cell(workload)
    dev = torch.device(device)
    t_start = time.perf_counter()
    p = harness.prepare(c, seed, dev, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    w = harness.window(p.step, p.carry, p.inputs, p.dt, p.k0, seconds,
                       None if to is None else set(range(to + 1)),
                       ticks=0 if to is None else to + 1)
    base_vel = p.inputs.base_vel
    del p
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = build.build_mpc(build.reference(), c.config, dev)
    limits = c.settings["check"]["limits"]
    records, rows = w.pop("records"), []
    while records:
        k, carry, t, out, stats = records.pop(0)
        ra, sa = check.reference_step(ref, carry, t, base_vel)
        row = {"k": k, "violation": w["tick_violation"][k],
               "program": check.gaps(out, stats, ra, sa),
               "halves": check.gaps(*halves_step(ref, carry, t, base_vel),
                                    ra, sa)}
        if k % control_every == 0:
            row["control"] = check.gaps(*check.reference_step(
                ref, carry, t, base_vel, allow_tf32=True), ra, sa)
        del carry, out, stats, ra, sa
        rows.append(row)
        print(json.dumps(dict(kind="scan", seed=seed, **row)), flush=True)
    over = [r["k"] for r in rows
            if any(r["program"][n] > lim for n, lim in limits.items())]
    fault = [r["k"] for r in rows if r["k"] in over and all(
        r["halves"][n] <= HONEST_SHARE * lim for n, lim in limits.items())]
    print(json.dumps({"kind": "scan_summary", "seed": seed,
                      "ticks": len(w["tick_s"]), "scanned": len(rows),
                      "window_s": w["window_s"],
                      "late": c.settings["check"]["late"],
                      "late_max": late_max(rows, limits),
                      "program_over_limit": over,
                      "program_over_with_halves_5x_under": fault,
                      "bands": bands(rows),
                      "s": time.perf_counter() - t_start}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--faults", type=seeds, default=[])
    ap.add_argument("--scan", action="store_true",
                    help="per-tick scan of one window per --seeds seed")
    ap.add_argument("--scan-to", type=int, default=None,
                    help="scan the ticks up to this one (and the last)")
    ap.add_argument("--control-every", type=int, default=1,
                    help="run the scan's control on every n-th tick")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args()
    c = cell.Cell(args.workload)
    if args.scan:
        for s in args.seeds:
            scan(args.workload, s, args.seconds, args.device, args.batch,
                 args.scan_to, args.control_every)
        return
    ticks = c.settings["check"]["late"] + 1

    def one(kind, seed, **kw):
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, 0, t,
                             device=args.device, batch=args.batch,
                             ticks=ticks, **kw)
        print(json.dumps({"kind": kind, "seed": seed,
                          "ticks": r["attempted"] // (args.batch or
                                                      c.traffic["batch"]),
                          "correct": r["correct"],
                          "check": {k: v["value"] for k, v in
                                    r["check"].items()},
                          "check_ticks": r["check_ticks"],
                          "metrics": {k: v["value"] for k, v in
                                      r["metrics"].items()},
                          "mem": r["device"]["memory_peak_bytes"],
                          "s": time.perf_counter() - t}), flush=True)

    for s in args.seeds:
        one("program", s)
    for s in args.control_seeds:
        one("control", s, program=build.reference(allow_tf32=True))
    batch = args.batch or c.traffic["batch"]
    for s in args.faults:
        for name, fault in faults.FAULTS.items():
            if name == "half_batch" and batch < 2:
                continue
            with fault():
                one("fault:" + name, s)


if __name__ == "__main__":
    main()
