"""Readings that the check's limits are set from, for one cell, in one
process on the card:

    python3 benchmark/calibrate.py --workload hot_b512 --seconds 8 \\
        --seeds 11,12,13 --control-seeds 21,22,23 [--faults 31,32,33]

prints one JSON line per run: the program (``program``), the control (the
plain reference with TF32 products put in the program's place,
``control``) and each fault of ``faults.py`` (``fault:<name>``), each
with the check's numbers. The benchmark's own runs never run these."""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import cell  # noqa: E402

cell.use_checkout_caches()

from benchmark import build, faults, harness  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--faults", type=seeds, default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args()

    def one(kind, seed, **kw):
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, 0, t,
                             device=args.device, batch=args.batch, **kw)
        print(json.dumps({"kind": kind, "seed": seed,
                          "ticks": r["attempted"], "correct": r["correct"],
                          "check": {k: v["value"] for k, v in
                                    r["check"].items()},
                          "metrics": {k: v["value"] for k, v in
                                      r["metrics"].items()},
                          "mem": r["device"]["memory_peak_bytes"],
                          "s": time.perf_counter() - t}), flush=True)

    for s in args.seeds:
        one("program", s)
    for s in args.control_seeds:
        one("control", s, program=build.reference(allow_tf32=True))
    batch = args.batch or cell.Cell(args.workload).traffic["batch"]
    for s in args.faults:
        for name, fault in faults.FAULTS.items():
            if name == "half_batch" and batch < 2:
                continue
            with fault():
                one("fault:" + name, s)


if __name__ == "__main__":
    main()
