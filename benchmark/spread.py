"""Spread of a cell's repeated runs, as the bounds are set from it:

    python3 benchmark/spread.py RUNS.jsonl

RUNS.jsonl holds one result line per run, each with ``set`` (runs of one
set share no seed with each other; the two sets use the same seeds) and
``trace``. For each end-to-end metric and set: the median and the spread,
the distance between the first and third quartile of
``statistics.quantiles(values, n=4)`` over the median; the setup of each
set's first run apart."""

import json
import statistics
import sys


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(path):
    runs = [json.loads(line) for line in open(path) if line.strip()]
    for r in runs:
        m = {k: round(v["value"], 4) for k, v in r.get("metrics", {}).items()}
        print(r["set"], r["seed"], r["trace"], "rc", r["rc"], "correct",
              r.get("correct"), "wall %.0f" % r["wall"], m,
              {k: "%.3g/%.3g" % (v["value"], v["limit"])
               for k, v in r.get("check", {}).items()},
              "mem", r.get("device", {}).get("memory_peak_bytes"))
    for s in sorted({r["set"] for r in runs if not r["trace"]}):
        rs = [r for r in runs if r["set"] == s and not r["trace"]
              and r["rc"] == 0]
        for k in rs[0]["metrics"]:
            vals = [r["metrics"][k]["value"] for r in rs]
            skip = vals[1:] if k == "setup_s" else vals
            print(f"set {s} {k}: median {statistics.median(skip):.6g} "
                  f"spread {spread(skip):.4%} over {len(skip)} runs"
                  + (f" (first run {vals[0]:.2f}, not counted)"
                     if k == "setup_s" else ""))


if __name__ == "__main__":
    main(sys.argv[1])
