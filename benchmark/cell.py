"""What a run needs to know about one cell, found by its name: the entry of
``BENCHMARK.json``, the configuration file, the traffic mix
(``traffic/<traffic>.json``), the cell's own settings
(``workloads/<cell>.json``: the check's sample and limits, the ticks
that the violation covers, the traced ticks) and a reader per metric
(``metrics/<metric>.py``)."""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def use_checkout_caches():
    """Point the kernel caches that torch may fill at fixed directories
    inside the checkout (set before torch is imported). The program's own
    nvcc build stays in ``tpu_locoman_torch/_build``."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    def __init__(self, name, root=ROOT):
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                             f"{sorted(cells)}")
        entry = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
        self.name = name
        self.chips = entry["chips"]
        self.config = load_json(os.path.join(root, conf["file"]))
        self.traffic = load_json(os.path.join(HERE, "traffic",
                                              entry["traffic"] + ".json"))
        self.settings = load_json(os.path.join(HERE, "workloads",
                                               name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moves)]


def metric_module(metric_name):
    """The module ``metrics/<metric_name>.py``."""
    path = os.path.join(HERE, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name):
    """``read(run)`` of ``metrics/<metric_name>.py``: the metric's value from
    a finished run, or None where the run holds nothing to read."""
    return metric_module(metric_name).read


def window_reads(metrics):
    """The reads that the traced window takes at ``quality_ticks``, by
    metric name: each metric module's ``window_read()``, called before the
    window, returns the read (a module without one takes none)."""
    reads = {}
    for m in metrics:
        start = getattr(metric_module(m["name"]), "window_read", None)
        if start is not None:
            reads[m["name"]] = start()
    return reads
