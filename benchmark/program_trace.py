"""The program's own spans (``tpu_locoman_torch.trace``) read against the
device trace of a traced run, and the per-layer numbers they give.

A span of the program lies on the profiler's timeline at ``(t_ns -
trace_start_ns) / 1000`` us (both are the host's ``time.time_ns`` clock),
so no ``record_function`` is needed and the ``bench/`` spans' reduction
(``spans.py``) cannot see them. Over the last ``ticks`` ``mpc.step``
spans of a profile:

- each device operation is charged to the innermost program span that
  holds the start of the CPU operation that launched it (the profiler's
  ``e.kernels``): its own ("self") time there, and its time "under" that
  span and every span around it;
- each synchronising runtime call (``SYNC_CALLS``) inside a tick is
  counted at the innermost span that made it, and so is each host-to-device
  copy;
- each gap in which the device ran nothing goes to the innermost program
  span the host was in at the gap's middle (``OUTSIDE`` between the
  ticks' spans).

``first_step_s`` reads the spans alone: the host seconds of the process's
first tick.

``metrics`` gives the five per-layer numbers that this reduction is for;
``table`` prints its rows, one per span name."""

import statistics

TICK = "mpc.step"
#: name of the gaps and operations outside every span of the traced ticks
OUTSIDE = "(outside)"
#: runtime calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
#: span names not started by the program
BENCH_PREFIX = "bench/"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Tree:
    """The spans of the traced ticks, and the innermost one at a time."""

    def __init__(self, spans):
        self.spans = spans
        self.by_id = {s[1]: s for s in spans}
        depth = {}
        for s in sorted(spans, key=lambda s: s[1]):
            depth[s[1]] = 0 if s[2] not in depth else depth[s[2]] + 1
        self.depth = depth
        self.order = sorted(spans, key=lambda s: s[4])

    def innermost(self, t):
        best = None
        for s in self.order:
            if s[4] > t:
                break
            if s[5] >= t and (best is None or (s[4], self.depth[s[1]]) >= (
                    best[4], self.depth[best[1]])):
                best = s
        return best

    def chain(self, s):
        """``s`` and every span around it."""
        while s is not None:
            yield s
            s = self.by_id.get(s[2])


def summarize(launched, device_ops, syncs, spans, ticks):
    """Per span name, over the last ``ticks`` ticks of ``spans``.

    ``launched``: (host_us, name, device_us) of each device operation, at
    the start of the CPU operation that launched it. ``device_ops``: (name,
    start_us, end_us) of each device operation on the device.
    ``syncs``: host_us of each synchronising runtime call. ``spans``: the
    program's spans as (name, id, parent, tick, t0_us, t1_us, attrs).
    Returns None where the spans hold fewer than ``ticks`` ticks."""
    roots = sorted((s for s in spans if s[0] == TICK), key=lambda s: s[4])
    roots = roots[-ticks:]
    if ticks < 1 or len(roots) < ticks:
        return None
    ids = {r[1] for r in roots}
    tree = _Tree([s for s in spans if s[3] in ids])
    rows = {}

    def row(name):
        if name not in rows:
            rows[name] = {"calls": 0, "host_us": 0.0, "self_host_us": 0.0,
                          "device_us": 0.0, "self_device_us": 0.0,
                          "syncs": 0, "h2d": 0, "idle_us": 0.0}
        return rows[name]

    for s in tree.spans:
        r = row(s[0])
        r["calls"] += 1
        r["host_us"] += s[5] - s[4]
        r["self_host_us"] += s[5] - s[4]
        if s[2] in tree.by_id:
            row(tree.by_id[s[2]][0])["self_host_us"] -= s[5] - s[4]
    t0, t1 = roots[0][4], roots[-1][5]
    for host_us, name, us in launched:
        if not t0 <= host_us <= t1:
            continue
        s = tree.innermost(host_us)
        if s is None:
            row(OUTSIDE)["self_device_us"] += us
            continue
        row(s[0])["self_device_us"] += us
        if "HtoD" in name:
            row(s[0])["h2d"] += 1
        for up in tree.chain(s):
            rows[up[0]]["device_us"] += us
    n_syncs = 0
    for host_us in syncs:
        s = tree.innermost(host_us)
        if s is not None:
            row(s[0])["syncs"] += 1
            n_syncs += 1
    busy = _union((max(s, t0), min(e, t1)) for _, s, e in device_ops
                  if s < t1 and e > t0)
    prev = t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            host = tree.innermost(0.5 * (prev + s))
            row(OUTSIDE if host is None else host[0])["idle_us"] += s - prev
        prev = max(prev, e)
    sweeps = sum(s[6].get("iters", 0) for s in tree.spans
                 if s[0] == "qp.sweeps")
    return {"ticks": ticks, "window_us": t1 - t0, "rows": rows,
            "syncs": n_syncs, "sweep_iters": sweeps}


def program_spans(spans, start_ns):
    """``trace.Span`` records as ``summarize`` takes them, in us on the
    timeline of a profile that started at ``start_ns``."""
    return [(s.name, s.id, s.parent, s.tick, (s.t0_ns - start_ns) / 1e3,
             (s.t1_ns - start_ns) / 1e3, s.attrs) for s in spans]


def from_profile(prof, spans, ticks):
    """``summarize`` over a finished ``torch.profiler.profile`` and the
    program's ``trace.spans()``: the ticks are the last ``ticks`` whose
    spans lie inside the profile."""
    from torch.autograd import DeviceType

    start_ns = prof.profiler.kineto_results.trace_start_ns()
    launched, device_ops, syncs, end = [], [], [], 0.0
    for e in prof.events():
        end = max(end, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not (e.name.startswith(BENCH_PREFIX)
                    or e.is_user_annotation):
                device_ops.append((e.name, e.time_range.start,
                                   e.time_range.end))
            continue
        if e.name in SYNC_CALLS:
            syncs.append(e.time_range.start)
        for k in e.kernels:
            if not k.name.startswith(BENCH_PREFIX):
                launched.append((e.time_range.start, k.name, k.duration))
    inside = [s for s in program_spans(spans, start_ns)
              if s[4] >= 0 and s[5] <= end]
    return summarize(launched, device_ops, syncs, inside, ticks)


def first_step_s(spans):
    """Host seconds of the first ``mpc.step`` span recorded, with whether
    a kernel build ran inside it; None without one."""
    steps = [s for s in spans if s.name == TICK]
    if not steps:
        return None
    first = min(steps, key=lambda s: s.id)
    built = any(s.name == "kernels.load" and s.tick == first.id
                and s.attrs.get("built") for s in spans)
    return (first.t1_ns - first.t0_ns) * 1e-9, built


def metrics(summary, spans=()):
    """The five per-layer numbers; a number the run holds nothing for is
    left out."""
    out = {}
    first = first_step_s(spans)
    if first is not None:
        out["setup.first_step_s.hot"] = first[0]
    if summary is None:
        return out
    rows, n = summary["rows"], summary["ticks"]
    for name, key in (("sqp.line_search", "sqp.line_search.device_ms.hot"),
                      ("sqp.corrector", "sqp.corrector.device_ms.hot")):
        if rows.get(name, {}).get("device_us", 0) > 0:
            out[key] = rows[name]["device_us"] / 1e3 / n
    sweeps = rows.get("qp.sweeps", {}).get("device_us", 0)
    if sweeps > 0 and summary["sweep_iters"] > 0:
        out["qp.sweep_us.hot"] = sweeps / summary["sweep_iters"]
    out["host.syncs_per_tick.hot"] = summary["syncs"] / n
    return out


def table(summary):
    """The rows per tick, as text: host and device ms under the span and
    its own (outside the spans inside it), and the synchronisations,
    host-to-device copies and idle ms charged to the span itself."""
    n = summary["ticks"]
    cols = ("calls", "host_us", "self_host_us", "device_us",
            "self_device_us", "syncs", "h2d", "idle_us")
    lines = ["span               calls   host ms  (self)  device ms  (self) "
             f"  syncs    h2d   idle ms   (per tick, {n} ticks)"]
    rows = summary["rows"]
    for name in sorted(rows, key=lambda k: -rows[k]["host_us"]):
        v = [rows[name][c] / n / (1e3 if c.endswith("_us") else 1)
             for c in cols]
        lines.append(f"{name:<18} {v[0]:>5.1f} {v[1]:>9.2f} {v[2]:>7.2f} "
                     f"{v[3]:>10.3f} {v[4]:>7.3f} {v[5]:>7.1f} {v[6]:>6.1f} "
                     f"{v[7]:>9.2f}")
    return "\n".join(lines)


def quartiles(values):
    """(first quartile, median, third quartile), as ``spread.py`` takes
    them."""
    q = statistics.quantiles(values, n=4)
    return q[0], statistics.median(values), q[2]
