"""The traced run: spans around the calls into each layer of the program,
put in from here (the program has none of its own yet), and the reduction
of the profiler's events, held in memory, to one summary that the
per-layer readers take.

Span names start with ``bench/``. The factorization and RNEA-derivative
spans carry the shapes of their call after a ``|``, so that the rooflines
count the work from the shapes whatever computes it."""

import contextlib
import functools

import torch

PREFIX = "bench/"
TICK = PREFIX + "tick"
SOLVE = PREFIX + "SQPSolver.solve"
LINEARIZE = PREFIX + "Transcription.linearize"
ADMM = PREFIX + "admm_solve"
EQ_PROJECT = PREFIX + "eq_project"
FACTORIZE = PREFIX + "qp._factorize_by_name"
DERIVS = PREFIX + "rnea_derivs.rnea_derivatives"


def _factor_shape(H, *args, **kwargs):
    return (H.shape[0], H.shape[1], H.shape[-1])


def _derivs_shape(model, q, v, a, ee_frames=(), forces_world=None):
    nf = 0 if forces_world is None or not ee_frames else forces_world.shape[-1]
    return (q.shape[0], q.shape[-1], v.shape[-1], nf)


def _wrap(fn, name, shape=None):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        label = name
        if shape is not None:
            label += "|" + ",".join(str(int(x)) for x in shape(*args, **kwargs))
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return inner


@contextlib.contextmanager
def installed():
    """The program with a span around each layer call, restored on exit."""
    from tpu_locoman_torch import rnea_derivs
    from tpu_locoman_torch.ocp import transcribe
    from tpu_locoman_torch.solver import qp, sqp

    sites = [(sqp.SQPSolver, "solve", SOLVE, None),
             (transcribe.Transcription, "linearize", LINEARIZE, None),
             (sqp, "admm_solve", ADMM, None),
             (sqp, "eq_project", EQ_PROJECT, None),
             (qp, "_factorize_by_name", FACTORIZE, _factor_shape),
             (rnea_derivs, "rnea_derivatives", DERIVS, _derivs_shape)]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _, _ in sites]
    for obj, attr, name, shape in sites:
        setattr(obj, attr, _wrap(getattr(obj, attr), name, shape))
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


# ---------------------------------------------------------------------------
# Reduction of the events to a summary
# ---------------------------------------------------------------------------

def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(device_ops, spans, kernels_under, ticks):
    """The summary of the last ``ticks`` tick spans.

    ``device_ops``: (name, start_us, end_us) of every device operation
    (kernel, memcpy, memset) the profiler saw. ``spans``: (name, start_us,
    end_us, key) of every ``bench/`` span on the host. ``kernels_under``:
    key -> device microseconds of the operations launched under that span
    instance. Times are on the profiler's one clock."""
    tick_spans = sorted(s for s in spans if s[0] == TICK)[-ticks:]
    t0, t1 = tick_spans[0][1], tick_spans[-1][2]
    ops = [(n, max(s, t0), min(e, t1)) for n, s, e in device_ops
           if s < t1 and e > t0]
    busy = _union((s, e) for _, s, e in ops if e > s)
    busy_us = sum(e - s for s, e in busy)
    inside = [s for s in spans if s[1] >= t0 and s[2] <= t1]

    by_name = {}
    for n, s, e in ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    gaps, prev = {}, t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            mid = 0.5 * (prev + s)
            host = [x for x in inside if x[1] <= mid <= x[2]]
            name = (min(host, key=lambda x: x[2] - x[1])[0] if host
                    else "between ticks")
            name = name.removeprefix(PREFIX).split("|")[0]
            gaps[name] = gaps.get(name, 0.0) + (s - prev)
        prev = max(prev, e)

    def device_us(prefix):
        return sum(kernels_under[k] for n, _, _, k in inside
                   if n.split("|")[0] == prefix)

    def calls(prefix):
        return [(tuple(int(x) for x in n.split("|")[1].split(",")),
                 kernels_under[k]) for n, _, _, k in inside
                if n.split("|")[0] == prefix]

    return {
        "ticks": ticks,
        "window_us": t1 - t0,
        "busy_us": busy_us,
        "device_ops": len(ops),
        "op_us": sum(e - s for _, s, e in ops),
        "device_us": {p[len(PREFIX):]: device_us(p) for p in (
            TICK, SOLVE, LINEARIZE, ADMM, EQ_PROJECT)},
        "factorize": calls(FACTORIZE),
        "derivs": calls(DERIVS),
        "top_ops": sorted(by_name.items(), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda x: -x[1])[:10],
    }


def summarize_profile(prof, ticks):
    """``summarize`` over a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.events()
    device_ops, spans, under = [], [], {}

    def own(e):
        return sum(k.duration for k in e.kernels
                   if not k.name.startswith(PREFIX))

    def total(e):
        key = id(e)
        if key not in under:
            under[key] = own(e) + sum(total(c) for c in e.cpu_children)
        return under[key]

    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(PREFIX) and not e.is_user_annotation:
                device_ops.append((e.name, e.time_range.start,
                                   e.time_range.end))
        elif e.name.startswith(PREFIX):
            spans.append((e.name, e.time_range.start, e.time_range.end, id(e)))
            total(e)
    return summarize(device_ops, spans, under, ticks)
