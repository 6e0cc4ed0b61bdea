"""The port's tracer: named host spans at the layer boundaries of the tick,
held in memory, and the counters of the kernel launches.

Spans are off by default. ``span(name, **attrs)`` then returns one shared
no-op object: no clock read and no record. After ``enable()`` each span
appends a ``Span`` (name, id, parent id, tick id, start and end in ns,
attrs) to an in-memory list when it closes. The parent is the span open
around it (the program is single-threaded); the tick id is the id of the
enclosing ``mpc.step`` span, so every span of one tick shares it.

The clock is ``time.time_ns()``, the host clock that ``torch.profiler``
stamps its events with: a span at ``t0_ns`` lies at ``(t0_ns -
trace_start_ns) / 1000`` us on a profile's timeline, where
``trace_start_ns`` is ``prof.profiler.kineto_results.trace_start_ns()``.
So the spans need no ``record_function`` to meet the device trace: they
add no event to a profile, and cannot move what is read from one.

Attrs are Python ints and strings, from shapes and the configuration;
never a tensor value, whose read would synchronise with the device.

The counters (``count``, ``counter``) are always on: one dict add per
kernel launch. So are the tallies (``tally``, ``tallies``): device tensors
added into a per-name accumulator on their own device, never read back in
the tick (a few tiny kernels where a path calls them, nothing where it
does not); ``tallies()`` reads every accumulator back once, outside the
tick. Inside ``off()`` neither spans nor tallies record (an export's
trace).

    from tpu_locoman_torch import trace
    trace.enable()
    carry, stats = mpc.step(carry, t, target)
    trace.disable()
    for s in trace.spans():
        print(s.name, s.tick, (s.t1_ns - s.t0_ns) / 1e6, "ms", s.attrs)
    trace.export_chrome("spans.json")
"""

import contextlib
import functools
import json
import os
import time
from typing import NamedTuple

#: the root span of a tick
TICK = "mpc.step"


class Span(NamedTuple):
    name: str
    id: int
    parent: int  # None at the top
    tick: int  # id of the enclosing mpc.step span, None outside a tick
    t0_ns: int
    t1_ns: int
    attrs: dict


_on = False
_spans = []
_stack = []  # the open _Live spans, innermost last
_next_id = 0
_counters = {}
_tallies = {}  # (name, device) -> accumulator on that device
_tallying = True


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NOOP = _NoOp()


def _check_attrs(attrs):
    for k, v in attrs.items():
        if type(v) not in (int, str):
            raise TypeError(f"span attr {k}={v!r}: a span holds Python "
                            f"ints and strings only")


class _Live:
    __slots__ = ("name", "attrs", "id", "parent", "tick", "t0")

    def __init__(self, name, attrs):
        _check_attrs(attrs)
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _next_id
        self.id = _next_id
        _next_id += 1
        up = _stack[-1] if _stack else None
        self.parent = None if up is None else up.id
        if up is not None and up.tick is not None:
            self.tick = up.tick
        else:
            self.tick = self.id if self.name == TICK else None
        _stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if _stack and _stack[-1] is self:
            _stack.pop()
        _spans.append(Span(self.name, self.id, self.parent, self.tick,
                           self.t0, t1, self.attrs))
        return False

    def set(self, **attrs):
        """Attrs known only inside the span."""
        _check_attrs(attrs)
        self.attrs.update(attrs)


def span(name, **attrs):
    """A span named ``name`` around a ``with`` block; the shared no-op while
    tracing is off."""
    if not _on:
        return _NOOP
    return _Live(name, attrs)


def traced(name):
    """Decorator: the whole function in a span named ``name`` (decided at
    each call, so tracing may be turned on after the definition)."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Live(name, {}):
                return fn(*args, **kwargs)
        return inner
    return deco


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled():
    return _on


@contextlib.contextmanager
def off():
    """Spans and tallies off inside, whatever ``enable()`` said: an export
    traces the step with fake tensors, which neither records."""
    global _on, _tallying
    on, _on, _tallying = _on, False, False
    try:
        yield
    finally:
        _on, _tallying = on, True


def spans():
    """The closed spans, in the order they closed."""
    return list(_spans)


def reset():
    """Forget the recorded spans (the open ones still close normally)."""
    _spans.clear()


def chrome_events(base_ns=0, spans_=None):
    """Chrome-trace ``X`` events of the spans (all recorded by default),
    with ``ts`` in us after ``base_ns`` (a ``torch.profiler`` trace file
    states its base as ``baseTimeNanoseconds``), on a thread of their own
    named "program spans"."""
    pid = os.getpid()
    out = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "program spans"}}]
    for s in _spans if spans_ is None else spans_:
        args = dict(s.attrs, id=s.id, parent=s.parent, tick=s.tick)
        out.append({"name": s.name, "ph": "X", "cat": "program",
                    "pid": pid, "tid": 0, "ts": (s.t0_ns - base_ns) / 1e3,
                    "dur": (s.t1_ns - s.t0_ns) / 1e3, "args": args})
    return out


def export_chrome(path, base_ns=0):
    """Write the recorded spans to ``path`` as a Chrome trace."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": chrome_events(base_ns)}, f)


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

def count(name, n=1):
    _counters[name] = _counters.get(name, 0) + n


def counter(name):
    return _counters.get(name, 0)


def counters():
    return dict(_counters)


def reset_counters():
    _counters.clear()


# ---------------------------------------------------------------------------
# Tallies
# ---------------------------------------------------------------------------

def _add(a, b):
    """a + b; of two histograms of other lengths (closers of other pass
    counts in one process), the shorter is widened with zeros."""
    if a.shape == b.shape:
        return a + b
    out = a.new_zeros(max(a.shape[0], b.shape[0]))
    out[:a.shape[0]] += a
    out[:b.shape[0]] += b
    return out


def tally(name, t):
    """Add the tensor ``t`` (a count, or a histogram of counts) into the
    accumulator ``name`` on ``t``'s device, without reading it back."""
    if not _tallying:
        return
    key = (name, t.device)
    acc = _tallies.get(key)
    _tallies[key] = t.clone() if acc is None else _add(acc, t)


def tallies():
    """Every accumulator read back, summed over devices: name -> int, or a
    list of ints for a histogram. It waits for the device: call it outside
    the tick."""
    out = {}
    for (name, _), acc in _tallies.items():
        acc = acc.cpu()
        out[name] = acc if name not in out else _add(out[name], acc)
    return {name: acc.tolist() for name, acc in out.items()}


def reset_tallies():
    _tallies.clear()
