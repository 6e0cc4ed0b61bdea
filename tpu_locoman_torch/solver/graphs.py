"""A pure function of tensors replayed as one CUDA graph per input shape.

``Graphed(fn, name)`` is called as ``fn`` is, with tensors and
``NamedTuple``s of tensors (parameter sets). On the card, in plain eager
mode, the first call with a new key (each input's device, dtype and
shape, the TF32 switch and inference mode) runs ``fn`` eagerly. The second copies the inputs into contiguous static buffers,
runs ``fn`` on them on a side stream (the warm-up that capture needs,
whose result it returns) and captures ``fn`` on that stream. Every later
call copies its inputs into the static buffers, replays the graph on the
current stream and returns a clone of its output, so that no caller
holds a tensor that a later replay overwrites. Each call thus launches
the kernels once, as an eager call does, and a call of a few thousand
small kernels costs the host a few copies and one graph launch. Strides
are not part of the key: a carry's first tick and the later ones pass
some parameters in other layouts (a slice of the plan against a fresh
tensor), and the copy makes them one.

Everywhere else ``fn`` runs as it is: on the CPU, on a stream that is
already capturing, under any dispatch mode (``make_fx``'s fake and proxy
modes, so an export traces plain operations), under ``torch.compile``,
inside a ``torch.func`` transform, or where an input requires grad or is
not a tensor. Whether a call is replayed depends on nothing else.

``fn`` must be a pure function of its tensor arguments and of constants
that outlive it: no copy from or to the host, no synchronisation and no
branch on a tensor's value, since a replay repeats the captured kernels
on whatever the buffers hold.

A ``Graphed`` keeps its graphs while it lives, one per key it has seen
twice, and they share one memory pool. That is safe in any replay order:
a graph's intermediates are dead once it has run, and its output is
cloned before the next replay can write over it.

Counters (``trace.count``): ``graphs.<name>.captures`` and
``graphs.<name>.replays``. A capture launches nothing, so the kernel
launch counters it moved (``kernels.*.launches``) are taken back, and
every replay adds them again.
"""

from typing import NamedTuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from .. import trace


class _Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list  # the static input buffers, one per leaf
    output: torch.Tensor  # the static output
    launched: dict  # launch counter -> what one replay adds


_SEEN = object()  # a key called once: its next call captures


def _flatten(args):
    """The leaves of ``args`` in order."""
    leaves = []
    for a in args:
        leaves.extend(a if isinstance(a, tuple) else (a,))
    return leaves


def _unflatten(args, leaves):
    """``args`` with its leaves replaced by ``leaves``."""
    it = iter(leaves)
    return [a._make(next(it) for _ in a) if isinstance(a, tuple)
            else next(it) for a in args]


def plain_eager(leaves):
    """True where nothing traces, transforms or differentiates a call on
    ``leaves``: no dispatch mode, no ``torch.compile``, no ``torch.func``
    transform, and every leaf a plain tensor that does not require
    grad."""
    if (_get_current_dispatch_mode_stack() or torch.compiler.is_compiling()
            or torch._C._functorch.peek_interpreter_stack() is not None):
        return False
    return all(type(x) is torch.Tensor and not x.requires_grad
               and not torch._C._functorch.is_functorch_wrapped_tensor(x)
               for x in leaves)


def on_card(leaves):
    """True where every tensor of ``leaves`` is on the first one's CUDA
    device and that device's current stream is not capturing."""
    dev = leaves[0].device
    if dev.type != "cuda" or any(x.device != dev for x in leaves):
        return False
    with torch.cuda.device(dev):
        return not torch.cuda.is_current_stream_capturing()


def _key(leaves):
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.is_inference_mode_enabled(),
            tuple((x.device, x.dtype, tuple(x.shape)) for x in leaves))


class Graphed:
    """``fn`` replayed as one CUDA graph per key; see the module's
    docstring. ``path`` is ``"graph"`` after a call that replayed and
    ``"eager"`` after one that ran ``fn`` (the capturing call too)."""

    def __init__(self, fn, name):
        self.fn = fn
        self.captures = f"graphs.{name}.captures"
        self.replays = f"graphs.{name}.replays"
        self.path = "eager"
        self._entries = {}
        self._side = {}  # device -> (side stream, memory pool)

    def __call__(self, *args):
        leaves = _flatten(args)
        if not (plain_eager(leaves) and on_card(leaves)):
            self.path = "eager"
            return self.fn(*args)
        key = _key(leaves)
        entry = self._entries.get(key)
        if entry is None:
            self._entries[key] = _SEEN
            self.path = "eager"
            return self.fn(*args)
        if entry is _SEEN:
            static = [torch.empty_like(x, memory_format=torch.contiguous_format)
                      .copy_(x) for x in leaves]
            out, graph, output, launched = self._record(
                _unflatten(args, static), leaves[0].device)
            self._entries[key] = _Entry(graph, static, output, launched)
            trace.count(self.captures)
            self.path = "eager"
            return out
        for dst, src in zip(entry.inputs, leaves):
            dst.copy_(src)
        entry.graph.replay()
        out = entry.output.clone()
        trace.count(self.replays)
        for name, n in entry.launched.items():
            trace.count(name, n)
        self.path = "graph"
        return out

    def _record(self, static_args, dev):
        """``fn`` on ``static_args`` run on the side stream (the warm-up),
        then captured there: (the warm-up's result, which the call
        returns; the graph; its output; the launch counters that the
        capture moved, which it takes back)."""
        side = self._side.get(dev)
        if side is None:
            side = self._side[dev] = (torch.cuda.Stream(dev),
                                      torch.cuda.graph_pool_handle())
        stream, pool = side
        main = torch.cuda.current_stream(dev)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            out = self.fn(*static_args)
        main.wait_stream(stream)
        out.record_stream(main)
        graph = torch.cuda.CUDAGraph()
        before = trace.counters()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            output = self.fn(*static_args)
        launched = {}
        for name, n in trace.counters().items():
            if n != before.get(name, 0):
                launched[name] = n - before.get(name, 0)
                trace.count(name, -launched[name])
        return out, graph, output, launched
