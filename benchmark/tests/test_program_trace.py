"""The reduction of the program's own spans (``program_trace.py``) on a
synthetic timeline, each of its five numbers; the existing ``bench/``
reduction blind to the program's tracer on a CPU profile of a Go2 tick;
and ``trace_program.py`` at a tiny batch on the CPU."""

import collections
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import build, program_trace, spans
from benchmark.cell import ROOT, Cell, load_json

trace = pytest.importorskip("tpu_locoman_torch.trace")

HOT = "benchmark/configs/b2g_rnea_hot.json"


def _tick(root, off):
    """The spans of one tick (ids from ``root``), ``off`` us after 0."""
    def s(i, name, parent, t0, t1, **attrs):
        return (name, root + i, None if parent is None else root + parent,
                root, off + t0, off + t1, attrs)

    return [s(0, "mpc.step", None, 0, 100, batch=2),
            s(1, "sqp.solve", 0, 5, 95, sqp_iters=1),
            s(2, "ocp.linearize", 1, 5, 30),
            s(3, "qp.admm_solve", 1, 30, 60),
            s(4, "qp.sweeps", 3, 40, 60, iters=10),
            s(5, "sqp.line_search", 1, 60, 75, trials=2, batch=2),
            s(6, "sqp.corrector", 1, 75, 90),
            s(7, "qp.sweeps", 6, 78, 88, iters=5),
            s(8, "mpc.shift", 0, 95, 100)]


def _timeline():
    """A warm-up tick, then two ticks of 100 us: (launched, device_ops,
    syncs, spans)."""
    sp = _tick(0, -300) + _tick(10, 0) + _tick(20, 100)
    launched, device_ops = [(-250, "warm", 5.0)], [("warm", -240, -235)]
    for off in (0, 100):
        launched += [(off + 10, "gemm", 4.0), (off + 45, "gemv", 2.0),
                     (off + 50, "gemv", 2.0), (off + 65, "elementwise", 3.0),
                     (off + 77, "add", 1.0), (off + 80, "gemv", 1.0),
                     (off + 32, "Memcpy HtoD (Pageable -> Device)", 0.5),
                     (off + 98, "copy", 1.0)]
        device_ops += [("gemm", off + 10, off + 20),
                       ("gemv", off + 45, off + 60)]
    # a sync in each tick's QP and one in the warm-up tick
    syncs = [33.0, 133.0, -250.0]
    return launched, device_ops, syncs, sp


def test_reduction_of_a_synthetic_timeline():
    s = program_trace.summarize(*_timeline(), ticks=2)
    rows = s["rows"]
    assert s["ticks"] == 2 and s["window_us"] == 200
    assert rows["mpc.step"]["calls"] == 2 and rows["qp.sweeps"]["calls"] == 4
    # under a span: its own operations and those of the spans inside it
    assert rows["sqp.solve"]["device_us"] == 2 * 13.5
    assert rows["mpc.step"]["device_us"] == 2 * 14.5
    assert rows["qp.admm_solve"]["device_us"] == 2 * 4.5
    assert rows["qp.admm_solve"]["self_device_us"] == 2 * 0.5
    assert rows["qp.admm_solve"]["h2d"] == 2
    assert rows["qp.admm_solve"]["syncs"] == 2 and s["syncs"] == 2
    # each idle gap goes to the innermost span at its middle: 0-10
    # (linearize), 20-45 and 120-145 (admm_solve), 60-110 (the corrector's
    # sweeps at 85) and 160-200 (at 180)
    idle = {k: r["idle_us"] for k, r in rows.items() if r["idle_us"]}
    assert idle == {"ocp.linearize": 10.0, "qp.admm_solve": 50.0,
                    "qp.sweeps": 90.0}
    assert s["sweep_iters"] == 30
    text = program_trace.table(s)
    assert text.splitlines()[1].startswith("mpc.step")


def test_the_five_numbers():
    s = program_trace.summarize(*_timeline(), ticks=2)
    first = [trace.Span("kernels.load", 1, 0, 0, 10, 20, {"built": 1}),
             trace.Span("mpc.step", 0, None, 0, 0, 2_500_000_000, {}),
             trace.Span("mpc.step", 5, None, 5, 3e9, 3.1e9, {})]
    m = program_trace.metrics(s, first)
    assert m["sqp.line_search.device_ms.hot"] == pytest.approx(0.003)
    assert m["sqp.corrector.device_ms.hot"] == pytest.approx(0.002)
    assert m["qp.sweep_us.hot"] == pytest.approx(10.0 / 30)
    assert m["host.syncs_per_tick.hot"] == 1.0
    assert m["setup.first_step_s.hot"] == pytest.approx(2.5)
    assert program_trace.first_step_s(first) == (pytest.approx(2.5), True)


def test_nothing_to_read_gives_no_number():
    launched, device_ops, syncs, sp = _timeline()
    assert program_trace.summarize(launched, device_ops, syncs, sp, 4) is None
    assert program_trace.metrics(None, ()) == {}
    s = program_trace.summarize([], [], [], sp, 2)
    assert program_trace.metrics(s) == {"host.syncs_per_tick.hot": 0.0}


def _go2_mpc():
    cfg = dict(load_json(os.path.join(ROOT, HOT)),
               robot={"class": "Go2", "kwargs": {}}, nodes=3)
    return build.build_mpc(build.program(), cfg, torch.device("cpu"))


def test_the_bench_reduction_is_blind_to_the_tracer():
    """The same profile events, by name and count, and the same summary
    shapes with the program's tracer on and off; on, the program's
    reduction finds the tick."""
    from torch.profiler import ProfilerActivity, profile

    mpc = _go2_mpc()
    vel = torch.tensor([[0.2, 0, 0, 0, 0, 0]] * 2)
    carry, _ = mpc.step(mpc.init_carry(2), 0.0, vel)
    seen = {}
    for on in (False, True):
        (trace.enable if on else trace.disable)()
        trace.reset()
        with spans.installed():
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with torch.profiler.record_function(spans.TICK):
                    mpc.step(carry, 0.01, vel)
        trace.disable()
        s = spans.summarize_profile(prof, 1)
        seen[on] = (collections.Counter(e.name for e in prof.events()),
                    s["device_ops"], s["factorize"], s["derivs"],
                    sorted(s["device_us"]))
        if on:
            prog = program_trace.from_profile(prof, trace.spans(), 1)
    assert seen[False] == seen[True]
    assert prog["rows"]["mpc.step"]["calls"] == 1
    assert prog["sweep_iters"] == 15  # 10 sweeps and 5 of the corrector
    trace.reset()


def test_trace_program_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "benchmark/trace_program.py", "--workload",
         "hot_b512", "--seed", str(2 ** 31 + 11), "--device", "cpu",
         "--batch", "1", "--pairs", "2", "--block", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["pairs"] == 2 and len(r["block_medians_on_off"]) == 2
    assert set(r["tick_s_quartiles"]) == {"on", "off"}


def test_trace_program_traced_mode_runs_on_the_cpu():
    """The default mode at batch 1: the cell's traced ticks through
    ``harness.window`` under the profiler, both reductions read."""
    out = subprocess.run(
        [sys.executable, "benchmark/trace_program.py", "--workload",
         "hot_b512", "--seed", str(2 ** 31 + 11), "--device", "cpu",
         "--batch", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["ticks"] == Cell("hot_b512").settings["trace_ticks"]
    assert set(r["same_layer_device_ms"]) == {"sqp.solve", "ocp.linearize",
                                              "qp.admm_solve"}
    assert r["spans_per_tick"] > 0
    assert "host.syncs_per_tick.hot" in r["metrics"]
