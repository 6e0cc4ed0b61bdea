"""The port's tracer (``tpu_locoman_torch/trace.py``) on the CPU: off it
records nothing, on it nests spans under their parent and their tick, its
attrs are ints and strings, its clock is the profiler's, and one Go2 N=3
tick records every span of the tick in its place."""

import json
import os
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import trace  # noqa: E402


@pytest.fixture
def tracer():
    """Tracing on, with nothing recorded; off and empty afterwards."""
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


def test_off_records_nothing_and_returns_the_shared_noop():
    trace.disable()
    trace.reset()
    a = trace.span("x", n=1)
    b = trace.span("y")
    assert a is b
    with a as s:
        s.set(n=2)

    @trace.traced("f")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert trace.spans() == []


def test_nesting_parents_and_the_tick_id(tracer):
    with trace.span("outside"):
        pass
    for _ in range(2):
        with trace.span(trace.TICK, batch=4):
            with trace.span("a"):
                with trace.span("b", k=3):
                    pass
            with trace.span("c"):
                pass
    by = {}
    for s in trace.spans():
        by.setdefault(s.name, []).append(s)
    assert by["outside"][0].parent is None and by["outside"][0].tick is None
    for i in range(2):
        root, a, b, c = (by[n][i] for n in (trace.TICK, "a", "b", "c"))
        assert root.parent is None and root.tick == root.id
        assert a.parent == root.id and c.parent == root.id
        assert b.parent == a.id and b.attrs == {"k": 3}
        assert a.tick == b.tick == c.tick == root.id
        assert root.t0_ns <= a.t0_ns <= b.t0_ns <= b.t1_ns <= a.t1_ns
        assert a.t1_ns <= c.t0_ns <= c.t1_ns <= root.t1_ns
    assert by[trace.TICK][0].id != by[trace.TICK][1].id


def test_a_span_closes_on_an_exception(tracer):
    with pytest.raises(ValueError):
        with trace.span("fails"):
            raise ValueError
    with trace.span("next"):
        pass
    fails, nxt = trace.spans()
    assert fails.name == "fails" and nxt.parent is None


@pytest.mark.parametrize("value", [1.5, True, torch.tensor(1), None])
def test_attrs_hold_only_ints_and_strings(tracer, value):
    with pytest.raises(TypeError):
        trace.span("x", v=value)
    with trace.span("y", n=1, s="a") as sp:
        with pytest.raises(TypeError):
            sp.set(v=value)
    assert trace.spans()[0].attrs == {"n": 1, "s": "a"}


def test_counters():
    trace.reset_counters()
    trace.count("a")
    trace.count("a", 2)
    assert trace.counter("a") == 3 and trace.counter("b") == 0
    assert trace.counters() == {"a": 3}
    trace.reset_counters()
    assert trace.counters() == {}


def test_spans_are_on_the_profilers_clock(tracer):
    """A span around an aten op contains that op on the profile's
    timeline: span times less ``trace_start_ns``, in us."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("mm"):
                x @ x
            time.sleep(0.002)
    start = prof.profiler.kineto_results.trace_start_ns()
    spans = [((s.t0_ns - start) / 1e3, (s.t1_ns - start) / 1e3)
             for s in trace.spans()]
    ops = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.name == "aten::mm")
    assert len(ops) == len(spans) == 3
    for (s0, s1), (o0, o1) in zip(spans, ops):
        assert s0 <= o0 <= o1 <= s1


def _go2(**sqp):
    robot = T.Go2()
    robot.set_gait_sequence("trot", 0.5)
    cfg = T.SQPConfig(sqp_iters=1, admm=T.ADMMConfig(iters=10), **sqp)
    return T.MPC(robot, nodes=3, config=cfg, device="cpu")


#: span -> its parent in the tick of ``_go2(corrector_iters=5,
#: eq_projection=1)`` (whole_body_rnea, the kernels' plain versions)
NESTING = {
    "mpc.prepare": "mpc.step", "sqp.solve": "mpc.step",
    "mpc.shift": "mpc.step", "ocp.linearize": "sqp.solve",
    "rnea_derivs": "ocp.linearize", "qp.admm_solve": "sqp.solve",
    "qp.assemble": "qp.admm_solve", "qp.factorize": "qp.admm_solve",
    "qp.sweeps": "qp.admm_solve", "sqp.line_search": "sqp.solve",
    "sqp.corrector": "sqp.solve", "sqp.eq_projection": "sqp.solve",
    "sqp.eq_projection.pass": "sqp.eq_projection",
    "qp.eq_project": "sqp.eq_projection.pass"}
#: the second parent of a span that the tick opens twice
ALSO = {"ocp.linearize": {"sqp.eq_projection.pass"},
        "qp.factorize": {"qp.eq_project"}, "qp.sweeps": {"sqp.corrector"}}


def test_one_tick_records_every_span_in_its_place(tracer):
    mpc = _go2(corrector_iters=5, eq_projection=1)
    carry = mpc.init_carry(2)
    trace.reset()
    mpc.step(carry, 0.0, torch.tensor([[0.2, 0, 0, 0, 0, 0]] * 2))
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    root = [s for s in spans if s.name == "mpc.step"]
    assert len(root) == 1 and root[0].attrs == {"batch": 2}
    assert {s.tick for s in spans} == {root[0].id}
    names = [s.name for s in spans]
    assert set(names) == set(NESTING) | {"mpc.step"}
    for s in spans:
        if s.name != "mpc.step":
            allowed = {NESTING[s.name]} | ALSO.get(s.name, set())
            assert by_id[s.parent].name in allowed, s
    # the eq projection re-linearizes and factorizes; the corrector sweeps
    for name in ALSO:
        assert names.count(name) == 2
    sweeps = [s for s in spans if s.name == "qp.sweeps"]
    cfg = mpc.solver.cfg
    assert sum(s.attrs["iters"] for s in sweeps) == (
        cfg.admm.iters + cfg.corrector_iters)
    fac = [s.attrs for s in spans if s.name == "qp.factorize"]
    assert fac[0] == {"factorizer": cfg.admm.factorizer, "Bs": 2, "K": 4,
                      "s": mpc.trans.s}
    # on the CPU the residuals are evaluated eagerly, never replayed
    assert [s.attrs for s in spans if s.name == "sqp.line_search"] == [
        {"trials": cfg.n_trials, "batch": 2, "path": "eager"}]
    assert [s.attrs for s in spans if s.name == "sqp.corrector"] == [
        {"path": "eager"}]
    assert [s.attrs for s in spans if s.name == "sqp.eq_projection"] == [
        {"passes": 1}]
    assert [s.attrs for s in spans if s.name == "sqp.eq_projection.pass"] == [
        {"k": 0, "path": "eager"}]
    for s in spans:
        assert all(type(v) in (int, str) for v in s.attrs.values())


def test_export_chrome(tracer, tmp_path):
    with trace.span(trace.TICK, batch=1):
        pass
    s = trace.spans()[0]
    path = tmp_path / "spans.json"
    trace.export_chrome(str(path), base_ns=s.t0_ns)
    ev = [e for e in json.load(open(path))["traceEvents"] if e["ph"] == "X"]
    assert ev == [{"name": "mpc.step", "ph": "X", "cat": "program",
                   "pid": os.getpid(), "tid": 0, "ts": 0.0,
                   "dur": (s.t1_ns - s.t0_ns) / 1e3,
                   "args": {"batch": 1, "id": s.id, "parent": None,
                            "tick": s.id}}]
