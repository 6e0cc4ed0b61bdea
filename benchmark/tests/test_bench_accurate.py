"""The accurate cell (``accurate_b512``) on the CPU: its files load by
name, its configuration is ``SQPConfig.accurate()`` as a user gets it, and
its per-layer readers on a synthetic summary and on the program's tallies,
reading nothing where nothing was traced, and a closer with one pass fewer
comes out not correct."""

import os
import time

import pytest
import torch

from benchmark import build, harness, roofline, spans
from benchmark.cell import ROOT, Cell, load_json, metric_module, reader

ACCURATE = "benchmark/configs/b2g_rnea_accurate.json"
#: the hot cells' per-layer metrics, which read the accurate tick as well
HOT_LAYERS = ("device.idle_pct.hot", "host.launches_per_tick.hot",
              "sqp.self_device_ms.hot", "linearize.device_ms.hot",
              "qp.device_ms.hot", "kernels.factor_roofline_pct.hot",
              "kernels.derivs_roofline_pct.hot")


def test_the_cell_loads_by_name():
    cell = Cell("accurate_b512")
    assert cell.config["name"] == "b2g_rnea_accurate"
    assert cell.traffic == load_json(
        os.path.join(ROOT, "benchmark/traffic/fleet_b512.json"))
    assert cell.settings["trace_ticks"] == 3
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "solves_per_s"}
    assert {m["name"] for m in cell.per_layer} == set(HOT_LAYERS) | {
        "qp.eq_project.device_ms.accurate",
        "kernels.eq_factor_roofline_pct.accurate",
        "sqp.eq_projection.within_tol_pct.accurate"}


def test_the_configuration_is_the_accurate_preset():
    import tpu_locoman_torch as T

    cfg = load_json(os.path.join(ROOT, ACCURATE))
    hot = load_json(os.path.join(ROOT, "benchmark/configs/b2g_rnea_hot.json"))
    mpc = build.build_mpc(build.program(), cfg, torch.device("cpu"))
    assert mpc.solver.cfg == T.SQPConfig.accurate()
    assert "1e-3" in cfg["guarantee"] and cfg["reduced"] == []
    # robot, formulation, horizon, clock, gait and carry as the hot cells
    same = set(hot) - {"name", "source", "sqp", "admm", "assumed",
                       "guarantee"}
    assert {k: cfg[k] for k in same} == {k: hot[k] for k in same}


TOL = "sqp.eq_projection.within_tol_pct.accurate"


def _run(trace, tallies=None):
    return harness.Run(setup_s=20.0, window_s=50.0, tick_s=[0.5],
                       tick_violation=[2e-4], scenario_ticks=512,
                       settings={"quality_ticks": 60}, trace=trace,
                       snapshots=None if tallies is None else {TOL: tallies})


def _summary():
    """Two traced ticks of the accurate solver at batch 512, N=14: per
    tick one KKT factorization (15 nodes of 105), four constraint-space
    ones (14 nodes of 110) and five RNEA derivatives."""
    kkt, eq = (512, 15, 105), (512, 14, 110)
    return {"ticks": 2, "window_us": 1e6, "busy_us": 3e5, "device_ops": 100,
            "device_us": {"tick": 3e5, "SQPSolver.solve": 2.8e5,
                          "Transcription.linearize": 1.2e5,
                          "admm_solve": 4e4, "eq_project": 8e4},
            "factorize": [(kkt, 5000.0)] * 2 + [(eq, 2000.0)] * 8,
            "derivs": [((512 * 14, 25, 24, 15), 150.0)] * 10,
            "top_ops": [], "idle_gaps": []}


def test_the_span_readers_on_a_synthetic_summary():
    run = _run(_summary())
    assert reader("qp.eq_project.device_ms.accurate")(run) == 40.0
    assert reader("linearize.device_ms.hot")(run) == 60.0  # all five
    least = roofline.bound_s(*roofline.factor_work(512, 14, 110))
    assert reader("kernels.eq_factor_roofline_pct.accurate")(
        run) == pytest.approx(100 * 8 * least / (8 * 2000e-6))
    # no closer: no constraint-space factorization, nothing under eq_project
    hot = dict(_summary(), factorize=[((512, 15, 105), 5000.0)] * 2,
               device_us=dict(_summary()["device_us"], eq_project=0.0))
    assert reader("kernels.eq_factor_roofline_pct.accurate")(
        _run(hot)) is None
    assert reader("qp.eq_project.device_ms.accurate")(_run(hot)) is None
    for name in ("qp.eq_project.device_ms.accurate",
                 "kernels.eq_factor_roofline_pct.accurate",
                 "sqp.eq_projection.within_tol_pct.accurate"):
        assert reader(name)(_run(None)) is None, name
    # the hot cells' readers read the accurate tick too
    for name in HOT_LAYERS:
        assert reader(name)(run) is not None, name


def test_the_tally_reader():
    """The share over the tallies that the run carries (the program's,
    read at ``quality_ticks``), not over what the process holds when the
    reader runs."""
    from tpu_locoman_torch import trace

    read = reader("sqp.eq_projection.within_tol_pct.accurate")
    trace.reset_tallies()
    assert read(_run(_summary(), trace.tallies())) is None  # no closer ran
    trace.tally("sqp.eq_projection.kept_pass", torch.tensor([0, 0, 0, 12,
                                                             500]))
    trace.tally("sqp.eq_projection.within_tol", torch.tensor(500))
    trace.tally("sqp.eq_projection.kept_pass", torch.tensor([0, 0, 0, 100,
                                                             412]))
    trace.tally("sqp.eq_projection.within_tol", torch.tensor(512))
    snap = trace.tallies()
    assert read(_run(_summary(), snap)) == pytest.approx(100 * 1012 / 1024)
    trace.tally("sqp.eq_projection.kept_pass", torch.tensor([0, 0, 0, 0,
                                                             512]))
    trace.tally("sqp.eq_projection.within_tol", torch.tensor(0))
    assert read(_run(_summary(), snap)) == pytest.approx(100 * 1012 / 1024)
    assert read(_run(_summary())) is None  # no read was taken
    assert read(_run(None, snap)) is None
    # the read that the harness takes: on tallies reset before the window
    take = metric_module(TOL).window_read()
    assert take() == {}
    trace.tally("sqp.eq_projection.within_tol", torch.tensor(7))
    assert int(take()["sqp.eq_projection.within_tol"]) == 7
    trace.reset_tallies()


def test_the_bench_spans_see_the_closer():
    """One accurate Go2 N=4 tick under the bench/ spans: eq_project and
    its factorizations (one node fewer than the KKT's) are wrapped."""
    cfg = dict(load_json(os.path.join(ROOT, ACCURATE)),
               robot={"class": "Go2", "kwargs": {}}, nodes=4)
    mpc = build.build_mpc(build.program(), cfg, torch.device("cpu"))
    from torch.profiler import ProfilerActivity, profile

    with spans.installed(), profile(activities=[ProfilerActivity.CPU]) as p:
        mpc.step(mpc.init_carry(2), 0.0, torch.zeros(2, 6))
    names = [e.name for e in p.events() if e.name.startswith(spans.PREFIX)]
    assert names.count(spans.EQ_PROJECT) == 4
    fac = sorted({n.split("|")[1] for n in names
                  if n.startswith(spans.FACTORIZE)})
    assert fac == ["2,4,%d" % mpc.trans.m_dense, "2,5,%d" % mpc.trans.s]


def test_one_projection_pass_fewer_is_caught():
    """The program's closer with one pass fewer than the configuration
    states, at 2 scenarios on the CPU: its mean violation is ~4× the
    reference's from the same carry, and ``viol_gap`` refuses it."""
    from tpu_locoman_torch import trace

    pkg = build.program()

    def fewer(**kw):
        return pkg.SQPConfig(**dict(kw, eq_projection=kw["eq_projection"] - 1))

    trace.reset_tallies()
    r = harness.run_cell("accurate_b512", 2 ** 31 + 14, 0.5, 0,
                         time.perf_counter(), device="cpu", batch=2,
                         program=pkg._replace(SQPConfig=fewer))
    trace.reset_tallies()
    assert not r["correct"], r["check"]
    assert r["check"]["viol_gap"]["value"] > r["check"]["viol_gap"]["limit"]
