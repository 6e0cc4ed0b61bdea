"""The harness on the CPU at tiny sizes: files found by name, the metric
arithmetic, the trace reduction, the reference against the program's CPU
path, the roofline counts, the module check and the command's refusal
without a card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import build, check, harness, roofline, spans
from benchmark.cell import ROOT, Cell, load_json, reader

BENCH = load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
HOT = "benchmark/configs/b2g_rnea_hot.json"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = Cell(name)
    assert cell.config["name"] == next(
        w for w in BENCH["workloads"] if w["name"] == name)["config"]
    assert cell.traffic["batch"] >= 1
    assert set(cell.settings["check"]["limits"]) <= set(check.NAMES)
    assert cell.settings["quality_ticks"] >= 1
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    assert callable(reader(name))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_every_solver_setting(conf):
    import tpu_locoman_torch as T

    cfg = load_json(os.path.join(ROOT, conf["file"]))
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    assert set(cfg["sqp"]) == set(T.SQPConfig._fields) - {"admm"}
    assert set(cfg["admm"]) == set(T.ADMMConfig._fields)


def _run(tick_s, window_s, scen, tick_violation=(), trace=None):
    return harness.Run(setup_s=12.5, window_s=window_s, tick_s=tick_s,
                       tick_violation=list(tick_violation),
                       scenario_ticks=scen, settings={"quality_ticks": 60},
                       trace=trace)


def test_end_to_end_arithmetic():
    """The rate over the whole window and every tick, never a median of
    chunks: ticks of 0.1-1.0 s, 512 scenarios each, in a 60 s window; the
    violation over the first ``quality_ticks`` (60) ticks only."""
    ticks = list(np.linspace(0.1, 1.0, 100))
    viol = [0.2] * 60 + [0.5] * 40
    run = _run(ticks, window_s=60.0, scen=512 * 100, tick_violation=viol)
    assert reader("solves_per_s")(run) == pytest.approx(51200 / 60.0)
    assert reader("violation_mean")(run) == pytest.approx(0.2)
    assert reader("violation_mean")(_run(ticks[:30], 20.0, 512 * 30, viol[
        :30])) == pytest.approx(0.2)
    assert reader("setup_s")(run) == 12.5


def _timeline():
    """Two ticks of 100 us each (after a warm-up tick), device busy
    10-30 and 150-160 us; spans nested as the program calls them."""
    ops = [("warm", -50, -40), ("k1", 10, 30), ("bmm", 150, 160)]
    sp = [(spans.TICK, -100, 0, "t0"), (spans.TICK, 0, 100, "t1"),
          (spans.TICK, 100, 200, "t2"),
          (spans.SOLVE, 5, 95, "s"), (spans.LINEARIZE, 5, 40, "l"),
          (spans.ADMM, 40, 90, "a"), (spans.FACTORIZE + "|512,15,105", 45,
                                      60, "f"),
          (spans.DERIVS + "|7168,25,24,15", 10, 20, "d")]
    under = {"t0": 10.0, "t1": 20.0, "t2": 10.0, "s": 20.0, "l": 20.0,
             "a": 0.0, "f": 0.0, "d": 5.0}
    return ops, sp, under


def test_trace_summary_from_a_synthetic_timeline():
    s = spans.summarize(*_timeline(), ticks=2)
    assert s["window_us"] == 200 and s["busy_us"] == 30
    assert s["device_ops"] == 2
    run = _run([0.1], 1.0, 1, trace=s)
    assert reader("device.idle_pct.hot")(run) == pytest.approx(85.0)
    assert reader("host.launches_per_tick.hot")(run) == 1.0
    assert reader("linearize.device_ms.hot")(run) == pytest.approx(0.01)
    assert reader("qp.device_ms.hot")(run) is None  # nothing under the QP
    assert s["factorize"] == [((512, 15, 105), 0.0)]
    assert reader("kernels.factor_roofline_pct.hot")(run) is None
    assert s["derivs"] == [((7168, 25, 24, 15), 5.0)]
    least = roofline.derivs_bytes(7168, 25, 24, 15) / 3.35e12
    assert reader("kernels.derivs_roofline_pct.hot")(run) == pytest.approx(
        100 * least / 5e-6)
    # each idle gap named by the innermost span the host was in at its
    # middle: 0-10 (linearize), 30-150 (admm_solve at 90), 160-200 (tick)
    assert dict(s["idle_gaps"]) == {"Transcription.linearize": 10,
                                    "admm_solve": 120, "tick": 40}


def test_factor_work_is_the_same_for_every_factorizer():
    """The roofline's work comes from (Bs, K, s) alone: one tick of each
    factorizer factors the same shapes, so it is charged the same work."""
    from tpu_locoman_torch.solver import qp

    cfg = load_json(os.path.join(ROOT, HOT))
    shapes = {}
    for fac in ("cholinv_pb", "pallas"):
        seen = []
        orig = qp._factorize_by_name

        def spy(H, U, *a, **k):
            seen.append(spans._factor_shape(H, U))
            return orig(H, U, *a, **k)

        c = dict(cfg, robot={"class": "Go2", "kwargs": {}}, nodes=4,
                 admm=dict(cfg["admm"], factorizer=fac))
        mpc = build.build_mpc(build.program(), c, torch.device("cpu"))
        qp._factorize_by_name = spy
        try:
            mpc.step(mpc.init_carry(2), 0.0, torch.zeros(2, 6))
        finally:
            qp._factorize_by_name = orig
        shapes[fac] = seen
    assert shapes["cholinv_pb"] == shapes["pallas"] == [(2, 5, shapes[
        "pallas"][0][2])]
    w = [roofline.factor_work(*s) for s in shapes["pallas"]]
    assert w == [roofline.factor_work(*s) for s in shapes["cholinv_pb"]]
    # the count at the flagship's shape (chip_smoke's k3_work)
    nbytes, ops = roofline.factor_work(512, 15, 105)
    assert roofline.bound_s(nbytes, ops) == pytest.approx(0.5886e-3,
                                                          rel=1e-3)


#: accurate mode (SQPConfig.accurate() with K3's factorizer): the
#: equality projection and the whole-horizon factorization
ACCURATE = {"sqp": {"corrector_iters": 0, "eq_projection": 4, "n_trials": 8},
            "admm": {"factorizer": "pallas"}}


@pytest.mark.parametrize("mode", ["hot", "accurate"])
def test_reference_agrees_with_the_program_on_the_cpu(mode):
    """Go2 at N=4, batch 2: the program's CPU path (the kernels' plain
    versions) and the reference, one tick each from the program's carry."""
    cfg = dict(load_json(os.path.join(ROOT, HOT)),
               robot={"class": "Go2", "kwargs": {}}, nodes=4)
    if mode == "accurate":
        for key, changes in ACCURATE.items():
            cfg[key] = dict(cfg[key], **changes)
    dev = torch.device("cpu")
    mpc = build.build_mpc(build.program(), cfg, dev)
    ref = build.build_mpc(build.reference(), cfg, dev)
    vel = torch.tensor([[0.2, 0, 0, 0, 0, 0], [0.1, 0.05, 0, 0, 0, 0.1]])
    carry, records = mpc.init_carry(2), []
    for k in range(3):
        out, stats = mpc.step(carry, k * 0.01, vel)
        records.append((k, carry, k * 0.01, out, stats))
        carry = out
    worst = check.compare(records, ref, vel)
    assert max(worst.values()) <= 1e-6, worst


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert "tpu_locoman" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_locoman_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "tpu_locoman.solver", sys)
    assert harness.forbidden_modules() == ["jax", "tpu_locoman"]


def test_the_harness_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r); "
         "from benchmark import harness, build, calibrate; build.program(); "
         "build.reference(); print(harness.forbidden_modules())" % ROOT],
        capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
