"""The check's sample and the tally read are fixed window ticks: the same
ticks for a fast program and a slow one. On the CPU, with a stand-in step
that costs nothing, so that windows run to several times a cell's late
tick."""

import time
from typing import NamedTuple

import pytest
import torch

from benchmark import check, harness, traffic
from benchmark.cell import ROOT, Cell, load_json

BENCH = load_json(ROOT + "/BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]

#: ``check.pick_ticks`` on each cell's stream, as drawn before the late
#: tick existed (seeds 245078559, 3190000303, 2**31 + 11)
DRAWS = {
    "hot_b512": [[15, 84, 102, 118], [18, 85, 99, 111], [21, 67, 73, 114]],
    "hot_b4096": [[3, 6], [9, 28], [10, 58]],
    "accurate_b512": [[5, 34], [33, 37], [7, 38]],
}
SEEDS = (245078559, 3190000303, 2 ** 31 + 11)


class _Carry(NamedTuple):
    x_init: torch.Tensor


def _step(carry, t, base_vel):
    """The next state is the tick count; every scenario within tolerance."""
    B = carry.x_init.shape[0]
    return _Carry(carry.x_init + 1), {"max_violation": torch.zeros(B),
                                      "status": torch.zeros(B)}


def _inputs(name, seed):
    """The seed's inputs at the cell's own batch: the draw follows them in
    the seed's stream."""
    return traffic.make(Cell(name).traffic, seed, "cpu")


def _window(name, seed, n, keep=(), snapshot=None, step=_step):
    """A window of exactly ``n`` ticks of the stand-in step."""
    late = Cell(name).settings["check"]["late"]
    inputs = _inputs(name, seed)
    return harness.window(step, _Carry(torch.zeros(2, 1)),
                          inputs, 0.01, 2, 0.0, set(keep),
                          late=late, ticks=n, snapshot=snapshot)


def _kept(w):
    return [r[0] for r in w["records"]]


@pytest.mark.parametrize("name", CELLS)
def test_late_record_is_a_fixed_window_tick(name):
    """Windows of ``late`` + 1, 2·``late`` and 3·``late`` ticks keep the
    same ticks, the late one among them; the late record is tick
    ``min(last, late)``, so a window of ``late`` ticks keeps its last."""
    ck = Cell(name).settings["check"]
    late = ck["late"]
    assert ck["horizon"] <= late
    keep = check.pick_ticks(_inputs(name, SEEDS[0]).rng, ck["horizon"],
                            ck["ticks"])
    kept = {}
    for n in (late, late + 1, 2 * late, 3 * late):
        w = _window(name, SEEDS[0], n, keep)
        assert len(w["tick_s"]) == n
        kept[n] = _kept(w)
        assert kept[n] == sorted({0, min(n - 1, late)} | keep)
        # the record holds what the program returned at that tick
        assert all(int(r[3].x_init[0, 0]) == r[0] + 1 for r in w["records"])
    assert kept[late + 1] == kept[2 * late] == kept[3 * late]
    assert kept[late][-1] == late - 1 and kept[2 * late][-1] == late


@pytest.mark.parametrize("n", [1, 2, 7])
@pytest.mark.parametrize("name", CELLS)
def test_a_window_shorter_than_late_keeps_its_last_tick(name, n):
    w = _window(name, SEEDS[1], n)
    assert _kept(w) == sorted({0, n - 1})


@pytest.mark.parametrize("name", CELLS)
def test_the_seeded_draw_is_unchanged(name):
    ck = Cell(name).settings["check"]
    for seed, draw in zip(SEEDS, DRAWS[name]):
        assert sorted(check.pick_ticks(_inputs(name, seed).rng,
                                       ck["horizon"], ck["ticks"])) == draw


class _Counted:
    """The stand-in step, counting its calls."""

    def __init__(self):
        self.n = 0

    def step(self, carry, t, base_vel):
        self.n += 1
        return _step(carry, t, base_vel)


@pytest.mark.parametrize("name", CELLS)
def test_the_tally_read_is_taken_at_quality_ticks(name):
    """The read comes between window ticks ``quality_ticks`` - 1 and
    ``quality_ticks``, however long the window; after the last tick where
    the window holds fewer."""
    q = Cell(name).settings["quality_ticks"]
    for n in (q // 2, q, 2 * q, 3 * q):
        c = _Counted()
        w = _window(name, SEEDS[2], n, snapshot=(q, lambda: c.n),
                    step=c.step)
        assert c.n == n and w["snapshot"] == min(n, q)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_run_cell_hands_the_window_the_sample_and_the_read(name, trace,
                                                           monkeypatch):
    """``run_cell`` gives the window the seed's draw, the cell's late tick
    and, traced, the reads of the cell's metrics at ``quality_ticks``: in
    ``accurate_b512`` the program's tallies, reset after the warm-up; in
    the hot cells, whose metrics take no such read, none."""
    from tpu_locoman_torch import trace as program_trace

    cell, seed = Cell(name), SEEDS[0]

    def prepare(cell_, seed_, dev, batch=None, program=None):
        assert (cell_.name, seed_) == (name, seed)
        program_trace.tally("sqp.eq_projection.within_tol", torch.tensor(3))
        inputs = traffic.make(cell.traffic, seed, dev)
        return harness.Prepared(_step, _Carry(torch.zeros(2, 1)), inputs,
                                0.01, 2, time.perf_counter(), [0.0, 0.0])

    seen = {}

    def window(step, carry, inputs, dt, k0, seconds, keep, *, late, prof,
               prof_ticks, ticks, snapshot):
        seen.update(keep=keep, late=late, snapshot=snapshot, ticks=ticks,
                    tallies=program_trace.tallies())
        raise _Stop

    monkeypatch.setattr(harness, "prepare", prepare)
    monkeypatch.setattr(harness, "window", window)
    with pytest.raises(_Stop):
        harness.run_cell(name, seed, 1.0, trace, time.perf_counter(),
                         device="cpu", ticks=5)
    program_trace.reset_tallies()
    ck = cell.settings["check"]
    assert sorted(seen["keep"]) == DRAWS[name][0]
    assert seen["late"] == ck["late"] and seen["ticks"] == 5
    if trace and name == "accurate_b512":
        q, read = seen["snapshot"]
        assert q == cell.settings["quality_ticks"]
        assert seen["tallies"] == {}
        program_trace.tally("sqp.eq_projection.within_tol", torch.tensor(5))
        got = read()
        program_trace.reset_tallies()
        assert list(got) == ["sqp.eq_projection.within_tol_pct.accurate"]
        assert int(got["sqp.eq_projection.within_tol_pct.accurate"][
            "sqp.eq_projection.within_tol"]) == 5
    else:
        assert seen["snapshot"] is None
