"""The check against planted faults and against the control.

On the CPU each cell's run is driven whole, past the look for a card, at
a small batch, with the program's timed path broken underneath
(``faults.py``): a step that returns its state unchanged, half the batch
left out, one scenario's answer altered where it is produced. Each run's
``correct`` has to come out false, and a run without a fault true. The
control (the plain reference in TF32 put in the program's place) needs
the card: TF32 exists only there."""

import time

import pytest

from benchmark import build, faults, harness
from benchmark.cell import ROOT, load_json

BENCH = load_json(ROOT + "/BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = 2  # scenarios per batch cell on the CPU


def _run(cell, seed, device="cpu", program=None, batch=None):
    if batch is None:
        batch = min(_batch(cell), SMALL)
    return harness.run_cell(cell, seed, 0.5, 0, time.perf_counter(),
                            device=device, batch=batch, program=program)


def _batch(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    return load_json(f"{ROOT}/benchmark/traffic/{w['traffic']}.json")["batch"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell, 2 ** 31 + 11)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault):
    if fault == "half_batch" and _batch(cell) < 2:
        pytest.skip("one scenario: no half of the batch to leave out")
    with faults.FAULTS[fault]():
        r = _run(cell, 2 ** 31 + 12)
    assert not r["correct"], r["check"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught(card, cell):
    """The reference with TF32 products in the program's place, at 64
    scenarios at most."""
    r = _run(cell, 2 ** 31 + 13, device=card.type,
             program=build.reference(allow_tf32=True),
             batch=min(_batch(cell), 64))
    assert not r["correct"], r["check"]
