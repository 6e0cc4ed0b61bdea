"""The tracer's device tallies (``trace.tally``) and the two that the
accurate-mode closer records, on the CPU at Go2 N=4: each tick's histogram
of the kept projection pass sums to the batch, the count within the
production tolerance is the host's count of ``max_violation <= 1e-3``, a
hot tick records none, ``reset_tallies`` clears them, and nothing is
tallied while ``trace.off()`` holds (an export's trace)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import trace  # noqa: E402
from tpu_locoman_torch.solver import sqp  # noqa: E402

NAMES = ("sqp.eq_projection.kept_pass", "sqp.eq_projection.within_tol")
BATCH = 3


def _mpc(config):
    robot = T.Go2()
    robot.set_gait_sequence("trot", 0.5)
    return T.MPC(robot, nodes=4, config=config, device="cpu")


def _vel():
    return torch.tensor([[0.2, 0, 0, 0, 0, 0], [0.1, 0.05, 0, 0, 0, 0.1],
                         [0.3, -0.05, 0, 0, 0, -0.1]])


def test_the_closer_tallies_every_scenario_of_every_tick():
    mpc = _mpc("accurate")
    passes = mpc.solver.cfg.eq_projection
    carry = mpc.init_carry(BATCH)
    trace.reset_tallies()
    within = 0
    for k in range(3):
        carry, stats = mpc.step(carry, 0.01 * k, _vel())
        within += int((stats["max_violation"] <= sqp.PRODUCTION_TOL).sum())
        t = trace.tallies()
        assert set(t) == set(NAMES)
        hist = t["sqp.eq_projection.kept_pass"]
        assert len(hist) == passes + 1
        assert sum(hist) == BATCH * (k + 1)
        assert t["sqp.eq_projection.within_tol"] == within
    assert sqp.PRODUCTION_TOL == 1e-3
    trace.reset_tallies()
    assert trace.tallies() == {}


def test_a_hot_tick_records_no_tally():
    mpc = _mpc("fast")
    trace.reset_tallies()
    mpc.step(mpc.init_carry(BATCH), 0.0, _vel())
    assert trace.tallies() == {}


def test_tally_adds_and_widens_histograms():
    """Closers of other pass counts in one process (a test session, a
    calibration) add into one histogram of the kept pass."""
    trace.reset_tallies()
    trace.tally("n", torch.tensor(2))
    trace.tally("n", torch.tensor(3))
    trace.tally("h", torch.tensor([1, 0, 2]))
    trace.tally("h", torch.tensor([1, 1]))
    trace.tally("h", torch.tensor([0, 0, 0, 4]))
    assert trace.tallies() == {"n": 5, "h": [2, 1, 2, 4]}
    trace.reset_tallies()
    assert trace.tallies() == {}


def test_nothing_is_tallied_while_the_tracer_is_off():
    trace.reset_tallies()
    trace.enable()
    try:
        with trace.off():
            assert not trace.enabled()
            trace.tally("n", torch.ones(3).sum())
        assert trace.enabled()
    finally:
        trace.disable()
    with trace.off():
        pass
    assert not trace.enabled()
    trace.tally("n", torch.tensor(1))
    assert trace.tallies() == {"n": 1}
    trace.reset_tallies()
