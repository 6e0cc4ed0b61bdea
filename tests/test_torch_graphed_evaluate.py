"""The solver's residual evaluation as one CUDA graph per shape
(``solver.graphs.Graphed`` around ``Transcription.evaluate``).

On the CPU, under an export's trace and inside a ``torch.func`` transform
the solver evaluates eagerly and counts no capture and no replay. The
bookkeeping of the graph path (the key, capture on a key's second call,
the static input buffers, a fresh output per call, the counters) is held
here with the card's two conditions stood in for: ``on_card`` reads true
and ``Graphed._record`` returns an eager stand-in for the captured graph,
whose replay runs ``evaluate`` on the static buffers into the static
output. The graph itself is held on the card by ``chip_smoke.py``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import aot, trace  # noqa: E402
from tpu_locoman_torch.solver import graphs  # noqa: E402

B = 2
CAPTURES, REPLAYS = "graphs.evaluate.captures", "graphs.evaluate.replays"


def _mpc(**sqp):
    robot = T.Go2()
    robot.set_gait_sequence("trot", 0.5)
    cfg = T.SQPConfig(sqp_iters=1, admm=T.ADMMConfig(iters=3), **sqp)
    return T.MPC(robot, nodes=3, config=cfg, device="cpu")


def _inputs(mpc, batch=B):
    """The solver's (Z, sp, shared) of a first tick's warm start."""
    carry = mpc.init_carry(batch)
    tg = torch.tensor([[0.2, 0, 0, 0, 0, 0]] * batch)
    state, sp, shared = mpc._prepare(carry, 0.0, tg, None, None, None, None)
    return state.Z, sp, shared


def _counts():
    return trace.counter(CAPTURES), trace.counter(REPLAYS)


class _EagerGraph:
    """Stands in for a captured graph: a replay runs ``fn`` on the static
    inputs and writes the static output."""

    def __init__(self, fn, args, output):
        self.fn, self.args, self.output = fn, args, output

    def replay(self):
        self.output.copy_(self.fn(*self.args))


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path engaged on the CPU with an eager stand-in for the
    capture. Returns the list of recorded (stand-in) graphs."""
    recorded = []

    def record(self, static_args, dev):
        output = self.fn(*static_args)
        recorded.append(_EagerGraph(self.fn, static_args, output))
        return self.fn(*static_args), recorded[-1], output, {}

    monkeypatch.setattr(graphs, "on_card", lambda leaves: True)
    monkeypatch.setattr(graphs.Graphed, "_record", record)
    trace.reset_counters()
    yield recorded
    trace.reset_counters()


@pytest.fixture
def counters():
    trace.reset_counters()
    yield
    trace.reset_counters()


def test_cpu_ticks_evaluate_eagerly(counters):
    """Hot (line search and corrector) and accurate (the closer) ticks on
    the CPU: every evaluation eager, no capture, no replay."""
    for sqp in ({"n_trials": 2, "corrector_iters": 2},
                {"n_trials": 8, "eq_projection": 2}):
        mpc = _mpc(**sqp)
        carry = mpc.init_carry(B)
        tg = torch.tensor([[0.2, 0, 0, 0, 0, 0]] * B)
        for k in range(3):
            carry, _ = mpc.step(carry, k * mpc.dt_min, tg)
        assert mpc.solver._evaluate.path == "eager"
    assert _counts() == (0, 0)


def test_export_trace_evaluates_eagerly(stand_in):
    """Under ``aot``'s trace (``make_fx`` in fake mode, then
    ``torch.export``), with the card's conditions stood in for, the
    solver's evaluation is traced as plain operations: nothing captured or
    replayed, and the artifact computes the eager residual."""
    mpc = _mpc(n_trials=2, corrector_iters=2)
    solver = mpc.solver
    Z, sp, shared = _inputs(mpc)

    n = len(sp)

    def fn(Z, *fields):  # the parameter sets flat, as an artifact takes them
        return solver._evaluate(Z, type(sp)(*fields[:n]),
                                type(shared)(*fields[n:]))

    args = (Z, *sp, *shared)
    art = aot.load_artifact(aot._export(fn, args, None))
    assert _counts() == (0, 0) and not stand_in
    assert solver._evaluate.path == "eager"
    Z2 = Z + 0.01
    assert torch.equal(art(Z2, *sp, *shared),
                       mpc.trans.evaluate(Z2, sp, shared))
    assert _counts() == (0, 0)


@pytest.mark.parametrize("transform", ["vmap", "jvp", "grad"])
def test_func_transforms_evaluate_eagerly(stand_in, transform):
    """Inside ``torch.func.vmap``/``jvp`` and with an input that requires
    grad the evaluation runs eagerly and gives the eager residual."""
    mpc = _mpc(n_trials=2, corrector_iters=2)
    ev, trans = mpc.solver._evaluate, mpc.trans
    Z, sp, shared = _inputs(mpc)
    Zs = torch.stack([Z, Z + 0.01])
    for _ in range(3):
        if transform == "vmap":
            out = torch.func.vmap(lambda z: ev(z, sp, shared))(Zs)
            ref = torch.stack([trans.evaluate(z, sp, shared) for z in Zs])
            assert torch.allclose(out, ref, rtol=1e-6, atol=1e-6)
        elif transform == "jvp":
            out, _ = torch.func.jvp(lambda z: ev(z, sp, shared), (Z,),
                                    (torch.ones_like(Z),))
            assert torch.equal(out, trans.evaluate(Z, sp, shared))
        else:
            out = ev(Z.clone().requires_grad_(True), sp, shared)
            assert out.requires_grad
            assert torch.equal(out.detach(), trans.evaluate(Z, sp, shared))
    assert _counts() == (0, 0) and not stand_in and ev.path == "eager"


def test_key_separates_the_call_shapes(stand_in):
    """(2, B), (B) and (8, B) iterates are three keys, each captured on
    its second call (which returns the warm-up's eager result) and
    replayed from then on."""
    mpc = _mpc(n_trials=2, corrector_iters=2)
    ev = mpc.solver._evaluate
    Z, sp, shared = _inputs(mpc)
    shapes = ((2,), (), (8,))
    expect = []
    for lead in shapes:
        Zk = Z.expand(lead + Z.shape).clone()
        for call in range(3):
            out = ev(Zk + 1e-3 * call, sp, shared)
            assert torch.equal(out, mpc.trans.evaluate(Zk + 1e-3 * call, sp,
                                                       shared))
            assert ev.path == ("graph" if call == 2 else "eager")
            expect.append(_counts())
    assert expect == [(0, 0), (1, 0), (1, 1), (1, 1), (2, 1), (2, 2),
                      (2, 2), (3, 2), (3, 3)]
    assert len(stand_in) == 3
    assert [tuple(g.args[0].shape[:-3]) for g in stand_in] == list(shapes)


def test_replay_reads_new_inputs_into_a_fresh_output(stand_in):
    """Every call copies its values into the static buffers, so a replay
    gives the residual of what it was given; the tensor it returns is not
    the static output, and a later call does not overwrite it."""
    mpc = _mpc(n_trials=2, corrector_iters=2)
    ev, trans = mpc.solver._evaluate, mpc.trans
    Z, sp, shared = _inputs(mpc)
    ev(Z, sp, shared)
    ev(Z, sp, shared)  # captures
    first = ev(Z + 0.01, sp, shared)  # replays
    kept = first.clone()
    (graph,) = stand_in
    assert first.data_ptr() != graph.output.data_ptr()
    Z2 = Z + 0.05
    sp2 = sp._replace(contact=1.0 - sp.contact)
    shared2 = shared._replace(x_init=shared.x_init + 0.01)
    second = ev(Z2, sp2, shared2)
    assert torch.equal(second, trans.evaluate(Z2, sp2, shared2))
    assert not torch.equal(second, kept)
    assert torch.equal(first, kept)  # untouched by the later replay
    assert torch.equal(graph.args[0], Z2)  # the static buffer holds Z2
    assert graph.args[1].contact.data_ptr() != sp2.contact.data_ptr()
    assert _counts() == (1, 2)


def test_replay_counts_the_launches_it_repeats(monkeypatch, stand_in):
    """A replay adds the kernel launch counts that its capture took back."""
    record = graphs.Graphed._record

    def with_launch(self, static_args, dev):
        out, graph, output, _ = record(self, static_args, dev)
        return out, graph, output, {"kernels.test.launches": 3}

    monkeypatch.setattr(graphs.Graphed, "_record", with_launch)
    mpc = _mpc(n_trials=2, corrector_iters=2)
    ev = mpc.solver._evaluate
    Z, sp, shared = _inputs(mpc)
    for _ in range(5):
        ev(Z, sp, shared)
    assert trace.counter("kernels.test.launches") == 9
    assert _counts() == (1, 3)


def test_plain_eager_sees_modes_and_grad():
    x = torch.zeros(3)
    assert graphs.plain_eager([x, x])
    assert not graphs.plain_eager([x, None])
    assert not graphs.plain_eager([x.requires_grad_(True)])
    assert not graphs.plain_eager([object()])
    assert not graphs.on_card([torch.zeros(2)])


@pytest.mark.parametrize("sqp,expect", [
    ({"n_trials": 2, "corrector_iters": 2}, [(0, 0), (2, 0), (2, 2)]),
    ({"n_trials": 8, "eq_projection": 2}, [(1, 0), (2, 2), (2, 5)])])
def test_ticks_capture_each_shape_once(monkeypatch, stand_in, sqp, expect):
    """Hot: (2, B) and (B) are captured in the second tick, though the
    first tick's torque hand-off is a fresh tensor and the later ones a
    slice of the plan. Accurate: the closer's (B) in the first tick's
    second pass, (8, B) in the second tick. Every tick equals an eager
    MPC's from the same start."""
    mpc, ref = _mpc(**sqp), _mpc(**sqp)
    carry = rcarry = mpc.init_carry(B)
    tg = torch.tensor([[0.2, 0, 0, 0, 0, 0]] * B)
    got = []
    for k in range(3):
        carry, stats = mpc.step(carry, k * mpc.dt_min, tg)
        got.append(_counts())
        with monkeypatch.context() as m:  # the reference evaluates eagerly
            m.setattr(graphs, "on_card", lambda leaves: False)
            rcarry, rstats = ref.step(rcarry, k * ref.dt_min, tg)
        assert _counts() == got[-1]
        trace.reset_counters()
        assert torch.equal(carry.solver_state.Z, rcarry.solver_state.Z)
        assert torch.equal(stats["max_violation"], rstats["max_violation"])
    assert [got[0], tuple(map(sum, zip(*got[:2]))),
            tuple(map(sum, zip(*got)))] == expect
    assert len(stand_in) == 2


#: ATen operations that read a device value back to the host on the card
#: (a capture refuses them): item, the linalg error checks, nonzero and
#: what calls it
_SYNCS = {"aten::_local_scalar_dense", "aten::_linalg_check_errors",
          "aten::nonzero", "aten::masked_select", "aten::is_nonzero",
          "aten::equal", "aten::unique_dim", "aten::_unique2"}


class _Syncs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in _SYNCS or (name == "aten::index" and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1])):
            self.seen.add(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dynamics,robot,form", [
    ("whole_body_rnea", {}, {}), ("whole_body_aba", {}, {}),
    ("whole_body_acc", {}, {}), ("centroidal_acc", {}, {}),
    ("centroidal_vel", {}, {}),
    ("whole_body_rnea", {}, {"include_acc": False}),
    ("whole_body_acc", {}, {"include_base": False}),
    ("centroidal_acc", {}, {"include_base": False}),
    ("centroidal_vel", {}, {"include_base": False}),
    ("whole_body_rnea", {"use_quaternion": False}, {}),
    ("centroidal_acc", {"use_quaternion": False}, {})])
def test_evaluate_reads_nothing_back(dynamics, robot, form):
    """Every formulation's and variant's residual evaluation, which the
    solver replays on the card, issues no operation that waits for the
    device."""
    rob = T.Go2(**robot)
    rob.set_gait_sequence("trot", 0.5)
    mpc = T.MPC(rob, dynamics=dynamics, nodes=3, device="cpu", **form)
    Z, sp, shared = _inputs(mpc)
    Zc = Z + 0.01 * torch.randn((2,) + Z.shape,
                                generator=torch.Generator().manual_seed(0))
    with _Syncs() as syncs:
        mpc.trans.evaluate(Z, sp, shared)
        mpc.trans.evaluate(Zc, sp, shared)
    assert not syncs.seen
