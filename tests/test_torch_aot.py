"""Exported step artifacts of the port (``tpu_locoman_torch.aot``), the
counterpart of tests/test_aot.py: Go2 ``whole_body_rnea`` N=3, batch 2,
one export of the step and one of the retraction per module.

The loaded artifact must compute the eager step: it runs the same ATen
operations and the same custom ops in the same order, so the bound is
1e-5 (measured on the CPU: 0 in x, Z and max_violation over 3 ticks). The
graph holds K1, K2 and K4 as the custom ops
``tpu_locoman_torch::chol_inv_node``, ``::rnea_derivs`` and
``::admm_sweeps`` (their CPU implementation here), and tracing leaves
no fake tensor in the live MPC. JAX's own artifact is held against the
port's in tests/test_torch_aot_jax.py."""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.utils._pytree as pytree  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensor  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import aot, rbda  # noqa: E402

B, TICKS, TOL = 2, 3, 1e-5
TARGETS = np.array([[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0.2]],
                   np.float32)


def _mpc():
    robot = T.Go2()
    robot.set_gait_sequence("trot", 0.8)
    return T.MPC(robot, dynamics="whole_body_rnea", nodes=3, device="cpu",
                 config=T.SQPConfig(n_trials=2, corrector_iters=2,
                                    admm=T.ADMMConfig(iters=3)))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(mpc, step bytes, loaded step (from the file export_mpc_step wrote),
    loaded retract, that file's path)."""
    mpc = _mpc()
    path = str(tmp_path_factory.mktemp("aot") / "step.pt2")
    data = aot.export_mpc_step(mpc, B, path=path)
    retract = aot.load_artifact(aot.export_retract(mpc, B, num_steps=2))
    return mpc, data, aot.load_artifact(path), retract, path


def test_artifact_bytes_and_kernel_ops(exported):
    _, data, step, _, _ = exported
    assert len(data) > 1000 and data[:2] == b"PK"  # a .pt2 zip archive
    ops = {str(n.target) for n in step.graph.nodes
           if n.op == "call_function"}
    assert "tpu_locoman_torch.chol_inv_node.default" in ops
    assert "tpu_locoman_torch.rnea_derivs.default" in ops
    assert "tpu_locoman_torch.admm_sweeps.default" in ops


def test_loaded_step_equals_eager_step(exported):
    mpc, _, step, _, _ = exported
    targets = torch.tensor(TARGETS)
    zeros = torch.zeros(B, 3)
    ca = ce = mpc.init_carry(B)
    for k in range(TICKS):
        t = torch.full((B,), np.float32(k * 0.01))
        ca, viol = step(ca, t, targets, zeros, zeros)
        ce, stats = mpc.step(ce, t, targets, zeros, zeros)
        for name, a, e in (("x", ca.x_init, ce.x_init),
                           ("Z", ca.solver_state.Z, ce.solver_state.Z),
                           ("max_violation", viol, stats["max_violation"])):
            assert not isinstance(a, FakeTensor)
            np.testing.assert_allclose(a.numpy(), e.numpy(), atol=TOL,
                                       err_msg=f"{name}, tick {k}")
    assert type(ce.x_init) is torch.Tensor  # no fake tensor left behind
    assert isinstance(ca, T.MPCCarry)


def _store(owner):
    """The entries of ``owner``'s per-device constants (model.device_consts),
    by key."""
    return owner.__dict__.get("_device_consts", {})


def _cached_tensors(mpc):
    """Every tensor in the per-device constants of the model, the
    transcription, the formulation and the gait."""
    return [x for owner in (mpc.form.model, mpc.trans, mpc.form, mpc.gait)
            for entry in _store(owner).values()
            for x in pytree.tree_leaves(entry) if isinstance(x, torch.Tensor)]


def test_export_leaves_no_fake_tensor_in_the_model(exported):
    mpc = exported[0]
    tensors = _cached_tensors(mpc)
    assert tensors and not any(isinstance(x, FakeTensor) for x in tensors)


def test_constants_built_in_the_trace_equal_their_eager_build(exported):
    """The export builds the constants its trace first needs inside the
    fake trace: each entry is a real tensor equal to the same entry built
    by an eager tick of a fresh MPC."""
    mpc, eager = exported[0], _mpc()
    eager.step(eager.init_carry(B), 0.0, torch.tensor(TARGETS))
    for owner, ref in ((mpc.form.model, eager.form.model),
                       (mpc.trans, eager.trans), (mpc.form, eager.form),
                       (mpc.gait, eager.gait)):
        assert set(_store(ref)) <= set(_store(owner)), type(owner).__name__
        for key, entry in _store(ref).items():
            got, want = (pytree.tree_leaves(e)
                         for e in (_store(owner)[key], entry))
            assert len(got) == len(want), key
            for g, w in zip(got, want):
                if isinstance(w, torch.Tensor):
                    assert type(g) is torch.Tensor and torch.equal(g, w), key


def test_constant_first_built_in_a_fake_trace_is_real():
    """A constant first needed inside make_fx's fake trace (the model's
    tensors, its local inertias and a frame's placement, none built
    before) is stored as a real tensor equal to its eager build, and the
    traced graph computes what the eager call does."""
    model, ref = T.Go2().model, T.Go2().model
    frame = next(iter(model.frames))

    def fn(model, R, p):
        I_w = rbda.world_inertias(model, R, p)
        return I_w, rbda.frame_placement(model, frame, R, p)[1]

    g = torch.Generator().manual_seed(0)
    n = model.n_links
    R = torch.linalg.qr(torch.randn(2, n, 3, 3, generator=g))[0]
    p = torch.randn(2, n, 3, generator=g)
    assert not _store(model)
    with torch.no_grad():
        gm = make_fx(functools.partial(fn, model), tracing_mode="fake",
                     _allow_non_fake_inputs=True)(R, p)
        want = fn(ref, R, p)
    assert set(_store(model)) == set(_store(ref)) and _store(model)
    for key, entry in _store(ref).items():
        for g_, w in zip(pytree.tree_leaves(_store(model)[key]),
                         pytree.tree_leaves(entry)):
            assert type(g_) is torch.Tensor and torch.equal(g_, w), key
    for a, b in zip(gm(R, p), want):
        assert torch.equal(a, b)


def test_artifact_file_holds_the_returned_bytes(exported):
    data, path = exported[1], exported[4]
    with open(path, "rb") as f:
        assert f.read() == data


def test_retract_artifact(exported):
    mpc, _, _, retract, _ = exported
    carry, _ = mpc.step(mpc.init_carry(B), 0.0, torch.tensor(TARGETS))
    Z, x0 = carry.solver_state.Z, carry.x_init
    out = retract(Z, x0)
    ref = mpc.retract(Z, x0, num_steps=2)
    for name, o in zip(("q", "v", "a", "forces", "tau"), out):
        assert o.shape[:2] == (B, 2), name
        np.testing.assert_allclose(o.numpy(), ref[name].numpy(), atol=TOL,
                                   err_msg=name)
    np.testing.assert_allclose(out[0][:, 0].numpy(),
                               x0[:, :mpc.form.nq].numpy(), atol=1e-5)


def test_artifact_loads_in_a_fresh_process(exported, tmp_path):
    """load_artifact registers the ops before torch.export.load: a process
    that imported nothing else of the port runs the artifact."""
    import subprocess
    import sys

    mpc, data, _, _, _ = exported
    path = tmp_path / "step.pt2"
    path.write_bytes(data)
    carry = mpc.init_carry(B)
    x_ref = mpc.step(carry, torch.zeros(B), torch.tensor(TARGETS))[0].x_init
    np.save(tmp_path / "x_ref.npy", x_ref.numpy())
    script = (
        "import sys, numpy as np, torch\n"
        "sys.modules['jax'] = None\n"
        "from tpu_locoman_torch.aot import load_artifact\n"
        "from tpu_locoman_torch.mpc import MPCCarry\n"
        "from tpu_locoman_torch.solver import SolverState\n"
        "d = sys.argv[1]\n"
        "fn = load_artifact(d + '/step.pt2')\n"
        "c = torch.load(d + '/carry.pt', weights_only=False)\n"
        "tg = torch.tensor(np.load(d + '/targets.npy'))\n"
        "z = torch.zeros(tg.shape[0], 3)\n"
        "out, viol = fn(c, torch.zeros(tg.shape[0]), tg, z, z)\n"
        "assert isinstance(out, MPCCarry)\n"
        "ref = np.load(d + '/x_ref.npy')\n"
        "print('gap', float(np.abs(out.x_init.numpy() - ref).max()))\n")
    torch.save(carry, tmp_path / "carry.pt")
    np.save(tmp_path / "targets.npy", TARGETS)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    gap = float(out.stdout.split("gap")[-1])
    assert gap <= TOL, gap
