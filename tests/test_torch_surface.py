"""The port's public surface against tpu_locoman's.

- Name parity: every public top-level name of every tpu_locoman module
  (its functions, classes, assignments and ``from ... import`` names, read
  from the file's AST) is a name of the port's counterpart module, except
  the differences listed in ALLOWED, each with its reason.
- The functions that came last, each against JAX on seeded numpy inputs:
  the Bezier swing velocity and CubicSpline (atol 1e-6), the SO(3) matrix
  maps (atol 2e-6; the round trip 2e-4, as tests/test_lie.py holds it),
  frame_velocity_lwa for every frame of Go2 and B2G (atol 1e-5),
  quat_identity exactly; and rbda's re-exports.
- make_ocp for each formulation (Go2 N=4 on the CPU): the formulation, its
  arguments and the transcription's sizes equal JAX make_ocp's, and one
  tick equals that of the MPC built directly.
- The preset lookup's error and the URDF fallback of the robots, both
  packages side by side.
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman import gait as jgait  # noqa: E402
from tpu_locoman import lie as jlie  # noqa: E402
from tpu_locoman import model as jmodel  # noqa: E402
from tpu_locoman import rbda as jrbda  # noqa: E402
from tpu_locoman import robots as jrobots  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import gait as tgait  # noqa: E402
from tpu_locoman_torch import lie as tlie  # noqa: E402
from tpu_locoman_torch import model as tmodel  # noqa: E402
from tpu_locoman_torch import rbda as trbda  # noqa: E402
from tpu_locoman_torch import rnea_derivs  # noqa: E402
from tpu_locoman_torch import robots as trobots  # noqa: E402
from tpu_locoman_torch.dynamics import formulations as tform  # noqa: E402
from tpu_locoman_torch.solver import qp as tqp  # noqa: E402
from test_torch_robots import _SRDF, _URDF, _dicts_close  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "tpu_locoman")
PORT_PKG = os.path.join(ROOT, "tpu_locoman_torch")

#: tpu_locoman module -> (names the port leaves out of its counterpart, or
#: "*" for a module without one; why)
ALLOWED = {
    "_platform.py": ("*", "JAX plumbing: it picks the Pallas target "
                          "platform; the MPC's device plays its part"),
    "pallas_rbda.py": ("*", "the Pallas form of K2: rnea_derivs.py and "
                            "csrc/rnea_derivs.cu do its work"),
    "solver/pallas_base.py": ("*", "the Pallas form of K1: solver/"
                                   "chol_base.py and csrc/chol_inv_node.cu"),
    "solver/pallas_fac.py": ("*", "the Pallas form of K3: solver/"
                                  "fac_whole.py and csrc/fac_whole.cu"),
    "distributed.py": ({"Mesh"}, "jax.sharding import"),
    "parallel.py": ({"Mesh", "NamedSharding", "P"}, "jax.sharding imports"),
    "solver/qp.py": ({"custom_vmap", "lax", "target_platform",
                      "override_target_platform"},
                     "JAX imports and _platform's Pallas target"),
    "solver/sqp.py": ({"lax"}, "JAX import"),
    "model.py": ({"SpatialInertiaHost", "build_reduced_model",
                  "load_srdf_reference_configurations", "parse_urdf",
                  "rpy_to_matrix"}, "the URDF parser, in urdf.py"),
    "rbda.py": ({"motion_act", "force_act_inv", "inertia_matrix",
                 "motion_transform_matrix", "force_transform_matrix"},
                "spatial helpers that only the JAX recursions call"),
}
#: where the port keeps a module's work under another name
ELSEWHERE = {"model.py": "urdf.py", "pallas_rbda.py": "rnea_derivs.py",
             "solver/pallas_base.py": "solver/chol_base.py",
             "solver/pallas_fac.py": "solver/fac_whole.py",
             "_platform.py": None}


def _public_names(path):
    """Public top-level names of a module: defs, classes, assigned names
    and ``from ... import`` names (``import x`` binds a module, left out)."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(n.id for t in node.targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        out += [os.path.relpath(os.path.join(dirpath, f), JAX_PKG)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _port_path(rel):
    if rel == "robots/__init__.py":
        return os.path.join(PORT_PKG, "robots.py")
    return os.path.join(PORT_PKG, rel)


@pytest.mark.parametrize("rel", _jax_modules())
def test_public_names_are_ported(rel):
    jax_names = _public_names(os.path.join(JAX_PKG, rel))
    allowed, why = ALLOWED.get(rel, (set(), ""))
    port = _port_path(rel)
    if allowed == "*":
        assert not os.path.exists(port), f"{rel} has a port now: {why}"
        if ELSEWHERE[rel]:
            assert os.path.exists(os.path.join(PORT_PKG, ELSEWHERE[rel]))
        return
    port_names = _public_names(port)
    missing = jax_names - port_names - allowed
    assert not missing, f"{rel}: not in the port: {sorted(missing)}"
    # every allowed difference is still one, and lives where it is said to
    assert allowed <= jax_names - port_names, (
        f"{rel}: ALLOWED lists {sorted(allowed - (jax_names - port_names))}, "
        f"which are no difference")
    if rel in ELSEWHERE:
        assert allowed <= _public_names(os.path.join(PORT_PKG, ELSEWHERE[rel]))


def test_allowed_modules_exist():
    assert set(ALLOWED) <= set(_jax_modules())


def test_package_exports():
    assert T.OCP_ARGS is tform.DEFAULT_ARGS
    assert T.FORMULATIONS is tform.FORMULATIONS
    assert T.make_formulation is tform.make_formulation
    for name in ("Formulation", "CentroidalVel", "CentroidalAcc",
                 "WholeBodyAcc", "WholeBodyRNEA", "WholeBodyABA"):
        assert getattr(T.dynamics, name) is getattr(tform, name)
    assert T.solver.BlockTridiagFactor is tqp.BlockTridiagFactor
    assert T.solver.admm_solve is tqp.admm_solve
    assert trobots.RobotModel is tmodel.RobotModel
    assert trbda.skew is tlie.skew and trbda.integrate_q is tlie.integrate_q
    assert T.OCP_ARGS == J.OCP_ARGS
    assert sorted(T.FORMULATIONS) == sorted(J.FORMULATIONS)


# ---------------------------------------------------------------------------
# Gait, Lie and RBDA functions against JAX.
# ---------------------------------------------------------------------------

def test_bezier_and_cubic_spline_match_jax():
    rng = np.random.default_rng(11)
    phase = np.concatenate([[0.0, 0.25, 0.5, 0.75, 1.0],
                            rng.uniform(0, 1, 200)]).astype(np.float32)
    period = rng.uniform(0.2, 0.6, phase.shape).astype(np.float32)
    h = rng.uniform(0.05, 0.15, phase.shape).astype(np.float32)
    ref = jgait.get_bezier_vel_z(jnp.asarray(phase), jnp.asarray(period),
                                 jnp.asarray(h))
    out = tgait.get_bezier_vel_z(torch.tensor(phase), torch.tensor(period),
                                 torch.tensor(h))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # the scalar form of tests/test_gait.py: antisymmetric about mid-swing
    v = tgait.get_bezier_vel_z(torch.tensor([0.25, 0.75]), 0.4, h_max=0.1)
    np.testing.assert_allclose(float(v[0]), -float(v[1]), atol=1e-6)
    assert float(v[0]) > 0
    np.testing.assert_allclose(
        tgait.cubic_bezier_derivative(0.0, 0.1, torch.tensor(phase)).numpy(),
        np.asarray(jgait.cubic_bezier_derivative(0.0, 0.1,
                                                 jnp.asarray(phase))),
        rtol=0, atol=1e-6)
    bc = rng.standard_normal((4, 50)).astype(np.float32)
    t0, t1 = np.float32(0.1), np.float32(0.45)
    t = rng.uniform(t0, t1, 50).astype(np.float32)
    js = jgait.CubicSpline(t0, t1, *(jnp.asarray(b) for b in bc))
    ts = tgait.CubicSpline(float(t0), float(t1), *(torch.tensor(b)
                                                   for b in bc))
    for name in ("position", "velocity"):
        np.testing.assert_allclose(
            getattr(ts, name)(torch.tensor(t)).numpy(),
            np.asarray(getattr(js, name)(jnp.asarray(t))), rtol=0, atol=1e-6,
            err_msg=name)


def _rotvecs(rng):
    """Angles on both sides of the small-angle threshold (theta^2 = 1e-2),
    near zero and up to pi - 0.1, on random axes: (n, 3) float32."""
    theta = np.concatenate([
        [0.0, 1e-6, 1e-3, np.sqrt(0.99e-2), np.sqrt(1.01e-2)],
        rng.uniform(0.0, 0.1, 20), rng.uniform(0.1, np.pi - 0.1, 60),
        [np.pi - 0.1]])
    axis = rng.standard_normal((theta.size, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    return (axis * theta[:, None]).astype(np.float32)


def test_so3_matrix_maps_match_jax():
    w = _rotvecs(np.random.default_rng(12))
    R_ref = np.asarray(jax.vmap(jlie.so3_exp_matrix)(jnp.asarray(w)))
    R = tlie.so3_exp_matrix(torch.tensor(w))
    np.testing.assert_allclose(R.numpy(), R_ref, rtol=0, atol=2e-6)
    # the log of the same matrices, and of the port's own
    log_ref = np.asarray(jax.vmap(jlie.so3_log_matrix)(jnp.asarray(R_ref)))
    log = tlie.so3_log_matrix(torch.tensor(R_ref))
    np.testing.assert_allclose(log.numpy(), log_ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(tlie.so3_log_matrix(R).numpy(), w, rtol=0,
                               atol=2e-4)
    # leading batch dimensions
    R2 = tlie.so3_exp_matrix(torch.tensor(w[:80]).reshape(4, 20, 3))
    assert torch.equal(R2.reshape(80, 3, 3), R[:80])


def test_quat_identity():
    q = tlie.quat_identity()
    assert q.dtype == torch.float32 and q.device.type == "cpu"
    np.testing.assert_array_equal(q.numpy(), np.asarray(jlie.quat_identity()))
    assert tlie.quat_identity(torch.float64).dtype == torch.float64


@pytest.mark.parametrize("name", ["Go2", "B2G"])
def test_frame_velocity_lwa_matches_jax(name):
    jrob, trob = getattr(J, name)(), getattr(T, name)()
    rng = np.random.default_rng(13)
    B = 3
    q = np.tile(np.asarray(jrob.q0, np.float32), (B, 1))
    q[:, :3] += rng.standard_normal((B, 3)).astype(np.float32) * 0.1
    quat = rng.standard_normal((B, 4)).astype(np.float32)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] += rng.standard_normal((B, jrob.nq - 7)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, jrob.nv)).astype(np.float32)
    m, frames = jrob.model, sorted(jrob.model.frames)
    assert frames == sorted(trob.model.frames)
    # JAX's frame_velocity_lwa is frame_velocity_lwa_from of one fk_vel:
    # that pass is compiled once, each frame's part runs eagerly, and the
    # function itself eagerly for the feet and the gripper
    kin = jax.jit(jax.vmap(lambda q_, v_: jrbda.fk_vel(m, q_, v_)))(q, v)
    kin = [[[np.asarray(x[i]) for x in k] for k in kin] for i in range(B)]
    for f in frames:
        out = trbda.frame_velocity_lwa(trob.model, f, torch.tensor(q),
                                       torch.tensor(v)).numpy()
        ref = np.stack([np.asarray(jrbda.frame_velocity_lwa_from(m, f, *k))
                        for k in kin])
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5, err_msg=f)
        if f in jrob.FOOT_FRAMES or f == jrob.arm_ee_frame:
            np.testing.assert_allclose(
                out[0], np.asarray(jrbda.frame_velocity_lwa(m, f, q[0], v[0])),
                rtol=0, atol=1e-5, err_msg=f)


def test_rbda_rnea_derivatives_is_the_batched_k2_contract():
    """rbda.rnea_derivatives is rnea_derivs.rnea_derivatives (whose plain
    version tests/test_torch_rbda.py holds against JAX's per sample)."""
    trob = T.Go2()
    rng = np.random.default_rng(14)
    B, m = 2, trob.model
    q = np.tile(np.asarray(trob.q0, np.float32), (B, 1))
    q[:, 7:] += rng.standard_normal((B, m.nq - 7)).astype(np.float32) * 0.3
    v, a = (rng.standard_normal((B, m.nv)).astype(np.float32)
            for _ in range(2))
    f = rng.standard_normal((B, 12)).astype(np.float32) * 30.0
    args = (m, *(torch.tensor(x) for x in (q, v, a)),
            tuple(trob.FOOT_FRAMES), torch.tensor(f))
    out = trbda.rnea_derivatives(*args)
    same = rnea_derivs.rnea_derivatives(*args)
    assert len(out) == 4 and all(torch.equal(o, s) for o, s in zip(out, same))
    assert [tuple(o.shape) for o in out] == [(B, m.nv, m.nv)] * 3 + [
        (B, m.nv, 12)]
    assert len(trbda.rnea_derivatives(*args[:4])) == 3


# ---------------------------------------------------------------------------
# make_ocp, the preset lookup and the URDF fallback.
# ---------------------------------------------------------------------------

def _go2(mod):
    robot = mod.Go2()
    robot.set_gait_sequence("trot", 0.5)
    return robot


def _hot(mod):
    return mod.SQPConfig(sqp_iters=1, n_trials=2, corrector_iters=5,
                         admm=mod.ADMMConfig(iters=10))


@pytest.mark.parametrize("dynamics", sorted(T.FORMULATIONS))
def test_make_ocp_matches_jax_and_direct(dynamics):
    jm = J.make_ocp(dynamics, robot=_go2(J), nodes=4, config=_hot(J))
    tm = T.make_ocp(dynamics, robot=_go2(T), nodes=4, config=_hot(T),
                    device="cpu")
    assert type(tm.form).__name__ == type(jm.form).__name__
    assert type(tm.form) is T.FORMULATIONS[dynamics]
    for k in J.OCP_ARGS[dynamics]:
        assert getattr(tm.form, k) == getattr(jm.form, k), k
    for k in ("s", "m", "n_eq", "n_ineq", "n_box", "nx", "nu", "ndx"):
        if hasattr(jm.trans, k):
            assert getattr(tm.trans, k) == getattr(jm.trans, k), k
    assert tm.nodes == jm.nodes == 4 and tm.device.type == "cpu"
    assert tm.solver.cfg == _hot(T)
    direct = T.MPC(_go2(T), dynamics=dynamics, nodes=4, config=_hot(T),
                   device="cpu", **T.OCP_ARGS[dynamics])
    target = torch.tensor([[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0.2]])
    c1, s1 = tm.step(tm.init_carry(2), 0.0, target)
    c2, s2 = direct.step(direct.init_carry(2), 0.0, target)
    assert torch.equal(c1.x_init, c2.x_init)
    assert torch.equal(c1.solver_state.Z, c2.solver_state.Z)
    for k in s2:
        assert torch.equal(s1[k], s2[k]), k


def test_make_ocp_arguments():
    # kwargs override OCP_ARGS; default_args replaces them; solver is
    # accepted and ignored
    tm = T.make_ocp("whole_body_rnea", robot=_go2(T), nodes=3, tau_nodes=2,
                    solver="anything", device="cpu")
    jm = J.make_ocp("whole_body_rnea", robot=_go2(J), nodes=3, tau_nodes=2,
                    solver="anything")
    assert tm.form.tau_nodes == jm.form.tau_nodes == 2
    assert tm.solver.cfg == T.SQPConfig()
    tm = T.make_ocp("whole_body_rnea", default_args={"include_acc": False},
                    robot=_go2(T), nodes=3, device="cpu")
    jm = J.make_ocp("whole_body_rnea", default_args={"include_acc": False},
                    robot=_go2(J), nodes=3)
    assert tm.form.include_acc is jm.form.include_acc is False
    assert tm.trans.s == jm.trans.s


@pytest.mark.parametrize("mod", [J, T], ids=["jax", "port"])
def test_make_ocp_requires_robot(mod):
    with pytest.raises(AssertionError, match="make_ocp requires robot="):
        mod.make_ocp("whole_body_rnea")


def test_make_ocp_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.make_ocp("whole_body_rnea", robot=_go2(T), nodes=3)


def test_unknown_preset_raises_like_jax():
    msgs = []
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            mod.MPC(_go2(mod), nodes=3, config="bogus", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[1] == ("unknown config preset 'bogus'; available: "
                       "['accurate', 'fast']")


@pytest.fixture
def assets(tmp_path, monkeypatch):
    """An empty spec directory for both packages, and an asset root with
    the tiny URDF/SRDF of tests/test_torch_robots.py at Go2's paths."""
    specs, root = tmp_path / "specs", tmp_path / "assets"
    specs.mkdir()
    for sub, text in (("go2_description/urdf/go2.urdf", _URDF),
                      ("go2_description/srdf/go2.srdf", _SRDF)):
        (root / sub).parent.mkdir(parents=True, exist_ok=True)
        (root / sub).write_text(text)
    for mod in (jrobots, trobots):
        monkeypatch.setattr(mod, "SPEC_DIR", str(specs))
        monkeypatch.setattr(mod, "ASSET_ROOTS", ["", str(root)])
    return root


def test_urdf_fallback_builds_the_same_robot(assets):
    jrob, trob = J.Go2(), T.Go2()
    assert trob.model.joint_names == ("root_joint", "hip_joint",
                                      "knee_joint", "tail_joint")
    _dicts_close(tmodel.model_to_dict(trob.model),
                 jmodel.model_to_dict(jrob.model))
    np.testing.assert_array_equal(trob.q0, jrob.q0)
    # a reduced model, as B2G locks its gripper: the knee (id 3) locked at
    # the free-flyer neutral configuration
    rel = ("go2_description/urdf/go2.urdf", "go2_description/srdf/go2.srdf")
    red = trobots._build_from_urdf(*rel, lock_joints=[3])
    jred = jrobots._build_from_urdf(*rel, lock_joints=[3])
    assert red.joint_names == ("root_joint", "hip_joint", "tail_joint")
    _dicts_close(tmodel.model_to_dict(red), jmodel.model_to_dict(jred))


def test_urdf_fallback_without_assets_raises_like_jax(assets, monkeypatch):
    msgs = []
    for mod, cls in ((jrobots, J.Go2), (trobots, T.Go2)):
        monkeypatch.setattr(mod, "ASSET_ROOTS", ["", str(assets / "none")])
        with pytest.raises(FileNotFoundError) as e:
            cls()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == (
        "no spec and no URDF found for go2_description/urdf/go2.urdf")


def test_asset_roots():
    assert trobots.ASSET_ROOTS[1:] == jrobots.ASSET_ROOTS[1:]
    assert trobots.ASSET_ROOTS[0] == os.environ.get("TPU_LOCOMAN_ASSETS", "")
