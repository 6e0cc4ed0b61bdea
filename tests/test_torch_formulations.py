"""The port's formulations slice against tpu_locoman on the same inputs:
the rigid-body additions (crba, nonlinear_effects, frame_jacobian_lwa,
center_of_mass, ccrba, dccrba, aba, aba_derivatives) on Go2 and B2G at
seeded configurations, and for whole_body_aba, whole_body_acc,
centroidal_acc and centroidal_vel the dynamics residual and
Transcription.linearize (g, G, B, C) at Go2 N=3; then the identities of
tests/test_formulations.py on the port, and its formulation factory.

Tolerances, each relative to max|ref| + 1:
- kinematics, crba, ccrba, dccrba, nle, aba and the residuals: 1e-5 (f32
  roundoff of the same recursions);
- aba_derivatives, per block (ABA_DERIV_TOL): da/dq 1e-3, da/dv 3e-4,
  da/dtau 1e-5, da/df 3e-5. At B2G the arm's light links give large
  accelerations, and da/dq and da/dv cancel terms of their size: at these
  samples the port lands 3.4e-4 and 9.6e-5 from JAX in them, and each
  side lies within the same bounds of the port's float64 evaluation,
  which the test checks too;
- linearize and evaluate: 1e-4, as tests/test_torch_transcribe.py (RNEA
  rows reach ~1e5 in g)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman import rbda as jr  # noqa: E402
from tpu_locoman.dynamics import make_formulation as jmake  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import rbda as tr  # noqa: E402
from tpu_locoman_torch.dynamics import make_formulation  # noqa: E402
from tpu_locoman_torch.dynamics.formulations import StageParams  # noqa: E402

ROBOTS = ["Go2", "B2G"]
# aba_derivatives: bound on each block against JAX and against float64
ABA_DERIV_TOL = {"da/dq": 1e-3, "da/dv": 3e-4, "da/dtau": 1e-5,
                 "da/df": 3e-5}


def _close(out, ref, rel, err_msg=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (err_msg, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, atol=rel * (np.abs(ref).max() + 1),
                               err_msg=err_msg)


def _samples(name, B=4, seed=0):
    """B configurations near the reference pose (base tilted, joints
    +-0.1 rad), velocities, joint torques and contact forces near the
    weight split, float32."""
    jrob, trob = getattr(J, name)(), getattr(T, name)()
    m = jrob.model
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(jrob.q0, np.float32), (B, 1))
    q[:, :3] += rng.standard_normal((B, 3)).astype(np.float32) * 0.1
    quat = np.array([0, 0, 0, 1.0]) + rng.standard_normal((B, 4)) * 0.1
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] += rng.standard_normal((B, m.nq - 7)).astype(np.float32) * 0.1
    v = rng.standard_normal((B, m.nv)).astype(np.float32) * 0.3
    tau = np.concatenate([np.zeros((B, 6)),
                          rng.standard_normal((B, m.nj)) * 5], 1)
    ee = tuple(jrob.FOOT_FRAMES) + (
        (jrob.ext_force_frame,) if jrob.ext_force_frame else ())
    f = rng.standard_normal((B, 3 * len(ee))) * 5
    f[:, 2:12:3] += 9.81 * m.total_mass / 4
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return jrob, trob, f32(q), f32(v), f32(tau), ee, f32(f)


def test_crba_nle_jacobian_com_centroidal_map_match_jax_go2():
    _check_kinematics("Go2")


@pytest.mark.slow
def test_crba_nle_jacobian_com_centroidal_map_match_jax_b2g():
    """Slow: the JAX side compiles for ~26 s on a CPU."""
    _check_kinematics("B2G")


def _check_kinematics(name):
    jrob, trob, q, v, _, ee, _ = _samples(name)
    m, tm = jrob.model, trob.model
    frames = ee + (jrob.base_frame,)

    def kin(x, y):
        return {"crba": jr.crba(m, x),
                "nonlinear_effects": jr.nonlinear_effects(m, x, y),
                "frame_jacobian_lwa": jnp.stack(
                    [jr.frame_jacobian_lwa(m, fr, x) for fr in frames]),
                "center_of_mass": jr.center_of_mass(m, x),
                "ccrba": jr.ccrba(m, x), "dccrba": jr.dccrba(m, x, y)}

    ref = jax.device_get(jax.jit(jax.vmap(kin))(q, v))
    tq, tv = torch.tensor(q), torch.tensor(v)
    out = {"crba": tr.crba(tm, tq),
           "nonlinear_effects": tr.nonlinear_effects(tm, tq, tv),
           "frame_jacobian_lwa": torch.stack(
               [tr.frame_jacobian_lwa(tm, fr, tq) for fr in frames], 1),
           "center_of_mass": tr.center_of_mass(tm, tq),
           "ccrba": tr.ccrba(tm, tq), "dccrba": tr.dccrba(tm, tq, tv)}
    for key, r in ref.items():
        _close(out[key], r, 1e-5, key)


@pytest.mark.parametrize("name", [
    "B2G", pytest.param("Go2", marks=pytest.mark.slow)])
def test_aba_and_derivatives_match_jax(name):
    """aba against JAX's, and aba_derivatives against jax.jacfwd of JAX's
    aba (its implicit-function JVP) along the local q tangent, v, tau and
    the forces. Go2 is slow: the JAX side compiles for ~30 s on a CPU."""
    jrob, trob, q, v, tau, ee, f = _samples(name, seed=1)
    m, tm = jrob.model, trob.model

    def dyn(x, y, z, w):
        fn = lambda d, y_, z_, w_: jr.aba(  # noqa: E731
            m, jr.model_integrate(m, x, d), y_, z_, ee, w_)
        return (jr.aba(m, x, y, z, ee, w),) + jax.jacfwd(
            fn, argnums=(0, 1, 2, 3))(jnp.zeros(m.nv), y, z, w)

    ref = jax.device_get(jax.jit(jax.vmap(dyn))(q, v, tau, f))
    args = tuple(map(torch.tensor, (q, v, tau, f)))
    _close(tr.aba(tm, *args[:3], ee, args[3]), ref[0], 1e-5, "aba")
    out = tr.aba_derivatives(tm, *args[:3], ee, args[3])
    exact = tr.aba_derivatives(_float64_model(name, ee),
                               *(x.double() for x in args[:3]), ee,
                               args[3].double())
    _close(out[0], ref[0], 1e-5, "a")
    for (label, tol), o, r, x in zip(ABA_DERIV_TOL.items(), out[1:], ref[1:],
                                     exact[1:]):
        _close(o, r, tol, label)
        _close(o, x, tol, label + ", port against float64")
        _close(r, x, tol, label + ", JAX against float64")


def _float64_model(name, ee):
    """The port's model of robot ``name`` with every constant that
    aba_derivatives reads in float64."""
    m = getattr(T, name)().model
    for fname in ee:
        tr._frame_consts(m, fname, "cpu")
    tr.local_inertias(m, "cpu")
    cache = m.tensors("cpu")
    for key, x in list(cache.items()):
        if isinstance(x, tuple):
            cache[key] = tuple(y.double() for y in x)
        elif x.is_floating_point():
            cache[key] = x.double()
    return m


@functools.lru_cache(maxsize=None)
def _pair(dyn, N=3, t=0.13, seed=3):
    """The JAX and port MPC for Go2 and ``dyn``, one warm-started iterate
    plus seeded noise at time t (mixed contact and swing nodes) on both
    sides, and the JAX package's dyn_residual, linearize, evaluate, bounds
    and tracking targets there, from one jitted call."""
    jrob, trob = J.Go2(), T.Go2()
    jrob.set_gait_sequence("trot", 0.8)
    trob.set_gait_sequence("trot", 0.8)
    jm = J.MPC(jrob, dynamics=dyn, nodes=N)
    tm = T.MPC(trob, dynamics=dyn, nodes=N, device="cpu")
    carry = jm.init_carry()
    vel = jnp.array([0.2, 0.0, 0.0, 0.0, 0.0, 0.1])
    shared = jm.make_shared(carry.x_init, vel, tau_prev=carry.tau_prev)
    sp = jm.make_stage_params(jnp.float32(t))
    rng = np.random.default_rng(seed)
    Z = jm.warm_start_Z(carry.solver_state.Z, sp, shared)
    Z = Z + jnp.asarray(rng.normal(size=Z.shape) * 0.02, dtype=jnp.float32)
    tsp = tm.make_stage_params(torch.tensor([t], dtype=torch.float32))
    tsh = tm.make_shared(torch.tensor(np.asarray(carry.x_init))[None],
                         torch.tensor(np.asarray(vel)))
    ndx = jm.form.ndx

    def ref_fn(Z):
        res = jax.vmap(lambda dx, u, dxn, s: jm.form.dyn_residual(
            shared.x_init, dx, u, dxn, s))(Z[:-1, :ndx], Z[:-1, ndx:],
                                           Z[1:, :ndx], sp)
        return {"dyn_residual": res,
                "linearize": jm.trans.linearize(Z, sp, shared),
                "bounds": jm.trans.bounds(sp, shared),
                "z_des": jm.trans.objective_data(shared).z_des}

    ref = jax.device_get(jax.jit(ref_fn)(Z))
    return jm, tm, torch.tensor(np.asarray(Z))[None], tsp, tsh, ref


# the JAX side of the centroidal formulations compiles for 30-60 s on a
# CPU (jacrev through ccrba and dccrba): slow
FORM_PARAMS = ["whole_body_aba", "whole_body_acc"] + [
    pytest.param(d, marks=pytest.mark.slow)
    for d in ("centroidal_acc", "centroidal_vel")]


@pytest.mark.parametrize("dyn", FORM_PARAMS)
def test_dyn_residual_matches_jax(dyn):
    jm, tm, tZ, tsp, tsh, ref = _pair(dyn)
    ndx = tm.form.ndx
    x0 = tsh.x_init[:, None].expand(-1, jm.nodes, -1)
    out = tm.form.dyn_residual(x0, tZ[:, :-1, :ndx], tZ[:, :-1, ndx:],
                               tZ[:, 1:, :ndx], tsp)
    _close(out[0], ref["dyn_residual"], 1e-5, dyn)


@pytest.mark.parametrize("dyn", FORM_PARAMS)
def test_linearize_bounds_evaluate_match_jax(dyn):
    """linearize against JAX's (split path); evaluate against the port's
    own linearize values (so against JAX's g); bounds, box slots and the
    tracking targets."""
    jm, tm, tZ, tsp, tsh, ref = _pair(dyn)
    assert tm.trans.box_slots.tolist() == np.asarray(
        jm.trans.box_slots).tolist()
    assert tm.trans.c_eye_rows == jm.trans.c_eye_rows
    out = tm.trans.linearize(tZ, tsp, tsh)
    for label, o, r in zip(("g", "G", "B", "C"), out, ref["linearize"]):
        _close(o[0], r, 1e-4, f"{dyn} {label}")
    _close(tm.trans.evaluate(tZ, tsp, tsh), out[0], 1e-4, "evaluate")
    for o, r in zip(tm.trans.bounds(tsp, tsh), ref["bounds"]):
        _close(o[0], r, 0.0, "bounds")
    _close(tm.trans.objective_data(tsh).z_des[0], ref["z_des"], 1e-5,
           "z_des")


# ---- identities of tests/test_formulations.py, on the port ------------------

def _robot(name):
    r = getattr(T, name)()
    r.set_gait_sequence("trot", 0.8)
    return r


def consistent_sample(robot, seed=0):
    """(q, v, a, forces, tau_j), each (1, ...), with a = aba(q, v, tau, f)."""
    rng = np.random.default_rng(seed)
    model = robot.model
    q = np.asarray(robot.q0, dtype=np.float64).copy()
    q[7:] += rng.normal(size=model.nj) * 0.1
    v = rng.normal(size=model.nv) * 0.3
    tau_j = rng.normal(size=model.nj) * 5.0
    ee = list(robot.foot_frames) + (
        [robot.ext_force_frame] if robot.ext_force_frame else [])
    forces = np.zeros(3 * len(ee))
    forces[2:12:3] = tr.GRAVITY * model.total_mass / 4.0
    t = lambda x: torch.tensor(np.asarray(x, np.float32))[None]  # noqa: E731
    q, v, tau_j, forces = t(q), t(v), t(tau_j), t(forces)
    tau = torch.cat([torch.zeros(1, 6), tau_j], -1)
    a = tr.aba(model, q, v, tau, ee, forces)
    return q, v, a, forces, tau_j


def sp_for(dt=0.02):
    one = torch.ones(1)
    return StageParams(dt=torch.full((1,), dt), contact=torch.ones(1, 4),
                       swing=torch.zeros(1, 4), state_mask=one,
                       tau_mask=one, node0_mask=one)


def _dyn_scale(form):
    return tr.GRAVITY * form.mass


def test_whole_body_aba_residual_vanishes():
    form = make_formulation("whole_body_aba", _robot("B2G"))
    q, v, a, forces, tau_j = consistent_sample(form.robot)
    dt = 0.02
    r = form.dyn_residual(torch.cat([q, v], -1), torch.zeros(1, form.ndx),
                          torch.cat([tau_j, forces], -1),
                          torch.cat([v * dt, a * dt], -1), sp_for(dt))[0]
    np.testing.assert_allclose(r[:form.nv], 0.0, atol=1e-4)
    np.testing.assert_allclose(r[form.nv:], 0.0, atol=5e-3)


def test_whole_body_acc_gaps_vanish():
    form = make_formulation("whole_body_acc", _robot("B2G"))
    q, v, a, forces, _ = consistent_sample(form.robot)
    dt = 0.02
    r = form.dyn_residual(torch.cat([q, v], -1), torch.zeros(1, form.ndx),
                          torch.cat([a, forces], -1),
                          torch.cat([v * dt, a * dt], -1), sp_for(dt))[0]
    np.testing.assert_allclose(r[:2 * form.nv], 0.0, atol=1e-4)
    np.testing.assert_allclose(r[2 * form.nv:], 0.0,
                               atol=2e-3 * _dyn_scale(form))


def test_centroidal_acc_gaps_vanish():
    """A a + Adot v - dh = 0 for any motion that obeys the equations of
    motion (Newton-Euler is their base-row projection)."""
    form = make_formulation("centroidal_acc", _robot("Go2"))
    q, v, a, forces, _ = consistent_sample(form.robot)
    dt = 0.02
    r = form.dyn_residual(torch.cat([q, v], -1), torch.zeros(1, form.ndx),
                          torch.cat([a, forces], -1),
                          torch.cat([v * dt, a * dt], -1), sp_for(dt))[0]
    np.testing.assert_allclose(r[:2 * form.nv], 0.0, atol=1e-4)
    np.testing.assert_allclose(r[2 * form.nv:], 0.0,
                               atol=5e-3 * _dyn_scale(form))


def test_centroidal_vel_gaps_and_base_vel():
    form = make_formulation("centroidal_vel", _robot("Go2"))
    q, v, a, forces, _ = consistent_sample(form.robot)
    A = tr.ccrba(form.model, q)
    h = tr.mv(A, v) / form.mass
    hdot = form.com_dynamics(q, forces) / form.mass
    dt = 0.02
    r = form.dyn_residual(torch.cat([h, q], -1), torch.zeros(1, form.ndx),
                          torch.cat([v, forces], -1),
                          torch.cat([hdot * dt, v * dt], -1), sp_for(dt))
    np.testing.assert_allclose(r, 0.0, atol=5e-3 * _dyn_scale(form))
    v_b = form.base_vel_dynamics(h, q, v[:, 6:])
    np.testing.assert_allclose(v_b, v[:, :6], atol=2e-3)


def test_base_acc_dynamics_consistency():
    """Both base_acc_dynamics reproduce ABA's base acceleration from
    joint accelerations that obey the equations of motion."""
    b2g = _robot("B2G")
    q, v, a, forces, _ = consistent_sample(b2g)
    for name in ["centroidal_acc", "whole_body_acc"]:
        form = make_formulation(name, b2g)
        a_b = form.base_acc_dynamics(q, v, a[:, 6:], forces)
        np.testing.assert_allclose(a_b, a[:, :6], rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("name", ROBOTS)
def test_factory_dims_weights_all_formulations(name):
    trob, jrob = _robot(name), getattr(J, name)()
    jrob.set_gait_sequence("trot", 0.8)
    for dyn in ["centroidal_vel", "centroidal_acc", "whole_body_acc",
                "whole_body_rnea", "whole_body_aba"]:
        form = make_formulation(dyn, trob)
        ref = jmake(dyn, jrob)
        for attr in ("nx", "ndx", "nu", "n_dyn", "n_prop_rows", "f_idx",
                     "tau_idx"):
            assert getattr(form, attr) == getattr(ref, attr), (dyn, attr)
        assert np.array_equal(form.dyn_nl_idx(), ref.dyn_nl_idx())
        for o, r in zip(form.default_weights(), ref.default_weights()):
            np.testing.assert_array_equal(o, r)
        x = torch.tensor(form.x_nom(), dtype=torch.float32)[None]
        dx = torch.zeros(1, form.ndx)
        np.testing.assert_allclose(form.integrate(x, dx), x, atol=1e-6)
        np.testing.assert_allclose(form.difference(x, x), 0.0, atol=1e-6)
    with pytest.raises(ValueError):
        make_formulation("bogus", trob)


@pytest.mark.parametrize("dyn,kwargs", [
    ("centroidal_vel", {"include_base": False}),
    ("centroidal_acc", {"include_base": False}),
    ("whole_body_acc", {"include_base": False}),
    ("whole_body_rnea", {"include_acc": False})])
def test_unported_variants_name_their_item(dyn, kwargs):
    """The variants that raised NotImplementedError naming ROADMAP item 13b
    until they were ported: each now builds with the JAX package's layout
    and no split linearize (tests/test_torch_variants.py holds them
    against JAX)."""
    trob, jrob = _robot("Go2"), getattr(J, "Go2")()
    jrob.set_gait_sequence("trot", 0.8)
    form, ref = make_formulation(dyn, trob, **kwargs), jmake(dyn, jrob,
                                                             **kwargs)
    for attr in ("nx", "ndx", "nu", "n_dyn", "n_prop_rows", "f_idx",
                 "tau_idx"):
        assert getattr(form, attr) == getattr(ref, attr), (dyn, attr)
    assert form.dyn_nl_idx() is None and ref.dyn_nl_idx() is None
    assert (form.dx_next_pattern() is None) == (ref.dx_next_pattern()
                                                is None)


@pytest.mark.parametrize("name", ROBOTS)
def test_euler_base_chart_names_its_item(name):
    """The Euler-ZYX base, which raised NotImplementedError naming item 13b
    until it was ported, builds as the JAX package's does
    (tests/test_torch_euler.py holds it against JAX)."""
    trob, jrob = (getattr(m, name)(use_quaternion=False) for m in (T, J))
    assert trob.model.base_type == jrob.model.base_type == "euler_zyx"
    assert (trob.nq, trob.nv) == (jrob.nq, jrob.nv)
    np.testing.assert_allclose(trob.q0, jrob.q0, atol=1e-12)
