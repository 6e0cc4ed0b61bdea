"""The Euler-ZYX base chart (use_quaternion=False) in the port against
tpu_locoman, on the same seeded inputs (Go2 and B2G, B=4), mirroring
tests/test_euler_base.py.

Tolerances: the chart functions and kinematics atol 1e-5 (O(1)
quantities, f32 roundoff); torques, mass matrices, centroidal maps atol
1e-5 * (max|ref| + 1); derivatives (ABA's, the frame Jacobian) atol
2e-4 * (max|ref| + 1), as tests/test_torch_rbda.py holds them; the
identities of tests/test_euler_base.py at its own tolerances (EOM against
RNEA 3e-3 * scale, ABA's inverse 5e-3). JAX's jacfwd of rnea and aba is
recorded in tests/data/torch_euler_jacobians_jax.npz, which
``JAX_PLATFORMS=cpu python tests/test_torch_euler.py`` rewrites."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman import lie as jl  # noqa: E402
from tpu_locoman import rbda as jr  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import lie as tl  # noqa: E402
from tpu_locoman_torch import rbda as tr  # noqa: E402

ROBOTS = ["Go2", "B2G"]
# jax.jacfwd of the JAX package's rnea and aba on _setup's inputs, written
# by running this file as a script
JACOBIANS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "torch_euler_jacobians_jax.npz")
FEET = ["FR_foot", "FL_foot", "RR_foot", "RL_foot"]


def _setup(name, B=4, seed=11):
    jrob = getattr(J, name)(use_quaternion=False)
    trob = getattr(T, name)(use_quaternion=False)
    m = jrob.model
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(jrob.q0, np.float32), (B, 1))
    q[:, :3] += rng.normal(size=(B, 3)).astype(np.float32) * 0.1
    q[:, 3:6] = rng.normal(size=(B, 3)).astype(np.float32) * 0.3
    q[:, 6:] += rng.normal(size=(B, m.nj)).astype(np.float32) * 0.2
    v = rng.normal(size=(B, m.nv)).astype(np.float32) * 0.4
    a = rng.normal(size=(B, m.nv)).astype(np.float32) * 0.4
    f = rng.normal(size=(B, 12)).astype(np.float32) * 20.0
    return jrob, trob, q, v, a, f


def _close(out, ref, rel=None, atol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    tol = atol if rel is None else rel * (np.abs(ref).max() + 1.0)
    np.testing.assert_allclose(out, ref, atol=tol)


def _t(*xs):
    return [torch.tensor(x) for x in xs]


@pytest.mark.parametrize("name", ["Go2", "B2", "B2G", "B2G_arm_locked"])
def test_robots_take_the_keyword(name):
    kw = {"ignore_arm": True} if name == "B2G_arm_locked" else {}
    cls = "B2G" if name == "B2G_arm_locked" else name
    jrob = getattr(J, cls)(use_quaternion=False, **kw)
    trob = getattr(T, cls)(use_quaternion=False, **kw)
    assert trob.model.base_type == "euler_zyx"
    assert (trob.nq, trob.nv, trob.nj) == (jrob.nq, jrob.nv, jrob.nj)
    assert trob.nq == getattr(T, cls)(**kw).nq - 1
    np.testing.assert_allclose(trob.q0, jrob.q0, atol=1e-12)
    for k, ref in jrob.model.reference_configurations.items():
        np.testing.assert_allclose(trob.model.reference_configurations[k],
                                   ref, atol=1e-12)


def test_chart_functions():
    rng = np.random.default_rng(0)
    e = rng.normal(size=(6, 3)).astype(np.float32) * 0.5
    quat = rng.normal(size=(6, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    R = jax.vmap(jl.euler_zyx_to_matrix)(e)
    _close(tl.euler_zyx_to_matrix(torch.tensor(e)), R)
    _close(tl.matrix_to_euler_zyx(torch.tensor(np.asarray(R))),
           jax.vmap(jl.matrix_to_euler_zyx)(R))
    _close(tl.quat_to_euler_zyx(torch.tensor(quat)),
           jax.vmap(jl.quat_to_euler_zyx)(quat))
    # the gimbal guard: |R[2, 0]| above 1 by roundoff stays finite
    Rb = np.eye(3, dtype=np.float32)[None].repeat(2, 0)
    Rb[:, 2, 0] = [1.0000001, -1.0000001]
    out = tl.matrix_to_euler_zyx(torch.tensor(Rb))
    assert torch.isfinite(out).all()
    _close(out, jax.vmap(jl.matrix_to_euler_zyx)(Rb))
    q0, dq = rng.normal(size=(2, 4, 18)).astype(np.float32)
    _close(tl.integrate_q_euler(torch.tensor(q0), torch.tensor(dq)),
           jl.integrate_q_euler(q0, dq))
    _close(tl.difference_q_euler(torch.tensor(q0), torch.tensor(dq)),
           jl.difference_q_euler(q0, dq))


@pytest.mark.parametrize("name", ROBOTS)
def test_base_chart_maps(name):
    jrob, trob, q, v, a, _ = _setup(name)
    m, tm = jrob.model, trob.model
    tq, tv, ta = _t(q, v, a)
    _close(tr._base_vloc(tm, tq, tv),
           jax.vmap(lambda *x: jr._base_vloc(m, *x))(q, v))
    _close(tr._base_aloc(tm, tq, tv, ta),
           jax.vmap(lambda *x: jr._base_aloc(m, *x))(q, v, a))
    _close(tr._base_jac(tm, tq), jax.vmap(lambda x: jr._base_jac(m, x))(q))
    _close(tr._chart_T(tm, tq), jax.vmap(lambda x: jr._chart_T(m, x))(q))
    assert tr._euler(tm) and not tr._euler(getattr(T, name)().model)
    dq = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    _close(tr.model_integrate(tm, tq, torch.tensor(dq)),
           jr.model_integrate(m, q, dq))
    _close(tr.model_difference(tm, tq, torch.tensor(q + dq)),
           jax.vmap(lambda x, y: jr.model_difference(m, x, y))(q, q + dq))


@pytest.mark.parametrize("name", ROBOTS)
def test_fk_rnea_and_maps_through_the_chart(name):
    jrob, trob, q, v, a, f = _setup(name)
    m, tm = jrob.model, trob.model
    tq, tv, ta, tf = _t(q, v, a, f)
    R, p, vl = jax.vmap(lambda *x: jr.fk_vel(m, *x))(q, v)
    tR, tp, tvl = tr.fk_vel(tm, tq, tv)
    _close(tR, np.stack(R, 1))
    _close(tp, np.stack(p, 1))
    _close(tvl, np.stack(vl, 1), rel=1e-5)
    _close(tr.frame_position(tm, "FR_foot", tq),
           jax.vmap(lambda x: jr.frame_position(m, "FR_foot", x))(q))
    _close(tr.rnea(tm, tq, tv, ta, FEET, tf),
           jax.vmap(lambda *x: jr.rnea(m, *x[:3], FEET, x[3]))(q, v, a, f),
           rel=1e-5)
    _close(tr.nonlinear_effects(tm, tq, tv),
           jax.vmap(lambda *x: jr.nonlinear_effects(m, *x))(q, v), rel=1e-5)
    _close(tr.crba(tm, tq), jax.vmap(lambda x: jr.crba(m, x))(q), rel=1e-5)
    _close(tr.ccrba(tm, tq), jax.vmap(lambda x: jr.ccrba(m, x))(q), rel=1e-5)
    _close(tr.dccrba(tm, tq, tv),
           jax.vmap(lambda *x: jr.dccrba(m, *x))(q, v), rel=1e-5)
    _close(tr.frame_jacobian_lwa(tm, "FL_foot", tq),
           jax.vmap(lambda x: jr.frame_jacobian_lwa(m, "FL_foot", x))(q),
           rel=2e-4)


@pytest.mark.parametrize("name", ROBOTS)
def test_rnea_matches_freeflyer_through_chart(name):
    """The Euler base's torques are J^T times the free-flyer's at the same
    physical state (tests/test_euler_base.py)."""
    _, trob, q, v, a, f = _setup(name)
    tq, tv, ta, tf = _t(q, v, a, f)
    tm = trob.model
    tmq = getattr(T, name)().model
    R = tl.euler_zyx_to_matrix(tq[:, 3:6])
    quat = torch.tensor(np.asarray(jax.vmap(
        lambda Rm: jl.so3_exp_quat(jl.so3_log_matrix(Rm)))(R.numpy())))
    q_ff = torch.cat([tq[:, :3], quat, tq[:, 6:]], -1)
    v_ff = torch.cat([tr._base_vloc(tm, tq, tv), tv[:, 6:]], -1)
    a_ff = torch.cat([tr._base_aloc(tm, tq, tv, ta), ta[:, 6:]], -1)
    tau_e = tr.rnea(tm, tq, tv, ta, FEET, tf)
    tau_f = tr.rnea(tmq, q_ff, v_ff, a_ff, FEET, tf)
    Jb = tr._base_jac(tm, tq)
    ref = torch.cat([tr.mv(Jb.transpose(-1, -2), tau_f[:, :6]),
                     tau_f[:, 6:]], -1)
    _close(tau_e, ref, rel=2e-3)


@pytest.mark.parametrize("name", ROBOTS)
def test_eom_and_aba_inverse(name):
    _, trob, q, v, a, f = _setup(name)
    tm = trob.model
    tq, tv, ta, tf = _t(q, v, a, f)
    M = tr.crba(tm, tq)
    nle = tr.nonlinear_effects(tm, tq, tv)
    tau_ext = torch.zeros_like(nle)
    for idx, fr in enumerate(FEET):
        Jf = tr.frame_jacobian_lwa(tm, fr, tq)
        tau_ext = tau_ext + tr.mv(Jf[:, :3].transpose(-1, -2),
                                  tf[:, 3 * idx:3 * idx + 3])
    tau_eom = tr.mv(M, ta) + nle - tau_ext
    tau_rnea = tr.rnea(tm, tq, tv, ta, FEET, tf)
    _close(tau_eom, tau_rnea, atol=3e-3 * (float(tau_eom.abs().max()) + 1))
    zf = torch.zeros_like(tf)
    tau = tr.rnea(tm, tq, tv, ta, FEET, zf)
    a_rt = tr.aba(tm, tq, tv, tau, FEET, zf)
    np.testing.assert_allclose(a_rt.numpy(), a, rtol=5e-3, atol=5e-3)


def _jax_jacobians(name):
    """jax.jacfwd of the JAX package's rnea and aba on _setup(name)'s
    inputs: (tau, drnea/d(q, v, a, f), daba/d(q, v, tau, f))."""
    jrob, _, q, v, a, f = _setup(name)
    m = jrob.model
    drnea = jax.vmap(jax.jacfwd(lambda *x: jr.rnea(m, *x[:3], FEET, x[3]),
                                argnums=(0, 1, 2, 3)))(q, v, a, f)
    tau = np.asarray(jax.vmap(lambda *x: jr.rnea(m, *x[:3], FEET, x[3]))(
        q, v, a, f))
    daba = jax.vmap(jax.jacfwd(lambda *x: jr.aba(m, *x[:3], FEET, x[3]),
                               argnums=(0, 1, 2, 3)))(q, v, tau, f)
    out = {"tau": tau}
    for k, blocks in (("drnea", drnea), ("daba", daba)):
        out.update({f"{k}{i}": np.asarray(b) for i, b in enumerate(blocks)})
    return out


def _jacobians_recording():
    """_jax_jacobians of every robot, as JACOBIANS holds them."""
    return {f"{name}/{k}": v for name in ROBOTS
            for k, v in _jax_jacobians(name).items()}


def _record_jacobians():
    """Write JACOBIANS."""
    np.savez_compressed(JACOBIANS, **_jacobians_recording())
    print("wrote", JACOBIANS)


@pytest.mark.parametrize("name", ROBOTS)
def test_aba_and_rnea_jacobians_match_jax(name):
    """On the Euler base the derivative blocks come from forward-mode AD
    over the plain recursion (no kernel), in chart coordinates: against
    jax.jacfwd of the JAX package's rnea and aba, recorded in JACOBIANS
    (op by op, jax.jacfwd of the recursions takes one to three minutes of
    the CPU per robot)."""
    _, trob, q, v, a, f = _setup(name)
    tm = trob.model
    with np.load(JACOBIANS) as d:
        ref = {k.split("/", 1)[1]: d[k] for k in d.files
               if k.startswith(name + "/")}
    tq, tv, ta, tf = _t(q, v, a, f)
    D = tr.rnea_jacobians(tm, tq, tv, ta, FEET, tf)
    for i, d in enumerate(D):
        _close(d, ref[f"drnea{i}"], rel=2e-4)
    out = tr.aba_derivatives(tm, tq, tv, torch.tensor(ref["tau"]), FEET, tf)
    _close(out[0], a, rel=5e-3)
    for i, o in enumerate(out[1:]):
        _close(o, ref[f"daba{i}"], rel=2e-3)

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _record_jacobians()
