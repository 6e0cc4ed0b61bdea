"""The port's rigid-body functions against tpu_locoman.rbda, B2G and Go2 at
B=5, elementwise on the same seeded inputs.

Tolerances: kinematics atol 1e-5 (O(1) quantities, f32 roundoff); RNEA
atol 1e-5 * (max|ref| + 1) (torques reach ~1e3 N m); the analytic
derivatives atol 2e-4 * (max|ref| + 1), as tests/test_pallas_rbda.py holds
the Pallas kernel (long masked sums reorder the f32 additions)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman import rbda as jr  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import rbda as tr  # noqa: E402
from tpu_locoman_torch import rnea_derivs as trd  # noqa: E402

ROBOTS = ["B2G", "Go2"]


def _setup(name, B=5, seed=0):
    jrob, trob = getattr(J, name)(), getattr(T, name)()
    m = jrob.model
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(jrob.q0, np.float32), (B, 1))
    q[:, :3] += rng.standard_normal((B, 3)).astype(np.float32) * 0.1
    quat = rng.standard_normal((B, 4)).astype(np.float32)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] += rng.standard_normal((B, m.nq - 7)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, m.nv)).astype(np.float32)
    a = rng.standard_normal((B, m.nv)).astype(np.float32)
    ee = tuple(jrob.FOOT_FRAMES) + (
        (jrob.ext_force_frame,) if jrob.ext_force_frame else ())
    f = rng.standard_normal((B, 3 * len(ee))).astype(np.float32) * 30.0
    return jrob, trob, q, v, a, ee, f


def _close(out, ref, rel=None, atol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    tol = atol if rel is None else rel * (np.abs(ref).max() + 1.0)
    np.testing.assert_allclose(out, ref, atol=tol)


@pytest.mark.parametrize("name", ROBOTS)
def test_fk_and_fk_vel(name):
    jrob, trob, q, v, *_ = _setup(name)
    m = jrob.model
    R, p, vl = jax.vmap(lambda q_, v_: jr.fk_vel(m, q_, v_))(q, v)
    tR, tp, tvl = tr.fk_vel(trob.model, torch.tensor(q), torch.tensor(v))
    _close(tR, np.stack(R, 1))
    _close(tp, np.stack(p, 1))
    _close(tvl, np.stack(vl, 1), rel=1e-5)


@pytest.mark.parametrize("name", ROBOTS)
def test_frame_velocity_from(name):
    jrob, trob, q, v, *_ = _setup(name, seed=1)
    m = jrob.model
    frame = "gripperStator" if name == "B2G" else "FR_foot"
    base = jrob.base_frame

    def one(q_, v_):
        kin = jr.fk_vel(m, q_, v_)
        return (jr.frame_velocity_from(m, frame, *kin),
                jr.frame_velocity_from(m, frame, *kin, relative_to_base=True,
                                       base_frame=base))

    ref = jax.vmap(one)(q, v)
    kin = tr.fk_vel(trob.model, torch.tensor(q), torch.tensor(v))
    out = (tr.frame_velocity_from(trob.model, frame, *kin),
           tr.frame_velocity_from(trob.model, frame, *kin,
                                  relative_to_base=True, base_frame=base))
    for o, r in zip(out, ref):
        _close(o, r, rel=1e-5)


@pytest.mark.parametrize("name", ROBOTS)
def test_rnea_with_forces(name):
    jrob, trob, q, v, a, ee, f = _setup(name, seed=2)
    m = jrob.model
    ref = jax.vmap(lambda *x: jr.rnea(m, *x[:3], ee, x[3]))(q, v, a, f)
    out = tr.rnea(trob.model, torch.tensor(q), torch.tensor(v),
                  torch.tensor(a), ee, torch.tensor(f))
    _close(out, ref, rel=1e-5)


@pytest.mark.parametrize("name", ROBOTS)
def test_frame_kin_jac(name):
    jrob, trob, q, v, *_ = _setup(name, seed=3)
    m = jrob.model
    frames = tuple(jrob.FOOT_FRAMES)
    if name == "B2G":
        frames += ("gripperStator", "base_link")
    ref = jax.vmap(lambda q_, v_: jr.frame_kin_jac(m, frames, q_, v_))(q, v)
    out = tr.frame_kin_jac(trob.model, frames, torch.tensor(q), torch.tensor(v))
    for k in ref:
        _close(out[k], ref[k], rel=1e-5)


@pytest.mark.parametrize("with_forces", [True, False])
@pytest.mark.parametrize("name", ROBOTS)
def test_rnea_derivatives_plain_matches_per_element(name, with_forces):
    jrob, trob, q, v, a, ee, f = _setup(name, seed=4)
    m = jrob.model
    B = q.shape[0]
    if with_forces:
        ref = [jr.rnea_derivatives(m, q[i], v[i], a[i], ee, f[i])
               for i in range(B)]
        out = trd.rnea_derivatives_plain(trob.model, torch.tensor(q),
                                         torch.tensor(v), torch.tensor(a), ee,
                                         torch.tensor(f))
    else:
        ref = [jr.rnea_derivatives(m, q[i], v[i], a[i])[:3] for i in range(B)]
        out = trd.rnea_derivatives_plain(trob.model, torch.tensor(q),
                                         torch.tensor(v), torch.tensor(a))
    assert len(out) == (4 if with_forces else 3)
    for k, o in enumerate(out):
        r = np.stack([np.asarray(x[k]) for x in ref])
        _close(o, r, rel=2e-4)


def test_integrate_tangent_map_matches_jax_ad():
    """The chart map the linearization composes with the local-tangent
    Jacobians: JAX's AD through integrate_q then _coord_to_tangent."""
    jrob, trob, q, *_ = _setup("Go2", seed=5)
    rng = np.random.default_rng(5)
    dq = (rng.standard_normal((q.shape[0], jrob.model.nv)) * 0.2
          ).astype(np.float32)

    def one(q_, dq_):
        J_ = jax.jacfwd(lambda d: J.lie.integrate_q(q_, d))(dq_)
        qn = J.lie.integrate_q(q_, dq_)
        return jax.vmap(lambda col: jr._coord_to_tangent(jrob.model, qn, col),
                        in_axes=1, out_axes=1)(J_)

    ref = jax.vmap(one)(q, dq)
    out = tr.integrate_tangent_map(torch.tensor(q), torch.tensor(dq))
    _close(out, np.asarray(ref)[:, :6, :6])
    np.testing.assert_allclose(np.asarray(ref)[:, 6:, 6:],
                               np.broadcast_to(np.eye(jrob.model.nj),
                                               (q.shape[0], 12, 12)),
                               atol=1e-6)
