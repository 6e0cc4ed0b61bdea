"""The port's world-frame variants (rnea_wf, crba_wf, ccrba_wf) against
tpu_locoman's and against the port's own recursions (rnea, crba, ccrba),
Go2 and B2G at B=4 on the same seeded inputs, mirroring
tests/test_rbda_worldframe.py.

Tolerances: against JAX, 1e-5 * (max|ref| + 1) (the same masked sums in
f32); against the recursion, tests/test_rbda_worldframe.py's 5e-4 *
scale (another order of the f32 sums)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman import rbda as jr  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import rbda as tr  # noqa: E402

FEET = ("FR_foot", "FL_foot", "RR_foot", "RL_foot")


@pytest.fixture(scope="module", params=["Go2", "B2G"])
def sample(request):
    jrob, trob = getattr(J, request.param)(), getattr(T, request.param)()
    m = jrob.model
    rng = np.random.default_rng(7)
    B = 4
    q = np.tile(np.asarray(jrob.q0, np.float64), (B, 1))
    q[:, :3] += rng.normal(size=(B, 3)) * 0.2
    quat = rng.normal(size=(B, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] += rng.normal(size=(B, m.nj)) * 0.3
    v = rng.normal(size=(B, m.nv))
    a = rng.normal(size=(B, m.nv))
    f = rng.normal(size=(B, 12)) * 30.0
    arrs = [np.asarray(x, np.float32) for x in (q, v, a, f)]
    return m, trob.model, arrs, [torch.tensor(x) for x in arrs]


def _close(out, ref, atol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=atol)


def _scale(x, plus=0.0):
    return float(np.abs(np.asarray(x)).max()) + plus


@pytest.mark.parametrize("forces", [True, False])
def test_rnea_wf(sample, forces):
    m, tm, (q, v, a, f), (tq, tv, ta, tf) = sample
    ee, tfw = (FEET, tf) if forces else ((), None)
    out = tr.rnea_wf(tm, tq, tv, ta, ee, tfw)
    ref = jax.vmap(lambda *x: jr.rnea_wf(m, *x[:3], ee, x[3] if forces
                                         else None))(q, v, a, f)
    _close(out, ref, 1e-5 * _scale(ref, 1.0))
    rec = tr.rnea(tm, tq, tv, ta, ee, tfw)
    _close(out, rec, 5e-4 * _scale(rec, 1.0))


def test_crba_wf_and_ccrba_wf(sample):
    m, tm, (q, *_), (tq, *_) = sample
    M = tr.crba_wf(tm, tq)
    _close(M, jax.vmap(lambda x: jr.crba_wf(m, x))(q), 1e-5 * _scale(M, 1.0))
    rec = tr.crba(tm, tq)
    _close(M, rec, 5e-4 * _scale(rec))
    A = tr.ccrba_wf(tm, tq)
    _close(A, jax.vmap(lambda x: jr.ccrba_wf(m, x))(q), 1e-5 * _scale(A, 1.0))
    rec = tr.ccrba(tm, tq)
    _close(A, rec, 5e-4 * _scale(rec))


def test_world_kinematics_and_external_forces(sample):
    m, tm, (q, v, _, f), (tq, tv, _, tf) = sample
    out = tr._world_kinematics(tm, tq, tv)
    ref = jax.vmap(lambda x, y: jr._world_kinematics(m, x, y))(q, v)
    for name, o, r in zip(("R_w", "p_w", "anc", "Sw", "sv", "V", "sdot"),
                          out, ref):
        r = np.stack(r, 1) if isinstance(r, list) else np.asarray(r)
        if name == "anc":
            r = r[0]
        _close(o, r, 1e-5 * _scale(r, 1.0))
    R_w = tr.fk(tm, tq)[0]
    ext = tr.external_joint_forces(tm, FEET, tf, list(R_w.unbind(-3)))
    jR = jax.vmap(lambda x: jr.fk(m, x)[0])(q)
    jext = jax.vmap(lambda Rl, fw: jr.external_joint_forces(
        m, FEET, fw, list(Rl)))(jR, f)
    assert set(ext) == set(jext)
    for k in ext:
        _close(ext[k], jext[k], 1e-5 * _scale(jext[k], 1.0))
    for fr in FEET:
        _close(tr.frame_position(tm, fr, tq),
               jax.vmap(lambda x: jr.frame_position(m, fr, x))(q), 1e-5)
