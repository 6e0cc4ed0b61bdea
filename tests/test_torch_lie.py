"""The port's Lie-group functions against tpu_locoman.lie on the same inputs:
random, near the identity, and with theta^2 just below and just above the
small-angle threshold _EPS = 1e-2. Tolerance: atol 1e-5 (f32 roundoff of
O(1) quantities; both sides use the same branch formulas)."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_locoman import lie as jl  # noqa: E402
from tpu_locoman_torch import lie as tl  # noqa: E402

ATOL = 1e-5


def _rotvecs(rng, n):
    """Random, near-identity and threshold-straddling rotation vectors."""
    rand = rng.standard_normal((n, 3)) * 1.2
    tiny = rng.standard_normal((n, 3)) * 1e-4
    axis = rng.standard_normal((2 * n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    below = axis[:n] * np.sqrt(0.99e-2)
    above = axis[n:] * np.sqrt(1.01e-2)
    return np.concatenate([rand, tiny, below, above, np.zeros((1, 3))]
                          ).astype(np.float32)


def _quats(rng, n):
    w = _rotvecs(rng, n)
    return np.asarray(jax.vmap(jl.so3_exp_quat)(w)), w


def _cmp(out, ref):
    if isinstance(ref, (tuple, list)):
        for o, r in zip(out, ref):
            _cmp(o, r)
        return
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=ATOL)


def _twists(rng, n):
    w = _rotvecs(rng, n)
    v = rng.standard_normal(w.shape).astype(np.float32)
    return np.concatenate([v, w], axis=1)


def _q(rng, n, nj=3):
    quat, _ = _quats(rng, n)
    m = quat.shape[0]
    p = rng.standard_normal((m, 3)).astype(np.float32)
    j = rng.standard_normal((m, nj)).astype(np.float32)
    return np.concatenate([p, quat, j], axis=1)


CASES = {
    "quat_mul": lambda r: (_quats(r, 6)[0], _quats(r, 6)[0]),
    "quat_conj": lambda r: (_quats(r, 6)[0],),
    "quat_normalize": lambda r: (_quats(r, 6)[0] * 1.7,),
    "quat_to_matrix": lambda r: (_quats(r, 6)[0],),
    "quat_rotate": lambda r: (_quats(r, 6)[0],
                              r.standard_normal((25, 3)).astype(np.float32)),
    "skew": lambda r: (_rotvecs(r, 6),),
    "so3_exp_quat": lambda r: (_rotvecs(r, 6),),
    "quat_log": lambda r: (_quats(r, 6)[0] * np.where(
        r.random((25, 1)) < 0.5, -1.0, 1.0).astype(np.float32),),
    "se3_exp": lambda r: (_twists(r, 6),),
    "se3_log": lambda r: (r.standard_normal((25, 3)).astype(np.float32),
                          _quats(r, 6)[0]),
    "freeflyer_integrate": lambda r: (_q(r, 6)[:, :7], _twists(r, 6)),
    "freeflyer_difference": lambda r: (_q(r, 6)[:, :7], _q(r, 6)[:, :7]),
    "integrate_q": lambda r: (_q(r, 6), np.concatenate(
        [_twists(r, 6), r.standard_normal((25, 3)).astype(np.float32)], 1)),
    "difference_q": lambda r: (_q(r, 6), _q(r, 6)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lie_matches_jax(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    args = CASES[name](rng)
    ref = jax.vmap(getattr(jl, name))(*[jnp.asarray(a) for a in args])
    out = getattr(tl, name)(*[torch.tensor(a) for a in args])
    _cmp(out, ref)


def test_integrate_difference_roundtrip_near_threshold():
    """difference(q, integrate(q, dq)) == dq across the _EPS crossover."""
    rng = np.random.default_rng(7)
    q = torch.tensor(_q(rng, 6))
    dq = torch.tensor(np.concatenate(
        [_twists(rng, 6), rng.standard_normal((25, 3)).astype(np.float32)], 1))
    back = tl.difference_q(q, tl.integrate_q(q, dq))
    np.testing.assert_allclose(back.numpy(), dq.numpy(), atol=2e-5)
