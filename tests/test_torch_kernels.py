"""The plain PyTorch versions of the port's three kernels against the Pallas
TPU kernels they replace, run in interpret mode as the JAX package's own
tests run them off-TPU (tests/test_pallas_rbda.py, tests/test_qp.py).

The CUDA kernels themselves run only on the GPU; chip_smoke.py holds each
one against these plain versions there. Here: the wrappers' CPU dispatch.

Tolerances: K2 atol 2e-4 * (max|ref| + 1) as test_pallas_rbda.py; K1 and
the factorize+solve path 1e-4 * (max|ref| + 1) as test_qp.py (the plain
version and the Pallas kernel share the algorithm, not the f32 summation
order); K3 atol 1e-5 as test_qp.py's test_pallas_factorize_matches_xla."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman.pallas_rbda import rnea_derivatives_pallas  # noqa: E402
from tpu_locoman.solver import qp as jqp  # noqa: E402
from tpu_locoman.solver.pallas_base import chol_inv_base_batched  # noqa: E402
from tpu_locoman.solver.pallas_fac import factorize_pallas  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import rnea_derivs  # noqa: E402
from tpu_locoman_torch.solver import chol_base, fac_whole  # noqa: E402
from tpu_locoman_torch.solver import qp as tqp  # noqa: E402


def _spd(rng, B, b):
    A = rng.standard_normal((B, b, b)).astype(np.float32)
    return A @ A.transpose(0, 2, 1) + b * np.eye(b, dtype=np.float32)


@pytest.mark.parametrize("with_forces", [True, False])
def test_k2_plain_matches_pallas_interpret(with_forces):
    jrob, trob = J.B2G(), T.B2G()
    m = jrob.model
    B = 5  # the Pallas pad-to-128 path
    rng = np.random.default_rng(11)
    q = np.tile(np.asarray(jrob.q0, np.float32), (B, 1))
    quat = rng.standard_normal((B, 4)).astype(np.float32)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] += rng.standard_normal((B, m.nq - 7)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, m.nv)).astype(np.float32)
    a = rng.standard_normal((B, m.nv)).astype(np.float32)
    ee = tuple(jrob.FOOT_FRAMES) + (jrob.ext_force_frame,)
    f = rng.standard_normal((B, 3 * len(ee))).astype(np.float32) * 30.0
    if with_forces:
        ref = rnea_derivatives_pallas(m, q, v, a, ee, f, interpret=True)
        args = (torch.tensor(q), torch.tensor(v), torch.tensor(a), ee,
                torch.tensor(f))
    else:
        ref = rnea_derivatives_pallas(m, q, v, a, interpret=True)
        args = (torch.tensor(q), torch.tensor(v), torch.tensor(a))
    before = rnea_derivs.launches
    out = rnea_derivs.rnea_derivatives(trob.model, *args)
    assert rnea_derivs.launches == before  # CPU tensors: plain version
    assert len(out) == len(ref) == (4 if with_forces else 3)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r,
                                   atol=2e-4 * (np.abs(r).max() + 1))


@pytest.mark.parametrize("B", [5, 130])
@pytest.mark.parametrize("b", [13, 14, 16])
def test_k1_plain_matches_pallas_interpret(b, B):
    S = _spd(np.random.default_rng(b * 1000 + B), B, b)
    ref = np.asarray(chol_inv_base_batched(jnp.asarray(S), interpret=True))
    before = chol_base.launches
    out = chol_base.chol_inv_base(torch.tensor(S)).numpy()
    assert chol_base.launches == before
    np.testing.assert_allclose(out, ref, atol=1e-4 * (np.abs(ref).max() + 1))
    # and it is the inverse Cholesky factor: Linv S Linv^T = I
    eye = np.einsum("bij,bjk,blk->bil", out.astype(np.float64), S, out)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(b), eye.shape),
                               atol=1e-3)


def test_k1_plain_keeps_nan_for_non_spd():
    S = np.tile(np.eye(14, dtype=np.float32), (3, 1, 1))
    S[1] *= -1.0
    out = chol_base.chol_inv_base(torch.tensor(S))
    assert torch.isnan(out[1]).any() and torch.isfinite(out[0]).all()


def test_factorize_cholinv_pb_matches_jax_interpret():
    """factorize(chol_impl="cholinv_pb") + solve_factorized against the JAX
    cholinv_pb path vmapped over scenarios (its Pallas base kernel fires in
    interpret mode through the custom_vmap rule, as test_qp.py runs it),
    with skinny couplings U (s, k) as assemble_blocks produces them."""
    rng = np.random.default_rng(12)
    Bs, K, s, k = 3, 5, 40, 24
    A = rng.standard_normal((Bs, K, s, s)).astype(np.float32)
    H = A @ A.transpose(0, 1, 3, 2) + 10 * np.eye(s, dtype=np.float32)
    U = (0.1 * rng.standard_normal((Bs, K - 1, s, k))).astype(np.float32)
    b = rng.standard_normal((Bs, K, s)).astype(np.float32)
    fpb = jax.vmap(functools.partial(jqp.factorize, chol_impl="cholinv_pb"))
    fac = fpb(jnp.asarray(H), jnp.asarray(U))
    ref = np.asarray(jax.vmap(jqp.solve_factorized)(fac, jnp.asarray(b)))
    tfac = tqp.factorize(torch.tensor(H), torch.tensor(U),
                         chol_impl="cholinv_pb")
    for name in ("Linv", "W", "V"):
        r = np.asarray(getattr(fac, name))
        np.testing.assert_allclose(getattr(tfac, name).numpy(), r,
                                   atol=1e-4 * (np.abs(r).max() + 1),
                                   err_msg=name)
    out = tqp.solve_factorized(tfac, torch.tensor(b)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4 * (np.abs(ref).max() + 1))


def test_k3_plain_matches_pallas_interpret():
    """K3's plain version (``factorize_whole`` on CPU tensors) against
    ``factorize_pallas`` in interpret mode at test_qp.py's shape: K=6,
    s=37 (odd: uneven recursion splits), a batch of 2 looped on the JAX
    side. Linv, W, V and solve_factorized. Measured gap: at most 2.4e-7
    absolute; held at 1e-5 as test_qp.py."""
    rng = np.random.default_rng(7)
    Bs, K, s = 2, 6, 37
    A = rng.normal(size=(Bs, K, s, s)).astype(np.float32)
    H = np.einsum("bnij,bnkj->bnik", A, A) / s + 3.0 * np.eye(s, dtype=np.float32)
    U = (0.1 * rng.normal(size=(Bs, K - 1, s, s))).astype(np.float32)
    b = rng.normal(size=(Bs, K, s)).astype(np.float32)
    before = fac_whole.launches
    fac = fac_whole.factorize_whole(torch.tensor(H), torch.tensor(U))
    assert fac_whole.launches == before  # CPU tensors: the plain version
    x = tqp.solve_factorized(fac, torch.tensor(b)).numpy()
    for i in range(Bs):
        ref = factorize_pallas(jnp.asarray(H[i]), jnp.asarray(U[i]),
                               interpret=True)
        for name in ("Linv", "W", "V"):
            np.testing.assert_allclose(getattr(fac, name)[i].numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=1e-5, err_msg=f"{name} {i}")
        np.testing.assert_allclose(
            x[i], np.asarray(jqp.solve_factorized(ref, jnp.asarray(b[i]))),
            atol=1e-5)
    assert np.all(fac.W[:, 0].numpy() == 0) and np.all(fac.V[:, -1].numpy() == 0)


def test_k3_plain_keeps_nan_for_non_spd():
    """A non-SPD node block must reach the solver as NaN (the eq-projection
    guard and the status codes depend on it), in its own scenario only."""
    H = np.tile(np.eye(10, dtype=np.float32), (2, 4, 1, 1))
    H[1, 2] *= -1.0
    U = np.zeros((2, 3, 10, 10), np.float32)
    fac = fac_whole.factorize_whole(torch.tensor(H), torch.tensor(U))
    assert torch.isnan(fac.Linv[1, 2]).any()
    assert torch.isfinite(fac.Linv[0]).all()


def test_k3_wrapper_rejects_what_the_kernel_cannot_take():
    """The checks the wrapper makes before a launch: float32, full-width U,
    s <= MAX_S."""
    z = torch.zeros
    for H, U in ((z(1, 3, 8, 8), z(1, 2, 8, 4)),
                 (z(1, 3, 8, 8, dtype=torch.float64), z(1, 2, 8, 8)),
                 (z(1, 3, 120, 120), z(1, 2, 120, 120))):
        with pytest.raises(ValueError):
            fac_whole._check(H, U)
    fac_whole._check(z(1, 3, 112, 112), z(1, 2, 112, 112))


def test_build_key_is_stable():
    """The kernel build directory is keyed by the sources and flags alone
    (the build itself needs nvcc and runs on the GPU machine)."""
    from tpu_locoman_torch import _build

    srcs = _build._sources()
    assert [s.rsplit("/", 1)[-1] for s in srcs] == ["chol_inv_base.cu",
                                                    "fac_whole.cu",
                                                    "rnea_derivs.cu"]
    assert set(_build._SIGNATURES) == {"chol_inv_base_launch",
                                       "fac_whole_launch",
                                       "rnea_derivs_launch"}
    assert _build._digest(srcs) == _build._digest(list(srcs))
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH
