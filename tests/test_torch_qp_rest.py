"""The rest of the QP in the port against tpu_locoman: the triangular
doubling inverse, the panel Cholesky, the "sequential" factorizer, block
cyclic reduction, a general C, Ruiz equilibration and the scaling path of
``admm_solve``.

The inputs are made with numpy from a seed and go through both packages on
the CPU. None of these is a TPU kernel (the JAX package runs XLA's Cholesky
and triangular solve, the port the library's), so the two sides differ by
f32 summation order only. Each tolerance is stated beside the gap measured
on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_locoman.solver import qp as jqp  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch.solver import blocked  # noqa: E402
from tpu_locoman_torch.solver import qp as tqp  # noqa: E402


def _spd(rng, shape, s, shift):
    A = rng.standard_normal(shape + (s, s)).astype(np.float32)
    return (np.einsum("...ij,...kj->...ik", A, A) / s
            + shift * np.eye(s, dtype=np.float32)).astype(np.float32)


def _close(out, ref, rel, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref,
                               atol=rel * (np.abs(ref).max() + 1),
                               err_msg=err_msg)


def _qps(Bs=2, N=6, m=5, ndx=4, nu=2, seed=6, spread=False):
    """Bs stage QPs with a general C, as tests/test_qp.py:random_blocks
    makes them (spread: rows and columns scaled over 1e-3..1e4, as in the
    real OCP), and loose interval bounds."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    G = rng.normal(size=(Bs, N, m, ndx))
    B = rng.normal(size=(Bs, N, m, nu))
    C = rng.normal(size=(Bs, N, m, ndx))
    P = np.abs(rng.normal(size=(Bs, N + 1, ndx + nu))) + 0.1
    if spread:
        G *= 10.0 ** rng.uniform(-2, 2, size=(Bs, N, m, 1))
        P *= 10.0 ** rng.uniform(-3, 4, size=(Bs, N + 1, ndx + nu))
    q = rng.normal(size=(Bs, N + 1, ndx + nu))
    l = rng.normal(size=(Bs, N, m)) - 2.0
    return [f32(x) for x in (G, B, C, P, q, l, l + 1.0)] + [rng]


@pytest.mark.parametrize("s,depth", [(35, 1), (35, 2), (105, 1), (105, 2)])
def test_tri_inverse_lower_matches_jax(s, depth):
    """Lower-triangular inverse by block-nilpotent doubling (nb=3, padded
    with an identity diagonal at s = 35 and 105 / 3 = 35 exact), depth 2
    recursing into the diagonal blocks. Measured gap to JAX at most 7.1e-8
    of max|L^-1|, and L^-1 L = I within 1.1e-7; held at 1e-6*(max+1) and
    1e-6."""
    rng = np.random.default_rng(s + depth)
    L = np.linalg.cholesky(_spd(rng, (3,), s, 1.0)).astype(np.float32)
    out = blocked.tri_inverse_lower(torch.tensor(L), depth=depth).numpy()
    ref = np.stack([np.asarray(jqp.tri_inverse_lower(jnp.asarray(Li),
                                                     depth=depth))
                    for Li in L])
    _close(out, ref, 1e-6)
    np.testing.assert_allclose(out @ L, np.broadcast_to(np.eye(s), L.shape),
                               atol=1e-6)


@pytest.mark.parametrize("s", [40, 105])
def test_chol_blocked_matches_jax(s):
    """The panel Cholesky: one library call at s = 40 (<= 48), three
    panels of 35 at s = 105, each inverting L11 by the doubling. Measured
    gap to JAX at most 1.2e-7 of max|L|; held at 1e-6*(max+1)."""
    S = _spd(np.random.default_rng(s), (3,), s, 3.0)
    out = blocked.chol_blocked(torch.tensor(S)).numpy()
    ref = np.stack([np.asarray(jqp.chol_blocked(jnp.asarray(Si)))
                    for Si in S])
    _close(out, ref, 1e-6)


def test_cholesky_gives_nan_for_a_non_spd_block():
    """As XLA's Cholesky does: a failed block is NaN, the others stay."""
    S = torch.eye(3).repeat(2, 1, 1)
    S[1] = -S[1]
    L = blocked.cholesky(S)
    assert torch.isnan(L[1]).all() and torch.equal(L[0], torch.eye(3))


@pytest.mark.parametrize("u_cols", [None, 6])
def test_factorize_blocked_matches_jax(u_cols):
    """factorize(chol_impl="blocked"), the "sequential" factorizer, on
    (K, s) = (8, 40) with a full coupling, and with u_cols = 6 (only six
    live columns, V stored skinny). Linv, W, V and one solve against JAX;
    measured gap at most 3.4e-7 of the largest entry; held at
    5e-6*(max+1)."""
    rng = np.random.default_rng(21)
    K, s, Bs = 8, 40, 2
    H = _spd(rng, (Bs, K), s, 3.0)
    U = (0.1 * rng.standard_normal((Bs, K - 1, s, s))).astype(np.float32)
    if u_cols is not None:
        U[..., u_cols:] = 0.0
    b = rng.standard_normal((Bs, K, s)).astype(np.float32)
    fac = tqp.factorize(torch.tensor(H), torch.tensor(U), chol_impl="blocked",
                        u_cols=u_cols)
    x = tqp.solve_factorized(fac, torch.tensor(b)).numpy()
    assert fac.V.shape[-1] == (s if u_cols is None else u_cols)
    for i in range(Bs):
        ref = jqp.factorize(jnp.asarray(H[i]), jnp.asarray(U[i]),
                            u_cols=u_cols)
        for name in ("Linv", "W", "V"):
            _close(getattr(fac, name)[i].numpy(), getattr(ref, name), 5e-6,
                   name)
        _close(x[i], jqp.solve_factorized(ref, jnp.asarray(b[i])), 5e-6)


def _dense_M(H, U):
    K, s = H.shape[0], H.shape[-1]
    M = np.zeros((K * s, K * s))
    for i in range(K):
        M[i * s:(i + 1) * s, i * s:(i + 1) * s] = H[i]
        if i < K - 1:
            M[i * s:(i + 1) * s, (i + 1) * s:(i + 2) * s] = U[i]
            M[(i + 1) * s:(i + 2) * s, i * s:(i + 1) * s] = U[i].T
    return M


@pytest.mark.parametrize("K", [15, 16])
def test_cyclic_matches_jax_and_dense(K):
    """Block cyclic reduction at K = 15 (padded to 16 with identity
    blocks) and 16, s = 20: the solve against JAX's and against a float64
    dense solve of the block tridiagonal. Measured: at most 2.6e-7 from
    JAX and 5.8e-7 from float64, of max|x| (the float64 gap includes the
    1e-6 jitter on every inverted block); held at 5e-6*(max+1)."""
    rng = np.random.default_rng(K)
    Bs, s = 2, 20
    H = _spd(rng, (Bs, K), s, 3.0)
    U = (0.1 * rng.standard_normal((Bs, K - 1, s, s))).astype(np.float32)
    b = rng.standard_normal((Bs, K, s)).astype(np.float32)
    fac = blocked.factorize_cyclic(torch.tensor(H), torch.tensor(U))
    assert len(fac.levels) == 4 and fac.n_blocks == K
    x = blocked.solve_cyclic(fac, torch.tensor(b)).numpy()
    assert x.shape == b.shape
    ref = np.asarray(jax.jit(jax.vmap(
        lambda H, U, b: jqp.solve_cyclic(jqp.factorize_cyclic(H, U), b)))(
            H, U, b))
    for i in range(Bs):
        _close(x[i], ref[i], 5e-6, f"JAX, scenario {i}")
        dense = np.linalg.solve(_dense_M(H[i].astype(np.float64),
                                         U[i].astype(np.float64)),
                                b[i].reshape(-1).astype(np.float64))
        _close(x[i], dense.reshape(K, s), 5e-6, f"dense, scenario {i}")


def test_general_c_assembly_and_matvecs_match_jax():
    """assemble_blocks without c_eye_rows (a general C: dense D, D^T rho D
    and A^T rho D) with box rows, and the ADMM matvecs with a dense D,
    against JAX. The same products: measured gap at most 1.2e-7 of the
    largest entry; held at 1e-6*(max+1)."""
    G, B, C, P, q, l, u, rng = _qps()
    Bs, N, m, ndx = G.shape
    s = P.shape[-1]
    box = np.array([1, 4, 5])
    rho = rng.uniform(0.01, 20.0, size=(Bs, N, m + 3)).astype(np.float32)
    X = rng.normal(size=(Bs, N + 1, s)).astype(np.float32)
    Wv = rng.normal(size=(Bs, N, m + 3)).astype(np.float32)
    H, U, A, D = tqp.assemble_blocks(*(torch.tensor(x) for x in (G, B, C, P,
                                                                 rho)),
                                     1e-6, box_idx=box)
    assert U.shape == (Bs, N, s, s) and D.shape == (Bs, N, m, s)
    Ax = tqp._A_matvec(A, D, torch.tensor(X), box)
    AtW = tqp._At_matvec(A, D, torch.tensor(Wv), box)
    for i in range(Bs):
        rH, rU, rA, rD = jqp.assemble_blocks(
            *(jnp.asarray(x[i]) for x in (G, B, C, P, rho)), 1e-6,
            box_idx=box)
        for out, ref in ((H, rH), (U, rU), (A, rA), (D, rD)):
            _close(out[i].numpy(), ref, 1e-6)
        _close(Ax[i].numpy(), jqp._A_matvec(rA, rD, jnp.asarray(X[i]), box),
               1e-6)
        _close(AtW[i].numpy(),
               jqp._At_matvec(rA, rD, jnp.asarray(Wv[i]), box), 1e-6)


def test_ruiz_equilibrate_matches_jax_and_keeps_zero_rows():
    """Three Ruiz sweeps on badly scaled blocks with a zero row (node 2,
    row 1) and a zero column (stage 3, slot 0: zero in G, in the C of node
    2 and in P): both keep a unit scale. Measured gap to JAX 2.4e-7
    relative (the same operations, another square root); held at 1e-6
    relative."""
    G, B, C, P, *_ = _qps(spread=True)
    G[:, 2, 1], B[:, 2, 1], C[:, 2, 1] = 0.0, 0.0, 0.0
    G[:, 3, :, 0], C[:, 2, :, 0], P[:, 3, 0] = 0.0, 0.0, 0.0
    E, Dc = tqp.ruiz_equilibrate(*(torch.tensor(x) for x in (G, B, C, P)), 3)
    assert torch.all(E[:, 2, 1] == 1.0) and torch.all(Dc[:, 3, 0] == 1.0)
    for i in range(G.shape[0]):
        rE, rD = jqp.ruiz_equilibrate(*(jnp.asarray(x[i]) for x in (G, B, C,
                                                                    P)), 3)
        np.testing.assert_allclose(E[i].numpy(), np.asarray(rE), rtol=1e-6)
        np.testing.assert_allclose(Dc[i].numpy(), np.asarray(rD), rtol=1e-6)


@pytest.mark.parametrize("factorizer", ["sequential", "cholinv"])
def test_admm_scaled_with_box_rows_matches_jax(factorizer):
    """admm_solve with scaling_iters=3 on badly scaled blocks with three
    box rows and warm starts, against JAX with the same factorizer: the
    box rows take E = 1/Dc at their slot, and x, z, y come back unscaled.
    Measured gap at most 8.6e-6 of max|x|, 1.7e-6 of max|z| and 1.1e-7 of
    max|y| (300 sweeps); held at 1e-4*(max+1)."""
    G, B, C, P, q, l, u, rng = _qps(spread=True, seed=9)
    Bs, N, m, _ = G.shape
    box = np.array([1, 4, 5])
    lb = (rng.normal(size=(Bs, N, 3)) - 1.0).astype(np.float32)
    l2 = np.concatenate([l, lb], -1)
    u2 = np.concatenate([u, lb + 2.0], -1)
    x0 = (0.1 * rng.normal(size=q.shape)).astype(np.float32)
    z0 = np.clip(rng.normal(size=l2.shape), l2, u2).astype(np.float32)
    y0 = (0.1 * rng.normal(size=l2.shape)).astype(np.float32)
    cfg = dict(iters=300, scaling_iters=3, factorizer=factorizer)
    x, z, y = tqp.admm_solve(*(torch.tensor(a) for a in (G, B, C, P, q, l2,
                                                         u2)),
                             T.ADMMConfig(**cfg), x0=torch.tensor(x0),
                             z0=torch.tensor(z0), y0=torch.tensor(y0),
                             box_idx=box)
    for i in range(Bs):
        rx, rz, ry = jqp.admm_solve(
            *(jnp.asarray(a[i]) for a in (G, B, C, P, q, l2, u2)),
            jqp.ADMMConfig(**cfg), x0=jnp.asarray(x0[i]),
            z0=jnp.asarray(z0[i]), y0=jnp.asarray(y0[i]), box_idx=box)
        _close(x[i].numpy(), rx, 1e-4, f"x, scenario {i}")
        _close(z[i].numpy(), rz, 1e-4, f"z, scenario {i}")
        _close(y[i].numpy(), ry, 1e-4, f"y, scenario {i}")


def test_admm_cyclic_matches_sequential_and_jax():
    """As tests/test_qp.py:185: "cyclic" against "sequential" on the same
    QP (300 sweeps), in the port, within the reference test's
    2e-2*(max+1); and each against JAX's same factorizer. Measured: cyclic
    2.1e-7 from sequential, each within 3.5e-7 of JAX, of max|x|; held at
    1e-5*(max+1) against JAX."""
    G, B, C, P, q, l, u, _ = _qps(Bs=2)
    xs = {}
    for fz in ("sequential", "cyclic"):
        cfg = dict(iters=300, factorizer=fz)
        xs[fz] = tqp.admm_solve(*(torch.tensor(a) for a in (G, B, C, P, q, l,
                                                            u)),
                                T.ADMMConfig(**cfg))[0].numpy()
        ref = jax.jit(jax.vmap(
            lambda *a: jqp.admm_solve(*a, jqp.ADMMConfig(**cfg))[0]))(
                G, B, C, P, q, l, u)
        _close(xs[fz], ref, 1e-5, fz)
    _close(xs["cyclic"], xs["sequential"], 2e-2)


def test_return_work_requires_unscaled():
    """As tests/test_qp.py:325: the corrector would otherwise reuse a
    factorization in scaled units."""
    G, B, C, P, q, l, u, _ = _qps(Bs=1, N=3, m=3, ndx=3)
    with pytest.raises(ValueError, match="scaling_iters"):
        tqp.admm_solve(*(torch.tensor(a) for a in (G, B, C, P, q, l, u)),
                       T.ADMMConfig(iters=2, scaling_iters=1),
                       return_work=True)


def test_auto_factorizer_resolves_as_the_reference():
    """"auto" on a CPU tensor is "sequential", as the reference resolves it
    off the TPU (tpu_locoman/solver/qp.py:929-930): the same factor, bit
    for bit."""
    rng = np.random.default_rng(3)
    H = torch.tensor(_spd(rng, (1, 4), 12, 3.0))
    U = torch.tensor((0.1 * rng.standard_normal((1, 3, 12, 12))).astype(
        np.float32))
    auto = tqp._factorize_by_name(H, U, "auto")
    seq = tqp._factorize_by_name(H, U, "sequential")
    for name in ("Linv", "W", "V"):
        assert torch.equal(getattr(auto, name), getattr(seq, name))
    with pytest.raises(ValueError, match="factorizer"):
        tqp._factorize_by_name(H, U, "nope")
