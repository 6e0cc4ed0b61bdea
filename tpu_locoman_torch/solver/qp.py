"""Stagewise QP: OSQP-semantics ADMM over the block-tridiagonal KKT.

PyTorch counterpart of ``tpu_locoman/solver/qp.py`` on the
``scaling_iters=0`` path: ``assemble_blocks`` (propagation-pattern C), the
recursive ``chol_inv`` whose leaves are kernel K1, ``factorize`` with skinny
couplings, the whole-horizon factorization of kernel K3
(``factorizer="pallas"``, ``fac_whole.py``), the two-chain BABE factorizer,
``solve_factorized`` / ``solve_babe``, the box-row matvecs, ``prepare`` /
``run_iters`` / ``admm_solve`` with the equality-polish phase, and the
accurate-mode closers ``kkt_polish`` and ``eq_project``. Every tensor
carries the scenario axis first: G (Bs, N, m, ndx), P_diag (Bs, N+1, s), ...

The recursion's panel products, the Schur updates and the ADMM sweeps are
plain batched products (left to XLA in the JAX package, to cuBLAS here).
Not ported yet (ROADMAP queue 1, item 12): Ruiz scaling, bf16 storage, and
the sequential and cyclic factorizers.
"""

from typing import NamedTuple

import torch

from .chol_base import chol_base_unrolled, chol_inv_base, tri_inv_doubling
from .fac_whole import factorize_whole

#: the factorizers the port has; "auto" is "cholinv_pb" on CUDA tensors and
#: "cholinv" on CPU tensors
FACTORIZERS = ("auto", "cholinv", "cholinv_pb", "pallas", "babe", "babe_pb")


class ADMMConfig(NamedTuple):
    iters: int = 100
    rho: float = 2e-2
    sigma: float = 1e-6
    alpha: float = 1.4
    scaling_iters: int = 0
    eq_boost: float = 1e3
    # "cholinv_pb" computes the recursion leaves with kernel K1 on CUDA
    # tensors; "cholinv" computes them in plain torch on any device;
    # "pallas" runs each scenario's whole factorization as one launch of
    # kernel K3; "babe" / "babe_pb" eliminate the horizon from both ends
    # (leaves as "cholinv" / "cholinv_pb"). Every product is full float32
    # (TF32 is off for the solve).
    factorizer: str = "cholinv_pb"
    chol_base: int = 16
    matvec_dtype: str = "float32"
    factor_dtype: str = "float32"
    # equality polish (accurate mode): after the main sweeps, refactorize
    # with the equality rho boosted by polish_boost and run polish_iters
    # more sweeps
    polish_iters: int = 0
    polish_boost: float = 100.0


class BlockTridiagFactor(NamedTuple):
    """Linv (Bs, N+1, s, s), W (Bs, N+1, s, s) with W_0 = 0,
    V (Bs, N+1, s, k) with V_N = 0 (see the JAX docstring)."""

    Linv: torch.Tensor
    W: torch.Tensor
    V: torch.Tensor


class QPWork(NamedTuple):
    fac: BlockTridiagFactor
    A: torch.Tensor
    D: int
    rho_vec: torch.Tensor


def _check_config(cfg):
    if cfg.scaling_iters > 0:
        raise NotImplementedError(
            "ADMMConfig.scaling_iters > 0 is not ported yet (ROADMAP queue 1, "
            "item 12)")
    if cfg.matvec_dtype != "float32" or cfg.factor_dtype != "float32":
        raise NotImplementedError(
            "only float32 matvec/factor storage is ported")
    if cfg.factorizer not in FACTORIZERS:
        raise NotImplementedError(
            f"factorizer {cfg.factorizer!r} is not ported yet (ROADMAP queue "
            f"1, item 12)")


def assemble_blocks(G, B, C, P_diag, rho_vec, sigma, box_idx=None,
                    c_eye_rows=None):
    """Tridiagonal blocks of M = P + sigma I + A^T diag(rho) A for the
    constant propagation pattern C (row r = e_r for r < c_eye_rows).
    Returns H (Bs, N+1, s, s), U (Bs, N, s, k), A (Bs, N, m, s) and k."""
    if c_eye_rows is None:
        raise NotImplementedError(
            "assemble_blocks needs the propagation-pattern C (c_eye_rows)")
    N, m = G.shape[1], G.shape[2]
    s = G.shape[3] + B.shape[3]
    A = torch.cat([G, B], dim=-1)
    rho_dense = rho_vec[..., :m]
    rA = rho_dense[..., None] * A
    AtA = torch.einsum("bnms,bnmt->bnst", rA, A)
    k = c_eye_rows
    diag = (P_diag + sigma).clone()
    diag[:, 1:, :k] += rho_dense[..., :k]
    if box_idx is not None:
        diag[:, :N, box_idx] += rho_vec[..., m:]
    H = torch.cat([AtA, AtA.new_zeros(AtA.shape[0], 1, s, s)], dim=1)
    idx = torch.arange(s, device=G.device)
    H[..., idx, idx] += diag
    U = rA[:, :, :k, :].transpose(-1, -2)
    return H, U, A, k


def chol_inv(S, base=16, base_impl="torch"):
    """(L, Linv) of SPD blocks (..., s, s) by recursive 2x2 block Cholesky.
    base_impl="kernel" computes the leaves (s <= base) with K1 and then
    materializes only Linv (L is None)."""
    s = S.shape[-1]
    if s <= base:
        if base_impl == "kernel":
            return None, chol_inv_base(S)
        L, dinv = chol_base_unrolled(S)
        return L, tri_inv_doubling(L, dinv)
    k = (s + 1) // 2
    L1, L1i = chol_inv(S[..., :k, :k], base, base_impl)
    L21 = S[..., k:, :k] @ L1i.transpose(-1, -2)
    S2 = S[..., k:, k:] - L21 @ L21.transpose(-1, -2)
    L2, L2i = chol_inv(S2, base, base_impl)
    B21 = -(L2i @ L21 @ L1i)
    zer = S.new_zeros(S.shape[:-2] + (k, s - k))
    L = None
    if L1 is not None and L2 is not None:
        L = torch.cat([torch.cat([L1, zer], -1), torch.cat([L21, L2], -1)], -2)
    Linv = torch.cat([torch.cat([L1i, zer], -1), torch.cat([B21, L2i], -1)], -2)
    return L, Linv


def factorize(H, U, chol_impl="cholinv_pb", base=16):
    """Blocked Cholesky of the tridiagonal M, node by node.
    H (Bs, N+1, s, s), U (Bs, N, s, k)."""
    if chol_impl not in ("cholinv", "cholinv_pb"):
        raise NotImplementedError(f"chol_impl {chol_impl!r} is not ported yet")
    base_impl = "kernel" if chol_impl == "cholinv_pb" else "torch"
    Bs, K, s = H.shape[0], H.shape[1], H.shape[2]
    k = U.shape[-1]
    eye = 1e-6 * torch.eye(s, dtype=H.dtype, device=H.device)
    prev_F = H.new_zeros(Bs, s, k)
    Linvs, Fs = [], []
    for i in range(K):
        S = H[:, i].clone()
        S[:, :k, :k] -= prev_F.transpose(-1, -2) @ prev_F
        S = S + eye
        _, Linv_i = chol_inv(S, base, base_impl)
        F_i = (Linv_i @ U[:, i] if i < K - 1 else H.new_zeros(Bs, s, k))
        Linvs.append(Linv_i)
        Fs.append(F_i)
        prev_F = F_i
    Linv = torch.stack(Linvs, dim=1)
    F = torch.stack(Fs, dim=1)
    F_prev = torch.cat([F.new_zeros(Bs, 1, s, k), F[:, :-1]], dim=1)
    W = Linv[..., :k] @ F_prev.transpose(-1, -2)
    V = Linv.transpose(-1, -2) @ F
    return BlockTridiagFactor(Linv=Linv, W=W, V=V)


def _bmv(M, x):
    return (M @ x.unsqueeze(-1)).squeeze(-1)


def solve_factorized(fac, b):
    """Solve M x = b, b (Bs, N+1, s)."""
    K = b.shape[1]
    Pb = _bmv(fac.Linv, b)
    y = torch.zeros_like(b[:, 0])
    Y = []
    for i in range(K):
        y = Pb[:, i] - _bmv(fac.W[:, i], y)
        Y.append(y)
    T = _bmv(fac.Linv.transpose(-1, -2), torch.stack(Y, dim=1))
    kv = fac.V.shape[-1]
    x = torch.zeros_like(b[:, 0])
    X = [None] * K
    for i in range(K - 1, -1, -1):
        x = T[:, i] - _bmv(fac.V[:, i], x[:, :kv])
        X[i] = x
    return torch.stack(X, dim=1)


class BabeFactor(NamedTuple):
    """Two-chain "burn-at-both-ends" factor (see the JAX docstring): the
    left chain (nodes 0..p-1) and the mirrored right chain (nodes S-1..p+1,
    couplings U^T) eliminated toward the separator node p = S // 2, the
    shorter chain front-padded with identity nodes.
    Linv, W, V (Bs, d, 2, s, s); Pfin (Bs, 2, s, s); Linv_sep (Bs, s, s)."""

    Linv: torch.Tensor
    W: torch.Tensor
    V: torch.Tensor
    Pfin: torch.Tensor
    Linv_sep: torch.Tensor


def _front_pad(c, d, fill):
    """Front-pad the node axis (dim 1) of c to length d with copies of
    fill (one node's block)."""
    n = c.shape[1]
    if n == d:
        return c
    return torch.cat([fill.expand((c.shape[0], d - n) + fill.shape), c], 1)


def factorize_babe(H, U, chol_impl="cholinv", base=16):
    """BABE factorization of the SPD block tridiagonal. H (Bs, S, s, s); U
    (Bs, S-1, s, k), padded dense here (the mirrored chain needs U^T)."""
    Bs, S_, s = H.shape[0], H.shape[1], H.shape[-1]
    k = U.shape[-1]
    base_impl = "kernel" if chol_impl == "cholinv_pb" else "torch"
    p = S_ // 2
    d = max(p, S_ - 1 - p)
    if k < s:
        U = torch.cat([U, U.new_zeros(U.shape[:-1] + (s - k,))], dim=-1)
    eye = torch.eye(s, dtype=H.dtype, device=H.device)
    zero = torch.zeros_like(eye)
    # chain step t: node t on the left, node S-1-t on the right, the latter
    # coupled onward through U_{S-2-t}^T; (Bs, d, 2, s, s)
    Hs = torch.stack([_front_pad(H[:, :p], d, eye),
                      _front_pad(H[:, p + 1:].flip(1), d, eye)], dim=2)
    Cs = torch.stack([_front_pad(U[:, :p], d, zero),
                      _front_pad(U[:, p:].transpose(-1, -2).flip(1), d, zero)],
                     dim=2)
    P_prev = H.new_zeros(Bs, 2, s, s)
    Linvs, Ps = [], []
    for t in range(d):
        Ssch = Hs[:, t] - P_prev.transpose(-1, -2) @ P_prev
        Ssch = Ssch + 1e-6 * eye
        _, Linv_t = chol_inv(Ssch, base, base_impl)
        P_prev = Linv_t @ Cs[:, t]
        Linvs.append(Linv_t)
        Ps.append(P_prev)
    Pfin = P_prev
    Ssep = (H[:, p] - Pfin[:, 0].transpose(-1, -2) @ Pfin[:, 0]
            - Pfin[:, 1].transpose(-1, -2) @ Pfin[:, 1] + 1e-6 * eye)
    _, Linv_sep = chol_inv(Ssep, base, base_impl)
    Linv = torch.stack(Linvs, dim=1)
    Pout = torch.stack(Ps, dim=1)
    P_prev_seq = torch.cat([Pout.new_zeros(Bs, 1, 2, s, s), Pout[:, :-1]], 1)
    W = Linv @ P_prev_seq.transpose(-1, -2)
    V = Linv.transpose(-1, -2) @ Pout
    return BabeFactor(Linv=Linv, W=W, V=V, Pfin=Pfin, Linv_sep=Linv_sep)


def solve_babe(fac, b):
    """Solve M x = b, b (Bs, S, s), with the BABE factor."""
    Bs, S_, s = b.shape
    d = fac.Linv.shape[1]
    p = S_ // 2
    nl, nr = p, S_ - 1 - p
    zero = b.new_zeros(s)
    bs = torch.stack([_front_pad(b[:, :p], d, zero),
                      _front_pad(b[:, p + 1:].flip(1), d, zero)], dim=2)
    Pb = _bmv(fac.Linv, bs)
    y = b.new_zeros(Bs, 2, s)
    Y = []
    for t in range(d):
        y = Pb[:, t] - _bmv(fac.W[:, t], y)
        Y.append(y)
    PfT = fac.Pfin.transpose(-1, -2)
    b_sep = b[:, p] - _bmv(PfT[:, 0], y[:, 0]) - _bmv(PfT[:, 1], y[:, 1])
    x_sep = _bmv(fac.Linv_sep.transpose(-1, -2), _bmv(fac.Linv_sep, b_sep))
    T = _bmv(fac.Linv.transpose(-1, -2), torch.stack(Y, dim=1))
    x = torch.stack([x_sep, x_sep], dim=1)
    X = [None] * d
    for t in range(d - 1, -1, -1):
        x = T[:, t] - _bmv(fac.V[:, t], x)
        X[t] = x
    X = torch.stack(X, dim=1)
    return torch.cat([X[:, d - nl:, 0], x_sep[:, None],
                      X[:, d - nr:, 1].flip(1)], dim=1)


def _A_matvec(A, D, X, box_idx=None):
    """w_i = A_i s_i + D_i s_{i+1} (+ box selector rows); X (Bs, N+1, s)."""
    out = _bmv(A, X[:, :-1]).clone()
    out[..., :D] += X[:, 1:, :D]
    if box_idx is not None:
        out = torch.cat([out, X[:, :-1][..., box_idx]], dim=-1)
    return out


def _At_matvec(A, D, W, box_idx=None):
    """X_i = A_i^T w_i + D_{i-1}^T w_{i-1}; W (Bs, N, m_all)."""
    Bs, N, md, s = A.shape
    out = W.new_zeros(Bs, N + 1, s)
    out[:, :-1] += _bmv(A.transpose(-1, -2), W[..., :md])
    out[:, 1:, :D] += W[..., :D]
    if box_idx is not None:
        out[:, :-1, box_idx] += W[..., md:]
    return out


def _rho_vec(l, u, cfg):
    return torch.where(u - l < 1e-7,
                       torch.full_like(l, cfg.eq_boost * cfg.rho),
                       torch.full_like(l, cfg.rho))


def _factorize_by_name(H, U, factorizer="auto", base=16):
    """Factorizer dispatch shared by prepare and eq_project. "pallas" takes
    the full-width coupling U (Bs, K-1, s, s)."""
    if factorizer == "auto":
        factorizer = "cholinv_pb" if H.is_cuda else "cholinv"
    if factorizer == "pallas":
        return factorize_whole(H, U)
    if factorizer in ("babe", "babe_pb"):
        return factorize_babe(
            H, U, chol_impl="cholinv_pb" if factorizer == "babe_pb"
            else "cholinv", base=base)
    if factorizer in ("cholinv", "cholinv_pb"):
        return factorize(H, U, chol_impl=factorizer, base=base)
    raise NotImplementedError(
        f"factorizer {factorizer!r} is not ported yet (ROADMAP queue 1, "
        f"item 12)")


def _solver_for(fac):
    return solve_babe if isinstance(fac, BabeFactor) else solve_factorized


def _median(x):
    """Median over the last two axes per scenario, averaging the two middle
    values for an even count as jnp.median does (torch.median returns the
    lower one)."""
    v = x.flatten(-2).sort(dim=-1).values
    n = v.shape[-1]
    return v[..., (n - 1) // 2] * 0.5 + v[..., n // 2] * 0.5


def _masked_rows(G, B, C, W, s):
    """The row blocks of node i's constraints on s_i (A) and on s_{i+1}
    (D), (Bs, N, m, s), with the rows where W = 0 zeroed."""
    Bs, N, m, ndx = G.shape
    A = torch.cat([G, B], dim=-1) * W[..., None]
    D = torch.cat([C, C.new_zeros(Bs, N, m, s - ndx)], dim=-1) * W[..., None]
    return A, D


def _schur(A, D, Pinv, W, delta):
    """The Jacobi-equilibrated constraint-space Schur complement
    S = A Pinv A^T + delta I of kkt_polish and eq_project: (A Pinv, D Pinv),
    its node blocks S_diag (Bs, N, m, m), its couplings S_off (Bs, N-1, m,
    m) and the scaling dscale (Bs, N, m)."""
    APi = A * Pinv[:, :-1, None, :]
    DPi = D * Pinv[:, 1:, None, :]
    S_diag = (torch.einsum("bnms,bnks->bnmk", APi, A)
              + torch.einsum("bnms,bnks->bnmk", DPi, D))
    # masked rows become the trivial equation lambda = 0
    S_diag = S_diag + torch.diag_embed(delta + (1.0 - W))
    S_off = torch.einsum("bnms,bnks->bnmk", DPi[:, :-1], A[:, 1:])
    # symmetric Jacobi equilibration (diag -> 1) for the f32 Cholesky
    dscale = 1.0 / torch.sqrt(torch.clamp(
        torch.diagonal(S_diag, dim1=-2, dim2=-1), min=1e-12))
    S_diag = S_diag * dscale[..., :, None] * dscale[..., None, :]
    S_off = S_off * dscale[:, :-1, :, None] * dscale[:, 1:, None, :]
    return APi, DPi, S_diag, S_off, dscale


def _At_lam(A, D, lam):
    """A^T lam on node i plus D^T lam on node i+1, (Bs, N+1, s)."""
    Bs, N, _, s = A.shape
    out = lam.new_zeros(Bs, N + 1, s)
    out[:, :-1] += torch.einsum("bnms,bnm->bns", A, lam)
    out[:, 1:] += torch.einsum("bnms,bnm->bns", D, lam)
    return out


def kkt_polish(G, B, C, P_diag, q, l, u, z, box_idx=None, sigma=1e-6,
               delta=1e-7, act_tol=1e-5):
    """OSQP-style polish: the exact equality-KKT solve on the active set
    (port of ``kkt_polish``); returns the polished step d (Bs, N+1, s).

    The JAX package factorizes the constraint-space Schur complement with
    its "blocked" Cholesky (XLA's loop Cholesky by panels, ROADMAP item 12).
    The port takes its "cholinv" factorization on CPU tensors and
    "cholinv_pb" (K1 leaves) on CUDA tensors: the same factor, with the f32
    sums in another order."""
    m = G.shape[2]
    ld, ud, zd = l[..., :m], u[..., :m], z[..., :m]
    eq = (ud - ld) < 1e-7
    act_l = (zd - ld) < act_tol
    act_u = (ud - zd) < act_tol
    W = (eq | act_l | act_u).to(G.dtype)
    r = torch.where(eq | act_l, ld, ud)
    Pinv = 1.0 / (P_diag + sigma)
    A, D = _masked_rows(G, B, C, W, P_diag.shape[-1])
    APi, DPi, S_diag, S_off, dscale = _schur(A, D, Pinv, W, delta)
    # S lam = -(A Pinv q + r)  (KKT: P d + q + A^T lam = 0, A d = r)
    rhs = -(torch.einsum("bnms,bns->bnm", APi, q[:, :-1])
            + torch.einsum("bnms,bns->bnm", DPi, q[:, 1:]) + W * r)
    fac = factorize(S_diag, S_off,
                    chol_impl="cholinv_pb" if S_diag.is_cuda else "cholinv")
    lam = solve_factorized(fac, rhs * dscale) * dscale
    return -Pinv * (q + _At_lam(A, D, lam))


def eq_project(G, B, C, P_diag, resid, W, sigma=1e-6, delta=1e-7, refine=2,
               factorizer="auto", base=16):
    """Minimum-norm correction zeroing the masked (equality) rows, the
    accurate-mode closer (port of ``eq_project``; see its docstring for the
    conditioning measures): the metric inverse clamped to a 1e4 spread
    around its median, the masked rows normalized, one constraint-space
    block-tridiagonal factorization (K3 at (N, m) under "pallas") and two
    rounds of iterative refinement reusing it.

    W (Bs, N, m) 0/1 mask of the rows to enforce; resid (Bs, N, m) their
    desired values. Returns delta (Bs, N+1, s)."""
    Pinv = 1.0 / (P_diag + sigma)
    med = _median(Pinv)[:, None, None]
    Pinv = torch.clamp(Pinv, min=med * 1e-2, max=med * 1e2)
    A, D = _masked_rows(G, B, C, W, P_diag.shape[-1])
    rn = torch.clamp(torch.maximum(A.abs().amax(-1), D.abs().amax(-1)),
                     min=1e-8)
    A = A / rn[..., None]
    D = D / rn[..., None]
    _, _, S_diag, S_off, dscale = _schur(A, D, Pinv, W, delta)
    rhs = (W * resid) / rn * dscale

    def S_matvec(lam):
        out = _bmv(S_diag, lam)
        out[:, :-1] += _bmv(S_off, lam[:, 1:])
        out[:, 1:] += _bmv(S_off.transpose(-1, -2), lam[:, :-1])
        return out

    fac = _factorize_by_name(S_diag, S_off, factorizer, base=base)
    solve = _solver_for(fac)
    lam = solve(fac, rhs)
    for _ in range(refine):
        lam = lam + solve(fac, rhs - S_matvec(lam))
    # A Pinv A^T lam = r  =>  delta = Pinv A^T lam satisfies A delta = r
    return Pinv * _At_lam(A, D, lam * dscale)


def prepare(G, B, C, P_diag, l, u, cfg, box_idx=None, rho_vec=None,
            c_eye_rows=None):
    """Assemble and factorize M."""
    _check_config(cfg)
    if rho_vec is None:
        rho_vec = _rho_vec(l, u, cfg)
    H, U, A, D = assemble_blocks(G, B, C, P_diag, rho_vec, cfg.sigma,
                                 box_idx=box_idx, c_eye_rows=c_eye_rows)
    s = H.shape[-1]
    if cfg.factorizer == "pallas" and U.shape[-1] < s:
        # K3 takes the full-width coupling block
        U = torch.cat([U, U.new_zeros(U.shape[:-1] + (s - U.shape[-1],))],
                      dim=-1)
    fac = _factorize_by_name(H, U, cfg.factorizer, base=cfg.chol_base)
    return QPWork(fac=fac, A=A, D=D, rho_vec=rho_vec)


def run_iters(work, q, l, u, cfg, x, z, y, iters, box_idx=None):
    """Fixed-count ADMM sweeps on prepared data (OSQP splitting)."""
    rho = work.rho_vec
    solve = _solver_for(work.fac)
    for _ in range(iters):
        rhs = cfg.sigma * x - q + _At_matvec(work.A, work.D, rho * z - y,
                                             box_idx)
        x_t = solve(work.fac, rhs)
        z_t = _A_matvec(work.A, work.D, x_t, box_idx)
        x_new = cfg.alpha * x_t + (1.0 - cfg.alpha) * x
        z_relax = cfg.alpha * z_t + (1.0 - cfg.alpha) * z
        z_new = torch.clamp(z_relax + y / rho, min=l, max=u)
        y = y + rho * (z_relax - z_new)
        x, z = x_new, z_new
    return x, z, y


def admm_solve(G, B, C, P_diag, q, l, u, cfg, x0=None, z0=None, y0=None,
               box_idx=None, return_work=False, c_eye_rows=None):
    """min 1/2 d^T P d + q^T d  s.t.  l <= A d <= u, per scenario.
    Returns (d, z, y) [and the QPWork when return_work]."""
    _check_config(cfg)
    work = prepare(G, B, C, P_diag, l, u, cfg, box_idx=box_idx,
                   c_eye_rows=c_eye_rows)
    x = torch.zeros_like(q) if x0 is None else x0
    z = torch.zeros_like(l) if z0 is None else z0
    y = torch.zeros_like(l) if y0 is None else y0
    x, z, y = run_iters(work, q, l, u, cfg, x, z, y, cfg.iters, box_idx)
    if cfg.polish_iters > 0:
        # equality polish: boosted equality rho, refactorize, more sweeps
        # from the carried (x, z, y); the inequalities keep their rho
        rho_p = torch.where((u - l) < 1e-7, cfg.polish_boost * work.rho_vec,
                            work.rho_vec)
        work_p = prepare(G, B, C, P_diag, l, u, cfg, box_idx=box_idx,
                         rho_vec=rho_p, c_eye_rows=c_eye_rows)
        x, z, y = run_iters(work_p, q, l, u, cfg, x, z, y, cfg.polish_iters,
                            box_idx)
    return ((x, z, y), work) if return_work else (x, z, y)
