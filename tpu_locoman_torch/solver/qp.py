"""Stagewise QP: OSQP-semantics ADMM over the block-tridiagonal KKT.

PyTorch counterpart of the main path of ``tpu_locoman/solver/qp.py``:
``assemble_blocks`` (propagation-pattern C), the recursive ``chol_inv``
whose leaves are kernel K1, ``factorize`` with skinny couplings,
``solve_factorized``, the box-row matvecs and ``prepare`` / ``run_iters``
/ ``admm_solve``. Every tensor carries the scenario axis first:
G (Bs, N, m, ndx), P_diag (Bs, N+1, s), ...

The recursion's panel products, the Schur updates and the ADMM sweeps are
plain batched products (left to XLA in the JAX package, to cuBLAS here).
Not ported yet (ROADMAP queue 1, items 11-12): Ruiz scaling, the polish
phase, bf16 storage, and the sequential / cyclic / babe / pallas
factorizers.
"""

from typing import NamedTuple

import torch

from .chol_base import chol_base_unrolled, chol_inv_base, tri_inv_doubling


class ADMMConfig(NamedTuple):
    iters: int = 100
    rho: float = 2e-2
    sigma: float = 1e-6
    alpha: float = 1.4
    scaling_iters: int = 0
    eq_boost: float = 1e3
    # "cholinv_pb" computes the recursion leaves with kernel K1 on CUDA
    # tensors; "cholinv" computes them in plain torch on any device. Every
    # product is full float32 (TF32 is off for the solve).
    factorizer: str = "cholinv_pb"
    chol_base: int = 16
    matvec_dtype: str = "float32"
    factor_dtype: str = "float32"
    polish_iters: int = 0


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
    if cfg.polish_iters > 0:
        raise NotImplementedError(
            "ADMMConfig.polish_iters > 0 is not ported yet (ROADMAP queue 1, "
            "item 11)")
    if cfg.matvec_dtype != "float32" or cfg.factor_dtype != "float32":
        raise NotImplementedError(
            "only float32 matvec/factor storage is ported")
    if cfg.factorizer not in ("cholinv", "cholinv_pb"):
        raise NotImplementedError(
            f"factorizer {cfg.factorizer!r} is not ported yet (ROADMAP queue "
            f"1, items 11-12; kernel K3 in queue 2)")


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


def prepare(G, B, C, P_diag, l, u, cfg, box_idx=None, rho_vec=None,
            c_eye_rows=None):
    """Assemble and factorize M."""
    _check_config(cfg)
    if rho_vec is None:
        rho_vec = _rho_vec(l, u, cfg)
    H, U, A, D = assemble_blocks(G, B, C, P_diag, rho_vec, cfg.sigma,
                                 box_idx=box_idx, c_eye_rows=c_eye_rows)
    fac = factorize(H, U, chol_impl=cfg.factorizer, base=cfg.chol_base)
    return QPWork(fac=fac, A=A, D=D, rho_vec=rho_vec)


def run_iters(work, q, l, u, cfg, x, z, y, iters, box_idx=None):
    """Fixed-count ADMM sweeps on prepared data (OSQP splitting)."""
    rho = work.rho_vec
    for _ in range(iters):
        rhs = cfg.sigma * x - q + _At_matvec(work.A, work.D, rho * z - y,
                                             box_idx)
        x_t = solve_factorized(work.fac, rhs)
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
    return ((x, z, y), work) if return_work else (x, z, y)
