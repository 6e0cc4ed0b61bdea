"""The library-Cholesky factorizations: the panel Cholesky and triangular
inverse of the "sequential" factorizer, and block cyclic reduction
("cyclic").

PyTorch counterparts of ``tri_inverse_lower``, ``chol_blocked``,
``_spd_inverse``, ``CyclicFactor``, ``factorize_cyclic`` and
``solve_cyclic`` in ``tpu_locoman/solver/qp.py``. None of them is a TPU
kernel: the JAX package computes the Cholesky and the triangular solves
with XLA, so here they are ``torch.linalg.cholesky_ex`` and
``torch.linalg.solve_triangular``, and the rest are batched products. Every
function takes any leading batch dimensions; the cyclic factor carries the
scenario axis first, H (Bs, K, s, s).
"""

from typing import NamedTuple

import torch


def cholesky(S):
    """Lower Cholesky factor of SPD blocks (..., s, s); NaN where a block
    is not positive definite, as XLA's Cholesky gives, so that a failed QP
    surfaces as NaN (a zero step in the SQP loop) without a host
    synchronisation."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _tri_solve_eye(L):
    """L^-1 of lower-triangular blocks by one triangular solve against I."""
    return torch.linalg.solve_triangular(
        L, _eye(L.shape[-1], L).expand(L.shape), upper=False)


def _block_diag(blocks):
    """(..., nb, b, b) -> the (..., nb*b, nb*b) block diagonal."""
    nb, b = blocks.shape[-3], blocks.shape[-1]
    out = blocks.new_zeros(blocks.shape[:-3] + (nb * b, nb * b))
    for i in range(nb):
        out[..., i * b:(i + 1) * b, i * b:(i + 1) * b] = blocks[..., i, :, :]
    return out


def tri_inverse_lower(L, nb=3, depth=1):
    """Inverse of lower-triangular blocks (..., s, s) by block-nilpotent
    doubling: with D the nb-block diagonal of L and A = -D^-1 (L - D),
    A^nb = 0 and L^-1 = (I + A + A^2 + A^3) D^-1, the powers by doubling in
    the reference's order (P = I + A, P = P + (A A) P, L^-1 = P D^-1). L is
    padded to a multiple of nb with an identity diagonal; the diagonal
    blocks recurse (depth levels, while b > 8), then take a triangular
    solve."""
    s = L.shape[-1]
    b = -(-s // nb)
    pad = nb * b - s
    if pad:
        L = torch.nn.functional.pad(L, (0, pad, 0, pad))
        diag = torch.cat([L.new_zeros(s), L.new_ones(pad)])
        L = L + torch.diag(diag)
    sp = nb * b
    blocks = torch.stack([L[..., i * b:(i + 1) * b, i * b:(i + 1) * b]
                          for i in range(nb)], dim=-3)
    if depth > 1 and b > 8:
        dinv_blocks = tri_inverse_lower(blocks, nb=nb, depth=depth - 1)
    else:
        dinv_blocks = _tri_solve_eye(blocks)
    Dinv = _block_diag(dinv_blocks)
    N = L - _block_diag(blocks)
    A = -Dinv @ N
    P = _eye(sp, L) + A
    if nb > 2:
        A2 = A @ A
        P = P + A2 @ P
    Linv = P @ Dinv
    return Linv[..., :s, :s] if pad else Linv


def chol_blocked(S, panels=3):
    """Right-looking panel Cholesky of SPD blocks (..., s, s): one library
    Cholesky up to s = 48, else ``panels`` panels, each inverting its
    diagonal factor (by ``tri_inverse_lower`` above width 16) to form the
    panel below it and update the trailing matrix by one product."""
    s = S.shape[-1]
    if s <= 48:
        return cholesky(S)
    b = -(-s // panels)
    cols = []
    T = S
    for st in range(0, s, b):
        bj = min(b, s - st)
        L11 = cholesky(T[..., :bj, :bj])
        inv = tri_inverse_lower(L11) if bj > 16 else _tri_solve_eye(L11)
        L21 = T[..., bj:, :bj] @ inv.transpose(-1, -2)
        col = torch.cat([L11, L21], dim=-2)
        if st:
            col = torch.nn.functional.pad(col, (0, 0, st, 0))
        cols.append(col)
        T = T[..., bj:, bj:] - L21 @ L21.transpose(-1, -2)
    return torch.cat(cols, dim=-1)


def spd_inverse(H):
    """Inverse of SPD blocks (..., s, s) through the panel Cholesky and the
    doubling triangular inverse, with the 1e-6 jitter."""
    S = H + 1e-6 * _eye(H.shape[-1], H)
    Linv = tri_inverse_lower(chol_blocked(S))
    return Linv.transpose(-1, -2) @ Linv


class CyclicFactor(NamedTuple):
    """Block cyclic reduction of the SPD block tridiagonal M: per level
    (Ho_inv, U_even, U_odd), the inverses of the odd diagonal blocks
    (Bs, L2, s, s) and the couplings that reduce the right-hand side and
    recover the odd blocks; top_inv (Bs, s, s) the inverse of the last
    block; n_blocks the unpadded block count K."""

    levels: tuple
    top_inv: torch.Tensor
    n_blocks: int


def _pow2(K):
    Kp = 1
    while Kp < K:
        Kp *= 2
    return Kp


def factorize_cyclic(H, U):
    """Cyclic reduction of (H (Bs, K, s, s), U (Bs, K-1, s, s)), U_i the
    coupling of block i to i+1. K is padded to a power of two with identity
    blocks; each level halves the blocks, batched over (Bs, blocks)."""
    Bs, K, s = H.shape[0], H.shape[1], H.shape[-1]
    Kp = _pow2(K)
    if Kp != K:
        pad = Kp - K
        H = torch.cat([H, _eye(s, H).expand(Bs, pad, s, s)], dim=1)
        U = torch.cat([U, U.new_zeros(Bs, pad, s, s)], dim=1)
    levels = []
    while H.shape[1] > 1:
        He, Ho = H[:, ::2], H[:, 1::2]
        U_even, U_odd = U[:, ::2], U[:, 1::2]
        Ho_inv = spd_inverse(Ho)
        levels.append((Ho_inv, U_even, U_odd))
        H_new = He - U_even @ Ho_inv @ U_even.transpose(-1, -2)
        H_new[:, 1:] -= U_odd.transpose(-1, -2) @ Ho_inv[:, :-1] @ U_odd
        U = -(U_even[:, :-1] @ Ho_inv[:, :-1] @ U_odd)
        H = H_new
    return CyclicFactor(levels=tuple(levels), top_inv=spd_inverse(H[:, 0]),
                        n_blocks=K)


def _bmv(M, x):
    return (M @ x.unsqueeze(-1)).squeeze(-1)


def solve_cyclic(fac, b):
    """Solve M x = b, b (Bs, K, s), with the cyclic-reduction factor."""
    Bs, K, s = b.shape
    Kp = _pow2(K)
    if Kp != K:
        b = torch.cat([b, b.new_zeros(Bs, Kp - K, s)], dim=1)
    saved = []
    for Ho_inv, U_even, U_odd in fac.levels:
        be, bo = b[:, ::2], b[:, 1::2]
        hbo = _bmv(Ho_inv, bo)
        b = be - _bmv(U_even, hbo)
        b[:, 1:] -= _bmv(U_odd.transpose(-1, -2), hbo[:, :-1])
        saved.append(bo)
    x = _bmv(fac.top_inv, b[:, 0])[:, None]
    for (Ho_inv, U_even, U_odd), bo in zip(reversed(fac.levels),
                                           reversed(saved)):
        rhs = bo - _bmv(U_even.transpose(-1, -2), x)
        rhs[:, :-1] -= _bmv(U_odd, x[:, 1:])
        xo = _bmv(Ho_inv, rhs)
        x = torch.stack([x, xo], dim=2).reshape(Bs, 2 * x.shape[1], s)
    return x[:, :K]
