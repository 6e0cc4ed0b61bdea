"""Inverse Cholesky factors of batches of SPD node blocks, in plain PyTorch:
the recursive 2x2 block Cholesky with plain leaves (``chol_base_unrolled``,
``tri_inv_doubling``), which ``chol_inv_node`` runs for every block."""

import torch

#: widest block the program's K1 takes whole; wider blocks split at the
#: same points here
MAX_S = 112


def chol_base_unrolled(S):
    """(L, dinv) of small (..., s, s) SPD blocks: the right-looking
    outer-product Cholesky with rsqrt pivots (port of
    ``_chol_base_unrolled``). dinv = 1/diag(L)."""
    s = S.shape[-1]
    A = S
    cols, dinvs = [], []
    for j in range(s):
        di = torch.rsqrt(A[..., 0, 0])
        col = A[..., :, 0] * di[..., None]
        if j:
            col = torch.nn.functional.pad(col, (j, 0))
        cols.append(col)
        dinvs.append(di)
        if j < s - 1:
            t = col[..., j + 1:]
            A = A[..., 1:, 1:] - t[..., :, None] * t[..., None, :]
    return torch.stack(cols, dim=-1), torch.stack(dinvs, dim=-1)


def tri_inv_doubling(L, dinv):
    """L^-1 of small lower-triangular L by scalar-diagonal nilpotent
    doubling (port of ``_tri_inv_doubling``)."""
    s = L.shape[-1]
    eye = torch.eye(s, dtype=L.dtype, device=L.device)
    A = -(L * (1.0 - eye) * dinv[..., :, None])
    P = eye + A
    k = 1
    while k < s - 1:
        A = A @ A
        P = P + A @ P
        k *= 2
    return P * dinv[..., None, :]


def chol_inv_base_plain(S):
    """L^-1 of small blocks (s <= chol_base): the recursion's plain leaf."""
    L, dinv = chol_base_unrolled(S)
    return tri_inv_doubling(L, dinv)


def chol_inv_node_plain(S, base=16):
    """Plain PyTorch version of the kernel: the recursive 2x2 block
    Cholesky with plain leaves (s <= base; the kernel's split points at
    the default 16)."""
    from .qp import chol_inv

    return chol_inv(S, base, "torch")[1]


def chol_inv_node(S, base=16):
    """L^-1 of a (..., s, s) batch of SPD blocks: the plain recursion."""
    return chol_inv_node_plain(S, base)
