"""K1: inverse Cholesky factor of a batch of small SPD blocks.

Replaces the TPU kernel ``chol_inv_base_batched`` / ``_base_kernel`` in
``tpu_locoman/solver/pallas_base.py``: S (B, b, b) float32 -> L^-1 with
S = L L^T, at the leaves (b <= chol_base) of every node's ``chol_inv``
recursion in ``factorize(chol_impl="cholinv_pb")``.

What bounds it on an H100: launch latency. One tick's factorization makes
120 calls (8 leaves of b in {13, 14} per node x 15 nodes at the flagship
s = 105), each on ~100 KB at batch 512, so FLOPs and bytes do not matter;
the kernel (``csrc/chol_inv_base.cu``) finishes each call in one short
wave: one warp per matrix held in shared memory, a lane per row for the
Cholesky and a lane per column for the triangular inverse.

``chol_inv_base`` takes the plain version only for CPU tensors; on a CUDA
tensor it launches the kernel or raises.
"""

import ctypes

import torch

#: kernel launches made by ``chol_inv_base`` (the CUDA path only)
launches = 0


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
    """Plain PyTorch version of the kernel."""
    L, dinv = chol_base_unrolled(S)
    return tri_inv_doubling(L, dinv)


def chol_inv_base(S):
    """L^-1 of a (B, b, b) batch of SPD blocks (leading dims flattened)."""
    global launches
    if not S.is_cuda:
        return chol_inv_base_plain(S)
    from .._build import load

    lead, b = S.shape[:-2], S.shape[-1]
    if S.dtype != torch.float32:
        raise ValueError("chol_inv_base: need float32")
    if S.shape[-2] != b or not 1 <= b <= 32:
        raise ValueError(f"chol_inv_base: need square blocks, 1 <= b <= 32, "
                         f"got {tuple(S.shape)}")
    Sf = S.reshape(-1, b, b).contiguous()
    out = torch.empty_like(Sf)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    rc = load().chol_inv_base_launch(
        ctypes.c_void_p(Sf.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int(Sf.shape[0]), ctypes.c_int(b), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"chol_inv_base kernel launch failed: CUDA error {rc}")
    launches += 1
    return out.reshape(lead + (b, b))
