"""K1: inverse Cholesky factor of a batch of SPD node blocks, one launch.

Replaces the TPU kernel ``chol_inv_base_batched`` / ``_base_kernel`` in
``tpu_locoman/solver/pallas_base.py``, which factors the b <= chol_base
leaves of every node's ``chol_inv`` recursion in
``factorize(chol_impl="cholinv_pb")``. On the card the recursion is gone
up to s = ``MAX_S``: ``chol_inv_node`` takes S (B, s, s) float32 to L^-1
with S = L L^T in one launch of ``csrc/chol_inv_node.cu`` (one CTA per
block running the same 2x2 recursion in shared memory,
``csrc/chol_tile.cuh``), where the torch recursion made 8 leaf launches
and ~70 small torch operations per node at s = 105.

What bounds it on an H100: bytes, 2 s^2 floats moved per block against
~2 s^3 / 3 operations (see the kernel's source note).

``chol_inv_node`` calls the custom op ``tpu_locoman_torch::chol_inv_node``
on both devices, so that an exported program (``aot.py``) holds it as one
node: its CPU implementation is the plain version, its CUDA implementation
launches the kernel or raises. The plain version is here: the recursive
2x2 block Cholesky ``chol_inv(S, base, "torch")`` with its plain leaves
(``chol_base_unrolled``, ``tri_inv_doubling``, ports of the TPU kernel's
algorithm). ``chol_inv(..., "kernel")`` hands each block of width <=
``MAX_S`` to the op; the factorizations (``fac_whole.factorize``) and
ABA's mass matrix (``rbda``) call it.
"""

import ctypes

import torch

from .. import trace

#: trace counter of the kernel launches made by ``chol_inv_node`` (the CUDA
#: path only)
LAUNCHES = "kernels.chol_inv_node.launches"

#: widest block the kernel takes: two padded s x (s+4) f32 tiles per CTA,
#: so that two CTAs share an SM (s = 112: 104 KB)
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


def _split(s):
    """Size of the leading block of chol_inv's 2x2 split of an s x s block."""
    return (s + 1) // 2


def kernel_blocks(s):
    """Sizes of the blocks, in order, that chol_inv(base_impl="kernel")
    hands to one K1 launch each on a CUDA tensor of width s: s itself up to
    MAX_S, else the 2x2 recursion's blocks down to widths <= MAX_S."""
    if s <= MAX_S:
        return [s]
    k = _split(s)
    return kernel_blocks(k) + kernel_blocks(s - k)


def chol_inv(S, base=16, base_impl="torch"):
    """(L, Linv) of SPD blocks (..., s, s) by recursive 2x2 block Cholesky.

    base_impl="kernel" materializes only Linv (L is None). It hands every
    block of width <= MAX_S (112) whole to the K1 op (``chol_inv_node``),
    recursing only above that (``kernel_blocks``). On a CUDA tensor that
    is one K1 launch, so ``base`` (``ADMMConfig.chol_base``) does not
    shape the factorization there: the factor is the same up to f32
    roundoff. On a CPU tensor the op recurses to leaves s <= base and
    computes them in plain torch, as base_impl="torch" does."""
    s = S.shape[-1]
    if base_impl == "kernel" and s <= MAX_S:
        return None, chol_inv_node(S, base)
    if s <= base:
        if base_impl == "kernel":
            return None, chol_inv_base_plain(S)
        L, dinv = chol_base_unrolled(S)
        return L, tri_inv_doubling(L, dinv)
    k = _split(s)
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


def chol_inv_node_plain(S, base=16):
    """Plain PyTorch version of the kernel: the recursive 2x2 block
    Cholesky with plain leaves (s <= base; the kernel's split points at
    the default 16)."""
    return chol_inv(S, base, "torch")[1]


def _check(S):
    """Raise on what the kernel does not take."""
    if S.dtype != torch.float32:
        raise ValueError("chol_inv_node: need float32")
    if (S.dim() < 2 or S.shape[-2] != S.shape[-1]
            or not 1 <= S.shape[-1] <= MAX_S):
        raise ValueError(f"chol_inv_node: need square blocks (..., s, s) "
                         f"with 1 <= s <= {MAX_S}, got {tuple(S.shape)}")


@torch.library.custom_op("tpu_locoman_torch::chol_inv_node", mutates_args=(),
                         device_types="cpu")
def _op(S: torch.Tensor, base: int) -> torch.Tensor:
    return chol_inv_node_plain(S, base)


@_op.register_kernel("cuda")
def _launch(S, base):
    from .._build import load

    _check(S)
    lead, s = S.shape[:-2], S.shape[-1]
    Sf = S.reshape(-1, s, s).contiguous()
    out = torch.empty_like(Sf)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    rc = load().chol_inv_node_launch(
        ctypes.c_void_p(Sf.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int(Sf.shape[0]), ctypes.c_int(s), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"chol_inv_node kernel launch failed: CUDA error "
                           f"{rc}")
    trace.count(LAUNCHES)
    return out.reshape(lead + (s, s))


@_op.register_fake
def _(S, base):
    return torch.empty_like(S)


def chol_inv_node(S, base=16):
    """L^-1 of a (..., s, s) batch of SPD blocks, s <= MAX_S on the card
    (where ``base`` does not shape the factor: the kernel keeps its own
    split points). A CPU tensor inside a ``torch.func`` transform takes the
    plain version directly, which the transform can see through."""
    if not S.is_cuda and torch._C._functorch.is_functorch_wrapped_tensor(S):
        return chol_inv_node_plain(S, base)
    return torch.ops.tpu_locoman_torch.chol_inv_node(S, base)
