"""K3: each scenario's whole block-tridiagonal factorization in one launch.

Replaces the TPU kernel ``factorize_pallas`` / ``_factorize_kernel`` in
``tpu_locoman/solver/pallas_fac.py``. For H (Bs, K, s, s) SPD-ish diagonal
blocks and full-width couplings U (Bs, K-1, s, s) it runs, node by node,

    S_i = H_i - F_{i-1}^T F_{i-1} + 1e-6 I,   Linv_i = chol(S_i)^-1,
    F_i = Linv_i U_i,   W_i = Linv_i F_{i-1}^T,   V_i = Linv_i^T F_i,

and returns the ``BlockTridiagFactor`` (Linv, W, V), each (Bs, K, s, s),
with W_0 = 0 and V_{K-1} = 0, that ``solve_factorized`` takes. It serves
``factorizer="pallas"``: once per tick in ``prepare`` at (K=N+1, s) and
once per ``eq_project`` pass at (K=N, s=m_dense) — at B2G N=14, (15, 105)
and (14, 110).

What bounds it on an H100: per scenario ~4.7 s^3 f32 operations per
interior node (77 MFLOP at (15, 105)) on 3.3 MB of blocks, so the card's
bound is operations at 67 TFLOP/s, 1.15 us at Bs=1 (0.59 ms at Bs=512).
The kernel (``csrc/fac_whole.cu``) keeps one scenario's running state
(S/L, Linv, F_{i-1}, U_i) resident in the shared memory of one CTA and
walks the nodes in a loop, so nothing but H, U and the outputs touches
device memory. Its products are register-tiled, and Linv_i comes from
the 2x2 block recursion it shares with K1 (``csrc/chol_tile.cuh``): about
41 block barriers per node where the column-by-column design took about
225. At Bs=1 it is still one SM's work with a dependent chain
of panel steps; at batch 512 the CTAs fill the card in four waves.
Splitting a scenario over a cluster of CTAs is later work.

``factorize_whole`` calls the custom op ``tpu_locoman_torch::fac_whole`` on
both devices, so that an exported program (``aot.py``) holds it as one
node: its CPU implementation is the plain version, its CUDA implementation
launches the kernel or raises.
"""

import ctypes

import torch

from .. import trace

#: trace counter of the kernel launches made by ``factorize_whole`` (the
#: CUDA path only)
LAUNCHES = "kernels.fac_whole.launches"

#: widest block the kernel takes: four padded s x (s+4) f32 tiles must fit
#: in the 227 KB of shared memory one block can have (s = 112: 203 KB)
MAX_S = 112


def factorize_whole_plain(H, U):
    """Plain PyTorch version: the same recurrence with the recursive
    ``chol_inv`` of ``factorize(chol_impl="cholinv")``."""
    from .qp import factorize

    return factorize(H, U, chol_impl="cholinv")


def _check(H, U):
    """Raise on what the kernel does not take."""
    Bs, K, s = H.shape[0], H.shape[1], H.shape[-1]
    if H.dtype != torch.float32 or U.dtype != torch.float32:
        raise ValueError("factorize_whole: need float32")
    if H.shape != (Bs, K, s, s) or U.shape != (Bs, K - 1, s, s) or K < 1:
        raise ValueError(f"factorize_whole: need H (Bs, K, s, s) and full-"
                         f"width U (Bs, K-1, s, s), got {tuple(H.shape)} and "
                         f"{tuple(U.shape)}")
    if s > MAX_S:
        raise ValueError(f"factorize_whole: s={s} > {MAX_S}: the kernel "
                         f"keeps four s x (s+4) f32 tiles in one block's "
                         f"shared memory")
    if U.device != H.device:
        raise ValueError("factorize_whole: H and U must be on one device")


@torch.library.custom_op("tpu_locoman_torch::fac_whole", mutates_args=(),
                         device_types="cpu")
def _op(H: torch.Tensor, U: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(factorize_whole_plain(H, U))


@_op.register_kernel("cuda")
def _launch(H, U):
    from .._build import load

    _check(H, U)
    Bs, K, s = H.shape[0], H.shape[1], H.shape[-1]
    Hc, Uc = H.contiguous(), U.contiguous()
    Linv, W, V = (torch.empty_like(Hc) for _ in range(3))
    stream = torch.cuda.current_stream(H.device).cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    rc = load().fac_whole_launch(
        ptr(Hc), ptr(Uc), ptr(Linv), ptr(W), ptr(V), ctypes.c_int(Bs),
        ctypes.c_int(K), ctypes.c_int(s), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"factorize_whole kernel launch failed: CUDA error "
                           f"{rc}")
    trace.count(LAUNCHES)
    return Linv, W, V


@_op.register_fake
def _(H, U):
    return tuple(torch.empty_like(H) for _ in range(3))


def factorize_whole(H, U):
    """BlockTridiagFactor of H (Bs, K, s, s) and U (Bs, K-1, s, s)."""
    from .qp import BlockTridiagFactor

    return BlockTridiagFactor(*torch.ops.tpu_locoman_torch.fac_whole(H, U))
