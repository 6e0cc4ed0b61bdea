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
launches the kernel or raises. The plain version is here:
``factorize(chol_impl="cholinv")``, the node-by-node factorization that
also serves the "cholinv", "cholinv_pb" and "sequential" factorizers (the
node blocks by ``chol_base.chol_inv`` or ``blocked.chol_blocked``), with
the factor ``BlockTridiagFactor`` and its solve ``solve_factorized``.
"""

import ctypes
from typing import NamedTuple

import torch

from .. import trace
from .blocked import _bmv, chol_blocked, tri_inverse_lower
from .chol_base import chol_inv

#: trace counter of the kernel launches made by ``factorize_whole`` (the
#: CUDA path only)
LAUNCHES = "kernels.fac_whole.launches"

#: widest block the kernel takes: four padded s x (s+4) f32 tiles must fit
#: in the 227 KB of shared memory one block can have (s = 112: 203 KB)
MAX_S = 112


class BlockTridiagFactor(NamedTuple):
    """Linv (Bs, N+1, s, s), W (Bs, N+1, s, s) with W_0 = 0,
    V (Bs, N+1, s, k) with V_N = 0 (see the JAX docstring)."""

    Linv: torch.Tensor
    W: torch.Tensor
    V: torch.Tensor


def factorize(H, U, chol_impl="cholinv_pb", base=16, u_cols=None):
    """Blocked Cholesky of the tridiagonal M, node by node.
    H (Bs, N+1, s, s), U (Bs, N, s, k).

    chol_impl: "cholinv" / "cholinv_pb" the recursive chol_inv (leaves in
    plain torch / the whole node in K1 on the card), "blocked" the panel
    Cholesky and the doubling triangular inverse (the "sequential"
    factorizer). u_cols: the count k of U's live columns, when only
    U[..., :k] is nonzero."""
    if chol_impl not in ("cholinv", "cholinv_pb", "blocked"):
        raise ValueError(f"unknown chol_impl {chol_impl!r}")
    base_impl = "kernel" if chol_impl == "cholinv_pb" else "torch"
    Bs, K, s = H.shape[0], H.shape[1], H.shape[2]
    k = U.shape[-1] if u_cols is None else u_cols
    U = U[..., :k]
    eye = 1e-6 * torch.eye(s, dtype=H.dtype, device=H.device)
    prev_F = H.new_zeros(Bs, s, k)
    Linvs, Fs = [], []
    for i in range(K):
        S = H[:, i].clone()
        S[:, :k, :k] -= prev_F.transpose(-1, -2) @ prev_F
        S = S + eye
        if chol_impl == "blocked":
            Linv_i = tri_inverse_lower(chol_blocked(S))
        else:
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


def factorize_whole_plain(H, U):
    """Plain PyTorch version: the same recurrence with the recursive
    ``chol_inv`` of ``factorize(chol_impl="cholinv")``."""
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
    return BlockTridiagFactor(*torch.ops.tpu_locoman_torch.fac_whole(H, U))
