"""K4: all the ADMM sweeps of one ``run_iters`` call in one launch.

No TPU kernel corresponds: in the JAX package XLA fused the sweep loop of
``run_iters`` (``tpu_locoman/solver/qp.py``). In the port that loop issues
about 100 small launches per sweep (34 batched matrix-vector products and
the elementwise updates between them). For a ``BlockTridiagFactor`` with
the propagation pattern (an int D) the kernel (``csrc/admm_sweeps.cu``)
runs every sweep of the call for every scenario in one launch: one CTA per
scenario walks the forward and backward chains node by node, its vectors
held in shared memory, and streams each node's blocks (Linv, W, V, A)
through a two-slot ring of asynchronous copies, reading each once per
sweep.

What bounds it on an H100: bytes, at 0.5 flop per byte. Per scenario and
sweep the kernel reads Linv, W and V once and A once (2.27 MB at the
flagship's (K, s, kv, md) = (15, 105, 48, 110)); the plain loop reads Linv
and A twice (3.58 MB). See ``sweep_bytes``.

``admm_sweeps`` calls the custom op ``tpu_locoman_torch::admm_sweeps`` on
both devices, so that an exported program (``aot.py``) holds it as one
node: its CPU implementation is the plain version, its CUDA implementation
launches the kernel or raises. The plain version is here: the sweep loop
``sweep_loop`` on ``fac_whole.solve_factorized``, with the stage matvecs
``_A_matvec`` and ``_At_matvec``. ``qp.run_iters`` runs the same loop on
the factors the kernel does not take (BABE, cyclic, a dense D), with
their own solves.
"""

import ctypes
from typing import Optional

import torch

from .. import trace
from .blocked import _bmv
from .fac_whole import BlockTridiagFactor, solve_factorized

#: trace counter of the kernel launches made by ``admm_sweeps`` (the CUDA
#: path only)
LAUNCHES = "kernels.admm_sweeps.launches"

#: threads of the kernel's CTA, one CTA per scenario
THREADS = 512

#: widest node the kernel takes: four columns per lane of a warp's row
MAX_S = 128

#: shared memory one block may have on sm_90
MAX_SMEM = 232448


def _slot(n):
    """Floats a block of n takes in a ring slot (with its 16-byte lead)."""
    return (n + 6) & ~3


def smem_bytes(K, s, kv, md, m, nbox):
    """Shared memory of one CTA (the kernel's ``admm_sweeps_smem``): a
    barrier per ring slot (16 bytes) and the two slots, each the largest of a forward step's (Linv_i, W_i), a
    backward step's (V_i, A_i and node i's z, y, rho, l, u) and a first
    step's (A_i, z0, y0, rho); the per-node vectors and x (2 K s); y_{i-1}
    and y_i, two A^T w and a zero vector (5 s); w of two nodes (2 m); the
    warps' column partials (16 s); the box maps (s + nbox)."""
    stage = max(2 * _slot(s * s),
                _slot(s * kv) + _slot(md * s) + 5 * _slot(m),
                _slot(md * s) + 3 * _slot(m))
    return 4 * (4 + 2 * stage + 2 * K * s + 5 * s + 2 * m
                + (THREADS // 32) * s + s + nbox)


def sweep_bytes(K, s, kv, md, m, once=True):
    """Bytes one scenario's sweep moves: the blocks (Linv, W, V and A read
    once each when ``once``, as the kernel reads them; with Linv and A
    twice as the plain loop's products read them) and the vectors (q, l,
    u and rho read, x, z and y read and written)."""
    N = K - 1
    blocks = K * (2 * s * s + s * kv) + N * md * s
    if not once:
        blocks += K * s * s + N * md * s
    return 4 * (blocks + 3 * K * s + 7 * N * m)


def _A_matvec(A, D, X, box_idx=None):
    """w_i = A_i s_i + D_i s_{i+1} (+ box selector rows); X (Bs, N+1, s).
    D is the int k of the propagation pattern (a slice) or dense."""
    out = _bmv(A, X[:, :-1])
    if isinstance(D, int):
        out = out.clone()
        out[..., :D] += X[:, 1:, :D]
    else:
        out = out + _bmv(D, X[:, 1:])
    if box_idx is not None:
        out = torch.cat([out, X[:, :-1][..., box_idx]], dim=-1)
    return out


def _At_matvec(A, D, W, box_idx=None):
    """X_i = A_i^T w_i + D_{i-1}^T w_{i-1}; W (Bs, N, m_all)."""
    Bs, N, md, s = A.shape
    out = W.new_zeros(Bs, N + 1, s)
    out[:, :-1] += _bmv(A.transpose(-1, -2), W[..., :md])
    if isinstance(D, int):
        out[:, 1:, :D] += W[..., :D]
    else:
        out[:, 1:] += _bmv(D.transpose(-1, -2), W[..., :md])
    if box_idx is not None:
        out[:, :-1, box_idx] += W[..., md:]
    return out


def sweep_loop(solve, fac, A, D, rho, q, l, u, sigma, alpha, x, z, y, iters,
               box_idx=None):
    """``iters`` ADMM sweeps (OSQP splitting) as plain batched products,
    with ``solve(fac, rhs)`` the factor's solve of M x = rhs."""
    for _ in range(iters):
        rhs = sigma * x - q + _At_matvec(A, D, rho * z - y, box_idx)
        x_t = solve(fac, rhs)
        z_t = _A_matvec(A, D, x_t, box_idx)
        x_new = alpha * x_t + (1.0 - alpha) * x
        z_relax = alpha * z_t + (1.0 - alpha) * z
        z_new = torch.clamp(z_relax + y / rho, min=l, max=u)
        y = y + rho * (z_relax - z_new)
        x, z = x_new, z_new
    return x, z, y


def admm_sweeps_plain(Linv, W, V, A, D, box_idx, rho, q, l, u, x, z, y,
                      sigma, alpha, iters):
    """Plain PyTorch version: the sweep loop on the factor (Linv, W, V)."""
    return sweep_loop(solve_factorized, BlockTridiagFactor(Linv, W, V), A, D,
                      rho, q, l, u, sigma, alpha, x, z, y, iters, box_idx)


def _check(Linv, W, V, A, D, box_idx, rho, q, l, u, x, z, y, iters):
    """Raise on what the kernel does not take."""
    floats = (Linv, W, V, A, rho, q, l, u, x, z, y)
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError("admm_sweeps: need float32")
    if Linv.dim() != 4 or A.dim() != 4 or rho.dim() != 3:
        raise ValueError(f"admm_sweeps: need Linv (Bs, K, s, s), A (Bs, K-1, "
                         f"md, s) and rho (Bs, K-1, m), got "
                         f"{tuple(Linv.shape)}, {tuple(A.shape)} and "
                         f"{tuple(rho.shape)}")
    Bs, K, s = Linv.shape[0], Linv.shape[1], Linv.shape[-1]
    md, m, kv = A.shape[2], rho.shape[-1], V.shape[-1]
    nbox = 0 if box_idx is None else box_idx.shape[0]
    want = {"Linv": (Bs, K, s, s), "W": (Bs, K, s, s), "V": (Bs, K, s, kv),
            "A": (Bs, K - 1, md, s), "q": (Bs, K, s), "x": (Bs, K, s)}
    want.update(dict.fromkeys(("rho", "l", "u", "z", "y"), (Bs, K - 1, m)))
    got = dict(zip(("Linv", "W", "V", "A", "rho", "q", "l", "u", "x", "z",
                    "y"), floats))
    bad = [f"{k} {tuple(got[k].shape)} (want {v})" for k, v in want.items()
           if tuple(got[k].shape) != v]
    if bad:
        raise ValueError("admm_sweeps: " + ", ".join(bad))
    if box_idx is not None and (box_idx.dim() != 1
                                or box_idx.dtype != torch.int64):
        raise ValueError("admm_sweeps: box_idx must be a 1-D int64 tensor")
    if (K < 2 or not 1 <= s <= MAX_S or not 1 <= kv <= s or m != md + nbox
            or not 0 <= D <= min(md, s) or iters < 1):
        raise ValueError(f"admm_sweeps: need K >= 2, 1 <= s <= {MAX_S}, "
                         f"1 <= kv <= s, m = md + n_box, 0 <= D <= min(md, s) "
                         f"and iters >= 1; got K={K} s={s} kv={kv} md={md} "
                         f"m={m} n_box={nbox} D={D} iters={iters}")
    need = smem_bytes(K, s, kv, md, m, nbox)
    if need > MAX_SMEM:
        raise ValueError(f"admm_sweeps: (K, s, kv, md, m) = ({K}, {s}, {kv}, "
                         f"{md}, {m}) needs {need} bytes of shared memory, "
                         f"more than the {MAX_SMEM} one block may have")
    devs = {t.device for t in floats}
    if box_idx is not None:
        devs.add(box_idx.device)
    if len(devs) != 1:
        raise ValueError("admm_sweeps: all inputs must be on one device")


@torch.library.custom_op("tpu_locoman_torch::admm_sweeps", mutates_args=(),
                         device_types="cpu")
def _op(Linv: torch.Tensor, W: torch.Tensor, V: torch.Tensor,
        A: torch.Tensor, D: int, box_idx: Optional[torch.Tensor],
        rho: torch.Tensor, q: torch.Tensor, l: torch.Tensor, u: torch.Tensor,
        x: torch.Tensor, z: torch.Tensor, y: torch.Tensor, sigma: float,
        alpha: float, iters: int
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return admm_sweeps_plain(Linv, W, V, A, D, box_idx, rho, q, l, u, x, z, y,
                             sigma, alpha, iters)


@_op.register_kernel("cuda")
def _launch(Linv, W, V, A, D, box_idx, rho, q, l, u, x, z, y, sigma, alpha,
            iters):
    from .._build import load

    _check(Linv, W, V, A, D, box_idx, rho, q, l, u, x, z, y, iters)
    ins = [t.contiguous() for t in (Linv, W, V, A)]
    box = None if box_idx is None else box_idx.contiguous()
    vecs = [t.contiguous() for t in (rho, q, l, u, x, z, y)]
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in (x, z, y)]
    Bs, K, s = Linv.shape[0], Linv.shape[1], Linv.shape[-1]
    md, m, kv = A.shape[2], rho.shape[-1], V.shape[-1]
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(Linv.device).cuda_stream
    rc = load().admm_sweeps_launch(
        *map(ptr, ins), ptr(box), *map(ptr, vecs), *map(ptr, outs),
        *map(ctypes.c_int, (Bs, K, s, kv, md, m, D,
                            0 if box is None else box.shape[0], iters)),
        ctypes.c_float(sigma), ctypes.c_float(alpha),
        ctypes.c_float(1.0 - alpha), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"admm_sweeps kernel launch failed: CUDA error "
                           f"{rc}")
    trace.count(LAUNCHES)
    return tuple(outs)


@_op.register_fake
def _(Linv, W, V, A, D, box_idx, rho, q, l, u, x, z, y, sigma, alpha, iters):
    return torch.empty_like(x), torch.empty_like(z), torch.empty_like(y)


def admm_sweeps(work, q, l, u, sigma, alpha, x, z, y, iters, box_idx=None):
    """``iters`` ADMM sweeps from (x, z, y) on ``work`` (a ``QPWork`` whose
    factor is a ``BlockTridiagFactor`` and whose D is the int k of the
    propagation pattern): the new (x, z, y)."""
    if iters <= 0:
        return x, z, y
    fac = work.fac
    return torch.ops.tpu_locoman_torch.admm_sweeps(
        fac.Linv, fac.W, fac.V, work.A, work.D, box_idx, work.rho_vec, q, l,
        u, x, z, y, float(sigma), float(alpha), int(iters))
