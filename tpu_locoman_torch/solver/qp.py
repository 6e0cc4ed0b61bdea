"""Stagewise QP: OSQP-semantics ADMM over the block-tridiagonal KKT.

PyTorch counterpart of ``tpu_locoman/solver/qp.py``: ``assemble_blocks``
(the propagation-pattern C with skinny couplings, or a general C with a
dense D), the two-chain BABE factorizer and its solve, Ruiz
equilibration, the factorizer dispatch, ``prepare`` / ``run_iters`` /
``admm_solve`` with the scaling path and the equality-polish phase, and
the accurate-mode closers ``kkt_polish`` and ``eq_project``. Every tensor
carries the scenario axis first: G (Bs, N, m, ndx), P_diag (Bs, N+1, s),
...

The layers below hold each kernel with its plain version, and this module
re-exports the reference's names from them: the recursive ``chol_inv``
(K1, ``chol_base.py``); ``BlockTridiagFactor``, ``factorize`` ("cholinv",
"cholinv_pb" and the "sequential" factorizer's panel Cholesky) and
``solve_factorized`` beside the whole-horizon factorization of K3
(``factorizer="pallas"``, ``fac_whole.py``); the box-row matvecs and the
sweep loop beside K4 (``admm_sweeps.py``), which takes a ``run_iters``
call's sweeps on a BlockTridiagFactor with the propagation pattern in one
launch on the card; block cyclic reduction (``factorizer="cyclic"``) and
the library Cholesky (``blocked.py``). The recursion's panel products
(CPU path) and the Schur updates are plain batched products (left to XLA
in the JAX package, to cuBLAS here); so are the ADMM sweeps on the BABE
and cyclic factors and with a dense D.
Not ported: bf16 storage of the matvec operator and of the factor (the
port computes in float32 only; the reference records both as diverging or
not worth it).
"""

from typing import NamedTuple

import torch

from .. import trace
# the names of the layers below that callers read as qp.<name> (the
# reference's qp module holds them all) are re-exported with the rest
from .admm_sweeps import (_A_matvec, _At_matvec,  # noqa: F401
                          admm_sweeps, sweep_loop)
from .blocked import (CyclicFactor, _bmv, chol_blocked,  # noqa: F401
                      factorize_cyclic, solve_cyclic, tri_inverse_lower)
from .chol_base import chol_inv, kernel_blocks  # noqa: F401
from .fac_whole import (BlockTridiagFactor, factorize, factorize_whole,
                        solve_factorized)

#: the factorizers the port has; "auto" is "cholinv_pb" on CUDA tensors and
#: "sequential" on CPU tensors, as the reference resolves it on and off the
#: TPU
FACTORIZERS = ("auto", "sequential", "cholinv", "cholinv_pb", "pallas",
               "babe", "babe_pb", "cyclic")


class _ADMMFields(NamedTuple):
    iters: int = 100
    rho: float = 2e-2
    sigma: float = 1e-6
    alpha: float = 1.4
    scaling_iters: int = 0
    eq_boost: float = 1e3
    # matmul precision of the QP's linear algebra and of its assembly;
    # the port runs every product in full float32, so only "highest"
    precision: str = "highest"
    # "cholinv_pb" factors each node block (s <= 112) in one launch of
    # kernel K1 on CUDA tensors, and by the recursion with plain leaves on
    # CPU tensors; "cholinv" runs the recursion in plain torch on any
    # device (chol_base sets its leaf width; see chol_inv);
    # "sequential" factors each node by the library Cholesky in panels
    # (chol_blocked); "pallas" runs each scenario's whole factorization as
    # one launch of kernel K3; "babe" / "babe_pb" eliminate the horizon
    # from both ends (leaves as "cholinv" / "cholinv_pb"); "cyclic" is
    # block cyclic reduction; "auto" is "cholinv_pb" on CUDA tensors and
    # "sequential" on CPU ones. Every product is full float32 (TF32 is off
    # for the solve).
    factorizer: str = "cholinv_pb"
    chol_base: int = 16
    assemble_precision: str = "highest"
    matvec_dtype: str = "float32"
    factor_dtype: str = "float32"
    # equality polish (accurate mode): after the main sweeps, refactorize
    # with the equality rho boosted by polish_boost and run polish_iters
    # more sweeps
    polish_iters: int = 0
    polish_boost: float = 100.0


class ADMMConfig(_ADMMFields):
    """The ADMM settings, with the reference's fields; a precision other
    than "highest" raises."""

    __slots__ = ()

    def __new__(cls, *args, **kwargs):
        cfg = super().__new__(cls, *args, **kwargs)
        _check_precision(cfg)
        return cfg


def _check_precision(cfg):
    for name in ("precision", "assemble_precision"):
        if getattr(cfg, name) != "highest":
            raise ValueError(
                f"ADMMConfig.{name}={getattr(cfg, name)!r}: the port computes "
                f"in float32 only, with no TF32 or bf16 passes, so only "
                f"\"highest\" is accepted")


class QPWork(NamedTuple):
    """The factor, A (Bs, N, m, s), D (the int k of the propagation
    pattern, or (Bs, N, m, s)) and the per-row rho."""

    fac: tuple
    A: torch.Tensor
    D: object
    rho_vec: torch.Tensor


def _check_config(cfg):
    _check_precision(cfg)  # also for a config made by _replace
    if cfg.matvec_dtype != "float32" or cfg.factor_dtype != "float32":
        raise NotImplementedError(
            "only float32 matvec/factor storage is ported: the port "
            "computes in float32 only")
    if cfg.factorizer not in FACTORIZERS:
        raise ValueError(f"unknown factorizer {cfg.factorizer!r}; the port "
                         f"has {FACTORIZERS}")


@trace.traced("qp.assemble")
def assemble_blocks(G, B, C, P_diag, rho_vec, sigma, box_idx=None,
                    c_eye_rows=None):
    """Tridiagonal blocks of M = P + sigma I + A^T diag(rho) A. Returns
    H (Bs, N+1, s, s), U, A (Bs, N, m, s) and D.

    With c_eye_rows = k, C is the constant propagation pattern (row r =
    e_r for r < k): U is the skinny (Bs, N, s, k) and D the int k. Without
    it, C is general: D = [C 0] (Bs, N, m, s) and U = A^T diag(rho) D is
    full (Bs, N, s, s)."""
    N, m = G.shape[1], G.shape[2]
    s = G.shape[3] + B.shape[3]
    A = torch.cat([G, B], dim=-1)
    rho_dense = rho_vec[..., :m]
    rA = rho_dense[..., None] * A
    AtA = torch.einsum("bnms,bnmt->bnst", rA, A)
    H = torch.cat([AtA, AtA.new_zeros(AtA.shape[0], 1, s, s)], dim=1)
    if c_eye_rows is not None:
        k = c_eye_rows
        diag = (P_diag + sigma).clone()
        diag[:, 1:, :k] += rho_dense[..., :k]
        if box_idx is not None:
            diag[:, :N, box_idx] += rho_vec[..., m:]
        idx = torch.arange(s, device=G.device)
        H[..., idx, idx] += diag
        U = rA[:, :, :k, :].transpose(-1, -2)
        return H, U, A, k
    H = H + torch.diag_embed(P_diag + sigma)
    if box_idx is not None:
        H[:, :N, box_idx, box_idx] += rho_vec[..., m:]
    D = torch.cat([C, C.new_zeros(C.shape[:-1] + (s - C.shape[-1],))], -1)
    DtD = torch.einsum("bnms,bnmt->bnst", rho_dense[..., None] * D, D)
    U = torch.einsum("bnms,bnmt->bnst", rA, D)
    H[:, 1:] += DtD
    return H, U, A, D


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


def ruiz_equilibrate(G, B, C, P_diag, iters):
    """Modified Ruiz equilibration of [P A^T; A 0] on the stage blocks
    (port of ``ruiz_equilibrate``): row scalings E (Bs, N, m) and column
    scalings Dc (Bs, N+1, s). Column j of stage i meets P's diagonal, node
    i's rows through [G_i B_i] and (its dx part) node i-1's rows through
    C_{i-1}. A row or column whose norm is zero keeps its unit scale:
    amplifying a masked row would blow up its stored dual when the contact
    schedule brings it back."""
    Bs, N, m, ndx = G.shape
    s = ndx + B.shape[-1]
    E = G.new_ones(Bs, N, m)
    Dc = G.new_ones(Bs, N + 1, s)
    GB = torch.cat([G, B], dim=-1)
    for _ in range(iters):
        A = GB * E[..., None] * Dc[:, :-1, None, :]
        D = C * E[..., None] * Dc[:, 1:, None, :ndx]
        row_norm = torch.maximum(A.abs().amax(-1), D.abs().amax(-1))
        E_new = torch.where(row_norm > 1e-8,
                            E / torch.sqrt(torch.clamp(row_norm, min=1e-8)),
                            E)
        E_new = torch.clamp(E_new, 1e-4, 1e4)
        col = G.new_zeros(Bs, N + 1, s)
        col[:, :-1] = torch.maximum(col[:, :-1], A.abs().amax(-2))
        col[:, 1:, :ndx] = torch.maximum(col[:, 1:, :ndx], D.abs().amax(-2))
        col = torch.maximum(col, P_diag.abs() * Dc * Dc)
        Dc_new = torch.where(col > 1e-8,
                             Dc / torch.sqrt(torch.clamp(col, min=1e-8)), Dc)
        Dc_new = torch.clamp(Dc_new, 1e-4, 1e4)
        E, Dc = E_new, Dc_new
    return E, Dc


def _rho_vec(l, u, cfg):
    return torch.where(u - l < 1e-7,
                       torch.full_like(l, cfg.eq_boost * cfg.rho),
                       torch.full_like(l, cfg.rho))


def _factorize_by_name(H, U, factorizer="auto", base=16):
    """Factorizer dispatch shared by prepare and eq_project. "pallas" and
    "cyclic" take the full-width coupling U (Bs, K-1, s, s)."""
    if factorizer == "auto":
        factorizer = "cholinv_pb" if H.is_cuda else "sequential"
    with trace.span("qp.factorize", factorizer=factorizer, Bs=H.shape[0],
                    K=H.shape[1], s=H.shape[-1]):
        if factorizer == "pallas":
            return factorize_whole(H, U)
        if factorizer == "cyclic":
            return factorize_cyclic(H, U)
        if factorizer in ("babe", "babe_pb"):
            return factorize_babe(
                H, U, chol_impl="cholinv_pb" if factorizer == "babe_pb"
                else "cholinv", base=base)
        if factorizer in ("cholinv", "cholinv_pb"):
            return factorize(H, U, chol_impl=factorizer, base=base)
        if factorizer == "sequential":
            return factorize(H, U, chol_impl="blocked")
        raise ValueError(f"unknown factorizer {factorizer!r}")


def _solver_for(fac):
    if isinstance(fac, CyclicFactor):
        return solve_cyclic
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
    (port of ``kkt_polish``); returns the polished step d (Bs, N+1, s). The
    constraint-space Schur complement is factorized with the panel
    Cholesky ("blocked"), as the reference does, on every device."""
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
    fac = factorize(S_diag, S_off, chol_impl="blocked")
    lam = solve_factorized(fac, rhs * dscale) * dscale
    return -Pinv * (q + _At_lam(A, D, lam))


@trace.traced("qp.eq_project")
def eq_project(G, B, C, P_diag, resid, W, sigma=1e-6, delta=1e-7, refine=2,
               factorizer="auto", base=16):
    """Minimum-norm correction zeroing the masked (equality) rows, the
    accurate-mode closer (port of ``eq_project``; see its docstring for the
    conditioning measures): the metric inverse clamped to a 1e4 spread
    around its median, the masked rows normalized, one constraint-space
    block-tridiagonal factorization (K3 at (N, m) under "pallas") and two
    rounds of iterative refinement reusing it. A cyclic factor does not
    take the refinement's solves, so "cyclic" factorizes "sequential" here,
    as in the reference.

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

    fac = _factorize_by_name(
        S_diag, S_off, "sequential" if factorizer == "cyclic" else factorizer,
        base=base)
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
    if cfg.factorizer in ("pallas", "cyclic") and U.shape[-1] < s:
        # these factorizers take the full-width coupling block
        U = torch.cat([U, U.new_zeros(U.shape[:-1] + (s - U.shape[-1],))],
                      dim=-1)
    fac = _factorize_by_name(H, U, cfg.factorizer, base=cfg.chol_base)
    return QPWork(fac=fac, A=A, D=D, rho_vec=rho_vec)


def run_iters(work, q, l, u, cfg, x, z, y, iters, box_idx=None):
    """Fixed-count ADMM sweeps on prepared data (OSQP splitting). A
    BlockTridiagFactor with the propagation pattern (an int D) takes the
    K4 op (``admm_sweeps``: one launch on the card, the plain loop on CPU
    tensors); the BABE and cyclic factors and a dense D take the plain loop
    on any device. The span's ``path`` says which."""
    fused = (isinstance(work.fac, BlockTridiagFactor)
             and isinstance(work.D, int))
    with trace.span("qp.sweeps", iters=iters,
                    path="kernel" if fused else "plain"):
        sweeps = admm_sweeps if fused else sweeps_plain
        return sweeps(work, q, l, u, cfg.sigma, cfg.alpha, x, z, y, iters,
                      box_idx)


def sweeps_plain(work, q, l, u, sigma, alpha, x, z, y, iters, box_idx=None):
    """The sweeps as plain batched products, on any factor and D (K4's
    loop, ``admm_sweeps.sweep_loop``, with the factor's own solve)."""
    return sweep_loop(_solver_for(work.fac), work.fac, work.A, work.D,
                      work.rho_vec, q, l, u, sigma, alpha, x, z, y, iters,
                      box_idx)


@trace.traced("qp.admm_solve")
def admm_solve(G, B, C, P_diag, q, l, u, cfg, x0=None, z0=None, y0=None,
               box_idx=None, return_work=False, c_eye_rows=None):
    """min 1/2 d^T P d + q^T d  s.t.  l <= A d <= u, per scenario.
    Returns (d, z, y) [and the QPWork when return_work].

    With cfg.scaling_iters > 0 the problem is Ruiz-equilibrated first: rho
    comes from the unscaled bounds, C counts as general (the scaled C is no
    longer the propagation pattern), the box rows take E = 1/Dc at their
    slot so that their unscaled bounds stay exact, the warm starts are
    scaled on the way in and the solution unscaled on the way out. The
    QPWork would then be in scaled units, so return_work requires
    scaling_iters == 0."""
    _check_config(cfg)
    if return_work and cfg.scaling_iters > 0:
        raise ValueError(
            "admm_solve(return_work=True) requires scaling_iters == 0: "
            "corrector steps reuse the factorization in problem units")
    # per-row penalty from the unscaled bounds (OSQP boosts the equalities)
    rho_vec = _rho_vec(l, u, cfg)
    E = Dc = None
    if cfg.scaling_iters > 0:
        c_eye_rows = None
        m, ndx = G.shape[2], G.shape[3]
        E, Dc = ruiz_equilibrate(G, B, C, P_diag, cfg.scaling_iters)
        if box_idx is not None:
            E = torch.cat([E, 1.0 / Dc[:, :-1][..., box_idx]], dim=-1)
        Ed = E[..., :m, None]
        G = G * Ed * Dc[:, :-1, None, :ndx]
        B = B * Ed * Dc[:, :-1, None, ndx:]
        C = C * Ed * Dc[:, 1:, None, :ndx]
        P_diag = P_diag * Dc * Dc
        q = q * Dc
        l = l * E
        u = u * E
        x0 = None if x0 is None else x0 / Dc
        z0 = None if z0 is None else z0 * E
        y0 = None if y0 is None else y0 / E
    work = prepare(G, B, C, P_diag, l, u, cfg, box_idx=box_idx,
                   rho_vec=rho_vec, c_eye_rows=c_eye_rows)
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
    if E is not None:
        x, z, y = x * Dc, z / E, y * E
    return ((x, z, y), work) if return_work else (x, z, y)
