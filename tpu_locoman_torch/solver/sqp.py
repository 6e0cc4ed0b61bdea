"""SQP outer loop with the vectorized filter line search, the corrector and
the accurate-mode closers.

PyTorch counterpart of ``SQPConfig`` (with the ``fast`` and ``accurate``
presets), ``SolverState`` and ``SQPSolver._solve`` in
``tpu_locoman/solver/sqp.py``, batched over scenarios: every per-scenario
scalar (alpha, violation, status) is a (B,) tensor, and the
``eq_projection`` scan is a loop over passes whose best-so-far safeguard is
kept per scenario.
"""

from typing import NamedTuple

import torch

from .. import trace
from .graphs import Graphed
from .qp import (ADMMConfig, _A_matvec, admm_solve, eq_project, kkt_polish,
                 run_iters)

#: the production guarantee of accurate mode, max-violation at most this:
#: upstream's Fatrop ``tol`` (lukasmolnar/pino-locoman,
#: ``optimization/ocp.py:248-262``)
PRODUCTION_TOL = 1e-3


class SQPConfig(NamedTuple):
    sqp_iters: int = 1
    admm: ADMMConfig = ADMMConfig()
    admm_schedule: tuple = None
    corrector_iters: int = 0
    kkt_polish: bool = False
    eq_projection: int = 0
    line_search: bool = True
    armijo_factor: float = 1e-4
    a_decay: float = 0.5
    n_trials: int = 8
    g_max: float = 1e-3
    g_min: float = 1e-5
    gamma: float = 1e-5

    @classmethod
    def fast(cls):
        """The real-time hot config: 1 SQP iteration, 10 ADMM sweeps."""
        return cls(sqp_iters=1, admm=ADMMConfig(iters=10))

    @classmethod
    def accurate(cls):
        """Production tolerance: mean max-violation <= 1e-3 over a rollout
        (the reference's Fatrop tolerance). The hot config plus 4
        equality-projection passes."""
        return cls(sqp_iters=1, admm=ADMMConfig(iters=10), eq_projection=4)


PRESETS = {"fast": SQPConfig.fast, "accurate": SQPConfig.accurate}


class SolverState(NamedTuple):
    """Warm-start carry: Z (B, N+1, s), ADMM z and y (B, N, m)."""

    Z: torch.Tensor
    z_admm: torch.Tensor
    y_admm: torch.Tensor


def _viol(g, l_b, u_b):
    return torch.clamp(l_b - g, min=0.0) + torch.clamp(g - u_b, min=0.0)


def _norm(viol):
    return torch.sqrt((viol * viol).sum((-1, -2)))


def _amax(viol):
    return viol.amax((-1, -2))


class SQPSolver:
    def __init__(self, transcription, config=SQPConfig()):
        if config.sqp_iters < 1:
            raise ValueError("SQPConfig.sqp_iters must be >= 1")
        self.trans = transcription
        self.cfg = config
        # the residuals at the trial steps, the corrected and the projected
        # iterates: thousands of small launches per call, replayed on the
        # card as one CUDA graph per shape
        self._evaluate = Graphed(transcription.evaluate, "evaluate")

    def init_state(self, batch, device):
        t = self.trans
        z = torch.zeros(batch, t.nodes, t.m, device=device)
        return SolverState(Z=torch.zeros(batch, t.nodes + 1, t.s,
                                         device=device),
                           z_admm=z, y_admm=z.clone())

    def _line_search(self, Z, d, obj, sp, shared, l_b, u_b, g_at_Z):
        """All trial steps evaluated at once over a (n_trials, B) axis, then
        the reference's sequential acceptance rules replayed against the
        incumbent iterate."""
        cfg = self.cfg
        t = self.trans
        alphas = cfg.a_decay ** torch.arange(cfg.n_trials, dtype=Z.dtype,
                                             device=Z.device)
        Zc = Z + alphas[:, None, None, None] * d
        new_fs = t.objective_value(Zc, obj)  # (T, B)
        new_res = self._evaluate(Zc, sp, shared)  # (T, B, N, m)
        viol = _viol(new_res, l_b, u_b)
        new_gs, new_maxv = _norm(viol), _amax(viol)

        f0 = t.objective_value(Z, obj)
        viol0 = _viol(g_at_Z, l_b, u_b)
        g0 = _norm(viol0)
        armijo = (t.objective_gradient(Z, obj) * d).sum((-1, -2))
        B = Z.shape[0]
        accepted = torch.zeros(B, dtype=torch.bool, device=Z.device)
        alpha_acc = Z.new_zeros(B)
        maxv_acc = _amax(viol0)
        g_acc = g_at_Z
        small_desc = None
        for k in range(cfg.n_trials):
            a_k = alphas[k]
            new_f, new_g = new_fs[k], new_gs[k]
            small_desc = (torch.maximum(new_g, g0) < cfg.g_min) & (armijo < 0)
            c1 = (new_g > cfg.g_max) & (new_g < (1.0 - cfg.gamma) * g0)
            c2 = ((new_g <= cfg.g_max) & small_desc
                  & (new_f <= f0 + cfg.armijo_factor * armijo * a_k))
            c3 = ((new_g <= cfg.g_max) & ~small_desc
                  & ((new_f <= f0 - cfg.gamma * new_g)
                     | (new_g < (1.0 - cfg.gamma) * g0)))
            now = (~accepted) & (c1 | c2 | c3)
            alpha_acc = torch.where(now, a_k, alpha_acc)
            maxv_acc = torch.where(now, new_maxv[k], maxv_acc)
            g_acc = torch.where(now[:, None, None], new_res[k], g_acc)
            accepted = accepted | now
        alpha = torch.where(accepted, alpha_acc, torch.zeros_like(alpha_acc))
        return Z + alpha[:, None, None] * d, alpha, maxv_acc, g_acc

    def _eq_projection(self, Z, max_viol, P_diag, sp, shared, l_b, u_b):
        """Accurate-mode closer: cfg.eq_projection Gauss-Newton projections
        onto the equality manifold, each re-linearized at the current
        iterate. The passes run unguarded (the first routinely overshoots
        on the rnea curvature); the best iterate by true max violation is
        kept per scenario, and a non-finite pass restarts from it.

        Tallies on the device (``trace.tally``): a histogram of the pass
        whose iterate was kept, 0 for the SQP step's own
        (``sqp.eq_projection.kept_pass``, summing to the scenarios through
        the closer), and the scenarios kept within ``PRODUCTION_TOL``
        (``.within_tol``)."""
        t = self.trans
        cfg = self.cfg
        md = t.m_dense
        eq_rows = (u_b[..., :md] - l_b[..., :md]) < 1e-7
        best_Z, best_viol = Z, max_viol
        kept = torch.zeros_like(max_viol, dtype=torch.long)
        for k in range(cfg.eq_projection):
            with trace.span("sqp.eq_projection.pass", k=k) as span:
                g_now, Gf, Bf, Cf = t.linearize(Z, sp, shared)
                row_norm = torch.maximum(
                    Gf.abs().amax(-1),
                    torch.maximum(Bf.abs().amax(-1), Cf.abs().amax(-1)))
                W = (eq_rows & (row_norm > 1e-8)).to(Z.dtype)
                r = l_b[..., :md] - g_now[..., :md]
                Z = Z + eq_project(Gf, Bf, Cf, P_diag, r, W,
                                   factorizer=cfg.admm.factorizer,
                                   base=cfg.admm.chol_base)
                g_try = self._evaluate(Z, sp, shared)
                span.set(path=self._evaluate.path)
                viol_try = _amax(_viol(g_try, l_b, u_b))
                finite = torch.isfinite(viol_try)
                better = finite & (viol_try <= best_viol)
                best_Z = torch.where(better[:, None, None], Z, best_Z)
                best_viol = torch.where(better, viol_try, best_viol)
                kept = torch.where(better, k + 1, kept)
                Z = torch.where(finite[:, None, None], Z, best_Z)
        passes = torch.arange(cfg.eq_projection + 1, device=Z.device)
        trace.tally("sqp.eq_projection.kept_pass",
                    (kept[:, None] == passes).sum(0))
        trace.tally("sqp.eq_projection.within_tol",
                    (best_viol <= PRODUCTION_TOL).sum())
        return best_Z, best_viol

    def solve(self, state, stage_params, shared):
        """One MPC solve per scenario; returns (new_state, stats). TF32 is
        off for the whole solve: reduced-precision products wreck the KKT
        solve."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with trace.span("sqp.solve", sqp_iters=self.cfg.sqp_iters):
                return self._solve(state, stage_params, shared)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _solve(self, state, sp, shared):
        t = self.trans
        cfg = self.cfg
        obj = t.objective_data(shared)
        P_diag = t.hessian_diag(obj)
        l_b, u_b = t.bounds(sp, shared)
        Z, z_admm, y_admm = state.Z, state.z_admm, state.y_admm
        box = t.consts(Z.device)["box_slots"]
        for it in range(cfg.sqp_iters):
            admm_cfg = cfg.admm
            if cfg.admm_schedule is not None:
                admm_cfg = admm_cfg._replace(iters=cfg.admm_schedule[it])
            g, G, Bm, C = t.linearize(Z, sp, shared)
            q = t.objective_gradient(Z, obj)
            # the corrector reuses the last iteration's factorization (in
            # problem units: admm_solve refuses it under Ruiz scaling)
            want_work = cfg.corrector_iters > 0 and it == cfg.sqp_iters - 1
            out = admm_solve(
                G, Bm, C, P_diag, q, l_b - g, u_b - g, admm_cfg, z0=z_admm,
                y0=y_admm, box_idx=box, return_work=want_work,
                c_eye_rows=t.c_eye_rows)
            (d, z_admm, y_admm), work = out if want_work else (out, None)
            if cfg.kkt_polish:
                d = kkt_polish(G, Bm, C, P_diag, q, l_b - g, u_b - g, z_admm)
            # a failed QP (NaN) is a zero step, not a poisoned iterate
            bad = torch.isnan(d).any(-1).any(-1)
            keep = ~bad[:, None, None]
            d = torch.where(keep, d, torch.zeros_like(d))
            z_admm = torch.where(keep, z_admm, torch.zeros_like(z_admm))
            y_admm = torch.where(keep, y_admm, torch.zeros_like(y_admm))
            if cfg.line_search:
                with trace.span("sqp.line_search", trials=cfg.n_trials,
                                batch=Z.shape[0]) as span:
                    Z, alpha, max_viol, g_new = self._line_search(
                        Z, d, obj, sp, shared, l_b, u_b, g)
                    span.set(path=self._evaluate.path)
            else:
                Z = Z + d
                alpha = torch.ones(Z.shape[0], device=Z.device)
                g_new = self._evaluate(Z, sp, shared)
                max_viol = _amax(_viol(g_new, l_b, u_b))

        if cfg.corrector_iters > 0:
            # fresh residuals at the stepped iterate against the same
            # linearization and factorization, warm started from the main
            # QP's state shifted by the step taken
            with trace.span("sqp.corrector") as span:
                q2 = t.objective_gradient(Z, obj)
                Ad = _A_matvec(work.A, work.D, d, box)
                a3 = alpha[:, None, None]
                d2, z_admm, y_admm = run_iters(
                    work, q2, l_b - g_new, u_b - g_new, cfg.admm,
                    (1.0 - a3) * d, z_admm - a3 * Ad, y_admm,
                    cfg.corrector_iters, box_idx=box)
                bad2 = torch.isnan(d2).any(-1).any(-1)
                d2 = torch.where(bad2[:, None, None], torch.zeros_like(d2),
                                 d2)
                bad = bad | bad2
                Z = Z + d2
                g3 = self._evaluate(Z, sp, shared)
                span.set(path=self._evaluate.path)
                max_viol = _amax(_viol(g3, l_b, u_b))

        if cfg.eq_projection > 0:
            with trace.span("sqp.eq_projection", passes=cfg.eq_projection):
                Z, max_viol = self._eq_projection(Z, max_viol, P_diag, sp,
                                                  shared, l_b, u_b)

        status = torch.where(bad, 2, torch.where(alpha <= 0.0, 1, 0)).to(
            torch.int32)
        stats = {"max_violation": max_viol,
                 "objective": t.objective_value(Z, obj),
                 "alpha": alpha, "status": status}
        return SolverState(Z=Z, z_admm=z_admm, y_admm=y_admm), stats
