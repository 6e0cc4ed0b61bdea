"""Solver structure and solve-quality diagnostics.

PyTorch counterpart of ``tpu_locoman/diagnostics.py``: the named row
groups of a node's constraint vector, a structured report of one solve,
the stage-structure check of the Jacobian blocks the KKT solver relies
on, its spy plot, and a ``torch.profiler`` trace context. The port's MPC
is batched: the report and the checks take one scenario (a batch of one,
or ``scenario`` of a batch), as the JAX package's take its one.
"""

import contextlib
import os
from dataclasses import dataclass, field

import numpy as np
import torch


def row_group_layout(trans):
    """[(name, first row, end row)] of the per-node constraint vector."""
    form = trans.form
    nv = form.nv
    groups = []
    off = 0

    def add(name, n):
        nonlocal off
        groups.append((name, off, off + n))
        off += n

    name = form.name
    if name == "centroidal_vel":
        add("dyn:h_prop", 6)
        add("dyn:q_prop", nv)
        if form.include_base:
            add("dyn:gaps", 6)
    elif name in ("centroidal_acc", "whole_body_acc"):
        add("dyn:q_prop", nv)
        add("dyn:v_prop", nv)
        if form.include_base:
            add("dyn:gaps", 6)
    elif name == "whole_body_rnea":
        add("dyn:q_prop", nv)
        if form.include_acc:
            add("dyn:v_prop", nv)
        add("dyn:rnea_base", 6)
        add("dyn:tau_eq", form.nj)
    elif name == "whole_body_aba":
        add("dyn:q_prop", nv)
        add("dyn:v_prop", nv)
    add("eq:swing_zero_force", 3 * form.n_feet)
    add("eq:contact_vel_xy", 2 * form.n_feet)
    add("eq:vel_z_blend", form.n_feet)
    if trans.has_ext:
        add("eq:ext_force", 3)
    if trans.has_arm:
        add("eq:arm_vel", 3)
    add("ineq:friction_normal", form.n_feet)
    add("ineq:friction_cone", form.n_feet)
    add("ineq:joint_pos", form.nj)
    add("ineq:joint_vel", form.nj)
    if trans.has_tau:
        add("ineq:torque", form.nj)
    assert off == trans.m, (off, trans.m)
    return groups


@dataclass
class SolveReport:
    max_violation: float
    violation_by_group: dict
    objective: float
    alpha: float
    extras: dict = field(default_factory=dict)

    def pretty(self):
        lines = [
            f"max_violation: {self.max_violation:.5f}",
            f"objective:     {self.objective:.3f}",
            f"alpha:         {self.alpha:.3f}",
            "violation by row group:",
        ]
        for k, v in sorted(self.violation_by_group.items(),
                           key=lambda kv: -kv[1]):
            lines.append(f"  {k:24s} {v:.5f}")
        return "\n".join(lines)


def solve_report(mpc, carry, t_current, base_vel_des, solve=False,
                 scenario=0, **target_kw):
    """Report on scenario ``scenario`` of the carried iterate, or (with
    ``solve=True``) of the iterate after one MPC solve from the carry, with
    that solve's line-search alpha and status."""
    B = carry.x_init.shape[0]
    shared = mpc.make_shared(carry.x_init, base_vel_des,
                             tau_prev=carry.tau_prev, **target_kw)
    t = torch.as_tensor(t_current, dtype=torch.float32, device=mpc.device)
    sp = mpc.make_stage_params(t.expand(B) if t.dim() == 0 else t)
    trans = mpc.trans
    extras = {}
    if solve:
        warm = carry.solver_state._replace(
            Z=mpc.warm_start_Z(carry.solver_state.Z, sp, shared))
        state, stats = mpc.solver.solve(warm, sp, shared)
        Z = state.Z
        alpha = float(stats["alpha"][scenario])
        extras["status"] = int(stats["status"][scenario])
    else:
        Z = carry.solver_state.Z
        alpha = float("nan")
    g = trans.evaluate(Z, sp, shared)
    lo, hi = trans.bounds(sp, shared)
    viol = (torch.clamp(lo - g, min=0) + torch.clamp(g - hi, min=0))[
        scenario].cpu().numpy()
    by_group = {name: float(viol[:, a:b].max()) if b > a else 0.0
                for name, a, b in row_group_layout(trans)}
    obj = trans.objective_value(Z, trans.objective_data(shared))[scenario]
    return SolveReport(max_violation=float(viol.max()),
                       violation_by_group=by_group, objective=float(obj),
                       alpha=alpha, extras=extras)


def _stage_jacobian(mpc, t):
    """(G, B, C) of one scenario at the nominal carry's shared parameters
    and a seeded iterate N(0, 0.01^2) (the JAX package's draws)."""
    trans = mpc.trans
    carry = mpc.init_carry(1)
    shared = mpc.make_shared(carry.x_init, torch.zeros(6, device=mpc.device),
                             tau_prev=carry.tau_prev)
    sp = mpc.make_stage_params(torch.full((1,), t, device=mpc.device))
    rng = np.random.default_rng(0)
    Z = torch.as_tensor(rng.normal(size=(mpc.nodes + 1, trans.s)) * 0.01,
                        dtype=torch.float32, device=mpc.device)[None]
    _, G, B, C = trans.linearize(Z, sp, shared)
    return G[0].cpu().numpy(), B[0].cpu().numpy(), C[0].cpu().numpy()


def structure_check(mpc, tol=1e-6):
    """The stage-structure facts the KKT solver relies on: node i's rows
    touch only (dx_i, u_i, dx_{i+1}), with the share of entries above
    ``tol`` in each block."""
    trans = mpc.trans
    G, B, C = _stage_jacobian(mpc, 0.0)
    return {
        "rows_per_node": trans.m,
        "eq_rows": trans.n_eq,
        "ineq_rows": trans.n_ineq,
        "stage_width": trans.s,
        "G_nonzero_frac": float((np.abs(G) > tol).mean()),
        "B_nonzero_frac": float((np.abs(B) > tol).mean()),
        "C_nonzero_frac": float((np.abs(C) > tol).mean()),
        "finite": bool(np.all(np.isfinite(G)) and np.all(np.isfinite(B))
                       and np.all(np.isfinite(C))),
    }


def spy_plot(mpc, path, node=1, tol=1e-6):
    """Spy plot of one node's [G | B | C] nonzeros with the row groups
    marked, and in red the entries outside the expected structure (C
    outside the constant propagation pattern). Needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    trans = mpc.trans
    G, B, C = _stage_jacobian(mpc, 0.13)
    GBC = np.concatenate([G[node], B[node], C[node]], axis=1)
    actual = np.abs(GBC) > tol
    C_pat = mpc.form.dx_next_pattern()
    offending = np.zeros_like(actual)
    if C_pat is not None:
        expected_C = np.zeros((trans.m_dense, trans.ndx), dtype=bool)
        expected_C[:mpc.form.n_dyn] = np.abs(C_pat) > 0
        offending[:, trans.s:] = (np.abs(C[node]) > tol) & ~expected_C

    fig, ax = plt.subplots(figsize=(12, 9))
    img = np.zeros(actual.shape + (3,))
    img[actual] = [0.15, 0.45, 0.85]
    img[offending] = [0.9, 0.1, 0.1]
    ax.imshow(1 - 0.9 * (img.sum(-1) > 0)[..., None] * (1 - img),
              aspect="auto", interpolation="nearest")
    for x_ in (trans.ndx, trans.s):
        ax.axvline(x_ - 0.5, color="k", lw=0.8)
    for name, a, b in row_group_layout(trans):
        if b > a and a < trans.m_dense:
            ax.axhline(a - 0.5, color="gray", lw=0.5)
            ax.text(GBC.shape[1] + 1, (a + min(b, trans.m_dense)) / 2, name,
                    fontsize=6, va="center")
    ax.set_title(f"node {node} stage Jacobian [G | B | C] nonzeros "
                 f"(red = outside expected structure)")
    ax.set_xlabel("dx | u | dx_next")
    ax.set_ylabel("constraint row")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return {"path": path, "offending_entries": int(offending.sum())}


@contextlib.contextmanager
def profile_trace(logdir):
    """torch.profiler over the block (the host, and the card when there is
    one); on exit the Chrome trace is written to ``logdir``/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
