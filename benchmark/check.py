"""The comparison that decides ``correct``.

A sample of the window's ticks is kept as the program ran it: the carry it
started from, its clock and targets, the carry it returned and its stats.
The sample is the window's first tick, ``check.ticks`` ticks drawn from the
seed among the first ``check.horizon``, and the late tick: window tick
``check.late``, or the window's last where it holds fewer
(``workloads/<cell>.json``). Every kept tick is a fixed window tick, so a
faster program is held to the same ticks as a slower one, and not deeper
into a closed-loop rollout that degrades with its length (``PERF.md``).
Once the window has closed and the program's state is freed, the plain
reference (``benchmark/reference``, float32 with TF32 off) runs each of
those ticks again from the same carry, clock and targets, at the same
batch, and the program's answers are held to the reference's:

- ``x_gap``: the largest |x_program - x_reference| over the scenarios'
  next states (the state update the user's loop consumes);
- ``plan_gap``: the largest difference of the carried solution Z (the
  plan the next tick warm starts from: states, forces, torques and
  accelerations of every node), per scenario over the largest |Z| of the
  reference's plan (at least 1), the worst scenario;
- ``viol_gap``: |mean max_violation of the program - of the reference|
  over the reference's mean, the worst tick.

A gap that is not a number reads as infinite. The reference follows the
program tick by tick from the program's own carry: a closed-loop rollout
of either alone bifurcates under another float32 summation order (see
``PERF.md``)."""

import math

import torch

NAMES = ("x_gap", "plan_gap", "viol_gap")


def pick_ticks(rng, horizon, count):
    """Window tick indices besides the first and last to keep, drawn from
    the seed's stream."""
    count = max(0, min(count, horizon - 1))
    return set(int(k) for k in 1 + rng.choice(horizon - 1, count,
                                                replace=False))


def reference_carry(carry):
    from .reference.mpc import MPCCarry
    from .reference.solver import SolverState

    s = carry.solver_state
    return MPCCarry(carry.x_init, SolverState(s.Z, s.z_admm, s.y_admm),
                    carry.tau_prev)


def reference_step(ref, carry, t, base_vel, allow_tf32=False):
    """One tick of the reference MPC ``ref`` from ``carry``; the control
    runs it with TF32 products."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    ref.solver.allow_tf32 = allow_tf32
    try:
        return ref.step(reference_carry(carry), t, base_vel)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _finite(x):
    x = float(x)
    return x if math.isfinite(x) else math.inf


def gaps(out, stats, ref_out, ref_stats):
    """The compared numbers of one tick."""
    x = (out.x_init - ref_out.x_init).abs().amax()
    Z, Zr = out.solver_state.Z, ref_out.solver_state.Z
    plan = ((Z - Zr).abs().amax((1, 2))
            / Zr.abs().amax((1, 2)).clamp(min=1.0)).amax()
    v, vr = stats["max_violation"].mean(), ref_stats["max_violation"].mean()
    viol = (v - vr).abs() / vr.abs().clamp(min=1e-12)
    return {"x_gap": _finite(x), "plan_gap": _finite(plan),
            "viol_gap": _finite(viol)}


def compare_each(records, ref, base_vel):
    """Each kept tick's numbers, by window tick; ``records`` are (k,
    carry_in, t, carry_out, stats) of the program."""
    each = {}
    for k, carry, t, out, stats in records:
        ref_out, ref_stats = reference_step(ref, carry, t, base_vel)
        each[k] = gaps(out, stats, ref_out, ref_stats)
        del ref_out, ref_stats
    return each


def worst(each):
    """The worst of each number over the ticks of ``compare_each``."""
    return {n: max([0.0] + [g[n] for g in each.values()]) for n in NAMES}


def compare(records, ref, base_vel):
    """The worst of each number over the kept ticks."""
    return worst(compare_each(records, ref, base_vel))


def verdict(values, limits):
    """(correct, the numbers beside their limits): the cell's limits name
    the numbers it is held to."""
    shown = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    return all(values[k] <= limits[k] for k in limits), shown
