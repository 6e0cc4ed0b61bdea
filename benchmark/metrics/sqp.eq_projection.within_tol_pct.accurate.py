"""Share of the scenarios through the accurate-mode closer whose kept
max-violation is within the production tolerance (1e-3), in %, over the
window's first ``quality_ticks`` ticks (``workloads/<cell>.json``; fewer
where the window holds fewer), as ``violation_mean`` counts them.

``window_read`` resets the program's device tallies
(``tpu_locoman_torch.trace``) before the window of a ``--trace 1`` run and
gives the harness the read that it takes once, between window ticks
``quality_ticks`` - 1 and ``quality_ticks`` (``Run.snapshots``): a fixed
count of ticks, so a faster program is not held over a longer stretch of
the closed-loop rollout, whose violation grows with its length. The
scenarios through the closer are the sum of the histogram of the kept
pass. A run without that read, or whose closer never ran, reads nothing."""

import os

NAME = os.path.basename(__file__)[:-len(".py")]


def window_read():
    from tpu_locoman_torch import trace

    trace.reset_tallies()
    return trace.tallies


def read(run):
    t = (run.snapshots or {}).get(NAME)
    if run.trace is None or not t:
        return None
    n = sum(t.get("sqp.eq_projection.kept_pass", []))
    if n <= 0:
        return None
    return 100.0 * t["sqp.eq_projection.within_tol"] / n
