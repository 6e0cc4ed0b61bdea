"""Share of the scenarios through the accurate-mode closer whose kept
max-violation is within the production tolerance (1e-3), in %: the
program's device tallies (``tpu_locoman_torch.trace.tallies()``), read
once after the window. The scenarios through the closer are the sum of
the histogram of the kept pass.

The tallies count every tick of the process: the warm-up ticks and the
whole window, the traced ticks among them. Numerator and denominator
count the same ticks, so the share is over them all and the two warm-up
ticks weigh as one tick of the window each. A program without tallies,
or a run whose closer never ran, reads nothing."""


def read(run):
    if run.trace is None:
        return None
    from tpu_locoman_torch import trace

    if not hasattr(trace, "tallies"):
        return None
    t = trace.tallies()
    n = sum(t.get("sqp.eq_projection.kept_pass", []))
    if n <= 0:
        return None
    return 100.0 * t["sqp.eq_projection.within_tol"] / n
