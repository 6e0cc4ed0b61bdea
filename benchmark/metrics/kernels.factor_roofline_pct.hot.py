"""Share of the factorizations' least time (their work counted from the
shapes, against the published peaks) in the device time under the
qp._factorize_by_name spans, in %."""

from benchmark.roofline import bound_s, factor_work


def read(run):
    calls = [] if run.trace is None else run.trace["factorize"]
    dev_us = sum(us for _, us in calls)
    if dev_us <= 0:
        return None
    least = sum(bound_s(*factor_work(*shape)) for shape, _ in calls)
    return 100.0 * least / (dev_us * 1e-6)
