"""Share of the closer's constraint-space factorizations' least time (their
work counted from the shapes, against the published peaks) in the device
time under their qp._factorize_by_name spans, in %.

They are told from the KKT factorization by their node count: the
constraint-space system has one block per stage (N), the KKT system one
per node (N + 1). A tick without them (no closer) reads nothing."""

from benchmark.roofline import bound_s, factor_work


def read(run):
    calls = [] if run.trace is None else run.trace["factorize"]
    if not calls:
        return None
    kkt_nodes = max(shape[1] for shape, _ in calls)
    calls = [(shape, us) for shape, us in calls if shape[1] == kkt_nodes - 1]
    dev_us = sum(us for _, us in calls)
    if dev_us <= 0:
        return None
    least = sum(bound_s(*factor_work(*shape)) for shape, _ in calls)
    return 100.0 * least / (dev_us * 1e-6)
