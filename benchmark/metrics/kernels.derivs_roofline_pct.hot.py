"""Share of the RNEA derivatives' least time (the bytes of q, v, a, f in
and of dtau/d(q, v, a, f) out, against the published bandwidth) in the
device time under the rnea_derivs.rnea_derivatives spans, forward pass
included, in %."""

from benchmark.roofline import bound_s, derivs_bytes


def read(run):
    calls = [] if run.trace is None else run.trace["derivs"]
    dev_us = sum(us for _, us in calls)
    if dev_us <= 0:
        return None
    least = sum(bound_s(derivs_bytes(*shape), 0) for shape, _ in calls)
    return 100.0 * least / (dev_us * 1e-6)
