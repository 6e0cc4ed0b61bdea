"""Device ms per traced tick of the operations launched under the
eq_project spans: the accurate-mode closer's constraint-space Schur
complements, factorizations and refinement solves, every pass."""


def read(run):
    s = run.trace
    if s is None:
        return None
    us = s["device_us"]["eq_project"]
    return us / 1e3 / s["ticks"] if us > 0 else None
