"""Device ms per traced tick under the admm_solve and eq_project spans."""


def read(run):
    s = run.trace
    if s is None:
        return None
    us = s["device_us"]["admm_solve"] + s["device_us"]["eq_project"]
    return us / 1e3 / s["ticks"] if us > 0 else None
