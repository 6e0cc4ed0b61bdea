"""Device operations (kernels, copies, memsets) per traced tick."""


def read(run):
    s = run.trace
    if s is None or s["device_ops"] == 0:
        return None
    return s["device_ops"] / s["ticks"]
