"""Share of the traced ticks' wall span in which no operation ran on the
device, in %."""


def read(run):
    s = run.trace
    if s is None or s["device_ops"] == 0:
        return None
    return 100.0 * (1.0 - s["busy_us"] / s["window_us"])
