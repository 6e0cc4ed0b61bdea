"""Device ms per traced tick of the operations launched under the
Transcription.linearize spans."""


def read(run):
    s = run.trace
    if s is None:
        return None
    us = s["device_us"]["Transcription.linearize"]
    return us / 1e3 / s["ticks"] if us > 0 else None
