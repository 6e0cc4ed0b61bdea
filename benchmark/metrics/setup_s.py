"""Process start to the first timed tick, in seconds."""


def read(run):
    return run.setup_s
