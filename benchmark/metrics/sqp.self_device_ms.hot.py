"""Device ms per traced tick under SQPSolver.solve outside its linearize
and QP spans (objective, line search, evaluations, corrector)."""


def read(run):
    s = run.trace
    if s is None:
        return None
    us = s["device_us"]
    own = (us["SQPSolver.solve"] - us["Transcription.linearize"]
           - us["admm_solve"] - us["eq_project"])
    return own / 1e3 / s["ticks"] if us["SQPSolver.solve"] > 0 else None
