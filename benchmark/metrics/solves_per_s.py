"""Scenario-ticks completed in the window over the window's seconds."""


def read(run):
    return run.scenario_ticks / run.window_s
