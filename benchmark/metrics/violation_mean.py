"""Mean of max_violation over every scenario of the window's first
``quality_ticks`` ticks (``workloads/<cell>.json``; fewer where the
window holds fewer). A fixed count of ticks, because the violation grows
along the closed-loop rollout: over the whole window a faster tick would
reach further into it and read worse."""


def read(run):
    ticks = run.tick_violation[:run.settings["quality_ticks"]]
    return sum(ticks) / len(ticks)
