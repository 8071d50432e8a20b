"""ESS per second: the sum over the window's calls of each call's smallest
bulk ESS over coordinates, over the window's seconds (a failed call adds
its time and no ESS)."""


def read(run):
    if not run.calls:
        return None
    ess = sum(c.min_ess for c in run.calls if not c.failed)
    return ess / run.window_s
