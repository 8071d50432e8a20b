"""Seconds per run_chains call: the window's seconds over its calls."""


def read(run):
    return run.window_s / len(run.calls) if run.calls else None
