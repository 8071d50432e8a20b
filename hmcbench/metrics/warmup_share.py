"""Percent of the traced call spent in the stepsize search and the warmup
stages: from the call's entry to the warmup checkpoint after its last
stage, where the traced call synchronises."""


def read(run):
    call = run.calls[0]
    if run.trace is None or call.warmup_s is None:
        return None
    return 100.0 * call.warmup_s / call.wall_s
