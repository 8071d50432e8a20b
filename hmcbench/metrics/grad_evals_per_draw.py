"""Leapfrog steps (gradient evaluations) per draw in the traced call: the
mean of the draws' tree_statistics.steps."""


def read(run):
    call = run.calls[0]
    return call.draw_steps / call.n_draws if call.n_draws else None
