"""The traced call's smallest bulk ESS over coordinates per draw (chains
x draws)."""


def read(run):
    call = run.calls[0]
    if call.min_ess is None or not call.n_draws:
        return None
    return call.min_ess / call.n_draws
