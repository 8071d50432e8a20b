"""Percent of the traced call's batch transitions (warmup and draws, the
port's ``transitions_*`` counters) that launched the tree kernel; the
rest ran the plain driver (the hook's ``tree_transition_declined``)."""


def read(run):
    counts = run.calls[0].launches
    if "transitions_warmup" not in counts:
        return None
    transitions = counts["transitions_warmup"] + counts["transitions_draws"]
    if not transitions:
        return None
    return 100.0 * counts.get("tree_transition", 0) / transitions
