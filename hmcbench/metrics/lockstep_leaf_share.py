"""Percent of the chain rows handed to the fused leaf in the traced
call's draws that the sampler needed: the draws' leapfrog steps (the sum
of their tree_statistics.steps) over the port's ``fused_leaf_rows`` in
the draws. The rest are rows of chains whose trees had ended, which the
plain driver's lockstep leaves carry along."""


def read(run):
    call = run.calls[0]
    rows = (call.launches.get("fused_leaf_rows") or {}).get("draws")
    if not rows:
        return None
    return 100.0 * call.draw_steps / rows
