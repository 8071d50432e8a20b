"""The whole step's share of the float32 peak over the traced call's
warmup, the twin of draws_mfu: the operations the warmup's leaves needed
(the port's ``warmup_steps``, the leapfrog steps of the warmup's
transitions, counted under the profiler) over the warmup's wall (the
call's entry to the warmup's end, host clock, both synchronised) over
67 TFLOP/s."""

from hmcbench.reference import peaks


def read(run):
    call = run.calls[0]
    steps = call.launches.get("warmup_steps")
    if run.trace is None or call.warmup_s is None or steps is None:
        return None
    flops = steps * run.reference.leaf_flops(run.config)
    return 100.0 * flops / call.warmup_s / peaks.FP32_FLOP_PER_S
