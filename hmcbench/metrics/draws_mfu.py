"""The whole step's share of the float32 peak over the traced call's draws:
the operations the draws' leaves needed over the draws' wall (the warmup's
end to the call's end, host clock, both synchronised) over 67 TFLOP/s."""

from hmcbench.reference import peaks
from hmcbench.rooflines import draws_flops


def read(run):
    call = run.calls[0]
    if run.trace is None or call.warmup_s is None:
        return None
    seconds = call.wall_s - call.warmup_s
    return 100.0 * draws_flops(run) / seconds / peaks.FP32_FLOP_PER_S
