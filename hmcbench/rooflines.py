"""A kernel's share of its roofline over the traced call's draws.

The bound is the larger of the operations over the float32 peak and the
bytes over the memory rate (reference/peaks.py). Operations: the leaves
the draws needed (the sum of the draws' leapfrog steps) times the
configuration's operations per leaf; bytes: each launch's inputs and
outputs once (the reference's ``launch_bytes``). The time: the summed
device time of the kernel's launches after the warmup's end.
"""

from hmcbench.reference import peaks


def draws_flops(run) -> float:
    """Operations the traced call's draws needed."""
    return run.calls[0].draw_steps * run.reference.leaf_flops(run.config)


def kernel_roofline(run, pattern: str):
    """Percent of the bound for the kernels named like ``pattern``; None
    where the traced call's draws launched none."""
    trace = run.trace
    if trace is None or trace.draws_start_s is None:
        return None
    launches = trace.kernels(pattern, after=trace.draws_start_s)
    if not launches:
        return None
    kernel_s = sum(b - a for _, a, b in launches)
    n_bytes = len(launches) * run.reference.launch_bytes(
        run.config, int(run.cell["chains"]))
    bound_s, _ = peaks.bound_seconds(draws_flops(run), n_bytes)
    return 100.0 * bound_s / kernel_s
