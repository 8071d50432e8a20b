"""The fused logistic-regression leaf (K3: its slice and finish kernels)
over the traced call's draws: percent of its roofline. The bound is the
larger of the operations of the chain rows the draws handed it (the
port's ``fused_leaf_rows`` in the draws, times the reference's
``leaf_flops``) over the float32 peak and its launches' bytes (the
reference's ``launch_bytes``, every input and output once) over the
memory rate; the time is the summed device time of both kernels' launches
after the warmup's end. It counts rows handed, not launches x chains, so
a port that hands K3 fewer rows cannot read above 100%."""

from hmcbench.reference import peaks

SLICE, FINISH = "logreg_leaf_slice_kernel", "logreg_leaf_finish_kernel"


def read(run):
    trace = run.trace
    rows = (run.calls[0].launches.get("fused_leaf_rows") or {}).get("draws")
    if trace is None or trace.draws_start_s is None or not rows:
        return None
    slices = trace.kernels(SLICE, after=trace.draws_start_s)
    finishes = trace.kernels(FINISH, after=trace.draws_start_s)
    kernel_s = sum(b - a for _, a, b in slices + finishes)
    if not slices or kernel_s <= 0:
        return None
    n_bytes = len(slices) * run.reference.launch_bytes(
        run.config, int(run.cell["chains"]))
    bound_s, _ = peaks.bound_seconds(
        rows * run.reference.leaf_flops(run.config), n_bytes)
    return 100.0 * bound_s / kernel_s
