"""The H100's published peaks (NVIDIA H100 SXM data sheet, dense rates, at
the full 700 W power limit) and the roofline bound of a piece of work.

The port's kernels compute in float32 outside the tensor cores (no TF32),
so the compute peak is the float32 one.
"""

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(flops: float, n_bytes: float):
    """(seconds, bound_by): the larger of the operations over the float32
    peak and the bytes over the memory rate."""
    t_ops = flops / FP32_FLOP_PER_S
    t_mem = n_bytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops > t_mem else (t_mem, "bytes")
