"""The control's precision: TF32, the nearest below the configurations'
float32 with TF32 off.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits; a TF32
matrix product rounds both operands so and accumulates in float32.
:func:`tf32` does that rounding on a float32 tensor, so the control runs
the same on the CPU and on the card, whatever the card's TF32 switch.
"""

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32, rounded to the nearest TF32 value (ties away from
    zero); finite values only."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float64 (the reference) or with TF32 operands and
    float32 accumulation (the control)."""
    if precision == "float64":
        return a.to(torch.float64) @ b.to(torch.float64)
    if precision == "tf32":
        return tf32(a) @ tf32(b)
    raise ValueError(f"unknown precision {precision!r}")


def cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` in the precision's elementwise type."""
    return x.to(torch.float64 if precision == "float64" else torch.float32)
