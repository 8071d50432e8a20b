"""Cached evaluations with -inf poisoning (port of ``dynamichmc_tpu.hamiltonian``).

``EvaluatedPoint`` caches (q, logdensity, gradient) so each leapfrog step
costs exactly one gradient evaluation. A non-finite log density or gradient
is poisoned to -inf instead of raising, unless the value already is exactly
-inf (a clean rejection): the leaf then becomes divergent and the sampler
rejects it and continues.
"""

from __future__ import annotations

import dataclasses

import torch

from .logdensity import LogDensity


@dataclasses.dataclass
class EvaluatedPoint:
    """Log density evaluated at a batch of positions."""

    q: torch.Tensor  # (C, K)
    logdensity: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, K)


def evaluate(ld: LogDensity, q: torch.Tensor) -> EvaluatedPoint:
    """Batched non-strict evaluation with -inf poisoning."""
    value, grad = ld.logdensity_and_gradient(q)
    ok = torch.isfinite(value) & torch.isfinite(grad).all(dim=-1)
    value = torch.where(ok | (value == -torch.inf), value, -torch.inf)
    return EvaluatedPoint(q=q, logdensity=value, grad=grad)
