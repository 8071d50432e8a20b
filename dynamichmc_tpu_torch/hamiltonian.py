"""Cached evaluations, phase points and the leapfrog, with -inf poisoning
(port of ``dynamichmc_tpu.hamiltonian``).

``EvaluatedPoint`` caches (q, logdensity, gradient) so each leapfrog step
costs exactly one gradient evaluation. A non-finite log density or gradient
is poisoned to -inf instead of raising, unless the value already is exactly
-inf (a clean rejection): the leaf then becomes divergent and the sampler
rejects it and continues. The joint density turns any non-finite value into
-inf.

``evaluate`` works on one chain ((K,) positions) and on a batch ((C, K));
``PhasePoint``, ``joint_logdensity`` and ``leapfrog`` are the per-chain
pieces of the per-chain drivers (tree.py, nuts.py, stepsize.py).
``evaluate_strict`` checks the user's initial position on the host and
raises ``DynamicHMCError`` with a payload.
"""

from __future__ import annotations

import dataclasses

import torch

from .errors import DynamicHMCError
from .logdensity import LogDensity
from .metric import Metric, kinetic_energy, psharp


@dataclasses.dataclass
class EvaluatedPoint:
    """Log density evaluated at a position (K,) or a batch of positions
    (C, K); the gradient is cached for reuse."""

    q: torch.Tensor  # (K,) or (C, K)
    logdensity: torch.Tensor  # () or (C,)
    grad: torch.Tensor  # (K,) or (C, K)


@dataclasses.dataclass
class PhasePoint:
    """Position (with cached evaluation) plus momentum."""

    Q: EvaluatedPoint
    p: torch.Tensor


def evaluate(ld: LogDensity, q: torch.Tensor) -> EvaluatedPoint:
    """Non-strict evaluation with -inf poisoning, per chain or batched."""
    value, grad = ld.logdensity_and_gradient(q)
    ok = torch.isfinite(value) & torch.isfinite(grad).all(dim=-1)
    value = torch.where(ok | (value == -torch.inf), value, -torch.inf)
    return EvaluatedPoint(q=q, logdensity=value, grad=grad)


def evaluate_strict(ld: LogDensity, q) -> EvaluatedPoint:
    """Host-side strict evaluation of the initial position (K,).

    Raises :class:`DynamicHMCError` with a debug payload on a non-finite
    position, value or gradient. As in the JAX package, a value of exactly
    -inf is rejected too: a -inf initial joint density would make every
    leaf's delta NaN."""
    q = torch.as_tensor(q)
    if not bool(torch.isfinite(q).all()):
        raise DynamicHMCError("Position vector has non-finite elements.",
                              q=q.cpu())
    value, grad = ld.logdensity_and_gradient(q)
    value_h, grad_h = value.cpu(), grad.cpu()
    if bool(torch.isfinite(value_h)) and bool(torch.isfinite(grad_h).all()):
        return EvaluatedPoint(q=q, logdensity=value, grad=grad)
    if bool(torch.isfinite(value_h)):
        raise DynamicHMCError("Gradient has non-finite elements.", q=q.cpu(),
                              grad=grad_h)
    raise DynamicHMCError("Invalid log posterior.", q=q.cpu(),
                          logdensity=value_h)


def joint_logdensity(metric: Metric, z: PhasePoint) -> torch.Tensor:
    """log p(q) - K(p); a non-finite position density gives -inf, a
    non-finite kinetic energy counts as +inf energy."""
    lq = z.Q.logdensity
    k = kinetic_energy(metric, z.p)
    k = torch.where(torch.isfinite(k), k, torch.inf)
    return torch.where(torch.isfinite(lq), lq - k, -torch.inf)


def calculate_psharp(metric: Metric, z: PhasePoint) -> torch.Tensor:
    return psharp(metric, z.p)


leapfrog_calls = 0  # calls of leapfrog (each one a fused hook call when set)


def reset_leapfrog_calls() -> None:
    global leapfrog_calls
    leapfrog_calls = 0


def leapfrog(ld: LogDensity, metric: Metric, z: PhasePoint, eps) -> PhasePoint:
    """One velocity-Verlet step of one chain: exactly one gradient
    evaluation. A non-finite gradient at the new point propagates into the
    momentum and is caught by ``joint_logdensity`` (a divergent leaf, never
    an error). A model's ``fused_leapfrog_fn`` replaces the whole step."""
    global leapfrog_calls
    leapfrog_calls += 1
    if ld.fused_leapfrog_fn is not None:
        return ld.fused_leapfrog_fn(metric, z, eps)
    half = eps / 2
    p_mid = z.p + half * z.Q.grad
    q_new = z.Q.q + eps * psharp(metric, p_mid)
    Q_new = evaluate(ld, q_new)
    p_new = p_mid + half * Q_new.grad
    return PhasePoint(Q=Q_new, p=p_new)
