"""The log-density (model) contract (port of ``dynamichmc_tpu.logdensity``).

A model is a dimension plus a value function. The port's functions are
*batched*: they take positions of shape ``(..., K)`` (the sampler passes a
``(C, K)`` chain batch) and return values of shape ``(...)``. The gradient
comes from ``torch.autograd`` unless the model supplies a fused
``logdensity_and_gradient_fn`` (the Gaussians do: both are one matmul).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class LogDensity:
    """A target log density on R^dim.

    Attributes:
      dim: dimension of the position vector.
      logdensity_fn: ``q (..., K) -> log p(q) (...)`` up to a constant.
      logdensity_and_gradient_fn: optional fused override returning
        ``(value (...), gradient (..., K))``.
      fused_leaf_batched_fn: optional fused batched leaf
        ``(metric, q, p, g, eps_signed) -> (q', p', g', ld', pi')`` with
        -inf poisoning applied (ops/logreg_leaf.py). When it is set, the
        plain batch driver (tree_batched.py) computes every leaf of a
        transition with it.
      fused_leapfrog_fn: optional fused leapfrog step
        ``(metric, z: PhasePoint, eps) -> PhasePoint`` with -inf poisoning
        applied (ops/gaussian_leapfrog.py). When it is set,
        ``hamiltonian.leapfrog`` hands it the whole step.
      tree_transition_fn: optional whole-transition kernel hook
        ``(generator, algorithm, metric, Q, eps, depth_limit) ->
        (Q', stats) | None`` (ops/tree_kernel.py). ``sample_tree_batched``
        hands the whole transition to it and runs the plain driver when it
        returns ``None`` (declines).
      device: where the model's tensors lie (set by the model factories);
        ``None`` for a model that holds no tensors. The entry points raise
        when it is not the generator's device (:func:`check_device`).
    """

    dim: int
    logdensity_fn: Callable
    logdensity_and_gradient_fn: Optional[Callable] = None
    fused_leapfrog_fn: Optional[Callable] = None
    fused_leaf_batched_fn: Optional[Callable] = None
    tree_transition_fn: Optional[Callable] = None
    device: Optional[torch.device] = None

    def logdensity(self, q):
        return self.logdensity_fn(q)

    def logdensity_and_gradient(self, q):
        if self.logdensity_and_gradient_fn is not None:
            return self.logdensity_and_gradient_fn(q)
        with torch.enable_grad():
            qq = q.detach().requires_grad_(True)
            value = self.logdensity_fn(qq)
            (grad,) = torch.autograd.grad(value.sum(), qq)
        return value.detach(), grad


def from_logdensity_fn(dim: int, fn: Callable) -> LogDensity:
    """Wrap a plain batched ``q -> value`` function as a :class:`LogDensity`."""
    return LogDensity(dim=dim, logdensity_fn=fn)


def resolve_device(device) -> torch.device:
    """The concrete device ``device`` names (``"cuda"`` -> ``cuda:0``).
    Raises where that device does not exist, e.g. ``"cuda"`` on a machine
    without CUDA: pass ``device="cpu"`` there."""
    try:
        return torch.empty(0, device=device).device
    except (AssertionError, RuntimeError) as err:
        raise RuntimeError(f"device {device!r} is not available ({err}); "
                           "pass device='cpu' to build on the CPU") from err


def check_device(ld: LogDensity, device) -> None:
    """Raise unless the model's tensors lie on ``device`` (the generator's).
    The entry points never move a model."""
    if ld.device is not None and resolve_device(ld.device) != resolve_device(device):
        raise ValueError(f"the model's tensors lie on {ld.device}, the "
                         f"generator on {device}: build the model on the "
                         "generator's device")
