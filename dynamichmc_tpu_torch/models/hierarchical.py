"""Hierarchical and pathological model families beyond the Gaussian zoo
(port of ``dynamichmc_tpu.models.hierarchical``).

A non-centered eight-schools posterior (the canonical hierarchical model,
well-behaved), its centered variant (funnel-pathological: exercises the
divergence diagnostics), and the Rosenbrock/banana density (strong
nonlinear correlation; no exact sampler). The log densities are batched,
``(..., dim) -> (...)``, with gradients from autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from ..logdensity import resolve_device
from .base import TestModel

# Classic eight-schools data (Rubin 1981)
SCHOOLS_Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
SCHOOLS_SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])


def _schools_data(dtype, device):
    return (torch.as_tensor(SCHOOLS_Y, dtype=dtype, device=device),
            torch.as_tensor(SCHOOLS_SIGMA, dtype=dtype, device=device))


def eight_schools_noncentered(dtype=torch.float64, device="cuda") -> TestModel:
    """q = (mu, log_tau, z_1..z_8); theta_j = mu + tau * z_j.

    Non-centered parameterization: the geometry HMC handles well; the
    recommended form for hierarchical models.
    """
    device = resolve_device(device)
    y_t, sigma_t = _schools_data(dtype, device)

    def logdensity_fn(q):
        y, sigma = y_t.to(q.dtype), sigma_t.to(q.dtype)
        mu, log_tau, z = q[..., 0], q[..., 1], q[..., 2:]
        tau = torch.exp(log_tau)
        theta = mu[..., None] + tau[..., None] * z
        lp = -0.5 * (mu / 5.0) ** 2  # mu ~ N(0, 5)
        lp = lp + (-0.5 * (log_tau / 5.0) ** 2 + log_tau)  # prior + Jacobian
        lp = lp + -0.5 * (z * z).sum(-1)  # z ~ N(0, 1)
        lp = lp + -0.5 * (((y - theta) / sigma) ** 2).sum(-1)
        return lp

    return TestModel(dim=10, logdensity_fn=logdensity_fn, device=device)


def eight_schools_centered(dtype=torch.float64, device="cuda") -> TestModel:
    """q = (mu, log_tau, theta_1..theta_8): the funnel-pathological centered
    form; expect divergences / low EBFMI, surfaced by the diagnostics. The
    ``- 8 * log_tau`` term is the JAX package's, kept as it is."""
    device = resolve_device(device)
    y_t, sigma_t = _schools_data(dtype, device)

    def logdensity_fn(q):
        y, sigma = y_t.to(q.dtype), sigma_t.to(q.dtype)
        mu, log_tau, theta = q[..., 0], q[..., 1], q[..., 2:]
        tau = torch.exp(log_tau)
        lp = -0.5 * (mu / 5.0) ** 2
        lp = lp + (-0.5 * (log_tau / 5.0) ** 2 + log_tau)
        lp = lp + (-0.5 * (((theta - mu[..., None]) / tau[..., None]) ** 2
                           ).sum(-1) - 8 * log_tau)
        lp = lp + -0.5 * (((y - theta) / sigma) ** 2).sum(-1)
        return lp

    return TestModel(dim=10, logdensity_fn=logdensity_fn, device=device)


def rosenbrock(dim: int = 2, a: float = 1.0, b: float = 5.0,
               dtype=torch.float64, device="cuda") -> TestModel:
    """Banana-shaped density: pairs (x, y) with y | x ~ N(b (x^2), ...).

    log p = -sum_i [ (x_i - a)^2 / 20 + (y_i - b x_i^2)^2 ] over dim//2
    pairs. It holds no tensors; ``dtype`` is the JAX signature's.
    """
    if dim % 2:
        raise ValueError("rosenbrock dim must be even")
    device = resolve_device(device)

    def logdensity_fn(q):
        x = q[..., 0::2]
        y = q[..., 1::2]
        return -((x - a) ** 2 / 20.0 + (y - b * x**2) ** 2).sum(-1)

    return TestModel(dim=dim, logdensity_fn=logdensity_fn, device=device)
