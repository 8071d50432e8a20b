"""Neal's funnel (port of ``dynamichmc_tpu.models.funnel``).

Exactly characterized: v ~ N(0, sigma_v^2); x_i | v ~ N(0, e^v),
i = 1..dim-1. The value is batched, ``(..., dim) -> (...)``; the gradient
comes from autograd, as the JAX model's comes from AD. ``tree_kernel=True``
attaches the whole-transition kernel with the funnel leaf (analytic
gradient; ops/tree_kernel.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..logdensity import resolve_device
from .base import TestModel


def funnel(dim: int, sigma_v: float = 3.0, dtype=torch.float64,
           device="cuda", tree_kernel: bool = False) -> TestModel:
    """q = (v, x_1..x_{dim-1}), on ``device`` ("cuda" unless the caller
    names another; raises where it does not exist)."""
    device = resolve_device(device)
    tree_transition_fn = None
    if tree_kernel:
        from ..ops.tree_kernel import make_funnel_tree_transition

        tree_transition_fn = make_funnel_tree_transition(dim, sigma_v)

    def logdensity_fn(q):
        v = q[..., 0]
        x = q[..., 1:]
        lp_v = -0.5 * (v / sigma_v) ** 2
        # x_i ~ N(0, e^v): -(dim-1)/2 * v - 0.5 * e^-v * sum x^2
        lp_x = -0.5 * (dim - 1) * v - 0.5 * torch.exp(-v) * (x * x).sum(-1)
        return lp_v + lp_x

    def sample_fn(generator, n):
        v = sigma_v * torch.randn((n, 1), generator=generator, dtype=dtype,
                                  device=device)
        x = torch.exp(v / 2) * torch.randn((n, dim - 1), generator=generator,
                                           dtype=dtype, device=device)
        return torch.cat([v, x], dim=1)

    # v-marginal misses -0.5 log(2 pi sigma_v^2); each x_i misses
    # -0.5 log(2 pi) (the -v/2 Jacobian part is in lp_x)
    log_normalization = float(-0.5 * dim * np.log(2 * np.pi) - np.log(sigma_v))
    return TestModel(
        dim=dim,
        logdensity_fn=logdensity_fn,
        tree_transition_fn=tree_transition_fn,
        device=device,
        sample_fn=sample_fn,
        log_normalization=log_normalization,
    )
