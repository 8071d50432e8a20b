"""Coordinate-wise tail transforms of exactly characterized targets (port of
``dynamichmc_tpu.models.transforms``).

The analogue of LogDensityTestSuite's ``elongate`` heavy-tail construction
(used at DynamicHMC.jl test/sample-correctness_tests.jl:100-118): if X has
an exactly characterized distribution, Y = sign(X) |X|^(1+gamma) has heavier
(gamma > 0) tails, and both the log density (change of variables) and the
exact sampler (push-forward) remain available.
"""

from __future__ import annotations

import math

import torch

from .base import TestModel


def elongate(gamma: float, model: TestModel) -> TestModel:
    """y = sign(x) |x|^(1+gamma), coordinate-wise, applied to ``model``.

    log p_Y(y) = log p_X(x(y)) + sum log |dx/dy|, with
    x = sign(y) |y|^(1/(1+gamma)). Batched over leading axes of y.
    """
    if gamma <= -1:
        raise ValueError("gamma must be > -1")
    a = 1.0 + gamma
    inv_a = 1.0 / a

    def inverse(y):
        return torch.sign(y) * y.abs() ** inv_a

    def log_jacobian_inv(y):
        # dx/dy = (1/a) |y|^{1/a - 1}; guard y = 0 (measure-zero)
        ay = torch.clamp(y.abs(), min=torch.finfo(y.dtype).tiny)
        return (math.log(inv_a) + (inv_a - 1.0) * torch.log(ay)).sum(-1)

    def logdensity_fn(y):
        return model.logdensity_fn(inverse(y)) + log_jacobian_inv(y)

    sample_fn = None
    if model.sample_fn is not None:

        def sample_fn(generator, n):
            x = model.sample(generator, n)
            return torch.sign(x) * x.abs() ** a

    # a change of variables preserves the normalization constant exactly,
    # so elongated targets remain usable as mixture components
    return TestModel(
        dim=model.dim,
        logdensity_fn=logdensity_fn,
        device=model.device,
        sample_fn=sample_fn,
        log_normalization=model.log_normalization,
    )
