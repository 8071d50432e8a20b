"""Finite mixtures of exactly characterized targets (port of
``dynamichmc_tpu.models.mixture``; cf.
DynamicHMC.jl test/sample-correctness_tests.jl:89-98)."""

from __future__ import annotations

import math

import torch

from .base import TestModel


def mixture(weight: float, model_a: TestModel, model_b: TestModel) -> TestModel:
    """weight * A + (1 - weight) * B. Exact mixing requires NORMALIZED
    component log densities; every component must therefore carry an explicit
    ``log_normalization`` constant (the additive c making logdensity_fn + c a
    normalized log pdf). Mixing a component whose constant is unknown would
    silently reweight the mixture (e.g. an unnormalized funnel at nominal
    weight 0.5 contributes an effective weight ~0.96), so that is an error.
    Both components must lie on one device."""
    if model_a.dim != model_b.dim:
        raise ValueError("mixture components must have equal dimension")
    if not 0 < weight < 1:
        raise ValueError("weight must be in (0, 1)")
    if None not in (model_a.device, model_b.device) and (
            model_a.device != model_b.device):
        raise ValueError("mixture components must lie on one device")
    dim = model_a.dim

    def log_norm(model, name):
        if model.log_normalization is None:
            raise ValueError(
                f"mixture component {name} has no log_normalization; exact "
                "mixing needs normalized component densities"
            )
        return model.log_normalization

    la, lb = log_norm(model_a, "A"), log_norm(model_b, "B")
    lw_a, lw_b = math.log(weight), math.log1p(-weight)

    def logdensity_fn(q):
        return torch.logaddexp(
            lw_a + la + model_a.logdensity_fn(q),
            lw_b + lb + model_b.logdensity_fn(q),
        )

    sample_fn = None
    if model_a.sample_fn is not None and model_b.sample_fn is not None:

        def sample_fn(generator, n):
            xa = model_a.sample(generator, n)
            xb = model_b.sample(generator, n)
            pick_a = torch.rand((n, 1), generator=generator, dtype=xa.dtype,
                                device=xa.device) < weight
            return torch.where(pick_a, xa, xb)

    # With component constants folded in, the mixture density is normalized.
    return TestModel(
        dim=dim,
        logdensity_fn=logdensity_fn,
        device=model_a.device if model_a.device is not None else model_b.device,
        sample_fn=sample_fn,
        log_normalization=0.0,
    )
