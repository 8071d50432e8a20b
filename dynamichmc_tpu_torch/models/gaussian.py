"""Gaussian targets (port of ``dynamichmc_tpu.models.gaussian``).

cov, prec = cov^-1 and L^T (prec = L L^T) are built in float64 with numpy
exactly as the JAX package builds them, so one ``np.random.RandomState``
seed gives the same matrices in both packages, and only then cast to the
model's dtype. The value is the cancellation-free whitened sum of squares
-0.5 ||L^T d||^2: a direct d . (prec d) quadratic form carries a systematic
float32 bias that over-disperses the worst-conditioned coordinates.

Every factory builds on ``device`` ("cuda" unless the caller names another,
e.g. ``device="cpu"``) and raises where that device does not exist.
"""

from __future__ import annotations

import numpy as np
import torch

from ..logdensity import resolve_device
from .base import TestModel


def _gaussian_model(mean, cov, dtype, device, fused: bool = False,
                    tree_kernel: bool = False) -> TestModel:
    device = resolve_device(device)
    mean_np = np.asarray(mean, np.float64)
    dim = mean_np.shape[0]
    cov_np = np.asarray(cov, np.float64)
    prec_np = np.linalg.inv(cov_np)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    mean_t = t(mean_np)
    prec = t(prec_np)
    chol = t(np.linalg.cholesky(cov_np))
    prec_chol_t = t(np.linalg.cholesky(prec_np).T)

    tree_transition_fn = None
    if tree_kernel:
        from ..ops.tree_kernel import make_gaussian_tree_transition

        tree_transition_fn = make_gaussian_tree_transition(
            prec, mean_t, prec_chol_t
        )

    fused_leapfrog_fn = fused_leaf_batched_fn = None
    if fused:
        from ..ops.gaussian_leaf import make_gaussian_fused_leaf_batched
        from ..ops.gaussian_leapfrog import make_gaussian_fused_leapfrog

        # both hooks take the model's own f64-built L^T, so the kernels
        # evaluate the value the model's log density defines
        fused_leapfrog_fn = make_gaussian_fused_leapfrog(prec, mean_t,
                                                         prec_chol_t)
        fused_leaf_batched_fn = make_gaussian_fused_leaf_batched(
            prec, mean_t, prec_chol_t)

    def logdensity_fn(q):
        d = q - mean_t.to(q.dtype)
        w = d @ prec_chol_t.to(q.dtype).mT
        return -0.5 * (w * w).sum(-1)

    def logdensity_and_gradient_fn(q):
        d = q - mean_t.to(q.dtype)
        w = d @ prec_chol_t.to(q.dtype).mT
        pd = d @ prec.to(q.dtype).mT
        return -0.5 * (w * w).sum(-1), -pd

    def sample_fn(generator, n):
        z = torch.randn((n, dim), generator=generator, dtype=dtype,
                        device=device)
        return z @ chol.mT + mean_t

    return TestModel(
        dim=dim,
        logdensity_fn=logdensity_fn,
        logdensity_and_gradient_fn=logdensity_and_gradient_fn,
        fused_leapfrog_fn=fused_leapfrog_fn,
        fused_leaf_batched_fn=fused_leaf_batched_fn,
        tree_transition_fn=tree_transition_fn,
        device=device,
        sample_fn=sample_fn,
        mean_fn=lambda: mean_t,
        cov_fn=lambda: torch.as_tensor(cov_np, device=device),
        log_normalization=float(
            -0.5 * (dim * np.log(2 * np.pi) + np.linalg.slogdet(cov_np)[1])
        ),
    )


def std_normal(dim: int, dtype=torch.float64, device="cuda") -> TestModel:
    """N(0, I_dim) with a direct quadratic log density (no matmul) and no
    fused hooks, as in the JAX package: the same target with the kernels is
    ``mvnormal(np.zeros(dim), np.eye(dim), fused=True)``."""
    device = resolve_device(device)
    mean = torch.zeros((dim,), dtype=dtype, device=device)

    def logdensity_fn(q):
        return -0.5 * (q * q).sum(-1)

    def logdensity_and_gradient_fn(q):
        return -0.5 * (q * q).sum(-1), -q

    def sample_fn(generator, n):
        return torch.randn((n, dim), generator=generator, dtype=dtype,
                           device=device)

    return TestModel(
        dim=dim,
        logdensity_fn=logdensity_fn,
        logdensity_and_gradient_fn=logdensity_and_gradient_fn,
        device=device,
        sample_fn=sample_fn,
        mean_fn=lambda: mean,
        cov_fn=lambda: torch.eye(dim, dtype=dtype, device=device),
        log_normalization=float(-0.5 * dim * np.log(2 * np.pi)),
    )


def mvnormal(mean, cov, dtype=torch.float64, device="cuda",
             fused: bool = False, tree_kernel: bool = False) -> TestModel:
    """MVN with the given mean and covariance. ``fused=True`` attaches the
    fused leaf (ops/gaussian_leaf.py, the plain batch driver's every leaf)
    and the fused leapfrog (ops/gaussian_leapfrog.py, every per-chain
    leapfrog); ``tree_kernel=True`` the whole-transition kernel
    (ops/tree_kernel.py)."""
    return _gaussian_model(mean, cov, dtype, device, fused=fused,
                           tree_kernel=tree_kernel)


def correlated_gaussian(
    dim: int, rho: float = 0.8, seed: int = 0, random_rotation: bool = True,
    dtype=torch.float64, device="cuda", fused: bool = False,
    tree_kernel: bool = False,
) -> TestModel:
    """The dense correlated Gaussian of the benchmark: equicorrelated with
    coefficient ``rho``, optionally randomly rotated and scaled."""
    rng = np.random.RandomState(seed)
    base = np.full((dim, dim), rho) + (1 - rho) * np.eye(dim)
    if random_rotation:
        q, _ = np.linalg.qr(rng.randn(dim, dim))
        scales = np.exp(rng.uniform(-1, 1, dim))
        base = (q * scales) @ base @ (q * scales).T
    base = (base + base.T) / 2
    return _gaussian_model(np.zeros(dim), base, dtype, device, fused=fused,
                           tree_kernel=tree_kernel)
