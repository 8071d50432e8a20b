"""Posterior moments by self-normalised importance sampling, in float64.

The proposal is a multivariate t with ``df`` degrees of freedom around the
posterior's mode, scaled by the inverse Hessian there (the Laplace
approximation): its polynomial tails are heavier than those of a log
density that falls off linearly, as a logistic likelihood does, so the
weights' variance is finite. The estimates' own error is that of
``(sum w)^2 / sum w^2`` independent draws (Kish's effective sample size).
"""

from __future__ import annotations

import math

import torch


def moments(log_density, mode: torch.Tensor, cov: torch.Tensor,
            n_draws: int, generator: torch.Generator, df: int = 7,
            block: int = 1 << 16):
    """(mean, covariance, effective draws) of the density ``exp(log_density)``
    (a function of (S, K) rows, float64) from ``n_draws`` proposals drawn
    with ``generator`` on ``mode``'s device."""
    K = mode.shape[0]
    f64 = dict(dtype=torch.float64, device=mode.device)
    chol = torch.linalg.cholesky(cov)
    shift = None
    sw = sw2 = 0.0
    s1 = torch.zeros(K, **f64)
    s2 = torch.zeros(K, K, **f64)
    for lo in range(0, n_draws, block):
        n = min(block, n_draws - lo)
        z = torch.randn(n, K, generator=generator, **f64)
        chi2 = torch.randn(n, df, generator=generator, **f64).square().sum(-1)
        x = mode + (z @ chol.mT) * torch.sqrt(df / chi2)[:, None]
        # log q up to a constant: -(df + K)/2 log(1 + |z|^2 / chi2)
        log_q = -0.5 * (df + K) * torch.log1p(z.square().sum(-1) / chi2)
        log_w = log_density(x) - log_q
        if shift is None:
            shift = float(log_w.max())
        w = torch.exp(log_w - shift)
        sw += float(w.sum())
        sw2 += float(w.square().sum())
        s1 += w @ x
        s2 += (x * w[:, None]).mT @ x
    if not math.isfinite(sw) or sw2 == 0:
        raise FloatingPointError("importance weights overflowed")
    mean = s1 / sw
    covariance = s2 / sw - torch.outer(mean, mean)
    return mean, (covariance + covariance.mT) / 2, sw * sw / sw2
