"""Bayesian logistic regression with an intercept (Hoffman and Gelman
2014, section 4, model LR: German credit's shape, 1000 rows of 24
standardised covariates, 25 coefficients, a N(0, prior_scale^2 I)
prior), on seeded data: from ``np.random.RandomState(data_seed)``, the
covariates ~ N(0, 1) standardised to mean 0 and variance 1 by column,
then y ~ Bernoulli(sigmoid(X beta)) with beta = (``intercept``,
``coef_scale`` x N(0, 1) draws). X's first column is the intercept's
ones.

The reference value is sum(y * logits - log(1 + e^logits)) - 0.5 ||beta /
prior_scale||^2 with logits = X beta, and the gradient X^T (y -
sigmoid(logits)) - beta / prior_scale^2.
"""

from __future__ import annotations

import numpy as np
import torch

from . import importance
from . import precision as P
from .tree_kernel import launch_bytes as _launch_bytes

BLOCK_ROWS = 4096


def make_data(config: dict) -> dict:
    """{"x" (n_obs, dim), "y" (n_obs,)}: float64 numpy arrays."""
    n, dim = int(config["n_obs"]), int(config["dim"])
    rng = np.random.RandomState(int(config["data_seed"]))
    covariates = rng.randn(n, dim - 1)
    covariates = (covariates - covariates.mean(0)) / covariates.std(0)
    x = np.concatenate([np.ones((n, 1)), covariates], axis=1)
    beta = np.concatenate([[float(config["intercept"])],
                           float(config["coef_scale"]) * rng.randn(dim - 1)])
    probs = 1 / (1 + np.exp(-(x @ beta)))
    y = (rng.uniform(size=n) < probs).astype(np.float64)
    return {"x": x, "y": y}


class Target:
    """The log density and its gradient on ``device``."""

    def __init__(self, data: dict, device, prior_scale: float):
        f64 = dict(dtype=torch.float64, device=device)
        self.x = torch.as_tensor(data["x"], **f64)
        self.y = torch.as_tensor(data["y"], **f64)
        self.prior_scale = float(prior_scale)

    def ld_grad(self, q: torch.Tensor, precision: str = "float64",
                grad: bool = True):
        """(log density (S,), gradient (S, K) or None) at the rows of ``q``,
        in float64 or at TF32 precision (:mod:`precision`)."""
        lds, grads = [], []
        y = P.cast(self.y, precision)
        s = self.prior_scale
        for lo in range(0, q.shape[0], BLOCK_ROWS):
            beta = P.cast(q[lo:lo + BLOCK_ROWS], precision)
            logits = P.matmul(beta, self.x.mT, precision)
            zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
            loglik = (y * logits).sum(-1) - torch.logaddexp(zero, logits).sum(-1)
            lds.append(loglik - 0.5 * ((beta / s) ** 2).sum(-1))
            if grad:
                resid = y - torch.sigmoid(logits)
                grads.append(P.matmul(resid, self.x, precision)
                             - beta / (s * s))
        return (torch.cat(lds).to(torch.float64),
                torch.cat(grads).to(torch.float64) if grad else None)

    def mode(self, steps: int = 50):
        """(the posterior's mode, the inverse Hessian there) by Newton's
        method from zero, in float64."""
        K = self.x.shape[1]
        beta = torch.zeros(K, dtype=torch.float64, device=self.x.device)
        prior = torch.eye(K, dtype=torch.float64, device=self.x.device) / (
            self.prior_scale ** 2)
        for _ in range(steps):
            p = torch.sigmoid(self.x @ beta)
            grad = self.x.mT @ (self.y - p) - prior @ beta
            hess = (self.x.mT * (p * (1 - p))) @ self.x + prior
            beta = beta + torch.linalg.solve(hess, grad)
        p = torch.sigmoid(self.x @ beta)
        hess = (self.x.mT * (p * (1 - p))) @ self.x + prior
        return beta, torch.linalg.inv(hess)


def make_target(data: dict, device, config: dict) -> Target:
    return Target(data, device, config["prior_scale"])


def posterior_moments(target: Target, config: dict):
    """(mean, covariance, effective draws behind them) of the posterior, by
    importance sampling (:mod:`importance`) with ``reference_draws``
    proposals from a generator seeded with ``data_seed``."""
    mode, cov = target.mode()
    generator = torch.Generator(device=mode.device).manual_seed(
        int(config["data_seed"]))
    return importance.moments(
        lambda b: target.ld_grad(b, grad=False)[0], mode, cov,
        int(config["reference_draws"]), generator)


def leaf_flops(config: dict) -> int:
    """Operations of one leaf: 4 n K + 10 n + 30 K (the two products with
    X, the softplus and sigmoid terms, the leapfrog)."""
    n, K = int(config["n_obs"]), int(config["dim"])
    return 4 * n * K + 10 * n + 30 * K


def launch_bytes(config: dict, chains: int) -> int:
    """One launch: the tree kernel's interface, a diagonal M^-1 and the
    leaf's operands (X with its columns padded to a multiple of 4, and y)."""
    n, K = int(config["n_obs"]), int(config["dim"])
    metric = K * K if config["metric"] == "dense" else K
    return _launch_bytes(chains, K, int(config["max_depth"]), metric,
                         n * (-(-K // 4) * 4) + n)
