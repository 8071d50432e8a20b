"""A plain float64 reference of Hoffman and Gelman's hierarchical logistic
regression (2014, JMLR 15, section 4, model HLR), in numpy and torch ops
alone (nothing of the port, no JAX).

The design X' = [1 | Z | W]: a ones column, the covariates standardised
by column (mean 0, variance 1), then the products z_i z_j of every pair
i < j in lexicographic order, each standardised. The coordinates are q =
(b, t) with b the coefficients of X' and t = log sigma^2:

    ld  = sum_n (y_n l_n - softplus(l_n)) - 1/2 e^-t |b|^2 - P/2 t
          - rate e^t + t,                      l = X' b, P = len(b)
    g_b = X'^T (y - sigmoid(l)) - e^-t b
    g_t = 1/2 e^-t |b|^2 - P/2 - rate e^t + 1
"""

import itertools

import numpy as np
import torch


def standardise(a):
    """Each column to mean 0 and variance 1 (population variance)."""
    return (a - a.mean(0)) / a.std(0)


def design(covariates):
    """X' (n, 1 + d + d (d - 1) / 2) of the (n, d) covariates."""
    z = standardise(np.asarray(covariates, np.float64))
    pairs = list(itertools.combinations(range(z.shape[1]), 2))
    w = standardise(np.stack([z[:, i] * z[:, j] for i, j in pairs], 1))
    return np.concatenate([np.ones((z.shape[0], 1)), z, w], 1)


def value_and_grad(q, x, y, rate):
    """(ld (S,), g (S, P + 1)) at the rows of q (S, P + 1), in float64."""
    q = torch.as_tensor(q, dtype=torch.float64)
    x = torch.as_tensor(x, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=torch.float64)
    P = x.shape[1]
    b, t = q[:, :P], q[:, P]
    logits = b @ x.T
    sq = (b * b).sum(-1)
    loglik = (y * logits).sum(-1) - torch.logaddexp(
        torch.zeros_like(logits), logits).sum(-1)
    ld = loglik - 0.5 * torch.exp(-t) * sq - 0.5 * P * t - rate * torch.exp(
        t) + t
    g_b = (y - torch.sigmoid(logits)) @ x - torch.exp(-t)[:, None] * b
    g_t = 0.5 * torch.exp(-t) * sq - 0.5 * P - rate * torch.exp(t) + 1
    return ld, torch.cat([g_b, g_t[:, None]], 1)
