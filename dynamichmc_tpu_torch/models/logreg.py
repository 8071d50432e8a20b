"""Bayesian logistic regression posterior (port of
``dynamichmc_tpu.models.logreg``).

The value is batched, ``(..., dim) -> (...)``: one product with the
(n_obs, dim) design matrix per evaluation; the gradient comes from autograd
through it, as the JAX model's comes from AD.
"""

from __future__ import annotations

import numpy as np
import torch

from ..logdensity import resolve_device
from .base import TestModel


def synthetic_data(n_obs: int, dim: int, seed: int):
    """X ~ N(0, I), beta ~ N(0, 1), y ~ Bernoulli(sigmoid(X beta)), drawn
    from ``np.random.RandomState(seed)`` in the JAX package's order, so
    both packages get the same float64 arrays."""
    rng = np.random.RandomState(seed)
    x_np = rng.randn(n_obs, dim)
    beta_true = rng.randn(dim)
    probs = 1 / (1 + np.exp(-(x_np @ beta_true)))
    y_np = (rng.uniform(size=n_obs) < probs).astype(np.float64)
    return x_np, y_np


def logistic_regression_from_data(x, y, prior_scale: float = 10.0,
                                  dtype=torch.float64, device="cuda",
                                  fused=False, tree_kernel=False) -> TestModel:
    """The posterior for design matrix ``x`` (n_obs, dim) and 0/1
    responses ``y`` under a N(0, prior_scale^2 I) prior, on ``device``
    ("cuda" unless the caller names another; raises where it does not
    exist).

    ``fused=True`` attaches the fused leaf (ops/logreg_leaf.py): the plain
    batch driver then runs every leaf (leapfrog, both products with X, the
    joint energy) as one kernel. ``tree_kernel=True`` attaches the
    whole-transition kernel with the logreg leaf (ops/tree_kernel.py); when
    both are set it takes precedence, as in the JAX package.

    ``"auto"`` attaches a kernel only where it was measured to win on the
    H100 (scripts/torch_logreg_auto_sweep.py): ``fused="auto"`` the fused
    leaf where ``logreg_leaf.fused_leaf_pays(n_obs, dim)``,
    ``tree_kernel="auto"`` the whole-transition kernel where
    ``tree_kernel.tree_kernel_pays(n_obs, dim, fused)`` (where the fused
    leaf is attached, by True or by "auto", it must also beat that leaf).
    Neither attaches
    past what its kernel takes. On the CPU an attached hook computes its
    plain version, as every hook there does."""
    device = resolve_device(device)
    x_np = np.asarray(x, np.float64)
    y_np = np.asarray(y, np.float64)
    n_obs, dim = x_np.shape
    if fused == "auto":
        from ..ops.logreg_leaf import fused_leaf_pays

        fused = fused_leaf_pays(n_obs, dim)
    if tree_kernel == "auto":
        from ..ops.tree_kernel import tree_kernel_pays

        tree_kernel = tree_kernel_pays(n_obs, dim, fused=bool(fused))

    fused_leaf_batched_fn = None
    if fused:
        from ..ops.logreg_leaf import make_logreg_fused_leaf_batched

        fused_leaf_batched_fn = make_logreg_fused_leaf_batched(
            x_np, y_np, prior_scale=prior_scale, device=device)
    tree_transition_fn = None
    if tree_kernel:
        from ..ops.tree_kernel import make_logreg_tree_transition

        tree_transition_fn = make_logreg_tree_transition(
            x_np, y_np, prior_scale=prior_scale, device=device)

    xt = torch.as_tensor(x_np, dtype=dtype, device=device)
    yt = torch.as_tensor(y_np, dtype=dtype, device=device)

    def logdensity_fn(beta):
        logits = beta @ xt.to(beta.dtype).mT
        # sum of y*logits - log(1 + e^logits), numerically stable
        loglik = (yt.to(beta.dtype) * logits).sum(-1) - torch.logaddexp(
            torch.zeros((), dtype=beta.dtype, device=beta.device), logits
        ).sum(-1)
        log_prior = -0.5 * ((beta / prior_scale) ** 2).sum(-1)
        return loglik + log_prior

    return TestModel(
        dim=dim,
        logdensity_fn=logdensity_fn,
        fused_leaf_batched_fn=fused_leaf_batched_fn,
        tree_transition_fn=tree_transition_fn,
        device=device,
    )


def logistic_regression(n_obs: int = 1000, dim: int = 25, seed: int = 0,
                        prior_scale: float = 10.0, dtype=torch.float64,
                        device="cuda", fused=False,
                        tree_kernel=False) -> TestModel:
    """Synthetic logistic regression (BASELINE config 3): the data of
    :func:`synthetic_data`, then :func:`logistic_regression_from_data`."""
    x_np, y_np = synthetic_data(n_obs, dim, seed)
    return logistic_regression_from_data(
        x_np, y_np, prior_scale=prior_scale, dtype=dtype, device=device,
        fused=fused, tree_kernel=tree_kernel)


def hierarchical_logistic_regression_from_data(
        x, y, rate: float = 0.01, dtype=torch.float64, device="cuda",
        fused=False, tree_kernel=False) -> TestModel:
    """Hoffman and Gelman's hierarchical logistic regression (2014, JMLR
    15, section 4, model HLR) for design matrix ``x`` (n_obs, P), its ones
    column included, and 0/1 responses ``y``: all P coefficients b share
    one scale, b_i ~ N(0, sigma^2), sigma^2 ~ Exponential(``rate``). The
    model samples q = (b, t) with t = log sigma^2, so its dim is P + 1:

        ld(q) = sum_n (y_n l_n - softplus(l_n)) - 1/2 e^-t |b|^2
                - P/2 t - rate e^t + t,     l = x b.

    The value is batched, ``(..., P + 1) -> (...)``; its gradient comes
    from autograd. ``fused=True`` attaches the fused leaf in its
    hierarchical mode (``ops/logreg_leaf.logreg_leaf_hier``), so the plain
    batch driver runs every leaf as one launch; ``fused="auto"`` does so
    where ``fused_leaf_pays(n_obs, P + 1)``. The whole-transition kernel
    has no hierarchical prior: ``tree_kernel="auto"`` attaches nothing and
    ``tree_kernel=True`` raises."""
    if tree_kernel not in (False, "auto"):
        raise ValueError(f"tree_kernel={tree_kernel!r}: the whole-transition "
                         "kernel has no hierarchical prior; use fused=True, "
                         "the fused leaf's hierarchical mode")
    device = resolve_device(device)
    x_np = np.asarray(x, np.float64)
    y_np = np.asarray(y, np.float64)
    n_obs, P = x_np.shape
    if fused == "auto":
        from ..ops.logreg_leaf import fused_leaf_pays

        fused = fused_leaf_pays(n_obs, P + 1)
    fused_leaf_batched_fn = None
    if fused:
        from ..ops.logreg_leaf import make_logreg_fused_leaf_batched

        fused_leaf_batched_fn = make_logreg_fused_leaf_batched(
            x_np, y_np, device=device, rate=rate)

    xt = torch.as_tensor(x_np, dtype=dtype, device=device)
    yt = torch.as_tensor(y_np, dtype=dtype, device=device)

    def logdensity_fn(q):
        b, t = q[..., :P], q[..., P]
        logits = b @ xt.to(q.dtype).mT
        loglik = (yt.to(q.dtype) * logits).sum(-1) - torch.logaddexp(
            torch.zeros((), dtype=q.dtype, device=q.device), logits).sum(-1)
        return (loglik - 0.5 * torch.exp(-t) * (b * b).sum(-1)
                - 0.5 * P * t - rate * torch.exp(t) + t)

    return TestModel(
        dim=P + 1,
        logdensity_fn=logdensity_fn,
        fused_leaf_batched_fn=fused_leaf_batched_fn,
        device=device,
    )
