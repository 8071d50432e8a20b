"""Carry parameters and state across from the JAX package as numpy arrays.

Each function reads plain attributes (``m_inv``, ``q``, ``count`` ...) of an
object from ``dynamichmc_tpu`` through ``np.asarray``, so this module never
imports JAX; the tests use it to feed both packages identical inputs. The
model builders default to ``device="cuda"`` as the model factories do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hamiltonian import EvaluatedPoint
from .metric import DenseMetric, DiagonalMetric, Metric
from .models.funnel import funnel
from .models.gaussian import mvnormal
from .models.logreg import logistic_regression_from_data
from .nuts import TreeStatistics
from .stepsize import DualAveragingState
from .utils.welford import WelfordState
from .warmup import WarmupState


def tensor(x, dtype=None, device=None) -> torch.Tensor:
    """Any array-like (numpy, JAX, Python) -> a torch tensor. A numpy
    uint32 array (direction bits) keeps its bit pattern as int32."""
    a = np.array(x, order="C")  # a writable copy; keeps 0-d arrays 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, dtype=dtype, device=device)


def to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x)
    )


def metric(obj, dtype=None, device=None) -> Metric:
    """A JAX ``DiagonalMetric`` / ``DenseMetric`` (m_inv with w_diag or w)."""
    if hasattr(obj, "w_diag"):
        return DiagonalMetric(m_inv=tensor(obj.m_inv, dtype, device),
                              w_diag=tensor(obj.w_diag, dtype, device))
    return DenseMetric(m_inv=tensor(obj.m_inv, dtype, device),
                       w=tensor(obj.w, dtype, device))


def evaluated_point(obj, dtype=None, device=None) -> EvaluatedPoint:
    return EvaluatedPoint(q=tensor(obj.q, dtype, device),
                          logdensity=tensor(obj.logdensity, dtype, device),
                          grad=tensor(obj.grad, dtype, device))


def warmup_state(obj, dtype=None, device=None) -> WarmupState:
    eps = None if obj.eps is None else tensor(obj.eps, dtype, device)
    return WarmupState(Q=evaluated_point(obj.Q, dtype, device),
                       metric=metric(obj.metric, dtype, device), eps=eps)


def dual_averaging_state(obj, dtype=None, device=None) -> DualAveragingState:
    return DualAveragingState(**{
        name: tensor(getattr(obj, name), dtype, device)
        for name in ("mu", "m", "h_bar", "log_eps", "log_eps_bar")
    })


def tree_statistics(obj, device=None) -> TreeStatistics:
    """A JAX ``TreeStatistics`` (fields of shape (N,) or (C, N)), each
    field at its own dtype; the uint32 direction bits become int32 with the
    same bit pattern, and a ``work`` of None stays None."""
    return TreeStatistics(**{
        f.name: (None if getattr(obj, f.name) is None
                 else tensor(getattr(obj, f.name), device=device))
        for f in dataclasses.fields(TreeStatistics)
    })


def welford_state(obj, dtype=None, device=None) -> WelfordState:
    return WelfordState(count=tensor(obj.count, dtype, device),
                        mean=tensor(obj.mean, dtype, device),
                        m2=tensor(obj.m2, dtype, device))


def gaussian_model(obj, dtype=torch.float64, device="cuda",
                   fused: bool = False, tree_kernel: bool = False):
    """The port's Gaussian with the mean and covariance of a JAX Gaussian
    TestModel (``mean_fn`` / ``cov_fn``): prec and L^T are rebuilt in
    float64 by the same numpy calls, so the arrays match."""
    return mvnormal(np.asarray(obj.mean_fn(), np.float64),
                    np.asarray(obj.cov_fn(), np.float64), dtype=dtype,
                    device=device, fused=fused, tree_kernel=tree_kernel)


def _closure(fn) -> dict:
    """The free variables of a Python function, by name."""
    return dict(zip(fn.__code__.co_freevars,
                    (cell.cell_contents for cell in fn.__closure__ or ())))


def logreg_data(obj):
    """(X, y, prior_scale) of a JAX ``logistic_regression`` TestModel, as
    float64 numpy arrays and a float. The JAX model keeps them only in its
    log density's closure, which is where they are read from."""
    cells = _closure(obj.logdensity_fn)
    return (np.asarray(cells["x"], np.float64),
            np.asarray(cells["y"], np.float64), float(cells["prior_scale"]))


def logreg_model(obj, dtype=torch.float64, device="cuda", fused=False,
                 tree_kernel=False):
    """The port's logistic regression on the same (X, y) and prior as a
    JAX ``logistic_regression`` TestModel."""
    x, y, prior_scale = logreg_data(obj)
    return logistic_regression_from_data(
        x, y, prior_scale=prior_scale, dtype=dtype, device=device,
        fused=fused, tree_kernel=tree_kernel)


def funnel_model(obj, dtype=torch.float64, device="cuda",
                 tree_kernel: bool = False):
    """The port's funnel with the dimension and sigma_v of a JAX ``funnel``
    TestModel (it holds no arrays)."""
    sigma_v = float(_closure(obj.logdensity_fn)["sigma_v"])
    return funnel(obj.dim, sigma_v=sigma_v, dtype=dtype, device=device,
                  tree_kernel=tree_kernel)
