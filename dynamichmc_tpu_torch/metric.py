"""Euclidean-Gaussian kinetic energies (port of ``dynamichmc_tpu.metric``).

A metric stores the inverse mass matrix M^-1 (used by the dynamics and by the
kinetic energy) and a factor W with W W^T = M (used to draw momenta).
Diagonal metrics store vectors, dense metrics matrices. A leading chain axis
makes a metric per-chain: (C, K) diagonal or (C, K, K) dense.

The kinetic energy is computed from the SAME M^-1 arrays as the dynamics
(``kinetic_energy`` here, tree_batched.kinetic_b): a whitened form through a separately computed
float32 Cholesky is inconsistent with them on ill-conditioned adapted
metrics and collapses the adapted stepsize.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass
class DiagonalMetric:
    """M^-1 = diag(m_inv); ``w_diag = 1/sqrt(m_inv)`` so diag(w)^2 = M."""

    m_inv: torch.Tensor  # (K,) or (C, K)
    w_diag: Optional[torch.Tensor]


@dataclasses.dataclass
class DenseMetric:
    """Full M^-1 and a factor W with W W^T = M."""

    m_inv: torch.Tensor  # (K, K) or (C, K, K)
    w: Optional[torch.Tensor]


Metric = Union[DiagonalMetric, DenseMetric]


def diagonal_metric(m_inv: torch.Tensor) -> DiagonalMetric:
    return DiagonalMetric(m_inv=m_inv, w_diag=torch.rsqrt(m_inv))


def dense_metric(m_inv: torch.Tensor) -> DenseMetric:
    """M^-1 = L L^T (Cholesky); W = L^-T from a triangular solve, so
    W W^T = (L L^T)^-1 = M without inverting M^-1. Batched over any leading
    axes."""
    m_inv = (m_inv + m_inv.mT) / 2
    chol = torch.linalg.cholesky(m_inv)
    eye = torch.eye(m_inv.shape[-1], dtype=m_inv.dtype, device=m_inv.device)
    w = torch.linalg.solve_triangular(
        chol.mT, eye.expand_as(m_inv), upper=True
    )
    return DenseMetric(m_inv=m_inv, w=w)


def identity_metric(dim: int, m_inv_scalar: float = 1.0,
                    dtype=torch.float32, device=None) -> DiagonalMetric:
    """M^-1 = m_inv_scalar * I."""
    return diagonal_metric(
        torch.full((dim,), m_inv_scalar, dtype=dtype, device=device)
    )


def metric_is_batched(metric: Metric) -> bool:
    """Per-chain vs shared metric, decided by array rank."""
    return metric.m_inv.ndim == (2 if isinstance(metric, DiagonalMetric) else 3)


# --- one chain: p is (K,), the metric (K,) or (K, K) ----------------------


def kinetic_energy(metric: Metric, p: torch.Tensor) -> torch.Tensor:
    """K(p) = p^T M^-1 p / 2, with the same M^-1 arrays as the dynamics
    (psharp) and the momentum draw (see the module docstring)."""
    if isinstance(metric, DiagonalMetric):
        return 0.5 * (metric.m_inv * p * p).sum(-1)
    return 0.5 * torch.dot(p, metric.m_inv @ p)


def psharp(metric: Metric, p: torch.Tensor) -> torch.Tensor:
    """p# = M^-1 p, the velocity (dynamics and turn checks)."""
    if isinstance(metric, DiagonalMetric):
        return metric.m_inv * p
    return metric.m_inv @ p


def rand_p(generator: torch.Generator, metric: Metric,
           dtype=None) -> torch.Tensor:
    """p ~ N(0, M) for one chain: W z with z standard normal, drawn from
    ``generator`` on the metric's device."""
    dt = dtype or metric.m_inv.dtype
    z = torch.randn(metric.m_inv.shape[-1:], generator=generator, dtype=dt,
                    device=metric.m_inv.device)
    if isinstance(metric, DiagonalMetric):
        return metric.w_diag.to(dt) * z
    return metric.w.to(dt) @ z
