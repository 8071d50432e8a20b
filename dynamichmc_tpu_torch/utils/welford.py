"""Streaming (Welford) moments for metric adaptation (port of
``dynamichmc_tpu.utils.welford`` plus the engine's batched folds).

Bessel-corrected variance/covariance from a streaming fold, so the warmup
carries O(K) / O(K^2) state instead of every draw.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class WelfordState:
    """Running moments: ``m2`` is (K,) diagonal or (K, K) dense, with an
    optional leading chain axis for per-chain states."""

    count: torch.Tensor  # float, avoids int/float casts in the fold
    mean: torch.Tensor
    m2: torch.Tensor


def welford_variance(state: WelfordState) -> torch.Tensor:
    """Sample variance (ddof=1)."""
    return state.m2 / torch.clamp(state.count - 1, min=1)[..., None]


def welford_covariance(state: WelfordState) -> torch.Tensor:
    """Sample covariance (ddof=1), symmetrized."""
    cov = state.m2 / torch.clamp(state.count - 1, min=1)[..., None, None]
    return (cov + cov.mT) / 2


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    """One chain's update: x (K,); m2 (K,) or (K, K)."""
    count = state.count + 1
    delta = x - state.mean
    mean = state.mean + delta / count
    delta2 = x - mean
    if state.m2.ndim == 2:
        m2 = state.m2 + torch.outer(delta, delta2)
    else:
        m2 = state.m2 + delta * delta2
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_update_b(state: WelfordState, x: torch.Tensor) -> WelfordState:
    """Per-chain update: x (C, K); m2 (C, K) or (C, K, K)."""
    count = state.count + 1
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    delta2 = x - mean
    if state.m2.ndim == 3:
        m2 = state.m2 + torch.einsum("ci,cj->cij", delta, delta2)
    else:
        m2 = state.m2 + delta * delta2
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_update_pooled_b(state: WelfordState, x: torch.Tensor
                            ) -> WelfordState:
    """SHARED update with one batch of C draws per step (Chan et al.
    parallel combine): the state is unbatched, so pooled dense adaptation
    holds O(K^2) memory and the step's cross-chain moment is one
    (K, C) @ (C, K) product."""
    c = x.shape[0]
    batch_mean = x.mean(dim=0)
    xc = x - batch_mean
    count_new = state.count + c
    delta = batch_mean - state.mean
    mean = state.mean + (c / count_new) * delta
    corr = state.count * c / count_new
    if state.m2.ndim == 2:
        batch_m2 = xc.mT @ xc
        m2 = state.m2 + batch_m2 + corr * torch.outer(delta, delta)
    else:
        batch_m2 = (xc * xc).sum(dim=0)
        m2 = state.m2 + batch_m2 + corr * delta * delta
    return WelfordState(count=count_new, mean=mean, m2=m2)


def welford_update_masked(state: WelfordState, x: torch.Tensor,
                          mask: torch.Tensor) -> WelfordState:
    """Per-chain update applied to the ``mask`` lanes only (the wavefront
    warmup, whose lanes finish their transitions at different slots): x
    (C, K); m2 (C, K) or (C, K, K)."""
    count = state.count + mask.to(state.count.dtype)
    delta = x - state.mean
    m = mask[:, None]
    mean = state.mean + torch.where(
        m, delta / torch.clamp(count, min=1)[:, None], 0.0)
    delta2 = x - mean
    if state.m2.ndim == 3:
        upd = torch.einsum("ci,cj->cij", delta, delta2)
        m2 = state.m2 + torch.where(m[:, :, None], upd, 0.0)
    else:
        m2 = state.m2 + torch.where(m, delta * delta2, 0.0)
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_update_pooled_masked(state: WelfordState, x: torch.Tensor,
                                 mask: torch.Tensor) -> WelfordState:
    """SHARED update over the ``mask`` rows of a (C, K) batch: Chan's exact
    two-sample combine with the masked rows as sample B; no row leaves the
    state as it was."""
    m = mask.to(x.dtype).sum()
    safe_m = torch.clamp(m, min=1)
    mc = mask[:, None]
    batch_mean = torch.where(mc, x, 0.0).sum(0) / safe_m
    xc = torch.where(mc, x - batch_mean, 0.0)
    count_new = state.count + m
    delta = batch_mean - state.mean
    mean = state.mean + (m / torch.clamp(count_new, min=1)) * delta
    corr = state.count * m / torch.clamp(count_new, min=1)
    if state.m2.ndim == 2:
        m2 = state.m2 + xc.mT @ xc + corr * torch.outer(delta, delta)
    else:
        m2 = state.m2 + (xc * xc).sum(0) + corr * delta * delta
    none = m == 0
    return WelfordState(count=torch.where(none, state.count, count_new),
                        mean=torch.where(none, state.mean, mean),
                        m2=torch.where(none, state.m2, m2))


def welford_zero_shared(dim: int, dense: bool, dtype,
                        device=None) -> WelfordState:
    return WelfordState(
        count=torch.zeros((), dtype=dtype, device=device),
        mean=torch.zeros((dim,), dtype=dtype, device=device),
        m2=torch.zeros((dim, dim) if dense else (dim,), dtype=dtype,
                       device=device),
    )


def welford_zero(q: torch.Tensor, dense: bool) -> WelfordState:
    """Per-chain zeros matching a (C, K) position batch."""
    c, k = q.shape
    return WelfordState(
        count=torch.zeros((c,), dtype=q.dtype, device=q.device),
        mean=torch.zeros_like(q),
        m2=torch.zeros((c, k, k) if dense else (c, k), dtype=q.dtype,
                       device=q.device),
    )


def pool_welford_over_group(w: WelfordState, mesh) -> WelfordState:
    """Chan-combine every rank's pooled (unbatched) state into the moments
    of the union of the ranks' draws, on every rank (the counterpart of
    the JAX package's ``pool_welford_over_axis``; equal counts on every
    rank): the grand mean is the mean of the rank means, m2 the sum over
    the ranks of m2 + count * delta delta^T, diagonal or dense, and the
    count the sum. Two collectives; ``mesh`` None or of one rank returns
    ``w`` itself."""
    if mesh is None or mesh.size == 1:
        return w
    from ..parallel.mesh import all_mean, all_sum

    grand = all_mean(w.mean, mesh)
    delta = w.mean - grand
    corr = w.count * (torch.outer(delta, delta) if w.m2.ndim == 2
                      else delta * delta)
    summed = all_sum(torch.cat([w.count.reshape(1), (w.m2 + corr).flatten()]),
                     mesh)
    return WelfordState(count=summed[0], mean=grand,
                        m2=summed[1:].reshape(w.m2.shape))
