"""What decides ``correct``: the timed calls' outputs against the plain
reference, once the window has closed.

From each timed call the benchmark keeps, on the host, a sample of its
draws drawn from the seed (position and the log density the port reports
for it), the warmup's final state as the last warmup checkpoint hands it
to the draws (every chain's position, log density and gradient, each
computed by the tree kernel's leaf), and the adapted metric (M^-1 and the
momentum factor the port derived from it). The reference then works out
in float64, from the benchmark's own data:

- ``ld_gap``: the widest gap, in nats, between a log density the port
  reports and the reference's at the same position (the leaf's value, and
  that each draw's log density is its position's);
- ``grad_gap``: the widest relative gap ||g - g_ref|| / ||g_ref|| over the
  chains of the warmup's final state (the leaf's gradient);
- ``metric_gap``: the widest gap between the port's momentum factor and
  the reference's derivation from the port's adapted M^-1, over the
  largest element of the reference's (the stage fold's metric as the
  tree kernel's momenta use it).

Against the posterior's mean mu and covariance Sigma, which the reference
knows (the Gaussian) or works out by importance sampling (the logistic
regression), from the moments of all the call's draws, taken on the
device after the call:

- ``mean_z``: the widest gap between the draws' mean and mu, coordinate
  by coordinate, in standard errors: sqrt(Sigma_kk (1/n + 1/n_ref)), with
  n the call's smallest bulk ESS and n_ref the reference's own draws;
- ``cov_z``: the widest gap between the draws' covariance and Sigma,
  element by element, in the standard errors of a covariance of n
  (and n_ref) independent draws: sqrt((Sigma_ii Sigma_jj + Sigma_ij^2)
  (1/n + 1/n_ref)). Both say whether the sampler draws from the posterior;
- ``metric_fold``: the stage fold's adapted M^-1 against Sigma, which
  its Welford estimate estimates: dense, the widest |M^-1_ij - Sigma_ij| /
  sqrt(Sigma_ii Sigma_jj); diagonal, the widest |M^-1_k / Sigma_kk - 1|.

The control puts the reference computed at TF32 precision in the port's
place (``source="control"``) where the tree kernel's leaf and the metric's
factor produce; it draws nothing, so the draws' moments stay the port's.
It is run by ``calibrate.py`` and the tests, never by a benchmark run.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .reference import precision as P

NAMES = ("ld_gap", "grad_gap", "metric_gap", "mean_z", "cov_z",
         "metric_fold")


@dataclasses.dataclass
class Samples:
    """What one call leaves for the check, on the host."""

    draw_q: torch.Tensor  # (S, K) sampled draws
    draw_ld: torch.Tensor  # (S,) their log densities as the port reports
    state_q: Optional[torch.Tensor]  # (C, K) the warmup's final state
    state_ld: Optional[torch.Tensor]
    state_grad: Optional[torch.Tensor]
    dense: bool  # the metric's kind
    m_inv: torch.Tensor  # (K, K) dense or (K,) diagonal, or per chain
    factor: torch.Tensor  # the port's w (dense) or w_diag (diagonal)
    draw_mean: Optional[torch.Tensor] = None  # (K,) over all the draws
    draw_cov: Optional[torch.Tensor] = None  # (K, K)
    n_eff: Optional[float] = None  # the call's smallest bulk ESS


def draw_moments(positions: torch.Tensor, block: int = 512):
    """(mean (K,), covariance (K, K)) of all (C, N, K) draws, in float64 on
    their device, ``block`` chains at a time."""
    C, N, K = positions.shape
    f64 = dict(dtype=torch.float64, device=positions.device)
    shift = positions[0, 0].to(torch.float64)
    s1, s2 = torch.zeros(K, **f64), torch.zeros(K, K, **f64)
    for lo in range(0, C, block):
        x = positions[lo:lo + block].reshape(-1, K).to(torch.float64) - shift
        s1 += x.sum(0)
        s2 += x.mT @ x
    n = C * N
    mean = s1 / n
    cov = (s2 - n * torch.outer(mean, mean)) / (n - 1)
    return mean + shift, (cov + cov.mT) / 2


def take_samples(result, checkpoint, n_sample: int,
                 generator: torch.Generator, n_eff: Optional[float] = None
                 ) -> Samples:
    """Copy the check's inputs of one call to the host: ``n_sample`` draws
    drawn uniformly (with ``generator``, on the host) over chains and
    draws, the checkpoint's state, the result's metric, and the moments of
    all its draws with ``n_eff``, their smallest bulk ESS."""
    C, N, K = result.positions.shape
    index = torch.randint(C * N, (n_sample,), generator=generator)
    flat = result.positions.reshape(C * N, K)
    device_index = index.to(flat.device)
    metric = result.metric
    dense = hasattr(metric, "w")
    state = checkpoint.Q if checkpoint is not None else None
    host = lambda x: None if x is None else x.detach().to("cpu", copy=True)
    mean = cov = None
    if n_eff is not None:
        mean, cov = draw_moments(result.positions)
    return Samples(
        draw_q=host(flat[device_index]),
        draw_ld=host(result.logdensities.reshape(C * N)[device_index]),
        state_q=host(None if state is None else state.q),
        state_ld=host(None if state is None else state.logdensity),
        state_grad=host(None if state is None else state.grad),
        dense=dense,
        m_inv=host(metric.m_inv),
        factor=host(metric.w if dense else metric.w_diag),
        draw_mean=host(mean),
        draw_cov=host(cov),
        n_eff=n_eff,
    )


def metric_factor(m_inv: torch.Tensor, dense: bool,
                  precision: str) -> torch.Tensor:
    """The momentum factor of M^-1: w = chol(M^-1)^-T for a dense metric
    (so that w w^T = M), 1 / sqrt(m_inv) for a diagonal one; in float64 or
    from TF32-rounded M^-1 in float32."""
    m = (m_inv.to(torch.float64) if precision == "float64"
         else P.tf32(m_inv))
    if not dense:
        return torch.rsqrt(m)
    m = (m + m.mT) / 2
    chol = torch.linalg.cholesky(m)
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    return torch.linalg.solve_triangular(chol.mT, eye, upper=True)


def _relative_rows(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((x - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def moment_numbers(s: Samples, moments) -> dict:
    """``mean_z``, ``cov_z`` and ``metric_fold`` of one call against the
    reference's ``moments``: (mu, Sigma, n_ref), on one device."""
    mu, sigma, n_ref = moments
    out = {}
    var = torch.diagonal(sigma)
    if s.draw_mean is not None and s.n_eff:
        scale = 1 / s.n_eff + 1 / n_ref
        mean = s.draw_mean.to(mu.device, torch.float64)
        cov = s.draw_cov.to(mu.device, torch.float64)
        out["mean_z"] = float(((mean - mu).abs() / torch.sqrt(
            var * scale)).max())
        out["cov_z"] = float(((cov - sigma).abs() / torch.sqrt(
            (torch.outer(var, var) + sigma * sigma) * scale)).max())
    m_inv = s.m_inv.to(mu.device, torch.float64)
    if s.dense:
        fold = (m_inv - sigma).abs() / torch.sqrt(torch.outer(var, var))
    else:
        fold = (m_inv / var - 1).abs()
    out["metric_fold"] = float(fold.max())
    return out


def numbers(samples: List[Samples], target, device,
            source: str = "program", moments=None) -> dict:
    """Each compared number over every call's samples: the port's outputs
    (``source="program"``) or the control's (``"control"``) against the
    float64 reference, computed on ``device``; the moments' numbers where
    the reference's ``moments`` (:func:`moment_numbers`) are given."""
    worst = {name: None for name in NAMES}

    def keep(name, value):
        worst[name] = value if worst[name] is None else max(worst[name], value)

    for s in samples:
        q = s.draw_q.to(device)
        ld_ref, _ = target.ld_grad(q, "float64")
        ld = (s.draw_ld.to(device, torch.float64) if source == "program"
              else target.ld_grad(q, "tf32")[0])
        keep("ld_gap", float((ld - ld_ref).abs().max()))
        if s.state_q is not None:
            q = s.state_q.to(device)
            ld_ref, g_ref = target.ld_grad(q, "float64")
            if source == "program":
                ld = s.state_ld.to(device, torch.float64)
                g = s.state_grad.to(device, torch.float64)
            else:
                ld, g = target.ld_grad(q, "tf32")
            keep("ld_gap", float((ld - ld_ref).abs().max()))
            keep("grad_gap", _relative_rows(g, g_ref))
        m_inv = s.m_inv.to(device)
        w_ref = metric_factor(m_inv, s.dense, "float64")
        w = (s.factor.to(device, torch.float64) if source == "program"
             else metric_factor(m_inv, s.dense, "tf32").to(torch.float64))
        keep("metric_gap", float((w - w_ref).abs().max() / w_ref.abs().max()))
        if moments is not None:
            for name, value in moment_numbers(s, moments).items():
                keep(name, value)
    return worst


def verdict(values: dict, limits: dict, attempted: int, failed: int):
    """(correct, lines): correct where some call was attempted, none
    failed, and every number was read and lies within its limit (a number
    or a limit that is missing fails). ``lines`` print each number beside
    its limit."""
    correct = attempted > 0 and failed == 0
    lines = {}
    for name in NAMES:
        value, limit = values.get(name), limits.get(name)
        ok = value is not None and limit is not None and value <= limit
        correct = correct and ok
        lines[name] = {"value": value, "limit": limit}
    lines["failed_calls"] = {"value": failed, "limit": 0}
    return correct, lines
