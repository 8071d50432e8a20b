"""Staged warmup configuration and metric estimation (port of parts of
``dynamichmc_tpu.warmup``).

The Stan-like windowed schedule: stepsize search, 75 eps-only steps,
25/50/100/200/400 eps+metric blocks, 50 eps-only steps. The metric is
re-estimated from streaming Welford moments, optionally pooled over all
chains (one shared metric).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from .hamiltonian import EvaluatedPoint, evaluate, evaluate_strict
from .logdensity import LogDensity, check_device
from .metric import Metric, dense_metric, diagonal_metric, identity_metric
from .stepsize import (
    DualAveraging,
    FixedStepsize,
    InitialStepsizeSearch,
    PooledStepsize,
)
from .utils.welford import WelfordState, welford_covariance, welford_variance


@dataclasses.dataclass
class WarmupState:
    """(Q, metric, eps); ``eps`` is None before a stepsize was chosen."""

    Q: EvaluatedPoint
    metric: Metric
    eps: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TuningNUTS:
    """Tune the stepsize every transition and optionally the metric at the
    end of the block.

    metric_kind: 'none', 'diagonal' or 'dense'.
    lam: shrinkage; dense estimates are regularized as
         (1 - lam) Sigma + lam diag(Sigma). Default 5/N.
    pooled: pool the Welford moments over all chains (one shared metric).
    """

    N: int
    metric_kind: str = "none"
    stepsize_adaptation: Union[DualAveraging, FixedStepsize,
                               PooledStepsize] = DualAveraging()
    lam: Optional[float] = None
    pooled: bool = False

    def __post_init__(self):
        if self.N < 20:
            raise ValueError("N must be >= 20 (variance estimation)")
        if self.metric_kind not in ("none", "diagonal", "dense"):
            raise ValueError("metric_kind must be 'none', 'diagonal' or 'dense'")
        if self.lam is not None and self.lam < 0:
            raise ValueError("lam must be >= 0")

    @property
    def shrinkage(self) -> float:
        return 5.0 / self.N if self.lam is None else self.lam


WarmupStage = Union[None, InitialStepsizeSearch, TuningNUTS]


def default_warmup_stages(
    stepsize_search: Optional[InitialStepsizeSearch] = InitialStepsizeSearch(),
    metric_kind: str = "diagonal",
    stepsize_adaptation: DualAveraging = DualAveraging(),
    init_steps: int = 75,
    middle_steps: int = 25,
    doubling_stages: int = 5,
    terminating_steps: int = 50,
    pooled: bool = False,
    pooled_stepsize: bool = False,
) -> Tuple[WarmupStage, ...]:
    """``pooled`` shares the adapted metric across chains;
    ``pooled_stepsize`` also shares the dual-averaged stepsize."""
    if pooled_stepsize:
        stepsize_adaptation = PooledStepsize(stepsize_adaptation)
    middle = tuple(
        TuningNUTS(
            N=middle_steps * 2**i,
            metric_kind=metric_kind,
            stepsize_adaptation=stepsize_adaptation,
            pooled=pooled,
        )
        for i in range(doubling_stages)
    )
    return (
        stepsize_search,
        TuningNUTS(N=init_steps, stepsize_adaptation=stepsize_adaptation),
        *middle,
        TuningNUTS(N=terminating_steps, stepsize_adaptation=stepsize_adaptation),
    )


def fixed_stepsize_warmup_stages(
    metric_kind: str = "diagonal",
    middle_steps: int = 25,
    doubling_stages: int = 5,
    pooled: bool = False,
) -> Tuple[WarmupStage, ...]:
    """Covariance-only tuning at fixed stepsize (mcmc.jl:436-440); the
    stepsize comes from ``initialization`` (``eps``)."""
    return tuple(
        TuningNUTS(
            N=middle_steps * 2**i,
            metric_kind=metric_kind,
            stepsize_adaptation=FixedStepsize(),
            pooled=pooled,
        )
        for i in range(doubling_stages)
    )


def random_position(generator, n_chains: Optional[int], dim: int,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform [-2, 2]^K initial positions: one row per chain, or one (K,)
    position when ``n_chains`` is None."""
    shape = (dim,) if n_chains is None else (n_chains, dim)
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return 4.0 * u - 2.0


def initialize_warmup_state(generator: torch.Generator, ld: LogDensity,
                            q=None, metric: Optional[Metric] = None, eps=None,
                            dtype=torch.float32, strict: bool = True
                            ) -> WarmupState:
    """The state of one chain before warmup (mcmc.jl:129-132), on the
    generator's device: a uniform [-2, 2]^K position (or ``q``), the
    identity metric (or ``metric``), no stepsize (or ``eps``).

    ``strict=True`` evaluates the initial point on the host and raises
    ``DynamicHMCError`` on a non-finite result (mcmc.jl:131). Raises when
    the model's tensors lie on another device than the generator."""
    device = generator.device
    check_device(ld, device)
    if q is None:
        q = random_position(generator, None, ld.dim, dtype, device)
    q = torch.as_tensor(q, dtype=dtype, device=device)
    if tuple(q.shape) != (ld.dim,):
        raise ValueError(f"q must have shape {(ld.dim,)}, got {tuple(q.shape)}")
    if metric is None:
        metric = identity_metric(ld.dim, dtype=dtype, device=device)
    Q = evaluate_strict(ld, q) if strict else evaluate(ld, q)
    if eps is not None:
        eps = torch.as_tensor(eps, dtype=dtype, device=device)
    return WarmupState(Q=Q, metric=metric, eps=eps)


def estimate_metric(welford: WelfordState, kind: str,
                    shrinkage: float) -> Metric:
    """Re-estimate the kinetic energy from accumulated moments (sample
    M^-1 plus the dense shrinkage regularization). Batched over a leading
    chain axis for per-chain states."""
    if kind == "diagonal":
        return diagonal_metric(welford_variance(welford))
    if kind == "dense":
        cov = welford_covariance(welford)
        lam = shrinkage
        reg = (1 - lam) * cov + lam * torch.diag_embed(
            torch.diagonal(cov, dim1=-2, dim2=-1)
        )
        return dense_metric(reg)
    raise ValueError(kind)
