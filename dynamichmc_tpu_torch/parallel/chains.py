"""Batched chains on one device (port of the single-device path of
``dynamichmc_tpu.parallel.chains``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..engine import WarmupSchedule, execute
from ..errors import DynamicHMCError
from ..hamiltonian import evaluate
from ..logdensity import LogDensity, check_device
from ..mcmc import MCMCResult, _check_stepsize_search
from ..metric import Metric, identity_metric, metric_is_batched
from ..nuts import NUTS
from ..warmup import (
    WarmupStage,
    WarmupState,
    default_warmup_stages,
    random_position,
)


def init_chain_states(
    generator: torch.Generator,
    ld: LogDensity,
    n_chains: int,
    q: Optional[torch.Tensor] = None,
    metric: Optional[Metric] = None,
    eps=None,
    dtype=torch.float32,
    broadcast_metric: bool = True,
) -> WarmupState:
    """Initial states on the generator's device: uniform [-2, 2]^K
    positions per chain (or the given ``q``), identity metric, optional
    shared eps. The initial point is checked strictly: a non-finite log
    density at any chain raises ``DynamicHMCError`` naming the chains.
    ``broadcast_metric=False`` keeps a shared metric unbatched (pooled
    adaptation). Raises when the model's tensors lie on another device."""
    device = generator.device
    check_device(ld, device)
    if q is None:
        q = random_position(generator, n_chains, ld.dim, dtype, device)
    else:
        q = torch.as_tensor(q, dtype=dtype, device=device)
        if tuple(q.shape) != (n_chains, ld.dim):
            raise ValueError(
                f"q must have shape {(n_chains, ld.dim)}, got {tuple(q.shape)}"
            )
    Q = evaluate(ld, q)
    lds = Q.logdensity.cpu()
    bad = torch.nonzero(~torch.isfinite(lds)).flatten()
    if bad.numel():
        raise DynamicHMCError(
            "Invalid log posterior at initial positions.",
            chains=bad.tolist(),
            logdensities=lds[bad].tolist(),
        )
    if metric is None:
        metric = identity_metric(ld.dim, dtype=dtype, device=device)
    if broadcast_metric and not metric_is_batched(metric):
        metric = dataclasses.replace(metric, **{
            f.name: getattr(metric, f.name).expand(
                (n_chains,) + tuple(getattr(metric, f.name).shape)
            )
            for f in dataclasses.fields(metric)
        })
    if eps is not None:
        eps = torch.as_tensor(eps, dtype=dtype, device=device).expand(n_chains)
    return WarmupState(Q=Q, metric=metric, eps=eps)


def run_chains(
    generator: torch.Generator,
    ld: LogDensity,
    n_chains: int,
    n_samples: int,
    initialization: dict = {},
    warmup_stages: Optional[Tuple[WarmupStage, ...]] = None,
    algorithm: Optional[NUTS] = None,
    dtype=torch.float32,
    tune: str = "reference",
    log=None,
    warmup_depth_clamp: Optional[int] = None,
    warmup_depth_clamp_tail: int = 0,
) -> MCMCResult:
    """Run ``n_chains`` independently started NUTS chains, batched on the
    generator's device: stepsize search, staged warmup, then ``n_samples``
    draws. Every random number comes from ``generator``.

    ``tune="reference"`` fills unspecified knobs with the reference's
    semantics: per-chain diagonal metric, per-chain dual averaging,
    max_depth 10, no clamp. ``warmup_depth_clamp`` caps the tree doublings
    in every warmup block but the last (0 = no clamp);
    ``warmup_depth_clamp_tail`` extends the cap that many steps into the
    last block. Returns positions of shape (n_chains, n_samples, K).
    """
    if tune != "reference":
        raise NotImplementedError(
            f"tune={tune!r}: only tune='reference' is ported"
        )
    if warmup_depth_clamp == 0:
        warmup_depth_clamp = None
    if algorithm is None:
        algorithm = NUTS()
    if warmup_stages is None:
        warmup_stages = default_warmup_stages()
    if algorithm.turn_statistic_configuration != "generalized":
        raise NotImplementedError(
            "custom turn statistics need the per-chain generic driver, "
            "which is not ported"
        )
    schedule = WarmupSchedule.from_stages(tuple(warmup_stages))
    if schedule is None:
        raise NotImplementedError(
            "only homogeneous schedules (an optional stepsize search, then "
            "TuningNUTS blocks sharing one metric kind and adaptation) are "
            "ported"
        )
    if warmup_depth_clamp_tail and warmup_depth_clamp is None:
        raise ValueError("warmup_depth_clamp_tail requires warmup_depth_clamp")
    if warmup_depth_clamp is not None:
        if not 0 < warmup_depth_clamp <= algorithm.max_depth:
            raise ValueError("warmup_depth_clamp must be in 1..max_depth")
        schedule = dataclasses.replace(
            schedule, depth_clamp=warmup_depth_clamp,
            depth_clamp_tail=int(warmup_depth_clamp_tail),
        )
    states = init_chain_states(
        generator, ld, n_chains, dtype=dtype,
        broadcast_metric=not schedule.pooled, **initialization,
    )
    return _run_chains_fast(schedule, ld, algorithm, n_samples, states,
                            generator, log=log)


def _run_chains_fast(schedule: WarmupSchedule, ld: LogDensity,
                     algorithm: NUTS, n_samples: int, states: WarmupState,
                     generator: torch.Generator, log=None) -> MCMCResult:
    metric0 = states.metric
    if schedule.pooled and metric_is_batched(metric0):
        # shared-metric mode: one metric for all chains
        metric0 = dataclasses.replace(metric0, **{
            f.name: getattr(metric0, f.name)[0]
            for f in dataclasses.fields(metric0)
        })
    metric, eps, search_results, inference = execute(
        generator, ld, algorithm, schedule, states.Q, metric0, states.eps,
        n_samples, log=log,
    )
    _check_stepsize_search(search_results)
    _q, positions, logdensities, stats = inference
    return MCMCResult(
        positions=positions,
        logdensities=logdensities,
        tree_statistics=stats,
        metric=metric,
        eps=eps,
    )
