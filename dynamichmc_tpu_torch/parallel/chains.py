"""Batched chains on one device (port of the single-device path of
``dynamichmc_tpu.parallel.chains``).

Every stage tuple runs through the stage fold (warmup.run_warmup) on the
batch, each stage pooled or not as it says."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..engine import WarmupSchedule
from ..errors import DynamicHMCError
from ..hamiltonian import evaluate
from ..logdensity import LogDensity, check_device
from ..mcmc import MCMCResult, _check_stepsize_search, mcmc
from ..metric import Metric, identity_metric, metric_is_batched
from ..nuts import NUTS
from ..warmup import (
    WarmupStage,
    WarmupState,
    default_warmup_stages,
    first_adapting_stage,
    random_position,
    run_warmup,
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
    reporter=None,
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
    last block; both need an optional stepsize search followed by
    TuningNUTS blocks sharing one metric kind, adaptation and pooling, as
    in the JAX package.
    ``reporter=None`` means ``reporting.default_reporter()``; a reporter's
    messages (each warmup block) go to its ``report_message``, and an
    explicit ``log`` callable takes precedence. Returns positions of shape
    (n_chains, n_samples, K).
    """
    if log is None:
        from ..reporting import default_reporter, stage_log

        log = stage_log(default_reporter() if reporter is None else reporter)
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
            "run_chains with a custom turn statistic needs the generic "
            "driver looped over the chains, which is not ported (ROADMAP "
            "Queue 1 item 19); mcmc_with_warmup runs one chain with it"
        )
    stages = tuple(warmup_stages)
    if warmup_depth_clamp_tail and warmup_depth_clamp is None:
        raise ValueError("warmup_depth_clamp_tail requires warmup_depth_clamp")
    if warmup_depth_clamp is not None:
        if WarmupSchedule.from_stages(stages) is None:
            raise NotImplementedError(
                "warmup_depth_clamp requires an optional stepsize search, "
                "then TuningNUTS blocks sharing one metric kind, adaptation "
                "and pooling"
            )
        if not 0 < warmup_depth_clamp <= algorithm.max_depth:
            raise ValueError("warmup_depth_clamp must be in 1..max_depth")
    # the chains share a metric from the start if its first estimate pools
    first = first_adapting_stage(stages)
    pooled = first is not None and first.pooled
    states = init_chain_states(
        generator, ld, n_chains, dtype=dtype, broadcast_metric=not pooled,
        **initialization,
    )
    if pooled:
        states = dataclasses.replace(states, metric=_shared(states.metric))
    history, state = run_warmup(
        generator, ld, algorithm, stages, states, collect_stats=False,
        log=log, depth_clamp=warmup_depth_clamp,
        depth_clamp_tail=warmup_depth_clamp_tail)
    _check_stepsize_search(history)
    _q, inference = mcmc(generator, ld, algorithm, state, n_samples)
    return MCMCResult(
        positions=inference.positions,
        logdensities=inference.logdensities,
        tree_statistics=inference.tree_statistics,
        metric=state.metric,
        eps=state.eps,
    )


def _shared(metric: Metric) -> Metric:
    """One metric for all chains: a per-chain initial metric's first
    chain's."""
    if not metric_is_batched(metric):
        return metric
    return dataclasses.replace(metric, **{
        f.name: getattr(metric, f.name)[0] for f in dataclasses.fields(metric)
    })
