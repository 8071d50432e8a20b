"""Batched chains on one device (port of the single-device path of
``dynamichmc_tpu.parallel.chains``).

Every stage tuple runs through the stage fold (warmup.run_warmup) on the
batch, each stage pooled or not as it says; the draws come in chunks
(engine.run_sampling), which a draw sink can take off the device."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..engine import WarmupSchedule, run_sampling
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
    draw_sink=None,
    reporter=None,
    warmup_depth_clamp: Optional[int] = None,
    warmup_depth_clamp_tail: int = 0,
    sample_chunk: Optional[int] = None,
    warmup_checkpoint_sink=None,
    warmup_resume=None,
    ess_target: Optional[float] = None,
    ess_check_start: int = 0,
    ess_check_factor: float = 2.0,
) -> MCMCResult:
    """Run ``n_chains`` independently started NUTS chains, batched on the
    generator's device: stepsize search, staged warmup, then ``n_samples``
    draws. Every random number comes from ``generator``.

    ``tune="reference"`` fills unspecified knobs with the reference's
    semantics: per-chain diagonal metric, per-chain dual averaging,
    max_depth 10, no clamp. ``warmup_depth_clamp`` caps the tree doublings
    in every warmup block but the last (0 = no clamp);
    ``warmup_depth_clamp_tail`` extends the cap that many steps into the
    last block.
    ``reporter=None`` means ``reporting.default_reporter()``; a reporter's
    messages (each warmup block, each sampling chunk) go to its
    ``report_message``, and an explicit ``log`` callable takes precedence.

    ``sample_chunk``: draws per sampling chunk (default
    ``max(8, min(512, 2**28 // (n_chains * dim)))``, as in the JAX
    package; an explicit value is capped at ``n_samples``). A chunk
    boundary is where ``draw_sink`` and the ESS check run; the draws are
    the same for every chunk size.
    ``draw_sink(start, positions, logdensities, tree_statistics)``: each
    chunk leaves the device through it (``io.MemmapDrawStore.sink``); the
    result's positions and logdensities are then None.
    ``ess_target``: sample until the min over coordinates of the pooled
    bulk ESS reaches it, checked at ``ess_check_start`` draws (0: the
    first chunk boundary >= ``max(sample_chunk, 64)``) and then at draw
    counts growing by ``ess_check_factor`` (1.0: every chunk);
    ``n_samples`` is the cap, and positions hold the draws taken. Not with
    a ``draw_sink``.
    ``warmup_checkpoint_sink`` is called with an
    ``engine.WarmupCheckpoint`` after the stepsize search and after every
    warmup stage (persist with ``checkpoint.save_state``);
    ``warmup_resume`` continues a run from one, with the same model,
    stages, chain count and seed, and gives the uninterrupted run's draws
    bit for bit.

    The warmup depth clamp, ``draw_sink``, ``ess_target`` and
    checkpointing need an optional stepsize search followed by TuningNUTS
    blocks sharing one metric kind, adaptation and pooling, as in the JAX
    package. Returns positions of shape (n_chains, n_samples, K).
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
    uses = [name for name, value in (
        ("warmup_depth_clamp", warmup_depth_clamp), ("draw_sink", draw_sink),
        ("ess_target", ess_target),
        ("warmup checkpoint/resume", warmup_checkpoint_sink),
        ("warmup checkpoint/resume", warmup_resume)) if value is not None]
    if uses and WarmupSchedule.from_stages(stages) is None:
        raise NotImplementedError(
            f"{uses[0]} requires an optional stepsize search, then "
            "TuningNUTS blocks sharing one metric kind, adaptation and "
            "pooling"
        )
    if warmup_depth_clamp is not None and not (
            0 < warmup_depth_clamp <= algorithm.max_depth):
        raise ValueError("warmup_depth_clamp must be in 1..max_depth")
    if ess_target is not None:
        if draw_sink is not None:
            raise DynamicHMCError(
                "ess_target needs the accumulated draws on the device to "
                "evaluate convergence; it cannot be combined with a "
                "draw_sink")
        if not ess_target > 0:
            raise DynamicHMCError("ess_target must be > 0")
        if not ess_check_factor >= 1.0:
            raise DynamicHMCError("ess_check_factor must be >= 1.0")
    if sample_chunk is None:
        sample_chunk = default_sample_chunk(n_chains, ld.dim)
    else:
        sample_chunk = int(min(sample_chunk, n_samples))
        if sample_chunk < 1:
            raise ValueError("sample_chunk must be >= 1")
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
        depth_clamp_tail=warmup_depth_clamp_tail,
        checkpoint_sink=warmup_checkpoint_sink, resume=warmup_resume)
    _check_stepsize_search(history)
    _q, positions, lds, stats = run_sampling(
        generator, ld, algorithm, state.Q, state.metric, state.eps,
        n_samples, sample_chunk=sample_chunk, draw_sink=draw_sink,
        ess_target=ess_target, ess_check_start=ess_check_start,
        ess_check_factor=ess_check_factor, log=log)
    return MCMCResult(
        positions=positions,
        logdensities=lds,
        tree_statistics=stats,
        metric=state.metric,
        eps=state.eps,
    )


def default_sample_chunk(n_chains: int, dim: int) -> int:
    """Draws per sampling chunk when ``run_chains`` is given none: about
    1 GB of float32 positions, between 8 and 512 draws (the JAX package's
    rule, ``parallel/chains.py``)."""
    return int(max(8, min(512, (1 << 28) // max(n_chains * dim, 1))))


def _shared(metric: Metric) -> Metric:
    """One metric for all chains: a per-chain initial metric's first
    chain's."""
    if not metric_is_batched(metric):
        return metric
    return dataclasses.replace(metric, **{
        f.name: getattr(metric, f.name)[0] for f in dataclasses.fields(metric)
    })
