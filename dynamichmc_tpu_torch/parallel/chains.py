"""Batched chains on one device, or over a mesh of devices (port of
``dynamichmc_tpu.parallel.chains``).

Every stage tuple runs through the stage fold (warmup.run_warmup) on the
batch, each stage pooled or not as it says; the draws come in chunks
(engine.run_sampling), which a draw sink can take off the device. By
default (``tune="auto"``) the knobs a caller leaves out come from
autotune.py, as in the JAX package. A custom turn statistic runs the
generic per-chain driver looped over the chains (engine.looped_ops).
Over a mesh (parallel/mesh.py) each rank runs its share of the chains
through the same code, and the pooling points and the checks that read
every chain make collective calls."""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import torch

from ..engine import WarmupSchedule, run_sampling
from ..errors import DynamicHMCError
from ..hamiltonian import evaluate
from ..logdensity import LogDensity, check_device
from ..mcmc import MCMCResult, _check_stepsize_search
from ..metric import Metric, identity_metric, metric_is_batched
from ..nuts import NUTS
from ..stepsize import PooledStepsize
from .mesh import ChainMesh, all_gather_chains, all_sum, broadcast_from
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
    mesh: Optional[ChainMesh] = None,
) -> WarmupState:
    """Initial states on the generator's device: uniform [-2, 2]^K
    positions per chain (or the given ``q``), identity metric, optional
    shared eps. The initial point is checked strictly: a non-finite log
    density at any chain raises ``DynamicHMCError`` naming the chains.
    ``broadcast_metric=False`` keeps a shared metric unbatched (pooled
    adaptation). Raises when the model's tensors lie on another device.
    ``mesh``: the ``n_chains`` chains are this rank's, and the check reads
    every rank's, so that every rank raises the same error, naming global
    chains (rank r's chain i is chain r * n_chains + i)."""
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
    lds = Q.logdensity if mesh is None else all_gather_chains(Q.logdensity,
                                                              mesh)
    lds = lds.cpu()
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
    tune: str = "auto",
    mesh=None,
    log=None,
    draw_sink=None,
    reporter=None,
    warmup_driver: str = "sync",
    sampling_driver: str = "sync",
    stratify_sampling: int = 0,
    warmup_depth_clamp: Optional[int] = None,
    warmup_depth_clamp_tail: int = 0,
    sample_chunk: Optional[int] = None,
    epoch_ring: int = 8,
    warmup_checkpoint_sink=None,
    warmup_resume=None,
    ess_target: Optional[float] = None,
    ess_check_start: int = 0,
    ess_check_factor: float = 2.0,
) -> MCMCResult:
    """Run ``n_chains`` independently started NUTS chains, batched on the
    generator's device: stepsize search, staged warmup, then ``n_samples``
    draws. Every random number comes from ``generator``.

    ``tune="auto"`` (the default, as in the JAX package) fills every knob
    the caller left out from :func:`autotune.auto_choices`, keyed on
    ``n_chains`` and the target's dimension: the metric's kind and pooling
    in the default warmup stages, per-chain eps, the warmup depth clamp
    and, for large lockstep fleets, a sampling ``max_depth`` cap. It logs
    one ``autotune: ...`` line of what it applied, and after the run warns
    when more than ``autotune.CAP_SATURATION_WARN`` of the draws hit an
    auto-applied cap. Explicit arguments win: ``algorithm`` pins the
    depth (the cap applies only when neither ``algorithm`` nor stages were
    given), and ``warmup_depth_clamp=0`` means no clamp. A custom turn
    statistic gets no stages and no clamp.
    ``tune="reference"`` fills unspecified knobs with the reference's
    semantics: per-chain diagonal metric, per-chain dual averaging,
    max_depth 10, no clamp. ``warmup_depth_clamp`` caps the tree doublings
    in every warmup block but the last (0 = no clamp);
    ``warmup_depth_clamp_tail`` extends the cap that many steps into the
    last block.
    ``reporter=None`` means ``reporting.default_reporter()``; a reporter's
    messages (each warmup block, each sampling chunk) go to its
    ``report_message``, and an explicit ``log`` callable takes precedence.

    An algorithm with a custom turn statistic runs the generic driver
    looped over the chains (``engine.looped_ops``), chain by chain, C
    times one chain's host time a transition; as in the JAX package it
    takes no pooled stepsize, no warmup depth clamp and no warmup
    checkpoint or resume.

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

    The schedulers, with the JAX package's keywords and refusals:
    ``warmup_driver="wavefront"`` runs every TuningNUTS stage through the
    aligned wavefront (tree_wavefront.py: each lane its own transitions,
    no lockstep barrier; the stepsize search stays lockstep; the clamp per
    lane; no checkpoint or resume); over a mesh a per-chain eps makes no
    collective in the slot loop, and a pooled one runs epoch-lockstep, one
    ``all_reduce`` every 16 slots. ``sampling_driver="epoch"`` takes the
    draws through the epoch wavefront (tree_wavefront_epoch.py, no
    collective over a mesh; ``epoch_ring`` bounds how many draws a chain
    may run ahead of the slowest; no ``ess_target``).
    ``stratify_sampling=G`` (a per-chain eps) sorts the chains by their
    adapted eps and samples G groups of C/G one after the other, each
    bounded by its own deepest tree (no ``ess_target``); over a mesh the
    sort is a permutation over the ranks, each rank sampling one eps band.
    The draws come back in the caller's chain order, and the warmup is
    untouched.

    ``mesh`` (a ``parallel.mesh.ChainMesh``, not a ``jax.sharding.Mesh``):
    run the chains over a ``torch.distributed`` process group, one rank per
    device, every rank making this same call. ``n_chains`` is global and
    must divide by ``mesh.size``; each rank runs ``n_chains / size``
    chains on ``mesh.device``, where ``generator`` must lie. Sampling
    needs no communication; a pooled stage pools its Welford moments over
    every rank before each metric estimate, a pooled stepsize its initial
    eps and every acceptance signal, and the stepsize search's and the
    initial point's checks, the ESS target's check and the cap warning
    read every rank's chains, so that every rank takes the same decision
    and raises the same error. The result holds this rank's chains
    (positions (n_chains / size, n_samples, K), and so on), with the pooled
    metric and eps the same on every rank, bit for bit; a per-chain
    ``initialization`` (``q``, a batched metric, eps) holds this rank's
    chains too, and a per-chain initial metric under pooling is reduced to
    global chain 0's, rank 0's. One generator drives a rank's whole batch,
    so the ranks' generators must be in different states (else two ranks
    would run the same chains and the ESS would count them twice): their
    states are compared without drawing, and equal states raise
    ``DynamicHMCError``; ``multihost.run_chains_multihost`` derives one
    stream per rank from one seed. ``draw_sink`` receives the rank's own
    chains (one ``io.MemmapDrawStore`` per rank), and each rank
    checkpoints and resumes its own chains and generator. A mesh of one
    rank gives the draws, metric and eps of the call without a mesh.
    """
    if log is None:
        from ..reporting import default_reporter, stage_log

        log = stage_log(default_reporter() if reporter is None else reporter)
    if tune not in ("auto", "reference"):
        raise ValueError("tune must be 'auto' or 'reference'")
    if warmup_driver not in ("sync", "wavefront"):
        raise ValueError("warmup_driver must be 'sync' or 'wavefront'")
    if sampling_driver not in ("sync", "epoch"):
        raise ValueError("sampling_driver must be 'sync' or 'epoch'")
    n_local = _local_chains(n_chains, mesh)
    # warmup_depth_clamp=0 means "no clamp", which auto does not fill in
    explicit_no_clamp = warmup_depth_clamp == 0
    if explicit_no_clamp:
        warmup_depth_clamp = None
    auto_cap = None
    if tune == "auto":
        (algorithm, warmup_stages, warmup_depth_clamp,
         warmup_depth_clamp_tail, auto_cap) = _auto_tune(
            n_chains, ld.dim, algorithm, warmup_stages, warmup_depth_clamp,
            warmup_depth_clamp_tail, explicit_no_clamp, log)
    if algorithm is None:
        algorithm = NUTS()
    if warmup_stages is None:
        warmup_stages = default_warmup_stages()
    stages = tuple(warmup_stages)
    schedule = WarmupSchedule.from_stages(stages)
    if warmup_depth_clamp_tail and warmup_depth_clamp is None:
        raise ValueError("warmup_depth_clamp_tail requires warmup_depth_clamp")
    _check_schedulers(schedule, algorithm, n_chains, mesh, warmup_driver,
                      sampling_driver, stratify_sampling, ess_target,
                      warmup_checkpoint_sink, warmup_resume)
    uses = [name for name, value in (
        ("warmup_depth_clamp", warmup_depth_clamp), ("draw_sink", draw_sink),
        ("ess_target", ess_target),
        ("warmup checkpoint/resume", warmup_checkpoint_sink),
        ("warmup checkpoint/resume", warmup_resume)) if value is not None]
    if uses and schedule is None:
        raise NotImplementedError(
            f"{uses[0]} requires an optional stepsize search, then "
            "TuningNUTS blocks sharing one metric kind, adaptation and "
            "pooling"
        )
    if warmup_depth_clamp is not None and not (
            0 < warmup_depth_clamp <= algorithm.max_depth):
        raise ValueError("warmup_depth_clamp must be in 1..max_depth")
    if (algorithm.turn_statistic_configuration != "generalized"
            and schedule is not None):
        _check_custom_statistic(schedule, warmup_depth_clamp,
                                warmup_checkpoint_sink, warmup_resume)
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
    if mesh is not None:
        _check_ranks(generator, mesh, warmup_resume)
    first = first_adapting_stage(stages)
    pooled = first is not None and first.pooled
    states = init_chain_states(
        generator, ld, n_local, dtype=dtype, broadcast_metric=not pooled,
        mesh=mesh, **initialization,
    )
    if pooled:
        states = dataclasses.replace(states,
                                     metric=_shared(states.metric, mesh))
    history, state = run_warmup(
        generator, ld, algorithm, stages, states, collect_stats=False,
        log=log, depth_clamp=warmup_depth_clamp,
        depth_clamp_tail=warmup_depth_clamp_tail,
        checkpoint_sink=warmup_checkpoint_sink, resume=warmup_resume,
        mesh=mesh, warmup_driver=warmup_driver)
    _check_stepsize_search(history, mesh)
    _q, positions, lds, stats = run_sampling(
        generator, ld, algorithm, state.Q, state.metric, state.eps,
        n_samples, sample_chunk=sample_chunk, draw_sink=draw_sink,
        ess_target=ess_target, ess_check_start=ess_check_start,
        ess_check_factor=ess_check_factor, log=log, mesh=mesh,
        sampling_driver=sampling_driver, epoch_ring=epoch_ring,
        stratify_sampling=stratify_sampling)
    _warn_auto_cap(stats, auto_cap, log, mesh)
    return MCMCResult(
        positions=positions,
        logdensities=lds,
        tree_statistics=stats,
        metric=state.metric,
        eps=state.eps,
    )


def _check_schedulers(schedule, algorithm, n_chains, mesh, warmup_driver,
                      sampling_driver, stratify_sampling, ess_target,
                      checkpoint_sink, resume) -> None:
    """The JAX package's refusals of the scheduling keywords, with its
    exception types and messages (``parallel/chains.py`` and its
    ``_run_chains_fast``)."""
    custom = algorithm.turn_statistic_configuration != "generalized"
    if sampling_driver == "epoch":
        if stratify_sampling:
            raise ValueError(
                "stratify_sampling is a scheduler for the synchronized "
                "sampler; the epoch driver already desynchronizes lanes")
        if custom:
            raise NotImplementedError(
                "epoch sampling requires the batch-native drivers "
                "(generalized turn statistic)")
        if schedule is None:
            raise NotImplementedError(
                "epoch sampling requires a fast-engine-expressible warmup "
                "schedule (homogeneous TuningNUTS blocks)")
    if ((checkpoint_sink is not None or resume is not None)
            and warmup_driver != "sync"):
        raise NotImplementedError(
            "warmup checkpoint/resume requires the sync (monolithic) "
            "warmup driver")
    if schedule is None and stratify_sampling:
        raise NotImplementedError(
            "draw_sink / stratify_sampling require a fast-engine-"
            "expressible warmup schedule (homogeneous TuningNUTS blocks)")
    if ess_target is not None and schedule is not None:
        if sampling_driver != "sync":
            raise NotImplementedError(
                "ess_target requires the sync sampling driver")
        if stratify_sampling and mesh is None:
            raise NotImplementedError(
                "ess_target is incompatible with group-serial "
                "stratify_sampling (mesh stratification by permutation "
                "is supported)")
    if warmup_driver == "wavefront":
        if schedule is None:
            raise NotImplementedError(
                "wavefront warmup requires a fast-engine-expressible warmup "
                "schedule (homogeneous TuningNUTS blocks)")
        if custom:
            raise NotImplementedError(
                "wavefront warmup requires the batch-native drivers "
                "(generalized turn statistic)")
    if stratify_sampling:
        if custom:
            raise NotImplementedError(
                "stratify_sampling requires the batch-native path")
        if isinstance(schedule.adaptation, PooledStepsize):
            raise ValueError(
                "stratify_sampling requires per-chain stepsize adaptation "
                "(pooled_stepsize=False)")
        if mesh is None and n_chains % int(stratify_sampling):
            raise ValueError(
                f"n_chains={n_chains} not divisible by stratify_sampling="
                f"{stratify_sampling}")


def _local_chains(n_chains: int, mesh: Optional[ChainMesh]) -> int:
    """The chains this rank runs: ``n_chains``, or its share over a mesh
    (the JAX package's divisibility error)."""
    if mesh is None:
        return n_chains
    if not isinstance(mesh, ChainMesh):
        raise TypeError(
            "mesh must be a parallel.mesh.ChainMesh (a torch.distributed "
            f"process group), got {type(mesh).__name__}")
    if n_chains % mesh.size:
        raise ValueError(
            f"n_chains={n_chains} not divisible by mesh size {mesh.size}")
    return n_chains // mesh.size


def _fingerprint(state: torch.Tensor) -> int:
    """A 64-bit fingerprint of a ``generator.get_state()``."""
    digest = hashlib.blake2b(state.cpu().numpy().tobytes(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little", signed=True)


def _check_ranks(generator: torch.Generator, mesh: ChainMesh,
                 resume) -> None:
    """Before a run over a mesh, on every rank alike: the generator lies
    on the mesh's device, the ranks' random streams differ (two ranks in
    one generator state would run the same chains; the states are
    compared, not drawn from) and every rank resumes from the same warmup
    stage, or none does. One collective."""
    device = torch.device(generator.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device != mesh.device:
        raise ValueError(f"the generator lies on {device}, the mesh's "
                         f"chains on {mesh.device}")
    state = generator.get_state() if resume is None else resume.generator_state
    row = torch.tensor([[_fingerprint(state),
                         -1 if resume is None else resume.stage]],
                       dtype=torch.int64, device=mesh.device)
    rows = all_gather_chains(row, mesh).cpu()
    stages = rows[:, 1].tolist()
    if len(set(stages)) > 1:
        raise DynamicHMCError(
            "warmup_resume: the ranks resume from different warmup stages "
            "(-1: no resume)", stages=stages)
    fingerprints = rows[:, 0].tolist()
    if len(set(fingerprints)) < mesh.size:
        raise DynamicHMCError(
            "two ranks' generators are in the same state, so they would run "
            "the same chains: seed each rank's generator apart "
            "(multihost.run_chains_multihost derives one stream per rank "
            "from one seed)", fingerprints=fingerprints)


def _auto_tune(n_chains, dim, algorithm, warmup_stages, warmup_depth_clamp,
               warmup_depth_clamp_tail, explicit_no_clamp, log):
    """``tune="auto"``: fill the knobs the caller left out from
    ``autotune.auto_choices``, as the JAX package does, and log what was
    applied. Returns (algorithm, warmup_stages, warmup_depth_clamp,
    warmup_depth_clamp_tail, the auto-applied max_depth cap or None)."""
    from ..autotune import auto_choices

    choices = auto_choices(
        n_chains, dim,
        max_depth_limit=algorithm.max_depth if algorithm is not None else 10)
    generalized = (algorithm is None
                   or algorithm.turn_statistic_configuration == "generalized")
    applied, auto_cap = [], None
    if algorithm is None:
        # the cap only where auto also owns the warmup stages: its safety
        # rests on the pooled metric's quality
        if choices.max_depth is not None and warmup_stages is None:
            algorithm = NUTS(max_depth=choices.max_depth)
            auto_cap = choices.max_depth
            applied.append(f"max_depth={choices.max_depth}")
        else:
            algorithm = NUTS()
    if warmup_stages is None and generalized:
        pooled_eps = choices.pooled_stepsize and choices.pooled_metric
        warmup_stages = default_warmup_stages(
            metric_kind=choices.metric_kind, pooled=choices.pooled_metric,
            pooled_stepsize=pooled_eps)
        applied.append(("pooled " if choices.pooled_metric else "per-chain ")
                       + choices.metric_kind + " metric")
        applied.append("pooled eps" if pooled_eps else "per-chain eps")
    if (warmup_depth_clamp is None and not explicit_no_clamp and generalized
            and warmup_stages is not None):
        schedule = WarmupSchedule.from_stages(tuple(warmup_stages))
        if schedule is not None and choices.warmup_depth_clamp:
            warmup_depth_clamp = min(choices.warmup_depth_clamp,
                                     algorithm.max_depth)
            if warmup_depth_clamp_tail == 0:
                warmup_depth_clamp_tail = min(
                    choices.warmup_depth_clamp_tail,
                    schedule.block_sizes[-1] // 2)
            applied.append(f"warmup clamp {warmup_depth_clamp}"
                           f"/{warmup_depth_clamp_tail}")
    if applied and log is not None:
        log("autotune: " + ", ".join(applied))
    return (algorithm, warmup_stages, warmup_depth_clamp,
            warmup_depth_clamp_tail, auto_cap)


def _check_custom_statistic(schedule, warmup_depth_clamp,
                            warmup_checkpoint_sink, warmup_resume) -> None:
    """What the JAX package refuses for a custom turn statistic on a
    schedule of TuningNUTS blocks, with its messages."""
    if warmup_checkpoint_sink is not None or warmup_resume is not None:
        raise NotImplementedError(
            "warmup checkpoint/resume requires the batch-native drivers "
            "(generalized turn statistic)")
    if warmup_depth_clamp is not None:
        raise NotImplementedError(
            "warmup_depth_clamp requires the batch-native drivers "
            "(generalized turn statistic)")
    if isinstance(schedule.adaptation, PooledStepsize):
        raise NotImplementedError(
            "pooled stepsize adaptation requires the batch-native drivers "
            "(generalized turn statistic)")


def _warn_auto_cap(stats, auto_cap, log, mesh=None) -> None:
    """After a run whose max_depth auto applied: warn when more than
    ``CAP_SATURATION_WARN`` of the draws hit the cap, which costs mixing,
    never exactness (one scalar read from the device). ``mesh``: the share
    of every rank's draws, on every rank."""
    from ..autotune import CAP_SATURATION_WARN

    if (auto_cap is None or stats.depth.numel() == 0
            or (log is None and mesh is None)):
        return
    hits = (stats.depth >= auto_cap).float().mean()
    if mesh is not None:
        hits = all_sum(hits.double(), mesh) / mesh.size
    frac = float(hits)
    if log is not None and frac > CAP_SATURATION_WARN:
        log(f"autotune WARNING: {100 * frac:.0f}% of draws hit the "
            f"auto-applied max_depth={auto_cap} cap — this target builds "
            "genuinely deep trajectories, and the cap is costing mixing. "
            "Pass algorithm=NUTS() (reference max_depth 10) or "
            "tune='reference' and compare ESS.")


def default_sample_chunk(n_chains: int, dim: int) -> int:
    """Draws per sampling chunk when ``run_chains`` is given none: about
    1 GB of float32 positions, between 8 and 512 draws (the JAX package's
    rule, ``parallel/chains.py``)."""
    return int(max(8, min(512, (1 << 28) // max(n_chains * dim, 1))))


def _shared(metric: Metric, mesh: Optional[ChainMesh] = None) -> Metric:
    """One metric for all chains: a per-chain initial metric's first
    chain's (over a mesh, rank 0's first chain's on every rank)."""
    if not metric_is_batched(metric):
        return metric
    return dataclasses.replace(metric, **{
        f.name: (getattr(metric, f.name)[0] if mesh is None
                 else broadcast_from(getattr(metric, f.name)[0], mesh))
        for f in dataclasses.fields(metric)
    })
