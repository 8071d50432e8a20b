"""Staged warmup: configuration, metric estimation and the stage fold
(port of ``dynamichmc_tpu.warmup``).

The Stan-like windowed schedule: stepsize search, 75 eps-only steps,
25/50/100/200/400 eps+metric blocks, 50 eps-only steps. The metric is
re-estimated from streaming Welford moments, optionally pooled over all
chains (one shared metric).

``run_warmup`` is the reference's left fold over any stage tuple
(mcmc.jl:450-457), for one (K,) chain or a (C, K) batch, and the one
warmup path of the port's entry points: each TuningNUTS stage runs the
engine's block loop (engine.run_block).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from .errors import DynamicHMCError
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


# --- the stage fold ---------------------------------------------------------


def first_adapting_stage(stages, start: int = 0) -> Optional[TuningNUTS]:
    """The first metric-adapting TuningNUTS stage at or after index
    ``start``, or None."""
    for stage in stages[start:]:
        if isinstance(stage, TuningNUTS) and stage.metric_kind != "none":
            return stage
    return None


def warmup_stage(generator: torch.Generator, ld: LogDensity, algorithm,
                 stage: WarmupStage, state: WarmupState,
                 collect_positions: bool = False, collect_stats: bool = True,
                 log=None, reporter=None, metric_kind: Optional[str] = None,
                 depth_clamp: Optional[int] = None, clamp_steps: int = 0,
                 mesh=None, warmup_driver: str = "sync"):
    """Run one warmup stage on one (K,) chain or a (C, K) batch, as the
    state's positions say; returns (results, state').

    ``results`` is None for a None stage (mcmc.jl:99-101), ``{eps,
    success, l0}`` for a stepsize search, and for a TuningNUTS stage each
    step's ``logdensities``, ``tree_statistics`` and ``epss`` (with
    ``collect_positions``, ``positions``), steps on the axis after the
    chain axis; ``{}`` with ``collect_stats=False``. A batch pools the
    Welford moments over its chains when the stage is ``pooled``, and runs
    the batch driver, or the generic driver looped over its chains when
    the algorithm has a custom turn statistic (engine.chain_ops).
    ``metric_kind``: run the transitions with the metric promoted to this
    kind (a diagonal metric to its dense form; numerically a no-op).
    ``log`` receives the search's message, ``reporter`` (a step reporter)
    every transition. ``depth_clamp`` caps the tree doublings of the
    stage's first ``clamp_steps`` transitions (a batch only). ``mesh`` (a
    ``parallel.mesh.ChainMesh``, a batch only): a pooled stage pools its
    moments, and a ``PooledStepsize`` its stepsize, over every rank's
    chains. ``warmup_driver="wavefront"`` (a batch only) runs a TuningNUTS
    stage through the aligned wavefront (engine.run_block_wavefront; the
    clamp per lane, no per-step results or reporter); a stepsize search
    runs the lockstep driver either way."""
    from .engine import (chain_ops, promote_metric, run_block,
                         run_block_wavefront, stepsize_message)

    if stage is None:
        return None, state
    batched = state.Q.q.ndim == 2
    if isinstance(stage, InitialStepsizeSearch):
        if state.eps is not None:
            raise DynamicHMCError(
                "stepsize eps manually specified, won't perform initial search"
            )
        ops = chain_ops(algorithm, batched)
        eps, success, l0 = ops.make_search(ld, stage)(generator, state.Q,
                                                      state.metric)
        if log is not None:
            log(stepsize_message(eps))
        return ({"eps": eps, "success": success, "l0": l0},
                WarmupState(Q=state.Q, metric=state.metric, eps=eps))
    if not isinstance(stage, TuningNUTS):
        raise TypeError(f"not a warmup stage: {stage!r}")
    if state.eps is None:
        raise DynamicHMCError("no stepsize: run a stepsize search stage first")
    metric = (state.metric if metric_kind is None
              else promote_metric(state.metric, metric_kind))
    collect = collect_stats or collect_positions
    adaptation = stage.stepsize_adaptation
    if mesh is not None and isinstance(adaptation, PooledStepsize):
        stage = dataclasses.replace(
            stage, stepsize_adaptation=dataclasses.replace(adaptation,
                                                           mesh=mesh))
    if warmup_driver == "wavefront":
        if not batched or collect:
            raise ValueError("the wavefront warmup runs a (C, K) batch and "
                             "records no per-step results")
        Q, metric, eps = run_block_wavefront(
            generator, ld, algorithm, stage, state.Q, metric, state.eps,
            depth_clamp=depth_clamp, clamp_steps=clamp_steps, mesh=mesh)
        return {}, WarmupState(Q=Q, metric=metric, eps=eps)
    Q, metric, eps, results = run_block(
        generator, ld, algorithm, stage, state.Q, metric, state.eps,
        ops=chain_ops(algorithm, batched, stage.pooled),
        collect=collect, collect_positions=collect_positions,
        reporter=reporter, depth_clamp=depth_clamp, clamp_steps=clamp_steps,
        mesh=mesh)
    if not collect:
        results = {}
    elif not collect_stats:
        results = {"positions": results["positions"]}
    return results, WarmupState(Q=Q, metric=metric, eps=eps)


def _stage_start_steps(stages) -> list:
    """The absolute warmup step at which each stage of ``stages`` starts,
    and the total after the last: the TuningNUTS steps before it."""
    starts = [0]
    for stage in stages:
        n = stage.N if isinstance(stage, TuningNUTS) else 0
        starts.append(starts[-1] + n)
    return starts


def _check_resume(stages, starts, resume, state) -> None:
    """Raise ``DynamicHMCError`` unless ``resume`` can continue this run:
    the same chain-state shape, and a step that is a stage boundary of
    this schedule."""
    if tuple(resume.Q.q.shape) != tuple(state.Q.q.shape):
        raise DynamicHMCError(
            f"warmup_resume chain state shape {tuple(resume.Q.q.shape)} "
            f"does not match this run's {tuple(state.Q.q.shape)}")
    if not 0 <= resume.step <= starts[-1]:
        raise DynamicHMCError(
            f"warmup_resume step {resume.step} is outside this schedule's "
            f"0..{starts[-1]} warmup steps")
    if not (0 <= resume.stage <= len(stages)
            and starts[resume.stage] == resume.step):
        raise DynamicHMCError(
            f"warmup_resume step {resume.step} at stage {resume.stage} is "
            "not a stage boundary of this schedule")


def run_warmup(generator: torch.Generator, ld: LogDensity, algorithm,
               stages: Tuple[WarmupStage, ...], state: WarmupState,
               collect_positions: bool = False, collect_stats: bool = True,
               log=None, reporter=None, depth_clamp: Optional[int] = None,
               depth_clamp_tail: int = 0, checkpoint_sink=None,
               resume=None, mesh=None, warmup_driver: str = "sync"):
    """Left fold of warmup stages (mcmc.jl:450-457) over one chain or a
    batch, every random number from ``generator`` in stage order. Returns
    (history, final state), ``history`` a list of (stage, results,
    state after the stage) aligned with ``stages``.

    Each TuningNUTS stage runs with its metric promoted to the kind of the
    next metric-adapting stage at or after it, so a diagonal stage keeps a
    diagonal metric and a dense block (and the eps-only stages before it)
    runs with a dense one. ``log`` receives a message per stage.

    ``depth_clamp`` (a batch only) caps the tree doublings in every
    TuningNUTS stage but the last, where early trees on an unadapted metric
    hit max depth and pin the lockstep batch; ``depth_clamp_tail`` extends
    the cap that many steps into the last stage (the dual-averaging restart
    transient), never over the whole of it. Any cap is a valid NUTS kernel:
    only the adaptation trajectory changes, and sampling is never
    clamped.

    ``checkpoint_sink`` is called with an ``engine.WarmupCheckpoint`` after
    the stepsize search and after every TuningNUTS stage. ``resume`` (such
    a checkpoint) skips the stages before ``resume.stage``, restores the
    state and the search's results, and sets ``generator`` to the
    checkpoint's state, so the fold continues the interrupted one bit for
    bit (the clamp applied per stage as above); ``history`` then holds the
    restored search, if any, and the stages run.

    ``mesh`` (a ``parallel.mesh.ChainMesh``, a batch only): the batch is
    this rank's chains, and every pooled stage pools over the ranks
    (:func:`warmup_stage`); each rank checkpoints and resumes its own
    chains and generator.

    ``warmup_driver="wavefront"`` (a batch only) runs every TuningNUTS
    stage through the aligned wavefront, the clamp applied per lane to
    each lane's first transitions of a stage: all of them but in the last
    stage, ``depth_clamp_tail`` of them there (the JAX package's per-lane
    tail clamp, not capped at N - 1)."""
    from .engine import WarmupCheckpoint

    stages = tuple(stages)
    tuning = [s for s, stage in enumerate(stages)
              if isinstance(stage, TuningNUTS)]
    starts = _stage_start_steps(stages)
    history, search, first = [], None, 0
    if resume is not None:
        _check_resume(stages, starts, resume, state)
        state = WarmupState(Q=resume.Q, metric=resume.metric, eps=resume.eps)
        search, first = resume.search, resume.stage
        if search is not None:
            searched = next((s for s in stages[:first]
                             if isinstance(s, InitialStepsizeSearch)), None)
            history.append((searched, search, state))
        generator.set_state(resume.generator_state.cpu())
    for s in range(first, len(stages)):
        stage = stages[s]
        adapting = first_adapting_stage(stages, s)
        clamp_steps = 0
        if depth_clamp is not None and s in tuning:
            tail = int(depth_clamp_tail)
            clamp_steps = (stage.N if s != tuning[-1] else
                           tail if warmup_driver == "wavefront" else
                           min(tail, stage.N - 1))
        results, state = warmup_stage(
            generator, ld, algorithm, stage, state,
            collect_positions=collect_positions, collect_stats=collect_stats,
            log=log, reporter=reporter,
            metric_kind=None if adapting is None else adapting.metric_kind,
            depth_clamp=depth_clamp, clamp_steps=clamp_steps, mesh=mesh,
            warmup_driver=warmup_driver)
        history.append((stage, results, state))
        if isinstance(stage, InitialStepsizeSearch):
            search = results
        if log is not None and isinstance(stage, TuningNUTS):
            log(f"warmup stage {s + 1}/{len(stages)} done ({stage.N} steps)")
        if checkpoint_sink is not None and stage is not None:
            checkpoint_sink(WarmupCheckpoint(
                step=starts[s + 1], stage=s + 1, Q=state.Q,
                metric=state.metric, eps=state.eps, search=search,
                generator_state=generator.get_state()))
    return history, state
