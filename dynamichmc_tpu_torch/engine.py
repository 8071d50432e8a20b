"""Warmup blocks and sampling, single device (port of the batch-native and
per-chain drivers of ``dynamichmc_tpu.engine``).

The JAX engine compiles the whole warmup into one program and chunks it
into dispatches that stay under the TPU runtime's watchdog. PyTorch runs
eagerly, so here a warmup is the stage fold of warmup.py, whose TuningNUTS
stages each run :func:`run_block`, a Python loop over the block's
transitions; block boundaries (dual-averaging restart, metric re-estimate,
Welford reset) fall between two transitions, with the same semantics.

One loop serves every chain layout. A :class:`ChainOps` names the
transition, the stepsize search and the Welford fold: ``batched_ops`` for a
(C, K) chain batch (run_chains), ``PER_CHAIN`` for one (K,) chain
(mcmc_with_warmup), and ``looped_ops`` for a (C, K) batch whose algorithm
has a custom turn statistic, which the batch driver does not take: the
generic per-chain driver looped over the chains. :func:`chain_ops` picks
one.

Two optional hooks ride on the loop without changing what it computes or
draws: collection of each step's position, log density, tree statistics
and stepsize (keep-warmup), and a step reporter whose ``report_step`` is
called once per transition (reporting.py).

Sampling (:func:`run_sampling`) runs in chunks of draws: a chunk boundary
is where a draw sink takes the chunk off the device (io.py) and where the
sample-until-converged check reads the draws' ESS; the draws and the
random stream are the same for every chunk size. A warmup stops and
resumes at a stage boundary through a :class:`WarmupCheckpoint`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .hamiltonian import EvaluatedPoint, PhasePoint
from .logdensity import LogDensity
from .metric import (
    DiagonalMetric,
    Metric,
    dense_metric,
    metric_is_batched,
    rand_p,
)
from .nuts import NUTS, TreeStatistics, sample_tree
from .profiling import count_transition, host_bool, host_read, span, spanned
from .stepsize import (
    InitialStepsizeSearch,
    PooledStepsize,
    find_initial_stepsize,
    local_log_acceptance_ratio,
)
from .tree_batched import _Edge, _joint_b, _leapfrog_b, rand_p_b, sample_tree_batched
from .utils.welford import (
    pool_welford_over_group,
    welford_update,
    welford_update_b,
    welford_update_pooled_b,
    welford_zero,
    welford_zero_shared,
)
from .warmup import TuningNUTS, WarmupStage, estimate_metric


@dataclasses.dataclass(frozen=True)
class WarmupSchedule:
    """A normalized schedule: optional search + homogeneous tuning blocks,
    what the JAX package's engine compiles whole. The port runs every stage
    tuple through the stage fold (warmup.run_warmup); ``run_chains`` takes
    a warmup depth clamp only with a stage tuple of this form, as the JAX
    package does."""

    search: Optional[InitialStepsizeSearch]
    block_sizes: Tuple[int, ...]
    update_metric: Tuple[bool, ...]
    metric_kind: str
    shrinkages: Tuple[float, ...]
    adaptation: object
    pooled: bool

    @staticmethod
    def from_stages(stages: Tuple[WarmupStage, ...]
                    ) -> Optional["WarmupSchedule"]:
        """Normalize a stage tuple; None if not expressible."""
        stages = tuple(s for s in stages if s is not None)
        search = None
        idx = 0
        if stages and isinstance(stages[0], InitialStepsizeSearch):
            search = stages[0]
            idx = 1
        blocks = stages[idx:]
        if not blocks or not all(isinstance(s, TuningNUTS) for s in blocks):
            return None
        kinds = {s.metric_kind for s in blocks if s.metric_kind != "none"}
        adaptations = {s.stepsize_adaptation for s in blocks}
        pooled_flags = {s.pooled for s in blocks if s.metric_kind != "none"}
        if len(kinds) > 1 or len(adaptations) > 1 or len(pooled_flags) > 1:
            return None
        return WarmupSchedule(
            search=search,
            block_sizes=tuple(s.N for s in blocks),
            update_metric=tuple(s.metric_kind != "none" for s in blocks),
            metric_kind=next(iter(kinds)) if kinds else "none",
            shrinkages=tuple(s.shrinkage for s in blocks),
            adaptation=next(iter(adaptations)),
            pooled=next(iter(pooled_flags)) if pooled_flags else False,
        )


@dataclasses.dataclass(frozen=True)
class WarmupCheckpoint:
    """Warmup state at a stage boundary, from which
    ``run_chains(..., warmup_resume=checkpoint)`` continues the run with
    the draws, eps and metric of the uninterrupted one, bit for bit.

    The port runs warmup eagerly, one stage at a time, so a checkpoint
    falls after the stepsize search (``step`` 0) and after each TuningNUTS
    stage. The dual-averaging and Welford states restart at every stage
    (``run_block``), so the JAX checkpoint's ``da``, ``wf``, ``eps_run``
    and ``totals`` have nothing to carry here; the generator's state takes
    the place of the JAX key. Valid only for the (model, stage tuple,
    chain count, seed) it was taken from. The tensors are the fold's own
    state, which no later step writes. Persist with
    :func:`dynamichmc_tpu_torch.checkpoint.save_state`.

    step: the next absolute warmup step (TuningNUTS steps before ``stage``).
    stage: the index in the stage tuple of the next stage to run.
    search: ``{eps, success, l0}`` of the stepsize search, or None.
    generator_state: ``generator.get_state()`` at the boundary.
    """

    step: int
    stage: int
    Q: EvaluatedPoint
    metric: Metric
    eps: Optional[torch.Tensor]
    search: Optional[dict]
    generator_state: torch.Tensor


def make_search_driver_batched(ld: LogDensity, params: InitialStepsizeSearch):
    """(generator, Q, metric[, p]) -> (eps (C,), success (C,), l0 (C,)):
    the bracketing search of every chain at once; ``l0`` feeds the
    host-side non-finite-start check. ``p`` injects the momenta (tests)."""

    def search(generator, Q: EvaluatedPoint, metric: Metric, p=None):
        c, k = Q.q.shape
        dtype, device = Q.q.dtype, Q.q.device
        if p is None:
            p = rand_p_b(generator, metric, (c, k), dtype)
        z = _Edge(q=Q.q, p=p, grad=Q.grad, ld=Q.logdensity)
        l0 = _joint_b(metric, z.ld, z.p)

        def A(eps):
            z1 = _leapfrog_b(ld, metric, z, eps)
            return _joint_b(metric, z1.ld, z1.p) - l0

        thr = params.log_threshold
        eps = torch.full((c,), params.initial_eps, dtype=dtype, device=device)
        double = A(eps) > thr
        found = torch.zeros((c,), dtype=torch.bool, device=device)
        it = 0
        while (host_bool("search_loop", (~found).any())
               and it < params.maxiter_crossing):
            eps_new = torch.where(double, eps * 2, eps / 2)
            eps_new = torch.where(found, eps, eps_new)
            a_new = A(eps_new)
            crossed = torch.where(double, a_new < thr, a_new > thr) & ~found
            eps, found, it = eps_new, found | crossed, it + 1
        return eps, found, l0

    return search


def make_search_driver(ld: LogDensity, params: InitialStepsizeSearch):
    """(generator, Q, metric[, p]) -> (eps, success, l0) for one chain (JAX
    ``engine.make_search_driver``); ``p`` injects the momentum (tests)."""

    def search(generator, Q: EvaluatedPoint, metric: Metric, p=None):
        if p is None:
            p = rand_p(generator, metric, dtype=Q.q.dtype)
        A, l0 = local_log_acceptance_ratio(ld, metric, PhasePoint(Q=Q, p=p))
        eps, success = find_initial_stepsize(params, A, dtype=Q.q.dtype,
                                             device=Q.q.device)
        return eps, success, l0

    return search


class ChainOps(NamedTuple):
    """What the schedule loop needs from a chain layout.

    transition(generator, algorithm, ld, metric, Q, eps, depth_limit)
        -> (Q', TreeStatistics)
    make_search(ld, InitialStepsizeSearch) -> search(generator, Q, metric)
        -> (eps, success, l0)
    welford_zero(q, dense) -> WelfordState; welford_update(state, q) -> state
    """

    transition: Callable
    make_search: Callable
    welford_zero: Callable
    welford_update: Callable


def _shared_welford_zero(q, dense: bool):
    return welford_zero_shared(q.shape[-1], dense, q.dtype, q.device)


def batched_ops(pooled: bool) -> ChainOps:
    """A (C, K) chain batch: per-chain Welford moments, or one pooled over
    the batch."""
    return ChainOps(
        transition=sample_tree_batched,
        make_search=make_search_driver_batched,
        welford_zero=_shared_welford_zero if pooled else welford_zero,
        welford_update=welford_update_pooled_b if pooled else welford_update_b,
    )


def _per_chain_transition(generator, algorithm, ld, metric, Q, eps,
                          depth_limit=None):
    if depth_limit is not None:
        raise ValueError("the per-chain driver has no warmup depth clamp")
    return sample_tree(generator, algorithm, ld, metric, Q, eps)


PER_CHAIN = ChainOps(
    transition=_per_chain_transition,
    make_search=make_search_driver,
    welford_zero=_shared_welford_zero,
    welford_update=welford_update,
)
"""One (K,) chain through the per-chain fast driver (nuts.sample_tree)."""


def chain_metric(metric: Metric, c: int) -> Metric:
    """Chain ``c``'s metric: a copy of its row of a per-chain metric (a
    matrix product's rounding can depend on where its operand lies, so the
    row does not stay a view into the batch), else the shared one."""
    if not metric_is_batched(metric):
        return metric
    return dataclasses.replace(metric, **{
        f.name: (None if getattr(metric, f.name) is None
                 else getattr(metric, f.name)[c].clone())
        for f in dataclasses.fields(metric)})


def _chain_point(Q: EvaluatedPoint, c: int) -> EvaluatedPoint:
    return EvaluatedPoint(q=Q.q[c], logdensity=Q.logdensity[c],
                          grad=Q.grad[c])


def _stack_points(points) -> EvaluatedPoint:
    return EvaluatedPoint(q=torch.stack([P.q for P in points]),
                          logdensity=torch.stack([P.logdensity
                                                  for P in points]),
                          grad=torch.stack([P.grad for P in points]))


def _looped_transition(generator, algorithm, ld, metric, Q, eps,
                       depth_limit=None, p=None, directions=None):
    """The generic driver (``nuts.sample_tree(fast=False)``, with the
    algorithm's turn statistic) for chain 0, 1, ..., C-1 of a (C, K)
    batch, in that order, each with its metric row and its eps; ``p``
    (C, K) and ``directions`` (C,) inject the momenta and direction bits
    (tests)."""
    if depth_limit is not None:
        raise ValueError("the looped generic driver has no warmup depth "
                         "clamp")
    C = Q.q.shape[0]
    if not torch.is_tensor(eps):
        eps = torch.as_tensor(eps, dtype=Q.q.dtype, device=Q.q.device)
    eps = eps.expand(C)
    out = [sample_tree(generator, algorithm, ld, chain_metric(metric, c),
                       _chain_point(Q, c), eps[c],
                       p=None if p is None else p[c],
                       directions=None if directions is None
                       else directions[c], fast=False)
           for c in range(C)]
    return (_stack_points([point for point, _s in out]),
            stack_statistics([s for _point, s in out]))


def make_search_driver_looped(ld: LogDensity, params: InitialStepsizeSearch):
    """(generator, Q, metric[, p]) -> (eps (C,), success (C,), l0 (C,)):
    the per-chain search (:func:`make_search_driver`) for chain 0, 1, ...,
    C-1 of a (C, K) batch, in that order, as the JAX package vmaps it for
    a custom turn statistic; ``p`` (C, K) injects the momenta (tests)."""
    single = make_search_driver(ld, params)

    def search(generator, Q: EvaluatedPoint, metric: Metric, p=None):
        out = [single(generator, _chain_point(Q, c), chain_metric(metric, c),
                      None if p is None else p[c])
               for c in range(Q.q.shape[0])]
        return tuple(torch.stack(x) for x in zip(*out))

    return search


def looped_ops(pooled: bool) -> ChainOps:
    """A (C, K) chain batch through the generic per-chain driver, chain by
    chain, every random number from the run's one generator in chain
    order: the batch layout for a custom turn statistic, the counterpart
    in law of the JAX package's vmapped generic driver (one key per
    chain), not in speed. The generic driver costs about 1.24-1.30 ms of
    host time a leapfrog on an H100 machine (PERF.md), and the loop
    pays it C times a leaf: a transition of C chains costs C times one
    chain's. Welford moments per chain, or one pooled over the batch."""
    return ChainOps(
        transition=_looped_transition,
        make_search=make_search_driver_looped,
        welford_zero=_shared_welford_zero if pooled else welford_zero,
        welford_update=welford_update_pooled_b if pooled else welford_update_b,
    )


def chain_ops(algorithm: NUTS, batched: bool, pooled: bool = False
              ) -> ChainOps:
    """The ops of a chain layout: ``PER_CHAIN`` for one (K,) chain; for a
    (C, K) batch ``batched_ops``, or ``looped_ops`` when the algorithm has
    a custom turn statistic, which the batch driver does not take."""
    if not batched:
        return PER_CHAIN
    if algorithm.turn_statistic_configuration != "generalized":
        return looped_ops(pooled)
    return batched_ops(pooled)


def promote_metric(metric: Metric, kind: str) -> Metric:
    """Promote a diagonal initial metric to the dense representation when
    the schedule adapts a dense one (numerically a no-op)."""
    if kind != "dense" or not isinstance(metric, DiagonalMetric):
        return metric
    return dense_metric(torch.diag_embed(metric.m_inv))


class _Trace:
    """Each step's draw of one block: positions (optional), log densities,
    tree statistics and (optional) stepsizes, with the steps on the axis
    after the chain axis: (C, N, K) / (C, N) from a batch, (N, K) / (N,)
    from one chain."""

    def __init__(self, Q: EvaluatedPoint, n: int, positions: bool = True,
                 epss: bool = False):
        lead, K = tuple(Q.q.shape[:-1]), Q.q.shape[-1]
        like = dict(dtype=Q.q.dtype, device=Q.q.device)
        self.positions = (torch.empty(lead + (n, K), **like) if positions
                          else None)
        self.lds = torch.empty(lead + (n,), **like)
        self.epss = [] if epss else None
        self.per_draw = []
        self.lead, self.like = lead, like

    def add(self, j: int, Q: EvaluatedPoint, stats: TreeStatistics, eps=None):
        if self.positions is not None:
            self.positions[..., j, :] = Q.q
        self.lds[..., j] = Q.logdensity
        self.per_draw.append(stats)
        if self.epss is not None:
            self.epss.append(eps)

    def statistics(self) -> TreeStatistics:
        return stack_statistics(self.per_draw, self.lead, **self.like)

    def results(self) -> dict:
        """A warmup block's results: logdensities, tree_statistics, epss
        and, when collected, positions."""
        out = {"logdensities": self.lds, "tree_statistics": self.statistics(),
               "epss": torch.stack(self.epss, dim=-1)}
        if self.positions is not None:
            out["positions"] = self.positions
        return out


def run_block(generator, ld: LogDensity, algorithm: NUTS, stage: TuningNUTS,
              Q: EvaluatedPoint, metric, eps, ops: ChainOps,
              collect: bool = False, collect_positions: bool = False,
              reporter=None, depth_clamp: Optional[int] = None,
              clamp_steps: int = 0, mesh=None):
    """One TuningNUTS block for the chain layout ``ops``: ``stage.N``
    transitions under the stage's stepsize adaptation, started from
    ``eps``, with the Welford fold and the metric re-estimate at the end
    when the stage adapts a metric. Returns (Q', metric', eps', results).

    ``collect``: ``results`` holds each step's logdensities,
    tree_statistics, epss and, with ``collect_positions``, positions (else
    None). ``reporter``: a step reporter (reporting.py), told of every
    transition with its stepsize. ``depth_clamp``: cap the tree doublings
    of the first ``clamp_steps`` transitions; the rest then run at
    ``algorithm.max_depth``. ``mesh`` (a ``parallel.mesh.ChainMesh``): a
    pooled stage's moments are pooled over the ranks before the metric
    estimate (a per-chain stage needs no collective); a pooled stepsize
    carries the mesh in the stage's adaptation."""
    adaptation = stage.stepsize_adaptation
    kind = stage.metric_kind
    update = kind != "none"
    metric = promote_metric(metric, kind)
    da = adaptation.init(eps)
    wf = ops.welford_zero(Q.q, kind == "dense")
    trace = (_Trace(Q, stage.N, collect_positions, epss=True) if collect
             else None)
    stage_reporter = None
    if reporter is not None:
        tuning = f"stepsize and {kind} metric" if update else "stepsize"
        stage_reporter = reporter.make_stage_reporter(
            stage.N, currently_warmup=True, tuning=tuning)
    for j in range(stage.N):
        with span("dhmc.transition"):
            dl = None
            if depth_clamp is not None:
                dl = depth_clamp if j < clamp_steps else algorithm.max_depth
            eps_now = adaptation.current(da)
            Q, stats = ops.transition(
                generator, algorithm, ld, metric, Q, eps_now, depth_limit=dl,
            )
            count_transition("warmup", stats.steps)
            with span("dhmc.adapt"):
                if trace is not None:
                    trace.add(j, Q, stats, eps_now)
                if stage_reporter is not None:
                    stage_reporter.report_step(j, eps=eps_now)
                da = adaptation.update(da, stats.acceptance_rate)
                if update:
                    wf = ops.welford_update(wf, Q.q)
    with span("dhmc.estimate"):
        eps = adaptation.final(da)
        if update:
            if stage.pooled:
                wf = pool_welford_over_group(wf, mesh)
            metric = estimate_metric(wf, kind, stage.shrinkage)
    return Q, metric, eps, None if trace is None else trace.results()


def run_block_wavefront(generator, ld: LogDensity, algorithm: NUTS,
                        stage: TuningNUTS, Q: EvaluatedPoint, metric, eps,
                        depth_clamp: Optional[int] = None,
                        clamp_steps: int = 0, mesh=None):
    """One TuningNUTS block of a (C, K) batch through the aligned
    wavefront (tree_wavefront.py), with :func:`run_block`'s semantics:
    every lane completes ``stage.N`` transitions under the stage's
    stepsize adaptation, its Welford moments folded at each completion,
    and the metric re-estimated at the end (pooled over the ranks of
    ``mesh`` for a pooled stage). ``depth_clamp`` caps the doublings of
    each lane's first ``clamp_steps`` transitions. Returns (Q', metric',
    eps')."""
    from .tree_wavefront import make_wavefront_stage_driver, wavefront_init

    adaptation = stage.stepsize_adaptation
    kind = stage.metric_kind
    update = kind != "none"
    metric = promote_metric(metric, kind)
    pooled_eps = isinstance(adaptation, PooledStepsize)
    da = adaptation.init(eps)  # a pooled eps starts from every rank's chains
    wf = batched_ops(stage.pooled).welford_zero(Q.q, kind == "dense")
    driver = make_wavefront_stage_driver(
        ld, algorithm,
        # the driver pools the acceptance accumulators over the mesh itself
        dataclasses.replace(adaptation, mesh=None) if pooled_eps
        else adaptation,
        pooled_welford=stage.pooled, use_welford=update,
        pooled_eps=pooled_eps, mesh=mesh)
    carry = wavefront_init(Q, metric, da, wf, algorithm.max_depth)
    carry, _done = driver(
        generator, metric, carry, stage.N, depth_limit=depth_clamp,
        tail_steps=clamp_steps if depth_clamp is not None else None)
    count_transition("warmup", n=stage.N)
    with span("dhmc.estimate"):
        eps = adaptation.final(carry["da"])
        if update:
            wf = carry["wf"]
            if stage.pooled:
                wf = pool_welford_over_group(wf, mesh)
            metric = estimate_metric(wf, kind, stage.shrinkage)
    return carry["Q"], metric, eps


def stack_statistics(per_draw, lead=(), dtype=torch.float32,
                     device=None) -> TreeStatistics:
    """Per-draw statistics -> one TreeStatistics with the draws on the last
    axis: (C, N) fields from a batch, (N,) from one chain. No draws give
    empty (lead + (0,)) fields of the drivers' dtypes; ``work`` is None for
    one chain, as the per-chain driver records none."""
    fields = [f.name for f in dataclasses.fields(TreeStatistics)]
    if not per_draw:
        shape = tuple(lead) + (0,)
        floats = ("logdensity", "acceptance_rate")
        return TreeStatistics(**{
            name: (None if name == "work" and not lead else torch.empty(
                shape, dtype=dtype if name in floats else torch.int32,
                device=device))
            for name in fields
        })
    return TreeStatistics(**{
        name: (None if getattr(per_draw[0], name) is None else
               torch.stack([getattr(s, name) for s in per_draw], dim=-1))
        for name in fields
    })


@spanned("dhmc.draws")
def run_sampling(generator, ld: LogDensity, algorithm: NUTS,
                 Q: EvaluatedPoint, metric, eps, n_samples: int,
                 ops: Optional[ChainOps] = None, reporter=None,
                 sample_chunk: Optional[int] = None, draw_sink=None,
                 ess_target: Optional[float] = None, ess_check_start: int = 0,
                 ess_check_factor: float = 2.0, log=None, mesh=None,
                 sampling_driver: str = "sync", epoch_ring: int = 8,
                 stratify_sampling: int = 0):
    """n_samples transitions at fixed (metric, eps), in chunks of
    ``sample_chunk`` draws (None: one chunk). Returns (Q', positions
    (C, N, K) or (N, K), logdensities (C, N) or (N,), stats). ``ops``: the
    chain layout (None: :func:`chain_ops` of the algorithm and of ``Q``'s
    shape). ``reporter``: a step reporter, told of every draw; ``log``
    receives a line per chunk.

    ``draw_sink(start, positions, logdensities, tree_statistics)`` takes
    each chunk (``start`` its first draw), and its draws leave the device:
    positions and logdensities are then None, the statistics stay.

    ``ess_target``: after a chunk boundary at ``done >= next check`` (and
    ``done < n_samples``), the min over coordinates of the draws' pooled
    bulk ESS (stats_device, on the device); sampling stops once it reaches
    the target, and the result holds the ``done`` draws taken. The first
    check is at ``ess_check_start`` draws (0: ``max(sample_chunk, 64)``),
    the next at ``max(done + 1, int(done * ess_check_factor))``.

    The chunks decide only where the sink is called and the ESS read: the
    draws and the random stream are the same for every chunk size.

    ``mesh`` (a ``parallel.mesh.ChainMesh``): the batch is this rank's
    chains, and the ESS at a check is over every rank's draws, computed on
    rank 0 and broadcast, so that every rank stops at the same chunk.

    Two schedulers of a (C, K) batch, as in the JAX package:
    ``sampling_driver="epoch"`` takes every draw through the epoch
    wavefront (tree_wavefront_epoch.py; ``epoch_ring`` its ring; one
    ``draw_sink`` call with every draw; no ``ess_target``), and
    ``stratify_sampling=G`` with a per-chain eps sorts the chains by eps,
    then samples G groups of C/G one after the other, each with a stream
    of its own drawn from ``generator`` (group-serial,
    :func:`_sample_stratified`; no ``ess_target``); over a mesh, the
    sort is over every rank's chains and each rank samples one eps band
    (:func:`_sample_band`). The draws come back in the caller's order."""
    if ops is None:
        ops = chain_ops(algorithm, Q.q.ndim == 2)
    per_chain_eps = torch.is_tensor(eps) and eps.ndim == 1
    if sampling_driver == "epoch" and Q.q.ndim == 2:
        return _sample_epoch(generator, ld, algorithm, Q, metric, eps,
                             n_samples, epoch_ring, draw_sink, log)
    if stratify_sampling and per_chain_eps and mesh is not None:
        return _sample_band(
            generator, ld, algorithm, Q, metric, eps, n_samples, mesh,
            ops=ops, reporter=reporter, sample_chunk=sample_chunk,
            draw_sink=draw_sink, ess_target=ess_target,
            ess_check_start=ess_check_start,
            ess_check_factor=ess_check_factor, log=log)
    if stratify_sampling > 1 and per_chain_eps and mesh is None:
        return _sample_stratified(generator, ld, algorithm, Q, metric, eps,
                                  n_samples, ops, int(stratify_sampling),
                                  sample_chunk, draw_sink, reporter, log)
    chunk = n_samples if sample_chunk is None else int(sample_chunk)
    if chunk < 1 and n_samples > 0:
        raise ValueError("sample_chunk must be >= 1")
    # without a sink every draw goes into one buffer; with one, each chunk
    # gets its own, dropped once the sink returns
    trace = _Trace(Q, n_samples) if draw_sink is None else None
    per_draw = []
    stage_reporter = (None if reporter is None else
                      reporter.make_stage_reporter(n_samples,
                                                   currently_warmup=False))
    next_check = None
    if ess_target is not None:
        next_check = (int(ess_check_start) if ess_check_start > 0
                      else max(chunk, 64))
    done, t0 = 0, time.perf_counter()
    while done < n_samples:
        m = min(chunk, n_samples - done)
        part, offset = ((trace, done) if trace is not None
                        else (_Trace(Q, m), 0))
        for j in range(m):
            with span("dhmc.transition"):
                Q, stats = ops.transition(generator, algorithm, ld, metric, Q,
                                          eps, depth_limit=None)
                count_transition("draws", stats.steps)
                with span("dhmc.adapt"):
                    part.add(offset + j, Q, stats)
                if stage_reporter is not None:
                    stage_reporter.report_step(done + j)
        with span("dhmc.sink"):
            if draw_sink is not None:
                draw_sink(done, part.positions, part.lds, part.statistics())
                per_draw += part.per_draw
            done += m
            if log is not None:
                _synchronize(Q.q, "sampling_log")
                elapsed = time.perf_counter() - t0
                eta = (n_samples - done) * elapsed / max(done, 1)
                log(f"sampling: {done}/{n_samples} ({elapsed:.1f}s, "
                    f"{done / max(elapsed, 1e-9):.1f} draws/s, "
                    f"~{eta:.1f}s left)")
            if next_check is not None and next_check <= done < n_samples:
                host_read("ess_check")
                min_ess = float(_min_bulk_ess(trace.positions[..., :done, :],
                                              mesh))
                if log is not None:
                    log(f"ess check @ {done} draws: min bulk ESS "
                        f"{min_ess:.0f} (target {ess_target:g})")
                if min_ess >= ess_target:
                    break
                next_check = max(done + 1, int(done * ess_check_factor))
    if trace is None:
        return Q, None, None, stack_statistics(per_draw, tuple(Q.q.shape[:-1]),
                                               dtype=Q.q.dtype,
                                               device=Q.q.device)
    return (Q, trace.positions[..., :done, :], trace.lds[..., :done],
            trace.statistics())


def _sample_epoch(generator, ld, algorithm, Q, metric, eps, n_samples,
                  ring, draw_sink, log):
    """Every draw through the epoch wavefront; one ``draw_sink`` call."""
    from .tree_wavefront_epoch import (epoch_sampling_finish,
                                       epoch_sampling_init,
                                       make_epoch_sampling_driver)

    t0 = time.perf_counter()
    stage = make_epoch_sampling_driver(ld, algorithm, n_samples, ring=ring)
    carry = epoch_sampling_init(Q, metric, n_samples, algorithm.max_depth,
                                ring=ring)
    carry, _done = stage(generator, metric, eps, carry)
    count_transition("draws", n=n_samples)
    Q, positions, lds, stats = epoch_sampling_finish(carry, n_samples)
    if log is not None:
        _synchronize(Q.q, "epoch_log")
        log(f"sampling[epoch]: {n_samples} draws in {carry['g']} slots "
            f"({time.perf_counter() - t0:.1f}s)")
    if draw_sink is not None:
        draw_sink(0, positions, lds, stats)
        return Q, None, None, stats
    return Q, positions, lds, stats


def _take_chains(x, index):
    """Rows ``index`` of a (C, ...) tensor, EvaluatedPoint or per-chain
    metric."""
    if torch.is_tensor(x):
        return x[index]
    return dataclasses.replace(x, **{
        f.name: (None if getattr(x, f.name) is None
                 else getattr(x, f.name)[index])
        for f in dataclasses.fields(x)})


def _sample_stratified(generator, ld, algorithm, Q, metric, eps, n_samples,
                       ops, G, sample_chunk, draw_sink, reporter, log):
    """Group-serial stratified sampling: the chains sorted by eps, G groups
    of C/G, each chunk group by group, so that a group's lockstep loop ends
    with its own deepest tree. Each group draws from its own generator,
    seeded from ``generator``, so the draws are the same for every chunk
    size; positions, log densities and statistics are written in the
    caller's chain order."""
    C = Q.q.shape[0]
    if C % G:
        raise ValueError(f"n_chains={C} not divisible by "
                         f"stratify_sampling={G}")
    groups = torch.argsort(eps, stable=True).reshape(G, C // G)
    inverse = torch.argsort(groups.reshape(-1))
    device = Q.q.device
    host_read("stratified_seeds")
    seeds = torch.randint(0, 1 << 62, (G,), generator=generator,
                          device=generator.device).tolist()
    gens = [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]
    states = [_take_chains(Q, idx) for idx in groups]
    metrics = [_take_chains(metric, idx) if metric_is_batched(metric)
               else metric for idx in groups]
    group_eps = [eps[idx] for idx in groups]
    chunk = n_samples if sample_chunk is None else int(sample_chunk)
    trace = _Trace(Q, n_samples) if draw_sink is None else None
    per_draw = []
    stage_reporter = (None if reporter is None else
                      reporter.make_stage_reporter(n_samples,
                                                   currently_warmup=False))
    done, t0 = 0, time.perf_counter()
    while done < n_samples:
        m = min(chunk, n_samples - done)
        part, offset = ((trace, done) if trace is not None
                        else (_Trace(Q, m), 0))
        by_group = []
        for g, idx in enumerate(groups):
            Qg, stats_g = states[g], []
            for j in range(m):
                Qg, stats = ops.transition(gens[g], algorithm, ld, metrics[g],
                                           Qg, group_eps[g], depth_limit=None)
                count_transition("draws", stats.steps)
                part.positions[idx, offset + j] = Qg.q
                part.lds[idx, offset + j] = Qg.logdensity
                stats_g.append(stats)
            states[g] = Qg
            by_group.append(stats_g)
        for j in range(m):
            part.per_draw.append(TreeStatistics(**{
                f.name: (None if getattr(by_group[0][j], f.name) is None
                         else torch.cat([getattr(s[j], f.name)
                                         for s in by_group])[inverse])
                for f in dataclasses.fields(TreeStatistics)}))
            if stage_reporter is not None:
                stage_reporter.report_step(done + j)
        if draw_sink is not None:
            draw_sink(done, part.positions, part.lds, part.statistics())
            per_draw += part.per_draw
        done += m
        if log is not None:
            _synchronize(Q.q, "stratified_log")
            elapsed = time.perf_counter() - t0
            log(f"sampling[stratified x{G}]: {done}/{n_samples} "
                f"({elapsed:.1f}s, {done / max(elapsed, 1e-9):.1f} draws/s)")
    Q = EvaluatedPoint(*(torch.cat([getattr(P, name) for P in states])[inverse]
                         for name in ("q", "logdensity", "grad")))
    if trace is None:
        return Q, None, None, stack_statistics(per_draw, (C,), dtype=Q.q.dtype,
                                               device=device)
    return Q, trace.positions, trace.lds, trace.statistics()


def _sample_band(generator, ld, algorithm, Q, metric, eps, n_samples, mesh,
                 draw_sink=None, log=None, **sampling):
    """Stratified sampling over a mesh, a permutation only: every rank's
    chains sorted by eps, rank r samples the r-th band of C / size chains
    (so each rank's lockstep loop ends with its own band's deepest tree),
    and every chunk's draws go back to their chains' home ranks. Both
    moves are ``all_gather_chains``: the chains' states in, and per chunk
    every rank's band draws out, so each rank receives the global chunk
    (C x chunk x K values) to keep its own C / size chains."""
    from .parallel.mesh import all_gather_chains

    n_local = Q.q.shape[0]
    order = torch.argsort(all_gather_chains(eps, mesh), stable=True)
    mine = slice(mesh.rank * n_local, (mesh.rank + 1) * n_local)
    band, home = order[mine], torch.argsort(order)[mine]

    def to_band(x):
        return all_gather_chains(x, mesh)[band]

    def to_home(x):
        return None if x is None else all_gather_chains(x, mesh)[home]

    def stats_home(stats):
        return TreeStatistics(**{f.name: to_home(getattr(stats, f.name))
                                 for f in dataclasses.fields(TreeStatistics)})

    Qb = EvaluatedPoint(*(to_band(getattr(Q, name))
                          for name in ("q", "logdensity", "grad")))
    if metric_is_batched(metric):
        metric = dataclasses.replace(metric, **{
            f.name: to_band(getattr(metric, f.name))
            for f in dataclasses.fields(metric)})
    if log is not None:
        log("sampling: lanes eps-sorted (mesh stratification)")
    sink = None if draw_sink is None else (
        lambda start, qs, lds, stats: draw_sink(
            start, to_home(qs), to_home(lds), stats_home(stats)))
    Qb, positions, lds, stats = run_sampling(
        generator, ld, algorithm, Qb, metric, to_band(eps), n_samples,
        draw_sink=sink, log=log, mesh=mesh, **sampling)
    return (EvaluatedPoint(*(to_home(getattr(Qb, name))
                             for name in ("q", "logdensity", "grad"))),
            to_home(positions), to_home(lds), stats_home(stats))


def _min_bulk_ess(drawn: torch.Tensor, mesh) -> torch.Tensor:
    """The min over coordinates of the draws' pooled bulk ESS (0-d, on the
    draws' device); over a mesh, of every rank's chains, on every rank."""
    from .stats_device import ess_rhat_device

    if mesh is None:
        return ess_rhat_device(drawn)["ess_bulk"].min()
    from .parallel.mesh import all_gather_chains, broadcast_from

    drawn = all_gather_chains(drawn, mesh)
    if mesh.rank == 0:
        value = ess_rhat_device(drawn)["ess_bulk"].min()
    else:
        value = torch.empty((), dtype=torch.float64, device=drawn.device)
    return broadcast_from(value, mesh)


def _synchronize(x: torch.Tensor, site: str) -> None:
    """Wait for the device that holds ``x`` (a timed log line), counted as
    a host read at ``site``."""
    host_read(site)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def stepsize_message(eps) -> str:
    """The log line of a finished stepsize search (reads eps from the
    device): one chain's eps, or the range over a batch."""
    host_read("stepsize_message")
    eps = torch.as_tensor(eps).detach().cpu()
    if eps.numel() == 1:
        return f"found initial stepsize eps={float(eps):.4g}"
    return (f"found initial stepsizes eps in [{float(eps.min()):.4g}, "
            f"{float(eps.max()):.4g}]")
