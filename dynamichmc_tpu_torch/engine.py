"""Staged warmup + sampling, single device (port of the batch-native and
per-chain drivers of ``dynamichmc_tpu.engine``).

The JAX engine compiles the whole warmup into one program and chunks it
into dispatches that stay under the TPU runtime's watchdog. PyTorch runs
eagerly, so here the same schedule is a Python loop over the global step
index: block boundaries (dual-averaging restart, metric re-estimate,
Welford reset) happen between two transitions, with the same semantics.

One loop serves both chain layouts. A :class:`ChainOps` names the
transition, the stepsize search and the Welford fold: ``batched_ops`` for a
(C, K) chain batch (run_chains), ``PER_CHAIN`` for one (K,) chain
(mcmc_with_warmup).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .errors import DynamicHMCError
from .hamiltonian import EvaluatedPoint, PhasePoint
from .logdensity import LogDensity
from .metric import DiagonalMetric, Metric, dense_metric, rand_p
from .nuts import NUTS, TreeStatistics, sample_tree
from .stepsize import (
    InitialStepsizeSearch,
    find_initial_stepsize,
    local_log_acceptance_ratio,
)
from .tree_batched import _Edge, _joint_b, _leapfrog_b, rand_p_b, sample_tree_batched
from .utils.welford import (
    welford_update,
    welford_update_b,
    welford_update_pooled_b,
    welford_zero,
    welford_zero_shared,
)
from .warmup import TuningNUTS, WarmupStage, estimate_metric


@dataclasses.dataclass(frozen=True)
class WarmupSchedule:
    """A normalized schedule: optional search + homogeneous tuning blocks.

    ``depth_clamp`` caps tree doublings during every block except the last
    (early trees on an unadapted metric hit max depth and pin the lockstep
    batch); ``depth_clamp_tail`` extends the clamp that many steps into
    the final block. Any cap is a valid NUTS kernel; only the adaptation
    trajectory changes, and sampling is never clamped.
    """

    search: Optional[InitialStepsizeSearch]
    block_sizes: Tuple[int, ...]
    update_metric: Tuple[bool, ...]
    metric_kind: str
    shrinkages: Tuple[float, ...]
    adaptation: object
    pooled: bool
    depth_clamp: Optional[int] = None
    depth_clamp_tail: int = 0

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
        while bool((~found).any()) and it < params.maxiter_crossing:
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


def promote_metric(metric: Metric, kind: str) -> Metric:
    """Promote a diagonal initial metric to the dense representation when
    the schedule adapts a dense one (numerically a no-op)."""
    if kind != "dense" or not isinstance(metric, DiagonalMetric):
        return metric
    return dense_metric(torch.diag_embed(metric.m_inv))


def run_warmup(generator, ld: LogDensity, algorithm: NUTS,
               schedule: WarmupSchedule, Q: EvaluatedPoint, metric, eps,
               log=None, ops: Optional[ChainOps] = None):
    """The whole tuning schedule as one loop over the global step index,
    for the chain layout ``ops`` (default: a batch, pooled as the schedule
    says). Returns (Q', metric', eps')."""
    if ops is None:
        ops = batched_ops(schedule.pooled)
    adaptation = schedule.adaptation
    kind = schedule.metric_kind
    cums = []
    acc = 0
    for s in schedule.block_sizes:
        acc += s
        cums.append(acc)
    total = cums[-1]
    clamp = schedule.depth_clamp
    clamp_until = cums[-2] if len(cums) > 1 else 0
    if clamp is not None and schedule.depth_clamp_tail:
        # clamp the head of the final block too (the dual-averaging restart
        # transient); never the whole block
        clamp_until = min(clamp_until + int(schedule.depth_clamp_tail),
                          total - 1)
    block_of = []
    for b, n in enumerate(schedule.block_sizes):
        block_of += [b] * n

    dense = kind == "dense"
    metric = promote_metric(metric, kind)
    da = adaptation.init(eps)
    wf = ops.welford_zero(Q.q, dense)
    eps_run = adaptation.current(da)
    for i in range(total):
        b = block_of[i]
        dl = None
        if clamp is not None:
            dl = clamp if i < clamp_until else algorithm.max_depth
        Q, stats = ops.transition(
            generator, algorithm, ld, metric, Q, adaptation.current(da),
            depth_limit=dl,
        )
        da = adaptation.update(da, stats.acceptance_rate)
        if schedule.update_metric[b]:
            wf = ops.welford_update(wf, Q.q)
        if i + 1 == cums[b]:  # block boundary
            eps_run = adaptation.final(da)
            da = adaptation.init(eps_run)
            if schedule.update_metric[b]:
                metric = estimate_metric(wf, kind, schedule.shrinkages[b])
                wf = ops.welford_zero(Q.q, dense)
            if log is not None:
                log(f"warmup block {b + 1}/{len(cums)} done ({i + 1} steps)")
    return Q, metric, eps_run


def stack_statistics(per_draw) -> TreeStatistics:
    """Per-draw statistics -> one TreeStatistics with the draws on the last
    axis: (C, N) fields from a batch, (N,) from one chain."""
    fields = [f.name for f in dataclasses.fields(TreeStatistics)]
    return TreeStatistics(**{
        name: (None if getattr(per_draw[0], name) is None else
               torch.stack([getattr(s, name) for s in per_draw], dim=-1))
        for name in fields
    })


def run_sampling(generator, ld: LogDensity, algorithm: NUTS,
                 Q: EvaluatedPoint, metric, eps, n_samples: int,
                 ops: Optional[ChainOps] = None):
    """n_samples transitions at fixed (metric, eps). Returns (Q', positions
    (C, N, K) or (N, K), logdensities (C, N) or (N,), stats)."""
    if ops is None:
        ops = batched_ops(False)
    K = Q.q.shape[-1]
    lead = tuple(Q.q.shape[:-1])
    positions = torch.empty(lead + (n_samples, K), dtype=Q.q.dtype,
                            device=Q.q.device)
    lds = torch.empty(lead + (n_samples,), dtype=Q.q.dtype, device=Q.q.device)
    per_draw = []
    for j in range(n_samples):
        Q, stats = ops.transition(generator, algorithm, ld, metric, Q, eps,
                                  depth_limit=None)
        positions[..., j, :] = Q.q
        lds[..., j] = Q.logdensity
        per_draw.append(stats)
    return Q, positions, lds, stack_statistics(per_draw)


def execute(generator, ld: LogDensity, algorithm: NUTS,
            schedule: WarmupSchedule, Q: EvaluatedPoint, metric, eps,
            n_samples: int, log=None, ops: Optional[ChainOps] = None):
    """Search (if scheduled), warmup, then sampling, for the chain layout
    ``ops`` (default: a batch). Returns (metric, eps, search_results,
    (Q, positions, lds, stats))."""
    if ops is None:
        ops = batched_ops(schedule.pooled)
    search_results = None
    if schedule.search is not None:
        if eps is not None:
            raise DynamicHMCError(
                "stepsize eps manually specified, won't perform initial search"
            )
        eps, success, l0 = ops.make_search(ld, schedule.search)(
            generator, Q, metric
        )
        search_results = {"eps": eps, "success": success, "l0": l0}
    elif eps is None:
        raise DynamicHMCError("no stepsize: provide eps or a search stage")
    Q, metric, eps = run_warmup(
        generator, ld, algorithm, schedule, Q, metric, eps, log=log, ops=ops
    )
    inference = run_sampling(generator, ld, algorithm, Q, metric, eps,
                             n_samples, ops=ops)
    return metric, eps, search_results, inference

