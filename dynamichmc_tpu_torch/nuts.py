"""NUTS configuration, per-transition statistics and the per-chain
transition (port of ``dynamichmc_tpu.nuts``).

``sample_tree`` is one NUTS transition of one chain: the generalized U-turn
criterion with its three sub-checks, divergence at delta < min_delta,
biased progressive sampling. It runs the multinomial fast driver by
default and the generic progressive-merge driver (tree.py) with
``fast=False`` or a custom turn statistic (NUTS.jl:120-139).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .hamiltonian import (
    EvaluatedPoint,
    PhasePoint,
    calculate_psharp,
    joint_logdensity,
    leapfrog,
)
from .logdensity import LogDensity
from .metric import DiagonalMetric, Metric, rand_p
from .tree import (
    MAX_TREE_DEPTH_BOUND,
    FastTrajectoryOps,
    MergeNoise,
    TrajectoryOps,
    TreeNoise,
    biased_progressive_logprob2,
    exponential_like,
    gumbel_like,
    random_directions,
    sample_trajectory,
    sample_trajectory_fast,
)

DEFAULT_MAX_TREE_DEPTH = 10


@dataclasses.dataclass(frozen=True)
class NUTS:
    """Algorithm configuration (NUTS.jl:178-195): tree depth cap,
    divergence threshold and the turn statistic. ``"generalized"`` selects
    the built-in generalized U-turn statistic; an object with
    ``leaf(metric, z) -> tau`` and ``combine(metric, tau_x, tau_y) -> (tau,
    turning)`` runs the per-chain transition through the generic driver
    with that statistic (the batch driver takes only the default; a batch
    runs the generic driver looped over its chains, engine.looped_ops)."""

    max_depth: int = DEFAULT_MAX_TREE_DEPTH
    min_delta: float = -1000.0
    turn_statistic_configuration: object = "generalized"

    def __post_init__(self):
        if not 0 < self.max_depth <= MAX_TREE_DEPTH_BOUND:
            raise ValueError(f"max_depth must be in 1..{MAX_TREE_DEPTH_BOUND}")
        if not self.min_delta < 0:
            raise ValueError("min_delta must be negative")
        c = self.turn_statistic_configuration
        if c != "generalized" and not (
            hasattr(c, "leaf") and hasattr(c, "combine")
        ):
            raise ValueError(
                "turn_statistic_configuration must be 'generalized' or an "
                "object with leaf(metric, z) and combine(metric, x, y)"
            )


@dataclasses.dataclass
class GeneralizedTurnStatistic:
    """Edge momenta and velocities and the momentum sum rho
    (NUTS.jl:107-118)."""

    p_minus: torch.Tensor
    psharp_minus: torch.Tensor
    p_plus: torch.Tensor
    psharp_plus: torch.Tensor
    rho: torch.Tensor


def _is_turning(psharp_minus, psharp_plus, rho):
    """NUTS.jl:130."""
    return (torch.dot(psharp_minus, rho) < 0) | (torch.dot(psharp_plus, rho) < 0)


def _combine_turn_statistics(x: GeneralizedTurnStatistic,
                             y: GeneralizedTurnStatistic):
    """The three-way check of NUTS.jl:132-139; x precedes y in trajectory
    time. Returns (combined statistic, turning flag as a 0-d bool tensor)."""
    t1 = _is_turning(x.psharp_minus, y.psharp_minus, x.rho + y.p_minus)
    t2 = _is_turning(x.psharp_plus, y.psharp_plus, x.p_plus + y.rho)
    rho = x.rho + y.rho
    t3 = _is_turning(x.psharp_minus, y.psharp_plus, rho)
    combined = GeneralizedTurnStatistic(
        p_minus=x.p_minus,
        psharp_minus=x.psharp_minus,
        p_plus=y.p_plus,
        psharp_plus=y.psharp_plus,
        rho=rho,
    )
    return combined, t1 | t2 | t3


@dataclasses.dataclass
class AcceptanceStatistic:
    """log sum of Metropolis acceptance probabilities + leapfrog step count
    over all visited leaves, including invalid subtrees."""

    log_sum_alpha: torch.Tensor
    steps: torch.Tensor


def acceptance_rate(a: AcceptanceStatistic) -> torch.Tensor:
    steps = torch.clamp(a.steps, min=1)
    return torch.clamp(torch.exp(a.log_sum_alpha) / steps, max=1.0)


@dataclasses.dataclass
class TreeStatistics:
    """Per-transition diagnostics, one entry per chain.

    ``term_left``/``term_right`` encode the termination reason: (1, 0) =
    reached max depth; left == right = divergence at that position;
    left < right = turning over those positions. ``directions`` holds the
    uint32 direction bits as int32. ``work``: leaf slots executed — the
    whole batch's lockstep count from the plain driver, the chain's own
    count from the tree kernel (each chain leaves its loops when it ends).
    """

    logdensity: torch.Tensor  # joint log density at the proposal
    depth: torch.Tensor
    term_left: torch.Tensor
    term_right: torch.Tensor
    acceptance_rate: torch.Tensor
    steps: torch.Tensor
    directions: torch.Tensor
    work: Optional[torch.Tensor] = None

    @property
    def is_divergent(self):
        return self.term_left == self.term_right

    @property
    def reached_max_depth(self):
        return (self.term_left == 1) & (self.term_right == 0)

    @property
    def is_turning(self):
        return ~self.is_divergent & ~self.reached_max_depth


def combine_acceptance_statistics(a: AcceptanceStatistic,
                                  b: AcceptanceStatistic) -> AcceptanceStatistic:
    """NUTS.jl:69-71: log-sum-exp of the acceptance sums, steps added."""
    return AcceptanceStatistic(
        log_sum_alpha=torch.logaddexp(a.log_sum_alpha, b.log_sum_alpha),
        steps=a.steps + b.steps,
    )


def acceptance_identity(v: AcceptanceStatistic) -> AcceptanceStatistic:
    """The identity of :func:`combine_acceptance_statistics`."""
    return AcceptanceStatistic(
        log_sum_alpha=torch.full_like(v.log_sum_alpha, -torch.inf), steps=0)


def _leaf_acceptance(delta, is_initial: bool, min_delta: float):
    """(acceptance statistic, divergent) of one leaf given delta = pi - pi0;
    the initial leaf contributes nothing and is never divergent. ``steps``
    is a Python int (the per-chain driver keeps its counters on the host)."""
    if is_initial:
        return (AcceptanceStatistic(log_sum_alpha=delta.new_full((), -torch.inf),
                                    steps=0),
                torch.zeros((), dtype=torch.bool, device=delta.device))
    return (AcceptanceStatistic(log_sum_alpha=torch.clamp(delta, max=0.0),
                                steps=1),
            delta < min_delta)


def make_trajectory_ops(ld: LogDensity, metric: Metric, pi0, eps,
                        min_delta: float,
                        turn_statistic_configuration="generalized"
                        ) -> TrajectoryOps:
    """The generic driver's ops bundle for one transition of one chain
    (TrajectoryNUTS, NUTS.jl:15-53, 148-159). A non-default
    ``turn_statistic_configuration`` supplies the leaf/combine pair of the
    turn statistic (NUTS.jl:120-139). The proposal is the phase point."""
    custom = turn_statistic_configuration != "generalized"
    neg_eps = -eps

    def move(z: PhasePoint, is_forward: bool) -> PhasePoint:
        return leapfrog(ld, metric, z, eps if is_forward else neg_eps)

    def leaf(z: PhasePoint, is_initial: bool):
        delta = (torch.zeros_like(pi0) if is_initial
                 else joint_logdensity(metric, z) - pi0)
        v, divergent = _leaf_acceptance(delta, is_initial, min_delta)
        if custom:
            tau = turn_statistic_configuration.leaf(metric, z)
        else:
            psharp = calculate_psharp(metric, z)
            tau = GeneralizedTurnStatistic(
                p_minus=z.p, psharp_minus=psharp, p_plus=z.p,
                psharp_plus=psharp, rho=z.p,
            )
        return z, delta, tau, divergent, v

    def combine_turn(tau_x, tau_y):
        if custom:
            return turn_statistic_configuration.combine(metric, tau_x, tau_y)
        return _combine_turn_statistics(tau_x, tau_y)

    def combine_proposals(draw, z1: PhasePoint, z2: PhasePoint, logprob2,
                          is_forward: bool) -> PhasePoint:
        # accept z2 with probability exp(logprob2) through an
        # Exponential(1) draw, distributionally NUTS.jl:43-45
        accept = (logprob2 >= 0) | (draw > -logprob2)
        return PhasePoint(
            Q=EvaluatedPoint(
                q=torch.where(accept, z2.Q.q, z1.Q.q),
                logdensity=torch.where(accept, z2.Q.logdensity,
                                       z1.Q.logdensity),
                grad=torch.where(accept, z2.Q.grad, z1.Q.grad),
            ),
            p=torch.where(accept, z2.p, z1.p),
        )

    return TrajectoryOps(
        move=move,
        leaf=leaf,
        combine_turn=combine_turn,
        calculate_logprob2=biased_progressive_logprob2,
        combine_proposals=combine_proposals,
        combine_visited=combine_acceptance_statistics,
        visited_identity=acceptance_identity,
    )


class CompactTurnStatistic:
    """The fast driver's turn statistic: one (3, K) tensor with rows
    (p_minus, p_plus, rho). psharp is folded into the dot products
    (dot(psharp_a, rho) == dot(p_a, M^-1 rho)), so the merge stack holds
    three vectors per level instead of five."""

    @staticmethod
    def leaf(p: torch.Tensor) -> torch.Tensor:
        return p.expand(3, p.shape[-1])


def make_fast_trajectory_ops(ld: LogDensity, metric: Metric, pi0, eps,
                             min_delta: float) -> FastTrajectoryOps:
    """Ops bundle of the fast driver for one chain: the leaf payload carries
    (q, logdensity, grad, pi), so nothing is recomputed for the proposal."""
    neg_eps = -eps
    diagonal = isinstance(metric, DiagonalMetric)

    def move(z: PhasePoint, is_forward: bool) -> PhasePoint:
        return leapfrog(ld, metric, z, eps if is_forward else neg_eps)

    def leaf(z: PhasePoint, is_initial: bool):
        pi = joint_logdensity(metric, z)
        delta = torch.zeros_like(pi0) if is_initial else pi - pi0
        v, divergent = _leaf_acceptance(delta, is_initial, min_delta)
        payload = {"q": z.Q.q, "logdensity": z.Q.logdensity, "grad": z.Q.grad,
                   "pi": pi}
        return delta, CompactTurnStatistic.leaf(z.p), divergent, v, payload

    def combine_turn(x, y):
        """The three sub-checks of NUTS.jl:132-139 as one batch of dots:
        dot(a_i, M^-1 r_i) < 0 or dot(b_i, M^-1 r_i) < 0 for
        r = (x.rho + y.p_minus, x.p_plus + y.rho, x.rho + y.rho)."""
        rho = x[2] + y[2]
        r = torch.stack([x[2] + y[0], x[1] + y[2], rho])
        mr = metric.m_inv * r if diagonal else r @ metric.m_inv.mT
        ab = torch.stack([x[0], x[1], x[0], y[0], y[1], y[1]]).view(2, 3, -1)
        turning = ((ab * mr).sum(-1) < 0).any()
        return torch.stack([x[0], y[1], rho]), turning

    return FastTrajectoryOps(
        move=move,
        leaf=leaf,
        combine_turn=combine_turn,
        combine_visited=combine_acceptance_statistics,
        visited_identity=acceptance_identity,
    )


def sample_tree(generator: Optional[torch.Generator], algorithm: NUTS,
                ld: LogDensity, metric: Metric, Q: EvaluatedPoint, eps,
                p: Optional[torch.Tensor] = None, directions=None,
                fast: bool = True, noise: Optional[TreeNoise] = None):
    """One NUTS transition of one chain (NUTS.jl:232-241): momentum,
    direction bits and tree noise from ``generator`` (in that order), the
    trajectory tree, and (Q', TreeStatistics of 0-d tensors).

    ``fast=True`` runs the multinomial fast driver; ``fast=False`` the
    generic progressive-merge driver (the semantics oracle), which every
    custom turn statistic takes. The fast driver's tree noise is a
    ``TreeNoise``, the generic driver's a ``MergeNoise``; both are drawn as
    (max_depth, 2**(max_depth-1)) and then (max_depth,) Exponential(1)
    tensors, so from one generator state both drivers take the same
    momentum and direction bits. ``p`` (K,), ``directions`` (the uint32
    bits, an int or a 0-d tensor) and, for the fast driver, ``noise`` are
    injectable, which makes the transition deterministic; ``noise`` with
    the generic driver raises ``ValueError``."""
    if algorithm.turn_statistic_configuration != "generalized":
        fast = False
    if noise is not None and not fast:
        raise ValueError("noise injection requires the fast driver")
    dtype, device = Q.q.dtype, Q.q.device
    md = algorithm.max_depth
    if p is None:
        p = rand_p(generator, metric, dtype=dtype)
    if directions is None:
        directions = random_directions(generator, device)
    if noise is None and fast:
        noise = TreeNoise(
            gumbel=gumbel_like(generator, (md, 1 << (md - 1)), dtype, device),
            expo=exponential_like(generator, (md,), dtype, device))
    elif noise is None:
        noise = MergeNoise(
            merge=exponential_like(generator, (md, 1 << (md - 1)), dtype,
                                   device),
            doubling=exponential_like(generator, (md,), dtype, device))
    else:
        noise = TreeNoise(*(torch.as_tensor(x).to(device, dtype) for x in noise))
    directions = int(directions) & 0xFFFFFFFF
    z = PhasePoint(Q=Q, p=torch.as_tensor(p).to(device, dtype))
    pi0 = joint_logdensity(metric, z)
    if fast:
        ops = make_fast_trajectory_ops(ld, metric, pi0, eps,
                                       algorithm.min_delta)
        result = sample_trajectory_fast(ops, z, md, directions, noise)
        payload = result.zeta
        Q_new = EvaluatedPoint(q=payload["q"],
                               logdensity=payload["logdensity"],
                               grad=payload["grad"])
        pi_new = payload["pi"]
    else:
        ops = make_trajectory_ops(ld, metric, pi0, eps, algorithm.min_delta,
                                  algorithm.turn_statistic_configuration)
        result = sample_trajectory(ops, z, md, directions, noise)
        Q_new = result.zeta.Q
        pi_new = joint_logdensity(metric, result.zeta)
    v = result.v
    ints = torch.tensor(
        [result.depth, result.term_left, result.term_right, v.steps,
         directions - (1 << 32) if directions >= 1 << 31 else directions],
        dtype=torch.int32, device=device)
    stats = TreeStatistics(
        logdensity=pi_new,
        depth=ints[0],
        term_left=ints[1],
        term_right=ints[2],
        acceptance_rate=torch.clamp(
            torch.exp(v.log_sum_alpha) / max(v.steps, 1), max=1.0),
        steps=ints[3],
        directions=ints[4],
    )
    return Q_new, stats
