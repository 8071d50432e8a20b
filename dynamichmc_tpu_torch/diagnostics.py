"""Post-hoc NUTS diagnostics and interactive debugging tools (port of
``dynamichmc_tpu.diagnostics``).

EBFMI, termination and depth counts and acceptance quantiles over the
per-transition ``TreeStatistics`` (fields of shape (N,) for one chain or
(C, N) for a batch, draws on the last axis), the lockstep waste of the
batched drivers, and the two numerical explorers (acceptance-ratio grids
and bidirectional leapfrog trajectories) as host-side debug tools. The
explorers draw their momenta from an explicit ``torch.Generator``, or take
them injected (``momenta`` / ``p``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .hamiltonian import PhasePoint, evaluate, joint_logdensity, leapfrog
from .logdensity import LogDensity
from .metric import Metric, identity_metric, rand_p
from .nuts import TreeStatistics
from .stepsize import local_log_acceptance_ratio

ACCEPTANCE_QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)
"""diagnostics.jl:35."""


def EBFMI(tree_statistics: TreeStatistics) -> torch.Tensor:
    """Energy Bayesian fraction of missing information (diagnostics.jl:29-32):
    mean(diff(pi)^2) / var(pi) along the draws (the last axis), on the
    statistics' own device. Values <= 0.3 indicate a poorly chosen kinetic
    energy (Betancourt 2016). The variance is the corrected sample
    variance, as Julia's ``var``."""
    pis = tree_statistics.logdensity
    d = torch.diff(pis, dim=-1)
    return (d * d).mean(-1) / pis.var(-1, correction=1)


@dataclasses.dataclass(frozen=True)
class TreeStatisticsSummary:
    """diagnostics.jl:47-58 (host-side, pretty-printable)."""

    N: int
    a_mean: float
    a_quantiles: np.ndarray
    termination_counts: dict  # max_depth / divergence / turning
    depth_counts: np.ndarray  # first element is depth 0

    def __str__(self) -> str:
        lines = [f"Hamiltonian Monte Carlo sample of length {self.N}"]
        qs = " ".join(f"{q:.2f}" for q in self.a_quantiles)
        lines.append(
            f"  acceptance rate mean: {self.a_mean:.2f}, 5/25/50/75/95%: {qs}"
        )
        term = ", ".join(
            f"{k} => {round(100 * v / self.N)}%"
            for k, v in sorted(self.termination_counts.items())
        )
        lines.append(f"  termination: {term}")
        depth = ", ".join(
            f"{d} => {round(100 * c / self.N)}%"
            for d, c in enumerate(self.depth_counts)
        )
        lines.append(f"  depth: {depth}")
        return "\n".join(lines)


def termination_description(term_left: int, term_right: int) -> str:
    """Human-readable termination reason, mirroring InvalidTree's display
    (trees.jl:189-199): divergence at a position, turning over positions, or
    the reached-max-depth sentinel."""
    left, right = int(term_left), int(term_right)
    if left == 1 and right == 0:
        return "reached maximum depth without divergence or turning"
    if left == right:
        return f"divergence at position {left}"
    return f"turning at positions {left}:{right}"


def count_terminations(tree_statistics: TreeStatistics) -> dict:
    """diagnostics.jl:65-80."""
    return {
        "max_depth": int(tree_statistics.reached_max_depth.sum()),
        "divergence": int(tree_statistics.is_divergent.sum()),
        "turning": int(tree_statistics.is_turning.sum()),
    }


def count_depths(tree_statistics: TreeStatistics) -> np.ndarray:
    """diagnostics.jl:87-93: counts indexed by depth, trailing zeros
    trimmed."""
    depths = tree_statistics.depth.flatten().to(torch.int64)
    c = torch.bincount(depths, minlength=1).cpu().numpy()
    last = np.nonzero(c)[0]
    return c[: (last[-1] + 1 if last.size else 0)]


def summarize_tree_statistics(tree_statistics: TreeStatistics
                              ) -> TreeStatisticsSummary:
    """diagnostics.jl:100-106."""
    a = tree_statistics.acceptance_rate.detach().cpu().numpy().ravel()
    return TreeStatisticsSummary(
        N=a.size,
        a_mean=float(a.mean()),
        a_quantiles=np.quantile(a, ACCEPTANCE_QUANTILES),
        termination_counts=count_terminations(tree_statistics),
        depth_counts=count_depths(tree_statistics),
    )


def _start(ld: LogDensity, q, metric: Optional[Metric]):
    q = torch.as_tensor(q)
    if metric is None:
        metric = identity_metric(ld.dim, dtype=q.dtype, device=q.device)
    return q, metric, evaluate(ld, q)


def _generator(generator: Optional[torch.Generator], device):
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


def explore_log_acceptance_ratios(
    ld: LogDensity,
    q,
    log2_epsilons,
    generator: Optional[torch.Generator] = None,
    metric: Optional[Metric] = None,
    n_momenta: int = 20,
    momenta=None,
) -> np.ndarray:
    """Grid of uncapped one-step log acceptance ratios over log2 stepsizes x
    momenta (diagnostics.jl:144-152), for one chain at ``q`` (K,). The
    momenta are ``momenta`` (n, K) or ``n_momenta`` draws of N(0, M) from
    ``generator`` (seed 0 when none is given). Useful for diagnosing
    stepsize and divergence pathologies. Returns (len(log2_epsilons), n)."""
    q, metric, Q = _start(ld, q, metric)
    if momenta is None:
        gen = _generator(generator, q.device)
        momenta = [rand_p(gen, metric, dtype=q.dtype) for _ in range(n_momenta)]
    else:
        momenta = torch.as_tensor(momenta, dtype=q.dtype, device=q.device)
    epsilons = torch.as_tensor(2.0, dtype=q.dtype, device=q.device) ** (
        torch.as_tensor(log2_epsilons, dtype=q.dtype, device=q.device))
    columns = []
    for p in momenta:
        A, _ = local_log_acceptance_ratio(ld, metric, PhasePoint(Q=Q, p=p))
        columns.append(torch.stack([A(eps) for eps in epsilons]))
    return torch.stack(columns, dim=1).cpu().numpy()


def leapfrog_trajectory(
    ld: LogDensity,
    q,
    eps,
    positions: range,
    generator: Optional[torch.Generator] = None,
    metric: Optional[Metric] = None,
    p=None,
):
    """Bidirectional leapfrog trajectory dump (diagnostics.jl:214-227).

    Visits ``positions`` (a range containing 0) relative to the start,
    stopping each direction at the first non-finite log density. Returns a
    list of dicts with ``z`` (PhasePoint), ``position``, and ``delta``
    (energy change relative to position 0), sorted by position. The
    momentum is ``p`` or a draw of N(0, M) from ``generator`` (seed 0 when
    none is given). Host-side debug tool.

    A strided range still *integrates* every intermediate leapfrog step
    (a step cannot be skipped) but only the requested positions are
    returned.
    """
    requested = set(positions) | {0}
    lo, hi = min(positions), max(positions)
    if not lo <= 0 <= hi:
        raise ValueError("positions must contain 0")
    q, metric, Q = _start(ld, q, metric)
    if p is None:
        p = rand_p(_generator(generator, q.device), metric, dtype=q.dtype)
    else:
        p = torch.as_tensor(p, dtype=q.dtype, device=q.device)
    z0 = PhasePoint(Q=Q, p=p)
    pi0 = joint_logdensity(metric, z0)

    def info(z, i):
        return {
            "z": z,
            "position": i,
            "delta": float(joint_logdensity(metric, z) - pi0),
        }

    out = [info(z0, 0)]
    for sign, count in ((1, hi), (-1, -lo)):
        z = z0
        e = torch.as_tensor(sign * eps, dtype=q.dtype, device=q.device)
        for i in range(1, count + 1):
            if not np.isfinite(float(z.Q.logdensity)):
                break
            z = leapfrog(ld, metric, z, e)
            out.append(info(z, sign * i))
    out = [r for r in out if r["position"] in requested]
    return sorted(out, key=lambda r: r["position"])


def straggler_waste(tree_statistics: TreeStatistics) -> float:
    """Fraction of leaf slots spent on already-terminated chains:
    ``1 - mean(steps) / mean(work)`` over all transitions.

    What ``work`` counts depends on the driver that recorded it. The plain
    batch driver (tree_batched.py) advances all chains in lockstep, so its
    ``work`` is the batch's executed leaf slots and this is the fleet's
    lockstep waste (the JAX package's meaning). The tree kernel records
    each chain's own executed leaf count, and a chain stops building when
    its own tree ends, so on a tree-kernel path ``work`` equals ``steps``
    and this reads 0: what the kernel loses to its deepest chains is the
    tail of each launch, which leaf slots do not count. The per-chain
    driver records no ``work`` and raises."""
    if tree_statistics.work is None:
        raise ValueError("straggler_waste needs batch-native tree statistics "
                         "(per-chain drivers do not record work)")
    steps = tree_statistics.steps.to(torch.float64)
    work = tree_statistics.work.to(torch.float64)
    return float(1.0 - steps.mean() / work.mean())
