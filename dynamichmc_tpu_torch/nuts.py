"""NUTS configuration and per-transition statistics (port of parts of
``dynamichmc_tpu.nuts``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .tree import MAX_TREE_DEPTH_BOUND

DEFAULT_MAX_TREE_DEPTH = 10


@dataclasses.dataclass(frozen=True)
class NUTS:
    """Algorithm configuration: tree depth cap, divergence threshold and the
    turn statistic (only ``"generalized"`` has batched drivers)."""

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
