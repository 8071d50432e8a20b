"""A dummy integer trajectory for unit-testing the port's generic tree
driver (torch copy of tests/dummy_trajectory.py, which ports the
reference's DummyTrajectory, test/test_trees.jl:28-103).

Positions are Python ints, ``move`` is +-1, turning and divergence are
injected through position ranges, and a proposal carries the full
within-tree probability vector instead of a sampled point, which makes the
exhaustive detailed-balance check possible without any MCMC:

  z     : int position
  zeta  : (lo, hi, logp), logp a float64 (SPAN,) tensor indexed
          logp[pos + OFFSET], -inf outside the tree's [lo, hi]
  tau   : (all_turning: 0-d bool tensor, first: int, last: int)
  v     : (acceptance sum: 0-d float64 tensor, steps: int)

Imports no JAX.
"""

from __future__ import annotations

import math

import torch

from dynamichmc_tpu_torch.tree import TrajectoryOps, biased_progressive_logprob2

OFFSET = 192  # wide enough for the enumeration at depth 6 from z = 3
SPAN = 2 * OFFSET + 1
F64 = torch.float64


def log1mexp(x):
    """log(1 - exp(x)) for x <= 0, stable; log1mexp(0) = -inf."""
    return torch.where(
        x > math.log(0.5),
        torch.log(-torch.expm1(torch.clamp(x, max=0.0))),
        torch.log1p(-torch.exp(x)),
    )


def dummy_logdensity(z):
    """The reference's testl (test_trees.jl:106)."""
    return -((z - 3.0) ** 2) * 0.1


def make_dummy_ops(turning=(1, 0), divergent=(1, 0)) -> TrajectoryOps:
    """TrajectoryOps of the dummy trajectory; ``turning`` / ``divergent``
    are inclusive (lo, hi) ranges, the default (1, 0) empty."""
    t_lo, t_hi = turning
    d_lo, d_hi = divergent

    def move(z, is_forward):
        return z + (1 if is_forward else -1)

    def leaf(z, is_initial):
        delta = torch.tensor(dummy_logdensity(float(z)), dtype=F64)
        logp = torch.full((SPAN,), -torch.inf, dtype=F64)
        logp[z + OFFSET] = 0.0
        tau = (torch.tensor(t_lo <= z <= t_hi), z, z)
        if is_initial:
            v = (torch.tensor(0.0, dtype=F64), 0)
            divergent_flag = torch.tensor(False)
        else:
            v = (torch.clamp(torch.exp(delta), max=1.0), 1)
            divergent_flag = torch.tensor(d_lo <= z <= d_hi)
        return (z, z, logp), delta, tau, divergent_flag, v

    def combine_turn(tau_x, tau_y):
        fx, x_first, _x_last = tau_x
        fy, _y_first, y_last = tau_y
        flag = fx & fy
        return (flag, x_first, y_last), flag

    def combine_proposals(draw, zeta1, zeta2, logprob2, is_forward):
        lo1, hi1, logp1 = zeta1
        lo2, hi2, logp2 = zeta2
        lp2 = torch.clamp(logprob2, max=0.0)
        lp1 = log1mexp(lp2)
        logp = torch.logaddexp(logp1 + lp1, logp2 + lp2)
        return (min(lo1, lo2), max(hi1, hi2), logp)

    def combine_visited(v1, v2):
        return (v1[0] + v2[0], v1[1] + v2[1])

    def visited_identity(v):
        return (torch.zeros_like(v[0]), 0)

    return TrajectoryOps(
        move=move,
        leaf=leaf,
        combine_turn=combine_turn,
        calculate_logprob2=biased_progressive_logprob2,
        combine_proposals=combine_proposals,
        combine_visited=combine_visited,
        visited_identity=visited_identity,
    )
