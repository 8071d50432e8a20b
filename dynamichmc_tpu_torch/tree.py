"""Injected tree randomness and termination encodings (port of parts of
``dynamichmc_tpu.tree``).

Termination is an int32 (left, right) pair mirroring ``InvalidTree``:
(1, 0) = reached max depth; left == right = divergence at that position;
left < right = turning over positions left..right.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_TREE_DEPTH_BOUND = 30
"""Largest permitted ``max_depth``: leaf counters and signed position
indices are int32, and depth 31 would overflow ``1 << depth``."""


class TreeNoise(NamedTuple):
    """The randomness a transition draws inside its tree, made injectable so
    that two implementations can be fed the same numbers.

    gumbel : (max_depth, 2**(max_depth-1), C) indexed [doubling, leaf]
    expo   : (max_depth, C) indexed [doubling]
    """

    gumbel: torch.Tensor
    expo: torch.Tensor


def is_divergent_termination(left, right):
    return left == right


def reached_max_depth(left, right):
    return (left == 1) & (right == 0)


def is_turning_termination(left, right):
    return ~is_divergent_termination(left, right) & ~reached_max_depth(
        left, right
    )


def normalize_termination(left, right):
    """Canonicalize a turning span to ``left <= right`` (backward turning can
    emit reversed pairs), keeping the divergence and max-depth encodings."""
    is_sentinel = reached_max_depth(left, right)
    lo = torch.where(is_sentinel, left, torch.minimum(left, right))
    hi = torch.where(is_sentinel, right, torch.maximum(left, right))
    return lo, hi
