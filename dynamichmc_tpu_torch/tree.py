"""Injected tree randomness, termination encodings and the per-chain fast
trajectory driver (port of parts of ``dynamichmc_tpu.tree``).

Termination is an int32 (left, right) pair mirroring ``InvalidTree``:
(1, 0) = reached max depth; left == right = divergence at that position;
left < right = turning over positions left..right.

The per-chain fast driver (``sample_trajectory_fast``) is the JAX package's
multinomial driver run eagerly for one chain: a running Gumbel-argmax picks
the proposal inside each adjacent tree, a Bernoulli at each doubling
combines it with the old tree's (biased progressive sampling), and the merge
stack holds only turn statistics. Every float stays on the device. Each leaf
reads its discrete outcome (divergent, proposal taken, turned at each merge
level) to the host once, and each doubling reads (accepted, turned) once;
counters, positions and depths are Python ints.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

MAX_TREE_DEPTH_BOUND = 30
"""Largest permitted ``max_depth``: leaf counters and signed position
indices are int32, and depth 31 would overflow ``1 << depth``."""

TERM_MAX_DEPTH = (1, 0)
"""The termination pair of a tree that reached max depth."""


class TreeNoise(NamedTuple):
    """The randomness a transition draws inside its tree, made injectable so
    that two implementations can be fed the same numbers.

    gumbel : (max_depth, 2**(max_depth-1)[, C]) indexed [doubling, leaf]
    expo   : (max_depth[, C]) indexed [doubling]

    The trailing chain axis C is the batched drivers' layout; the per-chain
    driver takes none.
    """

    gumbel: torch.Tensor
    expo: torch.Tensor


def gumbel_like(generator, shape, dtype, device):
    """Gumbel(0, 1) as -log(Exponential(1)), which never takes log(0)."""
    e = torch.empty(shape, dtype=dtype, device=device)
    return -torch.log(e.exponential_(generator=generator))


def exponential_like(generator, shape, dtype, device):
    e = torch.empty(shape, dtype=dtype, device=device)
    return e.exponential_(generator=generator)


def random_directions(generator, device=None) -> int:
    """32 direction bits for one chain: one uint32 draw, read to the host."""
    return int(torch.randint(0, 1 << 32, (), generator=generator,
                             dtype=torch.int64, device=device))


def next_direction(flags: int):
    """Pop the next doubling direction bit: (is_forward, remaining bits)."""
    flags &= 0xFFFFFFFF
    return (flags & 1) == 1, flags >> 1


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


@dataclasses.dataclass(frozen=True)
class FastTrajectoryOps:
    """Trajectory interface of the multinomial fast driver, for one chain.

    move(z, is_forward: bool) -> z'
    leaf(z, is_initial: bool) -> (delta, tau, divergent, v, payload)
        ``delta``: the leaf's log weight (0-d tensor); ``tau``: its turn
        statistic (a tensor); ``divergent``: 0-d bool tensor; ``v``: visited
        statistics; ``payload``: what the proposal returns.
    combine_turn(tau_earlier, tau_later) -> (tau, turning 0-d bool tensor)
    combine_visited(v1, v2) -> v
    visited_identity(v) -> v0
    """

    move: Callable
    leaf: Callable
    combine_turn: Callable
    combine_visited: Callable
    visited_identity: Callable


class TrajectoryResult(NamedTuple):
    zeta: Any  # proposal payload
    v: Any  # visited statistics
    term_left: int  # termination description, see the module docstring
    term_right: int
    depth: int


def _combine_turn_in_direction(ops: FastTrajectoryOps, tau_first, tau_second,
                               is_forward: bool):
    """Merge turn statistics where ``tau_first`` precedes ``tau_second`` in
    traversal order, swapped into trajectory-time order backward."""
    if is_forward:
        return ops.combine_turn(tau_first, tau_second)
    return ops.combine_turn(tau_second, tau_first)


def _adjacent_tree_fast(ops: FastTrajectoryOps, z, i: int, depth: int,
                        is_forward: bool, max_depth: int, noise: TreeNoise,
                        v_identity) -> dict:
    """The depth-``depth`` adjacent tree from edge ``z`` at position ``i``:
    traversal, early exit and turn checks of the JAX ``_adjacent_tree_fast``.
    The merge stack is one preallocated (max_depth, *tau.shape) tensor; the
    completed tree's statistic sits at slot ``depth``."""
    step = 1 if is_forward else -1
    n_leaves = 1 << depth
    stack = None
    v = v_identity
    omega = best_score = best_payload = None
    valid, left, right, n = True, 0, 0, 0
    while n < n_leaves and valid:
        z = ops.move(z, is_forward)
        i_new = i + step * (n + 1)
        delta, tau, divergent, v_leaf, payload = ops.leaf(z, False)
        v = ops.combine_visited(v, v_leaf)
        if stack is None:
            stack = tau.new_empty((max_depth,) + tuple(tau.shape))
            best_score = delta.new_full((), -torch.inf)
        score = delta + noise.gumbel[depth, n]
        turnings, level = [], 0
        while (n >> level) & 1:  # merge pending subtrees (trailing one bits)
            tau, turning = _combine_turn_in_direction(ops, stack[level], tau,
                                                      is_forward)
            turnings.append(turning)
            level += 1
        flags = torch.stack([divergent, score > best_score, *turnings]).tolist()
        div, take = flags[0], flags[1] and not flags[0]
        turned_at = next((lv for lv, t in enumerate(flags[2:]) if t), None)
        if not div:
            omega = delta if omega is None else torch.logaddexp(omega, delta)
        if take:
            best_score, best_payload = score, payload
        if div or turned_at is not None:
            valid = False
            if div:
                left = i_new
            else:  # first leaf of the merged subtree that turned
                a = n - (1 << (turned_at + 1)) + 1
                left = i + step * (a + 1)
            right = i_new
        else:
            stack[level].copy_(tau)
        n += 1
    return {
        "valid": valid, "left": left, "right": right, "z": z,
        "i": i + step * n, "v": v, "omega": omega,
        "best_payload": best_payload,
        "tau": stack[min(depth, max_depth - 1)] if valid else None,
    }


def sample_trajectory_fast(ops: FastTrajectoryOps, z, max_depth: int,
                           directions: int, noise: TreeNoise
                           ) -> TrajectoryResult:
    """Doubling driver over the fast adjacent tree (JAX
    ``sample_trajectory_fast``) for one chain. ``directions``: the uint32
    direction bits as a Python int; ``noise``: per-chain TreeNoise."""
    if not 0 < max_depth <= MAX_TREE_DEPTH_BOUND:
        raise ValueError(f"max_depth must be in 1..{MAX_TREE_DEPTH_BOUND}")
    omega, tau, _div, v, payload = ops.leaf(z, True)
    v_identity = ops.visited_identity(v)
    z_minus = z_plus = z
    i_minus = i_plus = 0
    depth = 0
    term = TERM_MAX_DEPTH
    while depth < max_depth:
        is_forward, directions = next_direction(directions)
        z_edge, i_edge = (z_plus, i_plus) if is_forward else (z_minus, i_minus)
        adj = _adjacent_tree_fast(ops, z_edge, i_edge, depth, is_forward,
                                  max_depth, noise, v_identity)
        v = ops.combine_visited(v, adj["v"])
        if not adj["valid"]:
            term = (adj["left"], adj["right"])
            break
        if is_forward:
            z_plus, i_plus = adj["z"], adj["i"]
        else:
            z_minus, i_minus = adj["z"], adj["i"]
        # biased progressive combine at the doubling: accept the new
        # subtree's proposal with probability exp(w_new - w_old)
        lp2 = adj["omega"] - omega
        accept = (lp2 >= 0) | (noise.expo[depth] > -lp2)
        tau_c, turning = _combine_turn_in_direction(ops, tau, adj["tau"],
                                                    is_forward)
        accepted, turned = torch.stack([accept, turning]).tolist()
        if accepted:
            payload = adj["best_payload"]
        omega = torch.logaddexp(omega, adj["omega"])
        depth += 1
        if turned:
            term = (i_minus, i_plus)
            break
        tau = tau_c
    left, right = term
    if term != TERM_MAX_DEPTH:
        left, right = min(term), max(term)
    return TrajectoryResult(zeta=payload, v=v, term_left=left,
                            term_right=right, depth=depth)
