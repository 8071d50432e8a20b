"""Dummy integer trajectory routed through the PyTorch port's batch driver.

The copy of tests/dummy_batched.py for ``dynamichmc_tpu_torch``: it imports
torch and the port only. It drives the SAME helpers the port's plain batch
driver executes — ``tree_batched._merge_pending`` (the trailing-ones merge
run with freeze-on-turn and the in-place stack store) and
``tree_batched._doubling_bookkeeping`` (validity, edge updates, merged-tree
turn check, termination positions) — replacing only the physics leaf
(integer positions, injected turning/divergence ranges like
DynamicHMC.jl test/test_trees.jl:28-103) and the sampled proposal.

The driver draws its proposal by running Gumbel-argmax and a doubling
Bernoulli; those draws are exactly a multinomial within each valid adjacent
tree and a biased progressive combine across doublings, so this shim carries
the EXACT probability vector instead: per-leaf ``logaddexp`` of the leaf
weight at its position (the driver's live/divergence masks), and the
doubling's exact mixture ``(1-p2)·old + p2·new_normalized`` with
``p2 = exp(min(omega_adj - omega, 0))``, the driver's ``lp2``. Exhaustive
detailed-balance enumeration over all 2^depth direction masks then runs
THROUGH the port's merge and termination code.

``OFFSET``, ``SPAN``, ``dummy_logdensity`` and ``log1mexp`` are copies of
tests/dummy_trajectory.py's (that file imports JAX).
"""

from __future__ import annotations

import math

import torch

from dynamichmc_tpu_torch.tree_batched import (
    _doubling_bookkeeping,
    _Edge,
    _merge_pending,
    _where_edge,
)

F = torch.float64
I32 = torch.int32
OFFSET = 64
SPAN = 2 * OFFSET + 1


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


def _dummy_combine_dir(turning_range):
    """Dummy turn-statistic algebra in the batched combine_dir form:
    tau = (flag, first, last) as (C, 1) tensors; a merged tree is turning
    iff BOTH subtrees are entirely inside the turning range."""
    t_lo, t_hi = turning_range

    def leaf_tau(pos):
        flag = ((pos >= t_lo) & (pos <= t_hi)).to(F)
        pf = pos.to(F)
        return (flag[:, None], pf[:, None], pf[:, None])

    def combine_dir(tau_first, tau_second, is_fwd):
        f = is_fwd[:, None]
        x = tuple(torch.where(f, a, b) for a, b in zip(tau_first, tau_second))
        y = tuple(torch.where(f, b, a) for a, b in zip(tau_first, tau_second))
        flag = (x[0] > 0.5) & (y[0] > 0.5)
        combined = (flag.to(F), x[1], y[2])
        return combined, flag[:, 0]

    return leaf_tau, combine_dir


def dummy_sample_batched(z0, directions, max_depth: int, turning=(1, 0),
                         divergent=(1, 0)):
    """One batched dummy transition; returns the (C, SPAN) log probability
    vector of the proposal over integer positions and the final carry.

    ``z0``: (C,) int32 start positions; ``directions``: (C,) int32 bit
    patterns; ``turning`` / ``divergent``: inclusive injected ranges
    ((1, 0) = empty).
    """
    z0 = torch.as_tensor(z0, dtype=I32)
    directions = torch.as_tensor(directions, dtype=I32)
    C = z0.shape[0]
    S = max_depth
    d_lo, d_hi = divergent
    leaf_tau, combine_dir = _dummy_combine_dir(turning)
    neg_inf = torch.tensor(-math.inf, dtype=F)
    span_idx = torch.arange(SPAN)
    stack = tuple(torch.zeros((S, C, 1), dtype=F) for _ in range(3))

    def onehot_log(pos, value):
        """(C, SPAN): ``value`` at column pos+OFFSET, -inf elsewhere."""
        hit = span_idx[None, :] == (pos + OFFSET)[:, None]
        return torch.where(hit, value[:, None], neg_inf)

    def adjacent(d, z_edge: _Edge, i_edge, is_fwd, engaged):
        """The driver's ``adjacent`` loop with integer moves and an exact
        within-tree log-probability accumulator; merge and termination
        logic is the SHARED ``_merge_pending``."""
        step = torch.where(is_fwd, 1, -1).to(I32)
        n_leaves = 1 << d
        a = {
            "z": z_edge,
            "building": torch.ones((C,), dtype=torch.bool),
            "log_sum": neg_inf.expand(C),
            "steps": torch.zeros((C,), dtype=I32),
            "omega": neg_inf.expand(C),
            "logp": neg_inf.expand(C, SPAN),
            "inv_left": torch.zeros((C,), dtype=I32),
            "inv_right": torch.zeros((C,), dtype=I32),
        }
        n = 0
        while n < n_leaves and bool((a["building"] & engaged).any()):
            pos = a["z"].q[:, 0].to(I32) + step
            z = _Edge(q=pos.to(F)[:, None], p=a["z"].p, grad=a["z"].grad,
                      ld=a["z"].ld)
            delta = dummy_logdensity(pos.to(F))
            div_flag = (pos >= d_lo) & (pos <= d_hi)
            i_new = i_edge + step * (n + 1)
            live = a["building"] & engaged

            v_log = torch.where(live, torch.clamp(delta, max=0.0), neg_inf)
            a["log_sum"] = torch.logaddexp(a["log_sum"], v_log)
            a["steps"] = a["steps"] + live.to(I32)

            # exact multinomial accumulator (replaces Gumbel-argmax): the
            # driver's inclusion mask of the score and omega updates
            w = torch.where(div_flag | ~live, neg_inf, delta)
            a["logp"] = torch.logaddexp(a["logp"], onehot_log(pos, w))
            a["omega"] = torch.logaddexp(a["omega"], w)

            _node, turned, turn_left = _merge_pending(
                n, stack, leaf_tau(pos), combine_dir, is_fwd, i_edge, step,
                torch.zeros((C,), dtype=torch.bool),
                torch.zeros((C,), dtype=I32),
            )
            invalid = live & (div_flag | turned)
            left = torch.where(div_flag, i_new, turn_left)
            a["z"] = z
            a["building"] = a["building"] & ~(div_flag | turned)
            a["inv_left"] = torch.where(invalid, left, a["inv_left"])
            a["inv_right"] = torch.where(invalid, i_new, a["inv_right"])
            n += 1
        a["tau_tree"] = tuple(s[min(d, S - 1)] for s in stack)
        a["n"] = n
        a["i_end"] = i_edge + step * n
        return a

    z0f = z0.to(F)
    zeros1 = torch.zeros((C, 1), dtype=F)
    edge0 = _Edge(q=z0f[:, None], p=zeros1, grad=zeros1,
                  ld=torch.zeros((C,), dtype=F))
    c = {
        "z_minus": edge0,
        "z_plus": edge0,
        "i_minus": torch.zeros((C,), dtype=I32),
        "i_plus": torch.zeros((C,), dtype=I32),
        "logp": onehot_log(z0, torch.zeros((C,), dtype=F)),
        "omega": dummy_logdensity(z0f),
        "tau": leaf_tau(z0),
        "work": 0,
        "log_sum": neg_inf.expand(C),
        "steps": torch.zeros((C,), dtype=I32),
        "depth": torch.zeros((C,), dtype=I32),
        "terminated": torch.zeros((C,), dtype=torch.bool),
        "term_left": torch.ones((C,), dtype=I32),
        "term_right": torch.zeros((C,), dtype=I32),
    }
    d = 0
    while d < max_depth and bool((~c["terminated"]).any()):
        is_fwd = ((directions >> d) & 1) == 1
        engaged = ~c["terminated"]
        z_edge = _where_edge(is_fwd, c["z_plus"], c["z_minus"])
        i_edge = torch.where(is_fwd, c["i_plus"], c["i_minus"])

        adj = adjacent(d, z_edge, i_edge, is_fwd, engaged)
        upd = _doubling_bookkeeping(c, adj, engaged, is_fwd, combine_dir)
        valid = upd.pop("valid")

        # exact biased progressive combine (replaces the Bernoulli draw):
        # the driver's lp2
        lp2 = torch.clamp(adj["omega"] - c["omega"], max=0.0)
        logp_new = torch.logaddexp(
            c["logp"] + log1mexp(lp2)[:, None],
            (adj["logp"] - adj["omega"][:, None]) + lp2[:, None],
        )
        c["logp"] = torch.where(valid[:, None], logp_new, c["logp"])
        c.update(upd)
        d += 1
    return c["logp"], c
