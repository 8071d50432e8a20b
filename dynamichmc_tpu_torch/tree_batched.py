"""Batch-native NUTS transition, the plain driver (port of
``dynamichmc_tpu.tree_batched``).

One transition for a whole (C, K) chain batch. All still-active chains share
the doubling level ``d`` and the leaf counter ``n`` (they start together and
advance together; finished chains are masked), so loop bounds and merge
levels are plain Python integers and the merge stack is a level-major
(S, C, K) tensor written in place.

Semantics are the JAX driver's: multinomial proposal inside each adjacent
tree by running Gumbel-argmax, biased progressive combine at every
doubling, the three-way generalized U-turn at every merge, -inf poisoning of
numerical faults, and InvalidTree-style termination positions.

This driver is the oracle the tree kernel (ops/tree_kernel.py) is tested
against and the fallback for every model and configuration the kernel
declines. A model with a ``fused_leaf_batched_fn`` (ops/logreg_leaf.py)
has every leaf computed by that hook. Its lockstep loops end on
``any(active)``, one host read per leaf.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .hamiltonian import EvaluatedPoint, evaluate
from .logdensity import LogDensity
from .metric import DiagonalMetric, Metric
from .nuts import NUTS, AcceptanceStatistic, TreeStatistics, acceptance_rate
from .profiling import host_bool
from .tree import (
    TreeNoise,
    exponential_like,
    gumbel_like,
    normalize_termination,
)

# --- batched metric helpers (shared or per-chain) ----------------------------


def psharp_b(metric: Metric, p):
    """M^-1 p for p: (C, K); metric arrays shared or per-chain."""
    m = metric.m_inv
    if isinstance(metric, DiagonalMetric):
        return p * m
    if m.ndim == 2:  # shared dense (K, K), symmetric
        return p @ m
    return torch.einsum("cij,cj->ci", m, p)


def kinetic_b(metric: Metric, p):
    """0.5 p^T M^-1 p per chain, with the same M^-1 as the dynamics."""
    if isinstance(metric, DiagonalMetric):
        return 0.5 * (metric.m_inv * p * p).sum(-1)
    return 0.5 * (p * psharp_b(metric, p)).sum(-1)


def rand_p_b(generator, metric: Metric, shape, dtype):
    """p ~ N(0, M) for a (C, K) batch."""
    z = torch.randn(shape, generator=generator, dtype=dtype,
                    device=metric.m_inv.device)
    if isinstance(metric, DiagonalMetric):
        return z * metric.w_diag.to(dtype)
    w = metric.w.to(dtype)
    if w.ndim == 2:
        return z @ w.mT
    return torch.einsum("cij,cj->ci", w, z)


def random_directions(generator, C: int, device) -> torch.Tensor:
    """C uniform uint32 direction words, held as int32 bit patterns."""
    x = torch.randint(0, 1 << 32, (C,), generator=generator,
                      dtype=torch.int64, device=device)
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _dot(a, b):
    return (a * b).sum(-1)


def _joint_b(metric, ld_vals, p):
    k = kinetic_b(metric, p)
    k = torch.where(torch.isfinite(k), k, torch.inf)
    return torch.where(torch.isfinite(ld_vals), ld_vals - k, -torch.inf)


class _Edge(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    grad: torch.Tensor
    ld: torch.Tensor


def _leapfrog_b(ld, metric, edge: _Edge, eps_signed):
    half = 0.5 * eps_signed[:, None]
    p_mid = edge.p + half * edge.grad
    q_new = edge.q + eps_signed[:, None] * psharp_b(metric, p_mid)
    ev = evaluate(ld, q_new)
    p_new = p_mid + half * ev.grad
    return _Edge(q=q_new, p=p_new, grad=ev.grad, ld=ev.logdensity)


def _where_edge(c, a: _Edge, b: _Edge) -> _Edge:
    cc = c[:, None]
    return _Edge(
        q=torch.where(cc, a.q, b.q),
        p=torch.where(cc, a.p, b.p),
        grad=torch.where(cc, a.grad, b.grad),
        ld=torch.where(c, a.ld, b.ld),
    )


class TauOps(NamedTuple):
    """The generalized-turn-statistic algebra for a metric.

    Dense metrics carry psharp (M^-1 p) for the two edge momenta, so every
    merge-time turn check is a plain dot (five statistics). Diagonal metrics
    keep the compact three-vector statistic and fold psharp into the dots.
    """

    tau_len: int
    pi_and_psharp: Callable  # (ld_vals, p) -> (joint logdensity, psharp|None)
    leaf_tau: Callable  # (p, sp) -> tau tuple
    combine_dir: Callable  # (tau_first, tau_second, is_fwd) -> (tau, turning)


def make_tau_ops(metric: Metric) -> TauOps:
    carry_psharp = not isinstance(metric, DiagonalMetric)
    tau_len = 5 if carry_psharp else 3

    def pi_and_psharp(ld_vals, p):
        if carry_psharp:
            sp = psharp_b(metric, p)
            k = 0.5 * (p * sp).sum(-1)
        else:
            sp = None
            k = kinetic_b(metric, p)
        k = torch.where(torch.isfinite(k), k, torch.inf)
        return torch.where(torch.isfinite(ld_vals), ld_vals - k,
                           -torch.inf), sp

    def leaf_tau(p, sp):
        if carry_psharp:
            return (p, p, p, sp, sp)
        return (p, p, p)

    def turn_checks(pm_x, pp_x, rho_x, pm_y, pp_y, rho_y, sp_x, sp_y):
        """Three-way generalized U-turn in trajectory-time order (x
        earlier)."""
        r1 = rho_x + pm_y
        r2 = pp_x + rho_y
        rho = rho_x + rho_y
        if carry_psharp:
            spm_x, spp_x = sp_x
            spm_y, spp_y = sp_y
            t1 = (_dot(spm_x, r1) < 0) | (_dot(spm_y, r1) < 0)
            t2 = (_dot(spp_x, r2) < 0) | (_dot(spp_y, r2) < 0)
            t3 = (_dot(spm_x, rho) < 0) | (_dot(spp_y, rho) < 0)
        else:
            mr1 = psharp_b(metric, r1)
            t1 = (_dot(pm_x, mr1) < 0) | (_dot(pm_y, mr1) < 0)
            mr2 = psharp_b(metric, r2)
            t2 = (_dot(pp_x, mr2) < 0) | (_dot(pp_y, mr2) < 0)
            mrho = psharp_b(metric, rho)
            t3 = (_dot(pm_x, mrho) < 0) | (_dot(pp_y, mrho) < 0)
        return rho, t1 | t2 | t3

    def combine_dir(tau_first, tau_second, is_fwd):
        """tau = (p_minus, p_plus, rho[, psharp_minus, psharp_plus]); first
        precedes second in traversal order, swapped into time order per
        lane when moving backward."""
        f = is_fwd[:, None]
        x = tuple(torch.where(f, a, b) for a, b in zip(tau_first, tau_second))
        y = tuple(torch.where(f, b, a) for a, b in zip(tau_first, tau_second))
        if carry_psharp:
            pm_x, pp_x, rho_x, spm_x, spp_x = x
            pm_y, pp_y, rho_y, spm_y, spp_y = y
            rho, turning = turn_checks(
                pm_x, pp_x, rho_x, pm_y, pp_y, rho_y,
                (spm_x, spp_x), (spm_y, spp_y),
            )
            return (pm_x, pp_y, rho, spm_x, spp_y), turning
        pm_x, pp_x, rho_x = x
        pm_y, pp_y, rho_y = y
        rho, turning = turn_checks(
            pm_x, pp_x, rho_x, pm_y, pp_y, rho_y, None, None
        )
        return (pm_x, pp_y, rho), turning

    return TauOps(tau_len, pi_and_psharp, leaf_tau, combine_dir)


fused_leaf_calls = 0  # leaves the driver handed to a fused_leaf_batched_fn


def reset_fused_leaf_calls() -> None:
    global fused_leaf_calls
    fused_leaf_calls = 0


def _leaf(ld: LogDensity, metric: Metric, ops: TauOps, edge: _Edge,
          eps_signed):
    """One leapfrog leaf of the batch -> (edge', pi', psharp(p') | None).

    A model with a ``fused_leaf_batched_fn`` computes the whole leaf
    (leapfrog, value, gradient, poisoning and pi) in that hook; the driver
    then only adds psharp for the 5-statistic (dense) turn check."""
    global fused_leaf_calls
    if ld.fused_leaf_batched_fn is not None:
        qn, pn, gn, ldn, pi = ld.fused_leaf_batched_fn(
            metric, edge.q, edge.p, edge.grad, eps_signed)
        fused_leaf_calls += 1
        sp = psharp_b(metric, pn) if ops.tau_len == 5 else None
        return _Edge(q=qn, p=pn, grad=gn, ld=ldn), pi, sp
    z = _leapfrog_b(ld, metric, edge, eps_signed)
    pi, sp = ops.pi_and_psharp(z.ld, z.p)
    return z, pi, sp


def _merge_pending(n: int, stack, node, combine_dir, is_fwd, i_edge, step,
                   turned, turn_left):
    """Trailing-ones merge run: merge ``node`` with the pending subtree at
    every trailing one-bit level of the leaf counter ``n``, freezing a
    lane's node once it turned, then park the result at its slot."""
    level = 0
    while (n >> level) & 1:
        popped = tuple(s[level] for s in stack)
        merged, turning = combine_dir(popped, node, is_fwd)
        first_new_turn = turning & ~turned
        a = n - (1 << (level + 1)) + 1
        turn_left = torch.where(
            first_new_turn, i_edge + step * (a + 1), turn_left
        )
        node = tuple(
            torch.where(turned[:, None], old, new)
            for old, new in zip(node, merged)
        )
        turned = turned | turning
        level += 1
    for s, v in zip(stack, node):
        s[level] = v
    return node, turned, turn_left


def _doubling_bookkeeping(c, adj, engaged, is_fwd, combine_dir):
    """Everything in one doubling except proposal selection: validity,
    visited statistics, edge updates, the merged-tree turn check, depth
    and InvalidTree-style termination positions."""
    tree_done = adj["building"]
    valid = engaged & tree_done
    invalid = engaged & ~tree_done

    log_sum = torch.logaddexp(c["log_sum"], adj["log_sum"])
    steps = c["steps"] + adj["steps"]
    work = c["work"] + adj["n"]

    fwd_valid = valid & is_fwd
    bwd_valid = valid & ~is_fwd
    z_plus = _where_edge(fwd_valid, adj["z"], c["z_plus"])
    i_plus = torch.where(fwd_valid, adj["i_end"], c["i_plus"])
    z_minus = _where_edge(bwd_valid, adj["z"], c["z_minus"])
    i_minus = torch.where(bwd_valid, adj["i_end"], c["i_minus"])

    omega = torch.where(
        valid, torch.logaddexp(c["omega"], adj["omega"]), c["omega"]
    )

    tau_c, turning = combine_dir(c["tau"], adj["tau_tree"], is_fwd)
    turning = valid & turning
    keep = (valid & ~turning)[:, None]
    tau = tuple(
        torch.where(keep, new, old) for old, new in zip(c["tau"], tau_c)
    )
    depth = c["depth"] + valid.to(torch.int32)

    newly_term = invalid | turning
    term_left = torch.where(
        invalid, adj["inv_left"],
        torch.where(turning, i_minus, c["term_left"]),
    )
    term_right = torch.where(
        invalid, adj["inv_right"],
        torch.where(turning, i_plus, c["term_right"]),
    )
    return {
        "valid": valid,
        "z_minus": z_minus,
        "z_plus": z_plus,
        "i_minus": i_minus,
        "i_plus": i_plus,
        "omega": omega,
        "tau": tau,
        "log_sum": log_sum,
        "steps": steps,
        "work": work,
        "depth": depth,
        "terminated": c["terminated"] | newly_term,
        "term_left": term_left,
        "term_right": term_right,
    }


def depth_cap(depth_limit, max_depth: int) -> int:
    """The runtime doubling cap: ``None`` or a value <= 0 means uncapped
    (max_depth); reading 0 as a cap would freeze every chain."""
    if depth_limit is None:
        return max_depth
    dl = int(depth_limit)
    return max_depth if dl <= 0 else min(dl, max_depth)


def sample_tree_batched(
    generator: Optional[torch.Generator],
    algorithm: NUTS,
    ld: LogDensity,
    metric: Metric,
    Q: EvaluatedPoint,  # batched: q (C, K), logdensity (C,), grad (C, K)
    eps,  # (C,) or scalar
    directions: Optional[torch.Tensor] = None,  # (C,) int32 bit patterns
    p: Optional[torch.Tensor] = None,  # (C, K) injected momenta
    noise: Optional[TreeNoise] = None,  # injected tree randomness
    depth_limit=None,  # runtime doubling cap <= max_depth (warmup clamp)
):
    """One NUTS transition for a whole chain batch; returns (Q', stats).

    When the model has a ``tree_transition_fn`` and nothing is injected, the
    whole transition goes to that hook; when it declines (returns None)
    the plain driver below runs. ``depth_limit`` caps the doublings below
    ``max_depth`` (the warmup clamp); <= 0 means uncapped."""
    if algorithm.turn_statistic_configuration != "generalized":
        raise NotImplementedError(
            "the batch-native driver supports only the generalized turn "
            "statistic"
        )
    if (
        ld.tree_transition_fn is not None
        and p is None and directions is None and noise is None
    ):
        out = ld.tree_transition_fn(generator, algorithm, metric, Q, eps,
                                    depth_limit)
        if out is not None:
            return out
    raw = transition_raw(generator, algorithm, ld, metric, Q, eps,
                         directions=directions, p=p, noise=noise,
                         depth_limit=depth_limit)
    return finish_transition(raw)


def transition_raw(generator, algorithm: NUTS, ld: LogDensity,
                   metric: Metric, Q: EvaluatedPoint, eps, directions=None,
                   p=None, noise=None, depth_limit=None) -> dict:
    """The plain driver's transition as raw per-chain fields (termination
    not yet normalized): prop_q, prop_ld, prop_grad, prop_pi, depth,
    term_left, term_right, log_sum, steps, work, directions."""
    C, K = Q.q.shape
    dtype, device = Q.q.dtype, Q.q.device
    max_depth = algorithm.max_depth
    S = max_depth  # merge-stack slots (levels 0..max_depth-1)
    d_cap = depth_cap(depth_limit, max_depth)

    p0 = (rand_p_b(generator, metric, (C, K), dtype) if p is None
          else torch.as_tensor(p, dtype=dtype, device=device))
    if directions is None:
        directions = random_directions(generator, C, device)
    eps = torch.as_tensor(eps, dtype=dtype, device=device).expand(C)
    min_delta = float(algorithm.min_delta)
    neg_inf = torch.tensor(-torch.inf, dtype=dtype, device=device)
    i32 = torch.int32

    ops = make_tau_ops(metric)
    pi0, sp0 = ops.pi_and_psharp(Q.logdensity, p0)
    z0 = _Edge(q=Q.q, p=p0, grad=Q.grad, ld=Q.logdensity)
    stack = tuple(
        torch.zeros((S, C, K), dtype=dtype, device=device)
        for _ in range(ops.tau_len)
    )

    def adjacent(d, z_edge, i_edge, is_fwd, engaged):
        """Build the depth-d adjacent trees for all engaged lanes."""
        step = torch.where(is_fwd, 1, -1).to(i32)
        n_leaves = 1 << d
        eps_signed = torch.where(is_fwd, eps, -eps)
        a = {
            "z": z_edge,
            "building": torch.ones((C,), dtype=torch.bool, device=device),
            "log_sum": neg_inf.expand(C),
            "steps": torch.zeros((C,), dtype=i32, device=device),
            "omega": neg_inf.expand(C),
            "best_score": neg_inf.expand(C),
            "best_q": torch.zeros((C, K), dtype=dtype, device=device),
            "best_ld": torch.zeros((C,), dtype=dtype, device=device),
            "best_grad": torch.zeros((C, K), dtype=dtype, device=device),
            "best_pi": torch.zeros((C,), dtype=dtype, device=device),
            "inv_left": torch.zeros((C,), dtype=i32, device=device),
            "inv_right": torch.zeros((C,), dtype=i32, device=device),
        }
        n = 0
        while n < n_leaves and host_bool("leaf_loop",
                                         (a["building"] & engaged).any()):
            z, pi, sp = _leaf(ld, metric, ops, a["z"], eps_signed)
            i_new = i_edge + step * (n + 1)
            delta = pi - pi0
            divergent = delta < min_delta
            live = a["building"] & engaged

            # visited statistics: every visited leaf counts
            v_log = torch.where(live, torch.clamp(delta, max=0.0), neg_inf)
            a["log_sum"] = torch.logaddexp(a["log_sum"], v_log)
            a["steps"] = a["steps"] + live.to(i32)

            # running multinomial proposal draw
            if noise is None:
                g = gumbel_like(generator, (C,), dtype, device)
            else:
                g = noise.gumbel[d, n].to(dtype)
            dead = divergent | ~live
            score = torch.where(dead, neg_inf, delta + g)
            take = score > a["best_score"]
            tk = take[:, None]
            a["best_score"] = torch.where(take, score, a["best_score"])
            a["best_q"] = torch.where(tk, z.q, a["best_q"])
            a["best_ld"] = torch.where(take, z.ld, a["best_ld"])
            a["best_grad"] = torch.where(tk, z.grad, a["best_grad"])
            a["best_pi"] = torch.where(take, pi, a["best_pi"])
            a["omega"] = torch.logaddexp(
                a["omega"], torch.where(dead, neg_inf, delta)
            )

            # merge pending subtrees at the trailing one-bit levels of n
            _node, turned, turn_left = _merge_pending(
                n, stack, ops.leaf_tau(z.p, sp), ops.combine_dir, is_fwd,
                i_edge, step,
                torch.zeros((C,), dtype=torch.bool, device=device),
                torch.zeros((C,), dtype=i32, device=device),
            )
            invalid = live & (divergent | turned)
            left = torch.where(divergent, i_new, turn_left)
            a["z"] = z
            a["building"] = a["building"] & ~(divergent | turned)
            a["inv_left"] = torch.where(invalid, left, a["inv_left"])
            a["inv_right"] = torch.where(invalid, i_new, a["inv_right"])
            n += 1
        # the completed tree's turn statistic sits at slot == d
        slot = min(d, S - 1)
        a["tau_tree"] = tuple(s[slot] for s in stack)
        a["n"] = n
        a["i_end"] = i_edge + step * n
        return a

    c = {
        "z_minus": z0,
        "z_plus": z0,
        "i_minus": torch.zeros((C,), dtype=i32, device=device),
        "i_plus": torch.zeros((C,), dtype=i32, device=device),
        "prop_q": Q.q,
        "prop_ld": Q.logdensity,
        "prop_grad": Q.grad,
        "prop_pi": pi0,
        "omega": torch.zeros((C,), dtype=dtype, device=device),
        "tau": ops.leaf_tau(p0, sp0),
        "work": 0,
        "log_sum": neg_inf.expand(C),
        "steps": torch.zeros((C,), dtype=i32, device=device),
        "depth": torch.zeros((C,), dtype=i32, device=device),
        "terminated": torch.zeros((C,), dtype=torch.bool, device=device),
        "term_left": torch.ones((C,), dtype=i32, device=device),
        "term_right": torch.zeros((C,), dtype=i32, device=device),
    }
    d = 0
    while d < d_cap and host_bool("doubling_loop",
                                  (~c["terminated"]).any()):
        is_fwd = ((directions >> d) & 1) == 1
        engaged = ~c["terminated"]
        z_edge = _where_edge(is_fwd, c["z_plus"], c["z_minus"])
        i_edge = torch.where(is_fwd, c["i_plus"], c["i_minus"])

        adj = adjacent(d, z_edge, i_edge, is_fwd, engaged)
        upd = _doubling_bookkeeping(c, adj, engaged, is_fwd, ops.combine_dir)
        valid = upd.pop("valid")

        # biased doubling combine
        lp2 = adj["omega"] - c["omega"]
        if noise is None:
            e_dbl = exponential_like(generator, (C,), dtype, device)
        else:
            e_dbl = noise.expo[d].to(dtype)
        accept = (lp2 >= 0) | (e_dbl > -lp2)
        take = valid & accept
        tk = take[:, None]
        c["prop_q"] = torch.where(tk, adj["best_q"], c["prop_q"])
        c["prop_ld"] = torch.where(take, adj["best_ld"], c["prop_ld"])
        c["prop_grad"] = torch.where(tk, adj["best_grad"], c["prop_grad"])
        c["prop_pi"] = torch.where(take, adj["best_pi"], c["prop_pi"])
        c.update(upd)
        d += 1

    return {
        "prop_q": c["prop_q"],
        "prop_ld": c["prop_ld"],
        "prop_grad": c["prop_grad"],
        "prop_pi": c["prop_pi"],
        "depth": c["depth"],
        "term_left": c["term_left"],
        "term_right": c["term_right"],
        "log_sum": c["log_sum"],
        "steps": c["steps"],
        "work": torch.full((C,), c["work"], dtype=i32, device=device),
        "directions": directions,
    }


def finish_transition(raw: dict):
    """Normalize the termination encoding and pack (Q', TreeStatistics)."""
    lo, hi = normalize_termination(raw["term_left"], raw["term_right"])
    stats = TreeStatistics(
        logdensity=raw["prop_pi"],
        depth=raw["depth"],
        term_left=lo,
        term_right=hi,
        acceptance_rate=acceptance_rate(
            AcceptanceStatistic(raw["log_sum"], raw["steps"])
        ),
        steps=raw["steps"],
        directions=raw["directions"],
        work=raw["work"],
    )
    Q_new = EvaluatedPoint(
        q=raw["prop_q"], logdensity=raw["prop_ld"], grad=raw["prop_grad"]
    )
    return Q_new, stats
