"""Aligned wavefront warmup driver (port of ``dynamichmc_tpu.tree_wavefront``).

The lockstep batch driver (tree_batched.py) advances every chain through
the same transition, so each transition costs the whole batch the deepest
tree of any chain. This driver removes that barrier: each lane runs its
own transition lifecycle (restart, adjacent trees, doubling, completion)
inside one loop over a global leaf slot ``g``, and a lane whose transition
ends begins its next one while the others keep building.

**Aligned starts.** A lane may start a depth-d adjacent tree only at
slots g = 0 (mod 2^d). Its leaf index n = g - g0 then satisfies
n = g (mod 2^d), so its trailing-ones merge run covers levels
0..min(TO(g), d) - 1, a prefix of the slot counter's own trailing ones.
One loop over the levels of TO(g) serves every lane, with a per-lane mask
at each level. The rule also sets which slots each lane uses, so the slot
counts (the final ``g``, each lane's waits) are the JAX driver's for the
same noise. Here ``g`` is a host integer, so TO(g) and the merge levels
are plain Python integers and no slot reads the device.

Scope: warmup stages (dual averaging and Welford folds at each lane's
transition completion; no per-draw recording). Sampling runs the lockstep
driver or the epoch driver (tree_wavefront_epoch.py).

Each transition has the lockstep driver's semantics: multinomial
Gumbel-argmax proposals, the biased doubling combine, the three-way
generalized U-turn, -inf poisoning. The random stream differs: draws are
taken per slot, for every lane at once, so a lane's numbers depend on the
slot at which it uses them. Every leaf goes through ``tree_batched._leaf``,
so a model with a ``fused_leaf_batched_fn`` (K2, K3) runs its kernel on
every slot, for all lanes, the waiting ones masked out afterwards.

The JAX package's ``wavefront_carry_specs`` is ``shard_map`` plumbing;
under a mesh each rank here holds its own lanes and its own carry, so it
has no counterpart. With a pooled stepsize over a mesh of more than one
rank the slot loop runs epoch-lockstep: each rank runs its slots up to the
next multiple of ``epoch``, then one ``all_reduce`` pools the acceptance
accumulators and a live flag, and a rank whose lanes are done keeps
joining those collectives until every rank's lanes finish.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .hamiltonian import EvaluatedPoint
from .logdensity import LogDensity
from .metric import Metric
from .nuts import NUTS, AcceptanceStatistic, acceptance_rate
from .profiling import host_bool
from .tree import exponential_like, gumbel_like
from .tree_batched import (
    _Edge,
    _leaf,
    _where_edge,
    depth_cap,
    make_tau_ops,
    rand_p_b,
    random_directions,
)
from .utils.welford import welford_update_masked, welford_update_pooled_masked

CHECK_EVERY = 16  # slots between two reads of "every lane done" to the host

slots_run = 0  # slots executed by every stage since the last reset
lane_steps = 0  # leapfrog steps of the transitions those stages completed


def reset_slots_run() -> None:
    global slots_run, lane_steps
    slots_run = lane_steps = 0


class WavefrontNoise(NamedTuple):
    """Injected randomness (tests), indexed by each lane's own counters
    (transition t, doubling d, leaf n = g - tree_g0), so that a wavefront
    run consumes the numbers the lockstep driver consumes when fed the
    matching ``tree.TreeNoise`` per transition:

    p      : (T, C, K)  momentum at the restart of transition t
    dirs   : (T, C)     direction bits (int32 bit patterns)
    gumbel : (T, max_depth, 2**(max_depth-1), C)
    expo   : (T, max_depth, C)
    """

    p: torch.Tensor
    dirs: torch.Tensor
    gumbel: torch.Tensor
    expo: torch.Tensor


def _trailing_ones(g: int) -> int:
    """The number of trailing one bits of ``g`` >= 0 (0 for even g)."""
    return ((~g) & (g + 1)).bit_length() - 1


def select_state(mask: torch.Tensor, new, old):
    """``new`` where ``mask`` else ``old``, per chain (a (C,) mask) or for
    the whole state (a 0-d one), for a tensor or a dataclass of tensors
    (an adaptation state)."""
    if torch.is_tensor(new):
        m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
        return torch.where(m, new, old)
    return dataclasses.replace(old, **{
        f.name: select_state(mask, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(old)})


def wavefront_init(Q: EvaluatedPoint, metric: Metric, da_state, welford,
                   max_depth: int) -> dict:
    """A fresh stage carry: every lane flagged for restart."""
    C, K = Q.q.shape
    like = dict(dtype=Q.q.dtype, device=Q.q.device)
    i32 = dict(dtype=torch.int32, device=Q.q.device)
    tau_len = make_tau_ops(metric).tau_len
    zeros = torch.zeros((C,), **like)
    zeros_i = torch.zeros((C,), **i32)
    false = torch.zeros((C,), dtype=torch.bool, device=Q.q.device)
    zK = torch.zeros((C, K), **like)
    edge = _Edge(q=Q.q, p=zK, grad=Q.grad, ld=Q.logdensity)
    return {
        "g": 0,
        "t": zeros_i,
        "need_restart": torch.ones((C,), dtype=torch.bool, device=Q.q.device),
        "waiting": false,
        "building": false,
        # adaptation folds and stage totals
        "da": da_state,
        "wf": welford,
        "acc_sum": zeros,
        "div": zeros_i,
        "steps_total": zeros_i,
        "maxd": zeros_i,
        # pooled-eps accumulators (0-d; unused with per-chain eps)
        "acc_ep_sum": torch.zeros((), **like),
        "acc_ep_n": torch.zeros((), **like),
        # transition state
        "Q": Q,
        "eps_l": zeros,
        "dirs": zeros_i,
        "pi0": zeros,
        "d": zeros_i,
        "is_fwd": false,
        "z_minus": edge,
        "z_plus": edge,
        "prop_q": Q.q,
        "prop_ld": Q.logdensity,
        "prop_grad": Q.grad,
        "omega": zeros,
        "tau": tuple(zK for _ in range(tau_len)),
        "log_sum": torch.full((C,), -torch.inf, **like),
        "steps_tr": zeros_i,
        # adjacent-tree state
        "tree_g0": zeros_i,
        "z": edge,
        "stack": tuple(torch.zeros((max_depth, C, K), **like)
                       for _ in range(tau_len)),
        "omega_adj": zeros,
        "best_score": zeros,
        "best_q": zK,
        "best_ld": zeros,
        "best_grad": zK,
        "lsum_adj": zeros,
        "steps_adj": zeros_i,
    }


def merge_run(stack, node, combine_dir, is_fwd, building, d, to_g: int,
              levels: int, turn_left=None, edge_info=None):
    """The slot's merge run over levels 0..min(TO(g), levels - 1): at each
    level a lane whose run passes it (level < k_l = min(TO(g), d)) merges
    ``node`` with its parked subtree, freezing the node at its first turn;
    a lane still mid-tree parks the node at level k_l (< d). With
    ``turn_left`` (C,) and ``edge_info`` = (n, i_edge, step), the
    InvalidTree left edge of a first turn is recorded as in
    tree_batched._merge_pending. Returns (node, turned, turn_left)."""
    k_l = torch.clamp(d, max=to_g)
    turned = torch.zeros_like(building)
    for level in range(min(to_g, levels - 1) + 1):
        rows = tuple(s[level] for s in stack)
        if level < to_g:
            merged, turning = combine_dir(rows, node, is_fwd)
            do_merge = building & (level < k_l)
            first_turn = do_merge & turning & ~turned
            if turn_left is not None:
                n, i_edge, step = edge_info
                a = n - (1 << (level + 1)) + 1
                turn_left = torch.where(first_turn, i_edge + step * (a + 1),
                                        turn_left)
            turned = turned | first_turn
            keep = ((do_merge & ~turned) | first_turn)[:, None]
            node = tuple(torch.where(keep, mg, nd)
                         for nd, mg in zip(node, merged))
        # a lane still mid-tree parks its node at this level
        do_push = (building & (k_l == level) & (level < d))[:, None]
        for s, nd, row in zip(stack, node, rows):
            s[level] = torch.where(do_push, nd, row)
    return node, turned, turn_left


def make_wavefront_stage_driver(
    ld: LogDensity,
    algorithm: NUTS,
    adaptation,
    pooled_welford: bool = False,
    use_welford: bool = True,
    pooled_eps: bool = False,
    epoch: int = 16,
    noise: Optional[WavefrontNoise] = None,
    mesh=None,
):
    """The wavefront tuning stage:

        stage(generator, metric, carry, n_steps, g_stop=None,
              depth_limit=None, tail_steps=None) -> (carry', all_done)

    runs slots until every lane has completed ``n_steps`` transitions or
    the slot counter reaches ``g_stop``. Each slot draws its randomness
    from ``generator`` for every lane (unless ``noise`` is injected). The
    host reads "every lane done" every ``CHECK_EVERY`` slots; slots past
    the last completion leave every lane and the adaptation as they were,
    and ``carry["g"]`` is set back to the slot count at which the last
    lane finished (the JAX driver's final counter).

    ``pooled_eps`` (a ``PooledStepsize``): completed transitions'
    acceptances accumulate, and one pooled dual-averaging update fires
    every ``epoch`` global slots with the epoch's mean acceptance; each
    transition keeps the eps it started with. ``adaptation`` must then
    not pool over a mesh itself: over ``mesh`` (a ``ChainMesh`` of more
    than one rank) the driver pools the accumulators with one
    ``all_reduce`` per epoch (epoch-lockstep). Per-chain adaptation never
    communicates.

    ``depth_limit`` caps the doublings below ``algorithm.max_depth``
    (tree_batched.depth_cap: None or <= 0 means none); ``tail_steps``
    (None or < 0: the whole stage) applies the cap only to each lane's
    first ``tail_steps`` transitions of the stage."""
    if algorithm.turn_statistic_configuration != "generalized":
        raise NotImplementedError(
            "the wavefront driver supports only the generalized turn statistic"
        )
    max_depth = algorithm.max_depth
    S = max_depth
    lockstep = pooled_eps and mesh is not None and mesh.size > 1

    if use_welford:
        wf_update = (welford_update_pooled_masked if pooled_welford
                     else welford_update_masked)
    else:
        def wf_update(wf, _x, _mask):
            return wf

    def stage(generator, metric: Metric, carry: dict, n_steps: int,
              g_stop: Optional[int] = None, depth_limit=None,
              tail_steps=None):
        ops = make_tau_ops(metric)
        C, K = carry["Q"].q.shape
        dtype, device = carry["Q"].q.dtype, carry["Q"].q.device
        neg_inf = torch.tensor(-torch.inf, dtype=dtype, device=device)
        min_delta = float(algorithm.min_delta)
        dl = depth_cap(depth_limit, max_depth)
        ts = None if tail_steps is None or int(tail_steps) < 0 else int(
            tail_steps)
        lane = torch.arange(C, device=device)
        c = dict(carry)

        def body(g: int):
            """One slot for every lane; returns whether any lane was live
            at its start (0-d, on the device)."""
            lane_live = c["t"] < n_steps
            Q = c["Q"]

            # --- A: restarts: a fresh transition at the current Q --------
            restart = c["need_restart"] & lane_live
            if noise is None:
                p0 = rand_p_b(generator, metric, (C, K), dtype)
                dirs_new = random_directions(generator, C, device)
            else:
                ti = torch.clamp(c["t"], max=noise.p.shape[0] - 1).long()
                p0 = noise.p[ti, lane].to(dtype)
                dirs_new = noise.dirs[ti, lane]
            pi0_new, sp0 = ops.pi_and_psharp(Q.logdensity, p0)
            sp0 = p0 if sp0 is None else sp0
            r = restart
            rc = r[:, None]
            pi0 = torch.where(r, pi0_new, c["pi0"])
            dirs = torch.where(r, dirs_new, c["dirs"])
            eps_l = torch.where(
                r, torch.as_tensor(adaptation.current(c["da"]), dtype=dtype),
                c["eps_l"])
            z0 = _Edge(q=Q.q, p=p0, grad=Q.grad, ld=Q.logdensity)
            z_minus = _where_edge(r, z0, c["z_minus"])
            z_plus = _where_edge(r, z0, c["z_plus"])
            prop_q = torch.where(rc, Q.q, c["prop_q"])
            prop_ld = torch.where(r, Q.logdensity, c["prop_ld"])
            prop_grad = torch.where(rc, Q.grad, c["prop_grad"])
            omega = torch.where(r, 0.0, c["omega"])
            tau = tuple(torch.where(rc, new, old)
                        for old, new in zip(c["tau"], ops.leaf_tau(p0, sp0)))
            log_sum = torch.where(r, neg_inf, c["log_sum"])
            steps_tr = torch.where(r, 0, c["steps_tr"])
            d = torch.where(r, 0, c["d"])
            waiting = c["waiting"] | restart

            # --- B: aligned tree starts ------------------------------------
            aligned = (g & ((1 << d) - 1)) == 0
            start = waiting & lane_live & aligned
            is_fwd = torch.where(start, ((dirs >> d) & 1) == 1, c["is_fwd"])
            z = _where_edge(start, _where_edge(is_fwd, z_plus, z_minus),
                            c["z"])
            tree_g0 = torch.where(start, g, c["tree_g0"])
            omega_adj = torch.where(start, neg_inf, c["omega_adj"])
            best_score = torch.where(start, neg_inf, c["best_score"])
            lsum_adj = torch.where(start, neg_inf, c["lsum_adj"])
            steps_adj = torch.where(start, 0, c["steps_adj"])
            building = (c["building"] | start) & lane_live
            waiting = waiting & ~start

            # --- C: one leaf for every lane, kept for the building ones ----
            eps_signed = torch.where(is_fwd, eps_l, -eps_l)
            z_new, pi, sp = _leaf(ld, metric, ops, z, eps_signed)
            sp = z_new.p if sp is None else sp
            z = _where_edge(building, z_new, z)
            delta = pi - pi0
            divergent = building & (delta < min_delta)
            lsum_adj = torch.logaddexp(
                lsum_adj,
                torch.where(building, torch.clamp(delta, max=0.0), neg_inf))
            steps_adj = steps_adj + building.to(torch.int32)
            if noise is None:
                gum = gumbel_like(generator, (C,), dtype, device)
            else:
                di = torch.clamp(d, max=noise.gumbel.shape[1] - 1).long()
                ni = torch.clamp(g - tree_g0, 0,
                                 noise.gumbel.shape[2] - 1).long()
                gum = noise.gumbel[ti, di, ni, lane].to(dtype)
            dead = divergent | ~building
            score = torch.where(dead, neg_inf, delta + gum)
            take = score > best_score
            tk = take[:, None]
            best_score = torch.where(take, score, best_score)
            best_q = torch.where(tk, z_new.q, c["best_q"])
            best_ld = torch.where(take, z_new.ld, c["best_ld"])
            best_grad = torch.where(tk, z_new.grad, c["best_grad"])
            omega_adj = torch.logaddexp(omega_adj,
                                        torch.where(dead, neg_inf, delta))

            # --- D: the merge run over the levels of TO(g) ------------------
            to_g = _trailing_ones(g)
            node, turned, _ = merge_run(
                c["stack"], ops.leaf_tau(z_new.p, sp), ops.combine_dir,
                is_fwd, building, d, to_g, S)
            k_l = torch.clamp(d, max=to_g)

            # --- E: completions ----------------------------------------------
            invalid = building & (divergent | turned)
            tree_done = building & (k_l == d) & ~invalid
            finished = invalid | tree_done
            building = building & ~finished
            log_sum = torch.where(finished, torch.logaddexp(log_sum, lsum_adj),
                                  log_sum)
            steps_tr = torch.where(finished, steps_tr + steps_adj, steps_tr)
            lsum_adj = torch.where(finished, neg_inf, lsum_adj)
            steps_adj = torch.where(finished, 0, steps_adj)
            z_plus = _where_edge(tree_done & is_fwd, z_new, z_plus)
            z_minus = _where_edge(tree_done & ~is_fwd, z_new, z_minus)

            # the biased doubling combine of completed valid trees
            lp2 = omega_adj - omega
            if noise is None:
                e_dbl = exponential_like(generator, (C,), dtype, device)
            else:
                e_dbl = noise.expo[ti, di, lane].to(dtype)
            take2 = tree_done & ((lp2 >= 0) | (e_dbl > -lp2))
            t2 = take2[:, None]
            prop_q = torch.where(t2, best_q, prop_q)
            prop_ld = torch.where(take2, best_ld, prop_ld)
            prop_grad = torch.where(t2, best_grad, prop_grad)
            omega = torch.where(tree_done, torch.logaddexp(omega, omega_adj),
                                omega)
            tau_c, turning_tr = ops.combine_dir(tau, node, is_fwd)
            turning_tr = tree_done & turning_tr
            keep = (tree_done & ~turning_tr)[:, None]
            tau = tuple(torch.where(keep, new, old)
                        for old, new in zip(tau, tau_c))
            d = torch.where(tree_done, d + 1, d)
            if ts is None:
                hit_max = tree_done & ~turning_tr & (d >= dl)
            else:
                dl_eff = torch.where(c["t"] < ts, dl, max_depth)
                hit_max = tree_done & ~turning_tr & (d >= dl_eff)
            tr_done = invalid | turning_tr | hit_max
            waiting = waiting | (tree_done & ~turning_tr & ~hit_max)

            # --- F: bookkeeping at each lane's transition completion -------
            acc_rate = acceptance_rate(AcceptanceStatistic(log_sum, steps_tr))
            any_live = lane_live.any()
            da = c["da"]
            acc_ep_sum, acc_ep_n = c["acc_ep_sum"], c["acc_ep_n"]
            if pooled_eps:
                acc_ep_sum = acc_ep_sum + torch.where(tr_done, acc_rate,
                                                      0.0).sum()
                acc_ep_n = acc_ep_n + tr_done.to(dtype).sum()
                if not lockstep and (g + 1) % epoch == 0:
                    # the JAX loop runs no slot once every lane is done
                    fire = (acc_ep_n > 0) & any_live
                    da = select_state(fire, adaptation.update(
                        da, acc_ep_sum / torch.clamp(acc_ep_n, min=1.0)), da)
                    acc_ep_sum = torch.where(fire, 0.0, acc_ep_sum)
                    acc_ep_n = torch.where(fire, 0.0, acc_ep_n)
            else:
                da = select_state(tr_done, adaptation.update(da, acc_rate), da)
            td = tr_done[:, None]
            Q = EvaluatedPoint(
                q=torch.where(td, prop_q, Q.q),
                logdensity=torch.where(tr_done, prop_ld, Q.logdensity),
                grad=torch.where(td, prop_grad, Q.grad))
            c.update(
                t=c["t"] + tr_done.to(torch.int32),
                need_restart=(c["need_restart"] & ~restart) | tr_done,
                waiting=waiting, building=building, da=da,
                wf=wf_update(c["wf"], Q.q, tr_done),
                acc_sum=c["acc_sum"] + torch.where(tr_done, acc_rate, 0.0),
                div=c["div"] + (invalid & divergent).to(torch.int32),
                steps_total=c["steps_total"] + torch.where(tr_done, steps_tr,
                                                           0),
                maxd=c["maxd"] + hit_max.to(torch.int32),
                acc_ep_sum=acc_ep_sum, acc_ep_n=acc_ep_n, Q=Q, eps_l=eps_l,
                dirs=dirs, pi0=pi0, d=d, is_fwd=is_fwd, z_minus=z_minus,
                z_plus=z_plus, prop_q=prop_q, prop_ld=prop_ld,
                prop_grad=prop_grad, omega=omega, tau=tau, log_sum=log_sum,
                steps_tr=steps_tr, tree_g0=tree_g0, z=z,
                omega_adj=omega_adj, best_score=best_score, best_q=best_q,
                best_ld=best_ld, best_grad=best_grad, lsum_adj=lsum_adj,
                steps_adj=steps_adj)
            return any_live

        def live() -> bool:
            return host_bool("wavefront_live", (c["t"] < n_steps).any())

        def run_slots(g: int, g_end_at: int, g_last):
            """Slots g..g_end_at - 1, stopping early once every lane is
            done (read every ``CHECK_EVERY`` slots); returns the next slot
            and the device count of slots up to the last live one."""
            global slots_run
            while g < g_end_at:
                any_live = body(g)
                slots_run += 1
                g += 1
                g_last = torch.where(any_live, g, g_last)
                if g % CHECK_EVERY == 0 and not live():
                    break
            return g, g_last

        def finish():
            """(carry', every lane done); counts the call's leapfrog steps."""
            global lane_steps
            lane_steps += int((c["steps_total"] - carry["steps_total"]).sum())
            return c, not live()

        stop = 1 << 62 if g_stop is None else int(g_stop)
        g = int(c["g"])
        g_last = torch.tensor(g, dtype=torch.int64, device=device)
        if not lockstep:
            if live():
                g, g_last = run_slots(g, stop, g_last)
                g = int(g_last) if not live() else g
            c["g"] = g
            return finish()

        # --- pooled eps over a mesh: epoch-lockstep ------------------------
        from .parallel.mesh import all_sum

        gdone = float(all_sum(torch.tensor(float(live()), dtype=dtype,
                                           device=device), mesh)) == 0
        while g < stop and not gdone:
            epoch_end = min((g // epoch + 1) * epoch, stop)
            if live():
                g, g_last = run_slots(g, epoch_end, g_last)
            # a rank whose lanes are done skips to the boundary: its slots
            # would change nothing, and every rank meets the collective
            g = epoch_end
            pooled = all_sum(torch.stack([
                c["acc_ep_sum"], c["acc_ep_n"],
                torch.tensor(float(live()), dtype=dtype, device=device)]),
                mesh)
            if g % epoch == 0:
                fire = pooled[1] > 0
                c["da"] = select_state(fire, adaptation.update(
                    c["da"], pooled[0] / torch.clamp(pooled[1], min=1.0)),
                    c["da"])
                c["acc_ep_sum"] = torch.where(fire, 0.0, c["acc_ep_sum"])
                c["acc_ep_n"] = torch.where(fire, 0.0, c["acc_ep_n"])
            gdone = float(pooled[2]) == 0
        c["g"] = g
        return finish()

    return stage
