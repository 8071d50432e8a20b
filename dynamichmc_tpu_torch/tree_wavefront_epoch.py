"""Epoch wavefront driver for the sampling phase (port of
``dynamichmc_tpu.tree_wavefront_epoch``).

The lanes run desynchronized transition lifecycles with the wavefront's
aligned starts (tree_wavefront.py), and every completed transition is a
draw. The slot schedule is the JAX driver's 8-slot epoch: the global slot
``g`` advances by 8 per epoch, and each sub-slot r = g mod 8 has its own
work:

    r:      0  1  2  3  4  5  6  7
    TO(g):  0  1  0  2  0  1  0  >=3

- restarts (the momentum draw, the joint density, the proposal reset) and
  the draw counters' bookkeeping run only at sub-slots 0 and 4, so a
  finished lane waits 0-3 slots to restart;
- completion bookkeeping (the doubling combine, the turn check of the
  whole trajectory, each draw's statistics) runs only at odd sub-slots: a
  depth-d >= 1 adjacent tree can only finish at a slot with TO(g) >= d
  (odd), and a depth-0 tree finished at an even slot would wait for its
  next doubling's alignment anyway; its one-leaf turn statistic is rebuilt
  from the leaf's momentum kept in ``z.p`` and ``sp_last``;
- the merge run covers the levels of TO(g), which only r = 7 leaves
  unbounded.

These decide which slots each lane uses, so the slot counts (the final
``g``, each draw's ``work``) are the JAX driver's for the same noise. Here
``g`` and TO(g) are host integers: no slot reads the device.

``ring`` limits how far a lane may run ahead of the slowest: a lane may
restart only while its draw count is less than ``ring`` ahead of the
draws every lane has passed (``flushed``, which grows by at most one at
each record sub-slot, as in the JAX driver). The JAX driver also stages
the draws in a ring of that many rows and flushes one row at a time with
masked writes (TPU workarounds); here each completed draw is written
straight into the (C, T + 1, ...) outputs with one indexed store per
field, the lanes that finished nothing writing to the spare row T. The
draws are the same for every ring >= 2.

Per-transition semantics are the lockstep driver's (tree_batched.py),
draw for draw under injected noise (``EpochNoise``, indexed by each lane's
own transition, doubling and leaf). In production the randomness is
drawn per slot for every lane at once, so a lane's numbers depend on the
slots it uses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .hamiltonian import EvaluatedPoint
from .logdensity import LogDensity
from .metric import Metric
from .nuts import NUTS, AcceptanceStatistic, TreeStatistics, acceptance_rate
from .tree import exponential_like, gumbel_like, normalize_termination
from .tree_batched import (
    _Edge,
    _leaf,
    _where_edge,
    make_tau_ops,
    rand_p_b,
    random_directions,
)
from .tree_wavefront import _trailing_ones, merge_run

EPOCH = 8
# trailing ones of g at each sub-slot residue (mod 8); None: >= 3, from g
_TO_TABLE = (0, 1, 0, 2, 0, 1, 0, None)
_RESTART_SLOTS = (0, 4)
CHECK_EPOCHS = 2  # epochs between two reads of "every draw taken"

slots_run = 0  # slots executed since the last reset


def reset_slots_run() -> None:
    global slots_run
    slots_run = 0


class EpochNoise(NamedTuple):
    """Injected randomness (tests), indexed by each lane's own transition
    t, doubling d and leaf n, as ``tree_wavefront.WavefrontNoise``."""

    p: torch.Tensor  # (T, C, K) restart momenta
    dirs: torch.Tensor  # (T, C) direction bits (int32 bit patterns)
    gumbel: torch.Tensor  # (T, max_depth, 2**(max_depth-1), C)
    expo: torch.Tensor  # (T, max_depth, C)


# each draw's (C, T + 1) outputs beside out_q: floats, then int32
_FLOAT_OUTPUTS = ("ld", "pi", "acc")
_INT_OUTPUTS = ("depth", "steps", "tl", "tr", "work", "dirs")


def epoch_sampling_init(Q: EvaluatedPoint, metric: Metric, n_samples: int,
                        max_depth: int, ring: int = 8) -> dict:
    """A fresh sampling carry: every lane flagged for restart, the outputs
    (C, n_samples + 1, ...) with the spare row last. ``ring`` is the
    driver's (make_epoch_sampling_driver) and sizes nothing here."""
    C, K = Q.q.shape
    T = n_samples
    like = dict(dtype=Q.q.dtype, device=Q.q.device)
    i32 = dict(dtype=torch.int32, device=Q.q.device)
    tau_len = make_tau_ops(metric).tau_len
    zeros = torch.zeros((C,), **like)
    zeros_i = torch.zeros((C,), **i32)
    false = torch.zeros((C,), dtype=torch.bool, device=Q.q.device)
    zK = torch.zeros((C, K), **like)
    edge = _Edge(q=Q.q, p=zK, grad=Q.grad, ld=Q.logdensity)
    carry = {
        "g": 0,
        "t": zeros_i,
        "rec": zeros_i,
        "flushed": torch.zeros((), **i32),
        "need_restart": torch.ones((C,), dtype=torch.bool, device=Q.q.device),
        "waiting": false,
        "building": false,
        "pending_done": false,
        "pending_inv": false,
        # transition state
        "Q": Q,
        "dirs": zeros_i,
        "pi0": zeros,
        "d": zeros_i,
        "is_fwd": false,
        "z_minus": edge,
        "z_plus": edge,
        "i_minus": zeros_i,
        "i_plus": zeros_i,
        "prop_q": Q.q,
        "prop_ld": Q.logdensity,
        "prop_grad": Q.grad,
        "prop_pi": zeros,
        "omega": zeros,
        "tau": tuple(zK for _ in range(tau_len)),
        "log_sum": torch.full((C,), -torch.inf, **like),
        "steps_tr": zeros_i,
        "g_restart": zeros_i,
        # adjacent-tree state
        "tree_g0": zeros_i,
        "i_edge": zeros_i,
        "i_cur": zeros_i,
        "z": edge,
        "sp_last": zK,
        "omega_adj": zeros,
        "best_score": zeros,
        "best_q": zK,
        "best_ld": zeros,
        "best_grad": zK,
        "best_pi": zeros,
        "lsum_adj": zeros,
        "steps_adj": zeros_i,
        "inv_left": zeros_i,
        "inv_right": zeros_i,
        "stack": tuple(torch.zeros((max_depth, C, K), **like)
                       for _ in range(tau_len)),
        "out_q": torch.zeros((C, T + 1, K), **like),
    }
    for name in _FLOAT_OUTPUTS + _INT_OUTPUTS:
        carry["out_" + name] = torch.zeros(
            (C, T + 1), **(i32 if name in _INT_OUTPUTS else like))
    return carry


def epoch_sampling_finish(carry: dict, n_samples: int):
    """(Q', positions (C, T, K), logdensities (C, T), per-draw
    TreeStatistics (C, T)) from a finished carry, the lockstep sampler's
    output layout."""
    T = n_samples

    def out(name):
        return carry["out_" + name][:, :T].contiguous()

    tl, tr = normalize_termination(out("tl"), out("tr"))
    stats = TreeStatistics(
        logdensity=out("pi"), depth=out("depth"), term_left=tl,
        term_right=tr, acceptance_rate=out("acc"), steps=out("steps"),
        directions=out("dirs"), work=out("work"))
    return carry["Q"], out("q"), out("ld"), stats


def make_epoch_sampling_driver(ld: LogDensity, algorithm: NUTS,
                               n_samples: int, ring: int = 8,
                               noise: Optional[EpochNoise] = None):
    """The epoch sampling loop:

        stage(generator, metric, eps, carry, g_stop=None) -> (carry', done)

    runs 8-slot epochs until every lane's ``n_samples`` draws are taken
    (read to the host every ``CHECK_EPOCHS`` epochs; epochs past the end
    change no draw) or ``g`` reaches ``g_stop``; ``carry["g"]`` is then the
    JAX driver's final counter. ``eps`` is the fixed (C,) or scalar
    stepsize."""
    if algorithm.turn_statistic_configuration != "generalized":
        raise NotImplementedError(
            "the epoch wavefront driver supports only the generalized "
            "turn statistic"
        )
    S = algorithm.max_depth
    T = n_samples
    if ring < 2:
        raise ValueError("ring must be >= 2")

    def stage(generator, metric: Metric, eps, carry: dict,
              g_stop: Optional[int] = None):
        global slots_run
        ops = make_tau_ops(metric)
        carry_psharp = ops.tau_len == 5
        C, K = carry["Q"].q.shape
        dtype, device = carry["Q"].q.dtype, carry["Q"].q.device
        neg_inf = torch.tensor(-torch.inf, dtype=dtype, device=device)
        min_delta = float(algorithm.min_delta)
        eps_b = torch.as_tensor(eps, dtype=dtype, device=device).expand(C)
        lane = torch.arange(C, device=device)
        c = dict(carry)

        def counters():
            """Each lane's (transition, doubling) for the injected noise,
            clamped: idle lanes hold stale counters."""
            ti = torch.clamp(c["t"], max=noise.p.shape[0] - 1).long()
            di = torch.clamp(c["d"], max=noise.expo.shape[1] - 1).long()
            return ti, di

        def restart_and_record(g: int):
            """Sub-slots 0 and 4: count each lane's parked draw, pass one
            more draw if every lane has, then restart every lane whose
            draw count leaves room in the ring."""
            rec = torch.where(c["t"] > c["rec"], c["rec"] + 1, c["rec"])
            flushed = c["flushed"]
            flushed = torch.where(flushed < rec.min(), flushed + 1, flushed)
            restart = (c["need_restart"] & (c["t"] < T)
                       & (c["t"] - flushed < ring))
            Q = c["Q"]
            if noise is None:
                p0 = rand_p_b(generator, metric, (C, K), dtype)
                dirs_new = random_directions(generator, C, device)
            else:
                ti, _di = counters()
                p0 = noise.p[ti, lane].to(dtype)
                dirs_new = noise.dirs[ti, lane]
            pi0_new, sp0 = ops.pi_and_psharp(Q.logdensity, p0)
            sp0 = p0 if sp0 is None else sp0
            r = restart
            rc = r[:, None]
            z0 = _Edge(q=Q.q, p=p0, grad=Q.grad, ld=Q.logdensity)
            c.update(
                rec=rec, flushed=flushed,
                need_restart=c["need_restart"] & ~restart,
                waiting=c["waiting"] | restart,
                pi0=torch.where(r, pi0_new, c["pi0"]),
                dirs=torch.where(r, dirs_new, c["dirs"]),
                d=torch.where(r, 0, c["d"]),
                z_minus=_where_edge(r, z0, c["z_minus"]),
                z_plus=_where_edge(r, z0, c["z_plus"]),
                i_minus=torch.where(r, 0, c["i_minus"]),
                i_plus=torch.where(r, 0, c["i_plus"]),
                prop_q=torch.where(rc, Q.q, c["prop_q"]),
                prop_ld=torch.where(r, Q.logdensity, c["prop_ld"]),
                prop_grad=torch.where(rc, Q.grad, c["prop_grad"]),
                prop_pi=torch.where(r, pi0_new, c["prop_pi"]),
                omega=torch.where(r, 0.0, c["omega"]),
                tau=tuple(torch.where(rc, new, old) for old, new in
                          zip(c["tau"], ops.leaf_tau(p0, sp0))),
                log_sum=torch.where(r, neg_inf, c["log_sum"]),
                steps_tr=torch.where(r, 0, c["steps_tr"]),
                g_restart=torch.where(r, g, c["g_restart"]))

        def tree_starts(g: int):
            """Aligned adjacent-tree starts (every sub-slot)."""
            d = c["d"]
            start = c["waiting"] & ((g & ((1 << d) - 1)) == 0)
            is_fwd = torch.where(start, ((c["dirs"] >> d) & 1) == 1,
                                 c["is_fwd"])
            edge = _where_edge(is_fwd, c["z_plus"], c["z_minus"])
            i_e = torch.where(is_fwd, c["i_plus"], c["i_minus"])
            c.update(
                is_fwd=is_fwd, z=_where_edge(start, edge, c["z"]),
                i_edge=torch.where(start, i_e, c["i_edge"]),
                tree_g0=torch.where(start, g, c["tree_g0"]),
                omega_adj=torch.where(start, neg_inf, c["omega_adj"]),
                best_score=torch.where(start, neg_inf, c["best_score"]),
                lsum_adj=torch.where(start, neg_inf, c["lsum_adj"]),
                steps_adj=torch.where(start, 0, c["steps_adj"]),
                building=c["building"] | start,
                waiting=c["waiting"] & ~start)

        def leaf(g: int, stash_sp: bool):
            """One leaf for every lane, kept for the building ones, with
            the proposal and visited bookkeeping. ``stash_sp`` (even
            sub-slots): keep M^-1 p of the leaf for a depth-0 completion
            processed at the next odd sub-slot."""
            building, is_fwd = c["building"], c["is_fwd"]
            z_new, pi, sp = _leaf(ld, metric, ops, c["z"],
                                  torch.where(is_fwd, eps_b, -eps_b))
            n = g - c["tree_g0"]
            step = torch.where(is_fwd, 1, -1).to(torch.int32)
            i_new = c["i_edge"] + step * (n + 1)
            delta = pi - c["pi0"]
            divergent = building & (delta < min_delta)
            if noise is None:
                gum = gumbel_like(generator, (C,), dtype, device)
            else:
                ti, di = counters()
                ni = torch.clamp(n, 0, noise.gumbel.shape[2] - 1).long()
                gum = noise.gumbel[ti, di, ni, lane].to(dtype)
            dead = divergent | ~building
            score = torch.where(dead, neg_inf, delta + gum)
            take = score > c["best_score"]
            tk = take[:, None]
            c.update(
                z=_where_edge(building, z_new, c["z"]),
                i_cur=torch.where(building, i_new, c["i_cur"]),
                lsum_adj=torch.logaddexp(c["lsum_adj"], torch.where(
                    building, torch.clamp(delta, max=0.0), neg_inf)),
                steps_adj=c["steps_adj"] + building.to(torch.int32),
                best_score=torch.where(take, score, c["best_score"]),
                best_q=torch.where(tk, z_new.q, c["best_q"]),
                best_ld=torch.where(take, z_new.ld, c["best_ld"]),
                best_grad=torch.where(tk, z_new.grad, c["best_grad"]),
                best_pi=torch.where(take, pi, c["best_pi"]),
                omega_adj=torch.logaddexp(c["omega_adj"],
                                          torch.where(dead, neg_inf, delta)))
            if carry_psharp and stash_sp:
                c["sp_last"] = torch.where(building[:, None], sp,
                                           c["sp_last"])
            return z_new, (z_new.p if sp is None else sp), n, i_new, step, \
                divergent

        def complete(to_g: int, z_new, sp, n, i_new, step, divergent):
            """The merge run, then flag invalid and completed adjacent
            trees and fold their visited statistics into the transition.
            Returns (the merged node, the trees completed now)."""
            building, d = c["building"], c["d"]
            node, turned, turn_left = merge_run(
                c["stack"], ops.leaf_tau(z_new.p, sp), ops.combine_dir,
                c["is_fwd"], building, d, to_g, S,
                turn_left=torch.zeros_like(d),
                edge_info=(n, c["i_edge"], step))
            k_l = torch.clamp(d, max=to_g)
            invalid = building & (divergent | turned)
            tree_done = building & (k_l == d) & ~(divergent | turned)
            finished = invalid | tree_done
            left = torch.where(divergent, i_new, turn_left)
            c.update(
                building=building & ~finished,
                pending_done=c["pending_done"] | tree_done,
                pending_inv=c["pending_inv"] | invalid,
                log_sum=torch.where(
                    finished, torch.logaddexp(c["log_sum"], c["lsum_adj"]),
                    c["log_sum"]),
                steps_tr=torch.where(finished, c["steps_tr"] + c["steps_adj"],
                                     c["steps_tr"]),
                lsum_adj=torch.where(finished, neg_inf, c["lsum_adj"]),
                steps_adj=torch.where(finished, 0, c["steps_adj"]),
                inv_left=torch.where(invalid, left, c["inv_left"]),
                inv_right=torch.where(invalid, i_new, c["inv_right"]))
            return node, tree_done

        def process(g: int, node, now_done):
            """Odd sub-slots: the doubling combine, the trajectory's turn
            check and, for each finished transition, its draw. A tree
            pending from the even sub-slot before is a depth-0 one: its
            node is rebuilt from the kept leaf momentum."""
            proc_done, proc_inv, is_fwd = (c["pending_done"],
                                           c["pending_inv"], c["is_fwd"])
            zp = c["z"].p
            pend = ((zp, zp, zp, c["sp_last"], c["sp_last"]) if carry_psharp
                    else (zp, zp, zp))
            wp = (proc_done & ~now_done)[:, None]
            node = tuple(torch.where(wp, pn, nd) for pn, nd in zip(pend, node))
            fwd_done, bwd_done = proc_done & is_fwd, proc_done & ~is_fwd
            z_plus = _where_edge(fwd_done, c["z"], c["z_plus"])
            z_minus = _where_edge(bwd_done, c["z"], c["z_minus"])
            i_plus = torch.where(fwd_done, c["i_cur"], c["i_plus"])
            i_minus = torch.where(bwd_done, c["i_cur"], c["i_minus"])
            lp2 = c["omega_adj"] - c["omega"]
            if noise is None:
                e_dbl = exponential_like(generator, (C,), dtype, device)
            else:
                ti, di = counters()
                e_dbl = noise.expo[ti, di, lane].to(dtype)
            take = proc_done & ((lp2 >= 0) | (e_dbl > -lp2))
            tk = take[:, None]
            prop_q = torch.where(tk, c["best_q"], c["prop_q"])
            prop_ld = torch.where(take, c["best_ld"], c["prop_ld"])
            prop_grad = torch.where(tk, c["best_grad"], c["prop_grad"])
            prop_pi = torch.where(take, c["best_pi"], c["prop_pi"])
            omega = torch.where(proc_done,
                                torch.logaddexp(c["omega"], c["omega_adj"]),
                                c["omega"])
            tau_c, turning_tr = ops.combine_dir(c["tau"], node, is_fwd)
            turning_tr = proc_done & turning_tr
            keep = (proc_done & ~turning_tr)[:, None]
            tau = tuple(torch.where(keep, new, old)
                        for old, new in zip(c["tau"], tau_c))
            d = torch.where(proc_done, c["d"] + 1, c["d"])
            hit_max = proc_done & ~turning_tr & (d >= S)
            tr_done = proc_inv | turning_tr | hit_max
            waiting = c["waiting"] | (proc_done & ~turning_tr & ~hit_max)

            # each finished transition's draw, at its row of the outputs
            row = torch.where(tr_done, c["t"], T)
            values = {
                "q": prop_q, "ld": prop_ld, "pi": prop_pi,
                "acc": acceptance_rate(AcceptanceStatistic(c["log_sum"],
                                                           c["steps_tr"])),
                "depth": d, "steps": c["steps_tr"],
                "tl": torch.where(proc_inv, c["inv_left"],
                                  torch.where(turning_tr, i_minus, 1)),
                "tr": torch.where(proc_inv, c["inv_right"],
                                  torch.where(turning_tr, i_plus, 0)),
                "work": g - c["g_restart"] + 1, "dirs": c["dirs"]}
            for name, value in values.items():
                out = c["out_" + name]
                out[lane, row] = value.to(out.dtype)
            td = tr_done[:, None]
            Q = c["Q"]
            c.update(
                pending_done=torch.zeros_like(proc_done),
                pending_inv=torch.zeros_like(proc_done),
                z_minus=z_minus, z_plus=z_plus, i_minus=i_minus,
                i_plus=i_plus, prop_q=prop_q, prop_ld=prop_ld,
                prop_grad=prop_grad, prop_pi=prop_pi, omega=omega, tau=tau,
                d=d, waiting=waiting & ~tr_done,
                need_restart=c["need_restart"] | tr_done,
                t=c["t"] + tr_done.to(torch.int32),
                Q=EvaluatedPoint(
                    q=torch.where(td, prop_q, Q.q),
                    logdensity=torch.where(tr_done, prop_ld, Q.logdensity),
                    grad=torch.where(td, prop_grad, Q.grad)))

        def sub_slot(g: int, r: int):
            if r in _RESTART_SLOTS:
                restart_and_record(g)
            tree_starts(g)
            leaf_out = leaf(g, stash_sp=r % 2 == 0)
            to_g = _TO_TABLE[r] if _TO_TABLE[r] is not None else \
                _trailing_ones(g)
            node, now_done = complete(to_g, *leaf_out)
            if r % 2 == 1:
                process(g, node, now_done)

        stop = 1 << 62 if g_stop is None else int(g_stop)
        g = int(c["g"])
        g_last = torch.tensor(g, dtype=torch.int64, device=device)
        epochs = 0
        done = int(c["flushed"]) >= T
        while g < stop and not done:
            live = c["flushed"] < T  # the JAX loop's condition, on the device
            for r in range(EPOCH):
                sub_slot(g + r, r)
            slots_run += EPOCH
            g += EPOCH
            g_last = torch.where(live, g, g_last)
            epochs += 1
            if epochs % CHECK_EPOCHS == 0:
                done = int(c["flushed"]) >= T
        done = int(c["flushed"]) >= T
        c["g"] = int(g_last) if done else g
        return c, done

    return stage
