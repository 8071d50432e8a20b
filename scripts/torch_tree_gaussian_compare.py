#!/usr/bin/env python3
"""Time the port's Gaussian tree kernel and run phase 3's rule over seeds,
for the package of any checkout.

    python3 scripts/torch_tree_gaussian_compare.py [--root DIR]

``--root`` names the checkout whose ``dynamichmc_tpu_torch`` is imported
(default: this one), so that one call can hold this tree's kernel beside
another commit's unpacked with ``git archive``. The inputs, timing and
bound come from this checkout's ``chip_smoke.py``, the leaf of each
proposal from its ``ops/proposal_leaf.py``. Needs CUDA. Prints one JSON
line per measurement.

1. ``time``: ms per call of ``tree_kernel.tree_transition`` (CUDA events,
   50 calls after a warm-up call, as in chip_smoke's phase 5) on 4096
   chains of correlated_gaussian(K), max_depth 4, for K = 100 and 129
   (either side of the warp variant's limit) with a dense and a diagonal
   metric, beside the fp32 bound of the leaves the chains executed.
2. ``seed``: for seeds 1..8, at K = 100 with a dense metric, a diagonal
   one and dcap 2, the kernel against the plain float32 and float64
   versions: the chains whose depth, steps or termination differ, the
   chains whose proposal lies on another leaf of the trajectory, and
   whether phase 3's rule passes without the leaf in its matching mask
   (chip_smoke before it held the leaf) and with it.
3. ``flip``: for each chain where only the leaf differs between the kernel
   and the plain float32 version, the three versions' leaves (signed step
   offsets) and the float64 witness: the margin of the decision that
   separates the kernel's leaf from the plain version's, computed from the
   float64 trajectory and the injected noise. For two leaves of one
   doubling it is the gap of their Gumbel scores (delta + G); across
   doublings, that of the later doubling's biased combine
   (Exponential + log weight ratio). A margin at the float32 rounding of
   pi (``f32_pi_err``: the plain versions' |pi' difference| where both
   chose the same leaf) marks a tie that rounding may break either way.
"""

import argparse
import importlib.util
import json
import math
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, MD, N_TIME, SEEDS = 4096, 4, 50, 8
chip = None  # this checkout's chip_smoke.py, loaded by main()


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def leaf_rule(out, ref, ref64, leaves, with_leaf):
    """Phase 3's rule (chip_smoke.compare_kernel_plain without its repeat
    check), with or without the proposal's leaf in the matching masks:
    the messages of the gates that fail."""
    leaf_k, leaf_32, leaf_64 = leaves
    same = torch.ones_like(leaf_k, dtype=torch.bool)
    if with_leaf:
        same &= leaf_k == leaf_32
    for stat in ("depth", "steps", "term_left", "term_right"):
        same &= out[stat] == ref[stat]
    fails = []
    if float(same.float().mean()) < 0.999:
        fails.append(f"match {float(same.float().mean()):.4%}")
    both = same & (leaf_64 == leaf_32) if with_leaf else same
    for stat in ("depth", "steps", "term_left", "term_right"):
        both &= ref64[stat] == ref[stat]
    rel = chip._rel_err
    ld = float(rel(out["prop_ld"][same], ref["prop_ld"][same]).max())
    if ld > 1e-4:
        fails.append(f"ld' {ld:.3g}")
    for name in ("prop_q", "prop_grad", "prop_ld", "log_sum"):
        x, y, z = out[name][both], ref[name][both], ref64[name][both]
        err_k, err_p = float(rel(x, z).max()), float(rel(y, z).max())
        if err_k > 2 * err_p + 1e-5:
            fails.append(f"{name} {err_k:.3g} vs plain {err_p:.3g}")
    return fails


def doubling_of(offset, dirs, depth):
    """(d, n) of a leaf's signed offset: doubling d extends the trajectory
    by 2^d leaves in the direction of bit d of ``dirs``, n counts outward;
    (-1, 0) for the start, (depth, 0) for a leaf of no valid doubling."""
    fwd = bwd = 0
    for d in range(depth):
        if (dirs >> d) & 1:
            if fwd < offset <= fwd + (1 << d):
                return d, offset - fwd - 1
            fwd += 1 << d
        else:
            if -bwd - (1 << d) <= offset < -bwd:
                return d, -offset - bwd - 1
            bwd += 1 << d
    return (-1, 0) if offset == 0 else (depth, 0)


def flip_witness(args, c, leaves, delta, depth):
    """The float64 margin of the decision between the kernel's leaf and the
    plain float32 version's on chain c (see the module's docstring)."""
    dirs = int(args[5][c]) & 0xFFFFFFFF
    gum, expo, min_delta = args[6], args[7], args[11]
    a, b = (int(x[c]) for x in leaves[:2])
    (da, na), (db, nb) = doubling_of(a, dirs, depth), doubling_of(b, dirs, depth)
    live = lambda j: delta[j][c] >= min_delta  # noqa: E731
    if da == db:
        score = lambda j, d, n: (delta[j][c] + gum[(1 << d) - 1 + n, c])  # noqa: E731
        return "gumbel", abs(float(score(a, da, na) - score(b, db, nb)))
    d = max(da, db)
    old = [j for j in delta if doubling_of(j, dirs, depth)[0] < d and live(j)]
    new = [j for j in delta if doubling_of(j, dirs, depth)[0] == d and live(j)]
    lse = lambda js: float(torch.logsumexp(torch.stack([delta[j][c] for j in js]), 0))  # noqa: E731
    lp2 = lse(new) - lse(old) if new else -math.inf
    return "combine", abs(float(expo[d, c]) + lp2)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    opts = parser.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    global chip
    chip = load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    proposal = load("proposal_leaf", os.path.join(
        HERE, "dynamichmc_tpu_torch", "ops", "proposal_leaf.py"))
    from dynamichmc_tpu_torch.models import correlated_gaussian
    from dynamichmc_tpu_torch.ops import tree_kernel

    dev = torch.device("cuda", 0)
    smi = chip.nvidia_smi_line()
    tree_kernel.library.build()
    tag = {"root": os.path.relpath(root, HERE), "gpu": smi}
    models = {K: correlated_gaussian(K, dtype=torch.float32, device=dev,
                                     tree_kernel=True) for K in (100, 129)}
    gen = torch.Generator(device=dev).manual_seed(0)
    for K, model in models.items():
        for kind in ("dense", "diag"):
            args = chip.kernel_inputs(model, C, MD, kind, MD, gen)
            ms = chip.time_call(tree_kernel.tree_transition, args, N_TIME)
            bound_ms, bound_by = chip.tree_kernel_bound(args)
            print(json.dumps({"time": [C, K, MD, kind], "ms": ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              **tag}), flush=True)

    totals = {"checks": 0, "fail_without_leaf": 0, "fail_with_leaf": 0}
    for seed in range(1, SEEDS + 1):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for kind, dcap in (("dense", MD), ("diag", MD), ("dense", 2)):
            args = chip.kernel_inputs(models[100], C, MD, kind, dcap, gen)
            out = tree_kernel.tree_transition(*args)
            ref = tree_kernel.tree_transition_plain(*args)
            ref64 = tree_kernel.tree_transition_plain(*chip._as64(args))
            vg = args[9].value_and_grad
            leaves = proposal.proposal_offsets(
                *args[:5], args[8], vg, dcap,
                [out["prop_q"], ref["prop_q"], ref64["prop_q"]])
            discrete = torch.zeros(C, dtype=torch.bool, device=dev)
            for stat in ("depth", "steps", "term_left", "term_right"):
                discrete |= out[stat] != ref[stat]
            without = leaf_rule(out, ref, ref64, leaves, False)
            with_leaf = leaf_rule(out, ref, ref64, leaves, True)
            totals["checks"] += 1
            totals["fail_without_leaf"] += bool(without)
            totals["fail_with_leaf"] += bool(with_leaf)
            print(json.dumps({
                "seed": seed, "config": [kind, dcap],
                "discrete_mismatch": int(discrete.sum()),
                "leaf_kernel_vs_f32": int((leaves[0] != leaves[1]).sum()),
                "leaf_f32_vs_f64": int((leaves[1] != leaves[2]).sum()),
                "fails_without_leaf": without, "fails_with_leaf": with_leaf,
                **tag}), flush=True)
            flips = ((leaves[0] != leaves[1]) & ~discrete).nonzero().flatten()
            if not len(flips):
                continue
            delta, minv = {}, args[8].double()
            for j, _q, p, ld in proposal.trajectory(
                    *args[:5], args[8], vg, (1 << dcap) - 1):
                sp = p * minv if minv.ndim == 1 else p @ minv
                pi = torch.where(torch.isfinite(ld), ld - 0.5 * (p * sp).sum(-1),
                                 -torch.inf)
                delta[j] = torch.nan_to_num(pi, nan=-torch.inf)
            delta = {j: v - delta[0] for j, v in delta.items()}
            agree = leaves[1] == leaves[2]
            pi_err = (ref["prop_pi"].double() - ref64["prop_pi"])[agree].abs()
            for c in flips.tolist():
                kind_of, margin = flip_witness(args, c, leaves, delta,
                                               int(ref["depth"][c]))
                print(json.dumps({
                    "flip": [seed, kind, dcap, c],
                    "leaf": {"kernel": int(leaves[0][c]),
                             "plain_f32": int(leaves[1][c]),
                             "plain_f64": int(leaves[2][c])},
                    "decision": kind_of, "f64_margin": margin,
                    "f32_pi_err": {"median": float(pi_err.median()),
                                   "max": float(pi_err.max())},
                    **tag}), flush=True)
    print(json.dumps({"totals": totals, **tag}), flush=True)


if __name__ == "__main__":
    main()
