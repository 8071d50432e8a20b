#!/usr/bin/env python3
"""Time the port's funnel tree kernel and count its discrete flips over
seeds, or time its logreg tree kernel, for the package of any checkout.

    python3 scripts/torch_tree_funnel_compare.py [--root DIR] [--seeds N] [--K 25,129]
        [--md 7]
    python3 scripts/torch_tree_funnel_compare.py --leaf logreg [--root DIR]
        [--shapes 16384x25x1000,2048x128x4000] [--kinds diag,dense]
        [--md 4] [--reps 20]

``--root`` names the checkout whose ``dynamichmc_tpu_torch`` is imported
(default: this one), so that one call can hold this tree's kernel beside
another commit's unpacked with ``git archive``. The inputs, timing and
bound come from this checkout's ``chip_smoke.py``, the leaf of each
proposal from its ``ops/proposal_leaf.py``. Needs CUDA. Prints one JSON
line per measurement.

1. ``time``: ms per call of ``tree_kernel.tree_transition`` (CUDA events,
   ``--reps`` calls, 20 by default, after a warm-up call, as in
   chip_smoke's phase 5) on 4096 chains of funnel(K), max_depth ``--md``
   (default 7), from chip_smoke's phase-3 inputs, for each K of ``--K``
   (default 25, the funnel path, and 129, past the warp variant) with a
   diagonal and a dense metric; beside it the fp32 bound
   of the leaves the chains executed, the plain version's ms per call (3
   calls after a warm-up call), the variant the shape takes and its
   launch plan where the imported package reports one.
2. ``seed``: for seeds 1..N, at each K with a diagonal metric, a dense one
   and dcap 2, the chains whose depth, steps, termination or proposal leaf
   differ between the kernel and the plain float32 version (phase 3's
   match counts them against 0.1% of the chains), and between the plain
   float32 and float64 versions (the ties that float32 rounding alone
   breaks either way); and, on the chains where all three agree, the
   largest and the 99th-percentile per-chain error of log_sum, q' and
   grad' against float64, the kernel's beside the plain float32
   version's (the GPU tests' rule: the kernel's within twice the plain
   version's plus 1e-5).

With ``--leaf logreg``, one ``time`` line per shape ``CxKxN`` of
``--shapes`` (chains, coordinates, observations) and metric kind of
``--kinds``, from phase 3's logreg inputs (a start at draws of the Laplace
approximation, its covariance as M^-1 or that covariance's diagonal):
ms per call (CUDA events around ``--reps`` calls after a warm-up call),
the kernel's device ms per launch (torch.profiler), the leaves the chains
executed (the kernel's ``work``), device us per thousand chain-leaves, the
fp32 bound of those leaves and its share, and the variant and launch plan
the imported package reports (a package without the staged-X variant
takes the CTA one). ``--md`` defaults to 4 there.
"""

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, N_TIME, N_PLAIN = 4096, 20, 3
MD = 7  # max_depth, set by --md


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def plan_of(tree_kernel, dev, kind, K, diag, n_obs=0):
    """The variant and launch plan of leaf ``kind`` at K coordinates (and
    n_obs rows of X) at max_depth MD, where the imported package reports
    them."""
    if hasattr(tree_kernel, "xstaged_plan"):
        variant = tree_kernel.kernel_variant(kind, K, MD, diag, n_obs)
    else:
        variant = tree_kernel.kernel_variant(kind, K, MD, diag)
    plan = {"variant": variant}
    name = f"{variant}_kernel_info"
    if not (hasattr(tree_kernel, "cta_kernel_info") and hasattr(tree_kernel, name)):
        return plan
    if variant == "xstaged":
        info = tree_kernel.xstaged_kernel_info(dev, K, MD, n_obs, diag)
    else:
        info = getattr(tree_kernel, name)(dev, kind, K, MD, diag)
    plan.update({"warps_per_cta": info.warps, "registers": info.registers,
                 "smem_bytes": info.smem, "ctas_per_sm": info.ctas_per_sm,
                 "resident_warps_per_sm": info.resident_warps})
    return plan


def mismatches(a, b, leaf_a, leaf_b):
    differ = leaf_a != leaf_b
    for stat in ("depth", "steps", "term_left", "term_right"):
        differ |= a[stat] != b[stat]
    return int(differ.sum())


def errors(out, ref, ref64, same):
    """Per output, [max, 99th percentile] of the per-chain error
    |x - x64| / (1 + |x64|) on the ``same`` chains, for the kernel and for
    the plain float32 version."""
    res = {}
    for name in ("log_sum", "prop_q", "prop_grad"):
        row = {}
        for who, x in (("kernel", out[name]), ("plain", ref[name])):
            a, b = x[same].double(), ref64[name][same].double()
            err = torch.where(a == b, 0.0, (a - b).abs() / (1 + b.abs()))
            per_chain = err.reshape(err.shape[0], -1).amax(-1)
            row[who] = [float(per_chain.max()),
                        float(torch.quantile(per_chain, 0.99))]
        res[name] = row
    return res


def time_logreg(chip, tree_kernel, dev, opts, tag):
    """``--leaf logreg``: the time lines (see above)."""
    from dynamichmc_tpu_torch.models import logistic_regression

    for shape in opts.shapes.split(","):
        C_, K, n_obs = (int(x) for x in shape.split("x"))
        model = logistic_regression(n_obs, K, dtype=torch.float32,
                                    device=dev, tree_kernel=True)
        for kind in opts.kinds.split(","):
            gen = torch.Generator(device=dev).manual_seed(0)
            args = chip.kernel_inputs(model, C_, MD, kind, MD, gen)
            ms = chip.time_call(tree_kernel.tree_transition, args, opts.reps)
            device_ms = chip.device_ms(tree_kernel.tree_transition, args,
                                       opts.reps, "tree_transition_kernel")
            leaves = int(tree_kernel.tree_transition(*args)["work"].sum())
            bound_ms, bound_by = chip.tree_kernel_bound(args)
            print(json.dumps({
                "time": [C_, K, n_obs, MD, kind], "ms": ms,
                "device_ms": device_ms, "chain_leaves": leaves,
                "device_us_per_1k_chain_leaves": 1e6 * device_ms / leaves,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "roofline_pct": 100 * bound_ms / device_ms,
                "plan": plan_of(tree_kernel, dev, tree_kernel.LOGREG, K,
                                kind == "diag", n_obs), **tag}), flush=True)


def main():
    global MD
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--leaf", choices=("funnel", "logreg"),
                        default="funnel")
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--K", default="25,129")
    parser.add_argument("--md", type=int)
    parser.add_argument("--shapes", default="16384x25x1000")
    parser.add_argument("--kinds", default="diag,dense")
    parser.add_argument("--reps", type=int, default=N_TIME)
    opts = parser.parse_args()
    MD = opts.md or (MD if opts.leaf == "funnel" else 4)
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    chip = load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    proposal = load("proposal_leaf", os.path.join(
        HERE, "dynamichmc_tpu_torch", "ops", "proposal_leaf.py"))
    from dynamichmc_tpu_torch.models import funnel
    from dynamichmc_tpu_torch.ops import tree_kernel

    dev = torch.device("cuda", 0)
    smi = chip.nvidia_smi_line()
    tree_kernel.library.build()
    tag = {"root": os.path.relpath(root, HERE), "gpu": smi}
    if opts.leaf == "logreg":
        time_logreg(chip, tree_kernel, dev, opts, tag)
        return
    models = {K: funnel(K, dtype=torch.float32, device=dev, tree_kernel=True)
              for K in (int(k) for k in opts.K.split(","))}
    gen = torch.Generator(device=dev).manual_seed(0)
    for K, model in models.items():
        for kind in ("diag", "dense"):
            args = chip.kernel_inputs(model, C, MD, kind, MD, gen)
            ms = chip.time_call(tree_kernel.tree_transition, args, opts.reps)
            plain_ms = chip.time_call(tree_kernel.tree_transition_plain, args,
                                      N_PLAIN)
            bound_ms, bound_by = chip.tree_kernel_bound(args)
            print(json.dumps({"time": [C, K, MD, kind], "ms": ms,
                              "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "plan": plan_of(tree_kernel, dev, tree_kernel.FUNNEL,
                                              K, kind == "diag"),
                              **tag}), flush=True)

    for seed in range(1, opts.seeds + 1):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for K, model in models.items():
            for kind, dcap in (("diag", MD), ("dense", MD), ("diag", 2)):
                args = chip.kernel_inputs(model, C, MD, kind, dcap, gen)
                out = tree_kernel.tree_transition(*args)
                ref = tree_kernel.tree_transition_plain(*args)
                ref64 = tree_kernel.tree_transition_plain(*chip._as64(args))
                leaf_k, leaf_32, leaf_64 = proposal.proposal_offsets(
                    *args[:5], args[8], args[9].value_and_grad, dcap,
                    [out["prop_q"], ref["prop_q"], ref64["prop_q"]])
                same = leaf_k == leaf_32
                same &= leaf_32 == leaf_64
                for stat in ("depth", "steps", "term_left", "term_right"):
                    same &= (out[stat] == ref[stat]) & (ref[stat] == ref64[stat])
                print(json.dumps({
                    "seed": seed, "config": [K, kind, dcap, MD],
                    "errors_vs_f64": errors(out, ref, ref64, same),
                    "kernel_vs_f32": mismatches(out, ref, leaf_k, leaf_32),
                    "f32_vs_f64": mismatches(ref, ref64, leaf_32, leaf_64),
                    "kernel_vs_f64": mismatches(out, ref64, leaf_k, leaf_64),
                    "allowed": int(0.001 * C), **tag}), flush=True)


if __name__ == "__main__":
    main()
