#!/usr/bin/env python3
"""Show, on the CPU, how far another summation order alone moves the
funnel's float32 transition, and what that does to phase 3's rules.

    python3 scripts/torch_funnel_order_sensitivity.py [--K 25,129] [--seeds 3]

For funnel(K) on 4096 chains at max_depth 7 from chip_smoke's phase-3
inputs (exact draws, the pooled diagonal metric's variances, per-chain
eps), with a diagonal metric, a dense one and dcap 2, this runs the plain
transition three times on the same injected noise: in float32 as it is
(torch's order of sum q^2), in float32 with sum q^2 taken in the CUDA
kernels' order (a 32-lane xor butterfly per warp, the warps added in
order), and in float64. Nothing else differs between the two float32
runs. One JSON line per configuration gives the chains whose discrete
statistics or proposal leaf differ (reordered against plain, each against
float64), and for ld', log_sum, q' and grad' the largest and the 99th
percentile per-chain error of each float32 run against float64, with
whether the reordered run passes phase 3's rule (no further from float64
than twice the plain run, plus 1e-5) by each statistic, and the largest
and 99th-percentile |ld' difference| / (1 + |ld'|) between the two float32
runs (phase 3 holds it to 1e-4).
"""

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True, eq=False)
class KernelOrderLeaf:
    """The funnel leaf with sum q^2 in the CUDA kernels' order."""

    leaf: object

    def to(self, device):
        return KernelOrderLeaf(self.leaf.to(device))

    def value_and_grad(self, q):
        s0, s1 = self.leaf.scalars
        v = q[:, 0]
        C, K = q.shape
        kp = (K + 31) // 32 * 32
        x = torch.zeros((C, kp), dtype=q.dtype)
        x[:, :K] = q * q
        x = x.view(C, kp // 32, 32)
        for o in (16, 8, 4, 2, 1):  # lane 0's butterfly
            x = x[..., :o] + x[..., o:2 * o]
        total = x[:, 0, 0]
        for w in range(1, kp // 32):
            total = total + x[:, w, 0]
        x2 = total - v * v
        emv = torch.exp(-v)
        ld = -0.5 * (v * v) / s0 - s1 * v - 0.5 * emv * x2
        gv = -v / s0 - s1 + 0.5 * emv * x2
        return ld, torch.cat([gv[:, None], -emv[:, None] * q[:, 1:]], 1)


def per_chain(err):
    return err.reshape(err.shape[0], -1).amax(-1).double()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--K", default="25,129")
    parser.add_argument("--seeds", type=int, default=3)
    opts = parser.parse_args()
    import chip_smoke as chip
    from dynamichmc_tpu_torch.models import funnel
    from dynamichmc_tpu_torch.ops import tree_kernel
    from dynamichmc_tpu_torch.ops.proposal_leaf import proposal_offsets

    C, md = 4096, 7
    for K in (int(k) for k in opts.K.split(",")):
        model = funnel(K, dtype=torch.float32, device="cpu", tree_kernel=True)
        for seed in range(opts.seeds):
            gen = torch.Generator().manual_seed(seed)
            for kind, dcap in (("diag", md), ("dense", md), ("diag", 2)):
                args = chip.kernel_inputs(model, C, md, kind, dcap, gen)
                leaf = args[9]
                alt = tree_kernel.tree_transition_plain(
                    *args[:9], KernelOrderLeaf(leaf), *args[10:])
                ref = tree_kernel.tree_transition_plain(*args)
                ref64 = tree_kernel.tree_transition_plain(*chip._as64(args))
                l_alt, l_32, l_64 = proposal_offsets(
                    *args[:5], args[8], leaf.value_and_grad, dcap,
                    [alt["prop_q"], ref["prop_q"], ref64["prop_q"]])

                def differ(a, b, la, lb):
                    d = la != lb
                    for stat in ("depth", "steps", "term_left", "term_right"):
                        d = d | (a[stat] != b[stat])
                    return d

                same = ~differ(alt, ref, l_alt, l_32)
                both = same & ~differ(ref, ref64, l_32, l_64)
                row = {"K": K, "seed": seed, "config": [kind, dcap],
                       "device": "cpu", "chains": C,
                       "reordered_vs_plain": int((~same).sum()),
                       "plain_vs_f64": int(differ(ref, ref64, l_32, l_64).sum()),
                       "reordered_vs_f64": int(differ(alt, ref64, l_alt, l_64).sum())}
                ld = per_chain(chip._rel_err(alt["prop_ld"][same], ref["prop_ld"][same]))
                row["ld_vs_plain"] = {"max": float(ld.max()),
                                      "q99": float(torch.quantile(ld, 0.99))}
                for name in ("prop_ld", "log_sum", "prop_q", "prop_grad"):
                    e_alt = per_chain(chip._rel_err(alt[name][both], ref64[name][both]))
                    e_32 = per_chain(chip._rel_err(ref[name][both], ref64[name][both]))
                    stats = {}
                    for stat, f in (("max", torch.max),
                                    ("q99", lambda e: torch.quantile(e, 0.99))):
                        a, p = float(f(e_alt)), float(f(e_32))
                        stats[stat] = {"reordered": a, "plain_f32": p,
                                       "rule_holds": a <= 2 * p + 1e-5}
                    row[name] = stats
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
