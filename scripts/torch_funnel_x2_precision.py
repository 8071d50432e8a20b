#!/usr/bin/env python3
"""Measure, on the CPU, what the funnel leaf's x2 = sum q^2 - v^2 costs in
float32 in the funnel's neck.

    python3 scripts/torch_funnel_x2_precision.py [--n N] [--seed S]

The JAX kernel (ops/pallas_tree.py::funnel_leaf) and both variants of the
port's tree kernel form x2 = sum_{i>0} q_i^2 as the sum over every
coordinate less v^2, and the leaf multiplies x2 by e^-v. Where v is very
negative the x_i are small (x_i ~ N(0, e^v)), so the sum cancels v^2
against a small remainder and e^-v scales the rounding up. For funnel(K)
with sigma_v = 3, N draws of x | v at each fixed v, this prints one JSON
line per (K, v): the largest relative error of x2 and ld, and of d ld / dv
relative to 1 + |d ld / dv|, and the largest absolute errors, of the
plain float32 leaf (``Leaf.value_and_grad``, the kernels' formula) against
the same in float64, and of x2 summed over i > 0 directly in float32, the
form without the cancellation, for comparison. Nothing here runs on a GPU.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rel(x, y):
    """Largest |x - y| / |y|."""
    return float(((x.double() - y).abs() / y.abs()).max())


def rel1(x, y):
    """Largest |x - y| / (1 + |y|), the repo's rule for values near 0."""
    return float(((x.double() - y).abs() / (1 + y.abs())).max())


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=4096)
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args()
    from dynamichmc_tpu_torch.ops.tree_kernel import funnel_leaf

    rng = np.random.default_rng(opts.seed)
    for K in (25, 129):
        leaf = funnel_leaf(K, 3.0)
        for v in (0.0, -3.0, -6.0, -9.0):
            q = np.empty((opts.n, K))
            q[:, 0] = v
            q[:, 1:] = np.exp(v / 2) * rng.standard_normal((opts.n, K - 1))
            q64 = torch.as_tensor(q, dtype=torch.float64)
            q32 = q64.float()
            # the same float32 inputs in both: only the arithmetic differs
            ld64, g64 = leaf.value_and_grad(q32.double())
            ld32, g32 = leaf.value_and_grad(q32)
            x2_64 = (q32.double()[:, 1:] ** 2).sum(-1)
            x2_cancel = (q32 * q32).sum(-1) - q32[:, 0] * q32[:, 0]
            x2_direct = (q32[:, 1:] * q32[:, 1:]).sum(-1)
            print(json.dumps({
                "K": K, "v": v, "draws": opts.n, "device": "cpu",
                "x2_rel_err_cancelling_f32": rel(x2_cancel, x2_64),
                "x2_rel_err_direct_f32": rel(x2_direct, x2_64),
                "ld_rel_err_f32": rel(ld32, ld64),
                "ld_abs_err_f32": float((ld32.double() - ld64).abs().max()),
                "dld_dv_rel1_err_f32": rel1(g32[:, 0], g64[:, 0]),
                "dld_dv_abs_err_f32": float((g32[:, 0].double() - g64[:, 0]).abs().max()),
            }), flush=True)


if __name__ == "__main__":
    main()
