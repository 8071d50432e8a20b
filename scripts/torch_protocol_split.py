#!/usr/bin/env python3
"""Tell a sampler bias from an unlucky draw, and the tree kernel from
float32, on the bench-dimension gate of the statistical protocol.

    python3 scripts/torch_protocol_split.py [--variants V,...] [--seeds S,...]
        [--chains C] [--draws N] [--out FILE]

Runs the configuration of tests/torch_correctness_utils.bench_dim_gate
(correlated_gaussian(64), pooled dense metric, NUTS(max_depth=4), warmup
clamp 2/25) on the GPU for each variant and seed, and prints one JSON line
each with the protocol's numbers (tests/torch_correctness_utils.measure),
without asserting:

- ``k1_f32``: float32 chains through the tree kernel (K1, warp variant);
- ``plain_f32``: float32 chains through the plain batch driver (the model
  without the kernel's hook);
- ``plain_f64``: float64 chains through the plain batch driver (the
  kernels decline float64).

Each line gives R-hat max, tau min, EBFMI min, the smallest AD p, and for
the AD statistics against the 0.1% critical values (the gate's rule at
64 coordinates) the worst ratio, its coordinate and how many coordinates
exceed it; with the wall of the run and the kernel launches. More chains
and draws than the gate's 128 x 256 give the same test more power: a bias
grows with the sample, an unlucky draw does not. Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from dynamichmc_tpu_torch import run_chains  # noqa: E402
from dynamichmc_tpu_torch.models import correlated_gaussian  # noqa: E402
from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: E402
import torch_correctness_utils as protocol  # noqa: E402

VARIANTS = {  # name -> (chain dtype, tree kernel)
    "k1_f32": (torch.float32, True),
    "plain_f32": (torch.float32, False),
    "plain_f64": (torch.float64, False),
}


def run(variant, seed, chains, draws, dev, smi):
    dtype, kernel = VARIANTS[variant]
    model = correlated_gaussian(64, dtype=dtype, device=dev, tree_kernel=kernel)
    gen = torch.Generator(device=dev).manual_seed(seed)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_chains(gen, model, chains, draws, dtype=dtype,
                     **protocol.bench_dim_config())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    m = protocol.measure(res, model, seed)
    ratios = [stat / crit for stat, _p, crit in m["ad"]]
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    return {"variant": variant, "seed": seed, "chains": chains, "draws": draws,
            "rhat_max": m["rhat_max"], "tau_min": m["tau_min"],
            "ebfmi_min": float(m["ebfmi"].min()),
            "ad_p_min": min(p for _s, p, _c in m["ad"]),
            "ad_worst_coord": worst, "ad_worst_stat": m["ad"][worst][0],
            "ad_worst_crit_001": m["ad"][worst][2],
            "ad_worst_ratio": ratios[worst],
            "ad_coords_over_crit_001": sum(r >= 1 for r in ratios),
            "ad_stride": m["stride"], "wall_s": seconds,
            "tree_kernel_launches": launches["tree_transition"],
            "warp_launches": launches["tree_transition_warp"], "gpu": smi}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="k1_f32,plain_f32,plain_f64")
    ap.add_argument("--seeds", default=str(protocol.BENCH_DIM_SEED))
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--draws", type=int, default=256)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in args.variants.split(","):
            line = json.dumps(run(variant, seed, args.chains, args.draws, dev,
                                  smi))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
