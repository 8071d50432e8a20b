#!/usr/bin/env python3
"""run_chains_multihost under torchrun: one rank per device.

    torchrun --standalone --nproc-per-node=N \\
        scripts/torch_multihost_example.py \\
        [--chains-per-device 1024] [--draws 256] [--dim 100] \\
        [--backend nccl|gloo] [--device cuda|cpu]

Every rank joins the group from torchrun's variables (``initialize()``),
runs ``correlated_gaussian(dim)`` through ``run_chains_multihost`` with a
pooled dense metric, from one generator seeded alike on every rank, and
prints one JSON line: its chains' shape, its wall seconds, the SHA-256 of
its pooled metric (the same on every rank) and its launch counts. Rank 0
also prints the split R-hat and min bulk ESS over every rank's chains,
gathered with ``parallel.mesh.all_gather_chains``. The default backend is
nccl on CUDA (one device per rank), gloo on the CPU; two ranks sharing one
card need ``--backend gloo --device cuda:0``, as NCCL refuses two ranks on
one device.
"""

import argparse
import hashlib
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--chains-per-device", type=int, default=1024)
    parser.add_argument("--draws", type=int, default=256)
    parser.add_argument("--dim", type=int, default=100)
    parser.add_argument("--backend", default=None)
    parser.add_argument("--device", default=None,
                        help="this rank's device (default cuda:LOCAL_RANK, "
                        "or cpu without CUDA); cuda:0 puts every rank on "
                        "one card")
    args = parser.parse_args()

    import torch.distributed as dist

    from dynamichmc_tpu_torch import NUTS
    from dynamichmc_tpu_torch.models import correlated_gaussian
    from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts
    from dynamichmc_tpu_torch.parallel import initialize, run_chains_multihost
    from dynamichmc_tpu_torch.parallel.mesh import (all_gather_chains,
                                                    chain_mesh)
    from dynamichmc_tpu_torch.stats_device import ess_rhat_device
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    cpu = args.device == "cpu" or (args.device is None
                                   and not torch.cuda.is_available())
    initialize(backend=args.backend)
    mesh = chain_mesh(device="cpu" if cpu else args.device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    model = correlated_gaussian(args.dim, dtype=torch.float32,
                                device=mesh.device, tree_kernel=not cpu)

    def synchronize():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    generator = torch.Generator(device=mesh.device).manual_seed(0)
    synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_chains_multihost(
        generator, model, args.chains_per_device, args.draws,
        device=mesh.device, tune="reference",
        warmup_stages=default_warmup_stages(metric_kind="dense", pooled=True),
        algorithm=NUTS(max_depth=4), warmup_depth_clamp=2,
        warmup_depth_clamp_tail=25, dtype=torch.float32)
    synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    m_inv = res.metric.m_inv.cpu().numpy().tobytes()
    print(json.dumps({
        "rank": mesh.rank, "size": mesh.size, "backend": dist.get_backend(),
        "device": str(mesh.device), "positions": list(res.positions.shape),
        "wall_s": seconds, "m_inv_sha256": hashlib.sha256(m_inv).hexdigest(),
        "tree_transition": counts["tree_transition"],
        "tree_transition_warp": counts["tree_transition_warp"]}), flush=True)
    gathered = all_gather_chains(res.positions, mesh)
    if mesh.rank == 0:
        stats = ess_rhat_device(gathered)
        print(json.dumps({"chains": gathered.shape[0],
                          "max_rhat": float(stats["rhat"].max()),
                          "min_bulk_ess": float(stats["ess_bulk"].min())}),
              flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
