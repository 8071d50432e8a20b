#!/usr/bin/env python3
"""Which earlier work in a process keeps ``profiling.trace`` from
recording kernels on the card.

    python3 scripts/torch_trace_check.py [--sequences T1,C,T1 ...]
        [--parallel 3] [--device cuda]

Each sequence runs in a fresh process: its steps in order, each on a
K1 transition (``sample_tree_batched`` of ``correlated_gaussian(100,
tree_kernel=True)``, 1024 chains, ``NUTS()``, warmed before the first
step). Steps:
  T1  ``profiling.trace`` around one transition;
  T3  ``profiling.trace`` around three transitions;
  M   ``profiling.trace`` around one float32 matmul of 1024 x 1024;
  TS  ``torch.profiler.profile`` (CPU and CUDA) around one small kernel,
      a synchronisation, then one transition;
  C   a CUDA-only ``torch.profiler.profile`` around five transitions, as
      chip_smoke's phase 5 times its kernels;
  L   100,000 small kernels (``x.add_(1)``) outside any profiler; ``Ln``
      n of them;
  P   another process on the card: one transition in a child interpreter;
  N   ``stats.ess_rhat`` of 4 x 100 x 3 draws through the native engine
      (``native.load()``: the build, the library and its OpenMP runtime);
  Y   the same through the numpy path (``use_native=False``);
  Z   ``from scipy.stats import anderson_ksamp``;
  Sn  n seconds of sleep.
Each profiled step reports its kernel events and how many of them name
the tree kernel; one JSON line a sequence, with the lines of the
process's standard error that name the profiler. ``--device cpu`` runs the
steps without a card, for a check of the script.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQUENCES = ("T1", "T1,T1", "T3", "C,T1", "C,T3", "C,C", "C,M", "C,TS",
             "L,T1", "C,L,T1", "C,L,TS", "T1,C,T1")


def kernel_events(log_dir):
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def run_sequence(steps, device):
    import torch

    sys.path.insert(0, ROOT)
    from dynamichmc_tpu_torch import profiling
    from dynamichmc_tpu_torch.hamiltonian import evaluate
    from dynamichmc_tpu_torch.metric import identity_metric
    from dynamichmc_tpu_torch.models import correlated_gaussian
    from dynamichmc_tpu_torch.nuts import NUTS
    from dynamichmc_tpu_torch.tree_batched import sample_tree_batched

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model = correlated_gaussian(100, dtype=torch.float32, device=dev,
                                tree_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    Q = evaluate(model, 0.1 * torch.randn((1024, 100), generator=gen,
                                          device=dev))
    metric = identity_metric(100, device=dev)

    def transition():
        sample_tree_batched(gen, NUTS(), model, metric, Q, 0.2)

    transition()
    sync()
    out = []
    for step in steps:
        t0 = time.perf_counter()
        if step == "TS":
            from torch.profiler import ProfilerActivity, profile

            with tempfile.TemporaryDirectory() as tmp:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    torch.zeros(1, device=dev).add_(1)
                    sync()
                    transition()
                    sync()
                prof.export_chrome_trace(os.path.join(tmp, "t.json"))
                names = kernel_events(tmp)
            out.append({"step": step, "kernel_events": len(names),
                        "tree_kernel": sum("tree_transition" in n
                                           for n in names)})
        elif step in ("T1", "T3", "M"):
            with tempfile.TemporaryDirectory() as tmp:
                with profiling.trace(tmp):
                    if step == "M":
                        a = torch.ones(1024, 1024, device=dev)
                        a @ a
                    else:
                        for _ in range(int(step[1])):
                            transition()
                names = kernel_events(tmp)
            out.append({"step": step, "kernel_events": len(names),
                        "tree_kernel": sum("tree_transition" in n
                                           for n in names)})
        elif step == "C":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    transition()
                sync()
            tree = sum(e.count for e in prof.key_averages()
                       if "tree_transition" in e.key
                       and e.device_type.name == "CUDA")
            out.append({"step": step, "tree_kernel": tree, "of": 5})
        elif step[0] == "L":
            x = torch.zeros(1, device=dev)
            for _ in range(int(step[1:] or 100_000)):
                x.add_(1)
            sync()
            out.append({"step": step})
        elif step in ("N", "Y"):
            import numpy as np

            from dynamichmc_tpu_torch import native, stats

            draws = np.random.default_rng(0).normal(size=(4, 100, 3))
            stats.ess_rhat(draws, use_native=step == "N")
            out.append({"step": step, "native": native._lib is not None})
        elif step == "Z":
            from scipy.stats import anderson_ksamp  # noqa: F401

            out.append({"step": step})
        elif step == "P":
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--one", "", "--device", device]).returncode
            out.append({"step": step, "rc": rc})
        elif step[0] == "S":
            time.sleep(float(step[1:]))
            out.append({"step": step})
        out[-1]["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sequences", nargs="*", default=list(SEQUENCES))
    ap.add_argument("--parallel", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(run_sequence([s for s in args.one.split(",") if s],
                                      args.device)))
        return 0

    def spawn(seq):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", seq, "--device", args.device],
                              capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        return {"sequence": seq, "rc": proc.returncode,
                "steps": json.loads(lines[-1]) if proc.returncode == 0 else
                proc.stderr[-2000:],
                "profiler_stderr": [line[:300] for line in
                                    proc.stderr.splitlines()
                                    if any(w in line.lower() for w in (
                                        "kineto", "cupti", "profil",
                                        "buffer"))][:20]}

    with concurrent.futures.ThreadPoolExecutor(args.parallel) as pool:
        for res in pool.map(spawn, args.sequences):
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
