#!/usr/bin/env python3
"""Time one NUTS transition of Bayesian logistic regression through each
of its three routes, over a grid of shapes, to set the rule of
``logistic_regression(fused="auto", tree_kernel="auto")``.

    python3 scripts/torch_logreg_auto_sweep.py [--chains 2048,256]
        [--dims 8,25,64,128,256,512,1024] [--n-obs 250,1000,4000,16000]
        [--repeats 3] [--device cuda] [--out PATH]

Routes, each one ``tree_batched.sample_tree_batched`` call with
``NUTS(max_depth=4)``:
  plain  the plain batch driver, the gradient by autograd
         (``fused=False, tree_kernel=False``);
  k3     the plain batch driver, every leaf through the fused logreg leaf
         (``fused=True``, csrc/logreg_leaf.cu);
  k1     the whole transition in the tree kernel with the logreg leaf
         (``tree_kernel=True``, csrc/tree_kernel.cu).
At each shape every route gets the same data (``synthetic_data``, seed
0) and the same state of a short adapted warmup: ``run_chains`` from C
draws of the Laplace approximation (float64 Newton from 0), with
chip_smoke's logreg_tree configuration (pooled diagonal metric,
per-chain dual averaging, ``NUTS(max_depth=4)``, warmup depth clamp 2
with a tail of 25) on default stages cut to WARMUP_DOUBLINGS doubling
stages (300 transitions), through the route the rule of the checkout
picks; the timed transitions start at its last draws with its per-chain
eps and pooled metric, the trees an adapted run takes. Each route is
timed ``--repeats`` times with ``profiling.benchmark``, the routes
interleaved, with as many transitions a repeat as fit in about a quarter
of a second (at least one). Each shape prints one JSON line: per route the median and
the spread (max - min) of the seconds per transition, the steps per chain
and the kernel launches of its runs; ``winner``, the route with the
smallest median; ``ties``, the routes whose spread overlaps the winner's.
``--out PATH`` also writes the lines to PATH. The last lines hold the
card's name and power limit and, per fleet, a table of winners.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dynamichmc_tpu_torch import profiling, run_chains  # noqa: E402
from dynamichmc_tpu_torch.hamiltonian import evaluate  # noqa: E402
from dynamichmc_tpu_torch.models.logreg import (  # noqa: E402
    logistic_regression_from_data,
    synthetic_data,
)
from dynamichmc_tpu_torch.nuts import NUTS  # noqa: E402
from dynamichmc_tpu_torch.ops import logreg_leaf, tree_kernel  # noqa: E402
from dynamichmc_tpu_torch.tree_batched import sample_tree_batched  # noqa: E402
from dynamichmc_tpu_torch.warmup import default_warmup_stages  # noqa: E402

ROUTES = {"plain": {}, "k3": {"fused": True}, "k1": {"tree_kernel": True}}
MAX_DEPTH = 4
PRIOR_SCALE = 10.0
TARGET_SECONDS = 0.25  # timed transitions a repeat: about this long
WARMUP_DOUBLINGS = 3  # 75 + 25 + 50 + 100 + 50 warmup transitions


def ints(text):
    return [int(v) for v in text.split(",") if v]


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def laplace(x, y, inv_s2, iters=25):
    """Mode and covariance of the Laplace approximation, float64 Newton
    from 0 until the step is below 1e-10 (relative)."""
    x, y = x.double(), y.double()
    K = x.shape[1]
    eye = torch.eye(K, dtype=torch.float64, device=x.device)
    beta = torch.zeros(K, dtype=torch.float64, device=x.device)
    for _ in range(iters):
        s = torch.sigmoid(x @ beta)
        hess = x.mT @ (x * (s * (1 - s))[:, None]) + inv_s2 * eye
        step = torch.linalg.solve(hess, x.mT @ (y - s) - inv_s2 * beta)
        beta = beta + step
        if float(step.norm()) <= 1e-10 * (1.0 + float(beta.norm())):
            break
    s = torch.sigmoid(x @ beta)
    hess = x.mT @ (x * (s * (1 - s))[:, None]) + inv_s2 * eye
    return beta, torch.linalg.inv(hess)


def rule_route(n_obs, dim):
    """The route ``fused="auto", tree_kernel="auto"`` takes by the rule."""
    fused = logreg_leaf.fused_leaf_pays(n_obs, dim)
    if tree_kernel.tree_kernel_pays(n_obs, dim, fused=fused):
        return "k1"
    return "k3" if fused else "plain"


def shape_inputs(n_obs, dim, C, device, seed=0):
    """The three route models, the start Q, the metric and eps: the end
    of a short adapted warmup through the rule's route."""
    x_np, y_np = synthetic_data(n_obs, dim, seed)
    models = {route: logistic_regression_from_data(
        x_np, y_np, prior_scale=PRIOR_SCALE, dtype=torch.float32,
        device=device, **kw) for route, kw in ROUTES.items()}
    x = torch.as_tensor(x_np, device=device)
    y = torch.as_tensor(y_np, device=device)
    mode, cov = laplace(x, y, 1.0 / PRIOR_SCALE ** 2)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((C, dim), generator=gen, dtype=torch.float64, device=device)
    q = (mode + z @ torch.linalg.cholesky(cov).mT).float().contiguous()
    route = rule_route(n_obs, dim)
    stages = default_warmup_stages(metric_kind="diagonal", pooled=True,
                                   doubling_stages=WARMUP_DOUBLINGS)
    t0 = time.perf_counter()
    res = run_chains(gen, models[route], C, 1, initialization={"q": q},
                     warmup_stages=stages, algorithm=NUTS(max_depth=MAX_DEPTH),
                     dtype=torch.float32, tune="reference",
                     warmup_depth_clamp=2, warmup_depth_clamp_tail=25,
                     log=lambda _msg: None)
    Q = evaluate(models["plain"], res.positions[:, -1].contiguous())
    eps = res.eps.contiguous()
    return models, Q, res.metric, eps, {
        "warmup_route": route, "warmup_seconds": time.perf_counter() - t0,
        "eps_range": [float(eps.min()), float(eps.max())],
        "eps_median": float(eps.median()),
        "draw_steps_per_chain": float(
            res.tree_statistics.steps.double().mean())}


def counts():
    return {"k1": tree_kernel.launches, "k3": logreg_leaf.launches}


def time_routes(models, Q, metric, eps, repeats, device, seed=1):
    """Per route: the seconds per transition of each repeat, the mean
    steps per chain and max depth of the last transition, the launches."""
    algorithm = NUTS(max_depth=MAX_DEPTH)
    gens = {r: torch.Generator(device=device).manual_seed(seed) for r in models}
    out = {r: {"seconds": [], "launches": {"k1": 0, "k3": 0}, "calls": 0}
           for r in models}

    def fn(route):
        return lambda: sample_tree_batched(gens[route], algorithm,
                                           models[route], metric, Q, eps)

    iters = {}
    for route in models:  # one probe: the kernels' first calls, the pace
        probe = profiling.benchmark(fn(route), iters=1, warmup=1, name=route)
        iters[route] = max(1, min(8, int(TARGET_SECONDS
                                          / probe["seconds_per_iteration"])))
    for _ in range(repeats):
        for route in models:
            before = counts()
            res = profiling.benchmark(fn(route), iters=iters[route], warmup=1,
                                      name=route)
            after = counts()
            o = out[route]
            o["seconds"].append(res["seconds_per_iteration"])
            o["calls"] += 1 + iters[route]
            for k in ("k1", "k3"):
                o["launches"][k] += after[k] - before[k]
            stats = res["output"][1]
            o["steps_per_chain"] = float(stats.steps.double().mean())
            o["max_depth"] = int(stats.depth.max())
    for route, o in out.items():
        o["iters"] = iters[route]
        s = o.pop("seconds")
        o["median_s"] = statistics.median(s)
        o["spread_s"] = max(s) - min(s)
        o["min_s"], o["max_s"] = min(s), max(s)
        o["all_s"] = s
    return out


def check_routes(timed):
    """Each route took its own kernel on every call, and no other."""
    calls = {r: o["calls"] for r, o in timed.items()}
    assert timed["plain"]["launches"] == {"k1": 0, "k3": 0}, timed["plain"]
    assert timed["k1"]["launches"] == {"k1": calls["k1"], "k3": 0}, timed["k1"]
    assert timed["k3"]["launches"]["k1"] == 0 and (
        timed["k3"]["launches"]["k3"] >= calls["k3"]), timed["k3"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", default="2048,256")
    ap.add_argument("--dims", default="8,25,64,128,256,512,1024")
    ap.add_argument("--n-obs", default="250,1000,4000,16000")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    smi = nvidia_smi_line() if device.type == "cuda" else "cpu"
    if device.type == "cuda":
        for lib in (tree_kernel.library, logreg_leaf.library):
            lib.load()  # nvcc outside the timed regions
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t_start = time.perf_counter()
    winners = {}
    with open(args.out or os.devnull, "w") as sink:
        for C in ints(args.chains):
            for dim in ints(args.dims):
                for n_obs in ints(args.n_obs):
                    t0 = time.perf_counter()
                    models, Q, metric, eps, how = shape_inputs(
                        n_obs, dim, C, device)
                    timed = time_routes(models, Q, metric, eps, args.repeats,
                                        device)
                    if device.type == "cuda":
                        check_routes(timed)
                    best = min(timed, key=lambda r: timed[r]["median_s"])
                    lo = timed[best]["max_s"]
                    ties = sorted(r for r in timed if r != best
                                  and timed[r]["min_s"] <= lo)
                    line = {"chains": C, "dim": dim, "n_obs": n_obs, **how,
                            "routes": timed, "winner": best, "ties": ties,
                            "shape_seconds": time.perf_counter() - t0,
                            "gpu": smi}
                    winners[(C, dim, n_obs)] = (best, ties, {
                        r: timed[r]["median_s"] for r in timed})
                    text = json.dumps(line)
                    print(text, flush=True)
                    sink.write(text + "\n")
                    sink.flush()
                    del models, Q, metric
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
    print(f"sweep seconds {time.perf_counter() - t_start:.1f}")
    for C in ints(args.chains):
        print(f"winners at {C} chains (rows dim, columns n_obs "
              f"{ints(args.n_obs)}; median ms plain/k3/k1; * a tie):")
        for dim in ints(args.dims):
            cells = []
            for n_obs in ints(args.n_obs):
                best, ties, med = winners[(C, dim, n_obs)]
                ms = "/".join(f"{1e3 * med[r]:.3f}" for r in ROUTES)
                cells.append(f"{best}{'*' + ','.join(ties) if ties else ''}"
                             f" ({ms})")
            print(f"  {dim:5d}: " + " | ".join(cells))
    print(smi)


if __name__ == "__main__":
    main()
