#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each one that fails ends the script with a non-zero exit code):
  1. Device: the nvidia-smi name and power limit.
  2. Build: compile the tree kernel (csrc/tree_kernel.cu) with nvcc, timed.
  3. Kernel against plain: one transition at the main-path shape (4096
     chains, K = 100, max_depth 4, per-chain eps in [0.2, 0.6], start at
     draws of the target) through the CUDA kernel and through its plain
     PyTorch version on the same injected noise; dense metric = the target
     covariance, then the diagonal metric, then dcap = 2.
  4. Main path: run_chains on correlated_gaussian(100) in float32 with the
     tree kernel, 4096 chains, 512 draws, tune="reference", a pooled dense
     metric with per-chain dual-averaging eps, warmup depth clamp 2 with a
     25-step tail and NUTS(max_depth=4): once untimed, once timed. Checks
     that every one of the 1412 transitions launched the kernel, that the
     draws are finite and that they recover the target's moments; reports
     wall time, pooled bulk ESS/s and gradient evaluations/s.
  5. Kernel time: kernel and plain driver per transition at the phase-3
     shape.

The line before the last is the nvidia-smi name and power limit; the last
line is {"ok": true, "device": {...}}. Needs CUDA; never runs on the CPU.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

C_MAIN, K_MAIN, MD_MAIN, N_DRAWS = 4096, 100, 4, 512
SEED = 0


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_inputs(model, C, md, kind, dcap, gen):
    """Phase-3 inputs: start at draws of the target, per-chain eps in
    [0.2, 0.6], metric = the target covariance (dense) or its diagonal."""
    from dynamichmc_tpu_torch.metric import dense_metric, diagonal_metric
    from dynamichmc_tpu_torch.tree_batched import (
        exponential_like, gumbel_like, rand_p_b, random_directions)

    f32 = torch.float32
    dev = model.mean_fn().device
    K = model.dim
    prec_t, lchol, mu = model.tree_transition_fn.operands
    q = model.sample(gen, C)
    v, g = model.logdensity_and_gradient(q)
    minv = model.cov_fn().to(f32)
    if kind == "diag":
        minv = torch.diagonal(minv).contiguous()
    metric = diagonal_metric(minv) if kind == "diag" else dense_metric(minv)
    eps = torch.empty(C, device=dev).uniform_(0.2, 0.6, generator=gen)
    return (
        q, rand_p_b(gen, metric, (C, K), f32).contiguous(), g, v, eps,
        random_directions(gen, C, dev),
        gumbel_like(gen, ((1 << md) - 1, C), f32, dev),
        exponential_like(gen, (md, C), f32, dev), minv.contiguous(),
        prec_t, lchol, mu, dcap, -1000.0, md,
    )


def acceptance(raw):
    from dynamichmc_tpu_torch.nuts import AcceptanceStatistic, acceptance_rate

    return acceptance_rate(AcceptanceStatistic(raw["log_sum"], raw["steps"]))


def _rel_err(x, y):
    """|x - y| / (1 + |y|), 0 where both are the same infinity."""
    x, y = x.double(), y.double()
    return torch.where(x == y, 0.0, (x - y).abs() / (1 + y.abs()))


def compare_kernel_plain(model, C, md, kind, dcap, gen):
    """Phase 3 for one configuration, on the same injected noise:
    - depth, steps, term_left and term_right match on >= 99.9% of chains
      (summation orders differ, so a U-turn or Gumbel decision can flip
      where a dot product sits at 0);
    - on those chains ld' agrees with the plain float32 version to
      1e-4 (1 + |x|);
    - q', ld' and acceptance are no further from the float64 plain
      transition than twice the plain float32 version's distance, plus
      1e-5. q' and the acceptance carry the target's float32 conditioning:
      on correlated_gaussian(100) (covariance condition number ~5e3) the
      plain float32 transition itself lies up to ~3e-4 (1 + |q|) from the
      float64 one, and the acceptance inherits the absolute rounding of
      delta = pi - pi0 with |pi| ~ 1e2 (measured on the H100), so a fixed
      1e-4 between the two float32 versions does not hold for either."""
    from dynamichmc_tpu_torch.ops import tree_kernel

    args = kernel_inputs(model, C, md, kind, dcap, gen)
    out = tree_kernel.tree_transition(*args)
    ref = tree_kernel.tree_transition_plain(*args)
    ref64 = tree_kernel.tree_transition_plain(*(
        a.double() if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args
    ))
    if out["prop_q"].is_cuda:
        torch.cuda.synchronize()
    mismatch = {}
    same = torch.ones(C, dtype=torch.bool, device=out["depth"].device)
    for name in ("depth", "steps", "term_left", "term_right"):
        eq = out[name] == ref[name]
        mismatch[name] = int((~eq).sum())
        same &= eq
    frac = float(same.float().mean())
    result = {"config": f"{kind} dcap={dcap}", "chains": C,
              "mismatched_chains": mismatch, "matching_fraction": frac}
    check(frac >= 0.999, f"{result['config']}: discrete statistics match on "
                         f"only {frac:.4%} of chains")
    both = same
    for name in ("depth", "steps", "term_left", "term_right"):
        both = both & (ref64[name] == ref[name])
    fields = {
        "q": (out["prop_q"], ref["prop_q"], ref64["prop_q"]),
        "ld": (out["prop_ld"], ref["prop_ld"], ref64["prop_ld"]),
        "acceptance": (acceptance(out), acceptance(ref), acceptance(ref64)),
    }
    worst_abs, worst_rel, vs_f64 = {}, {}, {}
    for name, (x, y, z) in fields.items():
        xs, ys = x[same], y[same]
        worst_abs[name] = float(torch.where(xs == ys, 0.0, (xs - ys).abs()).max())
        worst_rel[name] = float(_rel_err(xs, ys).max())
        err_kernel = float(_rel_err(x[both], z[both]).max())
        err_plain = float(_rel_err(y[both], z[both]).max())
        vs_f64[name] = {"kernel": err_kernel, "plain_f32": err_plain}
        check(err_kernel <= 2 * err_plain + 1e-5,
              f"{result['config']}: kernel {name} is {err_kernel:.3g} from "
              f"float64, the plain float32 version {err_plain:.3g}")
    result.update({"max_abs_diff": worst_abs, "max_rel_diff": worst_rel,
                   "max_rel_err_vs_f64": vs_f64})
    check(worst_rel["ld"] <= 1e-4,
          f"{result['config']}: ld' differs by {worst_rel['ld']:.3g} (1 + |x|)")
    check(int(out["depth"].max()) <= dcap, "depth above dcap")
    return result


def main_path_config():
    from dynamichmc_tpu_torch.nuts import NUTS
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    stages = default_warmup_stages(metric_kind="dense", pooled=True,
                                   pooled_stepsize=False)
    return dict(
        tune="reference", warmup_stages=stages, algorithm=NUTS(max_depth=MD_MAIN),
        dtype=torch.float32, warmup_depth_clamp=2, warmup_depth_clamp_tail=25,
    )


def expected_transitions(n_draws):
    """Tree transitions of one run: every warmup step plus every draw."""
    stages = main_path_config()["warmup_stages"]
    return sum(s.N for s in stages[1:]) + n_draws


def run_main_path(model, C, n_draws, seed):
    """Phase 4: one run_chains call through the entry point a user calls;
    returns the result, its wall seconds and the kernel launches in it."""
    from dynamichmc_tpu_torch import run_chains
    from dynamichmc_tpu_torch.ops import tree_kernel

    dev = model.mean_fn().device
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    tree_kernel.reset_launches()
    t0 = time.perf_counter()
    res = run_chains(gen, model, C, n_draws, **main_path_config())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, seconds, tree_kernel.launches


def check_draws(model, res, seconds):
    """Finite draws of the expected shape that recover the target's moments;
    returns the phase-4 metrics."""
    from dynamichmc_tpu_torch.stats import ess_bulk

    C, N, K = res.positions.shape
    x = res.positions.double().cpu().numpy()
    check(np.isfinite(x).all(), "non-finite draws")
    cov = model.cov_fn().cpu().numpy()
    sd = np.sqrt(np.diag(cov))
    flat = x.reshape(-1, K)
    mean_err = np.abs(flat.mean(0)) / sd
    var_ratio = flat.var(0) / np.diag(cov)
    check(mean_err.max() <= 0.05, f"|mean| up to {mean_err.max():.4f} sd")
    check(var_ratio.min() >= 0.9 and var_ratio.max() <= 1.1,
          f"var ratio in [{var_ratio.min():.4f}, {var_ratio.max():.4f}]")
    t0 = time.perf_counter()
    ess = np.array([ess_bulk(x[:, :, j]) for j in range(K)])
    steps = int(res.tree_statistics.steps.sum())
    return {
        "wall_s": seconds,
        "min_bulk_ess_per_s": float(ess.min() / seconds),
        "mean_bulk_ess_per_s": float(ess.mean() / seconds),
        "min_bulk_ess": float(ess.min()),
        "grad_evals_per_s": steps / seconds,
        "draw_grad_evals": steps,
        "divergences": int(res.tree_statistics.is_divergent.sum()),
        "max_mean_err_sd": float(mean_err.max()),
        "var_ratio_range": [float(var_ratio.min()), float(var_ratio.max())],
        "ess_seconds": time.perf_counter() - t0,
    }


def time_transition(fn, args, reps):
    """ms per call with CUDA events, after one warm-up call."""
    fn(*args)
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamichmc_tpu_torch.models import correlated_gaussian
    from dynamichmc_tpu_torch.ops import tree_kernel

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    log(f"[1 device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    so = tree_kernel.build()
    log(f"[2 build] {os.path.relpath(so)} in {time.perf_counter() - t0:.1f} s")
    for line in tree_kernel.build_log.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            log(f"[2 build] {line.strip()}")

    model = correlated_gaussian(K_MAIN, dtype=torch.float32, device=dev,
                                tree_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    phase3 = []
    for kind, dcap in (("dense", MD_MAIN), ("diag", MD_MAIN), ("dense", 2)):
        r = compare_kernel_plain(model, C_MAIN, MD_MAIN, kind, dcap, gen)
        phase3.append(r)
        log(f"[3 kernel vs plain] {json.dumps(r)}")
    max_abs_err = max(r["max_abs_diff"]["q"] for r in phase3)

    run_main_path(model, C_MAIN, N_DRAWS, seed=9)  # untimed first run
    res, seconds, launches = run_main_path(model, C_MAIN, N_DRAWS, seed=SEED)
    expected = expected_transitions(N_DRAWS)
    check(launches == expected,
          f"kernel launched {launches} times in the timed run, expected "
          f"{expected} (one per transition)")
    check(tuple(res.positions.shape) == (C_MAIN, N_DRAWS, K_MAIN),
          f"positions shape {tuple(res.positions.shape)}")
    metrics = check_draws(model, res, seconds)
    metrics.update({"kernel_launches": launches, "chains": C_MAIN,
                    "draws": N_DRAWS, "dim": K_MAIN, "gpu": smi})
    log(f"[4 main path] {json.dumps(metrics)}")
    del res

    args = kernel_inputs(model, C_MAIN, MD_MAIN, "dense", MD_MAIN, gen)
    kernel_ms = time_transition(tree_kernel.tree_transition, args, reps=50)
    plain_ms = time_transition(tree_kernel.tree_transition_plain, args, reps=5)
    log(f"[5 kernel time] {json.dumps({'kernel_ms': kernel_ms, 'plain_ms': plain_ms, 'shape': [C_MAIN, K_MAIN, MD_MAIN], 'gpu': smi})}")

    print(json.dumps({"kernels": [{
        "name": "tree_transition",
        "route": "cuda",
        "source": "dynamichmc_tpu_torch/csrc/tree_kernel.cu",
        "replaces": "dynamichmc_tpu/ops/pallas_tree.py:93",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
