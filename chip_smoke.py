#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (each one that fails ends the script with a non-zero exit code):
  1. Device: the nvidia-smi name and power limit.
  2. Build: compile both CUDA sources (csrc/tree_kernel.cu,
     csrc/logreg_leaf.cu) with nvcc, one process each, started together.
  3. Kernel against plain, on the same injected noise / inputs:
     - the tree kernel with the Gaussian leaf at the main-path shape (4096
       chains, K = 100, max_depth 4, per-chain eps in [0.2, 0.6], start at
       draws of the target): dense metric = the target covariance, the
       diagonal metric, then dcap = 2;
     - the tree kernel with the funnel leaf: funnel(25), 4096 chains,
       max_depth 7, diagonal metric, per-chain eps, start at exact draws;
     - the tree kernel with the logreg leaf: 2048 chains, K = 128,
       n_obs = 4000, max_depth 4, diagonal metric = the Laplace posterior
       variances, start at draws of the Laplace approximation;
     - the fused logreg leaf at 2048 x 128 x 4000 with a shared diagonal,
       a per-chain diagonal and a shared dense metric.
  4. Paths, through run_chains as a user calls it, each with the pooled
     metric, per-chain dual-averaging eps, warmup depth clamp 2 with a
     25-step tail, 900 warmup transitions and 512 draws:
     - main: correlated_gaussian(100), dense metric, 4096 chains,
       NUTS(max_depth=4), tree kernel; once untimed, once timed;
     - funnel: funnel(25, sigma_v=3), diagonal metric, 4096 chains,
       NUTS(max_depth=7), tree kernel; timed;
     - logreg_tree: logistic_regression(4000, 128), diagonal metric, 2048
       chains, NUTS(max_depth=4), tree kernel; timed;
     - logreg_fused: the same model with the fused leaf in the plain
       driver; timed.
     Each checks that its kernel launched on every transition (for the
     fused leaf: on every leaf the driver executed), that the draws are
     finite, and the path's gate: the Gaussian's moments, the funnel's
     v-marginal (|mean v| <= 0.4, sd(v) in [2.7, 3.3]), the two logreg
     runs' agreement (every posterior mean within 5 combined MCSE). Each reports wall time,
     min and mean bulk ESS/s (device ESS, float64), gradient evaluations/s
     and divergences.
  5. Kernel time: each kernel and its plain version per call at its
     phase-3 shape.
With --profile, each path's timed run is repeated under torch.profiler
after phase 5 and the device split is printed.

The line before the last is the nvidia-smi name and power limit; the last
line is {"ok": true, "device": {...}}. Needs CUDA; never runs on the CPU.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

C_MAIN, K_MAIN, MD_MAIN, N_DRAWS = 4096, 100, 4, 512
C_FUNNEL, K_FUNNEL, MD_FUNNEL = 4096, 25, 7
C_LOGREG, K_LOGREG, N_OBS, MD_LOGREG = 2048, 128, 4000, 4
SEED = 0


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


T0 = time.perf_counter()


def log(msg):
    print(msg, flush=True)


def log_phase_done(phase):
    log(f"[time] phase {phase} done at {time.perf_counter() - T0:.1f} s")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def laplace(x, y, inv_s2):
    """Mode and covariance of the Laplace approximation of the logreg
    posterior with data (x, y) and prior precision inv_s2, in float64:
    Newton's method from 0."""
    x, y = x.double(), y.double()
    K = x.shape[1]
    eye = torch.eye(K, dtype=torch.float64, device=x.device)
    beta = torch.zeros(K, dtype=torch.float64, device=x.device)
    for _ in range(20):
        s = torch.sigmoid(x @ beta)
        grad = x.mT @ (y - s) - inv_s2 * beta
        hess = x.mT @ (x * (s * (1 - s))[:, None]) + inv_s2 * eye
        beta = beta + torch.linalg.solve(hess, grad)
    return beta, torch.linalg.inv(hess).contiguous()  # inv is column-major


def start_point(model, C, gen):
    """Phase-3 start and full M^-1: draws of the target with its covariance
    (Gaussian), exact draws with the diagonal metric of the adapted pooled
    run (funnel), draws of the Laplace approximation with its covariance
    (logreg)."""
    from dynamichmc_tpu_torch.ops import tree_kernel

    leaf = model.tree_transition_fn.leaf
    if leaf.kind == tree_kernel.LOGREG:
        x, _xt, y = leaf.operands
        mode, cov = laplace(x, y, leaf.scalars[0])
        z = torch.randn((C, model.dim), generator=gen, dtype=torch.float64,
                        device=mode.device)
        q = (mode + z @ torch.linalg.cholesky(cov).mT).float()
        return q, cov.float()
    q = model.sample(gen, C)
    if leaf.kind == tree_kernel.FUNNEL:
        # per-coordinate variances of the pooled diagonal metric the funnel
        # path adapts (v, then x_1..x_24)
        minv = torch.full((model.dim,), FUNNEL_X_VAR, device=q.device)
        minv[0] = FUNNEL_V_VAR
        return q, torch.diag(minv)
    return q, model.cov_fn().to(torch.float32)


# The funnel path's adapted pooled diagonal metric and per-chain eps are
# about these (the port's plain path at 256 chains on the CPU, two seeds:
# M^-1 7.3-7.6 for v and 2.5-3.7 for the x_i, eps 0.006 to 0.12).
FUNNEL_V_VAR, FUNNEL_X_VAR = 7.5, 3.0
EPS_RANGE = {0: (0.2, 0.6), 1: (0.02, 0.12), 2: (0.1, 0.4)}  # by leaf kind


def kernel_inputs(model, C, md, kind, dcap, gen):
    """Phase-3 inputs of the tree kernel: a start (start_point), per-chain
    eps in the leaf's range, metric = the full M^-1 (dense) or its
    diagonal, momenta and noise from ``gen``."""
    from dynamichmc_tpu_torch.metric import dense_metric, diagonal_metric
    from dynamichmc_tpu_torch.tree_batched import (
        exponential_like, gumbel_like, rand_p_b, random_directions)

    f32 = torch.float32
    leaf = model.tree_transition_fn.leaf
    K = model.dim
    q, minv = start_point(model, C, gen)
    dev = q.device
    v, g = model.logdensity_and_gradient(q)
    if kind == "diag":
        minv = torch.diagonal(minv).contiguous()
    metric = diagonal_metric(minv) if kind == "diag" else dense_metric(minv)
    lo, hi = EPS_RANGE[leaf.kind]
    eps = torch.empty(C, device=dev).uniform_(lo, hi, generator=gen)
    return (
        q, rand_p_b(gen, metric, (C, K), f32).contiguous(), g, v, eps,
        random_directions(gen, C, dev),
        gumbel_like(gen, ((1 << md) - 1, C), f32, dev),
        exponential_like(gen, (md, C), f32, dev), minv.contiguous(),
        leaf.to(dev), dcap, -1000.0, md,
    )


def acceptance(raw):
    from dynamichmc_tpu_torch.nuts import AcceptanceStatistic, acceptance_rate

    return acceptance_rate(AcceptanceStatistic(raw["log_sum"], raw["steps"]))


def _rel_err(x, y):
    """|x - y| / (1 + |y|), 0 where both are the same infinity."""
    x, y = x.double(), y.double()
    return torch.where(x == y, 0.0, (x - y).abs() / (1 + y.abs()))


def _as64(args):
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def compare_kernel_plain(name, model, C, md, kind, dcap, gen):
    """Phase 3 for one tree-kernel configuration, on the same injected
    noise:
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
    ref64 = tree_kernel.tree_transition_plain(*_as64(args))
    torch.cuda.synchronize()
    mismatch = {}
    same = torch.ones(C, dtype=torch.bool, device=out["depth"].device)
    for stat in ("depth", "steps", "term_left", "term_right"):
        eq = out[stat] == ref[stat]
        mismatch[stat] = int((~eq).sum())
        same &= eq
    frac = float(same.float().mean())
    result = {"config": f"{name} {kind} dcap={dcap}", "chains": C,
              "mismatched_chains": mismatch, "matching_fraction": frac,
              "divergent_chains": int((ref["prop_pi"] == -torch.inf).sum())}
    fails = []
    want = lambda cond, msg: cond or fails.append(msg)  # noqa: E731
    want(frac >= 0.999, f"{result['config']}: discrete statistics match on "
                        f"only {frac:.4%} of chains")
    both = same
    for stat in ("depth", "steps", "term_left", "term_right"):
        both = both & (ref64[stat] == ref[stat])
    fields = {
        "q": (out["prop_q"], ref["prop_q"], ref64["prop_q"]),
        "ld": (out["prop_ld"], ref["prop_ld"], ref64["prop_ld"]),
        "acceptance": (acceptance(out), acceptance(ref), acceptance(ref64)),
    }
    worst_abs, worst_rel, vs_f64 = {}, {}, {}
    for field, (x, y, z) in fields.items():
        xs, ys = x[same], y[same]
        worst_abs[field] = float(torch.where(xs == ys, 0.0, (xs - ys).abs()).max())
        worst_rel[field] = float(_rel_err(xs, ys).max())
        err_kernel = float(_rel_err(x[both], z[both]).max())
        err_plain = float(_rel_err(y[both], z[both]).max())
        vs_f64[field] = {"kernel": err_kernel, "plain_f32": err_plain}
        want(err_kernel <= 2 * err_plain + 1e-5,
              f"{result['config']}: kernel {field} is {err_kernel:.3g} from "
              f"float64, the plain float32 version {err_plain:.3g}")
    result.update({"max_abs_diff": worst_abs, "max_rel_diff": worst_rel,
                   "max_rel_err_vs_f64": vs_f64})
    want(worst_rel["ld"] <= 1e-4,
         f"{result['config']}: ld' differs by {worst_rel['ld']:.3g} (1 + |x|)")
    want(int(out["depth"].max()) <= dcap, "depth above dcap")
    log(f"[3 kernel vs plain] {json.dumps(result)}")
    check(not fails, "; ".join(fails))
    return result


def fused_leaf_inputs(model, C, kind, gen):
    """Phase-3 inputs of the fused logreg leaf: Laplace draws, the metric
    (Laplace covariance, its diagonal, or the diagonal scaled per chain by
    U[0.8, 1.25]), momenta from it, the model's gradient, and a signed
    per-chain eps with |eps| in [0.1, 0.4]."""
    from dynamichmc_tpu_torch.metric import dense_metric, diagonal_metric
    from dynamichmc_tpu_torch.tree_batched import rand_p_b

    hook = model.fused_leaf_batched_fn
    x32, y32 = hook.operands
    mode, cov = laplace(x32, y32, hook.inv_s2)
    dev = mode.device
    z = torch.randn((C, model.dim), generator=gen, dtype=torch.float64,
                    device=dev)
    q = (mode + z @ torch.linalg.cholesky(cov).mT).float().contiguous()
    if kind == "shared_dense":
        metric = dense_metric(cov.float())
    else:
        m = torch.diagonal(cov).float().contiguous()
        if kind == "chain_diag":
            m = (m * torch.empty((C, 1), device=dev).uniform_(
                0.8, 1.25, generator=gen)).contiguous()
        metric = diagonal_metric(m)
    p = rand_p_b(gen, metric, (C, model.dim), torch.float32).contiguous()
    _v, g = model.logdensity_and_gradient(q)
    sign = torch.where(torch.rand(C, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    eps = (sign * torch.empty(C, device=dev).uniform_(0.1, 0.4, generator=gen))
    return metric, q, p, g.contiguous(), eps.contiguous(), x32, y32, hook.inv_s2


def compare_fused_leaf(model, C, kind, gen):
    """Phase 3 for the fused logreg leaf in one metric form:
    - ld' and pi' agree with the plain float32 version to 1e-4 (1 + |x|);
    - q', p', g', ld' and pi' are no further from the float64 plain leaf
      than twice the plain float32 version's distance, plus 1e-5 (1 + |x|):
      the plain version sums the 4000 observations in cuBLAS's order, the
      kernel in its own tiles;
    - the -inf pattern of ld' and pi' is the plain version's."""
    from dynamichmc_tpu_torch.ops import logreg_leaf

    args = fused_leaf_inputs(model, C, kind, gen)
    out = logreg_leaf.logreg_leaf(*args)
    ref = logreg_leaf.logreg_leaf_plain(*args)
    metric = args[0]
    metric64 = type(metric)(metric.m_inv.double(), None)
    ref64 = logreg_leaf.logreg_leaf_plain(metric64, *_as64(args[1:]))
    torch.cuda.synchronize()
    result = {"config": f"logreg_fused {kind}", "chains": C}
    fails = []
    want = lambda cond, msg: cond or fails.append(msg)  # noqa: E731
    names = ("q", "p", "g", "ld", "pi")
    worst_abs, worst_rel, vs_f64 = {}, {}, {}
    for name, x, y, z in zip(names, out, ref, ref64):
        want(torch.equal(torch.isneginf(x), torch.isneginf(y)),
             f"{result['config']}: {name}' -inf pattern differs")
        worst_abs[name] = float(torch.where(x == y, 0.0, (x - y).abs()).max())
        worst_rel[name] = float(_rel_err(x, y).max())
        err_kernel = float(_rel_err(x, z).max())
        err_plain = float(_rel_err(y, z).max())
        vs_f64[name] = {"kernel": err_kernel, "plain_f32": err_plain}
        want(err_kernel <= 2 * err_plain + 1e-5,
             f"{result['config']}: kernel {name}' is {err_kernel:.3g} from "
             f"float64, the plain float32 version {err_plain:.3g}")
    for name in ("ld", "pi"):
        want(worst_rel[name] <= 1e-4, f"{result['config']}: {name}' differs "
             f"by {worst_rel[name]:.3g} (1 + |x|)")
    result.update({"max_abs_diff": worst_abs, "max_rel_diff": worst_rel,
                   "max_rel_err_vs_f64": vs_f64})
    log(f"[3 kernel vs plain] {json.dumps(result)}")
    check(not fails, "; ".join(fails))
    return result


def path_config(metric_kind, max_depth):
    from dynamichmc_tpu_torch.nuts import NUTS
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    stages = default_warmup_stages(metric_kind=metric_kind, pooled=True,
                                   pooled_stepsize=False)
    return dict(
        tune="reference", warmup_stages=stages,
        algorithm=NUTS(max_depth=max_depth), dtype=torch.float32,
        warmup_depth_clamp=2, warmup_depth_clamp_tail=25,
    )


def main_path_config():
    return path_config("dense", MD_MAIN)


def expected_transitions(n_draws):
    """Tree transitions of one run: every warmup step plus every draw."""
    stages = main_path_config()["warmup_stages"]
    return sum(s.N for s in stages[1:]) + n_draws


def reset_counts():
    from dynamichmc_tpu_torch import tree_batched
    from dynamichmc_tpu_torch.ops import logreg_leaf, tree_kernel

    tree_kernel.reset_launches()
    logreg_leaf.reset_launches()
    tree_batched.reset_fused_leaf_calls()


def read_counts():
    from dynamichmc_tpu_torch import tree_batched
    from dynamichmc_tpu_torch.ops import logreg_leaf, tree_kernel

    return {"tree_transition": tree_kernel.launches,
            "logreg_fused_leaf": logreg_leaf.launches,
            "driver_fused_leaves": tree_batched.fused_leaf_calls}


def run_path(model, C, n_draws, seed, config, dev):
    """Phase 4: one run_chains call through the entry point a user calls;
    returns the result, its wall seconds and the launch counts of the
    run (every count set to 0 just before it)."""
    from dynamichmc_tpu_torch import run_chains

    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = run_chains(gen, model, C, n_draws, **config)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, seconds, read_counts()


def path_metrics(res, seconds):
    """Finite draws of the expected shape; device bulk ESS (float64);
    returns the phase-4 metrics and the per-coordinate ESS."""
    from dynamichmc_tpu_torch.stats_device import ess_bulk_device

    check(bool(torch.isfinite(res.positions).all()), "non-finite draws")
    t0 = time.perf_counter()
    ess = ess_bulk_device(res.positions)
    torch.cuda.synchronize()
    ess_seconds = time.perf_counter() - t0
    check(bool(torch.isfinite(ess).all()), "non-finite ESS")
    steps = int(res.tree_statistics.steps.sum())
    return {
        "wall_s": seconds,
        "min_bulk_ess_per_s": float(ess.min()) / seconds,
        "mean_bulk_ess_per_s": float(ess.mean()) / seconds,
        "min_bulk_ess": float(ess.min()),
        "grad_evals_per_s": steps / seconds,
        "draw_grad_evals": steps,
        "divergences": int(res.tree_statistics.is_divergent.sum()),
        "ess_seconds": ess_seconds,
    }, ess


def check_draws(model, res, seconds):
    """The main path's gate: the draws recover the target's moments; the
    device ESS agrees with the host ESS (stats.ess_bulk) on three
    coordinates to 1e-6 relative. Returns the phase-4 metrics."""
    from dynamichmc_tpu_torch.stats import ess_bulk

    C, N, K = res.positions.shape
    metrics, ess = path_metrics(res, seconds)
    x = res.positions.double()
    cov = model.cov_fn().to(x.device)
    var = torch.diagonal(cov)
    flat = x.reshape(-1, K)
    mean_err = (flat.mean(0).abs() / var.sqrt()).cpu().numpy()
    var_ratio = (flat.var(0, correction=0) / var).cpu().numpy()
    check(mean_err.max() <= 0.05, f"|mean| up to {mean_err.max():.4f} sd")
    check(var_ratio.min() >= 0.9 and var_ratio.max() <= 1.1,
          f"var ratio in [{var_ratio.min():.4f}, {var_ratio.max():.4f}]")
    t0 = time.perf_counter()
    host = np.array([ess_bulk(x[:, :, j].cpu().numpy()) for j in range(3)])
    dev = ess[:3].cpu().numpy()
    rel = float(np.max(np.abs(dev / host - 1)))
    check(rel <= 1e-6, f"device ESS differs from the host ESS by {rel:.3g}")
    metrics.update({
        "max_mean_err_sd": float(mean_err.max()),
        "var_ratio_range": [float(var_ratio.min()), float(var_ratio.max())],
        "device_vs_host_ess_rel": rel,
        "host_ess_seconds_3_coords": time.perf_counter() - t0,
    })
    return metrics


def check_funnel(res, seconds):
    """v ~ N(0, 3^2): |mean v| <= 0.4 and sd(v) in [2.7, 3.3]. At this
    configuration (900 warmup transitions, 512 draws, max_depth 7) the
    draws of the JAX package and of this port carry the same offset:
    mean(v) -0.19 to -0.28 and sd(v) 2.81-2.87 over four seeds each, about
    8 Monte Carlo standard errors at 4096 chains; at max_depth 10 both
    give -0.09 to -0.18. In longer runs both settle above 0 (+0.1 to
    +0.25, sd 2.7-2.8) with more divergences, the funnel's neck being
    under-sampled, so this gate holds the 512 draws of this configuration
    only. The band on the mean is 0.4, not 0.3, so that the gate keeps a
    4-MCSE margin over the worst seed."""
    metrics, _ess = path_metrics(res, seconds)
    v = res.positions[:, :, 0].double()
    mean_v, sd_v = float(v.mean()), float(v.std(correction=0))
    check(abs(mean_v) <= 0.4, f"funnel mean(v) = {mean_v:.4f}")
    check(2.7 <= sd_v <= 3.3, f"funnel sd(v) = {sd_v:.4f}")
    metrics.update({"mean_v": mean_v, "sd_v": sd_v})
    return metrics


def posterior_summary(res, ess):
    x = res.positions.double()
    flat = x.reshape(-1, x.shape[2])
    return flat.mean(0), flat.std(0, correction=0), ess


def check_logreg_agreement(a, b):
    """Every coordinate's posterior mean of the two runs agrees within 5
    combined Monte Carlo standard errors (sd / sqrt(ESS) of each run)."""
    (ma, sa, ea), (mb, sb, eb) = a, b
    mcse = torch.sqrt(sa**2 / ea + sb**2 / eb)
    z = ((ma - mb).abs() / mcse)
    check(bool((z <= 5).all()), f"logreg runs disagree: max |dmean| / mcse "
                                f"= {float(z.max()):.3f}")
    return float(z.max())


def time_call(fn, args, reps):
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


def profile_run(name, fn):
    """fn() under torch.profiler: wall, device time of the kernels by name,
    other device work and the idle share (1 - device busy / wall)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type.name == "CUDA":
            rows.append((e.key, dev_us, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    kern = [r for r in rows if "tree_transition_kernel" in r[0]
            or "logreg_leaf_kernel" in r[0]]
    ours = sum(r[1] for r in kern) / 1e6
    return {"path": name, "profiled_wall_s": wall,
            "kernels": [{"name": r[0][:60], "device_s": r[1] / 1e6,
                         "calls": r[2]} for r in kern],
            "kernel_share": ours / wall, "other_device_share": (busy - ours) / wall,
            "idle_share": 1 - busy / wall,
            "top_other": [{"name": r[0][:60], "device_s": r[1] / 1e6,
                           "calls": r[2]} for r in rows if r not in kern][:6]}


def build_all():
    """Phase 2: both CUDA libraries, one nvcc each, in parallel."""
    from dynamichmc_tpu_torch.ops import logreg_leaf, tree_kernel

    libs = (tree_kernel.library, logreg_leaf.library)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        paths = list(pool.map(lambda lib: lib.build(), libs))
    seconds = time.perf_counter() - t0
    for lib, so in zip(libs, paths):
        log(f"[2 build] {os.path.relpath(so)} ({seconds:.1f} s for both)")
        for line in lib.build_log.splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                log(f"[2 build] {line.strip()}")
        lib.load()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    log(f"[1 device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32}")
    build_all()
    run_phases(dev, smi, profile="--profile" in sys.argv[1:])
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(dev, smi, profile=False):
    """Phases 3-5 on ``dev``; prints the kernels line."""
    from dynamichmc_tpu_torch.models import (
        correlated_gaussian, funnel, logistic_regression)
    from dynamichmc_tpu_torch.ops import logreg_leaf, tree_kernel

    # --- phase 3: every kernel against its plain version -----------------
    gauss = correlated_gaussian(K_MAIN, dtype=torch.float32, device=dev,
                                tree_kernel=True)
    fun = funnel(K_FUNNEL, dtype=torch.float32, device=dev, tree_kernel=True)
    lr_tree = logistic_regression(N_OBS, K_LOGREG, dtype=torch.float32,
                                  device=dev, tree_kernel=True)
    lr_fused = logistic_regression(N_OBS, K_LOGREG, dtype=torch.float32,
                                   device=dev, fused=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    phase3 = {"gaussian": [], "funnel": [], "logreg_tree": [], "logreg_fused": []}

    def phase3_result(key, r):
        phase3[key].append(r)

    for kind, dcap in (("dense", MD_MAIN), ("diag", MD_MAIN), ("dense", 2)):
        phase3_result("gaussian", compare_kernel_plain(
            "gaussian", gauss, C_MAIN, MD_MAIN, kind, dcap, gen))
    phase3_result("funnel", compare_kernel_plain(
        "funnel", fun, C_FUNNEL, MD_FUNNEL, "diag", MD_FUNNEL, gen))
    phase3_result("logreg_tree", compare_kernel_plain(
        "logreg", lr_tree, C_LOGREG, MD_LOGREG, "diag", MD_LOGREG, gen))
    for kind in ("shared_diag", "chain_diag", "shared_dense"):
        phase3_result("logreg_fused",
                      compare_fused_leaf(lr_fused, C_LOGREG, kind, gen))
    log_phase_done(3)
    max_abs = {name: max(max(r["max_abs_diff"][f] for f in ("q", "p", "g")
                             if f in r["max_abs_diff"]) for r in results)
               for name, results in phase3.items()}

    # --- phase 4: the paths ---------------------------------------------
    expected = expected_transitions(N_DRAWS)
    run_path(gauss, C_MAIN, N_DRAWS, 9, main_path_config(), dev)  # untimed
    paths = {
        "main": (gauss, C_MAIN, main_path_config()),
        "funnel": (fun, C_FUNNEL, path_config("diagonal", MD_FUNNEL)),
        "logreg_tree": (lr_tree, C_LOGREG, path_config("diagonal", MD_LOGREG)),
        "logreg_fused": (lr_fused, C_LOGREG, path_config("diagonal", MD_LOGREG)),
    }
    launches, summaries = {}, {}
    for name, (model, C, config) in paths.items():
        res, seconds, counts = run_path(model, C, N_DRAWS, SEED, config, dev)
        check(tuple(res.positions.shape) == (C, N_DRAWS, model.dim),
              f"{name}: positions shape {tuple(res.positions.shape)}")
        if name == "logreg_fused":
            check(counts["tree_transition"] == 0,
                  f"{name}: the tree kernel launched")
            check(counts["logreg_fused_leaf"] == counts["driver_fused_leaves"] > 0,
                  f"{name}: fused leaf launched {counts['logreg_fused_leaf']} "
                  f"times for {counts['driver_fused_leaves']} driver leaves")
            launches[name] = counts["logreg_fused_leaf"]
        else:
            check(counts["tree_transition"] == expected,
                  f"{name}: kernel launched {counts['tree_transition']} times "
                  f"in the run, expected {expected} (one per transition)")
            check(counts["logreg_fused_leaf"] == 0, f"{name}: fused leaf launched")
            launches[name] = counts["tree_transition"]
        if name == "main":
            metrics = check_draws(model, res, seconds)
        elif name == "funnel":
            metrics = check_funnel(res, seconds)
        else:
            metrics, ess = path_metrics(res, seconds)
            summaries[name] = posterior_summary(res, ess)
        metrics.update({"path": name, "launch_counts": counts, "chains": C,
                        "draws": N_DRAWS, "dim": model.dim,
                        "adapted_eps_range": [float(res.eps.min()),
                                              float(res.eps.max())],
                        "gpu": smi})
        log(f"[4 path] {json.dumps(metrics)}")
        del res
    z = check_logreg_agreement(summaries["logreg_tree"], summaries["logreg_fused"])
    log(f"[4 path] logreg_tree vs logreg_fused: max |dmean| / mcse = {z:.4f}")

    log_phase_done(4)

    # --- phase 5: kernel time against plain ------------------------------
    times = {}
    args = kernel_inputs(gauss, C_MAIN, MD_MAIN, "dense", MD_MAIN, gen)
    times["gaussian"] = (time_call(tree_kernel.tree_transition, args, 50),
                         time_call(tree_kernel.tree_transition_plain, args, 5))
    args = kernel_inputs(fun, C_FUNNEL, MD_FUNNEL, "diag", MD_FUNNEL, gen)
    times["funnel"] = (time_call(tree_kernel.tree_transition, args, 20),
                       time_call(tree_kernel.tree_transition_plain, args, 3))
    args = kernel_inputs(lr_tree, C_LOGREG, MD_LOGREG, "diag", MD_LOGREG, gen)
    times["logreg_tree"] = (time_call(tree_kernel.tree_transition, args, 5),
                            time_call(tree_kernel.tree_transition_plain, args, 3))
    args = fused_leaf_inputs(lr_fused, C_LOGREG, "shared_diag", gen)
    times["logreg_fused"] = (time_call(logreg_leaf.logreg_leaf, args, 50),
                             time_call(logreg_leaf.logreg_leaf_plain, args, 50))
    shapes = {"gaussian": [C_MAIN, K_MAIN, MD_MAIN, "dense"],
              "funnel": [C_FUNNEL, K_FUNNEL, MD_FUNNEL, "diag"],
              "logreg_tree": [C_LOGREG, K_LOGREG, N_OBS, MD_LOGREG, "diag"],
              "logreg_fused": [C_LOGREG, K_LOGREG, N_OBS, "shared_diag"]}
    for name, (kernel_ms, plain_ms) in times.items():
        log(f"[5 kernel time] {json.dumps({'kernel': name, 'kernel_ms': kernel_ms, 'plain_ms': plain_ms, 'shape': shapes[name], 'gpu': smi})}")

    log_phase_done(5)
    if profile:
        for name, (model, C, config) in paths.items():
            log(f"[profile] {json.dumps(profile_run(name, lambda: run_path(model, C, N_DRAWS, SEED, config, dev)))}")

    entries = [
        ("tree_transition", "gaussian", "main", "dynamichmc_tpu/ops/pallas_tree.py:93",
         "tree_kernel.cu"),
        ("tree_transition_funnel", "funnel", "funnel",
         "dynamichmc_tpu/ops/pallas_tree.py:707", "tree_kernel.cu"),
        ("tree_transition_logreg", "logreg_tree", "logreg_tree",
         "dynamichmc_tpu/ops/pallas_tree.py:762", "tree_kernel.cu"),
        ("logreg_fused_leaf", "logreg_fused", "logreg_fused",
         "dynamichmc_tpu/ops/pallas_logreg.py:53", "logreg_leaf.cu"),
    ]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"dynamichmc_tpu_torch/csrc/{src}",
        "replaces": replaces,
        "launches": launches[path],
        "max_abs_err": max_abs[key],
        "ms": times[key][0],
        "plain_ms": times[key][1],
    } for name, key, path, replaces, src in entries]}))


if __name__ == "__main__":
    sys.exit(main())
