#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile[=PATH,...]]

Phases (each one that fails ends the script with a non-zero exit code):
  1. Device: the nvidia-smi name and power limit.
  2. Build: compile the three CUDA sources (csrc/tree_kernel.cu,
     csrc/logreg_leaf.cu, csrc/gaussian_leaf.cu) with nvcc, one process
     each, started together; print ptxas's registers and spills, and fail
     if any of the 16 instantiations of the tree kernel's warp variant
     (Gaussian and funnel leaves, diagonal and dense, R = 1-4) spills;
     print the funnel's registers in both variants and each variant's
     residency at the funnel path's shape; print ptxas's usage and spill
     line of the fused Gaussian kernel's 16 instantiations (K2 and K4,
     shared and per-chain M^-1, R = 1 and 8, exact and compensated column
     sums) and fail if one spills; print
     its launch plan at each phase-5 shape (chains per CTA, R, warps, CTAs,
     staging, registers and CTAs per SM).
  3. Kernel against plain, on the same injected noise / inputs:
     - the tree kernel with the Gaussian leaf at the main-path shape (4096
       chains, K = 100, max_depth 4, per-chain eps in [0.2, 0.6], start at
       draws of the target): dense metric = the target covariance, the
       diagonal metric, then dcap = 2; each launch must take the warp
       variant (one warp per chain); the same three at K = 129, past the
       warp variant, where each launch must take the CTA variant (one CTA
       per chain), as must every other configuration;
     - the tree kernel with the funnel leaf: funnel(25), 4096 chains,
       max_depth 7, per-chain eps, start at exact draws: diagonal metric,
       dense metric, then dcap = 2, each through the warp variant; the
       same three at K = 129, each through the CTA variant and held to
       float64's discrete statistics (compare_kernel_plain's ``ties``);
     - the tree kernel with the logreg leaf: 2048 chains, K = 128,
       n_obs = 4000, max_depth 4, diagonal metric = the Laplace posterior
       variances, start at draws of the Laplace approximation;
     - the fused logreg leaf at 2048 x 128 x 4000 with a shared diagonal,
       a per-chain diagonal and a shared dense metric, and the same at
       K = 300 (the gradient in two chunks of coordinates);
     - the fused Gaussian leaf (K2) at 4096 x 25 on N(0, I) with a shared
       and a per-chain diagonal metric, and at 4096 x 100 on
       correlated_gaussian(100) with a per-chain one; the fused Gaussian
       leapfrog (K4) at 4096 x 25 with a per-chain diagonal metric and at
       1 x 25 with the chain's own; K2 at 4096 chains on both sides of its
       staging limit (the last K whose plan stages prec and L, with a
       per-chain diagonal, and the next, shared) and both at 4097 x 25 (the
       last tile holds one chain); two rows of each poisoned.
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
     Then BASELINE config 1, N(0, I_25) = mvnormal(0, I, fused=True), with
     the reference-default warmup (stepsize search, 900 transitions,
     per-chain diagonal metric and dual averaging, NUTS(), no clamp):
     - gauss_fused: run_chains, 4096 chains, 512 draws, every leaf of the
       plain driver through the fused Gaussian leaf; timed;
     - per_chain: mcmc_with_warmup, one chain per call, seeds 0-3, 1000
       draws each, every leapfrog through the fused Gaussian leapfrog;
       the four calls timed together.
     Each checks that its kernel launched on every transition (for the
     fused leaves: on every leaf the driver executed; for the leapfrog: on
     every hamiltonian.leapfrog call; on the main and funnel paths every
     transition through the tree kernel's warp variant, on no other path
     any), that the draws are finite, and the
     path's gate: the Gaussian's moments, the funnel's v-marginal (|mean
     v| <= 0.4, sd(v) in [2.7, 3.3]), the two logreg runs' agreement
     (every posterior mean within 5 combined MCSE), N(0, I)'s moments and,
     per chain, split R-hat and the acceptance rate. Each reports wall
     time, min and mean bulk ESS/s (device ESS, float64), gradient
     evaluations/s and divergences.
  5. Kernel time: each kernel and its plain version per call at its
     phase-3 shape (CUDA events around the wrapper calls), the fused
     Gaussian kernels' device time (torch.profiler), and each kernel's
     bound: the larger of its operations over the fp32 peak and its bytes
     over the memory rate, counted from this run's inputs. The fused
     Gaussian kernels also at the hooks as the paths call them (K2's on
     4096 x 25 with a per-chain diagonal, K4's on one chain's (K,) tensors
     and a 0-d eps) and K2 at 1 x 1, the binding's own floor, each line
     with its launch plan. The fused
     logreg leaf's line also gives its launch plan: the observation
     slices S, registers, shared memory and CTAs per SM; the Gaussian and
     funnel tree kernels' their variant and plan: warps per CTA,
     registers, shared memory, CTAs per SM and resident warps per SM (the
     funnel's beside the CTA variant's plan at the same shape).
With --profile, each path's timed run is repeated under torch.profiler
after phase 5 and the device split is printed; --profile=main,funnel
profiles the paths named only.

The line before the last is the nvidia-smi name and power limit; the last
line is {"ok": true, "device": {...}}. Needs CUDA; never runs on the CPU.
"""

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

C_MAIN, K_MAIN, MD_MAIN, N_DRAWS = 4096, 100, 4, 512
K_CTA = 129  # the Gaussian and funnel leaves one past the warp variant, phase 3
C_FUNNEL, K_FUNNEL, MD_FUNNEL = 4096, 25, 7
C_LOGREG, K_LOGREG, N_OBS, MD_LOGREG = 2048, 128, 4000, 4
K_WIDE = 300  # the fused logreg leaf past 256 coordinates, phase 3
C_GAUSS, K_GAUSS = 4096, 25  # BASELINE config 1 under the fleet
N_PER_CHAIN, PER_CHAIN_SEEDS = 1000, (0, 1, 2, 3)
SEED = 0
# H100 SXM peaks (NVIDIA's data sheet): fp32 outside the tensor
# cores, and device memory
FP32_FLOP_PER_S, HBM_BYTES_PER_S = 67e12, 3.35e12


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
        x, y = leaf.logreg_data()
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


def _worst(err, q99=False):
    """The largest per-chain error (the largest over a chain's coordinates),
    or with ``q99`` their 99th percentile."""
    per_chain = err.reshape(err.shape[0], -1).amax(-1).double()
    return float(torch.quantile(per_chain, 0.99) if q99 else per_chain.max())


def _as64(args):
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def compare_kernel_plain(name, model, C, md, kind, dcap, gen, expect,
                         ties=False):
    """Phase 3 for one tree-kernel configuration, on the same injected
    noise:
    - kernel_variant names ``expect`` ("warp" or "cta") for the shape, and
      the launch takes it;
    - depth, steps, term_left, term_right and the proposal's leaf of the
      trajectory (ops/proposal_leaf.py) match on >= 99.9% of chains
      (summation orders differ, so a U-turn or Gumbel decision can flip
      where a dot product sits at 0 or scores tie);
    - on those chains ld' agrees with the plain float32 version to
      1e-4 (1 + |x|), and the -inf rows of ld' and pi' are the plain
      version's;
    - on those of them where the float64 plain transition has the same
      discrete statistics and leaf, q', grad', ld', log_sum and
      acceptance are no further from it than twice the plain float32
      version's distance, plus 1e-5. q' and the acceptance carry the
      target's float32 conditioning:
      on correlated_gaussian(100) (covariance condition number ~5e3) the
      plain float32 transition itself lies up to ~3e-4 (1 + |q|) from the
      float64 one, and the acceptance inherits the absolute rounding of
      delta = pi - pi0 with |pi| ~ 1e2 (measured on the H100), so a fixed
      1e-4 between the two float32 versions does not hold for either;
    - a second launch on the same inputs gives bitwise the same outputs.
    ``ties`` is for a shape whose float32 transition is chaotic, so that
    another summation order alone moves a few chains in a thousand by far
    more than rounding: the funnel past K = 128 at max_depth 7, where the
    plain float32 version leaves the float64 one's discrete statistics on
    5-11 of 4096 chains (measured on the H100), and the plain transition
    with only sum q^2 reordered leaves the plain one's ld' by up to 8e-3
    (1 + |x|) and fails the rule against float64 on half the
    configurations by its maximum, never by its 99th percentile
    (scripts/torch_funnel_order_sensitivity.py, CPU). There the kernel may
    leave the float64 version's discrete statistics on no more chains than
    twice the plain float32 version does, plus 0.1% (in place of the 99.9%
    match), and each continuous rule holds the 99th percentile of the
    per-chain errors in place of their maximum."""
    from dynamichmc_tpu_torch.ops import tree_kernel
    from dynamichmc_tpu_torch.ops.proposal_leaf import proposal_offsets

    args = kernel_inputs(model, C, md, kind, dcap, gen)
    warp0 = tree_kernel.warp_launches
    out = tree_kernel.tree_transition(*args)
    again = tree_kernel.tree_transition(*args)
    warp_runs = tree_kernel.warp_launches - warp0
    ref = tree_kernel.tree_transition_plain(*args)
    ref64 = tree_kernel.tree_transition_plain(*_as64(args))
    leaf_k, leaf_32, leaf_64 = proposal_offsets(
        *args[:5], args[8], args[9].value_and_grad, dcap,
        [out["prop_q"], ref["prop_q"], ref64["prop_q"]])
    torch.cuda.synchronize()
    mismatch = {"leaf": int((leaf_k != leaf_32).sum())}
    same = leaf_k == leaf_32
    for stat in ("depth", "steps", "term_left", "term_right"):
        eq = out[stat] == ref[stat]
        mismatch[stat] = int((~eq).sum())
        same &= eq
    frac = float(same.float().mean())
    off64 = {}  # chains whose discrete statistics differ from float64's
    for who, out_x, leaf_x in (("kernel", out, leaf_k), ("plain_f32", ref, leaf_32)):
        differ = leaf_x != leaf_64
        for stat in ("depth", "steps", "term_left", "term_right"):
            differ |= out_x[stat] != ref64[stat]
        off64[who] = int(differ.sum())
    variant = tree_kernel.kernel_variant(args[9].kind, model.dim, md,
                                         kind == "diag")
    result = {"config": f"{name} K={model.dim} {kind} dcap={dcap}", "chains": C,
              "mismatched_chains": mismatch, "matching_fraction": frac,
              "chains_off_float64": off64,
              "divergent_chains": int((ref["prop_pi"] == -torch.inf).sum()),
              "variant": variant, "warp_variant_launches": warp_runs}
    fails = []
    want = lambda cond, msg: cond or fails.append(msg)  # noqa: E731
    want(variant == expect, f"{result['config']}: the shape's variant is "
                            f"{variant}, expected {expect}")
    want(warp_runs == (2 if variant == "warp" else 0),
         f"{result['config']}: {warp_runs} of 2 launches took the warp "
         f"variant, the shape's is {variant}")
    if ties:
        allowed = 2 * off64["plain_f32"] + int(0.001 * C)
        want(off64["kernel"] <= allowed,
             f"{result['config']}: the kernel leaves float64's discrete "
             f"statistics on {off64['kernel']} chains, the plain float32 "
             f"version on {off64['plain_f32']}")
    else:
        want(frac >= 0.999, f"{result['config']}: discrete statistics match "
                            f"on only {frac:.4%} of chains")
    result["repeat_bitwise_equal"] = all(
        torch.equal(x, again[k]) for k, x in out.items())
    want(result["repeat_bitwise_equal"],
         f"{result['config']}: two launches on the same inputs differ")
    for field in ("prop_ld", "prop_pi"):
        want(torch.equal(torch.isneginf(out[field])[same],
                         torch.isneginf(ref[field])[same]),
             f"{result['config']}: {field} -inf rows differ")
    both = same & (leaf_64 == leaf_32)
    for stat in ("depth", "steps", "term_left", "term_right"):
        both = both & (ref64[stat] == ref[stat])
    fields = {
        name: (out[f"prop_{name}"], ref[f"prop_{name}"], ref64[f"prop_{name}"])
        for name in ("q", "grad", "ld")}
    fields["log_sum"] = (out["log_sum"], ref["log_sum"], ref64["log_sum"])
    fields["acceptance"] = (acceptance(out), acceptance(ref), acceptance(ref64))
    worst_abs, worst_rel, vs_f64 = {}, {}, {}
    for field, (x, y, z) in fields.items():
        xs, ys = x[same], y[same]
        worst_abs[field] = float(torch.where(xs == ys, 0.0, (xs - ys).abs()).max())
        worst_rel[field] = _worst(_rel_err(xs, ys), ties)
        err_kernel = _worst(_rel_err(x[both], z[both]), ties)
        err_plain = _worst(_rel_err(y[both], z[both]), ties)
        vs_f64[field] = {"kernel": err_kernel, "plain_f32": err_plain}
        want(err_kernel <= 2 * err_plain + 1e-5,
              f"{result['config']}: kernel {field} is {err_kernel:.3g} from "
              f"float64, the plain float32 version {err_plain:.3g}")
    stat = "q99" if ties else "max"
    result.update({"max_abs_diff": worst_abs, f"{stat}_rel_diff": worst_rel,
                   f"{stat}_rel_err_vs_f64": vs_f64})
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
    result = {"config": f"logreg_fused K={model.dim} {kind}", "chains": C}
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


def gaussian_leaf_inputs(model, C, minv_kind, gen):
    """Phase-3 inputs of the fused Gaussian leaf and leapfrog: exact draws
    of the target, a diagonal metric drawn from U[0.5, 2], shared (K,) or
    per chain (C, K), momenta from it, the model's gradient and a signed
    per-chain eps with |eps| in [0.1, 0.6]. With C > 2, row 0 gets p = 1e25
    (||d L||^2 overflows float32: ld' = -inf) and row 1 a NaN position."""
    from dynamichmc_tpu_torch.metric import diagonal_metric
    from dynamichmc_tpu_torch.tree_batched import rand_p_b

    ops = model.fused_leaf_batched_fn.operands
    K, dev = model.dim, ops.prec.device
    q = model.sample(gen, C).float()
    shape = (C, K) if minv_kind == "chain_diag" else (K,)
    metric = diagonal_metric(torch.empty(shape, device=dev).uniform_(
        0.5, 2.0, generator=gen))
    p = rand_p_b(gen, metric, (C, K), torch.float32)
    _v, g = model.logdensity_and_gradient(q)
    sign = torch.where(torch.rand(C, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    eps = sign * torch.empty(C, device=dev).uniform_(0.1, 0.6, generator=gen)
    if C > 2:
        p[0] = 1e25
        q[1, 0] = float("nan")
    return (metric, q.contiguous(), p.contiguous(), g.contiguous(),
            eps.contiguous(), ops.prec, ops.lchol, ops.mu)


def compare_gaussian(name, kernel, plain, args):
    """Phase 3 for the fused Gaussian leaf (K2) or leapfrog (K4):
    - the -inf pattern of ld' (and pi') is the plain float32 version's,
      and the two poisoned rows of gaussian_leaf_inputs are -inf: the
      poisoned rows match exactly (row 0 overflows only in float32, so
      the float64 version is no witness there);
    - on the other rows every output is no further from the float64 plain
      version than twice the plain float32 version's distance, plus 1e-5
      (1 + |x|), the rule of compare_kernel_plain: the kernel sums the K
      products of each dot in its own order."""
    from dynamichmc_tpu_torch.metric import DiagonalMetric

    out = kernel(*args)
    ref = plain(*args)
    ref64 = plain(DiagonalMetric(args[0].m_inv.double(), None),
                  *_as64(args[1:]))
    torch.cuda.synchronize()
    C, K = args[1].shape
    names = ("q", "p", "g", "ld", "pi")[:len(out)]
    poisoned = torch.isneginf(ref[3])
    fine = ~poisoned & torch.isfinite(ref64[3])
    result = {"config": name, "chains": C, "dim": K,
              "poisoned_rows": int(poisoned.sum())}
    fails = []
    want = lambda cond, msg: cond or fails.append(msg)  # noqa: E731
    want(result["poisoned_rows"] == (2 if C > 2 else 0),
         f"{name}: {result['poisoned_rows']} poisoned rows in the plain version")
    worst_abs, vs_f64 = {}, {}
    for field, x, y, z in zip(names, out, ref, ref64):
        if x.ndim == 1:
            want(torch.equal(torch.isneginf(x), torch.isneginf(y)),
                 f"{name}: {field}' -inf pattern differs from the plain version")
        xs, ys, zs = x[fine], y[fine], z[fine]
        worst_abs[field] = float(torch.where(xs == ys, 0.0, (xs - ys).abs()).max())
        err_kernel = float(_rel_err(xs, zs).max())
        err_plain = float(_rel_err(ys, zs).max())
        vs_f64[field] = {"kernel": err_kernel, "plain_f32": err_plain}
        want(err_kernel <= 2 * err_plain + 1e-5,
             f"{name}: kernel {field}' is {err_kernel:.3g} from float64, the "
             f"plain float32 version {err_plain:.3g}")
    result.update({"max_abs_diff": worst_abs, "max_rel_err_vs_f64": vs_f64})
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
    from dynamichmc_tpu_torch import hamiltonian, tree_batched
    from dynamichmc_tpu_torch.ops import (
        gaussian_leaf, gaussian_leapfrog, logreg_leaf, tree_kernel)

    tree_kernel.reset_launches()
    logreg_leaf.reset_launches()
    gaussian_leaf.reset_launches()
    gaussian_leapfrog.reset_launches()
    tree_batched.reset_fused_leaf_calls()
    hamiltonian.reset_leapfrog_calls()


def read_counts():
    from dynamichmc_tpu_torch import hamiltonian, tree_batched
    from dynamichmc_tpu_torch.ops import (
        gaussian_leaf, gaussian_leapfrog, logreg_leaf, tree_kernel)

    return {"tree_transition": tree_kernel.launches,
            "tree_transition_warp": tree_kernel.warp_launches,
            "logreg_fused_leaf": logreg_leaf.launches,
            "gaussian_fused_leaf": gaussian_leaf.launches,
            "gaussian_leapfrog": gaussian_leapfrog.launches,
            "driver_fused_leaves": tree_batched.fused_leaf_calls,
            "leapfrog_calls": hamiltonian.leapfrog_calls}


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


def run_per_chain(model, dev):
    """Phase 4, per_chain: one mcmc_with_warmup call per seed, each chain
    on its own generator; returns the results, the seconds of the four
    calls together and their launch counts (set to 0 just before them)."""
    from dynamichmc_tpu_torch import mcmc_with_warmup

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = [mcmc_with_warmup(torch.Generator(device=dev).manual_seed(s),
                                model, N_PER_CHAIN) for s in PER_CHAIN_SEEDS]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return results, seconds, read_counts()


def check_standard_normal(flat, mean_tol, var_range):
    """Every coordinate of draws of N(0, I): |mean| <= mean_tol and the
    variance in var_range."""
    mean_err = float(flat.mean(0).abs().max())
    var = flat.var(0, correction=0)
    lo, hi = float(var.min()), float(var.max())
    check(mean_err <= mean_tol, f"|mean| up to {mean_err:.4f}")
    check(var_range[0] <= lo and hi <= var_range[1],
          f"var in [{lo:.4f}, {hi:.4f}], outside {var_range}")
    return {"max_abs_mean": mean_err, "var_range": [lo, hi]}


def check_per_chain(results, seconds):
    """The per_chain gate over the 4 x 1000 draws: finite; |mean| <= 0.1
    and var in [0.85, 1.15] in every coordinate; split R-hat <= 1.05; mean
    post-warmup acceptance in [0.6, 0.95]. Returns the phase-4 metrics."""
    from dynamichmc_tpu_torch.mcmc import stack_posterior_matrices
    from dynamichmc_tpu_torch.stats_device import ess_rhat_device

    draws = stack_posterior_matrices(results).transpose(0, 1)  # (4, N, K)
    metrics, _ess = path_metrics(SimpleNamespace(
        positions=draws, tree_statistics=SimpleNamespace(
            steps=torch.stack([r.tree_statistics.steps for r in results]),
            is_divergent=torch.stack([r.tree_statistics.is_divergent
                                      for r in results]))), seconds)
    metrics.update(check_standard_normal(draws.double().reshape(-1, K_GAUSS),
                                         0.1, (0.85, 1.15)))
    rhat = float(ess_rhat_device(draws.double())["rhat"].max())
    check(rhat <= 1.05, f"split R-hat up to {rhat:.4f}")
    acc = float(torch.stack([r.tree_statistics.acceptance_rate.mean()
                             for r in results]).mean())
    check(0.6 <= acc <= 0.95, f"mean acceptance {acc:.4f}")
    metrics.update({"max_rhat": rhat, "mean_acceptance": acc,
                    "eps": [float(r.eps) for r in results]})
    return metrics


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
    other device work and the idle share (1 - device busy / wall). Device
    activity only: the host ops' events would multiply the profiler's
    processing time and are not read."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    kern = [r for r in rows if any(k in r[0] for k in (
        "tree_transition_kernel", "tree_transition_warp_kernel",
        "logreg_leaf_slice_kernel",
        "logreg_leaf_finish_kernel", "gaussian_leaf_kernel"))]
    ours = sum(r[1] for r in kern) / 1e6
    return {"path": name, "profiled_wall_s": wall,
            "kernels": [{"name": r[0][:60], "device_s": r[1] / 1e6,
                         "calls": r[2]} for r in kern],
            "kernel_share": ours / wall, "other_device_share": (busy - ours) / wall,
            "idle_share": 1 - busy / wall,
            "top_other": [{"name": r[0][:60], "device_s": r[1] / 1e6,
                           "calls": r[2]} for r in rows if r not in kern][:6]}


def device_ms(fn, args, reps, kernel_name):
    """Device time per call of the kernel named ``kernel_name`` over
    ``reps`` calls, from torch.profiler (the wrapper's host time excluded):
    the mean over the launches the profiler recorded. It may miss one at
    the start of a session, and no more."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if kernel_name in e.key and e.device_type.name == "CUDA":
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            count += e.count
    check(reps - 1 <= count <= reps,
          f"profiler saw {count} {kernel_name} launches of {reps}")
    return total / count / 1e3


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


def bound(flops, n_bytes):
    """(bound_ms, bound_by): the larger of the operations over the fp32 peak
    and the bytes over the memory rate."""
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    t_mem = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_mem else (t_mem, "bytes")


def tree_kernel_bound(args):
    """The tree kernel's bound on one phase-5 call: the leaves each chain
    executed on these inputs (the kernel's ``work``) times the leaf's
    operations, and every input and output once. Operations per leaf:
    Gaussian 8 K^2 + 30 K dense (drift M^-1 p, gradient, value, M^-1 p'),
    4 K^2 + 30 K diagonal; funnel 30 K; logreg 4 n K + 10 n + 30 K (the
    two products with X, the softplus and sigmoid terms)."""
    from dynamichmc_tpu_torch.ops import tree_kernel

    out = tree_kernel.tree_transition(*args)
    torch.cuda.synchronize()
    leaves = int(out["work"].sum())
    K = args[0].shape[1]
    leaf = args[9]
    if leaf.kind == tree_kernel.GAUSSIAN:
        per_leaf = (8 if args[8].ndim == 2 else 4) * K * K + 30 * K
    elif leaf.kind == tree_kernel.FUNNEL:
        per_leaf = 30 * K
    else:
        per_leaf = 4 * leaf.n_obs * K + 10 * leaf.n_obs + 30 * K
    outputs = [v for v in out.values() if torch.is_tensor(v)]
    return bound(leaves * per_leaf,
                 nbytes(*args[:9], *leaf.operands) + nbytes(*outputs)
                 - nbytes(args[5]))  # directions are passed through


def gaussian_bound(args, write_pi):
    """The fused Gaussian leaf's (write_pi) or leapfrog's bound: per chain
    4 K^2 + 13 K operations (10 K without pi), every input and output once."""
    metric, q = args[0], args[1]
    C, K = q.shape
    ops = C * (4 * K * K + (13 if write_pi else 10) * K)
    outs = 4 * (3 * C * K + (2 if write_pi else 1) * C)
    return bound(ops, nbytes(metric.m_inv, *args[1:]) + outs)


def logreg_leaf_bound(args):
    """The fused logreg leaf's bound: per chain 4 n K + 10 n + 12 K
    operations (both products with X, the softplus and sigmoid terms, the
    leapfrog), every input and output once."""
    metric, q, x = args[0], args[1], args[5]
    C, K = q.shape
    n = x.shape[0]
    ops = C * (4 * n * K + 10 * n + 12 * K)
    outs = 4 * (3 * C * K + 2 * C)
    return bound(ops, nbytes(metric.m_inv, *args[1:7]) + outs)


def build_all(dev):
    """Phase 2: every CUDA library, one nvcc each, in parallel."""
    from dynamichmc_tpu_torch.ops import gaussian_leaf, logreg_leaf, tree_kernel

    libs = (tree_kernel.library, logreg_leaf.library, gaussian_leaf.library)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        paths = list(pool.map(lambda lib: lib.build(), libs))
    seconds = time.perf_counter() - t0
    for lib, so in zip(libs, paths):
        log(f"[2 build] {os.path.relpath(so)} ({seconds:.1f} s for all)")
        for line in lib.build_log.splitlines():
            if "spill" in line or "ptxas info" in line and (
                    "registers" in line or "Compiling" in line):
                log(f"[2 build] {line.strip()}")
        lib.load()
    usage = tree_kernel_usage(tree_kernel.library.build_log)
    warp = {k: u for k, u in usage.items() if k[0] == "warp"}
    check(len(warp) == 16, f"ptxas reported {len(warp)} warp-variant "
                           "instantiations, expected 16")
    spilled = {f"{k}": u["spill"] for k, u in warp.items()
               if "0 bytes spill stores, 0 bytes spill loads" not in u["spill"]}
    check(not spilled, f"the warp variant spills: {spilled}")
    funnel_regs = {
        "cta": {("diag" if k[1] else "dense"): u["registers"]
                for k, u in usage.items()
                if k[0] == "cta" and k[2] == tree_kernel.FUNNEL},
        "warp": {f"{'diag' if k[1] else 'dense'} R={k[3]}": u["registers"]
                 for k, u in warp.items() if k[2] == tree_kernel.FUNNEL}}
    log(f"[2 build] funnel leaf registers (ptxas): {json.dumps(funnel_regs)}")
    shape = (tree_kernel.FUNNEL, K_FUNNEL, MD_FUNNEL, True)
    log(f"[2 build] funnel path K={K_FUNNEL} md {MD_FUNNEL} diag residency: "
        f"{json.dumps(variant_plans(dev, *shape))}")
    gauss = gaussian_usage(gaussian_leaf.library.build_log)
    for key, u in sorted(gauss.items()):
        log(f"[2 build] gaussian_leaf_kernel {key}: {u['usage']}; {u['spill']}")
    check(len(gauss) == 16, f"ptxas reported {len(gauss)} fused Gaussian "
                            "instantiations, expected 16")
    spilled = {k: u["spill"] for k, u in gauss.items()
               if "0 bytes spill stores, 0 bytes spill loads" not in u["spill"]}
    check(not spilled, f"the fused Gaussian kernel spills: {spilled}")
    for name, shape in GAUSS_SHAPES.items():
        log(f"[2 build] {name} plan at {list(shape[1:])}: "
            f"{json.dumps(gaussian_plan(dev, *shape))}")


def plan_dict(info):
    return {"warps_per_cta": info.warps, "registers": info.registers,
            "smem_bytes": info.smem, "ctas_per_sm": info.ctas_per_sm,
            "resident_warps_per_sm": info.resident_warps,
            "sms": info.sm_count}


def variant_plans(dev, kind, K, md, diag):
    """Both variants' launch plans for one shape (the warp variant's where
    its plan takes warps), from the built library."""
    from dynamichmc_tpu_torch.ops import tree_kernel

    plans = {"cta": plan_dict(tree_kernel.cta_kernel_info(dev, kind, K, md, diag))}
    if tree_kernel.warp_plan(kind, K, md, diag)[0]:
        plans["warp"] = plan_dict(
            tree_kernel.warp_kernel_info(dev, kind, K, md, diag))
    return plans


def ptxas_usage(build_log, key_of):
    """ptxas's spill line, registers and usage line ("Used N registers,
    ...") of each kernel whose mangled name ``key_of`` maps to a key (None:
    not read); the spill line follows "Function properties for", the usage
    line the spill line."""
    usage, current = {}, None
    for line in build_log.splitlines():
        if "Function properties for" in line:
            current = key_of(line.split("Function properties for", 1)[1].strip())
        elif current and "spill stores" in line:
            usage[current] = {"spill": line.strip()}
        elif current and current in usage and "Used" in line and "registers" in line:
            usage[current]["registers"] = int(line.split("Used", 1)[1].split()[0])
            usage[current]["usage"] = line.split(":", 1)[1].strip()
            current = None
    return usage


def tree_kernel_usage(build_log):
    """ptxas_usage of each instantiation of the tree kernel, keyed ("warp",
    diag, leaf, R) for the warp variant and ("cta", diag, leaf) for
    tree_transition_kernel (the wide one is not read)."""
    warp_re = re.compile(r"tree_transition_warp_kernelILb([01])ELi(\d+)ELi(\d+)EE")
    cta_re = re.compile(r"tree_transition_kernelILb([01])ELi(\d+)EE")

    def key_of(name):
        m, c = warp_re.search(name), cta_re.search(name)
        return (("warp", m[1] == "1", int(m[2]), int(m[3])) if m else
                ("cta", c[1] == "1", int(c[2])) if c else None)

    return ptxas_usage(build_log, key_of)


def gaussian_usage(build_log):
    """ptxas_usage of each instantiation of the fused Gaussian kernel, keyed
    "K2" (writes pi') or "K4", then "chain" or "shared" M^-1, R and "exact"
    or "compensated" (the column sums past K = 256)."""
    name_re = re.compile(
        r"gaussian_leaf_kernelILb([01])ELb([01])ELi(\d+)ELb([01])EE")

    def key_of(name):
        m = name_re.search(name)
        return (f"{'K2' if m[1] == '1' else 'K4'} "
                f"{'chain' if m[2] == '1' else 'shared'} R={m[3]} "
                f"{'compensated' if m[4] == '1' else 'exact'}") if m else None

    return ptxas_usage(build_log, key_of)


# The fused Gaussian kernels' phase-5 shapes: name -> (K2?, C, K, metric form)
GAUSS_SHAPES = {
    "gaussian_leaf": (True, C_GAUSS, K_GAUSS, "chain_diag"),
    "gaussian_leaf_k100": (True, C_GAUSS, K_MAIN, "chain_diag"),
    "gaussian_leapfrog": (False, 1, K_GAUSS, "shared_diag"),
    "gaussian_leapfrog_4096": (False, C_GAUSS, K_GAUSS, "chain_diag"),
    "gaussian_leaf_floor": (True, 1, 1, "shared_diag"),
}


def gaussian_plan(dev, write_pi, C, K, kind):
    """The fused Gaussian kernel's launch plan of (C, K) and what the CUDA
    runtime says of the kernel it runs."""
    from dynamichmc_tpu_torch.ops import gaussian_leaf

    plan = gaussian_leaf.launch_plan(C, K, gaussian_leaf.sm_count(dev.index))
    info = gaussian_leaf.kernel_info(dev, write_pi, kind == "chain_diag", K, plan)
    return {"chains_per_cta": plan.chains, "R": plan.R, "warps": plan.warps,
            "ctas": plan.ctas, "staged": plan.staged, "smem_bytes": info.smem,
            "registers": info.registers, "ctas_per_sm": info.ctas_per_sm}


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
    build_all(dev)
    run_phases(dev, smi, profile=profiled_paths(sys.argv[1:]))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


PATHS = ("main", "funnel", "logreg_tree", "logreg_fused", "gauss_fused",
         "per_chain")


def profiled_paths(argv):
    """The paths --profile names (all six for a bare --profile)."""
    names = ()
    for arg in argv:
        if arg == "--profile":
            names = PATHS
        elif arg.startswith("--profile="):
            names = tuple(arg.split("=", 1)[1].split(","))
            unknown = set(names) - set(PATHS)
            check(not unknown, f"--profile: no path {sorted(unknown)}")
    return names


def run_phases(dev, smi, profile=()):
    """Phases 3-5 on ``dev``; prints the kernels line. ``profile``: the
    paths to repeat under torch.profiler."""
    from dynamichmc_tpu_torch.hamiltonian import EvaluatedPoint, PhasePoint
    from dynamichmc_tpu_torch.models import (
        correlated_gaussian, funnel, logistic_regression, mvnormal)
    from dynamichmc_tpu_torch.ops import (
        gaussian_leaf, gaussian_leapfrog, logreg_leaf, tree_kernel)

    # --- phase 3: every kernel against its plain version -----------------
    gauss = correlated_gaussian(K_MAIN, dtype=torch.float32, device=dev,
                                tree_kernel=True)
    fun = funnel(K_FUNNEL, dtype=torch.float32, device=dev, tree_kernel=True)
    lr_tree = logistic_regression(N_OBS, K_LOGREG, dtype=torch.float32,
                                  device=dev, tree_kernel=True)
    lr_fused = logistic_regression(N_OBS, K_LOGREG, dtype=torch.float32,
                                   device=dev, fused=True)
    lr_wide = logistic_regression(N_OBS, K_WIDE, dtype=torch.float32,
                                  device=dev, fused=True)
    # BASELINE config 1: N(0, I_25) through the Gaussian model with hooks
    normal = mvnormal(np.zeros(K_GAUSS), np.eye(K_GAUSS), dtype=torch.float32,
                      device=dev, fused=True)
    gauss100 = correlated_gaussian(K_MAIN, dtype=torch.float32, device=dev,
                                   fused=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    phase3 = {"gaussian": [], "gaussian_cta": [], "funnel": [],
              "funnel_cta": [], "logreg_tree": [], "logreg_fused": [],
              "gaussian_leaf": [], "gaussian_leapfrog": []}

    def phase3_result(key, r):
        phase3[key].append(r)

    gauss_cta = correlated_gaussian(K_CTA, dtype=torch.float32, device=dev,
                                    tree_kernel=True)
    gen_cta = torch.Generator(device=dev).manual_seed(SEED + 1)
    for kind, dcap in (("dense", MD_MAIN), ("diag", MD_MAIN), ("dense", 2)):
        phase3_result("gaussian", compare_kernel_plain(
            "gaussian", gauss, C_MAIN, MD_MAIN, kind, dcap, gen, "warp"))
        phase3_result("gaussian_cta", compare_kernel_plain(
            "gaussian", gauss_cta, C_MAIN, MD_MAIN, kind, dcap, gen_cta, "cta"))
    fun_cta = funnel(K_CTA, dtype=torch.float32, device=dev, tree_kernel=True)
    for i, (kind, dcap) in enumerate((("diag", MD_FUNNEL), ("dense", MD_FUNNEL),
                                      ("diag", 2))):
        # the path's own configuration draws from gen, the others from
        # gen_cta, so that no later configuration's inputs depend on them
        phase3_result("funnel", compare_kernel_plain(
            "funnel", fun, C_FUNNEL, MD_FUNNEL, kind, dcap,
            gen if i == 0 else gen_cta, "warp"))
        phase3_result("funnel_cta", compare_kernel_plain(
            "funnel", fun_cta, C_FUNNEL, MD_FUNNEL, kind, dcap, gen_cta, "cta",
            ties=True))
    phase3_result("logreg_tree", compare_kernel_plain(
        "logreg", lr_tree, C_LOGREG, MD_LOGREG, "diag", MD_LOGREG, gen, "cta"))
    for model in (lr_fused, lr_wide):
        for kind in ("shared_diag", "chain_diag", "shared_dense"):
            phase3_result("logreg_fused",
                          compare_fused_leaf(model, C_LOGREG, kind, gen))
    # the last K whose plan stages prec and L at 4096 chains, and the next
    k_st = gaussian_leaf.staging_limit(C_GAUSS, gaussian_leaf.sm_count(dev.index))
    staged_last, staged_next = (
        correlated_gaussian(k, dtype=torch.float32, device=dev, fused=True)
        for k in (k_st, k_st + 1))
    tile = gaussian_leaf.launch_plan(
        C_GAUSS, K_GAUSS, gaussian_leaf.sm_count(dev.index)).chains
    leaf_inputs = {  # name -> (model, C, metric form)
        "gaussian_leaf 4096x25 shared_diag": (normal, C_GAUSS, "shared_diag"),
        "gaussian_leaf 4096x25 chain_diag": (normal, C_GAUSS, "chain_diag"),
        "gaussian_leaf 4096x100 chain_diag": (gauss100, C_GAUSS, "chain_diag"),
        f"gaussian_leaf 4096x{k_st} chain_diag (staged)": (
            staged_last, C_GAUSS, "chain_diag"),
        f"gaussian_leaf 4096x{k_st + 1} shared_diag (not staged)": (
            staged_next, C_GAUSS, "shared_diag"),
        f"gaussian_leaf {C_GAUSS + 1}x25 chain_diag (last tile of {tile} "
        "holds one chain)": (normal, C_GAUSS + 1, "chain_diag"),
    }
    for name, (model, C, kind) in leaf_inputs.items():
        phase3_result("gaussian_leaf", compare_gaussian(
            name, gaussian_leaf.gaussian_leaf, gaussian_leaf.gaussian_leaf_plain,
            gaussian_leaf_inputs(model, C, kind, gen)))
    for name, C, kind in (("gaussian_leapfrog 4096x25 chain_diag", C_GAUSS,
                           "chain_diag"),
                          ("gaussian_leapfrog 1x25 shared_diag", 1,
                           "shared_diag"),
                          (f"gaussian_leapfrog {C_GAUSS + 1}x25 shared_diag",
                           C_GAUSS + 1, "shared_diag")):
        phase3_result("gaussian_leapfrog", compare_gaussian(
            name, gaussian_leapfrog.gaussian_leapfrog,
            gaussian_leapfrog.gaussian_leapfrog_plain,
            gaussian_leaf_inputs(normal, C, kind, gen)))
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
        # BASELINE config 1 under the fleet: the reference-default warmup
        "gauss_fused": (normal, C_GAUSS, {"tune": "reference"}),
    }
    launches, summaries = {}, {}
    for name, (model, C, config) in paths.items():
        res, seconds, counts = run_path(model, C, N_DRAWS, SEED, config, dev)
        check(tuple(res.positions.shape) == (C, N_DRAWS, model.dim),
              f"{name}: positions shape {tuple(res.positions.shape)}")
        check(counts["gaussian_leapfrog"] == 0,
              f"{name}: the fused Gaussian leapfrog launched")
        if name in ("logreg_fused", "gauss_fused"):
            own = "logreg_fused_leaf" if name == "logreg_fused" else "gaussian_fused_leaf"
            other = "gaussian_fused_leaf" if name == "logreg_fused" else "logreg_fused_leaf"
            check(counts["tree_transition"] == 0,
                  f"{name}: the tree kernel launched")
            check(counts[other] == 0, f"{name}: {other} launched")
            check(counts[own] == counts["driver_fused_leaves"] > 0,
                  f"{name}: {own} launched {counts[own]} times for "
                  f"{counts['driver_fused_leaves']} driver leaves")
            launches[name] = counts[own]
        else:
            check(counts["tree_transition"] == expected,
                  f"{name}: kernel launched {counts['tree_transition']} times "
                  f"in the run, expected {expected} (one per transition)")
            check(counts["logreg_fused_leaf"] == counts["gaussian_fused_leaf"] == 0,
                  f"{name}: a fused leaf launched")
            launches[name] = counts["tree_transition"]
        # the warp variant carries the Gaussian and funnel leaves, and
        # nothing else
        want_warp = counts["tree_transition"] if name in ("main", "funnel") else 0
        check(counts["tree_transition_warp"] == want_warp,
              f"{name}: the warp variant launched {counts['tree_transition_warp']} "
              f"times, expected {want_warp}")
        if name == "main":
            metrics = check_draws(model, res, seconds)
        elif name == "funnel":
            metrics = check_funnel(res, seconds)
        elif name == "gauss_fused":
            metrics, _ess = path_metrics(res, seconds)
            metrics.update(check_standard_normal(
                res.positions.double().reshape(-1, K_GAUSS), 0.05, (0.9, 1.1)))
            metrics["leaf_slots_per_transition"] = (
                counts["driver_fused_leaves"] / expected)
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

    # per_chain: BASELINE config 1 through mcmc_with_warmup, one chain per call
    results, seconds, counts = run_per_chain(normal, dev)
    for r in results:
        check(tuple(r.positions.shape) == (N_PER_CHAIN, K_GAUSS),
              f"per_chain: positions shape {tuple(r.positions.shape)}")
    check(counts["gaussian_leapfrog"] == counts["leapfrog_calls"] > 0,
          f"per_chain: fused leapfrog launched {counts['gaussian_leapfrog']} "
          f"times for {counts['leapfrog_calls']} leapfrog calls")
    check(counts["tree_transition"] == counts["tree_transition_warp"]
          == counts["gaussian_fused_leaf"] == counts["logreg_fused_leaf"] == 0,
          "per_chain: another kernel launched")
    launches["per_chain"] = counts["gaussian_leapfrog"]
    metrics = check_per_chain(results, seconds)
    metrics.update({"path": "per_chain", "launch_counts": counts,
                    "chains": len(results), "draws": N_PER_CHAIN,
                    "dim": K_GAUSS, "gpu": smi})
    log(f"[4 path] {json.dumps(metrics)}")
    del results
    log_phase_done(4)

    # --- phase 5: kernel time against plain, and each kernel's bound -----
    times, bounds = {}, {}
    args = kernel_inputs(gauss, C_MAIN, MD_MAIN, "dense", MD_MAIN, gen)
    times["gaussian"] = (time_call(tree_kernel.tree_transition, args, 50),
                         time_call(tree_kernel.tree_transition_plain, args, 5))
    bounds["gaussian"] = tree_kernel_bound(args)
    args = kernel_inputs(fun, C_FUNNEL, MD_FUNNEL, "diag", MD_FUNNEL, gen)
    times["funnel"] = (time_call(tree_kernel.tree_transition, args, 20),
                       time_call(tree_kernel.tree_transition_plain, args, 3))
    bounds["funnel"] = tree_kernel_bound(args)
    args = kernel_inputs(lr_tree, C_LOGREG, MD_LOGREG, "diag", MD_LOGREG, gen)
    times["logreg_tree"] = (time_call(tree_kernel.tree_transition, args, 5),
                            time_call(tree_kernel.tree_transition_plain, args, 3))
    bounds["logreg_tree"] = tree_kernel_bound(args)
    args = fused_leaf_inputs(lr_fused, C_LOGREG, "shared_diag", gen)
    times["logreg_fused"] = (time_call(logreg_leaf.logreg_leaf, args, 50),
                             time_call(logreg_leaf.logreg_leaf_plain, args, 50))
    bounds["logreg_fused"] = logreg_leaf_bound(args)
    info = logreg_leaf.kernel_info(dev, 0, K_LOGREG)
    plan = logreg_leaf.launch_plan(C_LOGREG, K_LOGREG, N_OBS, info.sm_count,
                                   info.blocks_per_sm)
    plans = {"logreg_fused": {
        "slices": plan.slices, "tiles_per_slice": plan.tiles_per_slice,
        "tile_rows": plan.tile, "chunks": plan.chunks,
        "registers": info.registers, "smem_bytes": info.smem,
        "ctas_per_sm": info.blocks_per_sm, "sms": info.sm_count}}
    for name, shape in (("gaussian", (tree_kernel.GAUSSIAN, K_MAIN, MD_MAIN, False)),
                        ("funnel", (tree_kernel.FUNNEL, K_FUNNEL, MD_FUNNEL, True))):
        variant = tree_kernel.kernel_variant(*shape)
        both = variant_plans(dev, *shape)
        plans[name] = {"variant": variant, **both[variant]}
        if name == "funnel":
            plans[name]["cta_variant_plan"] = both["cta"]
    shapes = {"gaussian": [C_MAIN, K_MAIN, MD_MAIN, "dense"],
              "funnel": [C_FUNNEL, K_FUNNEL, MD_FUNNEL, "diag"],
              "logreg_tree": [C_LOGREG, K_LOGREG, N_OBS, MD_LOGREG, "diag"],
              "logreg_fused": [C_LOGREG, K_LOGREG, N_OBS, "shared_diag"]}
    device_times = {}
    models = {K_GAUSS: normal, K_MAIN: gauss100,
              1: mvnormal(np.zeros(1), np.eye(1), dtype=torch.float32,
                          device=dev, fused=True)}
    for name, (write_pi, C, K, kind) in GAUSS_SHAPES.items():
        kernel, plain = (
            (gaussian_leaf.gaussian_leaf, gaussian_leaf.gaussian_leaf_plain)
            if write_pi else (gaussian_leapfrog.gaussian_leapfrog,
                              gaussian_leapfrog.gaussian_leapfrog_plain))
        args = gaussian_leaf_inputs(models[K], C, kind, gen)
        calls = {name: (kernel, args)}
        if name == "gaussian_leaf":  # K2's hook as gauss_fused calls it
            calls["gaussian_leaf_hook"] = (normal.fused_leaf_batched_fn, args[:5])
        elif name == "gaussian_leapfrog":  # K4's as per_chain calls it
            z = PhasePoint(Q=EvaluatedPoint(
                q=args[1][0], logdensity=torch.zeros((), device=dev),
                grad=args[3][0]), p=args[2][0])
            calls["gaussian_leapfrog_hook"] = (normal.fused_leapfrog_fn,
                                               (args[0], z, args[4][0]))
        for key, (fn, fn_args) in calls.items():
            times[key] = (time_call(fn, fn_args, 200), time_call(plain, args, 200))
            device_times[key] = device_ms(fn, fn_args, 50, "gaussian_leaf_kernel")
            bounds[key] = gaussian_bound(args, write_pi)
            shapes[key] = [C, K, kind]
            plans[key] = gaussian_plan(dev, write_pi, C, K, kind)
    for name, (kernel_ms, plain_ms) in times.items():
        line = {"kernel": name, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "shape": shapes[name], "gpu": smi}
        if name in device_times:
            line["kernel_device_ms"] = device_times[name]
        if name in plans:
            line["plan"] = plans[name]
        log(f"[5 kernel time] {json.dumps(line)}")

    log_phase_done(5)
    for name, (model, C, config) in paths.items():
        if name in profile:
            log(f"[profile] {json.dumps(profile_run(name, lambda: run_path(model, C, N_DRAWS, SEED, config, dev)))}")
    if "per_chain" in profile:
        log(f"[profile] {json.dumps(profile_run('per_chain', lambda: run_per_chain(normal, dev)))}")

    entries = [  # name, phase-3/5 key, path, replaces, source
        ("tree_transition", "gaussian", "main", "dynamichmc_tpu/ops/pallas_tree.py:93",
         "tree_kernel.cu"),
        ("tree_transition_funnel", "funnel", "funnel",
         "dynamichmc_tpu/ops/pallas_tree.py:707", "tree_kernel.cu"),
        ("tree_transition_logreg", "logreg_tree", "logreg_tree",
         "dynamichmc_tpu/ops/pallas_tree.py:762", "tree_kernel.cu"),
        ("logreg_fused_leaf", "logreg_fused", "logreg_fused",
         "dynamichmc_tpu/ops/pallas_logreg.py:53", "logreg_leaf.cu"),
        ("gaussian_fused_leaf", "gaussian_leaf", "gauss_fused",
         "dynamichmc_tpu/ops/pallas_leaf.py:32", "gaussian_leaf.cu"),
        ("gaussian_fused_leapfrog", "gaussian_leapfrog", "per_chain",
         "dynamichmc_tpu/ops/pallas_leapfrog.py:42", "gaussian_leaf.cu"),
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
        "bound_ms": bounds[key][0],
        "bound_by": bounds[key][1],
        "library_ms": None,  # no single PyTorch call computes a transition or leaf
    } for name, key, path, replaces, src in entries]}))


if __name__ == "__main__":
    sys.exit(main())
