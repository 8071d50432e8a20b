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
     staging, registers and CTAs per SM); print the same of the fused
     logreg leaf's tiled slice kernel's 15 instantiations (three metric
     modes, 1-5 float2 coordinate groups a thread) and fail if one spills.
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
       variances, start at draws of the Laplace approximation; then at the
       benchmark's 1000 x 25 on 16,384 chains, diagonal and dense metric,
       where each launch must take the staged-X variant (X staged once per
       CTA, one warp per chain);
     - the fused logreg leaf at 2048 x 128 x 4000 with a shared diagonal,
       a per-chain diagonal and a shared dense metric, and the same at
       K = 300, each call through the tiled slice kernel (each logit once,
       the whole gradient from one staging of X); the same three at K =
       320 and 512, past the tiled kernel's widest K, each call through
       the chunked slice kernel (two 256-wide gradient chunks, 64-row and
       16-row tiles of X) and none through the tiled one;
     - the fused leaf's hierarchical mode (each chain's prior precision
       e^-t, t its last coordinate) at the benchmark's logreg_hier_1000x302
       shape, 16,384 chains x K = 302 x 1000 rows (the tiled slice kernel),
       on that cell's seeded data, in the same three metric forms, against
       its plain version and float64 by the same rule, each call one
       launch of the hierarchical mode;
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
     - logreg_xstaged: logistic_regression(1000, 25), the benchmark's
       logreg_1000x25.fleet16k shape, diagonal metric, 16,384 chains,
       NUTS(max_depth=4), every launch through the tree kernel's staged-X
       variant; timed;
     - logreg_fused: the same model with the fused leaf in the plain
       driver; timed;
     - logreg_hier_fused: hierarchical_logistic_regression_from_data on
       the benchmark's logreg_hier_1000x302 data (K = 302), 4096 chains,
       NUTS(max_depth=4), the fused leaf's hierarchical mode on every leaf
       of the plain driver and no tree-kernel launch; timed, its draws of
       t reported.
     Then BASELINE config 1, N(0, I_25) = mvnormal(0, I, fused=True), with
     the reference-default warmup (stepsize search, 900 transitions,
     per-chain diagonal metric and dual averaging, NUTS(), no clamp):
     - gauss_fused: run_chains, 4096 chains, 512 draws, every leaf of the
       plain driver through the fused Gaussian leaf; timed;
     - per_chain: mcmc_with_warmup, one chain per call, seeds 0-3, 1000
       draws each, every leapfrog through the fused Gaussian leapfrog;
       the four calls timed together.
     Then the per-chain API, the stage fold and the stepwise API:
     - keep_warmup: mcmc_keep_warmup on the same model, seed 0, with a
       LogProgressReport(step_interval=250): a history of 8 entries with
       positions (75, 25) ... (400, 25), draws, eps and M^-1 bitwise
       per_chain's chain of seed 0 (which passed per_chain's gate), K4 on
       every leapfrog; its diagnostics reported, not gated;
     - generic: mcmc_with_warmup, seeds 0-1, 1000 draws, a custom turn
       statistic (the generalized one reimplemented: the generic driver)
       and a stage tuple of two metric kinds (the stage fold): K4 on
       every leapfrog with a diagonal M^-1 (the kernel, like the JAX one,
       takes no dense M^-1; the dense blocks and draws step in plain
       torch, counted apart), per chain split R-hat <= 1.05 and mean
       acceptance in [0.6, 0.95];
     - stepwise: next_chunk of 64 transitions from keep_warmup's final
       state, K4 on every leapfrog, finite draws; then 64 at
       4096 x 25 from gauss_fused's last draws, metric and eps, K2 on
       every driver leaf, N(0, I)'s moments;
     - stages_tree: run_chains on the main path's target, 4096 chains, md
       4, no clamp, 512 draws, pooled diagonal blocks 25/50 then pooled
       dense blocks 100/200/400 (two metric kinds): every
       transition through K1's warp variant, the main path's gate.
     Then the production surface of run_chains, on main's configuration
     and seed (every transition through K1's warp variant):
     - streamed: draws sunk to an io.MemmapDrawStore 64 at a time, every
       warmup checkpoint kept: the store is main's timed draws bit for
       bit, positions None, checkpoints at steps 0, 75, ..., 900; prints
       its peak device memory beside main's;
     - resumed: the step-450 checkpoint saved, loaded, resumed with a
       fresh generator: main's draws, eps and M^-1 bit for bit;
     - ess_target: sampling until a min bulk ESS of 1e6, checked at 64,
       128, 256 draws: stops at the first checked boundary that meets
       it, its draws main's prefix;
     - constrained: Dirichlet(2, 3, 4) through the simplex transform,
       1024 chains x 256 draws, clamp 2/25, the plain batch driver with
       autograd (no kernel): rows on the simplex, each mean within 5 MCSE.
     Then run_chains' defaults (tune="auto") and a custom turn statistic:
     - auto_main: run_chains(generator, main's target, 4096, 512) with
       nothing else but a log: its autotune line reads max_depth=4, pooled
       dense metric, per-chain eps, warmup clamp 2/25, and its draws, eps
       and M^-1 are main's timed run's bit for bit, every transition
       through K1's warp variant;
     - auto_funnel: the same call on the funnel path's target: the same
       line, K1's warp variant with the funnel leaf and a dense metric on
       every transition; prints the share of draws at the cap and checks
       that the autotune WARNING line appears exactly when that share
       exceeds autotune.CAP_SATURATION_WARN; the v-marginal is reported,
       not gated (the cap costs mixing);
     - custom_batch: N(0, I_25) = mvnormal(0, I, fused=True), 4 chains x
       256 draws, NUTS with the generalized statistic reimplemented as a
       custom one (the generic driver looped over the chains), warmup
       search, 75, diagonal 25, 50, 100, then 50: K4 once for every
       hamiltonian.leapfrog call and no other kernel, split R-hat over the
       4 chains <= 1.05, mean acceptance in [0.6, 0.95], every
       coordinate's |mean| <= 0.15 and variance in [0.8, 1.2].
     Each checks that its kernel launched on every transition (for the
     fused leaves: on every leaf the driver executed; for the leapfrog: on
     every hamiltonian.leapfrog call; on the main and funnel paths every
     transition through the tree kernel's warp variant, on no other path
     any), that the draws are finite, and the
     path's gate: the Gaussian's moments, the funnel's v-marginal (|mean
     v| <= 0.4, sd(v) in [2.7, 3.3]), the two logreg runs' agreement
     (every posterior mean within 5 combined MCSE), N(0, I)'s moments and,
     per chain, split R-hat and the acceptance rate (logreg_hier_fused:
     finite draws and ESS; the benchmark's cell holds its moments to its
     reference). Each reports wall
     time, min and mean bulk ESS/s (device ESS, float64), gradient
     evaluations/s and divergences, and the diagnostics of its draws
     (reported, not gated): EBFMI (min and mean over the chains), the
     termination and depth counts and, on the run_chains paths,
     straggler_waste with what its ``work`` counts there (each chain's
     own leaves on the tree-kernel paths, the batch's lockstep slots on
     the plain driver's).
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
     funnel's beside the CTA variant's plan at the same shape); the logreg
     leaf's staged-X variant at 16,384 x 25 x 1000, md 4, its own; the
     fused leaf's hierarchical mode at 16,384 x 302 x 1000 with a shared
     diagonal metric, its own line and plan.
  6. Protocol: two gates of the reference's statistical protocol
     (tests/torch_correctness_utils.py: split R-hat, ESS per draw,
     Anderson-Darling against exact draws, EBFMI, at the JAX gates'
     thresholds) at float32 through the kernels: the bench configuration
     at bench dimension (correlated_gaussian(64), 128 chains x 256 draws,
     pooled dense metric, md 4, clamp 2/25) with K1's warp variant on
     every transition, and the mildly scaled diagonal N((1, 2, 3),
     diag(1, 2, 3)) (5 chains x 2000 draws, default warmup) with K2 on
     every leaf of the plain driver. Each prints R-hat max, tau min, EBFMI
     min, the smallest AD p and the wall; a failed gate fails the run.
  7. Mesh: main's configuration over a torch.distributed group, each rank
     a process started by this script (``--mesh-worker``) that loads the
     tree kernel phase 2 built, every launch count set to 0 just before
     its run and read just after; every rank is killed after
     MESH_SPAWN_SECONDS and every collective times out:
     - one_rank: one rank on an NCCL group (after one NCCL all_reduce),
       run_chains with main's generator on global_chain_mesh: main's
       draws, eps and M^-1 bit for bit (SHA-256 against phase 4's main
       run), K1's warp variant on all 1,412 transitions;
     - two_ranks: two ranks sharing the card over gloo (NCCL refuses two
       ranks on one device), run_chains_multihost with 2048 chains each:
       on each rank 1,412 warp-variant launches and finite draws, the
       pooled metric bitwise the same on both, main's moment gate and
       split R-hat <= 1.01 over the gathered 4096 chains; then a short
       pooled-eps run (256 chains a rank) whose eps and metric must be
       bitwise the same on both ranks. Prints each rank's wall and the
       gathered min bulk ESS beside main's, and the phase's time. Two
       ranks on one card share its SMs: their wall says nothing of
       scaling, and no multi-GPU run is made;
     - dryrun_passes_4_6: passes 4-6 of the JAX package's
       dryrun_multichip on two gloo ranks sharing the card, 4 chains a
       rank of mvnormal(0, I_4, fused=True), 8 draws, the dry run's
       stages with a diagonal metric (K2 takes no dense one): (4) per-chain eps
       stratified over the mesh with warmup clamp 3, (5) the wavefront
       warmup with a pooled stepsize, its eps bitwise the same on both
       ranks, (6) epoch sampling; K2 on every driver leaf of each pass.
  8. Schedulers, at full width, each line beside its lockstep twin of
     phase 4 (``twin``: wall, min bulk ESS, warmup and draw slots, host ms
     per warmup slot):
     - wavefront_gauss: gauss_fused's configuration with
       warmup_driver="wavefront": K2 on every wavefront slot and every
       draw leaf; its warmup slots, their fill (leapfrog steps over slots
       x chains) and host ms a slot; gauss_fused's moment bands and split
       R-hat <= 1.01;
     - epoch_gauss and stratified_gauss: from gauss_fused's final warmup
       checkpoint (its eps and M^-1 bit for bit), the draws through the
       epoch driver, or stratify_sampling=4 (group-serial); K2 on every
       slot or leaf; the same gates and min bulk ESS within 10% of
       gauss_fused's;
     - stratified_main: main's configuration with stratify_sampling=4:
       eps and M^-1 bitwise main's, K1's warp variant on all 900 + 4 x 512
       transitions, main's moment gate;
     - wavefront_logreg: logreg_fused's configuration with the wavefront
       warmup, 64 draws (cut from 512): K3 on every slot, every posterior
       mean within 5 MCSE of logreg_tree's.
  9. Surface: logistic_regression(4000, 128, fused="auto",
     tree_kernel="auto") attaches the route the measured rule names
     (ops/logreg_leaf.fused_leaf_pays, ops/tree_kernel.tree_kernel_pays),
     and one transition through it launches that route's kernel;
     profiling.transition_throughput on main's model at 1024 chains
     (its grad evals/s, K1 on each of its 7 transitions);
     profiling.trace around one K1 call writes a trace whose kernels
     include the tree kernel, in a process of its own (``--trace-worker``,
     killed after TRACE_SPAWN_SECONDS; in this process, where
     torch.profiler has recorded no kernel after phases 4-8, the same
     trace is reported after phases 5-9, ``[trace probe]`` lines, not
     gated); the native ESS engine (native/fastdiag.cpp,
     built with the host compiler) loads, and stats.ess_rhat over main's
     draws of its first 8 coordinates agrees with the numpy path to 1e-7
     (both times printed). Its launches are not in the kernels line.
With --profile, each path's timed run is repeated under torch.profiler
after phase 5 and the device split is printed; --profile=main,funnel
profiles the paths named only.

The kernels line's ``launches`` are each kernel's launches on its phase-4
path plus those of phase 8. The line before the last is the nvidia-smi
name and power limit; the last line is {"ok": true, "device": {...}}.
Needs CUDA; never runs on the CPU.
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
# the logreg leaf's staged-X variant at the benchmark's shape, phases 3, 5
C_XSTAGED, K_XSTAGED, N_XSTAGED = 16384, 25, 1000
K_WIDE = 300  # the fused logreg leaf past 256 coordinates, tiled, phase 3
# past the tiled slice kernel's widest K: the chunked one with 64-row and
# with 16-row tiles of X, phase 3
K_CHUNKED = (320, 512)
# the fused leaf's hierarchical mode at the benchmark's logreg_hier_1000x302
# shape (1000 rows, 24 covariates and their 276 products, an intercept and
# t: K = 302, the tiled slice kernel): phases 3 and 5 at its 16,384 chains,
# phase 4's logreg_hier_fused path at 4096
C_HIER, N_HIER, D_HIER, C_HIER_PATH = 16384, 1000, 24, 4096
C_GAUSS, K_GAUSS = 4096, 25  # BASELINE config 1 under the fleet
N_PER_CHAIN, PER_CHAIN_SEEDS = 1000, (0, 1, 2, 3)
N_GENERIC, GENERIC_SEEDS = 1000, (0, 1)  # the generic driver's path
N_STEPWISE = 64  # transitions of each stepwise next_chunk
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
    - kernel_variant names ``expect`` ("warp", "xstaged" or "cta") for the
      shape, and the launch takes it;
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
    warp0, xs0 = tree_kernel.warp_launches, tree_kernel.xstaged_launches
    out = tree_kernel.tree_transition(*args)
    again = tree_kernel.tree_transition(*args)
    warp_runs = tree_kernel.warp_launches - warp0
    xs_runs = tree_kernel.xstaged_launches - xs0
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
                                         kind == "diag", args[9].n_obs)
    result = {"config": f"{name} K={model.dim} {kind} dcap={dcap}", "chains": C,
              "mismatched_chains": mismatch, "matching_fraction": frac,
              "chains_off_float64": off64,
              "divergent_chains": int((ref["prop_pi"] == -torch.inf).sum()),
              "variant": variant, "warp_variant_launches": warp_runs,
              "xstaged_variant_launches": xs_runs}
    fails = []
    want = lambda cond, msg: cond or fails.append(msg)  # noqa: E731
    want(variant == expect, f"{result['config']}: the shape's variant is "
                            f"{variant}, expected {expect}")
    want(warp_runs == (2 if variant == "warp" else 0),
         f"{result['config']}: {warp_runs} of 2 launches took the warp "
         f"variant, the shape's is {variant}")
    want(xs_runs == (2 if variant == "xstaged" else 0),
         f"{result['config']}: {xs_runs} of 2 launches took the staged-X "
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


def hier_data():
    """The data of the benchmark's logreg_hier_1000x302 (its configuration's
    ``assumed``): from RandomState(0) the covariates, the design of
    tests/torch_reference_hlr.py, 24 main effects of 0.2 N(0, 1), 276
    interactions of 0.05 N(0, 1), the intercept -0.8473, then y ~
    Bernoulli(sigmoid(X' b)). Returns float64 (x, y)."""
    ref = tests_module("torch_reference_hlr")
    rng = np.random.RandomState(0)
    x = ref.design(rng.randn(N_HIER, D_HIER))
    beta = np.concatenate([[-0.8473], 0.2 * rng.randn(D_HIER),
                           0.05 * rng.randn(x.shape[1] - 1 - D_HIER)])
    probs = 1 / (1 + np.exp(-(x @ beta)))
    return x, (rng.uniform(size=N_HIER) < probs).astype(np.float64)


def hier_leaf_inputs(model, C, kind, gen):
    """Phase-3 inputs of the fused leaf's hierarchical mode (the joint
    density has no mode to draw around): b ~ 0.1 N(0, 1) and t ~ U[-6, 1]
    (the posterior's t lies near -5, the warmup's starts near 0); M^-1 a
    shared diagonal from U[0.5, 2], the same scaled per chain by U[0.8,
    1.25], or a shared dense A A^T / K + I; momenta from it, the model's
    gradient, and a signed per-chain eps with |eps| in [0.005, 0.02], the
    cell's step sizes."""
    from dynamichmc_tpu_torch.metric import dense_metric, diagonal_metric
    from dynamichmc_tpu_torch.tree_batched import rand_p_b

    hook = model.fused_leaf_batched_fn
    x32, y32 = hook.operands
    dev, K = x32.device, model.dim
    q = 0.1 * torch.randn((C, K), generator=gen, device=dev)
    q[:, -1] = torch.empty(C, device=dev).uniform_(-6.0, 1.0, generator=gen)
    if kind == "shared_dense":
        a = torch.randn((K, K), generator=gen, device=dev)
        metric = dense_metric(a @ a.mT / K + torch.eye(K, device=dev))
    else:
        m = torch.empty(K, device=dev).uniform_(0.5, 2.0, generator=gen)
        if kind == "chain_diag":
            m = (m * torch.empty((C, 1), device=dev).uniform_(
                0.8, 1.25, generator=gen)).contiguous()
        metric = diagonal_metric(m)
    p = rand_p_b(gen, metric, (C, K), torch.float32).contiguous()
    _v, g = model.logdensity_and_gradient(q)
    sign = torch.where(torch.rand(C, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    eps = sign * torch.empty(C, device=dev).uniform_(0.005, 0.02, generator=gen)
    return metric, q, p, g.contiguous(), eps.contiguous(), x32, y32, hook.rate


def leaf_of(model):
    """(kernel, plain version, inputs, label) of the model's fused logreg
    leaf: the hierarchical mode where the hook carries a rate."""
    from dynamichmc_tpu_torch.ops import logreg_leaf

    if model.fused_leaf_batched_fn.rate is None:
        return (logreg_leaf.logreg_leaf, logreg_leaf.logreg_leaf_plain,
                fused_leaf_inputs, "logreg_fused")
    return (logreg_leaf.logreg_leaf_hier, logreg_leaf.logreg_leaf_hier_plain,
            hier_leaf_inputs, "logreg_fused_hier")


def compare_fused_leaf(model, C, kind, gen):
    """Phase 3 for the fused logreg leaf in one metric form, in the mode
    the model's hook takes (:func:`leaf_of`):
    - ld' and pi' agree with the plain float32 version to 1e-4 (1 + |x|);
    - q', p', g', ld' and pi' are no further from the float64 plain leaf
      than twice the plain float32 version's distance, plus 1e-5 (1 + |x|):
      the plain version sums the observations in cuBLAS's order, the
      kernel in its own tiles;
    - the -inf pattern of ld' and pi' is the plain version's;
    - the call is one launch, of the hierarchical mode exactly where the
      model's prior is hierarchical, and of the tiled slice kernel exactly
      where the plan gives it K (``logreg_leaf.tiled``)."""
    from dynamichmc_tpu_torch.ops import logreg_leaf

    kernel, plain, inputs, label = leaf_of(model)
    args = inputs(model, C, kind, gen)
    logreg_leaf.reset_launches()
    out = kernel(*args)
    hier = label == "logreg_fused_hier"
    tiled = logreg_leaf.tiled(model.dim)
    check(logreg_leaf.launches == 1 and logreg_leaf.hier_launches == hier
          and logreg_leaf.tiled_launches == tiled,
          f"{label}: {logreg_leaf.launches} launches, "
          f"{logreg_leaf.hier_launches} of the hierarchical mode, "
          f"{logreg_leaf.tiled_launches} of the tiled slice kernel")
    ref = plain(*args)
    metric = args[0]
    metric64 = type(metric)(metric.m_inv.double(), None)
    ref64 = plain(metric64, *_as64(args[1:]))
    torch.cuda.synchronize()
    result = {"config": f"{label} K={model.dim} {kind}", "chains": C,
              "slice_kernel": "tiled" if tiled else "chunked"}
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


def run_path(model, C, n_draws, seed, config, dev, **options):
    """Phase 4: one run_chains call through the entry point a user calls;
    returns the result, its wall seconds and the launch counts of the
    run (every count set to 0 just before it)."""
    from dynamichmc_tpu_torch import run_chains

    gen = torch.Generator(device=dev).manual_seed(seed)
    return timed(lambda: run_chains(gen, model, C, n_draws, **config,
                                    **options))


def run_per_chain(model, dev):
    """Phase 4, per_chain: one mcmc_with_warmup call per seed, each chain
    on its own generator; returns the results, the seconds of the four
    calls together and their launch counts (set to 0 just before them)."""
    from dynamichmc_tpu_torch import mcmc_with_warmup
    from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = [mcmc_with_warmup(torch.Generator(device=dev).manual_seed(s),
                                model, N_PER_CHAIN) for s in PER_CHAIN_SEEDS]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return results, seconds, launch_counts()


MEMORY = {}  # the last timed run's device memory: GB held before it, peak
TIMES = {}  # the last timed run's start on the host clock ("t0")


def timed(fn):
    """Run ``fn()`` with every launch count set to 0 just before it; returns
    its result, its wall seconds and the counts read just after it. Leaves
    the device memory held before the run and the run's peak in MEMORY."""
    from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = TIMES["t0"] = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    MEMORY.update(before_gb=before / 1e9,
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out, seconds, launch_counts()


def check_k4_only(name, counts):
    """Every hamiltonian.leapfrog call launched K4 once, and no other
    kernel launched."""
    check(counts["gaussian_leapfrog"] == counts["leapfrog_calls"] > 0,
          f"{name}: fused leapfrog launched {counts['gaussian_leapfrog']} "
          f"times for {counts['leapfrog_calls']} leapfrog calls")
    check(counts["tree_transition"] == counts["tree_transition_warp"]
          == counts["gaussian_fused_leaf"] == counts["logreg_fused_leaf"] == 0,
          f"{name}: another kernel launched")


def tests_module(name):
    """A helper module of the repo's tests/ directory."""
    import importlib

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def generic_stages():
    """A stage tuple of two metric kinds, the default schedule's 900
    transitions otherwise."""
    from dynamichmc_tpu_torch import InitialStepsizeSearch, TuningNUTS

    return (InitialStepsizeSearch(), TuningNUTS(75),
            TuningNUTS(25, "diagonal"), TuningNUTS(50, "diagonal"),
            TuningNUTS(100, "dense"), TuningNUTS(200, "dense"),
            TuningNUTS(400, "dense"), TuningNUTS(50))


def stages_tree_config():
    """stages_tree: the main path's 900 transitions as pooled diagonal
    blocks 25/50 then pooled dense blocks 100/200/400, NUTS(max_depth=4),
    per-chain dual-averaging eps, no clamp."""
    from dynamichmc_tpu_torch import InitialStepsizeSearch, NUTS, TuningNUTS

    stages = (InitialStepsizeSearch(), TuningNUTS(75),
              TuningNUTS(25, "diagonal", pooled=True),
              TuningNUTS(50, "diagonal", pooled=True),
              TuningNUTS(100, "dense", pooled=True),
              TuningNUTS(200, "dense", pooled=True),
              TuningNUTS(400, "dense", pooled=True), TuningNUTS(50))
    return dict(tune="reference", warmup_stages=stages,
                algorithm=NUTS(max_depth=MD_MAIN), dtype=torch.float32)


class LogCollector:
    """Collects the port's log records (a reporter's lines) while open."""

    def __init__(self):
        import logging

        self.records = []
        self.handler = logging.Handler()
        self.handler.emit = self.records.append
        self.logger = logging.getLogger("dynamichmc_tpu_torch")

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


class DiagonalCounter:
    """Counts a model's fused-leapfrog hook calls by the metric's kind:
    K4, like the JAX kernel, takes a diagonal M^-1 only, and the hook
    steps a dense one in plain torch."""

    def __init__(self, hook):
        self.hook, self.diagonal, self.dense = hook, 0, 0

    def __call__(self, metric, z, eps):
        from dynamichmc_tpu_torch.metric import DiagonalMetric

        if isinstance(metric, DiagonalMetric):
            self.diagonal += 1
        else:
            self.dense += 1
        return self.hook(metric, z, eps)


def run_slice13_paths(normal, gauss, fused_state, per_chain, dev, smi):
    """Phase 4's paths of the per-chain API, the stage fold and the
    stepwise API (keep_warmup, generic, stepwise, stages_tree); fails on a
    gate. ``per_chain``: the per_chain path's results (mcmc_with_warmup,
    seeds PER_CHAIN_SEEDS), whose chain of seed 0 keep_warmup must equal
    bit for bit."""
    import dataclasses
    from dynamichmc_tpu_torch import (
        NUTS, LogProgressReport, mcmc_keep_warmup, mcmc_steps,
        mcmc_steps_from_state, mcmc_with_warmup, run_chains)
    from dynamichmc_tpu_torch.hamiltonian import evaluate

    GeneralizedReimpl = tests_module("torch_turn_statistics").GeneralizedReimpl

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # keep_warmup: the stage fold with every state kept, and a reporter, on
    # seed 0: its draws are per_chain's chain of seed 0 bit for bit, which
    # passed per_chain's gate, so they are reported here, not gated again
    with LogCollector() as records:
        out, seconds, counts = timed(lambda: mcmc_keep_warmup(
            gen(PER_CHAIN_SEEDS[0]), normal, N_PER_CHAIN,
            reporter=LogProgressReport(step_interval=250)))
    check_k4_only("keep_warmup", counts)
    want = [(n, K_GAUSS) for n in (75, 25, 50, 100, 200, 400, 50)]
    history, ref = out["warmup"], per_chain[0]
    shapes = [tuple(r["positions"].shape) for _s, r, _st in history[1:]]
    check(len(history) == 8 and shapes == want,
          f"keep_warmup: history of {len(history)} entries, {shapes}")
    final, inference = out["final_warmup_state"], out["inference"]
    check(torch.equal(inference.positions, ref.positions)
          and torch.equal(final.eps, ref.eps)
          and torch.equal(final.metric.m_inv, ref.metric.m_inv),
          "keep_warmup: draws, eps or metric differ from mcmc_with_warmup's")
    lines = sum("MCMC progress" in r.getMessage() for r in records)
    check(lines >= 8, f"keep_warmup: {lines} progress lines")
    stats = inference.tree_statistics
    metrics = {"path": "keep_warmup", "wall_s": seconds,
               "launch_counts": counts, "chains": 1, "draws": N_PER_CHAIN,
               "dim": K_GAUSS, "bitwise_mcmc_with_warmup": True,
               "progress_lines": lines, "eps": float(final.eps),
               "mean_acceptance": float(stats.acceptance_rate.mean()),
               "divergences": int(stats.is_divergent.sum()), "gpu": smi}
    metrics.update(path_diagnostics(stacked_statistics([inference])))
    log(f"[4 path] {json.dumps(metrics)}")

    # generic: a custom turn statistic (the generic driver) and a schedule
    # of two metric kinds (the stage fold), two chains
    stages = generic_stages()
    algorithm = NUTS(turn_statistic_configuration=GeneralizedReimpl())
    hook = DiagonalCounter(normal.fused_leapfrog_fn)
    model = dataclasses.replace(normal, fused_leapfrog_fn=hook)
    results, seconds, counts = timed(lambda: [
        mcmc_with_warmup(gen(s), model, N_GENERIC, warmup_stages=stages,
                         algorithm=algorithm) for s in GENERIC_SEEDS])
    # K4 on every leapfrog with a diagonal metric (the search and the
    # blocks up to the first dense estimate); the dense rest in plain torch
    check(counts["gaussian_leapfrog"] == hook.diagonal > 0
          and hook.diagonal + hook.dense == counts["leapfrog_calls"],
          f"generic: K4 launched {counts['gaussian_leapfrog']} times for "
          f"{hook.diagonal} diagonal-metric leapfrogs ({hook.dense} dense, "
          f"{counts['leapfrog_calls']} in all)")
    check(counts["tree_transition"] == counts["gaussian_fused_leaf"]
          == counts["logreg_fused_leaf"] == 0, "generic: another kernel")
    metrics = check_generic(results, seconds)
    metrics.update(path_diagnostics(stacked_statistics(results)))
    metrics.update({"path": "generic", "launch_counts": counts,
                    "leapfrogs_diagonal_metric": hook.diagonal,
                    "leapfrogs_dense_metric": hook.dense,
                    "chains": len(results), "draws": N_GENERIC,
                    "dim": K_GAUSS, "gpu": smi})
    log(f"[4 path] {json.dumps(metrics)}")

    # stepwise, one chain, from keep_warmup's final state
    steps = mcmc_steps_from_state(normal, NUTS(), final)
    (_Q, chunk), seconds, counts = timed(
        lambda: steps.next_chunk(gen(5), final.Q, N_STEPWISE))
    check_k4_only("stepwise (one chain)", counts)
    check(tuple(chunk.positions.shape) == (N_STEPWISE, K_GAUSS)
          and bool(torch.isfinite(chunk.positions).all()),
          f"stepwise (one chain): positions {tuple(chunk.positions.shape)}, "
          "or non-finite")
    single = {"wall_s": seconds, "launch_counts": counts,
              "divergences": int(chunk.tree_statistics.is_divergent.sum())}

    # stepwise, the batch: gauss_fused's per-chain metric and eps, its last
    # draws as Q
    metric_b, eps_b, q_b = fused_state
    steps_b = mcmc_steps(normal, NUTS(), metric_b, eps_b)
    Q_b = evaluate(normal, q_b)
    (_Qb, chunk_b), seconds, counts = timed(
        lambda: steps_b.next_chunk(gen(6), Q_b, N_STEPWISE))
    check(counts["gaussian_fused_leaf"] == counts["driver_fused_leaves"] > 0,
          f"stepwise (batch): K2 launched {counts['gaussian_fused_leaf']} "
          f"times for {counts['driver_fused_leaves']} driver leaves")
    check(counts["tree_transition"] == counts["gaussian_leapfrog"]
          == counts["logreg_fused_leaf"] == 0,
          "stepwise (batch): another kernel launched")
    draws = chunk_b.positions
    check(tuple(draws.shape) == (N_STEPWISE, C_GAUSS, K_GAUSS),
          f"stepwise (batch): positions shape {tuple(draws.shape)}")
    check(bool(torch.isfinite(draws).all()), "stepwise (batch): non-finite")
    batch = check_standard_normal(draws.double().reshape(-1, K_GAUSS), 0.05,
                                  (0.9, 1.1))
    batch.update({"wall_s": seconds, "launch_counts": counts,
                  "chains": C_GAUSS,
                  "divergences": int(chunk_b.tree_statistics.is_divergent.sum())})
    log(f"[4 path] {json.dumps({'path': 'stepwise', 'steps': N_STEPWISE, 'one_chain': single, 'batch': batch, 'gpu': smi})}")

    # stages_tree: the stage fold on the batch, through K1's warp variant
    config = stages_tree_config()
    res, seconds, counts = timed(lambda: run_chains(
        gen(SEED), gauss, C_MAIN, N_DRAWS, **config))
    expected = sum(s.N for s in config["warmup_stages"][1:]) + N_DRAWS
    check(counts["tree_transition"] == counts["tree_transition_warp"]
          == expected,
          f"stages_tree: {counts['tree_transition']} launches "
          f"({counts['tree_transition_warp']} warp) for {expected} "
          "transitions")
    check(counts["gaussian_fused_leaf"] == counts["logreg_fused_leaf"]
          == counts["gaussian_leapfrog"] == 0,
          "stages_tree: another kernel launched")
    check(tuple(res.metric.m_inv.shape) == (K_MAIN, K_MAIN),
          f"stages_tree: metric shape {tuple(res.metric.m_inv.shape)}")
    metrics = check_draws(gauss, res, seconds)
    metrics.update(path_diagnostics(res.tree_statistics,
                                    "per-chain work (tree kernel)"))
    metrics.update({"path": "stages_tree", "launch_counts": counts,
                    "chains": C_MAIN, "draws": N_DRAWS, "dim": K_MAIN,
                    "adapted_eps_range": [float(res.eps.min()),
                                          float(res.eps.max())],
                    "gpu": smi})
    log(f"[4 path] {json.dumps(metrics)}")


ESS_TARGET, STREAM_CHUNK = 1.0e6, 64  # the ess_target and streamed runs
CHECKPOINT_STEPS = [0, 75, 100, 150, 250, 450, 850, 900]  # main's stages
RESUME_STEP = 450  # the resumed run starts before the 400-step block
N_CONSTRAINED, C_CONSTRAINED = 256, 1024
DIRICHLET = (2.0, 3.0, 4.0)


def run_slice14_paths(gauss, main, dev, smi):
    """Phase 4's streamed, resumed, ess_target and constrained paths; fails
    on a gate. ``main``: the main path's timed run (its draws on the host,
    eps, M^-1, device memory), which the first three equal bit for bit."""
    import tempfile

    from dynamichmc_tpu_torch.checkpoint import load_state, save_state
    from dynamichmc_tpu_torch.io import MemmapDrawStore

    config = main_path_config()
    expected = expected_transitions(N_DRAWS)
    ref = main["positions"].numpy()

    def same_adaptation(name, res):
        check(torch.equal(res.eps, main["eps"])
              and torch.equal(res.metric.m_inv, main["m_inv"]),
              f"{name}: eps or M^-1 differ from main's")

    def k1_only(name, counts, want):
        check(counts["tree_transition"] == counts["tree_transition_warp"]
              == want, f"{name}: {counts['tree_transition']} launches "
              f"({counts['tree_transition_warp']} warp) for {want} "
              "transitions")
        check(counts["gaussian_fused_leaf"] == counts["logreg_fused_leaf"]
              == counts["gaussian_leapfrog"] == 0,
              f"{name}: another kernel launched")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # streamed: main's run with its draws sunk to a memmap store, 64 a
        # chunk, and every warmup checkpoint kept
        store = MemmapDrawStore(os.path.join(tmp, "draws"), C_MAIN, N_DRAWS,
                                K_MAIN)
        ckpts = []
        res, seconds, counts = run_path(
            gauss, C_MAIN, N_DRAWS, SEED, config, dev,
            draw_sink=store.sink, sample_chunk=STREAM_CHUNK,
            warmup_checkpoint_sink=ckpts.append)
        memory = dict(MEMORY)
        k1_only("streamed", counts, expected)
        check(res.positions is None and res.logdensities is None,
              "streamed: draws kept on the device")
        store.flush()
        check(store.written == N_DRAWS
              and np.array_equal(np.asarray(store.positions), ref)
              and np.array_equal(np.asarray(store.logdensities),
                                 main["logdensities"].numpy()),
              "streamed: the store differs from main's draws")
        same_adaptation("streamed", res)
        steps = [c.step for c in ckpts]
        check(steps == CHECKPOINT_STEPS,
              f"streamed: checkpoints at {steps}, expected {CHECKPOINT_STEPS}")
        line = {
            "path": "streamed", "wall_s": seconds, "launch_counts": counts,
            "chains": C_MAIN, "draws": N_DRAWS, "dim": K_MAIN,
            "sample_chunk": STREAM_CHUNK, "bitwise_main": True,
            "checkpoint_steps": steps, "device_memory": memory,
            "main_device_memory": main["memory"],
            "peak_saved_gb": main["memory"]["peak_gb"] - memory["peak_gb"],
            "main_wall_s": main["wall_s"], "gpu": smi}
        log(f"[4 path] {json.dumps(line)}")
        del store, res

        # resumed: the step-450 checkpoint through disk, a fresh generator
        ckpt = ckpts[CHECKPOINT_STEPS.index(RESUME_STEP)]
        save_state(os.path.join(tmp, "ckpt"), ckpt)
        restored, _ = load_state(os.path.join(tmp, "ckpt"))
        del ckpts, ckpt
        res, seconds, counts = run_path(gauss, C_MAIN, N_DRAWS, SEED + 1,
                                        config, dev, warmup_resume=restored)
        k1_only("resumed", counts, expected - RESUME_STEP)
        check(np.array_equal(res.positions.cpu().numpy(), ref),
              "resumed: draws differ from main's")
        same_adaptation("resumed", res)
        line = {
            "path": "resumed", "wall_s": seconds, "launch_counts": counts,
            "resume_step": RESUME_STEP, "resume_stage": restored.stage,
            "bitwise_main": True, "gpu": smi}
        log(f"[4 path] {json.dumps(line)}")
        del res, restored

    # ess_target: main's run until min bulk ESS 1e6, checked at 64, 128, 256
    lines = []
    res, seconds, counts = run_path(
        gauss, C_MAIN, N_DRAWS, SEED, config, dev, ess_target=ESS_TARGET,
        sample_chunk=STREAM_CHUNK, log=lines.append)
    drawn = res.positions.shape[1]
    k1_only("ess_target", counts, expected - N_DRAWS + drawn)
    checks = [(int(m.group(1)), float(m.group(2))) for m in (
        re.match(r"ess check @ (\d+) draws: min bulk ESS (\d+)", line)
        for line in lines) if m]
    check(checks and checks[-1][0] == drawn and checks[-1][1] >= ESS_TARGET
          and all(ess < ESS_TARGET for _n, ess in checks[:-1]),
          f"ess_target: stopped at {drawn} draws after checks {checks}")
    check(np.array_equal(res.positions.cpu().numpy(), ref[:, :drawn]),
          "ess_target: draws are not main's prefix")
    line = {
        "path": "ess_target", "wall_s": seconds, "launch_counts": counts,
        "target": ESS_TARGET, "draws": drawn, "checks": checks,
        "main_min_bulk_ess": main["min_bulk_ess"], "prefix_of_main": True,
        "gpu": smi}
    log(f"[4 path] {json.dumps(line)}")
    del res
    run_constrained(dev, smi)


def run_constrained(dev, smi):
    """constrained: Dirichlet(2, 3, 4) through the simplex transform, 1024
    chains, float32, warmup depth clamp 2 with a 25-step tail, the plain
    batch driver with autograd (no kernel): finite draws, rows on the
    simplex, each mean within 5 MCSE."""
    from dynamichmc_tpu_torch import run_chains
    from dynamichmc_tpu_torch.constraints import (
        constrain_draws, simplex, transformed_logdensity)
    from dynamichmc_tpu_torch.stats_device import ess_bulk_device
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    alpha = torch.tensor(DIRICHLET, device=dev)
    model = transformed_logdensity(
        lambda y: ((alpha - 1) * torch.log(y)).sum(-1), [simplex(3)])
    stages = default_warmup_stages(init_steps=75, middle_steps=25,
                                   doubling_stages=3, terminating_steps=50)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the fleet's warmup clamp, as on main: unclamped, the lockstep batch
    # runs its deepest chain's early trees, 48.4 s on an H100 (700 W)
    res, seconds, counts = timed(lambda: run_chains(
        gen, model, C_CONSTRAINED, N_CONSTRAINED, tune="reference",
        warmup_stages=stages, warmup_depth_clamp=2,
        warmup_depth_clamp_tail=25))
    check(sum(counts[k] for k in ("tree_transition", "gaussian_fused_leaf",
                                  "logreg_fused_leaf", "gaussian_leapfrog"))
          == 0, "constrained: a kernel launched")
    check(bool(torch.isfinite(res.positions).all()),
          "constrained: non-finite draws")
    p = constrain_draws([simplex(3)], res.positions).double()
    row_err = float((p.sum(-1) - 1).abs().max())
    check(row_err <= 1e-5, f"constrained: rows sum to 1 within {row_err:.3g}")
    ess = ess_bulk_device(p)
    flat = p.reshape(-1, 3)
    want = torch.tensor(DIRICHLET, dtype=torch.float64, device=dev)
    want = want / want.sum()
    z = (flat.mean(0) - want).abs() / (flat.std(0) / ess.sqrt())
    check(bool((z <= 5).all()), f"constrained: |mean - alpha / sum| / mcse "
                                f"= {z.tolist()}")
    line = {
        "path": "constrained", "wall_s": seconds, "launch_counts": counts,
        "chains": C_CONSTRAINED, "draws": N_CONSTRAINED, "dim": 2,
        "mean": flat.mean(0).tolist(), "target_mean": want.tolist(),
        "z_mcse": z.tolist(), "min_bulk_ess": float(ess.min()),
        "max_row_sum_err": row_err, "eps_range": [
            float(res.eps.min()), float(res.eps.max())],
        "divergences": int(res.tree_statistics.is_divergent.sum()),
        "gpu": smi}
    log(f"[4 path] {json.dumps(line)}")


AUTO_LINE = ("autotune: max_depth=4, pooled dense metric, per-chain eps, "
             "warmup clamp 2/25")  # what the JAX package logs at 4096 x 100
C_CUSTOM, N_CUSTOM = 4, 256  # the custom_batch path


def custom_stages():
    """custom_batch's warmup: search, 75 eps-only, diagonal 25, 50, 100,
    then 50 eps-only (556 transitions with its 256 draws)."""
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    return default_warmup_stages(init_steps=75, middle_steps=25,
                                 doubling_stages=3, terminating_steps=50)


def run_slice15_paths(gauss, fun, normal, main, dev, smi):
    """Phase 4's auto_main, auto_funnel and custom_batch paths; fails on a
    gate. ``main``: the main path's timed run, which auto_main must equal
    bit for bit."""
    from dynamichmc_tpu_torch import NUTS, autotune
    from dynamichmc_tpu_torch.stats_device import ess_rhat_device

    GeneralizedReimpl = tests_module("torch_turn_statistics").GeneralizedReimpl
    expected = expected_transitions(N_DRAWS)

    def auto_run(name, model):
        lines = []
        res, seconds, counts = run_path(model, C_MAIN, N_DRAWS, SEED, {}, dev,
                                        log=lines.append)
        auto = [line for line in lines if line.startswith("autotune:")]
        check(auto == [AUTO_LINE], f"{name}: autotune lines {auto}")
        check(counts["tree_transition"] == counts["tree_transition_warp"]
              == expected, f"{name}: {counts['tree_transition']} launches "
              f"({counts['tree_transition_warp']} warp) for {expected} "
              "transitions")
        check(counts["gaussian_fused_leaf"] == counts["logreg_fused_leaf"]
              == counts["gaussian_leapfrog"] == 0,
              f"{name}: another kernel launched")
        check(tuple(res.metric.m_inv.shape) == (model.dim, model.dim),
              f"{name}: metric shape {tuple(res.metric.m_inv.shape)}")
        # the warning appears exactly when the share at the cap exceeds
        # the threshold
        share = float((res.tree_statistics.depth >= MD_MAIN).double().mean())
        warned = sum(line.startswith("autotune WARNING") for line in lines)
        check(warned == int(share > autotune.CAP_SATURATION_WARN),
              f"{name}: {warned} warnings at a cap share of {share:.4f}")
        metrics, _ess = path_metrics(res, seconds)
        metrics.update(path_diagnostics(res.tree_statistics,
                                        "per-chain work (tree kernel)"))
        metrics.update({"path": name, "launch_counts": counts,
                        "chains": C_MAIN, "draws": N_DRAWS, "dim": model.dim,
                        "autotune_line": auto[0], "cap_share": share,
                        "warned": bool(warned),
                        "adapted_eps_range": [float(res.eps.min()),
                                              float(res.eps.max())],
                        "gpu": smi})
        return res, metrics

    # auto_main: the plain call is main's configuration
    res, metrics = auto_run("auto_main", gauss)
    check(torch.equal(res.positions.cpu(), main["positions"])
          and torch.equal(res.eps, main["eps"])
          and torch.equal(res.metric.m_inv, main["m_inv"]),
          "auto_main: draws, eps or M^-1 differ from main's")
    metrics.update({"bitwise_main": True, "main_wall_s": main["wall_s"]})
    log(f"[4 path] {json.dumps(metrics)}")
    del res

    # auto_funnel: the plain call on the funnel, a dense metric and md 4
    res, metrics = auto_run("auto_funnel", fun)
    v = res.positions[:, :, 0].double()
    metrics.update({"mean_v": float(v.mean()),
                    "sd_v": float(v.std(correction=0))})
    log(f"[4 path] {json.dumps(metrics)}")
    del res

    # custom_batch: the generic driver looped over 4 chains, K4 per leapfrog
    algorithm = NUTS(turn_statistic_configuration=GeneralizedReimpl())
    res, seconds, counts = run_path(
        normal, C_CUSTOM, N_CUSTOM, SEED,
        {"warmup_stages": custom_stages(), "algorithm": algorithm}, dev)
    check_k4_only("custom_batch", counts)
    check(tuple(res.positions.shape) == (C_CUSTOM, N_CUSTOM, K_GAUSS),
          f"custom_batch: positions shape {tuple(res.positions.shape)}")
    metrics, _ess = path_metrics(res, seconds)
    draws = res.positions.double()
    metrics.update(check_standard_normal(draws.reshape(-1, K_GAUSS), 0.15,
                                         (0.8, 1.2)))
    rhat = float(ess_rhat_device(draws)["rhat"].max())
    check(rhat <= 1.05, f"custom_batch: split R-hat up to {rhat:.4f}")
    acc = float(res.tree_statistics.acceptance_rate.mean())
    check(0.6 <= acc <= 0.95, f"custom_batch: mean acceptance {acc:.4f}")
    metrics.update(path_diagnostics(res.tree_statistics))
    metrics.update({"path": "custom_batch", "launch_counts": counts,
                    "chains": C_CUSTOM, "draws": N_CUSTOM, "dim": K_GAUSS,
                    "max_rhat": rhat, "mean_acceptance": acc,
                    "transitions_per_chain": sum(
                        s.N for s in custom_stages()[1:]) + N_CUSTOM,
                    "host_ms_per_leapfrog": 1e3 * seconds
                    / counts["leapfrog_calls"],
                    "eps": res.eps.tolist(), "gpu": smi})
    log(f"[4 path] {json.dumps(metrics)}")


def check_generic(results, seconds):
    """The generic path's gate: finite draws; per chain, split R-hat <=
    1.05 and mean acceptance in [0.6, 0.95]. Returns the phase-4 metrics."""
    from dynamichmc_tpu_torch.mcmc import stack_posterior_matrices
    from dynamichmc_tpu_torch.stats_device import ess_rhat_device

    draws = stack_posterior_matrices(results).transpose(0, 1)  # (C, N, K)
    metrics, _ess = path_metrics(SimpleNamespace(
        positions=draws, tree_statistics=SimpleNamespace(
            steps=torch.stack([r.tree_statistics.steps for r in results]),
            is_divergent=torch.stack([r.tree_statistics.is_divergent
                                      for r in results]))), seconds)
    rhats = [float(ess_rhat_device(d.double())["rhat"].max()) for d in draws]
    accs = [float(r.tree_statistics.acceptance_rate.mean()) for r in results]
    check(max(rhats) <= 1.05, f"generic: split R-hat up to {max(rhats):.4f}")
    check(all(0.6 <= a <= 0.95 for a in accs),
          f"generic: mean acceptance {accs}")
    metrics.update({"max_rhat_per_chain": rhats, "mean_acceptance": accs,
                    "eps": [float(r.eps) for r in results]})
    return metrics


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


def path_diagnostics(stats, waste_reads=None):
    """Phase 4's diagnostics of a path's draws (reported, not gated):
    EBFMI over the chains, the termination and depth counts, and, where
    the driver records ``work``, straggler_waste and what it reads."""
    from dynamichmc_tpu_torch.diagnostics import (
        EBFMI, count_depths, count_terminations, straggler_waste)

    ebfmi = EBFMI(stats).double()
    out = {"ebfmi_min": float(ebfmi.min()), "ebfmi_mean": float(ebfmi.mean()),
           "terminations": count_terminations(stats),
           "depth_counts": count_depths(stats).tolist()}
    if waste_reads is not None:
        out["straggler_waste"] = straggler_waste(stats)
        out["straggler_waste_reads"] = waste_reads
    return out


def stacked_statistics(results):
    """The per-chain results' (N,) tree statistics as one (C, N) set."""
    import dataclasses

    from dynamichmc_tpu_torch.nuts import TreeStatistics

    first = results[0].tree_statistics
    return TreeStatistics(**{
        f.name: (None if getattr(first, f.name) is None else torch.stack(
            [getattr(r.tree_statistics, f.name) for r in results]))
        for f in dataclasses.fields(TreeStatistics)})


def run_protocol(dev, smi):
    """Phase 6: two gates of the reference's statistical protocol
    (tests/torch_correctness_utils.py: R-hat, ESS per draw, Anderson-
    Darling against exact draws, EBFMI, at the JAX gates' thresholds) on
    the card at float32 through the kernels: the bench configuration at
    bench dimension through K1's warp variant (correlated_gaussian(64),
    128 chains x 256 draws, pooled dense metric, md 4, clamp 2/25; every
    transition a warp-variant launch), and the mildly scaled diagonal
    N((1, 2, 3), diag(1, 2, 3)) through K2 (5 chains x 2000 draws, default
    warmup, per-chain diagonal metric; every leaf of the plain driver a
    K2 launch). A failed gate raises."""
    protocol = tests_module("torch_correctness_utils")

    diagonal = next(w for w in protocol.SPECIFIC_NORMALS
                    if w[0] == "mildly scaled diagonal")
    gates = {
        "bench_dim_k1": lambda: protocol.bench_dim_k1_gate(dev),
        "mildly_scaled_diagonal_k2": lambda: protocol.specific_normal_gate(
            *diagonal, dtype=torch.float32, device=dev, fused=True,
            launch_check=protocol.k2_on_every_leaf),
    }
    for name, gate in gates.items():
        g = gate()
        line = {"gate": name, "rhat_max": g.rhat_max, "tau_min": g.tau_min,
                "ebfmi_min": g.ebfmi_min, "ad_p_min": g.ad_p_min,
                "wall_s": g.seconds, "launch_counts": g.launches, "gpu": smi}
        log(f"[6 protocol] {json.dumps(line)}")


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


def device_ms(fn, args, reps, kernel_name, runs=3):
    """Device time per call of the kernel named ``kernel_name`` over
    ``reps`` calls, from torch.profiler (the wrapper's host time excluded):
    the mean over the launches the profiler recorded. A profiler run may
    miss one launch at its start, and no more; a run that recorded fewer
    (the profiler once kept 12 of 50 on a loaded host) is repeated, up to
    ``runs`` in all."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    for run in range(1, runs + 1):
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
        if reps - 1 <= count <= reps:
            return total / count / 1e3
        log(f"[5 kernel time] profiler run {run} of {runs} saw {count} "
            f"{kernel_name} launches of {reps}")
    check(False, f"profiler saw {count} {kernel_name} launches of {reps} in "
                 f"each of {runs} runs")


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
    4 K^2 + 30 K diagonal; funnel 30 K, and 4 K^2 more with a dense M^-1
    (its two products); logreg 4 n K + 10 n + 30 K (the two products with
    X, the softplus and sigmoid terms)."""
    from dynamichmc_tpu_torch.ops import tree_kernel

    out = tree_kernel.tree_transition(*args)
    torch.cuda.synchronize()
    leaves = int(out["work"].sum())
    K = args[0].shape[1]
    leaf = args[9]
    if leaf.kind == tree_kernel.GAUSSIAN:
        per_leaf = (8 if args[8].ndim == 2 else 4) * K * K + 30 * K
    elif leaf.kind == tree_kernel.FUNNEL:
        per_leaf = 30 * K + (4 * K * K if args[8].ndim == 2 else 0)
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
    staged = {k: u for k, u in usage.items() if k[0] == "xstaged"}
    for key, u in sorted(staged.items()):
        metric = "diag" if key[1] else "dense"
        log(f"[2 build] tree_transition_kernel_xstaged {metric} R={key[2]}: "
            f"{u['usage']}; {u['spill']}")
    check(len(staged) == 8, f"ptxas reported {len(staged)} staged-X "
                            "instantiations, expected 8")
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
    tiled = tiled_slice_usage(logreg_leaf.library.build_log)
    for key, u in sorted(tiled.items()):
        log(f"[2 build] logreg_leaf_slice_kernel_tiled {key}: {u['usage']}; "
            f"{u['spill']}")
    check(len(tiled) == 3 * logreg_leaf.TILED_GROUPS,
          f"ptxas reported {len(tiled)} tiled slice-kernel instantiations, "
          f"expected {3 * logreg_leaf.TILED_GROUPS}")
    spilled = {k: u["spill"] for k, u in tiled.items()
               if "0 bytes spill stores, 0 bytes spill loads" not in u["spill"]}
    check(not spilled, f"the tiled slice kernel spills: {spilled}")


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
    diag, leaf, R) for the warp variant, ("xstaged", diag, R) for the
    logreg leaf's staged-X variant and ("cta", diag, leaf) for
    tree_transition_kernel (the wide one is not read)."""
    warp_re = re.compile(r"tree_transition_warp_kernelILb([01])ELi(\d+)ELi(\d+)EE")
    xs_re = re.compile(r"tree_transition_kernel_xstagedILb([01])ELi(\d+)EE")
    cta_re = re.compile(r"tree_transition_kernelILb([01])ELi(\d+)EE")

    def key_of(name):
        m, x, c = (r.search(name) for r in (warp_re, xs_re, cta_re))
        return (("warp", m[1] == "1", int(m[2]), int(m[3])) if m else
                ("xstaged", x[1] == "1", int(x[2])) if x else
                ("cta", c[1] == "1", int(c[2])) if c else None)

    return ptxas_usage(build_log, key_of)


def tiled_slice_usage(build_log):
    """ptxas_usage of each instantiation of the fused logreg leaf's tiled
    slice kernel, keyed "mode M, KG G" (the metric mode and the float2
    coordinate groups a thread takes)."""
    name_re = re.compile(r"logreg_leaf_slice_kernel_tiledILi(\d+)ELi(\d+)EE")

    def key_of(name):
        m = name_re.search(name)
        return f"mode {m[1]}, KG {m[2]}" if m else None

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

# --- phase 7: run_chains over a mesh of ranks ---------------------------------

MESH_SPAWN_SECONDS = 240  # one spawn of phase 7, every rank killed after it
MESH_COLLECTIVE_SECONDS = 120  # one collective of a phase-7 rank
MESH_1RANK_BACKEND = "nccl"
MESH_POOLED_EPS_CHAINS = 256  # a rank's chains in the pooled-eps run


def sha256(x: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest()


def pooled_eps_config():
    """Phase 7's pooled-eps run: main's target with a pooled dense metric
    and a pooled stepsize, 250 warmup transitions."""
    from dynamichmc_tpu_torch.nuts import NUTS
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    stages = default_warmup_stages(
        metric_kind="dense", pooled=True, pooled_stepsize=True,
        init_steps=25, middle_steps=25, doubling_stages=3,
        terminating_steps=50)
    return dict(tune="reference", warmup_stages=stages,
                algorithm=NUTS(max_depth=MD_MAIN), dtype=torch.float32)


def mesh_worker(argv):
    """One rank of phase 7, started by :func:`mesh_spawn`:
    ``--mesh-worker CASE RANK WORLD INIT_METHOD BACKEND DEVICE CHAINS K
    DRAWS OUT``. It loads the tree kernel the parent built (it never
    builds one), joins the group, runs main's configuration on ``CHAINS``
    chains of its own (``one_rank``: run_chains with main's generator on
    the global mesh; ``two_ranks``: run_chains_multihost), every launch
    count set to 0 just before and read just after, and saves what the
    parent checks to ``OUT``."""
    import datetime

    import torch.distributed as dist

    case, rank, world, init_method, backend, device = argv[:6]
    rank, world = int(rank), int(world)
    chains, K, draws = (int(a) for a in argv[6:9])
    out_path = argv[9]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamichmc_tpu_torch import run_chains, run_chains_multihost
    from dynamichmc_tpu_torch.models import correlated_gaussian
    from dynamichmc_tpu_torch.ops import tree_kernel
    from dynamichmc_tpu_torch.parallel import global_chain_mesh, initialize

    from dynamichmc_tpu_torch.ops import gaussian_leaf

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        lib = gaussian_leaf.library if case == "dryrun" else tree_kernel.library
        so = lib.library_path()
        check(os.path.exists(so), f"the kernel library {so} was not built")
        lib.load()
    initialize(init_method, world, rank, backend=backend,
               timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_SECONDS))
    try:
        # the group carries a collective on the device (NCCL's is checked
        # here: a mesh of one rank makes none of its own)
        probe = torch.full((1,), rank + 1.0, device=dev)
        dist.all_reduce(probe)
        check(probe.item() == world * (world + 1) / 2,
              f"all_reduce over {backend} gave {probe.item()}")
        if case == "dryrun":
            torch.save(mesh_dryrun(dev, chains, K, draws), out_path)
            return 0
        gauss = correlated_gaussian(K, dtype=torch.float32, device=dev,
                                    tree_kernel=True)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        if case == "one_rank":
            mesh = global_chain_mesh(dev)
            res, seconds, counts = timed(lambda: run_chains(
                gen, gauss, chains * world, draws, mesh=mesh,
                **main_path_config()))
        else:
            res, seconds, counts = timed(lambda: run_chains_multihost(
                gen, gauss, chains, draws, device=dev, **main_path_config()))
        out = {"rank": rank, "wall_s": seconds, "counts": counts,
               "backend": dist.get_backend(), "world": dist.get_world_size(),
               "positions_sha": sha256(res.positions),
               "eps_sha": sha256(res.eps), "m_inv_sha": sha256(res.metric.m_inv),
               "shape": list(res.positions.shape),
               "finite": bool(torch.isfinite(res.positions).all())}
        if case == "two_ranks":
            stats = res.tree_statistics
            out.update(positions=res.positions.cpu(), steps=stats.steps.cpu(),
                       is_divergent=stats.is_divergent.cpu())
            del res
            pooled = run_chains_multihost(
                gen, gauss, MESH_POOLED_EPS_CHAINS, 64, device=dev,
                **pooled_eps_config())
            out.update(pooled_eps=float(pooled.eps),
                       pooled_eps_sha=sha256(pooled.eps),
                       pooled_m_inv_sha=sha256(pooled.metric.m_inv),
                       pooled_finite=bool(torch.isfinite(
                           pooled.positions).all()))
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_dryrun(dev, chains, K, draws):
    """Passes 4-6 of the JAX package's dryrun_multichip on this rank,
    float32, ``chains`` a rank of mvnormal(0, I_K, fused=True): (4)
    per-chain eps, stratified over the mesh, warmup clamp 3; (5) the
    wavefront warmup with a pooled stepsize; (6) epoch sampling. The dry
    run's pooled stages with a diagonal metric where it has a dense one,
    since K2 takes a diagonal M^-1 only (a dense one runs the plain leaf).
    Each pass's launch counts, draws' finiteness and shape, and eps (and
    its SHA-256)."""
    import torch.distributed as dist

    from dynamichmc_tpu_torch import run_chains
    from dynamichmc_tpu_torch.models import mvnormal
    from dynamichmc_tpu_torch.parallel import global_chain_mesh
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    mesh = global_chain_mesh(dev)
    model = mvnormal(np.zeros(K), np.eye(K), dtype=torch.float32, device=dev,
                     fused=True)

    def stages(pooled_stepsize=False):
        return default_warmup_stages(
            metric_kind="diagonal", init_steps=20, middle_steps=20,
            doubling_stages=1, terminating_steps=20, pooled=True,
            pooled_stepsize=pooled_stepsize)

    passes = {
        "pass4": (stages(), dict(stratify_sampling=mesh.size,
                                 warmup_depth_clamp=3)),
        "pass5": (stages(True), dict(warmup_driver="wavefront")),
        "pass6": (stages(), dict(sampling_driver="epoch"))}
    out = {"rank": mesh.rank, "backend": dist.get_backend(),
           "world": dist.get_world_size()}
    for i, (name, (st, kw)) in enumerate(passes.items()):
        gen = torch.Generator(device=dev).manual_seed(10 * (i + 3) + mesh.rank)
        res, seconds, counts = timed(lambda: run_chains(
            gen, model, chains * mesh.size, draws, warmup_stages=st,
            dtype=torch.float32, mesh=mesh, tune="reference", **kw))
        out[name] = {"wall_s": seconds, "counts": counts,
                     "shape": list(res.positions.shape),
                     "finite": bool(torch.isfinite(res.positions).all()),
                     "eps_shape": list(res.eps.shape),
                     "eps": res.eps.cpu(), "eps_sha": sha256(res.eps),
                     "m_inv_sha": sha256(res.metric.m_inv),
                     "positions_sha": sha256(res.positions)}
    return out


def mesh_spawn(case, world, backend, dev, chains, K, draws, tmp):
    """Start ``world`` ranks of ``case`` (:func:`mesh_worker`) on ``dev``,
    a ``file://`` rendezvous in ``tmp``; wait at most MESH_SPAWN_SECONDS,
    then kill every rank still running. Returns each rank's saved result;
    a rank that failed or hung fails the phase with every rank's log."""
    store = os.path.join(tmp, f"{case}.store")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    logs = [os.path.join(tmp, f"{case}_rank{r}.log") for r in range(world)]
    outs = [os.path.join(tmp, f"{case}_rank{r}.pt") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--mesh-worker",
                     case, str(r), str(world), f"file://{store}", backend,
                     str(dev), str(chains), str(K), str(draws), outs[r]],
                    stdout=f, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + MESH_SPAWN_SECONDS
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    codes = [p.returncode for p in procs]
    if hung or any(codes):
        tails = []
        for r, path in enumerate(logs):
            with open(path) as f:
                tails.append(f"--- rank {r}:\n{f.read()[-4000:]}")
        check(False, f"phase 7 {case}: ranks {hung} hung (killed after "
                     f"{MESH_SPAWN_SECONDS} s), exit codes {codes}\n"
                     + "\n".join(tails))
    return [torch.load(path) for path in outs]


def run_mesh_phase(dev, smi, main, K=K_MAIN, C=C_MAIN, n_draws=N_DRAWS):
    """Phase 7: main's configuration over a mesh of ranks on the one card.
    (a) one rank on an NCCL group, run_chains on global_chain_mesh with
    main's generator: main's draws, eps and M^-1 bit for bit (SHA-256 set
    against phase 4's main run), K1's warp variant on every transition;
    (b) two ranks sharing the card over gloo, run_chains_multihost with C/2
    chains each: the pooled metric bitwise the same on both ranks, each
    rank's every transition through the warp variant, finite draws, main's
    moment gate and split R-hat <= 1.01 over the gathered C chains; then a
    pooled-eps run (MESH_POOLED_EPS_CHAINS a rank), its eps and metric
    bitwise the same on both ranks. Prints each part's line; a failed or
    hung rank fails the phase. No multi-GPU run: two ranks on one card
    share its SMs, so their wall says nothing of scaling."""
    import tempfile
    from types import SimpleNamespace

    from dynamichmc_tpu_torch.stats_device import ess_rhat_device

    t0 = time.perf_counter()
    expected = expected_transitions(n_draws)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        (one,) = mesh_spawn("one_rank", 1, MESH_1RANK_BACKEND, dev, C, K,
                            n_draws, tmp)
        check(one["backend"] == MESH_1RANK_BACKEND and one["world"] == 1,
              f"one_rank: backend {one['backend']}, world {one['world']}")
        counts = one["counts"]
        check(counts["tree_transition"] == counts["tree_transition_warp"]
              == expected, f"one_rank: {counts['tree_transition']} launches "
              f"({counts['tree_transition_warp']} warp) for {expected} "
              "transitions")
        bitwise = (one["positions_sha"], one["eps_sha"], one["m_inv_sha"]) \
            == (main["positions_sha"], main["eps_sha"], main["m_inv_sha"])
        check(bitwise, "one_rank: draws, eps or M^-1 differ from main's")
        log(f"[7 mesh] {json.dumps({'part': 'one_rank', 'backend': one['backend'], 'bitwise_main': bitwise, 'launch_counts': counts, 'wall_s': one['wall_s'], 'main_wall_s': main['wall_s'], 'gpu': smi})}")

        two = mesh_spawn("two_ranks", 2, "gloo", dev, C // 2, K, n_draws, tmp)
    for r, out in enumerate(two):
        counts = out["counts"]
        check(out["backend"] == "gloo" and out["world"] == 2,
              f"two_ranks: rank {r} on {out['backend']}, world {out['world']}")
        check(out["shape"] == [C // 2, n_draws, K],
              f"two_ranks: rank {r} positions shape {out['shape']}")
        check(out["finite"] and out["pooled_finite"],
              f"two_ranks: rank {r} has non-finite draws")
        check(counts["tree_transition"] == counts["tree_transition_warp"]
              == expected, f"two_ranks: rank {r} launched "
              f"{counts['tree_transition']} ({counts['tree_transition_warp']}"
              f" warp) for {expected} transitions")
    check(two[0]["m_inv_sha"] == two[1]["m_inv_sha"],
          "two_ranks: the pooled metric differs between the ranks")
    check(two[0]["positions_sha"] != two[1]["positions_sha"],
          "two_ranks: both ranks ran the same chains")
    check((two[0]["pooled_eps_sha"], two[0]["pooled_m_inv_sha"])
          == (two[1]["pooled_eps_sha"], two[1]["pooled_m_inv_sha"]),
          "two_ranks: the pooled eps or metric differs between the ranks")
    gathered = SimpleNamespace(
        positions=torch.cat([out["positions"] for out in two]).to(dev),
        tree_statistics=SimpleNamespace(
            steps=torch.cat([out["steps"] for out in two]).to(dev),
            is_divergent=torch.cat([out["is_divergent"] for out in two]).to(dev)))
    del two[0]["positions"], two[1]["positions"]
    gauss = main["model"]
    seconds = max(out["wall_s"] for out in two)
    metrics = check_draws(gauss, gathered, seconds)
    rhat = float(ess_rhat_device(gathered.positions)["rhat"].max())
    check(rhat <= 1.01, f"two_ranks: split R-hat up to {rhat:.4f}")
    metrics.update({
        "part": "two_ranks", "backend": "gloo", "chains_per_rank": C // 2,
        "wall_s_per_rank": [out["wall_s"] for out in two],
        "launch_counts_per_rank": [out["counts"] for out in two],
        "metric_bitwise_across_ranks": True, "max_rhat": rhat,
        "main_min_bulk_ess": main["min_bulk_ess"],
        "main_wall_s": main["wall_s"],
        "pooled_eps_run": {"chains_per_rank": MESH_POOLED_EPS_CHAINS,
                           "eps": two[0]["pooled_eps"],
                           "eps_and_metric_bitwise_across_ranks": True},
        "gpu": smi})
    log(f"[7 mesh] {json.dumps(metrics)}")
    run_mesh_dryrun(dev, smi)
    log(f"[time] phase 7 took {time.perf_counter() - t0:.1f} s")


DRYRUN_CHAINS, DRYRUN_K, DRYRUN_DRAWS = 4, 4, 8  # a rank's, as the dry run


def run_mesh_dryrun(dev, smi):
    """Phase 7, passes 4-6 of the JAX package's dryrun_multichip on two
    gloo ranks sharing the card (:func:`mesh_dryrun`): each pass's draws
    finite, of the rank's shape, K2 on every driver leaf of each pass;
    pass 4's eps per chain, pass 5's one eps bitwise the same on both
    ranks, pass 6's draws other on each rank."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        outs = mesh_spawn("dryrun", 2, "gloo", dev, DRYRUN_CHAINS, DRYRUN_K,
                          DRYRUN_DRAWS, tmp)
    line = {"part": "dryrun_passes_4_6", "backend": "gloo",
            "chains_per_rank": DRYRUN_CHAINS, "dim": DRYRUN_K,
            "draws": DRYRUN_DRAWS, "gpu": smi}
    for name in ("pass4", "pass5", "pass6"):
        for r, out in enumerate(outs):
            p = out[name]
            counts = p["counts"]
            check(p["finite"] and p["shape"] == [DRYRUN_CHAINS, DRYRUN_DRAWS,
                                                 DRYRUN_K],
                  f"dryrun {name}: rank {r} draws {p['shape']}, finite "
                  f"{p['finite']}")
            check(counts["gaussian_fused_leaf"] == counts["driver_fused_leaves"]
                  > 0 and counts["tree_transition"] == 0,
                  f"dryrun {name}: rank {r} launch counts {counts}")
        line[name] = {"wall_s_per_rank": [o[name]["wall_s"] for o in outs],
                      "launch_counts_per_rank": [o[name]["counts"]
                                                 for o in outs],
                      "eps_shape": outs[0][name]["eps_shape"]}
    check(outs[0]["pass4"]["eps_shape"] == [DRYRUN_CHAINS],
          "dryrun pass4: eps is not per chain")
    check(outs[0]["pass5"]["eps_shape"] == [] and outs[0]["pass5"]["eps_sha"]
          == outs[1]["pass5"]["eps_sha"], "dryrun pass5: the pooled eps "
          "differs between the ranks")
    check(outs[0]["pass6"]["positions_sha"] != outs[1]["pass6"]["positions_sha"],
          "dryrun pass6: both ranks drew the same chains")
    line["pass5"]["eps"] = float(outs[0]["pass5"]["eps"])
    line["pass5"]["eps_bitwise_across_ranks"] = True
    log(f"[7 mesh] {json.dumps(line)}")



# --- phase 8: the schedulers ------------------------------------------------

STRATIFY_G = 4  # stratify_sampling of the stratified paths
N_WAVEFRONT_LOGREG = 64  # wavefront_logreg's draws, cut from 512


class Stamps(list):
    """A ``log`` that keeps each message with its host time."""

    def __call__(self, msg):
        self.append((time.perf_counter(), msg))

    def warmup_end(self):
        """The host time of the last warmup stage's message."""
        return max(t for t, msg in self if msg.startswith("warmup stage"))


def sync_twin_metrics(res, seconds, counts, stamps):
    """A lockstep run's warmup: its leaf slots (the driver's fused leaves
    less the draws' lockstep slots), its wall to the last stage's message,
    and the host ms per warmup slot; the draws' slots and wall."""
    sampling_slots = int(res.tree_statistics.work[0].sum())
    warmup_slots = counts["driver_fused_leaves"] - sampling_slots
    warmup_s = stamps.warmup_end() - TIMES["t0"]
    return {"warmup_slots": warmup_slots, "warmup_wall_s": warmup_s,
            "host_ms_per_warmup_slot": 1e3 * warmup_s / max(warmup_slots, 1),
            "sampling_slots": sampling_slots,
            "sampling_wall_s": seconds - warmup_s}


def grouped_lockstep_waste(stats, eps, groups):
    """The lockstep meaning of straggler_waste for chains that each run
    their own leaves (the tree kernel): 1 - the leapfrog steps over the
    slots a lockstep driver would take, each draw of each of ``groups``
    eps-sorted groups costing its deepest chain's leaves."""
    order = torch.argsort(eps, stable=True).reshape(groups, -1)
    work = stats.work.double()
    slots = sum(work[idx].max(dim=0).values.sum() * idx.numel()
                for idx in order)
    return float(1 - stats.steps.double().sum() / slots)


def max_rhat(positions):
    from dynamichmc_tpu_torch.stats_device import ess_rhat_device

    return float(ess_rhat_device(positions)["rhat"].max())


def run_scheduler_phase(dev, smi, twins, normal, gauss, lr_fused):
    """Phase 8: the wavefront warmup, epoch sampling and stratified
    sampling at full width, each beside its lockstep twin of phase 4 (in
    the line as ``twin``). Returns each kernel's launches over the phase,
    for the kernels line. Fails on a gate."""
    from dynamichmc_tpu_torch import tree_wavefront, tree_wavefront_epoch

    t_phase = time.perf_counter()
    fused_tw, logreg_tw, main = (twins["gauss_fused"], twins["logreg_fused"],
                                 twins["main"])
    twin_keys = ("wall_s", "min_bulk_ess", "min_bulk_ess_per_s",
                 "mean_bulk_ess_per_s", "grad_evals_per_s", "warmup_slots",
                 "warmup_wall_s", "host_ms_per_warmup_slot", "sampling_slots",
                 "sampling_wall_s", "straggler_waste", "divergences")
    sched = {"gaussian_fused_leaf": 0, "logreg_fused_leaf": 0,
             "tree_transition": 0}

    def run(name, model, C, n_draws, config, **options):
        tree_wavefront.reset_slots_run()
        tree_wavefront_epoch.reset_slots_run()
        stamps = Stamps()
        res, seconds, counts = run_path(model, C, n_draws, SEED, config, dev,
                                        log=stamps, **options)
        check(tuple(res.positions.shape) == (C, n_draws, model.dim),
              f"{name}: positions shape {tuple(res.positions.shape)}")
        for key in sched:
            sched[key] += counts[key]
        return res, seconds, counts, stamps

    def fused_only(name, counts, own):
        others = [k for k in ("gaussian_fused_leaf", "logreg_fused_leaf",
                              "tree_transition", "gaussian_leapfrog")
                  if k != own]
        check(counts[own] == counts["driver_fused_leaves"] > 0
              and all(counts[k] == 0 for k in others),
              f"{name}: {own} launched {counts[own]} times for "
              f"{counts['driver_fused_leaves']} driver leaves; {counts}")

    def emit(name, res, seconds, counts, twin, extra, waste_reads):
        metrics, ess = path_metrics(res, seconds)
        metrics.update(path_diagnostics(res.tree_statistics, waste_reads))
        metrics.update(extra)
        metrics.update({
            "path": name, "launch_counts": counts, "chains": res.eps.numel(),
            "draws": res.positions.shape[1], "dim": res.positions.shape[2],
            "adapted_eps_range": [float(res.eps.min()), float(res.eps.max())],
            "twin": {k: twin[k] for k in twin_keys if k in twin},
            "gpu": smi})
        log(f"[8 scheduler] {json.dumps(metrics)}")
        return metrics, ess

    def standard_normal_gate(name, res):
        out = check_standard_normal(
            res.positions.double().reshape(-1, K_GAUSS), 0.05, (0.9, 1.1))
        rhat = max_rhat(res.positions)
        check(rhat <= 1.01, f"{name}: split R-hat up to {rhat:.4f}")
        out["max_rhat"] = rhat
        return out

    def wavefront_extra(res, counts, stamps, twin):
        slots, steps = tree_wavefront.slots_run, tree_wavefront.lane_steps
        sampling = int(res.tree_statistics.work[0].sum())
        check(slots > 0 and counts["driver_fused_leaves"] == slots + sampling,
              f"wavefront: {counts['driver_fused_leaves']} driver leaves for "
              f"{slots} warmup slots and {sampling} draw slots")
        warmup_s = stamps.warmup_end() - TIMES["t0"]
        C = res.eps.numel()
        return {"warmup_slots": slots, "sampling_slots": sampling,
                "warmup_wall_s": warmup_s,
                "host_ms_per_warmup_slot": 1e3 * warmup_s / slots,
                "warmup_slot_fill": steps / (slots * C),
                "sampling_slot_fill": float(
                    res.tree_statistics.steps.sum()) / (sampling * C),
                "warmup_slots_vs_twin": slots / twin["warmup_slots"]}

    # wavefront_gauss: gauss_fused's configuration, the wavefront warmup
    res, seconds, counts, stamps = run(
        "wavefront_gauss", normal, C_GAUSS, N_DRAWS,
        {"tune": "reference", "warmup_driver": "wavefront"})
    fused_only("wavefront_gauss", counts, "gaussian_fused_leaf")
    extra = wavefront_extra(res, counts, stamps, fused_tw)
    extra.update(standard_normal_gate("wavefront_gauss", res))
    emit("wavefront_gauss", res, seconds, counts, fused_tw, extra,
         "lockstep work (plain driver) over the draws")
    del res

    # epoch_gauss and stratified_gauss: from gauss_fused's final warmup
    # checkpoint (its warmup, bit for bit), then the other samplers
    for name, option in (("epoch_gauss", {"sampling_driver": "epoch"}),
                         ("stratified_gauss",
                          {"stratify_sampling": STRATIFY_G})):
        res, seconds, counts, _stamps = run(
            name, normal, C_GAUSS, N_DRAWS, {"tune": "reference", **option},
            warmup_resume=fused_tw["checkpoint"])
        fused_only(name, counts, "gaussian_fused_leaf")
        check(sha256(res.eps) == fused_tw["eps_sha"]
              and sha256(res.metric.m_inv) == fused_tw["m_inv_sha"],
              f"{name}: eps or M^-1 differ from gauss_fused's")
        extra = standard_normal_gate(name, res)
        if name == "epoch_gauss":
            slots = tree_wavefront_epoch.slots_run
            check(counts["driver_fused_leaves"] == slots,
                  f"epoch_gauss: {counts['driver_fused_leaves']} leaves for "
                  f"{slots} slots")
            lanes = C_GAUSS
            reads = ("per-lane work (epoch driver: a draw's slots from its "
                     "restart to its completion, waits included)")
        else:
            slots, lanes = counts["driver_fused_leaves"], C_GAUSS // STRATIFY_G
            reads = "lockstep work (plain driver) of each chain's group"
        extra.update(
            sampling_slots=slots, resumed_from_step=int(
                fused_tw["checkpoint"].step),
            eps_and_metric_bitwise_twin=True,
            sampling_slot_fill=float(res.tree_statistics.steps.sum())
            / (slots * lanes))
        metrics, _ess = emit(name, res, seconds, counts, fused_tw, extra,
                             reads)
        ratio = metrics["min_bulk_ess"] / fused_tw["min_bulk_ess"]
        check(abs(ratio - 1) <= 0.10, f"{name}: min bulk ESS "
              f"{metrics['min_bulk_ess']:.2f} is {ratio:.4f} of "
              "gauss_fused's")
        del res

    # stratified_main: main's configuration, stratified
    res, seconds, counts, _stamps = run(
        "stratified_main", gauss, C_MAIN, N_DRAWS,
        dict(main_path_config(), stratify_sampling=STRATIFY_G))
    want = expected_transitions(N_DRAWS) - N_DRAWS + STRATIFY_G * N_DRAWS
    check(counts["tree_transition"] == counts["tree_transition_warp"] == want
          and counts["gaussian_fused_leaf"] == counts["logreg_fused_leaf"]
          == 0, f"stratified_main: {counts} for {want} group transitions")
    check(sha256(res.eps) == main["eps_sha"]
          and sha256(res.metric.m_inv) == main["m_inv_sha"],
          "stratified_main: eps or M^-1 differ from main's")
    metrics = check_draws(gauss, res, seconds)
    metrics.update(path_diagnostics(res.tree_statistics,
                                    "per-chain work (tree kernel)"))
    metrics.update({"path": "stratified_main", "launch_counts": counts,
                    "expected_launches": want, "groups": STRATIFY_G,
                    "lockstep_waste_groups": grouped_lockstep_waste(
                        res.tree_statistics, res.eps, STRATIFY_G),
                    "lockstep_waste_one_group": grouped_lockstep_waste(
                        res.tree_statistics, res.eps, 1),
                    "eps_and_metric_bitwise_main": True,
                    "twin": {"wall_s": main["wall_s"],
                             "min_bulk_ess": main["min_bulk_ess"]},
                    "gpu": smi})
    log(f"[8 scheduler] {json.dumps(metrics)}")
    del res

    # wavefront_logreg: logreg_fused's configuration, the wavefront warmup
    config = dict(path_config("diagonal", MD_LOGREG), warmup_driver="wavefront")
    res, seconds, counts, stamps = run("wavefront_logreg", lr_fused, C_LOGREG,
                                       N_WAVEFRONT_LOGREG, config)
    fused_only("wavefront_logreg", counts, "logreg_fused_leaf")
    extra = wavefront_extra(res, counts, stamps, logreg_tw)
    _m, ess = path_metrics(res, seconds)
    z = check_logreg_agreement(twins["logreg_tree_summary"],
                               posterior_summary(res, ess))
    extra.update(max_dmean_over_mcse_vs_logreg_tree=z,
                 cut=f"{N_WAVEFRONT_LOGREG} draws, not {N_DRAWS}")
    emit("wavefront_logreg", res, seconds, counts, logreg_tw, extra,
         "lockstep work (plain driver) over the draws")
    del res
    log(f"[time] phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return {"tree_transition": sched["tree_transition"],
            "logreg_fused_leaf": sched["logreg_fused_leaf"],
            "gaussian_fused_leaf": sched["gaussian_fused_leaf"]}


N_THROUGHPUT = 1024  # chains of phase 9's transition_throughput
N_ESS_PARAMS = 8  # main's coordinates whose draws phase 9's ESS engines read
TRACE_SPAWN_SECONDS = 240  # phase 9's trace worker, killed after it


def read_trace(log_dir):
    """The one Chrome trace in ``log_dir``: the names of the tree kernels
    it recorded on the card, its events and its kernel events."""
    files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    check(len(files) == 1, f"trace: {len(files)} files in {log_dir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"names": sorted({e["name"] for e in kernels
                             if "tree_transition" in e.get("name", "")}),
            "events": len(events), "kernel_events": len(kernels)}


def trace_probe_args(gauss, dev):
    """One main-shape K1 call's inputs, from a generator of their own (the
    phases' draws stay as they are), the kernel warmed on them."""
    from dynamichmc_tpu_torch.ops import tree_kernel

    gen = torch.Generator(device=dev).manual_seed(SEED)
    args = kernel_inputs(gauss, C_MAIN, MD_MAIN, "dense", MD_MAIN, gen)
    tree_kernel.tree_transition(*args)
    torch.cuda.synchronize()
    return args


def trace_probe(after_phase, args):
    """profiling.trace around one K1 call in this process: read_trace's
    result, or the error of a trace that recorded no kernel. Reported
    after phases 5-9 (after phase 5's profiler sessions), not gated:
    torch.profiler has recorded no kernel here after phases 4-8 (PERF.md
    §7), and the probes say from which phase on."""
    import tempfile

    from dynamichmc_tpu_torch import profiling
    from dynamichmc_tpu_torch.ops import tree_kernel

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            with profiling.trace(tmp) as log_dir:
                tree_kernel.tree_transition(*args)
            res = read_trace(log_dir)
        except RuntimeError as err:
            res = {"error": str(err)[:120]}
        res["seconds"] = time.perf_counter() - t0
    log(f"[trace probe] {json.dumps({'after_phase': after_phase, **res})}")
    return res


def trace_worker(argv):
    """``chip_smoke.py --trace-worker OUT``: in a process of its own,
    profiling.trace around one K1 call at main's shape, with the library
    phase 2 built; writes read_trace's result to OUT as JSON."""
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamichmc_tpu_torch import profiling
    from dynamichmc_tpu_torch.models import correlated_gaussian
    from dynamichmc_tpu_torch.ops import tree_kernel

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    so = tree_kernel.library.library_path()
    check(os.path.exists(so), f"the kernel library {so} was not built")
    gauss = correlated_gaussian(K_MAIN, dtype=torch.float32, device=dev,
                                tree_kernel=True)
    args = trace_probe_args(gauss, dev)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as log_dir:
            tree_kernel.tree_transition(*args)
        result = read_trace(log_dir)
    with open(argv[0], "w") as f:
        json.dump(result, f)
    return 0


def auto_route(n_obs, dim):
    """The route logistic_regression(fused="auto", tree_kernel="auto")
    takes by the port's measured rule: "k1", "k3" or "plain"."""
    from dynamichmc_tpu_torch.ops.logreg_leaf import fused_leaf_pays
    from dynamichmc_tpu_torch.ops.tree_kernel import tree_kernel_pays

    fused = fused_leaf_pays(n_obs, dim)
    if tree_kernel_pays(n_obs, dim, fused=fused):
        return "k1"
    return "k3" if fused else "plain"


def run_surface_phase(dev, smi, gauss, lr_tree, main_draws):
    """Phase 9: the rest of the package's surface on the card. Fails on a
    gate."""
    import tempfile

    from dynamichmc_tpu_torch import native, profiling, stats
    from dynamichmc_tpu_torch.hamiltonian import evaluate
    from dynamichmc_tpu_torch.metric import diagonal_metric
    from dynamichmc_tpu_torch.models import logistic_regression
    from dynamichmc_tpu_torch.nuts import NUTS
    from dynamichmc_tpu_torch.ops import (
        launch_counts, reset_launch_counts, tree_kernel)
    from dynamichmc_tpu_torch.tree_batched import sample_tree_batched

    # the auto rule at logreg_tree's shape: the route it names, and one
    # transition through that route's kernel
    t0 = time.perf_counter()
    route = auto_route(N_OBS, K_LOGREG)
    model = logistic_regression(N_OBS, K_LOGREG, dtype=torch.float32,
                                device=dev, fused="auto", tree_kernel="auto")
    attached = ("k1" if model.tree_transition_fn is not None else
                "k3" if model.fused_leaf_batched_fn is not None else "plain")
    check(attached == route, f"auto: the model attached {attached}, the rule "
                             f"names {route}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, minv = start_point(lr_tree, C_LOGREG, gen)
    Q = evaluate(model, q)
    torch.cuda.synchronize()
    reset_launch_counts()
    _q, st = sample_tree_batched(gen, NUTS(max_depth=MD_LOGREG), model,
                                 diagonal_metric(torch.diagonal(minv).contiguous()),
                                 Q, 0.2)
    torch.cuda.synchronize()
    counts = launch_counts()
    if route == "k1":
        check(counts["tree_transition"] == 1 and counts["logreg_fused_leaf"] == 0,
              f"auto k1: launches {counts}")
    elif route == "k3":
        check(counts["tree_transition"] == 0 and counts["logreg_fused_leaf"]
              == counts["driver_fused_leaves"] > 0, f"auto k3: launches {counts}")
    else:
        check(counts["tree_transition"] == counts["logreg_fused_leaf"] == 0,
              f"auto plain: launches {counts}")
    check(bool(torch.isfinite(_q.q).all()), "auto: non-finite positions")
    log(f"[9 surface] {json.dumps({'auto': [N_OBS, K_LOGREG], 'route': route, 'launch_counts': counts, 'mean_steps': float(st.steps.double().mean()), 'seconds': time.perf_counter() - t0, 'gpu': smi})}")

    # transition_throughput on main's model
    reset_launch_counts()
    res = profiling.transition_throughput(
        gauss, n_chains=N_THROUGHPUT, generator=torch.Generator(
            device=dev).manual_seed(SEED))
    counts = launch_counts()
    check(counts["tree_transition"] == 2 + 5 and res["grad_evals_per_second"] > 0,
          f"transition_throughput: {counts}, {res}")
    log(f"[9 surface] {json.dumps({'transition_throughput': [N_THROUGHPUT, K_MAIN], **res, 'launch_counts': counts, 'gpu': smi})}")

    # a trace of one K1 call names the tree kernel: in this process after
    # phases 4-8 (reported), and in a fresh process (the gate)
    here = trace_probe(9, trace_probe_args(gauss, dev))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "fresh.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--trace-worker", out],
            capture_output=True, text=True, timeout=TRACE_SPAWN_SECONDS)
        check(proc.returncode == 0, f"trace worker failed:\n{proc.stdout[-3000:]}"
                                    f"\n{proc.stderr[-3000:]}")
        with open(out) as f:
            fresh = dict(json.load(f), seconds=time.perf_counter() - t0)
    log(f"[9 surface] {json.dumps({'trace': {'after_phases_4_8': here, 'fresh_process': fresh}, 'gpu': smi})}")
    check(fresh["names"], "trace: no tree kernel on the card")

    # the native ESS engine against numpy on main's draws
    t0 = time.perf_counter()
    check(native.load() is not None,
          f"native: fastdiag did not load: {native.build_log}")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = stats.ess_rhat(main_draws, use_native=True)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = stats.ess_rhat(main_draws, use_native=False)
    numpy_s = time.perf_counter() - t0
    worst = max(float(np.max(np.abs(fast[k] / slow[k] - 1))) for k in fast)
    check(worst <= 1e-7, f"native: {worst} from numpy")
    log(f"[9 surface] {json.dumps({'native_ess': list(main_draws.shape), 'build_and_load_s': build_s, 'native_s': native_s, 'numpy_s': numpy_s, 'max_rel_diff': worst, 'min_bulk_ess': float(fast['ess_bulk'].min()), 'gpu': smi})}")


def main():
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--trace-worker"]:
        return trace_worker(sys.argv[2:])
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


PATHS = ("main", "funnel", "logreg_tree", "logreg_xstaged", "logreg_fused",
         "logreg_hier_fused", "gauss_fused", "per_chain")


def profiled_paths(argv):
    """The paths --profile names (all eight for a bare --profile)."""
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
        correlated_gaussian, funnel, hierarchical_logistic_regression_from_data,
        logistic_regression, mvnormal)
    from dynamichmc_tpu_torch.ops import (
        gaussian_leaf, gaussian_leapfrog, logreg_leaf, tree_kernel)

    # --- phase 3: every kernel against its plain version -----------------
    gauss = correlated_gaussian(K_MAIN, dtype=torch.float32, device=dev,
                                tree_kernel=True)
    fun = funnel(K_FUNNEL, dtype=torch.float32, device=dev, tree_kernel=True)
    lr_staged = logistic_regression(N_XSTAGED, K_XSTAGED, dtype=torch.float32,
                                    device=dev, tree_kernel=True)
    lr_tree = logistic_regression(N_OBS, K_LOGREG, dtype=torch.float32,
                                  device=dev, tree_kernel=True)
    lr_fused = logistic_regression(N_OBS, K_LOGREG, dtype=torch.float32,
                                   device=dev, fused=True)
    lr_wide = logistic_regression(N_OBS, K_WIDE, dtype=torch.float32,
                                  device=dev, fused=True)
    lr_chunked = [logistic_regression(N_OBS, k, dtype=torch.float32,
                                      device=dev, fused=True) for k in K_CHUNKED]
    lr_hier = hierarchical_logistic_regression_from_data(
        *hier_data(), rate=0.01, dtype=torch.float32, device=dev, fused=True)
    # BASELINE config 1: N(0, I_25) through the Gaussian model with hooks
    normal = mvnormal(np.zeros(K_GAUSS), np.eye(K_GAUSS), dtype=torch.float32,
                      device=dev, fused=True)
    gauss100 = correlated_gaussian(K_MAIN, dtype=torch.float32, device=dev,
                                   fused=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    phase3 = {"gaussian": [], "gaussian_cta": [], "funnel": [],
              "funnel_cta": [], "logreg_tree": [], "logreg_xstaged": [],
              "logreg_fused": [], "logreg_fused_hier": [],
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
    # from a generator of their own, so that no later configuration's
    # inputs depend on them
    gen_xs = torch.Generator(device=dev).manual_seed(SEED + 2)
    for kind in ("diag", "dense"):
        phase3_result("logreg_xstaged", compare_kernel_plain(
            "logreg", lr_staged, C_XSTAGED, MD_LOGREG, kind, MD_LOGREG, gen_xs,
            "xstaged"))
    for model in (lr_fused, lr_wide):
        for kind in ("shared_diag", "chain_diag", "shared_dense"):
            phase3_result("logreg_fused",
                          compare_fused_leaf(model, C_LOGREG, kind, gen))
    # the chunked slice kernel, from a generator of its own
    check(logreg_leaf.tiled(K_WIDE)
          and not any(logreg_leaf.tiled(k) for k in K_CHUNKED)
          and len({logreg_leaf.tile_rows(k) for k in K_CHUNKED}) == 2,
          f"K = {K_WIDE} must take the tiled slice kernel, K = {K_CHUNKED} "
          f"the chunked one with two tile heights")
    gen_chunked = torch.Generator(device=dev).manual_seed(SEED + 4)
    for model in lr_chunked:
        for kind in ("shared_diag", "chain_diag", "shared_dense"):
            phase3_result("logreg_fused", compare_fused_leaf(
                model, C_LOGREG, kind, gen_chunked))
    # from a generator of its own, as logreg_xstaged's
    gen_hier = torch.Generator(device=dev).manual_seed(SEED + 3)
    for kind in ("shared_diag", "chain_diag", "shared_dense"):
        phase3_result("logreg_fused_hier",
                      compare_fused_leaf(lr_hier, C_HIER, kind, gen_hier))
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
        # the benchmark's logreg_1000x25.fleet16k shape, through K1's
        # staged-X variant
        "logreg_xstaged": (lr_staged, C_XSTAGED,
                           path_config("diagonal", MD_LOGREG)),
        "logreg_fused": (lr_fused, C_LOGREG, path_config("diagonal", MD_LOGREG)),
        # the benchmark's logreg_hier_1000x302 through the plain driver and
        # the fused leaf's hierarchical mode, at a quarter of its chains
        "logreg_hier_fused": (lr_hier, C_HIER_PATH,
                              path_config("diagonal", MD_LOGREG)),
        # BASELINE config 1 under the fleet: the reference-default warmup
        "gauss_fused": (normal, C_GAUSS, {"tune": "reference"}),
    }
    launches, summaries, twins = {}, {}, {}
    for name, (model, C, config) in paths.items():
        # the schedulers' sync twins (phase 8) log the warmup's end, and
        # gauss_fused keeps its final warmup checkpoint for phase 8 to
        # resume from; neither changes a draw
        options = {}
        if name in ("gauss_fused", "logreg_fused"):
            stamps, ckpts = Stamps(), []
            options = dict(log=stamps, warmup_checkpoint_sink=ckpts.append)
        res, seconds, counts = run_path(model, C, N_DRAWS, SEED, config, dev,
                                        **options)
        check(tuple(res.positions.shape) == (C, N_DRAWS, model.dim),
              f"{name}: positions shape {tuple(res.positions.shape)}")
        check(counts["gaussian_leapfrog"] == 0,
              f"{name}: the fused Gaussian leapfrog launched")
        if name in ("logreg_fused", "logreg_hier_fused", "gauss_fused"):
            own = "gaussian_fused_leaf" if name == "gauss_fused" else "logreg_fused_leaf"
            other = "logreg_fused_leaf" if name == "gauss_fused" else "gaussian_fused_leaf"
            check(counts["tree_transition"] == 0,
                  f"{name}: the tree kernel launched")
            check(counts[other] == 0, f"{name}: {other} launched")
            check(counts[own] == counts["driver_fused_leaves"] > 0,
                  f"{name}: {own} launched {counts[own]} times for "
                  f"{counts['driver_fused_leaves']} driver leaves")
            # the hierarchical mode on every leaf of its path, on no other
            want_hier = counts[own] if name == "logreg_hier_fused" else 0
            check(counts["logreg_fused_leaf_hier"] == want_hier,
                  f"{name}: the hierarchical mode launched "
                  f"{counts['logreg_fused_leaf_hier']} times, expected "
                  f"{want_hier}")
            # the tiled slice kernel wherever the plan gives K to it
            want_tiled = (counts[own] if name != "gauss_fused"
                          and logreg_leaf.tiled(model.dim) else 0)
            check(counts["logreg_fused_leaf_tiled"] == want_tiled,
                  f"{name}: the tiled slice kernel launched "
                  f"{counts['logreg_fused_leaf_tiled']} times, expected "
                  f"{want_tiled}")
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
        # and the staged-X variant every launch of logreg_xstaged alone
        want_xs = counts["tree_transition"] if name == "logreg_xstaged" else 0
        check(counts["tree_transition_xstaged"] == want_xs,
              f"{name}: the staged-X variant launched "
              f"{counts['tree_transition_xstaged']} times, expected {want_xs}")
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
        elif name == "logreg_hier_fused":
            # t = log sigma^2's draws, reported: the benchmark's cell holds
            # the moments to its reference
            metrics, _ess = path_metrics(res, seconds)
            t = res.positions[:, :, -1].double()
            metrics.update({"mean_t": float(t.mean()),
                            "sd_t": float(t.std(correction=0)),
                            "min_bulk_ess_t": float(_ess[-1])})
        else:
            metrics, ess = path_metrics(res, seconds)
            summaries[name] = posterior_summary(res, ess)
        metrics.update(path_diagnostics(
            res.tree_statistics, "per-chain work (tree kernel)"
            if counts["tree_transition"] else "lockstep work (plain driver)"))
        metrics.update({"path": name, "launch_counts": counts, "chains": C,
                        "draws": N_DRAWS, "dim": model.dim,
                        "device_memory": dict(MEMORY),
                        "adapted_eps_range": [float(res.eps.min()),
                                              float(res.eps.max())],
                        "gpu": smi})
        if options:
            metrics.update(sync_twin_metrics(res, seconds, counts, stamps))
            twins[name] = dict(metrics, checkpoint=ckpts[-1],
                               eps_sha=sha256(res.eps),
                               m_inv_sha=sha256(res.metric.m_inv),
                               summary=summaries.get(name))
            del ckpts
        log(f"[4 path] {json.dumps(metrics)}")
        if name == "gauss_fused":  # the batched stepwise path starts here
            fused_state = (res.metric, res.eps, res.positions[:, -1].clone())
        if name == "main":  # what the streamed, resumed and ess runs equal
            main = {"positions": res.positions.cpu(), "eps": res.eps.clone(),
                    "positions_sha": sha256(res.positions),
                    "eps_sha": sha256(res.eps),
                    "m_inv_sha": sha256(res.metric.m_inv), "model": model,
                    "m_inv": res.metric.m_inv.clone(),
                    "logdensities": res.logdensities.cpu(),
                    "memory": dict(MEMORY), "wall_s": seconds,
                    "min_bulk_ess": metrics["min_bulk_ess"]}
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
    # the per-chain driver records no work: no straggler_waste
    metrics.update(path_diagnostics(stacked_statistics(results)))
    metrics.update({"path": "per_chain", "launch_counts": counts,
                    "chains": len(results), "draws": N_PER_CHAIN,
                    "dim": K_GAUSS, "gpu": smi})
    log(f"[4 path] {json.dumps(metrics)}")
    run_slice13_paths(normal, gauss, fused_state, results, dev, smi)
    del results, fused_state
    run_slice14_paths(gauss, main, dev, smi)
    run_slice15_paths(gauss, fun, normal, main, dev, smi)
    mesh_ref = {k: main[k] for k in ("positions_sha", "eps_sha", "m_inv_sha",
                                      "model", "wall_s", "min_bulk_ess")}
    twins["main"] = mesh_ref
    twins["logreg_tree_summary"] = summaries["logreg_tree"]
    main_draws = main["positions"][:, :, :N_ESS_PARAMS].double().numpy()
    del main
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
    args = kernel_inputs(lr_staged, C_XSTAGED, MD_LOGREG, "diag", MD_LOGREG,
                         gen_xs)
    times["logreg_xstaged"] = (
        time_call(tree_kernel.tree_transition, args, 20),
        time_call(tree_kernel.tree_transition_plain, args, 3))
    bounds["logreg_xstaged"] = tree_kernel_bound(args)
    args = fused_leaf_inputs(lr_fused, C_LOGREG, "shared_diag", gen)
    times["logreg_fused"] = (time_call(logreg_leaf.logreg_leaf, args, 50),
                             time_call(logreg_leaf.logreg_leaf_plain, args, 50))
    bounds["logreg_fused"] = logreg_leaf_bound(args)
    args = hier_leaf_inputs(lr_hier, C_HIER, "shared_diag", gen_hier)
    times["logreg_fused_hier"] = (
        time_call(logreg_leaf.logreg_leaf_hier, args, 20),
        time_call(logreg_leaf.logreg_leaf_hier_plain, args, 20))
    bounds["logreg_fused_hier"] = logreg_leaf_bound(args)
    plans = {}
    for key, (C, K, n) in (("logreg_fused", (C_LOGREG, K_LOGREG, N_OBS)),
                           ("logreg_fused_hier", (C_HIER, lr_hier.dim, N_HIER))):
        info = logreg_leaf.kernel_info(dev, 0, K)
        plan = logreg_leaf.launch_plan(C, K, n, info.sm_count,
                                       info.blocks_per_sm)
        plans[key] = {
            "tiled": plan.tiled,
            "slices": plan.slices, "tiles_per_slice": plan.tiles_per_slice,
            "tile_rows": plan.tile, "chunks": plan.chunks,
            "registers": info.registers, "smem_bytes": info.smem,
            "ctas_per_sm": info.blocks_per_sm, "sms": info.sm_count}
    for name, shape in (("gaussian", (tree_kernel.GAUSSIAN, K_MAIN, MD_MAIN, False)),
                        ("funnel", (tree_kernel.FUNNEL, K_FUNNEL, MD_FUNNEL, True))):
        variant = tree_kernel.kernel_variant(*shape)
        both = variant_plans(dev, *shape)
        plans[name] = {"variant": variant, **both[variant]}
        if name == "funnel":
            plans[name]["cta_variant_plan"] = both["cta"]
    plans["logreg_xstaged"] = {"variant": "xstaged", **plan_dict(
        tree_kernel.xstaged_kernel_info(dev, K_XSTAGED, MD_LOGREG, N_XSTAGED,
                                        True))}
    shapes = {"gaussian": [C_MAIN, K_MAIN, MD_MAIN, "dense"],
              "funnel": [C_FUNNEL, K_FUNNEL, MD_FUNNEL, "diag"],
              "logreg_tree": [C_LOGREG, K_LOGREG, N_OBS, MD_LOGREG, "diag"],
              "logreg_xstaged": [C_XSTAGED, K_XSTAGED, N_XSTAGED, MD_LOGREG,
                                 "diag"],
              "logreg_fused": [C_LOGREG, K_LOGREG, N_OBS, "shared_diag"],
              "logreg_fused_hier": [C_HIER, lr_hier.dim, N_HIER, "shared_diag"]}
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
    probe_args = trace_probe_args(gauss, dev)
    trace_probe(5, probe_args)
    for name, (model, C, config) in paths.items():
        if name in profile:
            log(f"[profile] {json.dumps(profile_run(name, lambda: run_path(model, C, N_DRAWS, SEED, config, dev)))}")
    if "per_chain" in profile:
        log(f"[profile] {json.dumps(profile_run('per_chain', lambda: run_per_chain(normal, dev)))}")

    # --- phase 6: the reference's statistical protocol through K1 and K2 --
    run_protocol(dev, smi)
    log_phase_done(6)
    trace_probe(6, probe_args)

    # --- phase 7: main's configuration over a mesh of ranks ---------------
    run_mesh_phase(dev, smi, mesh_ref)
    log_phase_done(7)
    trace_probe(7, probe_args)

    # --- phase 8: the wavefront, epoch and stratified schedulers ---------
    sched_launches = run_scheduler_phase(dev, smi, twins, normal, gauss,
                                         lr_fused)
    log_phase_done(8)
    trace_probe(8, probe_args)

    # --- phase 9: the auto rule, profiling and the native ESS engine -----
    run_surface_phase(dev, smi, gauss, lr_tree, main_draws)
    log_phase_done(9)

    entries = [  # name, phase-3/5 key, path, replaces, source
        ("tree_transition", "gaussian", "main", "dynamichmc_tpu/ops/pallas_tree.py:93",
         "tree_kernel.cu"),
        ("tree_transition_funnel", "funnel", "funnel",
         "dynamichmc_tpu/ops/pallas_tree.py:707", "tree_kernel.cu"),
        ("tree_transition_logreg", "logreg_tree", "logreg_tree",
         "dynamichmc_tpu/ops/pallas_tree.py:762", "tree_kernel.cu"),
        ("tree_transition_logreg_xstaged", "logreg_xstaged", "logreg_xstaged",
         "dynamichmc_tpu/ops/pallas_tree.py:762", "tree_kernel.cu"),
        ("logreg_fused_leaf", "logreg_fused", "logreg_fused",
         "dynamichmc_tpu/ops/pallas_logreg.py:53", "logreg_leaf.cu"),
        # the same kernel's hierarchical mode, which the JAX leaf lacks
        ("logreg_fused_leaf_hier", "logreg_fused_hier", "logreg_hier_fused",
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
        "launches": launches[path] + sched_launches.get(name, 0),
        "max_abs_err": max_abs[key],
        "ms": times[key][0],
        "plain_ms": times[key][1],
        "bound_ms": bounds[key][0],
        "bound_by": bounds[key][1],
        "library_ms": None,  # no single PyTorch call computes a transition or leaf
    } for name, key, path, replaces, src in entries]}))


if __name__ == "__main__":
    sys.exit(main())
