"""GPU-only checks of the port's hand-written kernels.

They import torch and the port only, so they also run where JAX is absent:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``. Without a
CUDA device they skip (the kernels have no CPU mode; on the CPU the wrappers
take their plain versions, which the other test_torch_* files check against
the JAX package).
"""

import pytest
import torch

import numpy as np

from dynamichmc_tpu_torch.metric import (
    DiagonalMetric,
    dense_metric,
    diagonal_metric,
)
from dynamichmc_tpu_torch.models import (
    correlated_gaussian,
    funnel,
    hierarchical_logistic_regression_from_data,
    logistic_regression,
    mvnormal,
)
from dynamichmc_tpu_torch.ops import (
    gaussian_leaf,
    gaussian_leapfrog,
    logreg_leaf,
    tree_kernel,
)
from dynamichmc_tpu_torch.ops.proposal_leaf import proposal_offsets
from dynamichmc_tpu_torch.tree_batched import (
    exponential_like,
    gumbel_like,
    rand_p_b,
    random_directions,
)
from torch_reference_hlr import design as hlr_design
from torch_turn_statistics import GeneralizedReimpl

F32 = torch.float32


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _start(model, C, gen, scale):
    """A start near the target: exact draws (Gaussian, funnel with v in
    [-2, 2]: v clamped, then x | v drawn at the clamped v) or N(0,
    scale^2) (logreg); M^-1 = the covariance or I."""
    K = model.dim
    if model.sample_fn is None:
        q = scale * torch.randn((C, K), generator=gen, device=gen.device)
        return q, torch.eye(K, device=gen.device)
    q = model.sample(gen, C)
    if model.cov_fn is None:  # funnel: x_i = e^(v / 2) z_i
        v = q[:, 0].clamp(-2.0, 2.0)
        q[:, 1:] *= torch.exp(0.5 * (v - q[:, 0]))[:, None]
        q[:, 0] = v
        return q, torch.diag(torch.tensor([7.5] + [3.0] * (K - 1),
                                          device=gen.device))
    return q, model.cov_fn().to(F32)


def _laplace_start(model, C, gen):
    """Draws of the Laplace approximation of a logreg posterior (Newton's
    method from 0 in float64) and its covariance as M^-1."""
    leaf = model.tree_transition_fn.leaf
    K = model.dim
    x, y = (t.double() for t in leaf.logreg_data())
    eye = torch.eye(K, dtype=torch.float64, device=x.device)
    beta = torch.zeros(K, dtype=torch.float64, device=x.device)
    for _ in range(20):
        s = torch.sigmoid(x @ beta)
        hess = x.mT @ (x * (s * (1 - s))[:, None]) + leaf.scalars[0] * eye
        beta = beta + torch.linalg.solve(
            hess, x.mT @ (y - s) - leaf.scalars[0] * beta)
    cov = torch.linalg.inv(hess)
    z = torch.randn((C, K), generator=gen, dtype=torch.float64, device=x.device)
    return (beta + z @ torch.linalg.cholesky(cov).mT).float(), cov.float()


def _kernel_args(model, C, md, kind, dcap, eps_range, scale=0.3, seed=0):
    """Inputs of one tree-kernel transition; ``scale=None`` starts a logreg
    model at draws of its Laplace approximation with its covariance."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    K = model.dim
    if scale is None:
        q, minv = _laplace_start(model, C, gen)
    else:
        q, minv = _start(model, C, gen, scale)
    v, g = model.logdensity_and_gradient(q)
    if kind == "diag":
        minv = torch.diagonal(minv).contiguous()
    metric = diagonal_metric(minv) if kind == "diag" else dense_metric(minv)
    eps = torch.empty(C, device=dev).uniform_(*eps_range, generator=gen)
    return (
        q, rand_p_b(gen, metric, (C, K), F32).contiguous(), g, v, eps,
        random_directions(gen, C, dev),
        gumbel_like(gen, ((1 << md) - 1, C), F32, dev),
        exponential_like(gen, (md, C), F32, dev), minv.contiguous(),
        model.tree_transition_fn.leaf, dcap, -1000.0, md,
    )


def _rel(x, y, mask):
    x, y = x[mask].double(), y[mask].double()
    return torch.where(x == y, 0.0, (x - y).abs() / (1 + y.abs()))


def _worst(err, quantile=None):
    """The largest per-chain error (the largest over a chain's
    coordinates), or the given quantile of them."""
    per_chain = err.reshape(err.shape[0], -1).amax(-1)
    if quantile is None:
        return float(per_chain.max())
    return float(torch.quantile(per_chain, quantile))


def _check_transition(args, C, dcap, min_match, quantile=None):
    """The CUDA kernel against its plain version on the same injected noise.

    Discrete statistics (depth, steps, termination, and the proposal's leaf
    of the trajectory, ops/proposal_leaf.py) must agree on a share >=
    min_match of chains (a dot product that sits at 0 can flip a U-turn or
    Gumbel decision under another summation order). On those chains ld'
    agrees to 1e-4 (1 + |x|).
    q', grad' and log_sum carry the target's float32 conditioning (the
    plain float32 transition itself lies up to ~3e-4 (1 + |q|) from the
    float64 one at K = 100, and log_sum inherits the absolute rounding of
    pi ~ 1e2), so they must be as close to the float64 plain transition as
    the float32 plain version is: within twice its error, plus 1e-5
    (float32 rounding of values ~10 over a 15-step trajectory), on the
    chains where the float64 version chose the same leaf. With
    ``quantile``, each of these continuous rules holds that quantile of
    the per-chain errors in place of their maximum (FUNNEL_QUANTILE)."""
    tree_kernel.reset_launches()
    out = tree_kernel.tree_transition(*args)
    torch.cuda.synchronize()
    assert tree_kernel.launches == 1
    K, md, leaf, minv = args[0].shape[1], args[12], args[9], args[8]
    variant = tree_kernel.kernel_variant(leaf.kind, K, md, minv.ndim == 1,
                                         leaf.n_obs)
    assert tree_kernel.warp_launches == int(variant == "warp")
    assert tree_kernel.xstaged_launches == int(variant == "xstaged")
    ref = tree_kernel.tree_transition_plain(*args)
    ref64 = tree_kernel.tree_transition_plain(*(
        a.double() if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args
    ))
    leaf_k, leaf_32, leaf_64 = proposal_offsets(
        *args[:5], minv, leaf.value_and_grad, args[10],
        [out["prop_q"], ref["prop_q"], ref64["prop_q"]])
    same = leaf_k == leaf_32
    for name in ("depth", "steps", "term_left", "term_right"):
        same &= (out[name] == ref[name]) & (ref64[name] == ref[name])
    assert same.float().mean() >= min_match
    for name in ("prop_ld", "prop_pi"):  # the -inf rows match exactly
        assert torch.equal(torch.isneginf(out[name])[same],
                           torch.isneginf(ref[name])[same]), name
    assert _worst(_rel(out["prop_ld"], ref["prop_ld"], same), quantile) <= 1e-4
    both = same & (leaf_64 == leaf_32)
    for name in ("prop_q", "prop_grad", "log_sum"):
        err_kernel = _worst(_rel(out[name], ref64[name], both), quantile)
        err_plain = _worst(_rel(ref[name], ref64[name], both), quantile)
        assert err_kernel <= 2 * err_plain + 1e-5, (name, err_kernel, err_plain)
    assert int(out["depth"].max()) <= dcap
    assert torch.equal(out["work"], out["steps"])  # the chain's own leaves


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dcap,K", [
    ("dense", 4, 5), ("diag", 4, 5), ("dense", 2, 5), ("dense", 4, 100),
    ("dense", 6, 33),
])
def test_cuda_kernel_matches_plain(kind, dcap, K):
    dev = _device()
    C, md = 256, max(dcap, 4)
    model = correlated_gaussian(K, dtype=F32, device=dev, tree_kernel=True)
    _check_transition(_kernel_args(model, C, md, kind, dcap, (0.2, 0.6)),
                      C, dcap, 0.99)


@pytest.mark.gpu
@pytest.mark.parametrize("md,dcap", [(4, 4), (10, 10), (4, 2)])
@pytest.mark.parametrize("kind", ["dense", "diag"])
@pytest.mark.parametrize("K", [1, 5, 31, 32, 33, 100, 128])
def test_cuda_warp_kernel_matches_plain(K, kind, md, dcap):
    """The Gaussian leaf's warp variant (one warp per chain, R = 1-4
    coordinates a lane) against the plain version, by the rule of
    _check_transition, on 256 chains of correlated_gaussian(K)."""
    dev = _device()
    assert tree_kernel.kernel_variant(tree_kernel.GAUSSIAN, K, md,
                                      kind == "diag") == "warp"
    model = correlated_gaussian(K, dtype=F32, device=dev, tree_kernel=True)
    _check_transition(_kernel_args(model, 256, md, kind, dcap, (0.2, 0.6)),
                      256, dcap, 0.99)
    assert tree_kernel.warp_launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("md,K,warp", [
    (4, 128, True), (4, 129, False), (14, 127, True), (14, 128, False),
])
def test_cuda_warp_kernel_dispatch_boundary(md, K, warp):
    """The largest K the warp plan takes (dense metric) runs the warp
    variant, and the next K the CTA variant: past K = 128 (R = 5) at
    max_depth 4; at max_depth 14 the matrices leave one warp's merge stack
    room up to K = 127 only. Each against the plain version."""
    dev = _device()
    G = tree_kernel.GAUSSIAN
    assert (tree_kernel.warp_plan(G, K, md, False)[0] > 0) == warp
    assert (tree_kernel.warp_plan(G, K - 1, md, False)[0] > 0)
    model = correlated_gaussian(K, dtype=F32, device=dev, tree_kernel=True)
    _check_transition(_kernel_args(model, 64, md, "dense", 4, (0.2, 0.6)),
                      64, 4, 0.99)
    assert tree_kernel.launches == 1
    assert tree_kernel.warp_launches == int(warp)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,large_md", [("dense", 4), ("diag", 5)])
def test_cuda_warp_kernel_after_a_smaller_plan_of_its_r(kind, large_md):
    """The launch plan of each (K, max_depth, diag) is prepared once and
    kept, while every (K, max_depth) of one R shares the kernel function:
    at K = 120, a plan with more shared memory, then one with less
    (max_depth 10), then the first again must each launch and match the
    plain version."""
    dev = _device()
    K = 120
    large, small = (tree_kernel.warp_plan(tree_kernel.GAUSSIAN, K, md,
                                          kind == "diag")
                    for md in (large_md, 10))
    assert 0 < small[1] < large[1]
    model = correlated_gaussian(K, dtype=F32, device=dev, tree_kernel=True)
    for md in (large_md, 10, large_md):
        _check_transition(_kernel_args(model, 64, md, kind, 3, (0.2, 0.6),
                                       seed=md), 64, 3, 0.99)
        assert tree_kernel.warp_launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("md,dcap", [(4, 4), (10, 10), (4, 2)])
@pytest.mark.parametrize("kind", ["dense", "diag"])
@pytest.mark.parametrize("K", [129, 256])
def test_cuda_cta_gaussian_kernel_matches_plain(K, kind, md, dcap):
    """Past K = 128 the Gaussian leaf runs the CTA variant (one CTA per
    chain, compensated matvec sums): against the plain version, by the
    rule of _check_transition, on 256 chains of correlated_gaussian(K),
    with a dense and a diagonal metric, and with dcap below max_depth."""
    dev = _device()
    assert tree_kernel.kernel_variant(tree_kernel.GAUSSIAN, K, md,
                                      kind == "diag") == "cta"
    model = correlated_gaussian(K, dtype=F32, device=dev, tree_kernel=True)
    _check_transition(_kernel_args(model, 256, md, kind, dcap, (0.2, 0.6)),
                      256, dcap, 0.99)
    assert tree_kernel.warp_launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "diag"])
def test_cuda_warp_kernel_is_deterministic(kind):
    """Two launches at the main path's shape (4096 x 100, max_depth 4) give
    bitwise the same outputs: a chain's result does not depend on which
    warp took it from the queue."""
    dev = _device()
    model = correlated_gaussian(100, dtype=F32, device=dev, tree_kernel=True)
    args = _kernel_args(model, 4096, 4, kind, 4, (0.2, 0.6))
    tree_kernel.reset_launches()
    a = tree_kernel.tree_transition(*args)
    b = tree_kernel.tree_transition(*args)
    torch.cuda.synchronize()
    assert tree_kernel.warp_launches == 2
    for name, x in a.items():
        assert torch.equal(x, b[name]), name


def _check_warp_plan_against_the_source(kind):
    """The CUDA source's warp plan of leaf ``kind`` (warps per CTA, shared
    memory) is warp_plan's over a table of shapes, and where it takes warps
    the runtime fits at least one CTA per SM."""
    dev = _device()
    for K in (1, 2, 5, 25, 31, 32, 33, 64, 96, 97, 100, 127, 128, 129, 200):
        for md in (1, 4, 7, 10, 13, 14):
            for diag in (False, True):
                info = tree_kernel.warp_kernel_info(dev, kind, K, md, diag)
                plan = tree_kernel.warp_plan(kind, K, md, diag)
                assert (info.warps, info.smem) == plan, (K, md, diag)
                if plan[0]:
                    assert info.ctas_per_sm >= 1 and info.registers > 0
                else:
                    assert info.ctas_per_sm == info.registers == 0


@pytest.mark.gpu
def test_cuda_warp_plan_matches_the_source():
    _check_warp_plan_against_the_source(tree_kernel.GAUSSIAN)


@pytest.mark.gpu
def test_cuda_funnel_warp_plan_matches_the_source():
    """The funnel's warp plan from the source against warp_plan; at the
    funnel path's shape (K = 25, md 7, diagonal) the runtime holds the two
    CTAs an SM that the launch bounds ask for."""
    _check_warp_plan_against_the_source(tree_kernel.FUNNEL)
    info = tree_kernel.warp_kernel_info(_device(), tree_kernel.FUNNEL, 25, 7, True)
    assert info.warps == tree_kernel.FUNNEL_WARPS and info.ctas_per_sm >= 2


@pytest.mark.gpu
@pytest.mark.parametrize("K,C,md,kind,dcap", [
    (5, 256, 5, "diag", 5), (5, 256, 5, "dense", 3), (25, 4096, 7, "diag", 7),
])
def test_cuda_funnel_kernel_matches_plain(K, C, md, kind, dcap):
    dev = _device()
    model = funnel(K, dtype=F32, device=dev, tree_kernel=True)
    _check_transition(_kernel_args(model, C, md, kind, dcap, (0.02, 0.12)),
                      C, dcap, 0.99)


# Chains of each funnel case below, as in the funnel path's case above: a
# U-turn at a near tie flips under another summation order on a few chains
# in a thousand of the funnel's deep trees (the plain float32 version
# against the float64 one as often), so 1% of 256 chains is no margin.
FUNNEL_CHAINS = 4096
# The funnel's float32 transition is chaotic at md >= 7 and K near 100 or
# more: the plain version with sum q^2 alone reordered leaves the plain
# one's ld' by up to 8e-3 (1 + |x|) on a few chains in 4096 and fails the
# rule against float64 by its maximum on half the configurations, never by
# its 99th percentile (scripts/torch_funnel_order_sensitivity.py). The
# funnel cases below hold that percentile.
FUNNEL_QUANTILE = 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("md,dcap", [(4, 4), (7, 7), (10, 10), (4, 2)])
@pytest.mark.parametrize("kind", ["dense", "diag"])
@pytest.mark.parametrize("K", [2, 5, 25, 31, 32, 33, 100, 128])
def test_cuda_warp_funnel_kernel_matches_plain(K, kind, md, dcap):
    """The funnel leaf's warp variant (one warp per chain, R = 1-4
    coordinates a lane, v by a shuffle from lane 0) against the plain
    version, by the rule of _check_transition, on 4096 chains of
    funnel(K)."""
    dev = _device()
    assert tree_kernel.kernel_variant(tree_kernel.FUNNEL, K, md,
                                      kind == "diag") == "warp"
    model = funnel(K, dtype=F32, device=dev, tree_kernel=True)
    _check_transition(_kernel_args(model, FUNNEL_CHAINS, md, kind, dcap,
                                   (0.02, 0.12)), FUNNEL_CHAINS, dcap, 0.99,
                      FUNNEL_QUANTILE)
    assert tree_kernel.warp_launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("md,dcap", [(4, 4), (7, 7), (4, 2)])
@pytest.mark.parametrize("kind", ["dense", "diag"])
@pytest.mark.parametrize("K", [129, 256])
def test_cuda_cta_funnel_kernel_matches_plain(K, kind, md, dcap):
    """Past K = 128 the funnel leaf runs the CTA variant (one CTA per
    chain, block reductions): against the plain version, by the rule of
    _check_transition, on 4096 chains of funnel(K)."""
    dev = _device()
    assert tree_kernel.kernel_variant(tree_kernel.FUNNEL, K, md,
                                      kind == "diag") == "cta"
    model = funnel(K, dtype=F32, device=dev, tree_kernel=True)
    _check_transition(_kernel_args(model, FUNNEL_CHAINS, md, kind, dcap,
                                   (0.02, 0.12)), FUNNEL_CHAINS, dcap, 0.99,
                      FUNNEL_QUANTILE)
    assert tree_kernel.warp_launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "diag"])
def test_cuda_cta_funnel_kernel_at_k_1024(kind):
    """The CTA variant at its widest funnel, K = 1024 (1024 threads a
    chain, block sums over 32 warps) and max_depth 10 (a merge stack of
    11 levels in shared memory): against the plain version, by the rule
    of _check_transition, on 4096 chains."""
    dev = _device()
    K, md = 1024, 10
    assert tree_kernel.kernel_variant(tree_kernel.FUNNEL, K, md,
                                      kind == "diag") == "cta"
    model = funnel(K, dtype=F32, device=dev, tree_kernel=True)
    _check_transition(_kernel_args(model, FUNNEL_CHAINS, md, kind, md,
                                   (0.02, 0.12)), FUNNEL_CHAINS, md, 0.99,
                      FUNNEL_QUANTILE)
    assert tree_kernel.warp_launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("md", [4, 7])
@pytest.mark.parametrize("kind", ["dense", "diag"])
@pytest.mark.parametrize("K,warp", [(128, True), (129, False)])
def test_cuda_warp_funnel_dispatch_boundary(K, warp, kind, md):
    """The funnel at K = 128 (R = 4) runs the warp variant and at K = 129
    the CTA variant, read from both counters; each against the plain
    version."""
    dev = _device()
    diag = kind == "diag"
    assert (tree_kernel.warp_plan(tree_kernel.FUNNEL, K, md, diag)[0] > 0) == warp
    model = funnel(K, dtype=F32, device=dev, tree_kernel=True)
    _check_transition(_kernel_args(model, FUNNEL_CHAINS, md, kind, md,
                                   (0.02, 0.12)), FUNNEL_CHAINS, md, 0.99,
                      FUNNEL_QUANTILE)
    assert tree_kernel.launches == 1
    assert tree_kernel.warp_launches == int(warp)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "diag"])
def test_cuda_warp_funnel_is_deterministic(kind):
    """Two launches at the funnel path's shape (4096 x 25, max_depth 7)
    give bitwise the same outputs: a chain's result does not depend on
    which warp took it from the queue."""
    dev = _device()
    model = funnel(25, dtype=F32, device=dev, tree_kernel=True)
    args = _kernel_args(model, 4096, 7, kind, 7, (0.02, 0.12))
    tree_kernel.reset_launches()
    a = tree_kernel.tree_transition(*args)
    b = tree_kernel.tree_transition(*args)
    torch.cuda.synchronize()
    assert tree_kernel.warp_launches == 2
    for name, x in a.items():
        assert torch.equal(x, b[name]), name


# Logreg shapes of the CTA variant: each n_obs is past the staged-X
# variant's fit at its K, max_depth and metric (4,263 rows at K = 7 diag,
# 1,043 at K = 40 dense, 1,076 at K = 33 diag), and ends in a partial tile
# of 32 rows; the same K at fewer rows runs the staged-X variant
# (test_cuda_xstaged_logreg_kernel_at_the_cta_cases_shapes).
@pytest.mark.gpu
@pytest.mark.parametrize("n_obs,K,C,md,kind,scale,eps", [
    (4309, 7, 64, 4, "diag", 0.3, 0.1), (1100, 40, 64, 4, "dense", 0.1, 0.05),
    (4000, 128, 2048, 4, "diag", 0.03, 0.02),
    # K = 33: rows of 36 floats, and one coordinate past a warp
    (1100, 33, 64, 4, "diag", 0.1, 0.05),
    # past the n_obs the residual buffer of the earlier design capped
    # (57,248 at K = 8, md 4), from draws of the Laplace approximation
    (60001, 8, 64, 4, "diag", None, 0.4),
])
def test_cuda_logreg_kernel_matches_plain(n_obs, K, C, md, kind, scale, eps):
    """The CTA variant: starts at N(0, scale^2), about the posterior's
    spread, with eps in [eps / 4, eps] on an identity metric (scale None:
    Laplace draws and covariance). 4309 and 1100 observations end in a
    partial tile of X."""
    dev = _device()
    assert tree_kernel.kernel_variant(tree_kernel.LOGREG, K, md,
                                      kind == "diag", n_obs) == "cta"
    model = logistic_regression(n_obs, K, dtype=F32, device=dev,
                                tree_kernel=True)
    _check_transition(_kernel_args(model, C, md, kind, md, (eps / 4, eps),
                                   scale=scale), C, md, 0.99)
    assert tree_kernel.xstaged_launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("md,tiles", [(10, (2, True)), (11, (32, False))])
def test_cuda_logreg_kernel_at_the_widest_k(md, tiles):
    """K = 1024, through the 64-register wide kernel: at max_depth 10 the
    merge stack leaves room for two rows per ring stage; at 11 for less
    than one, and the tiles are read from X in place. Trees are capped at
    depth 4; 300 observations end in a partial tile."""
    dev = _device()
    K, C, n_obs = 1024, 16, 300
    assert tree_kernel.logreg_tiles(K, md) == tiles
    model = logistic_regression(n_obs, K, dtype=F32, device=dev,
                                tree_kernel=True)
    _check_transition(_kernel_args(model, C, md, "diag", 4, (0.005, 0.02),
                                   scale=0.1), C, 4, 0.99)


@pytest.mark.gpu
@pytest.mark.parametrize("n_obs,K,C", [(4309, 7, 64), (4000, 128, 256)])
def test_cuda_logreg_kernel_is_deterministic(n_obs, K, C):
    """Two launches of the CTA variant on the same inputs give bitwise the
    same outputs: every sum runs in a fixed order."""
    dev = _device()
    assert tree_kernel.kernel_variant(tree_kernel.LOGREG, K, 4, True,
                                      n_obs) == "cta"
    model = logistic_regression(n_obs, K, dtype=F32, device=dev,
                                tree_kernel=True)
    args = _kernel_args(model, C, 4, "diag", 4, (0.005, 0.02), scale=0.03)
    tree_kernel.reset_launches()
    a = tree_kernel.tree_transition(*args)
    b = tree_kernel.tree_transition(*args)
    torch.cuda.synchronize()
    assert tree_kernel.launches == 2 and tree_kernel.xstaged_launches == 0
    for name, x in a.items():
        assert torch.equal(x, b[name]), name


# n_obs of the staged-X cases: 300 rows (a partial block of rows and a
# partial step) wherever X fits at max_depth 10 with a dense metric; 90 at
# K = 128, where 96 is the most that fits there
XSTAGED_N_OBS = {1: 300, 8: 300, 25: 300, 32: 300, 33: 300, 64: 300, 128: 90}


@pytest.mark.gpu
@pytest.mark.parametrize("md,dcap", [(4, 4), (10, 10), (4, 2)])
@pytest.mark.parametrize("kind", ["dense", "diag"])
@pytest.mark.parametrize("K", sorted(XSTAGED_N_OBS))
def test_cuda_xstaged_logreg_kernel_matches_plain(K, kind, md, dcap):
    """The logreg leaf's staged-X variant (X staged once per CTA, one warp
    per chain, G lanes a row of X) against the plain float32 and float64
    versions, by the rule of _check_transition, on 256 chains from
    N(0, 0.1^2) with eps in [0.0125, 0.05]."""
    dev = _device()
    n_obs = XSTAGED_N_OBS[K]
    assert tree_kernel.kernel_variant(tree_kernel.LOGREG, K, md,
                                      kind == "diag", n_obs) == "xstaged"
    model = logistic_regression(n_obs, K, dtype=F32, device=dev,
                                tree_kernel=True)
    _check_transition(_kernel_args(model, 256, md, kind, dcap, (0.0125, 0.05),
                                   scale=0.1), 256, dcap, 0.99)
    assert tree_kernel.xstaged_launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("n_obs,K,C,md,kind,scale,eps", [
    (53, 7, 64, 4, "diag", 0.3, 0.1), (300, 40, 64, 4, "dense", 0.1, 0.05),
    (300, 33, 64, 4, "diag", 0.1, 0.05),
])
def test_cuda_xstaged_logreg_kernel_at_the_cta_cases_shapes(n_obs, K, C, md,
                                                            kind, scale, eps):
    """The staged-X variant at the small shapes the CTA variant's cases ran
    before it (test_cuda_logreg_kernel_matches_plain now runs those K past
    the fit): 53 rows at K = 7 (one partial step of rows), 300 at K = 40
    with a dense metric and at K = 33 (two lanes' chunks a row past a
    warp's coordinates), by the rule of _check_transition."""
    dev = _device()
    assert tree_kernel.kernel_variant(tree_kernel.LOGREG, K, md,
                                      kind == "diag", n_obs) == "xstaged"
    model = logistic_regression(n_obs, K, dtype=F32, device=dev,
                                tree_kernel=True)
    _check_transition(_kernel_args(model, C, md, kind, md, (eps / 4, eps),
                                   scale=scale), C, md, 0.99)
    assert tree_kernel.xstaged_launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "diag"])
@pytest.mark.parametrize("K", [33, 64, 128])
def test_cuda_xstaged_logreg_kernel_at_large_logits(K, kind):
    """The staged-X variant from draws of the Laplace approximation at
    K >= 33, where |logit| reaches 35-280 (the softplus and sigmoid tails),
    with the Laplace covariance or its diagonal as M^-1: against the plain
    float32 and float64 versions by the rule of _check_transition."""
    dev = _device()
    n_obs, md = XSTAGED_N_OBS[K], 4
    assert tree_kernel.kernel_variant(tree_kernel.LOGREG, K, md,
                                      kind == "diag", n_obs) == "xstaged"
    model = logistic_regression(n_obs, K, dtype=F32, device=dev,
                                tree_kernel=True)
    args = _kernel_args(model, 256, md, kind, md, (0.05, 0.2), scale=None)
    X, _ = args[9].logreg_data()
    assert float((args[0] @ X.T).abs().max()) > 20
    _check_transition(args, 256, md, 0.99)
    assert tree_kernel.xstaged_launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("extra,variant", [(0, "xstaged"), (1, "cta")])
def test_cuda_xstaged_logreg_dispatch_boundary(extra, variant):
    """The largest n_obs whose X the staged-X plan fits at the benchmark's
    K = 25, max_depth 4, diagonal metric takes the staged-X variant, and
    one row more the CTA variant; each against the plain version, from
    draws of the Laplace approximation."""
    dev = _device()
    K, md = 25, 4
    n_obs = 1
    while tree_kernel.xstaged_plan(K, md, n_obs + 1, True)[0]:
        n_obs += 1
    n_obs += extra
    assert tree_kernel.kernel_variant(tree_kernel.LOGREG, K, md, True,
                                      n_obs) == variant
    model = logistic_regression(n_obs, K, dtype=F32, device=dev,
                                tree_kernel=True)
    _check_transition(_kernel_args(model, 64, md, "diag", md, (0.05, 0.2),
                                   scale=None), 64, md, 0.99)
    assert tree_kernel.xstaged_launches == int(variant == "xstaged")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "diag"])
@pytest.mark.parametrize("n_obs,K,C", [(1000, 25, 4096), (53, 7, 64)])
def test_cuda_xstaged_logreg_kernel_is_deterministic(n_obs, K, C, kind):
    """Two launches give bitwise the same outputs, at the benchmark's shape
    (1000 x 25, max_depth 4, 4096 chains) and at 53 x 7 on 64 chains: a
    chain's result does not depend on which warp took it from the
    queue."""
    dev = _device()
    model = logistic_regression(n_obs, K, dtype=F32, device=dev,
                                tree_kernel=True)
    args = _kernel_args(model, C, 4, kind, 4, (0.05, 0.2), scale=None)
    tree_kernel.reset_launches()
    a = tree_kernel.tree_transition(*args)
    b = tree_kernel.tree_transition(*args)
    torch.cuda.synchronize()
    assert tree_kernel.xstaged_launches == 2
    for name, x in a.items():
        assert torch.equal(x, b[name]), name


@pytest.mark.gpu
def test_cuda_xstaged_logreg_kernel_after_a_smaller_plan_of_its_r():
    """The staged-X launch plan of each (K, max_depth, diag, n_obs) is
    prepared once and kept, while every plan of one R shares the kernel
    function: at K = 25, a plan with more shared memory (1,500 rows), then
    one with less (200 rows), then the first again must each launch and
    match the plain version."""
    dev = _device()
    K, md = 25, 4
    large, small = (tree_kernel.xstaged_plan(K, md, n, True)
                    for n in (1500, 200))
    assert 0 < small[1] < large[1] and small[0] and large[0]
    for n_obs in (1500, 200, 1500):
        model = logistic_regression(n_obs, K, dtype=F32, device=dev,
                                    tree_kernel=True)
        _check_transition(_kernel_args(model, 64, md, "diag", md, (0.05, 0.2),
                                       scale=None, seed=n_obs), 64, md, 0.99)
        assert tree_kernel.xstaged_launches == 1


@pytest.mark.gpu
def test_cuda_xstaged_plan_matches_the_source():
    """The CUDA source's staged-X plan (warps per CTA, shared memory) is
    xstaged_plan's over shapes on both sides of the fit boundary, and
    where it takes warps the runtime fits one CTA per SM."""
    dev = _device()
    for K in (1, 8, 25, 28, 32, 33, 64, 100, 128, 129):
        for md in (4, 10, 13):
            for diag in (False, True):
                for n_obs in (0, 90, 1000, 1911, 1912, 10316, 10317):
                    info = tree_kernel.xstaged_kernel_info(dev, K, md, n_obs,
                                                           diag)
                    plan = tree_kernel.xstaged_plan(K, md, n_obs, diag)
                    assert (info.warps, info.smem) == plan, (K, md, diag, n_obs)
                    if plan[0]:
                        assert info.ctas_per_sm >= 1 and info.registers > 0
                    else:
                        assert info.ctas_per_sm == info.registers == 0


def _leaf_inputs(C, K, n_obs, kind, seed=0):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = logistic_regression(n_obs, K, dtype=F32, device=dev, fused=True)
    x, y = model.fused_leaf_batched_fn.operands
    q = 0.1 * torch.randn((C, K), generator=gen, device=dev)
    if kind == "shared_dense":
        a = torch.randn((K, K), generator=gen, device=dev)
        metric = dense_metric(a @ a.mT / K + torch.eye(K, device=dev))
    elif kind == "chain_diag":
        metric = diagonal_metric(torch.empty((C, K), device=dev).uniform_(
            0.5, 2.0, generator=gen))
    else:
        metric = diagonal_metric(torch.empty(K, device=dev).uniform_(
            0.5, 2.0, generator=gen))
    p = rand_p_b(gen, metric, (C, K), F32).contiguous()
    _v, g = model.logdensity_and_gradient(q)
    eps = torch.empty(C, device=dev).uniform_(-0.2, 0.2, generator=gen)
    return metric, q, p, g, eps, x, y, model.fused_leaf_batched_fn.inv_s2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["shared_diag", "chain_diag", "shared_dense"])
@pytest.mark.parametrize("C,K,n_obs", [
    (37, 7, 53), (16, 200, 100), (2048, 128, 4000),
    # past 256 coordinates: the gradient in two and four chunks, the
    # latter with 16-row tiles
    (37, 300, 53), (16, 1024, 100),
    # 1000 rows end in a partial tile, and the observations split into
    # several slices
    (64, 40, 1000),
    # the tiled slice kernel: the hierarchical cell's width at 300 chains
    # (not a multiple of its 64-chain blocks), 65 chains and 77 rows (not a
    # multiple of its 32-row tiles), and the plan's boundary, the widest K
    # it takes and the next, which the chunked kernel takes
    (300, 302, 1000), (65, 33, 77),
    (100, logreg_leaf.TILED_MAX_K, 1001), (100, logreg_leaf.TILED_MAX_K + 1, 1001),
])
def test_cuda_fused_logreg_leaf_matches_plain(kind, C, K, n_obs):
    """The fused leaf against its plain version: every output within twice
    the plain float32 version's distance from float64, plus 1e-5
    (1 + |x|); ld' and pi' within 1e-4 (1 + |x|) of the plain version. The
    launch takes the tiled slice kernel exactly up to TILED_MAX_K."""
    args = _leaf_inputs(C, K, n_obs, kind)
    logreg_leaf.reset_launches()
    out = logreg_leaf.logreg_leaf(*args)
    torch.cuda.synchronize()
    assert logreg_leaf.launches == 1
    assert logreg_leaf.tiled_launches == int(logreg_leaf.tiled(K))
    _check_fused_against_plain(out, args)


@pytest.mark.gpu
@pytest.mark.parametrize("K,kind", [
    (K, kind) for K in (257, 300, 1024)
    for kind in ("shared_diag", "chain_diag", "shared_dense")
] + [(logreg_leaf.MAX_K, "shared_diag"), (logreg_leaf.MAX_K + 1, "shared_diag")])
def test_cuda_fused_logreg_hook_at_and_past_max_k(K, kind):
    """The fused logreg hook on float32 chains on the card launches the
    kernel for every K up to MAX_K, where the smallest tile's CTA fills the
    shared memory, in each metric form; one coordinate more and it raises
    instead of running the plain leaf on the card."""
    dev = _device()
    C, n_obs = 16, 100
    args = _leaf_inputs(C, K, n_obs, kind)
    hook = logistic_regression(n_obs, K, dtype=F32, device=dev,
                               fused=True).fused_leaf_batched_fn
    logreg_leaf.reset_launches()
    if K > logreg_leaf.MAX_K:
        with pytest.raises(ValueError, match=f"K = {K}"):
            hook(*args[:5])
        assert logreg_leaf.launches == 0
        return
    out = hook(*args[:5])
    torch.cuda.synchronize()
    assert logreg_leaf.launches == 1
    _check_fused_against_plain(out, args)


@pytest.mark.gpu
@pytest.mark.parametrize("C,K,n_obs,kind", [
    (2048, 128, 4000, "shared_diag"), (64, 40, 1000, "chain_diag"),
    (16, 1024, 100, "shared_dense"),
    # the tiled slice kernel at the hierarchical cell's width
    (300, 302, 1000, "shared_dense"), (300, 302, 1000, "chain_diag"),
])
def test_cuda_fused_logreg_leaf_is_deterministic(C, K, n_obs, kind):
    """Two launches on the same inputs give bitwise the same outputs: the
    slices' partial sums are added in a fixed order, with no atomics."""
    args = _leaf_inputs(C, K, n_obs, kind)
    a = logreg_leaf.logreg_leaf(*args)
    b = logreg_leaf.logreg_leaf(*args)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_cuda_fused_logreg_plan_matches_the_source(mode):
    """The CUDA runtime's view of each slice kernel: its shared memory is
    the plan's (the CUDA source and ops/logreg_leaf.py agree) for the tiled
    kernel up to TILED_MAX_K and the chunked one past it, and at least one
    CTA fits on an SM; ptxas reports no spill in any instantiation of the
    tiled kernel."""
    dev = _device()
    for K in (7, 128, 300, 302, logreg_leaf.TILED_MAX_K,
              logreg_leaf.TILED_MAX_K + 1, 1024, logreg_leaf.MAX_K):
        info = logreg_leaf.kernel_info(dev, mode, K)
        plan = logreg_leaf.launch_plan(16384, K, 1000, info.sm_count,
                                       info.blocks_per_sm)
        assert plan.tiled == (K <= logreg_leaf.TILED_MAX_K), K
        assert info.smem == plan.smem, K
        assert info.blocks_per_sm >= 1 and info.registers > 0, K
        assert info.sm_count == torch.cuda.get_device_properties(
            dev).multi_processor_count
    spills, name = {}, None
    for line in logreg_leaf.library.build_log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and "spill stores" in line:
            if "logreg_leaf_slice_kernel_tiled" in name:
                spills[name] = line.strip()
            name = None
    assert len(spills) == 3 * logreg_leaf.TILED_GROUPS, spills
    assert all("0 bytes spill stores, 0 bytes spill loads" in v
               for v in spills.values()), spills


def _check_fused_against_plain(out, args, plain=logreg_leaf.logreg_leaf_plain):
    """The rule of test_cuda_fused_logreg_leaf_matches_plain."""
    C = args[1].shape[0]
    ref = plain(*args)
    m = args[0]
    m64 = type(m)(m.m_inv.double(), None)
    ref64 = plain(m64, *(
        a.double() if torch.is_tensor(a) else a for a in args[1:]))
    everything = torch.ones(C, dtype=torch.bool, device=out[0].device)
    for name, x, y, z in zip("qpgLP", out, ref, ref64):
        err_kernel = float(_rel(x, z, everything).max())
        err_plain = float(_rel(y, z, everything).max())
        assert err_kernel <= 2 * err_plain + 1e-5, (name, err_kernel, err_plain)
    for x, y in zip(out[3:], ref[3:]):
        assert float(_rel(x, y, everything).max()) <= 1e-4


@pytest.mark.gpu
def test_cuda_fused_logreg_leaf_poisoning():
    metric, q, p, g, eps, x, y, inv_s2 = _leaf_inputs(8, 7, 53, "shared_diag")
    p[0] = 1e25   # the drift overflows: q' = inf, ld' = -inf
    q[1, 2] = float("nan")
    out = logreg_leaf.logreg_leaf(metric, q, p, g, eps, x, y, inv_s2)
    ref = logreg_leaf.logreg_leaf_plain(metric, q, p, g, eps, x, y, inv_s2)
    for a, b in zip(out[3:], ref[3:]):
        assert torch.equal(torch.isneginf(a), torch.isneginf(b))
        assert bool(torch.isneginf(a[:2]).all())
        assert bool(torch.isfinite(a[2:]).all())


def _hier_inputs(C, n_cov, n_obs, kind, seed=0):
    """The fused leaf's hierarchical mode (Hoffman and Gelman's HLR) on
    seeded data: the design of tests/torch_reference_hlr.py (ones, n_cov
    covariates and their products), K = 2 + n_cov + n_cov (n_cov - 1) / 2;
    b ~ 0.1 N(0, 1) and t ~ U[-6, 1] (the posterior's t lies near -5, the
    warmup's starts near 0); M^-1 as _leaf_inputs makes it; |eps| <= 0.02,
    the cell's step sizes. Returns the wrapper's arguments."""
    dev = _device()
    rng = np.random.RandomState(seed)
    x = hlr_design(rng.randn(n_obs, n_cov))
    y = (rng.uniform(size=n_obs) < 0.35).astype(np.float64)
    model = hierarchical_logistic_regression_from_data(
        x, y, rate=0.01, dtype=F32, device=dev, fused=True)
    K = model.dim
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = 0.1 * torch.randn((C, K), generator=gen, device=dev)
    q[:, -1] = torch.empty(C, device=dev).uniform_(-6.0, 1.0, generator=gen)
    if kind == "shared_dense":
        a = torch.randn((K, K), generator=gen, device=dev)
        metric = dense_metric(a @ a.mT / K + torch.eye(K, device=dev))
    else:
        shape = (C, K) if kind == "chain_diag" else (K,)
        metric = diagonal_metric(torch.empty(shape, device=dev).uniform_(
            0.5, 2.0, generator=gen))
    p = rand_p_b(gen, metric, (C, K), F32).contiguous()
    _v, g = model.logdensity_and_gradient(q)
    eps = torch.empty(C, device=dev).uniform_(-0.02, 0.02, generator=gen)
    x32, y32 = model.fused_leaf_batched_fn.operands
    return metric, q, p, g.contiguous(), eps, x32, y32, 0.01


# the cell's shape (16,384 chains, 1000 rows, K = 302), one at K <= 128:
# 2048 chains, 300 rows, K = 57, and the cell's width at 300 chains (not a
# multiple of the tiled kernel's 64-chain blocks; 1000 rows are no multiple
# of its 32-row tiles); all take the tiled slice kernel
HIER_SHAPES = [(16384, 24, 1000), (2048, 10, 300), (300, 24, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["shared_diag", "chain_diag", "shared_dense"])
@pytest.mark.parametrize("C,n_cov,n_obs", HIER_SHAPES)
def test_cuda_fused_logreg_hier_leaf_matches_float64(kind, C, n_cov, n_obs):
    """The hierarchical mode against float64 by the flat mode's rule
    (_check_fused_against_plain): each output within twice the plain
    float32 version's distance from float64 plus 1e-5 (1 + |x|), since
    the kernel's sums run in another order than torch's (per tile, then
    per slice) with no more rounding; ld' and pi' within 1e-4 (1 + |x|)
    of the plain version (a float32 sum over 1000 rows). The control, the
    plain version with TF32 products, fails the first rule: its logits
    keep 10 mantissa bits of the covariates and coefficients."""
    args = _hier_inputs(C, n_cov, n_obs, kind)
    logreg_leaf.reset_launches()
    out = logreg_leaf.logreg_leaf_hier(*args)
    torch.cuda.synchronize()
    assert logreg_leaf.launches == logreg_leaf.hier_launches == 1
    assert logreg_leaf.tiled_launches == int(logreg_leaf.tiled(args[1].shape[1]))
    _check_fused_against_plain(out, args, logreg_leaf.logreg_leaf_hier_plain)
    plain = logreg_leaf.logreg_leaf_hier_plain
    m = args[0]
    ref = plain(*args)
    ref64 = plain(type(m)(m.m_inv.double(), None), *(
        a.double() if torch.is_tensor(a) else a for a in args[1:]))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = plain(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    everything = torch.ones(C, dtype=torch.bool, device=out[0].device)
    failed = [name for name, x, y, z in zip("qpgLP", control, ref, ref64)
              if float(_rel(x, z, everything).max())
              > 2 * float(_rel(y, z, everything).max()) + 1e-5]
    assert failed, "the TF32 control passes the rule"


@pytest.mark.gpu
@pytest.mark.parametrize("C,n_cov,n_obs,kind", [
    (16384, 24, 1000, "shared_diag"), (2048, 10, 300, "chain_diag"),
    (2048, 10, 300, "shared_dense")])
def test_cuda_fused_logreg_hier_leaf_is_deterministic(C, n_cov, n_obs, kind):
    args = _hier_inputs(C, n_cov, n_obs, kind)
    a = logreg_leaf.logreg_leaf_hier(*args)
    b = logreg_leaf.logreg_leaf_hier(*args)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_cuda_fused_logreg_hier_leaf_poisoning():
    metric, q, p, g, eps, x, y, rate = _hier_inputs(8, 3, 53, "shared_diag")
    p[0] = 1e25  # the drift overflows: q' = inf, ld' = -inf
    q[1, -1] = float("nan")  # t: the prior's precision is NaN
    out = logreg_leaf.logreg_leaf_hier(metric, q, p, g, eps, x, y, rate)
    ref = logreg_leaf.logreg_leaf_hier_plain(metric, q, p, g, eps, x, y, rate)
    for a, b in zip(out[3:], ref[3:]):
        assert torch.equal(torch.isneginf(a), torch.isneginf(b))
        assert bool(torch.isneginf(a[:2]).all())
        assert bool(torch.isfinite(a[2:]).all())


@pytest.mark.gpu
def test_cuda_hier_logreg_runs_k3_on_every_leaf_of_run_chains():
    """run_chains through the plain driver with the hook: every leaf one
    launch of the hierarchical mode, no K1 launch, finite draws."""
    from dynamichmc_tpu_torch import run_chains
    from dynamichmc_tpu_torch.nuts import NUTS
    from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    dev = _device()
    rng = np.random.RandomState(0)
    x = hlr_design(rng.randn(1000, 24))
    y = (rng.uniform(size=1000) < 0.35).astype(np.float64)
    model = hierarchical_logistic_regression_from_data(
        x, y, dtype=F32, device=dev, fused=True, tree_kernel="auto")
    stages = default_warmup_stages(init_steps=20, middle_steps=20,
                                   doubling_stages=1, terminating_steps=20,
                                   metric_kind="diagonal", pooled=True)
    reset_launch_counts()
    res = run_chains(torch.Generator(device=dev).manual_seed(1), model, 512,
                     32, tune="reference", warmup_stages=stages,
                     algorithm=NUTS(max_depth=4), dtype=F32)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["tree_transition"] == 0
    assert counts["logreg_fused_leaf_hier"] == counts[
        "logreg_fused_leaf"] == counts["driver_fused_leaves"] > 0
    assert counts["logreg_fused_leaf_tiled"] == counts["logreg_fused_leaf"]
    assert bool(torch.isfinite(res.positions).all())


def _gaussian_inputs(model, C, minv_kind, seed=0, poison=True):
    """Exact draws, a diagonal metric from U[0.5, 2] (shared or per chain),
    momenta from it, the model's gradient, signed eps with |eps| in
    [0.1, 0.6]; with C > 2 row 0 overflows (p = 1e25) and row 1 is NaN."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    K = model.dim
    ops = model.fused_leaf_batched_fn.operands
    q = model.sample(gen, C).float()
    shape = (C, K) if minv_kind == "chain_diag" else (K,)
    metric = diagonal_metric(torch.empty(shape, device=dev).uniform_(
        0.5, 2.0, generator=gen))
    p = rand_p_b(gen, metric, (C, K), F32)
    _v, g = model.logdensity_and_gradient(q)
    sign = torch.where(torch.rand(C, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    eps = sign * torch.empty(C, device=dev).uniform_(0.1, 0.6, generator=gen)
    if poison and C > 2:
        p[0] = 1e25
        q[1, 0] = float("nan")
    return (metric, q.contiguous(), p.contiguous(), g.contiguous(),
            eps.contiguous(), ops.prec, ops.lchol, ops.mu)


def _gaussian_model(K):
    dev = _device()
    if K == 25:
        return mvnormal(np.zeros(K), np.eye(K), dtype=F32, device=dev,
                        fused=True)
    return correlated_gaussian(K, dtype=F32, device=dev, fused=True)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["leaf", "leapfrog"])
@pytest.mark.parametrize("C,K,minv_kind", [
    (4096, 25, "shared_diag"), (4096, 25, "chain_diag"), (37, 7, "chain_diag"),
    (4096, 100, "chain_diag"), (64, 130, "shared_diag"), (16, 200, "chain_diag"),
    (1, 25, "shared_diag"),
])
def test_cuda_gaussian_kernels_match_plain(which, C, K, minv_kind):
    """K2 (leaf) and K4 (leapfrog) against their plain versions: the -inf
    rows are the plain version's; on the other rows every output lies no
    further from the float64 plain version than twice the plain float32
    version's distance, plus 1e-5 (1 + |x|). K = 100 stages 80 KB of
    shared memory, K = 130 140 KB; at K = 200 prec and L (320 KB) no longer
    fit and are read through L1/L2."""
    module = gaussian_leaf if which == "leaf" else gaussian_leapfrog
    kernel = getattr(module, f"gaussian_{which}")
    args = _gaussian_inputs(_gaussian_model(K), C, minv_kind)
    module.reset_launches()
    out = kernel(*args)
    torch.cuda.synchronize()
    assert module.launches == 1
    bad = _check_gaussian_against_plain(which, out, args)
    assert bad == (2 if C > 2 else 0)


def _check_gaussian_against_plain(which, out, args):
    """The rule of test_cuda_gaussian_kernels_match_plain; returns the
    number of -inf rows."""
    module = gaussian_leaf if which == "leaf" else gaussian_leapfrog
    plain = getattr(module, f"gaussian_{which}_plain")
    ref = plain(*args)
    m64 = DiagonalMetric(args[0].m_inv.double(), None)
    ref64 = plain(m64, *(a.double() for a in args[1:]))
    assert len(out) == (5 if which == "leaf" else 4)
    for x, y in zip(out[3:], ref[3:]):
        assert torch.equal(torch.isneginf(x), torch.isneginf(y))
    fine = torch.isfinite(ref[3]) & torch.isfinite(ref64[3])
    for name, x, y, z in zip("qpgLP", out, ref, ref64):
        err_kernel = float(_rel(x, z, fine).max())
        err_plain = float(_rel(y, z, fine).max())
        assert err_kernel <= 2 * err_plain + 1e-5, (name, err_kernel, err_plain)
    return int((~fine).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [0, 1])
def test_cuda_gaussian_hooks_at_and_past_max_k(extra):
    """At K = MAX_K the kernels' 16 K floats of shared memory (227 KB) fit
    and both hooks launch them; one coordinate more and both hooks raise
    instead of running the plain math on the card."""
    from dynamichmc_tpu_torch.hamiltonian import EvaluatedPoint, PhasePoint

    dev = _device()
    K, C = gaussian_leaf.MAX_K + extra, 9
    eye = torch.eye(K, dtype=torch.float64, device=dev)
    mu = torch.zeros(K, dtype=torch.float64, device=dev)
    leaf = gaussian_leaf.make_gaussian_fused_leaf_batched(eye, mu, eye)
    step = gaussian_leapfrog.make_gaussian_fused_leapfrog(eye, mu, eye)
    ops = leaf.operands
    gen = torch.Generator(device=dev).manual_seed(0)
    q, p = (torch.randn((C, K), generator=gen, device=dev) for _ in range(2))
    eps = torch.full((C,), 0.2, device=dev)
    metric = diagonal_metric(torch.ones(K, device=dev))
    z = PhasePoint(Q=EvaluatedPoint(q=q, logdensity=-0.5 * (q * q).sum(-1),
                                    grad=-q), p=p)
    args = (metric, q, p, -q, eps, ops.prec, ops.lchol, ops.mu)
    gaussian_leaf.reset_launches()
    gaussian_leapfrog.reset_launches()
    if extra:
        with pytest.raises(ValueError, match=f"K = {K}"):
            leaf(metric, q, p, -q, eps)
        with pytest.raises(ValueError, match=f"K = {K}"):
            step(metric, z, eps)
        assert gaussian_leaf.launches == gaussian_leapfrog.launches == 0
        return
    out = leaf(metric, q, p, -q, eps)
    z2 = step(metric, z, eps)
    torch.cuda.synchronize()
    assert gaussian_leaf.launches == gaussian_leapfrog.launches == 1
    assert _check_gaussian_against_plain("leaf", out, args) == 0
    assert _check_gaussian_against_plain(
        "leapfrog", (z2.Q.q, z2.p, z2.Q.grad, z2.Q.logdensity), args) == 0


def _same_bits(x, y):
    """Bitwise equal float32 tensors, NaN included."""
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


# The block-of-chains plan's edges: one chain (R = 1, nothing staged); 7
# chains (one warp's tile of 8 short of full); 31 and 33 chains (tiles of 8:
# the last CTA holds 7 chains, then 1); 4095, 4096 and 4097 chains (tiles
# of 32 chains in four warps: the last holds 31, 32, then 1)
EDGE_CHAINS = (1, 7, 31, 33, 4095, 4096, 4097)


def _edge_dim(K):
    """K of test_cuda_gaussian_kernels_at_the_tile_edges: an int, or the
    last K whose 4096-chain plan stages prec and L, the next, or MAX_K."""
    if K == "staged":
        return gaussian_leaf.staging_limit(4096)
    if K == "unstaged":
        return gaussian_leaf.staging_limit(4096) + 1
    return gaussian_leaf.MAX_K if K == "max" else K


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 25, 31, 32, 33, 100, "staged", "unstaged",
                               "max"])
def test_cuda_gaussian_kernels_at_the_tile_edges(K):
    """K2 and K4 against their plain versions under the rule of
    test_cuda_gaussian_kernels_match_plain (the -inf rows are the plain
    version's, both poisoned rows among them; every other output no
    further from float64 than twice the plain float32 version, plus 1e-5)
    at every C of EDGE_CHAINS, with a shared and a per-chain M^-1 and eps
    of both signs, at K across the 32-lane column blocks, on both sides of
    the 4096-chain plan's staging limit and at MAX_K. Each launch counts
    once, and two launches on the same inputs give the same bits (NaN
    rows included)."""
    K = _edge_dim(K)
    model = _gaussian_model(K)
    for which in ("leaf", "leapfrog"):
        module = gaussian_leaf if which == "leaf" else gaussian_leapfrog
        kernel = getattr(module, f"gaussian_{which}")
        for C in EDGE_CHAINS:
            for minv_kind in ("shared_diag", "chain_diag"):
                args = _gaussian_inputs(model, C, minv_kind, seed=C + K)
                for sign in (1.0, -1.0):
                    signed = args[:4] + (sign * args[4],) + args[5:]
                    module.reset_launches()
                    out = kernel(*signed)
                    again = kernel(*signed)
                    torch.cuda.synchronize()
                    assert module.launches == 2
                    assert all(map(_same_bits, out, again))
                    bad = _check_gaussian_against_plain(which, out, signed)
                    assert bad == (2 if C > 2 else 0), (which, C, minv_kind, sign)


@pytest.mark.gpu
def test_cuda_gaussian_plan_matches_the_source():
    """The CUDA runtime's view of the kernel each plan runs: its shared
    memory is the plan's (the CUDA source and ops/gaussian_leaf.py agree),
    one CTA fits on an SM, and at 4096 chains the grid is one wave."""
    dev = _device()
    sms = gaussian_leaf.sm_count(dev.index)
    for C in EDGE_CHAINS:
        for K in (1, 25, 100, gaussian_leaf.staging_limit(4096),
                  gaussian_leaf.staging_limit(4096) + 1, gaussian_leaf.MAX_K):
            plan = gaussian_leaf.launch_plan(C, K, sms)
            for write_pi in (True, False):
                for chain_minv in (True, False):
                    info = gaussian_leaf.kernel_info(dev, write_pi, chain_minv,
                                                     K, plan)
                    assert info.smem == plan.smem, (C, K, plan)
                    assert info.ctas_per_sm >= 1 and info.registers > 0
            if C == 4096 and K <= 100:
                assert plan.ctas <= sms * info.ctas_per_sm


@pytest.mark.gpu
@pytest.mark.parametrize("minv_kind", ["shared_diag", "chain_diag"])
def test_cuda_gaussian_hooks_match_the_wrappers_bitwise(minv_kind):
    """The hooks launch through the model's bound operands: K2's hook on a
    (C, K) batch and K4's on one chain's (K,) tensors with a 0-d eps give
    the wrappers' bits on the same inputs, in the shapes they were given."""
    from dynamichmc_tpu_torch.hamiltonian import EvaluatedPoint, PhasePoint

    model = _gaussian_model(25)
    args = _gaussian_inputs(model, 33, minv_kind)
    metric, q, p, g, eps = args[:5]
    gaussian_leaf.reset_launches()
    out = model.fused_leaf_batched_fn(metric, q, p, g, eps)
    assert gaussian_leaf.launches == 1
    assert all(map(_same_bits, out, gaussian_leaf.gaussian_leaf(*args)))
    one = diagonal_metric(metric.m_inv if minv_kind == "shared_diag"
                          else metric.m_inv[2].contiguous())
    row = (one, q[2:3], p[2:3], g[2:3], eps[2:3], *args[5:])
    ref = gaussian_leapfrog.gaussian_leapfrog(*row)
    z = PhasePoint(Q=EvaluatedPoint(q=q[2], logdensity=ref[3][0], grad=g[2]),
                   p=p[2])
    gaussian_leapfrog.reset_launches()
    for e in (eps[2], float(eps[2])):  # a 0-d tensor, then a Python float
        z2 = model.fused_leapfrog_fn(one, z, e)
        assert z2.Q.q.shape == (25,) and z2.Q.logdensity.shape == ()
        assert all(map(_same_bits, (z2.Q.q, z2.p, z2.Q.grad, z2.Q.logdensity),
                       (ref[0][0], ref[1][0], ref[2][0], ref[3][0])))
    assert gaussian_leapfrog.launches == 2


@pytest.mark.gpu
def test_cuda_gaussian_wrappers_refuse_what_the_kernel_does_not_take():
    args = _gaussian_inputs(_gaussian_model(25), 8, "chain_diag", poison=False)
    metric, q = args[0], args[1]
    with pytest.raises(TypeError, match="float32"):
        gaussian_leaf.gaussian_leaf(metric, q.double(), *args[2:])
    with pytest.raises(ValueError, match="diagonal"):
        gaussian_leapfrog.gaussian_leapfrog(
            dense_metric(torch.eye(25, device=q.device)), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        gaussian_leaf.gaussian_leaf(metric, q.mT.contiguous().mT, *args[2:])


@pytest.mark.gpu
def test_cuda_per_chain_path_launches_the_leapfrog_kernel():
    """mcmc_with_warmup on N(0, I_25) with the fused hooks: every
    hamiltonian.leapfrog call launches K4 once, and the draws are finite."""
    from dynamichmc_tpu_torch import TuningNUTS, hamiltonian, mcmc_with_warmup
    from dynamichmc_tpu_torch.stepsize import InitialStepsizeSearch

    dev = _device()
    model = _gaussian_model(25)
    gaussian_leapfrog.reset_launches()
    hamiltonian.reset_leapfrog_calls()
    res = mcmc_with_warmup(torch.Generator(device=dev).manual_seed(0), model,
                           50, warmup_stages=(InitialStepsizeSearch(),
                                              TuningNUTS(N=50)))
    torch.cuda.synchronize()
    assert gaussian_leapfrog.launches == hamiltonian.leapfrog_calls > 0
    assert res.positions.shape == (50, 25) and res.positions.is_cuda
    assert bool(torch.isfinite(res.positions).all())


@pytest.mark.gpu
def test_cuda_plain_driver_launches_the_leaf_kernel():
    """run_chains on N(0, I_25) with the fused hooks and a per-chain
    diagonal metric: every leaf of the plain driver launches K2."""
    from dynamichmc_tpu_torch import TuningNUTS, run_chains
    from dynamichmc_tpu_torch import tree_batched as tb
    from dynamichmc_tpu_torch.stepsize import InitialStepsizeSearch

    dev = _device()
    model = _gaussian_model(25)
    gaussian_leaf.reset_launches()
    tb.reset_fused_leaf_calls()
    res = run_chains(torch.Generator(device=dev).manual_seed(0), model, 256,
                     20, tune="reference", warmup_stages=(
                         InitialStepsizeSearch(), TuningNUTS(N=20),
                         TuningNUTS(N=30, metric_kind="diagonal")))
    torch.cuda.synchronize()
    assert gaussian_leaf.launches == tb.fused_leaf_calls > 0
    assert res.metric.m_inv.shape == (256, 25)
    assert bool(torch.isfinite(res.positions).all())


# --- the per-chain API and the stage fold on the card -----------------------

@pytest.mark.gpu
def test_cuda_keep_warmup_equals_mcmc_with_warmup_bitwise():
    """mcmc_keep_warmup (the stage fold, keeping every state) and
    mcmc_with_warmup (the same fold, keeping none) from one seed on the
    card, every leapfrog through K4: the same draws, eps and metric bit for
    bit."""
    from dynamichmc_tpu_torch import (
        hamiltonian, mcmc_keep_warmup, mcmc_with_warmup)

    dev = _device()
    model = _gaussian_model(25)
    gaussian_leapfrog.reset_launches()
    hamiltonian.reset_leapfrog_calls()
    out = mcmc_keep_warmup(torch.Generator(device=dev).manual_seed(0), model,
                           100)
    res = mcmc_with_warmup(torch.Generator(device=dev).manual_seed(0), model,
                           100)
    torch.cuda.synchronize()
    assert gaussian_leapfrog.launches == hamiltonian.leapfrog_calls > 0
    final = out["final_warmup_state"]
    assert torch.equal(out["inference"].positions, res.positions)
    assert torch.equal(final.eps, res.eps)
    assert torch.equal(final.metric.m_inv, res.metric.m_inv)
    assert [h[1]["positions"].shape[0] for h in out["warmup"][1:]] == [
        75, 25, 50, 100, 200, 400, 50]


@pytest.mark.gpu
def test_cuda_generic_driver_launches_the_leapfrog_kernel():
    """A custom turn statistic and a FixedStepsize block after dual
    averaging through mcmc_with_warmup: the generic driver and the stage
    fold, every leapfrog a K4 launch (the
    metric stays diagonal: K4, like the JAX kernel, takes no dense one),
    finite draws."""
    from dynamichmc_tpu_torch import (
        NUTS, FixedStepsize, InitialStepsizeSearch, TuningNUTS, hamiltonian,
        mcmc_with_warmup)

    dev = _device()
    model = _gaussian_model(25)
    stages = (InitialStepsizeSearch(), TuningNUTS(N=75),
              TuningNUTS(N=50, metric_kind="diagonal"),
              TuningNUTS(N=50, metric_kind="diagonal",
                         stepsize_adaptation=FixedStepsize()))
    gaussian_leapfrog.reset_launches()
    hamiltonian.reset_leapfrog_calls()
    res = mcmc_with_warmup(
        torch.Generator(device=dev).manual_seed(1), model, 100,
        warmup_stages=stages,
        algorithm=NUTS(turn_statistic_configuration=GeneralizedReimpl()))
    torch.cuda.synchronize()
    assert gaussian_leapfrog.launches == hamiltonian.leapfrog_calls > 0
    assert res.metric.m_inv.shape == (25,)
    assert res.positions.shape == (100, 25)
    assert bool(torch.isfinite(res.positions).all())


@pytest.mark.gpu
def test_cuda_batched_next_chunk_launches_the_leaf_kernel():
    """The stepwise API on a (C, K) batch with a per-chain diagonal metric:
    every leaf of the plain driver launches K2, and next_chunk is 16
    next_step calls bit for bit."""
    from dynamichmc_tpu_torch import NUTS, mcmc_steps
    from dynamichmc_tpu_torch import tree_batched as tb
    from dynamichmc_tpu_torch.hamiltonian import evaluate

    dev = _device()
    model = _gaussian_model(25)
    gen = torch.Generator(device=dev).manual_seed(2)
    C = 512
    metric = diagonal_metric(0.5 + torch.rand((C, 25), generator=gen,
                                              device=dev))
    eps = 0.3 + 0.2 * torch.rand((C,), generator=gen, device=dev)
    Q = evaluate(model, torch.randn((C, 25), generator=gen, device=dev))
    steps = mcmc_steps(model, NUTS(), metric, eps)
    gaussian_leaf.reset_launches()
    tb.reset_fused_leaf_calls()
    Q_fin, chunk = steps.next_chunk(torch.Generator(device=dev).manual_seed(3),
                                    Q, 16)
    torch.cuda.synchronize()
    assert gaussian_leaf.launches == tb.fused_leaf_calls > 0
    assert chunk.positions.shape == (16, C, 25)
    assert bool(torch.isfinite(chunk.positions).all())
    gen = torch.Generator(device=dev).manual_seed(3)
    for i in range(16):
        Q, _stats = steps.next_step(gen, Q)
        assert torch.equal(Q.q, chunk.positions[i])
    assert torch.equal(Q.q, Q_fin.q)


@pytest.mark.gpu
def test_cuda_heterogeneous_run_chains_takes_the_warp_kernel():
    """run_chains with pooled diagonal blocks then pooled dense blocks (the
    stage fold on the batch) on correlated_gaussian(100, tree_kernel=True):
    every transition a launch of K1's warp variant, the metric shared."""
    from dynamichmc_tpu_torch import (
        NUTS, InitialStepsizeSearch, TuningNUTS, run_chains)
    from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = _device()
    model = correlated_gaussian(100, dtype=F32, device=dev, tree_kernel=True)
    stages = (InitialStepsizeSearch(), TuningNUTS(N=75),
              TuningNUTS(N=25, metric_kind="diagonal", pooled=True),
              TuningNUTS(N=50, metric_kind="diagonal", pooled=True),
              TuningNUTS(N=100, metric_kind="dense", pooled=True),
              TuningNUTS(N=50))
    reset_launch_counts()
    res = run_chains(torch.Generator(device=dev).manual_seed(0), model, 512,
                     64, tune="reference", warmup_stages=stages,
                     algorithm=NUTS(max_depth=4))
    torch.cuda.synchronize()
    counts = launch_counts()
    transitions = sum(stage.N for stage in stages[1:]) + 64
    assert counts["tree_transition"] == counts["tree_transition_warp"] \
        == transitions
    assert res.metric.m_inv.shape == (100, 100)  # shared, dense
    assert bool(torch.isfinite(res.positions).all())


def _slice14_run(dev, **kw):
    """run_chains at 256 x 100 on correlated_gaussian(100, tree_kernel=True):
    a pooled dense schedule of 80 warmup steps, md 4, clamp 2 with a 5-step
    tail, 32 draws; returns the result and the run's launch counts."""
    from dynamichmc_tpu_torch import NUTS, run_chains
    from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    model = correlated_gaussian(100, dtype=F32, device=dev, tree_kernel=True)
    stages = default_warmup_stages(metric_kind="dense", pooled=True,
                                   init_steps=20, middle_steps=20,
                                   doubling_stages=2, terminating_steps=20)
    reset_launch_counts()
    res = run_chains(torch.Generator(device=dev).manual_seed(0), model, 256,
                     32, tune="reference", warmup_stages=stages,
                     algorithm=NUTS(max_depth=4), warmup_depth_clamp=2,
                     warmup_depth_clamp_tail=5, **kw)
    torch.cuda.synchronize()
    return res, launch_counts()


@pytest.mark.gpu
def test_cuda_warmup_resume_through_disk_is_bitwise(tmp_path):
    """Every checkpoint of a K1 run, saved and loaded, resumes to the
    uninterrupted run's draws, eps and M^-1 bit for bit, each remaining
    transition a launch of K1's warp variant."""
    from dynamichmc_tpu_torch.checkpoint import load_state, save_state

    dev = _device()
    ckpts = []
    ref, counts = _slice14_run(dev, warmup_checkpoint_sink=ckpts.append)
    assert [c.step for c in ckpts] == [0, 20, 40, 80, 100]
    assert counts["tree_transition_warp"] == 100 + 32
    for ckpt in ckpts:
        save_state(str(tmp_path / f"s{ckpt.step}"), ckpt)
        restored, _ = load_state(str(tmp_path / f"s{ckpt.step}"))
        assert restored.Q.q.is_cuda  # loaded where it was saved
        res, counts = _slice14_run(dev, warmup_resume=restored)
        assert counts["tree_transition"] == counts["tree_transition_warp"] \
            == 100 - ckpt.step + 32
        assert torch.equal(res.positions, ref.positions)
        assert torch.equal(res.eps, ref.eps)
        assert torch.equal(res.metric.m_inv, ref.metric.m_inv)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 8, None])
def test_cuda_draw_sink_streams_the_tree_kernels_draws(chunk, tmp_path):
    """A K1 run with a draw sink fills its store with the kept run's draws
    bit for bit, whatever the chunk; nothing of the draws stays on the
    card."""
    from dynamichmc_tpu_torch.io import MemmapDrawStore

    dev = _device()
    ref, _ = _slice14_run(dev)
    store = MemmapDrawStore(str(tmp_path / "d"), 256, 32, 100)
    res, counts = _slice14_run(dev, draw_sink=store.sink, sample_chunk=chunk)
    assert counts["tree_transition"] == counts["tree_transition_warp"] == 132
    assert res.positions is None and res.logdensities is None
    assert res.tree_statistics.depth.is_cuda
    assert np.array_equal(np.asarray(store.positions), ref.positions.cpu().numpy())
    assert np.array_equal(np.asarray(store.logdensities),
                          ref.logdensities.cpu().numpy())


@pytest.mark.gpu
def test_cuda_constraints_match_the_cpu():
    """Forward, log|J|, inverse and the transformed density's gradient on
    the card at float64 equal the CPU's to 1e-12."""
    from dynamichmc_tpu_torch import constraints as tc

    dev = _device()
    ts = [tc.positive(2), tc.bounded(-2.0, 5.0, 1), tc.simplex(4),
          tc.identity(1)]
    stack = tc.as_stack(ts)
    x = torch.randn((64, stack.input_dim), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    alpha = torch.tensor([2.0, 3.0, 4.0, 5.0], dtype=torch.float64)

    def lp(y):
        a = alpha.to(y.device)
        return -y[..., 0] - 0.5 * y[..., 3] ** 2 + (
            (a - 1) * torch.log(y[..., 3:7])).sum(-1)

    ld = tc.transformed_logdensity(lp, ts)
    y_cpu, lj_cpu = stack.forward_with_logdet(x)
    y_gpu, lj_gpu = stack.forward_with_logdet(x.to(dev))
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-12, atol=0)
    torch.testing.assert_close(lj_gpu.cpu(), lj_cpu, rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(stack.inverse(y_gpu).cpu(), stack.inverse(y_cpu),
                               rtol=1e-12, atol=1e-14)
    v_cpu, g_cpu = ld.logdensity_and_gradient(x)
    v_gpu, g_gpu = ld.logdensity_and_gradient(x.to(dev))
    torch.testing.assert_close(v_gpu.cpu(), v_cpu, rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(g_gpu.cpu(), g_cpu, rtol=1e-12, atol=1e-14)


# --- tune="auto" and a custom turn statistic on the card --------------------


@pytest.mark.gpu
def test_cuda_auto_is_the_explicit_configuration():
    """run_chains(generator, model, 256, 100) with nothing else on
    correlated_gaussian(100, tree_kernel=True): auto's line, and the draws,
    eps and M^-1 of the configuration spelled out (pooled dense stages,
    NUTS(max_depth=4), clamp 2/25) bit for bit, every transition a launch
    of K1's warp variant."""
    from dynamichmc_tpu_torch import NUTS, run_chains
    from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    dev = _device()
    model = correlated_gaussian(100, dtype=F32, device=dev, tree_kernel=True)
    lines = []
    reset_launch_counts()
    auto = run_chains(torch.Generator(device=dev).manual_seed(0), model, 256,
                      100, log=lines.append)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert lines[0] == ("autotune: max_depth=4, pooled dense metric, "
                        "per-chain eps, warmup clamp 2/25")
    assert counts["tree_transition"] == counts["tree_transition_warp"] \
        == 900 + 100
    ref = run_chains(torch.Generator(device=dev).manual_seed(0), model, 256,
                     100, tune="reference",
                     warmup_stages=default_warmup_stages(metric_kind="dense",
                                                         pooled=True),
                     algorithm=NUTS(max_depth=4), warmup_depth_clamp=2,
                     warmup_depth_clamp_tail=25)
    assert torch.equal(auto.positions, ref.positions)
    assert torch.equal(auto.eps, ref.eps)
    assert torch.equal(auto.metric.m_inv, ref.metric.m_inv)


@pytest.mark.gpu
def test_cuda_custom_statistic_batch_launches_k4_per_leapfrog():
    """run_chains at 4 x 25 on N(0, I) with the fused hooks and the
    generalized statistic reimplemented (the generic driver looped over the
    chains): K4 once for every hamiltonian.leapfrog call, and no other
    kernel."""
    from dynamichmc_tpu_torch import NUTS, run_chains
    from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    dev = _device()
    model = mvnormal(np.zeros(25), np.eye(25), dtype=F32, device=dev,
                     fused=True)
    stages = default_warmup_stages(init_steps=20, middle_steps=20,
                                   doubling_stages=1, terminating_steps=20)
    reset_launch_counts()
    res = run_chains(torch.Generator(device=dev).manual_seed(0), model, 4, 16,
                     warmup_stages=stages, algorithm=NUTS(
                         turn_statistic_configuration=GeneralizedReimpl()))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["gaussian_leapfrog"] == counts["leapfrog_calls"] > 0
    assert counts["tree_transition"] == counts["gaussian_fused_leaf"] \
        == counts["logreg_fused_leaf"] == 0
    assert tuple(res.positions.shape) == (4, 16, 25)
    assert bool(torch.isfinite(res.positions).all())


# --- the wavefront and epoch drivers with K2 --------------------------------

SCHED_C, SCHED_K, SCHED_T, SCHED_MD = 256, 25, 24, 6


def _sched_noise(cls, dev, seed):
    """Per-lane injected draws for SCHED_T transitions (numpy seed)."""
    rng = np.random.default_rng(seed)
    T, md, C, K = SCHED_T, SCHED_MD, SCHED_C, SCHED_K
    dirs = rng.integers(0, 2**32, size=(T, C), dtype=np.uint64)
    return cls(
        p=torch.tensor(rng.normal(size=(T, C, K)), dtype=F32, device=dev),
        dirs=torch.tensor(dirs.astype(np.uint32).view(np.int32), device=dev),
        gumbel=torch.tensor(rng.gumbel(size=(T, md, 1 << (md - 1), C)),
                            dtype=F32, device=dev),
        expo=torch.tensor(rng.exponential(size=(T, md, C)), dtype=F32,
                          device=dev))


def _sched_models(dev):
    """N(0, I_25) through K2 and through the plain leaf, a per-chain
    diagonal M^-1 near I and per-chain eps, and the start."""
    gen = torch.Generator(device=dev).manual_seed(17)
    fused, plain = (mvnormal(np.zeros(SCHED_K), np.eye(SCHED_K), dtype=F32,
                             device=dev, fused=f) for f in (True, False))
    m_inv = 0.8 + 0.4 * torch.rand((SCHED_C, SCHED_K), generator=gen,
                                   device=dev)
    eps = 0.3 + 0.6 * torch.rand((SCHED_C,), generator=gen, device=dev)
    q0 = torch.randn((SCHED_C, SCHED_K), generator=gen, device=dev)
    return fused, plain, diagonal_metric(m_inv), eps, q0


def _agreeing_lanes(q_a, q_b, counts_a, counts_b):
    """Lanes whose integer counts agree and whose positions agree to
    float32's rounding (a lane whose trajectory flips a decision on a
    rounding difference leaves the comparison: float32 only)."""
    same = torch.ones(q_a.shape[0], dtype=torch.bool, device=q_a.device)
    for a, b in zip(counts_a, counts_b):
        same &= (a == b).reshape(a.shape[0], -1).all(-1)
    close = ((q_a - q_b).abs() <= 1e-3 * (1 + q_b.abs())).reshape(
        q_a.shape[0], -1).all(-1)
    return same & close


@pytest.mark.gpu
def test_cuda_wavefront_with_k2_matches_the_plain_leaf():
    """The wavefront stage through K2 (one launch per slot) against the
    same stage through the plain float32 leaf, on the same injected noise:
    at least 95% of 256 lanes end with the same step, divergence and
    max-depth counts and the same position."""
    from dynamichmc_tpu_torch.hamiltonian import evaluate
    from dynamichmc_tpu_torch.nuts import NUTS
    from dynamichmc_tpu_torch.stepsize import FixedStepsize
    from dynamichmc_tpu_torch.tree_wavefront import (
        WavefrontNoise, make_wavefront_stage_driver, wavefront_init)

    dev = _device()
    fused, plain, metric, eps, q0 = _sched_models(dev)
    nz = _sched_noise(WavefrontNoise, dev, 5)
    out = {}
    for name, model in (("k2", fused), ("plain", plain)):
        stage = make_wavefront_stage_driver(
            model, NUTS(max_depth=SCHED_MD), FixedStepsize(),
            use_welford=False, noise=nz)
        carry = wavefront_init(evaluate(model, q0), metric, eps, None,
                               SCHED_MD)
        gaussian_leaf.reset_launches()
        carry, done = stage(None, metric, carry, SCHED_T)
        assert done
        out[name] = (carry, gaussian_leaf.launches)
    (k2, launches), (ref, plain_launches) = out["k2"], out["plain"]
    assert plain_launches == 0 and launches >= k2["g"] > 0
    agree = _agreeing_lanes(
        k2["Q"].q, ref["Q"].q,
        [k2[f] for f in ("steps_total", "div", "maxd")],
        [ref[f] for f in ("steps_total", "div", "maxd")])
    assert float(agree.float().mean()) >= 0.95


@pytest.mark.gpu
def test_cuda_epoch_with_k2_matches_the_plain_leaf():
    """The epoch sampler through K2 against the plain float32 leaf on the
    same injected noise: at least 95% of 256 lanes take the same draws
    (depth, steps, termination per draw; positions to rounding)."""
    from dynamichmc_tpu_torch.hamiltonian import evaluate
    from dynamichmc_tpu_torch.nuts import NUTS
    from dynamichmc_tpu_torch.tree_wavefront_epoch import (
        EpochNoise, epoch_sampling_finish, epoch_sampling_init,
        make_epoch_sampling_driver)

    dev = _device()
    fused, plain, metric, eps, q0 = _sched_models(dev)
    nz = _sched_noise(EpochNoise, dev, 6)
    out = {}
    for name, model in (("k2", fused), ("plain", plain)):
        stage = make_epoch_sampling_driver(model, NUTS(max_depth=SCHED_MD),
                                           SCHED_T, noise=nz)
        carry = epoch_sampling_init(evaluate(model, q0), metric, SCHED_T,
                                    SCHED_MD)
        gaussian_leaf.reset_launches()
        carry, done = stage(None, metric, eps, carry)
        assert done
        out[name] = (epoch_sampling_finish(carry, SCHED_T),
                     gaussian_leaf.launches, carry["g"])
    (k2, launches, slots), (ref, plain_launches, _s) = out["k2"], out["plain"]
    assert plain_launches == 0 and launches >= slots > 0
    fields = ("depth", "steps", "term_left", "term_right")
    agree = _agreeing_lanes(k2[1], ref[1],
                            [getattr(k2[3], f) for f in fields],
                            [getattr(ref[3], f) for f in fields])
    assert float(agree.float().mean()) >= 0.95


@pytest.mark.gpu
def test_cuda_trace_records_a_lone_kernel_after_another_session(tmp_path):
    """profiling.trace around one bare tree-kernel call, after a CUDA-only
    torch.profiler session in the same process, writes a trace that holds
    that kernel."""
    import json
    import os

    from dynamichmc_tpu_torch import profiling

    _device()
    model = correlated_gaussian(100, dtype=F32, tree_kernel=True)
    args = _kernel_args(model, 1024, 10, "dense", 10, (0.2, 0.6))
    tree_kernel.tree_transition(*args)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        tree_kernel.tree_transition(*args)
        torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)) as log_dir:
        tree_kernel.tree_transition(*args)
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any("tree_transition" in e.get("name", "") for e in events
               if e.get("cat") == "kernel")
