"""GPU-only checks of the port's hand-written kernels.

They import torch and the port only, so they also run where JAX is absent:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``. Without a
CUDA device they skip (the kernels have no CPU mode; on the CPU the wrappers
take their plain versions, which the other test_torch_* files check against
the JAX package).
"""

import pytest
import torch

from dynamichmc_tpu_torch.metric import dense_metric, diagonal_metric
from dynamichmc_tpu_torch.models import (
    correlated_gaussian,
    funnel,
    logistic_regression,
)
from dynamichmc_tpu_torch.ops import logreg_leaf, tree_kernel
from dynamichmc_tpu_torch.tree_batched import (
    exponential_like,
    gumbel_like,
    rand_p_b,
    random_directions,
)

F32 = torch.float32


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _start(model, C, gen, scale):
    """A start near the target: exact draws (Gaussian, funnel with v in
    [-2, 2]) or N(0, scale^2) (logreg); M^-1 = the covariance or I."""
    K = model.dim
    if model.sample_fn is None:
        q = scale * torch.randn((C, K), generator=gen, device=gen.device)
        return q, torch.eye(K, device=gen.device)
    q = model.sample(gen, C)
    if model.cov_fn is None:  # funnel
        q[:, 0].clamp_(-2.0, 2.0)
        return q, torch.diag(torch.tensor([7.5] + [3.0] * (K - 1),
                                          device=gen.device))
    return q, model.cov_fn().to(F32)


def _kernel_args(model, C, md, kind, dcap, eps_range, scale=0.3, seed=0):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    K = model.dim
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


def _check_transition(args, C, dcap, min_match):
    """The CUDA kernel against its plain version on the same injected noise.

    Discrete statistics must agree on a share >= min_match of chains (a dot
    product that sits at 0 can flip a U-turn or Gumbel decision under
    another summation order). On those chains ld' agrees to 1e-4 (1 + |x|).
    q', grad' and log_sum carry the target's float32 conditioning (the
    plain float32 transition itself lies up to ~3e-4 (1 + |q|) from the
    float64 one at K = 100, and log_sum inherits the absolute rounding of
    pi ~ 1e2), so they must be as close to the float64 plain transition as
    the float32 plain version is: within twice its error, plus 1e-5
    (float32 rounding of values ~10 over a 15-step trajectory)."""
    tree_kernel.reset_launches()
    out = tree_kernel.tree_transition(*args)
    torch.cuda.synchronize()
    assert tree_kernel.launches == 1
    ref = tree_kernel.tree_transition_plain(*args)
    ref64 = tree_kernel.tree_transition_plain(*(
        a.double() if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args
    ))
    same = torch.ones(C, dtype=torch.bool, device=out["depth"].device)
    for name in ("depth", "steps", "term_left", "term_right"):
        same &= (out[name] == ref[name]) & (ref64[name] == ref[name])
    assert same.float().mean() >= min_match
    assert float(_rel(out["prop_ld"], ref["prop_ld"], same).max()) <= 1e-4
    for name in ("prop_q", "prop_grad", "log_sum"):
        err_kernel = float(_rel(out[name], ref64[name], same).max())
        err_plain = float(_rel(ref[name], ref64[name], same).max())
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
@pytest.mark.parametrize("K,C,md,kind,dcap", [
    (5, 256, 5, "diag", 5), (5, 256, 5, "dense", 3), (25, 4096, 7, "diag", 7),
])
def test_cuda_funnel_kernel_matches_plain(K, C, md, kind, dcap):
    dev = _device()
    model = funnel(K, dtype=F32, device=dev, tree_kernel=True)
    _check_transition(_kernel_args(model, C, md, kind, dcap, (0.02, 0.12)),
                      C, dcap, 0.99)


@pytest.mark.gpu
@pytest.mark.parametrize("n_obs,K,C,md,kind,scale,eps", [
    (53, 7, 64, 4, "diag", 0.3, 0.1), (300, 40, 64, 4, "dense", 0.1, 0.05),
    (4000, 128, 2048, 4, "diag", 0.03, 0.02),
])
def test_cuda_logreg_kernel_matches_plain(n_obs, K, C, md, kind, scale, eps):
    """Starts at N(0, scale^2), about the posterior's spread, with eps in
    [eps / 4, eps] on an identity metric."""
    dev = _device()
    model = logistic_regression(n_obs, K, dtype=F32, device=dev,
                                tree_kernel=True)
    _check_transition(_kernel_args(model, C, md, kind, md, (eps / 4, eps),
                                   scale=scale), C, md, 0.99)


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
])
def test_cuda_fused_logreg_leaf_matches_plain(kind, C, K, n_obs):
    """The fused leaf against its plain version: every output within twice
    the plain float32 version's distance from float64, plus 1e-5
    (1 + |x|); ld' and pi' within 1e-4 (1 + |x|) of the plain version."""
    args = _leaf_inputs(C, K, n_obs, kind)
    logreg_leaf.reset_launches()
    out = logreg_leaf.logreg_leaf(*args)
    torch.cuda.synchronize()
    assert logreg_leaf.launches == 1
    ref = logreg_leaf.logreg_leaf_plain(*args)
    m = args[0]
    m64 = type(m)(m.m_inv.double(), None)
    ref64 = logreg_leaf.logreg_leaf_plain(m64, *(
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
