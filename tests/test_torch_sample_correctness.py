"""Statistical end-to-end correctness gates of the PyTorch port (CPU,
float64).

One test for each test of tests/test_sample_correctness.py, with the same
workloads, thresholds, chain and draw counts and warmup stages, through
the port's ``run_chains`` and the protocol of
tests/torch_correctness_utils.py (R-hat / ESS per draw / Anderson-Darling
/ EBFMI). Each generator is seeded with the integer of the JAX test's key
(``PRNGKey(1000 + seed)`` -> ``1000 + seed``). The torch stream is not
JAX's, so a draw the JAX file called unlucky need not be unlucky here,
and the other way round.

Beside them, the ports of tests/test_models.py's slow model-family runs
through ``mcmc_with_warmup`` and its elongate-then-mix check. Imports no
JAX: ``python -m pytest -m slow tests/test_torch_sample_correctness.py``.
"""

import numpy as np
import pytest
import torch

from torch_correctness_utils import (
    SPECIFIC_NORMALS,
    Thresholds,
    bench_dim_gate,
    run_and_check,
    specific_normal_gate,
)
from dynamichmc_tpu_torch import NUTS, default_warmup_stages, mcmc_with_warmup
from dynamichmc_tpu_torch.diagnostics import EBFMI, summarize_tree_statistics
from dynamichmc_tpu_torch.models import (
    correlated_gaussian,
    eight_schools_centered,
    eight_schools_noncentered,
    elongate,
    extreme_variance_gaussian,
    funnel,
    ill_conditioned_gaussian,
    logistic_regression,
    mixture,
    mvnormal,
    rosenbrock,
    std_normal,
)
from dynamichmc_tpu_torch.parallel import run_chains

CPU = {"device": "cpu"}
F64 = torch.float64


@pytest.mark.slow
@pytest.mark.parametrize("seed", list(range(10)))
def test_correlated_mvn_dense_metric(seed):
    # sample-correctness_tests.jl:12-23: TEN random correlated MVNs with
    # random dimension K in 3..10, random location, random per-coordinate
    # scales, random correlation; dense-metric warmup
    rng = np.random.RandomState(seed)
    k = int(rng.randint(3, 11))
    a = rng.randn(k, k + 2)
    s = a @ a.T
    corr = s / np.sqrt(np.outer(np.diag(s), np.diag(s)))
    d = np.abs(rng.randn(k)) + 0.05
    cov = corr * np.outer(d, d)
    model = mvnormal(rng.randn(k), cov, **CPU)
    run_and_check(
        model,
        1000 + seed,
        f"correlated mvn seed={seed}",
        warmup_stages=default_warmup_stages(metric_kind="dense"),
    )


@pytest.mark.slow
@pytest.mark.parametrize(
    "dim,condition,seed,key",
    [
        # sample-correctness_tests.jl:25-46 pins THREE ill-conditioned MVNs;
        # pinned equivalents: geometric eigenvalue spectra at the same dims
        (4, 1e4, 7, 200),
        (9, 1e6, 11, 210),
        (10, 1e7, 13, 220),
    ],
)
def test_ill_conditioned_mvn(dim, condition, seed, key):
    model = ill_conditioned_gaussian(dim, condition_number=condition,
                                     seed=seed, **CPU)
    run_and_check(
        model,
        key,
        f"ill-conditioned mvn dim={dim} cond={condition:g}",
        warmup_stages=default_warmup_stages(metric_kind="dense"),
    )


def _bench_mvn():
    """The 8-dim correlated MVN of the bench-kernel gate (seed 42)."""
    rng = np.random.RandomState(42)
    k = 8
    a = rng.randn(k, k + 2)
    s = a @ a.T
    corr = s / np.sqrt(np.outer(np.diag(s), np.diag(s)))
    d = np.abs(rng.randn(k)) + 0.05
    cov = corr * np.outer(d, d)
    return mvnormal(rng.randn(k), cov, **CPU)


@pytest.mark.slow
def test_bench_kernel_semantics():
    # the bench's depth-capped kernel (max_depth=4, warmup clamp 2 / tail
    # 25) pinned to the full acceptance protocol on a correlated MVN
    run_and_check(
        _bench_mvn(),
        4040,
        "bench kernel semantics (max_depth=4, clamp 2/25)",
        warmup_stages=default_warmup_stages(metric_kind="dense"),
        algorithm=NUTS(max_depth=4),
        warmup_depth_clamp=2,
        warmup_depth_clamp_tail=25,
    )


@pytest.mark.slow
def test_bench_kernel_semantics_bench_dim():
    # the EXACT bench configuration on the bench's own target construction
    # at 64 dims; the JAX file found the pooling load-bearing (a per-chain
    # 64x64 metric at 5 chains fails R-hat at 1.21)
    bench_dim_gate(correlated_gaussian(64, dtype=F64, **CPU))


@pytest.mark.slow
def test_specific_normals():
    # sample-correctness_tests.jl:53-87: univariate huge/tiny variances
    # and a mildly scaled diagonal
    for label, mean, cov, key in SPECIFIC_NORMALS:
        specific_normal_gate(label, mean, cov, key, dtype=F64, **CPU)


@pytest.mark.slow
def test_extreme_variances():
    # sample-correctness_tests.jl:48-87: variances 1e+-8
    run_and_check(
        extreme_variance_gaussian(2, log10_range=8.0, **CPU),
        300,
        "extreme variances",
        warmup_stages=default_warmup_stages(metric_kind="diagonal"),
    )


@pytest.mark.slow
def test_two_normal_mixture():
    # sample-correctness_tests.jl:89-98, thresholds relaxed as in reference
    model = mixture(
        0.7,
        mvnormal(np.zeros(2), np.eye(2), **CPU),
        mvnormal(np.full(2, 3.0), np.eye(2) * 2.0, **CPU),
    )
    run_and_check(
        model,
        400,
        "two-normal mixture",
        n_samples=4000,
        thresholds=Thresholds(tau_alert=0.3, tau_fail=0.1, ad_fail=1e-3),
    )


@pytest.mark.slow
def test_heavy_tails_elongated():
    # sample-correctness_tests.jl:100-106: elongate(1.1)-style heavy tails
    run_and_check(
        elongate(0.1, std_normal(3, **CPU)),
        500,
        "elongated std normal",
        thresholds=Thresholds(
            tau_alert=0.3, tau_fail=0.1, ebfmi_alert=0.2, ad_fail=5e-3
        ),
    )


FUNNEL_MIXTURE_THRESHOLDS = Thresholds(
    rhat_fail=1.05,
    tau_alert=0.1,
    tau_fail=0.03,
    ebfmi_alert=0.2,
    ebfmi_fail=0.1,
    ad_fail=1e-3,
)


def _funnel_normal_mixture():
    k = 3
    return mixture(0.5, mvnormal(np.zeros(k), np.eye(k) * 4.0, **CPU),
                   funnel(k, sigma_v=1.5, **CPU))


@pytest.mark.slow
def test_funnel_normal_mixture():
    # sample-correctness_tests.jl:108-118: funnel mixed with a normal,
    # relaxed thresholds
    run_and_check(
        _funnel_normal_mixture(),
        600,
        "funnel-normal mixture",
        n_samples=4000,
        thresholds=FUNNEL_MIXTURE_THRESHOLDS,
    )


@pytest.mark.slow
def test_funnel_bench_kernel_semantics():
    # the funnel bench configuration (max_depth=7, clamp 2/25) on the
    # funnel-normal mixture. The mixture has no tree kernel in either
    # package, so this gates the configuration, not the funnel kernel.
    run_and_check(
        _funnel_normal_mixture(),
        600,
        "funnel-normal mixture (bench kernel: max_depth=7, clamp 2/25)",
        n_samples=4000,
        algorithm=NUTS(max_depth=7),
        warmup_depth_clamp=2,
        warmup_depth_clamp_tail=25,
        thresholds=FUNNEL_MIXTURE_THRESHOLDS,
    )


@pytest.mark.slow
def test_funnel_diagnostics():
    # BASELINE config 4: the funnel's divergences and EBFMI surface in the
    # diagnostics
    res = run_chains(torch.Generator().manual_seed(700), funnel(5, **CPU),
                     n_chains=4, n_samples=2000, dtype=F64)
    summary = summarize_tree_statistics(res.tree_statistics)
    ebfmi = EBFMI(res.tree_statistics).numpy()
    divergences = summary.termination_counts["divergence"]
    assert divergences > 0 or ebfmi.min() < 1.0
    assert summary.N == 4 * 2000


# --- tests/test_models.py's model-family runs ------------------------------


@pytest.mark.slow
def test_eight_schools_noncentered_samples_cleanly():
    res = mcmc_with_warmup(torch.Generator().manual_seed(0),
                           eight_schools_noncentered(**CPU), 4000, dtype=F64)
    stats = res.tree_statistics
    div_rate = float(stats.is_divergent.double().mean())
    assert div_rate < 0.02, div_rate
    mu = res.positions[:, 0].numpy()
    # canonical posterior: mu around ~4.4, wide
    assert 1.0 < mu.mean() < 8.0
    assert float(EBFMI(stats)) > 0.3


@pytest.mark.slow
def test_eight_schools_centered_shows_pathology():
    res = mcmc_with_warmup(torch.Generator().manual_seed(1),
                           eight_schools_centered(**CPU), 4000, dtype=F64)
    summary = summarize_tree_statistics(res.tree_statistics)
    # the centered funnel geometry must be VISIBLE in the diagnostics:
    # divergences, or depth saturation, or low EBFMI
    ebfmi = float(EBFMI(res.tree_statistics))
    assert (summary.termination_counts["divergence"] > 0
            or summary.termination_counts["max_depth"] > 0
            or ebfmi < 0.5)


@pytest.mark.slow
def test_logistic_regression_posterior():
    # BASELINE config 3: autograd through the likelihood matmul
    res = mcmc_with_warmup(torch.Generator().manual_seed(2),
                           logistic_regression(n_obs=300, dim=8, seed=1, **CPU),
                           3000, dtype=F64)
    qs = res.positions.numpy()
    assert np.isfinite(qs).all()
    assert float(res.tree_statistics.acceptance_rate.mean()) > 0.7
    # posterior concentrates: std well below the prior scale 10
    assert qs.std(0).max() < 2.0


@pytest.mark.slow
def test_rosenbrock_runs():
    res = mcmc_with_warmup(torch.Generator().manual_seed(3),
                           rosenbrock(4, **CPU), 3000, dtype=F64)
    qs = res.positions.numpy()
    assert np.isfinite(qs).all()
    # banana: y ~ b*x^2 => strong curvature; check E[y - 5x^2] ~ 0
    x, y = qs[:, 0], qs[:, 1]
    assert abs((y - 5 * x**2).mean()) < 0.2


def test_elongate_preserves_normalization():
    """A change of variables preserves the normalization constant exactly,
    so elongated targets stay usable as mixture components (the reference's
    elongate-then-mix workload, sample-correctness_tests.jl:100-118)."""
    base = std_normal(2, **CPU)
    el = elongate(1.1, base)
    assert el.log_normalization == base.log_normalization
    mix = mixture(0.5, el, std_normal(2, **CPU))
    v = float(mix.logdensity_fn(torch.tensor([0.5, -0.3], dtype=F64)))
    assert np.isfinite(v)
    # exact samplers compose: the mixture draws from both components
    draws = mix.sample(torch.Generator().manual_seed(0), 4000).numpy()
    assert np.isfinite(draws).all()
    np.testing.assert_allclose(draws.mean(0), [0.0, 0.0], atol=0.1)
