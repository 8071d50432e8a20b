"""Port parity: Gaussian models of dynamichmc_tpu_torch against the JAX
package's, value and gradient at float64 (rtol 1e-12: both evaluate the
same f64 matrices with the same whitened formula; only the summation order
differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import models as jm
from dynamichmc_tpu_torch import models as tm

RTOL = 1e-12


def _value_and_grad_jax(model, q):
    vals, grads = [], []
    for row in q:
        v, g = model.logdensity_and_gradient(jnp.asarray(row))
        vals.append(float(v))
        grads.append(np.asarray(g))
    return np.array(vals), np.stack(grads)


def _pair(name, K):
    if name == "correlated":
        return (jm.correlated_gaussian(K, dtype=jnp.float64),
                tm.correlated_gaussian(K, dtype=torch.float64, device="cpu"))
    if name == "correlated_unrotated":
        return (jm.correlated_gaussian(K, rho=0.5, random_rotation=False,
                                       seed=3, dtype=jnp.float64),
                tm.correlated_gaussian(K, rho=0.5, random_rotation=False,
                                       seed=3, dtype=torch.float64, device="cpu"))
    if name == "mvnormal":
        rng = np.random.default_rng(7)
        a = rng.normal(size=(K, K))
        cov = a @ a.T + K * np.eye(K)
        mean = rng.normal(size=K)
        return (jm.mvnormal(jnp.asarray(mean), cov),
                tm.mvnormal(mean, cov, dtype=torch.float64, device="cpu"))
    return jm.std_normal(K), tm.std_normal(K, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", ["correlated", "correlated_unrotated",
                                  "mvnormal", "std_normal"])
@pytest.mark.parametrize("K", [3, 5])
def test_value_and_gradient_match_jax(name, K):
    jmodel, tmodel = _pair(name, K)
    q = np.random.default_rng(K).normal(size=(6, K)) * 1.5
    vj, gj = _value_and_grad_jax(jmodel, q)
    vt, gt = tmodel.logdensity_and_gradient(torch.as_tensor(q))
    np.testing.assert_allclose(vt.numpy(), vj, rtol=RTOL)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL, atol=1e-14)
    # the value-only path agrees with the fused one
    np.testing.assert_allclose(
        tmodel.logdensity(torch.as_tensor(q)).numpy(), vj, rtol=RTOL
    )


def test_correlated_gaussian_same_matrices_from_seed():
    jmodel = jm.correlated_gaussian(5, seed=11)
    tmodel = tm.correlated_gaussian(5, seed=11, device="cpu")
    np.testing.assert_array_equal(np.asarray(jmodel.cov_fn()),
                                  tmodel.cov_fn().numpy())
    np.testing.assert_array_equal(np.asarray(jmodel.mean_fn()),
                                  tmodel.mean_fn().numpy())
    assert tmodel.log_normalization == pytest.approx(
        jmodel.log_normalization, rel=1e-14
    )


def test_autograd_gradient_matches_fused():
    from dynamichmc_tpu_torch.logdensity import LogDensity

    tmodel = tm.correlated_gaussian(4, dtype=torch.float64, device="cpu")
    plain = LogDensity(dim=4, logdensity_fn=tmodel.logdensity_fn)
    q = torch.as_tensor(np.random.default_rng(1).normal(size=(5, 4)))
    v1, g1 = plain.logdensity_and_gradient(q)
    v2, g2 = tmodel.logdensity_and_gradient(q)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=RTOL)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-10)


def test_exact_sampler_moments():
    tmodel = tm.correlated_gaussian(3, dtype=torch.float64, device="cpu")
    x = tmodel.sample(torch.Generator().manual_seed(0), 200_000).numpy()
    cov = tmodel.cov_fn().numpy()
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.03 * np.abs(cov).max())


@pytest.mark.parametrize("K,sigma_v", [(5, 3.0), (25, 1.5)])
def test_funnel_value_and_gradient_match_jax(K, sigma_v):
    from dynamichmc_tpu_torch import convert

    jmodel = jm.funnel(K, sigma_v=sigma_v, dtype=jnp.float64)
    tmodel = convert.funnel_model(jmodel, device="cpu")
    rng = np.random.default_rng(K)
    v = rng.uniform(-4, 4, size=(6, 1))
    q = np.concatenate([v, np.exp(v / 2) * rng.normal(size=(6, K - 1))], 1)
    vj, gj = _value_and_grad_jax(jmodel, q)
    vt, gt = tmodel.logdensity_and_gradient(torch.as_tensor(q))
    np.testing.assert_allclose(vt.numpy(), vj, rtol=RTOL)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL, atol=1e-12)
    assert tmodel.log_normalization == pytest.approx(
        jmodel.log_normalization, rel=1e-14)
    # the tree kernel's analytic leaf agrees with autograd
    leaf = tm.funnel(K, sigma_v=sigma_v, tree_kernel=True,
                     device="cpu").tree_transition_fn.leaf
    va, ga = leaf.value_and_grad(torch.as_tensor(q))
    np.testing.assert_allclose(va.numpy(), vj, rtol=1e-12)
    np.testing.assert_allclose(ga.numpy(), gj, rtol=1e-10, atol=1e-10)


def test_funnel_exact_sampler():
    x = tm.funnel(4, dtype=torch.float64, device="cpu").sample(
        torch.Generator().manual_seed(0), 200_000).numpy()
    assert abs(x[:, 0].mean()) < 0.03 and abs(x[:, 0].std() - 3.0) < 0.03
    # x_i | v ~ N(0, e^v): x_i e^{-v/2} is standard normal
    z = x[:, 1:] * np.exp(-x[:, :1] / 2)
    assert abs(z.std() - 1.0) < 0.01


@pytest.mark.parametrize("n_obs,K,seed", [(53, 7, 0), (400, 25, 3)])
def test_logreg_value_and_gradient_match_jax(n_obs, K, seed):
    from dynamichmc_tpu_torch import convert

    jmodel = jm.logistic_regression(n_obs, K, seed=seed, dtype=jnp.float64)
    tmodel = tm.logistic_regression(n_obs, K, seed=seed, device="cpu")
    # the same data from the seed, and through convert from the JAX model
    x, y, prior_scale = convert.logreg_data(jmodel)
    np.testing.assert_array_equal(
        x, tm.logreg.synthetic_data(n_obs, K, seed)[0])
    assert prior_scale == 10.0
    q = np.random.default_rng(seed).normal(size=(6, K)) * 0.5
    vj, gj = _value_and_grad_jax(jmodel, q)
    for model in (tmodel, convert.logreg_model(jmodel, device="cpu")):
        vt, gt = model.logdensity_and_gradient(torch.as_tensor(q))
        np.testing.assert_allclose(vt.numpy(), vj, rtol=RTOL)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-10, atol=1e-10)
    # the kernels' analytic leaves (stable softplus, tanh sigmoid) agree
    leaf = tm.logistic_regression(n_obs, K, seed=seed, tree_kernel=True,
                                  device="cpu").tree_transition_fn.leaf
    va, ga = leaf.value_and_grad(torch.as_tensor(q, dtype=torch.float32))
    np.testing.assert_allclose(va.numpy(), vj, rtol=1e-5)
    np.testing.assert_allclose(ga.numpy(), gj, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n_obs,K", [(20, 3), (16000, 512), (1, 1201)])
def test_logreg_auto_attaches_the_measured_route(n_obs, K):
    """``"auto"`` no longer raises: each hook is attached exactly where
    the port's measured rule says it pays (ops/logreg_leaf.fused_leaf_pays,
    ops/tree_kernel.tree_kernel_pays), the same data either way."""
    from dynamichmc_tpu_torch.ops.logreg_leaf import fused_leaf_pays
    from dynamichmc_tpu_torch.ops.tree_kernel import tree_kernel_pays

    plain = tm.logistic_regression(n_obs, K, device="cpu")
    fused = tm.logistic_regression(n_obs, K, device="cpu", fused="auto")
    assert (fused.fused_leaf_batched_fn is not None) == fused_leaf_pays(n_obs, K)
    assert fused.tree_transition_fn is None
    tree = tm.logistic_regression(n_obs, K, device="cpu", tree_kernel="auto")
    assert (tree.tree_transition_fn is not None) == tree_kernel_pays(n_obs, K)
    assert tree.fused_leaf_batched_fn is None
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(2, K)))
    for model in (fused, tree):
        for a, b in zip(model.logdensity_and_gradient(q),
                        plain.logdensity_and_gradient(q)):
            assert torch.equal(a, b)


def _protocol_pair(name):
    """The models of the statistical protocol, built alike in both
    packages (the Gaussians from the same numpy seeds)."""
    cpu = {"device": "cpu"}
    if name == "ill_conditioned_4":
        return (jm.ill_conditioned_gaussian(4, condition_number=1e4, seed=7),
                tm.ill_conditioned_gaussian(4, condition_number=1e4, seed=7,
                                            **cpu))
    if name == "ill_conditioned_9":
        return (jm.ill_conditioned_gaussian(9, condition_number=1e6, seed=11),
                tm.ill_conditioned_gaussian(9, condition_number=1e6, seed=11,
                                            **cpu))
    if name == "extreme_variance":
        return (jm.extreme_variance_gaussian(2, log10_range=8.0),
                tm.extreme_variance_gaussian(2, log10_range=8.0, **cpu))
    if name == "two_normal_mixture":
        return (jm.mixture(0.7, jm.mvnormal(np.zeros(2), np.eye(2)),
                           jm.mvnormal(np.full(2, 3.0), np.eye(2) * 2.0)),
                tm.mixture(0.7, tm.mvnormal(np.zeros(2), np.eye(2), **cpu),
                           tm.mvnormal(np.full(2, 3.0), np.eye(2) * 2.0,
                                       **cpu)))
    if name == "funnel_normal_mixture":
        return (jm.mixture(0.5, jm.mvnormal(np.zeros(3), np.eye(3) * 4.0),
                           jm.funnel(3, sigma_v=1.5)),
                tm.mixture(0.5, tm.mvnormal(np.zeros(3), np.eye(3) * 4.0,
                                            **cpu),
                           tm.funnel(3, sigma_v=1.5, **cpu)))
    if name == "elongated_normal":
        return (jm.elongate(0.1, jm.std_normal(3)),
                tm.elongate(0.1, tm.std_normal(3, **cpu)))
    if name == "elongated_mixture":
        return (jm.mixture(0.5, jm.elongate(1.1, jm.std_normal(2)),
                           jm.std_normal(2)),
                tm.mixture(0.5, tm.elongate(1.1, tm.std_normal(2, **cpu)),
                           tm.std_normal(2, **cpu)))
    if name == "eight_schools_noncentered":
        return jm.eight_schools_noncentered(), tm.eight_schools_noncentered(**cpu)
    if name == "eight_schools_centered":
        return jm.eight_schools_centered(), tm.eight_schools_centered(**cpu)
    return jm.rosenbrock(4), tm.rosenbrock(4, **cpu)


PROTOCOL_MODELS = ["ill_conditioned_4", "ill_conditioned_9",
                   "extreme_variance", "two_normal_mixture",
                   "funnel_normal_mixture", "elongated_normal",
                   "elongated_mixture", "eight_schools_noncentered",
                   "eight_schools_centered", "rosenbrock"]


@pytest.mark.parametrize("name", PROTOCOL_MODELS)
def test_protocol_model_value_and_gradient_match_jax(name):
    """Value and gradient on a batch of points at float64 (rtol 1e-12), and
    the same log_normalization; the port's models take (..., dim)."""
    jmodel, tmodel = _protocol_pair(name)
    K = jmodel.dim
    assert tmodel.dim == K
    rng = np.random.default_rng(len(name))
    q = rng.normal(size=(6, K)) * 1.5
    if name == "extreme_variance":
        q *= np.sqrt(np.geomspace(1e-8, 1e8, 2))
    vj, gj = _value_and_grad_jax(jmodel, q)
    vt, gt = tmodel.logdensity_and_gradient(torch.as_tensor(q))
    assert tuple(vt.shape) == (6,) and tuple(gt.shape) == (6, K)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=RTOL)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL,
                               atol=1e-12 * np.abs(gj).max())
    # one point without a batch axis
    assert float(tmodel.logdensity(torch.as_tensor(q[0]))) == pytest.approx(
        vj[0], rel=RTOL)
    if jmodel.log_normalization is None:
        assert tmodel.log_normalization is None
    else:
        assert tmodel.log_normalization == pytest.approx(
            jmodel.log_normalization, rel=1e-14)
    assert tmodel.has_exact_sampler == jmodel.has_exact_sampler


@pytest.mark.parametrize("name,factory,kwargs", [
    ("ill_conditioned_4", tm.ill_conditioned_gaussian,
     {"dim": 4, "condition_number": 1e4, "seed": 7}),
    ("ill_conditioned_9", tm.ill_conditioned_gaussian,
     {"dim": 9, "condition_number": 1e6, "seed": 11}),
    ("extreme_variance", tm.extreme_variance_gaussian,
     {"dim": 2, "log10_range": 8.0}),
])
def test_protocol_gaussians_same_matrices_and_hooks(name, factory, kwargs):
    """The same covariance as the JAX model's, bit for bit, with and
    without the kernels' hooks attached."""
    jmodel, tmodel = _protocol_pair(name)
    np.testing.assert_array_equal(np.asarray(jmodel.cov_fn()),
                                  tmodel.cov_fn().numpy())
    hooked = factory(device="cpu", fused=True, tree_kernel=True, **kwargs)
    assert hooked.fused_leaf_batched_fn is not None
    assert hooked.fused_leapfrog_fn is not None
    assert hooked.tree_transition_fn is not None
    np.testing.assert_array_equal(hooked.cov_fn().numpy(),
                                  tmodel.cov_fn().numpy())


def test_mixture_errors_match_jax():
    def both(make):
        with pytest.raises(ValueError) as jerr:
            make(jm, {})
        with pytest.raises(ValueError) as terr:
            make(tm, {"device": "cpu"})
        assert str(terr.value) == str(jerr.value)

    both(lambda m, kw: m.mixture(0.5, m.std_normal(2, **kw),
                                 m.std_normal(3, **kw)))
    for weight in (0.0, 1.0, 1.5, -0.2):
        both(lambda m, kw: m.mixture(weight, m.std_normal(2, **kw),
                                     m.std_normal(2, **kw)))
    both(lambda m, kw: m.mixture(0.5, m.rosenbrock(2, **kw),
                                 m.std_normal(2, **kw)))
    both(lambda m, kw: m.mixture(0.5, m.std_normal(10, **kw),
                                 m.eight_schools_centered(**kw)))
    both(lambda m, kw: m.elongate(-1.0, m.std_normal(2, **kw)))
    both(lambda m, kw: m.rosenbrock(3, **kw))


def test_protocol_exact_samplers_moments():
    """Moments of 200,000 exact draws against the known ones, to Monte
    Carlo tolerance (about 5 standard errors)."""
    from scipy.special import gamma

    gen = torch.Generator().manual_seed(0)
    n = 200_000
    _, mix = _protocol_pair("two_normal_mixture")
    x = mix.sample(gen, n).numpy()
    # 0.7 N(0, I) + 0.3 N(3, 2 I): mean 0.9, var 0.7 + 0.6 + 0.21 * 9
    np.testing.assert_allclose(x.mean(0), 0.9, atol=0.02)
    np.testing.assert_allclose(x.var(0), 3.19, rtol=0.02)
    _, el = _protocol_pair("elongated_normal")
    y = el.sample(gen, n).numpy()
    # E|Y|^2 = E|X|^2.2 = 2^1.1 Gamma(1.6) / sqrt(pi) for X ~ N(0, 1)
    np.testing.assert_allclose(y.mean(0), 0.0, atol=0.02)
    np.testing.assert_allclose((y * y).mean(0),
                               2**1.1 * gamma(1.6) / np.sqrt(np.pi), rtol=0.02)
    for name in ("ill_conditioned_4", "extreme_variance"):
        _, g = _protocol_pair(name)
        z = g.sample(gen, n).numpy()
        cov = g.cov_fn().numpy()
        # whitened draws are N(0, I)
        w = z @ np.linalg.inv(np.linalg.cholesky(cov)).T
        np.testing.assert_allclose(np.cov(w.T), np.eye(g.dim), atol=0.02)
        np.testing.assert_allclose(w.mean(0), 0.0, atol=0.02)
    _, fmix = _protocol_pair("funnel_normal_mixture")
    f = fmix.sample(gen, n).numpy()
    # v: 0.5 N(0, 4) + 0.5 N(0, 1.5^2)
    np.testing.assert_allclose(f[:, 0].var(), 0.5 * 4.0 + 0.5 * 2.25,
                               rtol=0.02)
    for name in ("eight_schools_noncentered", "rosenbrock"):
        with pytest.raises(NotImplementedError):
            _protocol_pair(name)[1].sample(gen, 2)
