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


def test_logreg_auto_dispatch_is_not_ported():
    for kw in ({"fused": "auto"}, {"tree_kernel": "auto"}):
        with pytest.raises(NotImplementedError, match="auto"):
            tm.logistic_regression(20, 3, device="cpu", **kw)
