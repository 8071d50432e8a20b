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
                tm.correlated_gaussian(K, dtype=torch.float64))
    if name == "correlated_unrotated":
        return (jm.correlated_gaussian(K, rho=0.5, random_rotation=False,
                                       seed=3, dtype=jnp.float64),
                tm.correlated_gaussian(K, rho=0.5, random_rotation=False,
                                       seed=3, dtype=torch.float64))
    if name == "mvnormal":
        rng = np.random.default_rng(7)
        a = rng.normal(size=(K, K))
        cov = a @ a.T + K * np.eye(K)
        mean = rng.normal(size=K)
        return (jm.mvnormal(jnp.asarray(mean), cov),
                tm.mvnormal(mean, cov, dtype=torch.float64))
    return jm.std_normal(K), tm.std_normal(K, dtype=torch.float64)


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
    tmodel = tm.correlated_gaussian(5, seed=11)
    np.testing.assert_array_equal(np.asarray(jmodel.cov_fn()),
                                  tmodel.cov_fn().numpy())
    np.testing.assert_array_equal(np.asarray(jmodel.mean_fn()),
                                  tmodel.mean_fn().numpy())
    assert tmodel.log_normalization == pytest.approx(
        jmodel.log_normalization, rel=1e-14
    )


def test_autograd_gradient_matches_fused():
    from dynamichmc_tpu_torch.logdensity import LogDensity

    tmodel = tm.correlated_gaussian(4, dtype=torch.float64)
    plain = LogDensity(dim=4, logdensity_fn=tmodel.logdensity_fn)
    q = torch.as_tensor(np.random.default_rng(1).normal(size=(5, 4)))
    v1, g1 = plain.logdensity_and_gradient(q)
    v2, g2 = tmodel.logdensity_and_gradient(q)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=RTOL)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-10)


def test_exact_sampler_moments():
    tmodel = tm.correlated_gaussian(3, dtype=torch.float64)
    x = tmodel.sample(torch.Generator().manual_seed(0), 200_000).numpy()
    cov = tmodel.cov_fn().numpy()
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.03 * np.abs(cov).max())
