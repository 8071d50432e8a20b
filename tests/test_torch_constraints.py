"""The port's constrained-parameter transforms against the JAX package.

- Each transform (the JAX test's cases, tests/test_constraints.py) and a
  stack: forward, log|J| and inverse on the same float64 rows equal JAX's
  (``jax.vmap`` over the rows) within 1e-12 relative.
- ``transformed_logdensity``: value and autograd gradient equal JAX's value
  and ``jax.grad`` within 1e-12.
- log|J| equals the log-determinant of the autograd Jacobian, as in the JAX
  test; ``constrain_draws`` on (N, K) and (C, N, K); the length errors.
- Sampling: Gamma(3, 2) through ``positive`` with ``run_chains`` at float64
  (cheap); the JAX file's two sampling tests, Gamma and Dirichlet through
  ``mcmc_with_warmup``, under ``slow``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import constraints as jc
from dynamichmc_tpu_torch import mcmc_with_warmup, run_chains
from dynamichmc_tpu_torch import constraints as tc
from dynamichmc_tpu_torch.warmup import default_warmup_stages

F64 = torch.float64
RTOL = 1e-12

# (name, port transform, JAX transform, the JAX test's input)
CASES = [
    ("identity", tc.identity(3), jc.identity(3), [0.3, -1.0, 2.0]),
    ("positive", tc.positive(2), jc.positive(2), [0.5, -1.5]),
    ("bounded", tc.bounded(-2.0, 5.0, 2), jc.bounded(-2.0, 5.0, 2),
     [0.7, -0.3]),
    ("simplex", tc.simplex(4), jc.simplex(4), [0.2, -0.5, 1.0]),
    ("stack", tc.as_stack([tc.positive(1), tc.bounded(0, 1, 2),
                           tc.identity(2), tc.simplex(3)]),
     jc.as_stack([jc.positive(1), jc.bounded(0, 1, 2), jc.identity(2),
                  jc.simplex(3)]),
     [0.1, -0.2, 0.3, 1.0, -1.0, 0.4, -0.6]),
]


def _rows(x, n=6, seed=0):
    """The case's input and ``n`` more rows of N(0, 1.5^2), float64."""
    x = np.asarray(x, np.float64)
    more = 1.5 * np.random.default_rng(seed).normal(size=(n, x.size))
    return np.vstack([x, more])


def _jax_forward(t):
    if isinstance(t, jc.TransformStack):
        return t.forward_with_logdet
    return t.forward


def _port_forward(t):
    if isinstance(t, tc.TransformStack):
        return t.forward_with_logdet
    return t.forward


@pytest.mark.parametrize("name,t,jt,x", CASES, ids=[c[0] for c in CASES])
def test_forward_logdet_inverse_match_jax(name, t, jt, x):
    rows = _rows(x)
    y, log_j = _port_forward(t)(torch.tensor(rows, dtype=F64))
    jy, jlog_j = jax.vmap(_jax_forward(jt))(jnp.asarray(rows))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL)
    np.testing.assert_allclose(log_j.numpy(), np.asarray(jlog_j), rtol=RTOL)
    assert y.shape == (len(rows), t.output_dim) and log_j.shape == (len(rows),)
    back = t.inverse(y)
    jback = jax.vmap(jt.inverse)(jy)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=RTOL)
    np.testing.assert_allclose(back.numpy(), rows, rtol=1e-8)


@pytest.mark.parametrize("name,t,jt,x", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_logdet_is_the_jacobians(name, t, jt, x):
    """log|J| against autograd's Jacobian (its first n - 1 rows for the
    simplex, whose last output is determined)."""
    xt = torch.tensor(x, dtype=F64)
    _y, log_j = t.forward(xt)
    jac = torch.autograd.functional.jacobian(lambda v: t.forward(v)[0], xt)
    if jac.shape[0] == jac.shape[1] + 1:
        jac = jac[:-1]
    _sign, logdet = torch.linalg.slogdet(jac)
    np.testing.assert_allclose(float(log_j), float(logdet), rtol=1e-8)


def test_transformed_logdensity_value_and_gradient_match_jax():
    alpha = np.array([2.0, 3.0, 4.0])
    shape_, rate = 3.0, 2.0
    t = [tc.positive(1), tc.bounded(-1.0, 2.0, 1), tc.simplex(3)]
    jt = [jc.positive(1), jc.bounded(-1.0, 2.0, 1), jc.simplex(3)]
    a = torch.tensor(alpha, dtype=F64)

    def lp(y):  # Gamma(3, 2) x Uniform x Dirichlet(alpha), batched
        return ((shape_ - 1) * torch.log(y[..., 0]) - rate * y[..., 0]
                + ((a - 1) * torch.log(y[..., 2:])).sum(-1))

    def jlp(y):
        return ((shape_ - 1) * jnp.log(y[0]) - rate * y[0]
                + jnp.sum((jnp.asarray(alpha) - 1) * jnp.log(y[2:])))

    ld = tc.transformed_logdensity(lp, t)
    jld = jc.transformed_logdensity(jlp, jt)
    assert ld.dim == jld.dim == 4
    rows = _rows([0.3, -0.4, 0.2, -0.7], n=5, seed=1)
    value, grad = ld.logdensity_and_gradient(torch.tensor(rows, dtype=F64))
    jvalue = jax.vmap(jld.logdensity_fn)(jnp.asarray(rows))
    jgrad = jax.vmap(jax.grad(jld.logdensity_fn))(jnp.asarray(rows))
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=RTOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=RTOL,
                               atol=1e-14)


def test_simplex_outputs_valid():
    y, _ = tc.simplex(5).forward(torch.tensor([0.3, -1.0, 0.5, 2.0], dtype=F64))
    assert bool((y > 0).all())
    assert float(y.sum()) == pytest.approx(1.0, rel=1e-12)


def test_constrain_draws_takes_any_leading_axes():
    t = [tc.positive(1), tc.simplex(3)]
    draws = torch.tensor(np.random.default_rng(2).normal(size=(2, 5, 3)),
                         dtype=F64)
    both = tc.constrain_draws(t, draws)
    assert both.shape == (2, 5, 4)
    for c in range(2):
        torch.testing.assert_close(tc.constrain_draws(t, draws[c]), both[c],
                                   rtol=0, atol=0)
    jboth = jax.vmap(jc.as_stack([jc.positive(1), jc.simplex(3)]).forward)(
        jnp.asarray(draws.numpy().reshape(-1, 3)))
    np.testing.assert_allclose(both.numpy().reshape(-1, 4), np.asarray(jboth),
                               rtol=RTOL)
    np.testing.assert_allclose(both[..., 1:].sum(-1).numpy(), 1.0, rtol=1e-12)


def test_length_and_argument_errors():
    stack = tc.as_stack([tc.positive(1), tc.simplex(3)])
    with pytest.raises(ValueError, match="length 3, got 4"):
        stack.forward(torch.zeros(4, dtype=F64))
    with pytest.raises(ValueError, match="length 4, got 3"):
        stack.inverse(torch.zeros(3, dtype=F64))
    with pytest.raises(ValueError, match="lo < hi"):
        tc.bounded(1.0, 1.0)
    with pytest.raises(ValueError, match="n >= 2"):
        tc.simplex(1)


def _gamma():
    shape_, rate = 3.0, 2.0

    def lp(y):
        theta = y[..., 0]
        return (shape_ - 1) * torch.log(theta) - rate * theta

    return tc.transformed_logdensity(lp, [tc.positive(1)])


def _check_gamma(theta):
    assert bool((theta > 0).all())
    # Gamma(3, 2): mean 1.5, var 0.75
    assert float(theta.mean()) == pytest.approx(1.5, rel=0.05)
    assert float(theta.var()) == pytest.approx(0.75, rel=0.15)


def test_sample_constrained_gamma_run_chains():
    """Gamma(3, 2) through ``positive`` on a batch of 32 chains at float64
    (a short default-shaped warmup), held to the JAX test's tolerances."""
    res = run_chains(
        torch.Generator().manual_seed(0), _gamma(), 32, 400, dtype=F64,
        warmup_stages=default_warmup_stages(init_steps=50, middle_steps=25,
                                            doubling_stages=3,
                                            terminating_steps=50))
    theta = tc.constrain_draws([tc.positive(1)], res.positions)[..., 0]
    assert theta.shape == (32, 400)
    _check_gamma(theta)


@pytest.mark.slow
def test_sample_constrained_gamma_posterior():
    res = mcmc_with_warmup(torch.Generator().manual_seed(0), _gamma(), 8000,
                           dtype=F64)
    _check_gamma(tc.constrain_draws([tc.positive(1)], res.positions)[:, 0])


@pytest.mark.slow
def test_sample_dirichlet_posterior():
    alpha = torch.tensor([2.0, 3.0, 4.0], dtype=F64)
    ld = tc.transformed_logdensity(
        lambda y: ((alpha - 1) * torch.log(y)).sum(-1), [tc.simplex(3)])
    res = mcmc_with_warmup(torch.Generator().manual_seed(1), ld, 8000,
                           dtype=F64)
    p = tc.constrain_draws([tc.simplex(3)], res.positions)
    np.testing.assert_allclose(p.sum(1).numpy(), 1.0, rtol=1e-10)
    np.testing.assert_allclose(p.mean(0).numpy(), (alpha / alpha.sum()).numpy(),
                               rtol=0.05)
