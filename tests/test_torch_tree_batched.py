"""Port parity: the plain batched driver (dynamichmc_tpu_torch.tree_batched)
against dynamichmc_tpu.tree_batched.sample_tree_batched with the same
injected momenta, direction bits and TreeNoise, at float64.

Floats agree to atol 1e-10 (same algorithm, same f64 inputs; only the
summation order of the matmuls and dots differs) and the discrete
statistics exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import models as jm
from dynamichmc_tpu.hamiltonian import EvaluatedPoint as JEvaluatedPoint
from dynamichmc_tpu.metric import dense_metric as j_dense
from dynamichmc_tpu.metric import diagonal_metric as j_diag
from dynamichmc_tpu.nuts import NUTS as JNUTS
from dynamichmc_tpu.tree import TreeNoise as JTreeNoise
from dynamichmc_tpu.tree_batched import _evaluate_b
from dynamichmc_tpu.tree_batched import sample_tree_batched as j_sample
from dynamichmc_tpu_torch import convert
from dynamichmc_tpu_torch import models as tm
from dynamichmc_tpu_torch.nuts import NUTS
from dynamichmc_tpu_torch.tree import TreeNoise
from dynamichmc_tpu_torch.tree_batched import sample_tree_batched

ATOL = 1e-10
KEY = jax.random.PRNGKey(0)


def _inputs(K, C, md, seed):
    rng = np.random.default_rng(seed)
    q0 = rng.normal(size=(C, K))
    p = rng.normal(size=(C, K))
    dirs = rng.integers(0, 2**32, size=C, dtype=np.uint64).astype(np.uint32)
    gum = rng.gumbel(size=(md, 1 << (md - 1), C))
    expo = rng.exponential(size=(md, C))
    return rng, q0, p, dirs, gum, expo


def _metrics(kind, jmodel, K, C):
    cov = np.asarray(jmodel.cov_fn())
    if kind == "dense":
        return j_dense(jnp.asarray(cov))
    if kind == "diag":
        return j_diag(jnp.asarray(np.linspace(0.5, 2.0, K)))
    if kind == "per_chain_dense":
        scale = np.linspace(0.8, 1.2, C)[:, None, None]
        return jax.vmap(j_dense)(jnp.asarray(scale * cov[None]))
    raise ValueError(kind)


def _run_both(kind, K, C, md, eps, depth_limit=None, seed=0, n_steps=1):
    jmodel = jm.correlated_gaussian(K, dtype=jnp.float64)
    tmodel = tm.correlated_gaussian(K, dtype=torch.float64, device="cpu")
    rng, q0, p, dirs, gum, expo = _inputs(K, C, md, seed)
    vals, grads = _evaluate_b(jmodel, jnp.asarray(q0))
    Qj = JEvaluatedPoint(q=jnp.asarray(q0), logdensity=vals, grad=grads)
    Qt = convert.evaluated_point(Qj)
    jmetric = _metrics(kind, jmodel, K, C)
    tmetric = convert.metric(jmetric)
    eps_np = np.asarray(eps, np.float64)
    for step in range(n_steps):
        if step:
            p = rng.normal(size=(C, K))
            gum = rng.gumbel(size=gum.shape)
            expo = rng.exponential(size=expo.shape)
        a = j_sample(
            KEY, JNUTS(max_depth=md), jmodel, jmetric, Qj, jnp.asarray(eps_np),
            directions=jnp.asarray(dirs), p=jnp.asarray(p),
            noise=JTreeNoise(jnp.asarray(gum), jnp.asarray(expo)),
            depth_limit=depth_limit,
        )
        b = sample_tree_batched(
            None, NUTS(max_depth=md), tmodel, tmetric, Qt,
            torch.as_tensor(eps_np), directions=convert.tensor(dirs),
            p=torch.as_tensor(p),
            noise=TreeNoise(torch.as_tensor(gum), torch.as_tensor(expo)),
            depth_limit=depth_limit,
        )
        _assert_same(a, b)
        Qj, Qt = a[0], b[0]
    return a, b


def _assert_same(a, b, atol=ATOL, check_work=True):
    (Qa, sa), (Qb, sb) = a, b
    for x, y in ((Qa.q, Qb.q), (Qa.logdensity, Qb.logdensity),
                 (Qa.grad, Qb.grad), (sa.logdensity, sb.logdensity),
                 (sa.acceptance_rate, sb.acceptance_rate)):
        np.testing.assert_allclose(convert.to_numpy(y), np.asarray(x),
                                   atol=atol)
    names = ["depth", "steps", "term_left", "term_right", "is_divergent"]
    if check_work:
        names.append("work")
    for name in names:
        np.testing.assert_array_equal(
            convert.to_numpy(getattr(sb, name)), np.asarray(getattr(sa, name)),
            err_msg=name,
        )
    np.testing.assert_array_equal(
        convert.to_numpy(sb.directions),
        np.asarray(sa.directions).view(np.int32),
    )


def test_plain_driver_matches_jax_dense_chained():
    _run_both("dense", K=3, C=10, md=4, eps=0.3, n_steps=3)


def test_plain_driver_matches_jax_diagonal():
    _run_both("diag", K=5, C=7, md=4, eps=0.25, seed=3)


def test_plain_driver_matches_jax_per_chain_eps():
    eps = np.random.default_rng(2).uniform(0.1, 0.5, size=9)
    _run_both("dense", K=4, C=9, md=5, eps=eps, seed=5)


def test_plain_driver_matches_jax_per_chain_dense_metric():
    _run_both("per_chain_dense", K=3, C=8, md=4, eps=0.3, seed=6)


@pytest.mark.parametrize("depth_limit", [2, 3, 0])
def test_plain_driver_matches_jax_depth_limit(depth_limit):
    _a, b = _run_both("dense", K=3, C=16, md=6, eps=0.2, seed=1,
                      depth_limit=depth_limit)
    if depth_limit:
        assert int(b[1].depth.max()) <= depth_limit


def test_plain_driver_matches_jax_divergent():
    # a huge stepsize diverges: -inf poisoning and the InvalidTree
    # encodings must agree
    _a, b = _run_both("dense", K=3, C=12, md=4, eps=40.0, seed=4)
    assert bool(b[1].is_divergent.any())
