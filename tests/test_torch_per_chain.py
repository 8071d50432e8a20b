"""The per-chain path of the port (mcmc_with_warmup) against the JAX
package.

- ``nuts.sample_tree`` with injected momenta, direction bits and TreeNoise
  against JAX ``nuts.sample_tree(..., fast=True)`` at float64, chained over
  several transitions and with a divergent one: discrete statistics exactly,
  floats to 1e-12 (same algorithm on the same f64 inputs; only summation
  orders differ).
- The per-chain driver and the batched driver of the port on the same noise
  (1e-12 and exact).
- The per-chain stepsize search with injected momenta against JAX: the same
  eps exactly (a power of two times the initial eps), l0 to 1e-12.
- ``mcmc_with_warmup`` end to end on a 3-d Gaussian, next to the JAX
  package's own run, and its error paths.
- The model factories build on CUDA unless told otherwise; the entry points
  refuse a model that lies on another device than the generator.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import models as jm
from dynamichmc_tpu.hamiltonian import PhasePoint as JPhasePoint
from dynamichmc_tpu.hamiltonian import evaluate as j_evaluate
from dynamichmc_tpu.logdensity import from_logdensity_fn as j_from_fn
from dynamichmc_tpu.mcmc import mcmc_with_warmup as j_mcmc_with_warmup
from dynamichmc_tpu.mcmc import pool_posterior_matrices as j_pool
from dynamichmc_tpu.mcmc import stack_posterior_matrices as j_stack
from dynamichmc_tpu.metric import dense_metric as j_dense
from dynamichmc_tpu.metric import diagonal_metric as j_diag
from dynamichmc_tpu.nuts import NUTS as JNUTS
from dynamichmc_tpu.nuts import sample_tree as j_sample_tree
from dynamichmc_tpu.stepsize import InitialStepsizeSearch as JSearch
from dynamichmc_tpu.stepsize import find_initial_stepsize as j_find
from dynamichmc_tpu.stepsize import local_log_acceptance_ratio as j_ratio
from dynamichmc_tpu.tree import TreeNoise as JTreeNoise
from dynamichmc_tpu.warmup import TuningNUTS as JTuning
from dynamichmc_tpu_torch import (
    DynamicHMCError,
    NUTS,
    TuningNUTS,
    convert,
    evaluate_strict,
    from_logdensity_fn,
    mcmc_with_warmup,
)
from dynamichmc_tpu_torch import models as tm
from dynamichmc_tpu_torch.engine import make_search_driver
from dynamichmc_tpu_torch.hamiltonian import evaluate
from dynamichmc_tpu_torch.mcmc import (
    pool_posterior_matrices,
    stack_posterior_matrices,
)
from dynamichmc_tpu_torch.nuts import sample_tree
from dynamichmc_tpu_torch.stats import ess_bulk
from dynamichmc_tpu_torch.stepsize import InitialStepsizeSearch
from dynamichmc_tpu_torch.tree import TreeNoise
from dynamichmc_tpu_torch.tree_batched import sample_tree_batched

ATOL = 1e-12
KEY = jax.random.PRNGKey(0)
F64 = torch.float64


def _gaussians(K, fused=False):
    return (jm.correlated_gaussian(K, dtype=jnp.float64),
            convert.gaussian_model(jm.correlated_gaussian(K, dtype=jnp.float64),
                                   device="cpu", fused=fused))


def _jmetric(kind, jmodel, K):
    if kind == "dense":
        return j_dense(jnp.asarray(np.asarray(jmodel.cov_fn())))
    return j_diag(jnp.asarray(np.linspace(0.5, 2.0, K)))


def _draws(rng, K, md):
    return (rng.normal(size=K),
            int(rng.integers(0, 2**32, dtype=np.uint64)),
            rng.gumbel(size=(md, 1 << (md - 1))),
            rng.exponential(size=md))


def _assert_same_transition(a, b):
    (Qa, sa), (Qb, sb) = a, b
    for x, y in ((Qa.q, Qb.q), (Qa.logdensity, Qb.logdensity),
                 (Qa.grad, Qb.grad), (sa.logdensity, sb.logdensity),
                 (sa.acceptance_rate, sb.acceptance_rate)):
        np.testing.assert_allclose(convert.to_numpy(y), np.asarray(x),
                                   atol=ATOL)
    for name in ("depth", "steps", "term_left", "term_right", "is_divergent"):
        np.testing.assert_array_equal(convert.to_numpy(getattr(sb, name)),
                                      np.asarray(getattr(sa, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(convert.to_numpy(sb.directions),
                                  np.asarray(sa.directions).view(np.int32))


@pytest.mark.parametrize("kind,fused,md", [
    ("diag", False, 5), ("dense", False, 4), ("diag", True, 6),
])
def test_sample_tree_matches_jax_chained(kind, fused, md):
    """Six transitions chained from one start, the fifth with eps = 40
    (divergent), the others eps = 0.35. ``fused=True`` takes the fused
    leapfrog hook (its plain float64 math) in both packages."""
    K = 4
    jmodel, tmodel = _gaussians(K, fused)
    if fused:
        jmodel = jm.mvnormal(jnp.asarray(np.asarray(jmodel.mean_fn())),
                             np.asarray(jmodel.cov_fn()), fused=True)
    jmetric = _jmetric(kind, jmodel, K)
    tmetric = convert.metric(jmetric)
    algorithm, jalgorithm = NUTS(max_depth=md), JNUTS(max_depth=md)

    @jax.jit
    def j_step(Q, p, dirs, gum, expo, eps):
        return j_sample_tree(KEY, jalgorithm, jmodel, jmetric, Q, eps, p=p,
                             directions=dirs, noise=JTreeNoise(gum, expo))

    rng = np.random.default_rng(7)
    Qj = j_evaluate(jmodel, jnp.asarray(rng.normal(size=K)))
    Qt = convert.evaluated_point(Qj)
    divergent = 0
    for step in range(6):
        eps = 40.0 if step == 4 else 0.35
        p, dirs, gum, expo = _draws(rng, K, md)
        a = j_step(Qj, jnp.asarray(p), jnp.asarray(dirs, jnp.uint32),
                   jnp.asarray(gum), jnp.asarray(expo), jnp.float64(eps))
        b = sample_tree(None, algorithm, tmodel, tmetric, Qt,
                        torch.tensor(eps, dtype=F64), p=torch.as_tensor(p),
                        directions=dirs,
                        noise=TreeNoise(torch.as_tensor(gum),
                                        torch.as_tensor(expo)))
        _assert_same_transition(a, b)
        divergent += int(b[1].is_divergent)
        Qj, Qt = a[0], b[0]
    assert divergent >= 1


def test_per_chain_and_batched_drivers_agree():
    """sample_tree on each chain and sample_tree_batched on the batch, with
    the same momenta, direction bits, per-chain eps and noise."""
    K, C, md = 3, 6, 5
    _jmodel, tmodel = _gaussians(K)
    rng = np.random.default_rng(11)
    q0 = torch.as_tensor(rng.normal(size=(C, K)))
    p = torch.as_tensor(rng.normal(size=(C, K)))
    dirs = rng.integers(0, 2**32, size=C, dtype=np.uint64)
    gum = torch.as_tensor(rng.gumbel(size=(md, 1 << (md - 1), C)))
    expo = torch.as_tensor(rng.exponential(size=(md, C)))
    eps = torch.as_tensor(rng.uniform(0.2, 0.8, size=C))
    eps[2] = 30.0  # a divergent chain
    metric = convert.metric(j_diag(jnp.asarray(np.linspace(0.6, 1.6, K))))
    Qb, sb = sample_tree_batched(
        None, NUTS(max_depth=md), tmodel, metric, evaluate(tmodel, q0), eps,
        directions=convert.tensor(dirs.astype(np.uint32)), p=p,
        noise=TreeNoise(gum, expo))
    assert bool(sb.is_divergent[2])
    for c in range(C):
        Qc, sc = sample_tree(None, NUTS(max_depth=md), tmodel, metric,
                             evaluate(tmodel, q0[c]), eps[c], p=p[c],
                             directions=int(dirs[c]),
                             noise=TreeNoise(gum[..., c], expo[:, c]))
        for x, y in ((Qc.q, Qb.q[c]), (Qc.logdensity, Qb.logdensity[c]),
                     (Qc.grad, Qb.grad[c]), (sc.logdensity, sb.logdensity[c]),
                     (sc.acceptance_rate, sb.acceptance_rate[c])):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL)
        for name in ("depth", "steps", "term_left", "term_right",
                     "directions"):
            assert int(getattr(sc, name)) == int(getattr(sb, name)[c]), name


@pytest.mark.parametrize("scale", [0.05, 1.0, 30.0])
def test_stepsize_search_matches_jax(scale):
    """Injected momenta of three scales reach both the doubling and the
    halving branch; eps and success agree exactly, l0 to 1e-12."""
    K = 3
    jmodel, tmodel = _gaussians(K)
    rng = np.random.default_rng(int(scale * 100))
    q, p = rng.normal(size=K), scale * rng.normal(size=K)
    jmetric = _jmetric("diag", jmodel, K)
    Qj = j_evaluate(jmodel, jnp.asarray(q))
    A, l0_j = j_ratio(jmodel, jmetric, JPhasePoint(Q=Qj, p=jnp.asarray(p)))
    eps_j, ok_j = j_find(JSearch(), A, dtype=jnp.float64)
    eps, ok, l0 = make_search_driver(tmodel, InitialStepsizeSearch())(
        None, convert.evaluated_point(Qj), convert.metric(jmetric),
        p=torch.as_tensor(p))
    assert float(eps) == float(eps_j) and bool(ok) == bool(ok_j) is True
    assert float(l0) == pytest.approx(float(l0_j), abs=ATOL)


def test_stepsize_search_reports_no_crossing_like_jax():
    """A flat density never crosses: both packages stop after
    maxiter_crossing doublings with success False."""
    jld = j_from_fn(3, lambda q: 0.0 * jnp.sum(q))
    tld = from_logdensity_fn(3, lambda q: 0.0 * q.sum(-1))
    p = np.array([0.3, -1.0, 0.5])
    jmetric = j_diag(jnp.ones(3))
    Qj = j_evaluate(jld, jnp.zeros(3))
    A, _l0 = j_ratio(jld, jmetric, JPhasePoint(Q=Qj, p=jnp.asarray(p)))
    eps_j, ok_j = j_find(JSearch(), A, dtype=jnp.float64)
    eps, ok, _ = make_search_driver(tld, InitialStepsizeSearch())(
        None, evaluate(tld, torch.zeros(3, dtype=F64)),
        convert.metric(jmetric), p=torch.as_tensor(p))
    assert not bool(ok) and not bool(ok_j)
    assert float(eps) == float(eps_j)


def _short_stages(search, tuning):
    return (search(), tuning(N=50), tuning(N=50, metric_kind="diagonal"),
            tuning(N=100, metric_kind="diagonal"), tuning(N=30))


def _check_moments(x, mean, cov):
    """Each coordinate's mean within 5 sd / sqrt(ESS) of the truth and its
    variance within [0.6, 1.5] of it; returns (mean, sd, ESS)."""
    sd = np.sqrt(np.diag(cov))
    ess = np.array([ess_bulk(x[None, :, j]) for j in range(x.shape[1])])
    assert (np.abs(x.mean(0) - mean) <= 5 * sd / np.sqrt(ess)).all()
    ratio = x.var(0) / sd**2
    assert (ratio >= 0.6).all() and (ratio <= 1.5).all(), ratio
    return x.mean(0), x.std(0), ess


def test_mcmc_with_warmup_recovers_gaussian_like_jax():
    """A 3-d Gaussian with the fused hooks (float32, the K4 hook's plain
    version here) through the port's mcmc_with_warmup and the JAX
    package's: both recover the moments, and their means agree within 5
    combined Monte Carlo standard errors."""
    from dynamichmc_tpu_torch import hamiltonian

    N = 600
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 3))
    cov, mean = a @ a.T + np.eye(3), rng.normal(size=3)
    jres = j_mcmc_with_warmup(
        jax.random.PRNGKey(0), jm.mvnormal(jnp.asarray(mean, jnp.float32),
                                           cov, fused=True),
        N, warmup_stages=_short_stages(JSearch, JTuning))
    model = tm.mvnormal(mean, cov, dtype=torch.float32, device="cpu",
                        fused=True)
    hamiltonian.reset_leapfrog_calls()
    res = mcmc_with_warmup(torch.Generator().manual_seed(0), model, N,
                           warmup_stages=_short_stages(InitialStepsizeSearch,
                                                       TuningNUTS))
    assert res.positions.shape == (N, 3) and res.positions.dtype == torch.float32
    assert res.logdensities.shape == (N,)
    assert res.tree_statistics.depth.shape == (N,)
    assert res.metric.m_inv.shape == (3,) and res.eps.shape == ()
    # every transition's leapfrogs went through leapfrog, the fused hook
    assert hamiltonian.leapfrog_calls >= int(res.tree_statistics.steps.sum())
    acc = float(res.tree_statistics.acceptance_rate.mean())
    assert 0.6 <= acc <= 0.97, acc
    m, s, e = _check_moments(res.positions.double().numpy(), mean, cov)
    mj, sj, ej = _check_moments(np.asarray(jres.positions, np.float64), mean,
                                cov)
    mcse = np.sqrt(s**2 / e + sj**2 / ej)
    assert (np.abs(m - mj) <= 5 * mcse).all()
    # the reference's posterior-matrix orientations
    np.testing.assert_array_equal(res.posterior_matrix.numpy(),
                                  res.positions.numpy().T)
    np.testing.assert_array_equal(
        stack_posterior_matrices(res).numpy(),
        np.asarray(j_stack(
            dataclasses.replace(jres, positions=res.positions.numpy()))))
    np.testing.assert_array_equal(
        pool_posterior_matrices([res, res]).numpy(),
        np.asarray(j_pool(
            [dataclasses.replace(jres, positions=res.positions.numpy())] * 2)))


def test_mcmc_with_warmup_is_deterministic_from_the_generator():
    model = tm.std_normal(2, dtype=torch.float32, device="cpu")
    stages = (InitialStepsizeSearch(), TuningNUTS(N=20))
    a, b = (mcmc_with_warmup(torch.Generator().manual_seed(3), model, 15,
                             warmup_stages=stages) for _ in range(2))
    assert torch.equal(a.positions, b.positions) and float(a.eps) == float(b.eps)


def test_evaluate_strict_raises_with_payload():
    model = tm.std_normal(2, device="cpu")
    with pytest.raises(DynamicHMCError, match="non-finite elements") as err:
        evaluate_strict(model, torch.tensor([0.0, float("nan")], dtype=F64))
    assert "q" in err.value.payload
    bad = from_logdensity_fn(2, lambda q: torch.log(-q.sum(-1).clamp(max=0)))
    with pytest.raises(DynamicHMCError, match="Invalid log posterior") as err:
        evaluate_strict(bad, torch.tensor([1.0, 1.0], dtype=F64))
    assert float(err.value.payload["logdensity"]) == -np.inf
    grad_bad = from_logdensity_fn(2, lambda q: (q.abs() ** 0.5).sum(-1))
    with pytest.raises(DynamicHMCError, match="Gradient"):
        evaluate_strict(grad_bad, torch.zeros(2, dtype=F64))
    # the same start through the entry point
    with pytest.raises(DynamicHMCError, match="Invalid log posterior"):
        mcmc_with_warmup(torch.Generator().manual_seed(0), bad, 5,
                         initialization={"q": [1.0, 1.0]})


def test_mcmc_with_warmup_error_paths():
    model = tm.std_normal(2, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(DynamicHMCError, match="manually specified"):
        mcmc_with_warmup(gen, model, 5, initialization={"eps": 0.1})
    with pytest.raises(NotImplementedError, match="homogeneous"):
        mcmc_with_warmup(gen, model, 5, warmup_stages=(
            TuningNUTS(N=20, metric_kind="dense"),
            TuningNUTS(N=20, metric_kind="diagonal")))
    with pytest.raises(NotImplementedError, match="reporter"):
        mcmc_with_warmup(gen, model, 5, reporter=object())
    with pytest.raises(NotImplementedError, match="item 14"):
        sample_tree(gen, NUTS(), model, convert.metric(j_diag(jnp.ones(2))),
                    evaluate(model, torch.zeros(2)), 0.1, fast=False)
    # a manual eps without a search stage runs
    res = mcmc_with_warmup(gen, model, 5, initialization={"eps": 0.5},
                           warmup_stages=(TuningNUTS(N=20),))
    assert res.positions.shape == (5, 2)


def test_model_factories_default_to_cuda():
    """No ``device``: the factories build on CUDA, and raise where it is
    absent instead of building on the CPU."""
    factories = {
        "std_normal": lambda: tm.std_normal(3),
        "mvnormal": lambda: tm.mvnormal(np.zeros(3), np.eye(3), fused=True),
        "correlated_gaussian": lambda: tm.correlated_gaussian(3),
        "funnel": lambda: tm.funnel(3),
        "logistic_regression": lambda: tm.logistic_regression(20, 3),
    }
    for name, make in factories.items():
        if torch.cuda.is_available():
            assert make().device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


def test_entry_points_refuse_a_model_on_another_device():
    """The model's tensors on one device, the generator on another: the
    entry points raise and never move the model."""
    from dynamichmc_tpu_torch import run_chains
    from dynamichmc_tpu_torch.warmup import initialize_warmup_state

    model = tm.std_normal(2, dtype=torch.float32, device="meta")
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: mcmc_with_warmup(gen, model, 5),
                 lambda: initialize_warmup_state(gen, model),
                 lambda: run_chains(gen, model, 4, 5)):
        with pytest.raises(ValueError, match="generator's device"):
            call()
