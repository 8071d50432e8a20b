"""The port's generic per-chain driver (``nuts.sample_tree(fast=False)``
and custom turn statistics) with real Hamiltonian ops at float64.

- With injected momenta and direction bits, depth, steps, termination and
  the acceptance rate equal JAX ``sample_tree(..., fast=False)``'s (exactly;
  the acceptance rate to 1e-12). They do not depend on the merge draws,
  which the two packages take from different generators.
- The proposal is one of the trajectory's leapfrog points.
- A reimplemented generalized statistic reproduces the default generic
  driver bitwise from one generator seed; a never-turning statistic
  reaches max depth in 2^md - 1 steps (JAX tests/test_nuts.py:245-270).
- The generic and fast drivers take the same momenta and direction bits
  from one generator state, so their discrete statistics agree exactly,
  and their proposals agree in distribution (JAX
  tests/test_fast_driver.py:34).
- ``mcmc_with_warmup`` and ``run_chains`` run a custom statistic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import anderson_ksamp

from dynamichmc_tpu import models as jm
from dynamichmc_tpu.hamiltonian import evaluate as j_evaluate
from dynamichmc_tpu.metric import dense_metric as j_dense
from dynamichmc_tpu.metric import diagonal_metric as j_diag
from dynamichmc_tpu.nuts import NUTS as JNUTS
from dynamichmc_tpu.nuts import sample_tree as j_sample_tree
from dynamichmc_tpu_torch import NUTS, convert, mcmc_with_warmup, run_chains
from dynamichmc_tpu_torch import models as tm
from dynamichmc_tpu_torch.hamiltonian import (
    PhasePoint,
    evaluate,
    leapfrog,
)
from dynamichmc_tpu_torch.metric import diagonal_metric, identity_metric
from dynamichmc_tpu_torch.nuts import (
    GeneralizedTurnStatistic,
    sample_tree,
)
from dynamichmc_tpu_torch.tree import TreeNoise
from dynamichmc_tpu_torch.warmup import InitialStepsizeSearch, TuningNUTS
from torch_turn_statistics import GeneralizedReimpl

F64 = torch.float64
K = 4


class NeverTurning:
    """No merge ever turns: every transition ends at max depth or at a
    divergence."""

    def leaf(self, metric, z):
        return GeneralizedTurnStatistic(
            p_minus=z.p, psharp_minus=z.p, p_plus=z.p, psharp_plus=z.p,
            rho=z.p)

    def combine(self, metric, x, y):
        combined = GeneralizedTurnStatistic(
            p_minus=x.p_minus, psharp_minus=x.psharp_minus,
            p_plus=y.p_plus, psharp_plus=y.psharp_plus, rho=x.rho + y.rho)
        return combined, torch.tensor(False)


def _models():
    jmodel = jm.correlated_gaussian(K, dtype=jnp.float64)
    return jmodel, convert.gaussian_model(jmodel, device="cpu")


@pytest.mark.parametrize("kind,md", [("diag", 6), ("dense", 5), ("diag", 3)])
def test_generic_driver_matches_jax_discrete_statistics(kind, md):
    jmodel, tmodel = _models()
    jmetric = (j_dense(jnp.asarray(np.asarray(jmodel.cov_fn())))
               if kind == "dense"
               else j_diag(jnp.asarray(np.linspace(0.5, 2.0, K))))
    tmetric = convert.metric(jmetric)

    @jax.jit
    def j_step(Q, p, dirs, eps):
        return j_sample_tree(jax.random.PRNGKey(0), JNUTS(max_depth=md),
                             jmodel, jmetric, Q, eps, p=p, directions=dirs,
                             fast=False)

    rng = np.random.default_rng(11)
    terms = set()
    for step in range(8):
        q = rng.normal(size=K)
        p = rng.normal(size=K)
        dirs = int(rng.integers(0, 2**32, dtype=np.uint64))
        eps = 30.0 if step == 5 else 0.3  # one divergent transition
        _Qj, sj = j_step(j_evaluate(jmodel, jnp.asarray(q)), jnp.asarray(p),
                         jnp.asarray(dirs, jnp.uint32), jnp.float64(eps))
        _Qt, st = sample_tree(torch.Generator().manual_seed(step),
                              NUTS(max_depth=md), tmodel, tmetric,
                              evaluate(tmodel, torch.as_tensor(q)),
                              torch.tensor(eps, dtype=F64),
                              p=torch.as_tensor(p), directions=dirs,
                              fast=False)
        for name in ("depth", "steps", "term_left", "term_right"):
            assert int(getattr(st, name)) == int(getattr(sj, name)), name
        np.testing.assert_allclose(float(st.acceptance_rate),
                                   float(sj.acceptance_rate), rtol=0,
                                   atol=1e-12)
        assert int(st.directions) == np.asarray(
            sj.directions, np.uint32).view(np.int32)
        terms.add("divergent" if bool(st.is_divergent) else
                  "max" if bool(st.reached_max_depth) else "turning")
    assert "divergent" in terms and "turning" in terms


def _orbit(model, metric, Q, p, eps, n):
    """The leapfrog points at positions -n..n of the trajectory from (Q, p),
    computed as the driver moves (from the edge, one step at a time)."""
    points = {0: Q.q}
    for sign in (1, -1):
        z = PhasePoint(Q=Q, p=p)
        for i in range(1, n + 1):
            z = leapfrog(model, metric, z, eps * sign)
            points[sign * i] = z.Q.q
    return points


@pytest.mark.parametrize("md", [3, 5])
def test_generic_proposal_is_a_trajectory_point(md):
    _jmodel, model = _models()
    metric = diagonal_metric(torch.linspace(0.6, 1.8, K, dtype=F64))
    gen = torch.Generator().manual_seed(5)
    eps = torch.tensor(0.25, dtype=F64)
    for _ in range(6):
        Q = evaluate(model, torch.randn(K, generator=gen, dtype=F64))
        p = torch.randn(K, generator=gen, dtype=F64)
        Qn, stats = sample_tree(gen, NUTS(max_depth=md), model, metric, Q,
                                eps, p=p, fast=False)
        points = _orbit(model, metric, Q, p, eps, 2**md)
        hits = [i for i, q in points.items() if torch.equal(q, Qn.q)]
        # one point of the orbit, no further from the start than the
        # trajectory's leaves reach
        assert len(hits) == 1 and abs(hits[0]) <= int(stats.steps), hits
        np.testing.assert_allclose(
            float(evaluate(model, Qn.q).logdensity), float(Qn.logdensity),
            rtol=1e-14)


def test_reimplemented_statistic_reproduces_the_generic_driver_bitwise():
    model = tm.std_normal(3, dtype=F64, device="cpu")
    metric = identity_metric(3, dtype=F64)
    Q = evaluate(model, torch.tensor([0.3, -0.8, 1.1], dtype=F64))
    custom = NUTS(turn_statistic_configuration=GeneralizedReimpl())
    for seed in range(5):
        Q1, s1 = sample_tree(torch.Generator().manual_seed(seed), NUTS(),
                             model, metric, Q, 0.5, fast=False)
        # a custom statistic switches to the generic driver by itself
        Q2, s2 = sample_tree(torch.Generator().manual_seed(seed), custom,
                             model, metric, Q, 0.5)
        assert torch.equal(Q1.q, Q2.q) and torch.equal(Q1.grad, Q2.grad)
        for name in ("logdensity", "depth", "steps", "term_left",
                     "term_right", "acceptance_rate", "directions"):
            assert torch.equal(getattr(s1, name), getattr(s2, name)), name


def test_never_turning_statistic_reaches_max_depth():
    model = tm.std_normal(2, dtype=F64, device="cpu")
    metric = identity_metric(2, dtype=F64)
    Q = evaluate(model, torch.tensor([0.1, 0.2], dtype=F64))
    algo = NUTS(max_depth=4, turn_statistic_configuration=NeverTurning())
    _Q, stats = sample_tree(torch.Generator().manual_seed(0), algo, model,
                            metric, Q, 0.05)
    assert bool(stats.reached_max_depth)
    assert int(stats.steps) == 2**4 - 1 and int(stats.depth) == 4


def test_generic_driver_refuses_injected_tree_noise():
    model = tm.std_normal(2, dtype=F64, device="cpu")
    metric = identity_metric(2, dtype=F64)
    Q = evaluate(model, torch.zeros(2, dtype=F64))
    noise = TreeNoise(torch.zeros((3, 4), dtype=F64), torch.ones(3, dtype=F64))
    with pytest.raises(ValueError, match="fast driver"):
        sample_tree(None, NUTS(max_depth=3), model, metric, Q, 0.1,
                    p=torch.zeros(2, dtype=F64), directions=0, noise=noise,
                    fast=False)
    with pytest.raises(ValueError, match="fast driver"):  # the custom route
        sample_tree(None, NUTS(max_depth=3,
                               turn_statistic_configuration=NeverTurning()),
                    model, metric, Q, 0.1, noise=noise)


@pytest.mark.parametrize("n", [800, pytest.param(6000, marks=pytest.mark.slow)])
def test_fast_and_generic_drivers_agree(n):
    """One transition from each of ``n`` exact draws of a correlated 3-d
    Gaussian through both drivers, transition i of each from generator
    seed i: identical discrete statistics, acceptance rates to 1e-12, and
    proposals with the same law as each other and as exact draws
    (two-sample Anderson-Darling, p > 0.01 / K)."""
    k = 3
    rng = np.random.RandomState(1)
    a = rng.randn(k, k)
    cov = a @ a.T + k * np.eye(k)
    model = tm.mvnormal(np.zeros(k), cov, dtype=F64, device="cpu")
    metric = diagonal_metric(torch.tensor([0.8, 1.1, 1.4], dtype=F64))
    chol = np.linalg.cholesky(cov)
    q0 = (chol @ np.random.RandomState(42).randn(k, n)).T
    out = {}
    for fast in (True, False):
        qs, stats = [], []
        for i in range(n):
            Qn, s = sample_tree(torch.Generator().manual_seed(i), NUTS(),
                                model, metric,
                                evaluate(model, torch.as_tensor(q0[i])), 0.4,
                                fast=fast)
            qs.append(Qn.q)
            stats.append(torch.stack([s.steps, s.depth, s.term_left,
                                      s.term_right, s.directions]))
        out[fast] = (torch.stack(qs).numpy(), torch.stack(stats).numpy())
    np.testing.assert_array_equal(out[True][1], out[False][1])
    exact = (chol @ np.random.RandomState(7).randn(k, n)).T
    for j in range(k):
        p1 = anderson_ksamp([out[True][0][:, j],
                             out[False][0][:, j]]).significance_level
        p2 = anderson_ksamp([out[False][0][:, j], exact[:, j]]).significance_level
        assert p1 > 0.01 / k, f"fast vs generic differ on coord {j}: p={p1}"
        assert p2 > 0.01 / k, f"generic driver off-target on coord {j}: p={p2}"


def test_mcmc_with_warmup_runs_a_custom_statistic():
    """A custom statistic through the whole per-chain API, on the generic
    driver: the reimplemented generalized statistic gives the draws of
    ``fast=False``'s statistic, which a N(0, I) recovers."""
    model = tm.std_normal(2, dtype=F64, device="cpu")
    stages = (InitialStepsizeSearch(), TuningNUTS(N=30),
              TuningNUTS(N=40, metric_kind="diagonal"), TuningNUTS(N=20))
    res = mcmc_with_warmup(
        torch.Generator().manual_seed(3), model, 300, warmup_stages=stages,
        algorithm=NUTS(turn_statistic_configuration=GeneralizedReimpl()),
        dtype=F64)
    assert res.positions.shape == (300, 2)
    assert bool(torch.isfinite(res.positions).all())
    assert float(res.positions.mean(0).abs().max()) < 0.3
    assert 0.6 < float(res.positions.std(0).min())
    assert float(res.positions.std(0).max()) < 1.4


def test_run_chains_refuses_a_custom_statistic():
    """No longer refused: run_chains runs a custom statistic through the
    generic driver looped over the chains (tests/
    test_torch_run_chains_custom.py holds it to the JAX package); a
    never-turning statistic ends every draw at max depth or a divergence."""
    model = tm.std_normal(2, dtype=F64, device="cpu")
    res = run_chains(torch.Generator().manual_seed(0), model, 4, 10,
                     algorithm=NUTS(max_depth=3,
                                    turn_statistic_configuration=NeverTurning()),
                     warmup_stages=(InitialStepsizeSearch(), TuningNUTS(N=20)),
                     dtype=F64)
    assert tuple(res.positions.shape) == (4, 10, 2)
    assert bool(torch.isfinite(res.positions).all())
    stats = res.tree_statistics
    assert bool((stats.reached_max_depth | stats.is_divergent).all())
