"""Port parity: dynamichmc_tpu_torch.diagnostics against the JAX package's.

The same numpy arrays (a seeded RandomState) go through both packages:
tree statistics of shape (N,) and (C, N), built as JAX ``TreeStatistics``
and carried across by ``convert.tree_statistics``. Integer results are
exact; floats match to 1e-12 at float64; the summary text is identical.
The explorers take the same injected momenta and match to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import diagnostics as jd
from dynamichmc_tpu import models as jm
from dynamichmc_tpu import warmup as jw
from dynamichmc_tpu.logdensity import from_logdensity_fn as j_from_fn
from dynamichmc_tpu.mcmc import MCMCResult as JMCMCResult
from dynamichmc_tpu.metric import dense_metric as j_dense
from dynamichmc_tpu.metric import identity_metric as j_identity
from dynamichmc_tpu.nuts import TreeStatistics as JTreeStatistics
from dynamichmc_tpu_torch import convert
from dynamichmc_tpu_torch import diagnostics as td
from dynamichmc_tpu_torch import models as tm
from dynamichmc_tpu_torch import warmup as tw
from dynamichmc_tpu_torch.logdensity import from_logdensity_fn as t_from_fn
from dynamichmc_tpu_torch.mcmc import MCMCResult
from dynamichmc_tpu_torch.metric import dense_metric as t_dense
from dynamichmc_tpu_torch.metric import identity_metric as t_identity

RTOL = 1e-12


def _stats_arrays(shape, seed=0, work=True):
    """Numpy fields of tree statistics: ~20% divergent (left == right),
    ~10% at max depth (1, 0), the rest turning (left < right)."""
    rng = np.random.RandomState(seed)
    kinds = rng.choice(3, size=shape, p=[0.2, 0.1, 0.7])
    left = rng.randint(-8, 0, size=shape).astype(np.int32)
    right = (left + rng.randint(1, 8, size=shape)).astype(np.int32)
    div = rng.randint(-8, 8, size=shape).astype(np.int32)
    left = np.where(kinds == 0, div, np.where(kinds == 1, 1, left))
    right = np.where(kinds == 0, div, np.where(kinds == 1, 0, right))
    steps = rng.randint(1, 100, size=shape).astype(np.int32)
    arrays = dict(
        logdensity=np.cumsum(rng.randn(*shape), axis=-1) * 0.3
        + rng.randn(*shape),
        depth=rng.randint(0, 6, size=shape).astype(np.int32),
        term_left=left.astype(np.int32),
        term_right=right.astype(np.int32),
        acceptance_rate=rng.uniform(size=shape),
        steps=steps,
        directions=rng.randint(0, 2**32, size=shape, dtype=np.uint64
                               ).astype(np.uint32),
        work=(steps + rng.randint(0, 30, size=shape)).astype(np.int32)
        if work else None,
    )
    return arrays


def _both(shape, seed=0, work=True):
    a = _stats_arrays(shape, seed, work)
    j = JTreeStatistics(**{k: (None if v is None else jnp.asarray(v))
                           for k, v in a.items()})
    return j, convert.tree_statistics(j)


SHAPES = [(400,), (4, 250)]


@pytest.mark.parametrize("shape", SHAPES)
def test_convert_tree_statistics(shape):
    j, t = _both(shape)
    assert t.directions.dtype == torch.int32
    np.testing.assert_array_equal(t.directions.numpy().view(np.uint32),
                                  np.asarray(j.directions))
    for name in ("is_divergent", "reached_max_depth", "is_turning"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert convert.tree_statistics(_both(shape, work=False)[0]).work is None


@pytest.mark.parametrize("shape", SHAPES)
def test_ebfmi_matches_jax(shape):
    j, t = _both(shape)
    ours = td.EBFMI(t)
    assert tuple(ours.shape) == shape[:-1]
    np.testing.assert_allclose(ours.numpy(), np.asarray(jd.EBFMI(j)),
                               rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_counts_and_summary_match_jax(shape):
    j, t = _both(shape, seed=3)
    assert td.count_terminations(t) == jd.count_terminations(j)
    np.testing.assert_array_equal(td.count_depths(t), jd.count_depths(j))
    ours, theirs = td.summarize_tree_statistics(t), jd.summarize_tree_statistics(j)
    assert ours.N == theirs.N
    assert ours.a_mean == pytest.approx(theirs.a_mean, rel=RTOL)
    np.testing.assert_allclose(ours.a_quantiles, theirs.a_quantiles, rtol=RTOL)
    assert ours.termination_counts == theirs.termination_counts
    np.testing.assert_array_equal(ours.depth_counts, theirs.depth_counts)
    assert str(ours) == str(theirs)


def test_count_depths_trims_trailing_zeros():
    j, t = _both((50,), seed=5)
    depth = np.zeros(50, np.int32)
    depth[:3] = [0, 2, 2]
    t.depth = torch.as_tensor(depth)
    j = JTreeStatistics(**{**vars(j), "depth": jnp.asarray(depth)})
    np.testing.assert_array_equal(td.count_depths(t), [48, 0, 2])
    np.testing.assert_array_equal(td.count_depths(t), jd.count_depths(j))


@pytest.mark.parametrize("shape", SHAPES)
def test_straggler_waste_matches_jax(shape):
    j, t = _both(shape, seed=7)
    assert td.straggler_waste(t) == pytest.approx(jd.straggler_waste(j),
                                                  rel=RTOL)
    j, t = _both(shape, work=False)
    for fn, stats in ((td.straggler_waste, t), (jd.straggler_waste, j)):
        with pytest.raises(ValueError, match="batch-native"):
            fn(stats)


@pytest.mark.parametrize("left,right", [(1, 0), (3, 3), (-2, 5), (0, 0)])
def test_termination_description_matches_jax(left, right):
    assert td.termination_description(left, right) == (
        jd.termination_description(left, right))


@pytest.mark.parametrize("chains", [1, 3])
def test_mcmc_result_summary_matches_jax(chains):
    rng = np.random.RandomState(11)
    positions = rng.randn(chains, 200, 3).cumsum(axis=1) * 0.1 + rng.randn(
        chains, 200, 3)
    j, t = _both((chains, 200), seed=11)
    if chains == 1:  # one chain: (N, K) draws and (N,) statistics
        positions = positions[0]
        j, t = _both((200,), seed=11)
    ours = MCMCResult(positions=torch.as_tensor(positions),
                      logdensities=None, tree_statistics=t, metric=None,
                      eps=None).summary()
    theirs = JMCMCResult(positions=jnp.asarray(positions), logdensities=None,
                         tree_statistics=j, metric=None, eps=None).summary()
    assert ours == theirs
    assert ("R-hat max" in ours) == (chains > 1)


def _dense_pair(K):
    a = np.random.RandomState(K).randn(K, K)
    m_inv = a @ a.T / K + np.eye(K)
    return j_dense(jnp.asarray(m_inv)), t_dense(torch.as_tensor(m_inv))


@pytest.mark.parametrize("metric", ["identity", "dense"])
def test_leapfrog_trajectory_matches_jax(metric):
    K = 4
    jmodel = jm.correlated_gaussian(K, seed=2)
    tmodel = tm.correlated_gaussian(K, seed=2, device="cpu")
    rng = np.random.RandomState(4)
    q, p = rng.randn(K), rng.randn(K)
    if metric == "dense":
        jmet, tmet = _dense_pair(K)
    else:
        jmet = j_identity(K, dtype=jnp.float64)
        tmet = t_identity(K, dtype=torch.float64)
    positions = range(-5, 7, 2)  # strided: every step is integrated
    theirs = jd.leapfrog_trajectory(jmodel, jnp.asarray(q), 0.3, positions,
                                    metric=jmet, p=jnp.asarray(p))
    ours = td.leapfrog_trajectory(tmodel, torch.as_tensor(q), 0.3, positions,
                                  metric=tmet, p=torch.as_tensor(p))
    assert [r["position"] for r in ours] == [r["position"] for r in theirs]
    assert [r["position"] for r in ours] == [-5, -3, -1, 0, 1, 3, 5]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a["z"].Q.q.numpy(), np.asarray(b["z"].Q.q),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(a["z"].p.numpy(), np.asarray(b["z"].p),
                                   rtol=1e-10, atol=1e-12)
        assert a["delta"] == pytest.approx(b["delta"], rel=1e-10, abs=1e-12)


def test_leapfrog_trajectory_stops_at_nonfinite_as_jax():
    jld = j_from_fn(1, lambda q: jnp.where(jnp.abs(q[0]) > 1.0, -jnp.inf,
                                           -0.5 * q[0] ** 2))
    tld = t_from_fn(1, lambda q: torch.where(q[..., 0].abs() > 1.0, -torch.inf,
                                             -0.5 * q[..., 0] ** 2))
    theirs = jd.leapfrog_trajectory(jld, jnp.zeros(1), 0.5, range(-10, 11),
                                    p=jnp.asarray([1.0]))
    ours = td.leapfrog_trajectory(tld, torch.zeros(1, dtype=torch.float64),
                                  0.5, range(-10, 11),
                                  p=torch.tensor([1.0], dtype=torch.float64))
    positions = [r["position"] for r in ours]
    assert positions == [r["position"] for r in theirs]
    assert 0 in positions and len(positions) < 21  # truncated at the cliff
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a["delta"], b["delta"], rtol=1e-10)
    with pytest.raises(ValueError, match="contain 0"):
        td.leapfrog_trajectory(tld, torch.zeros(1), 0.5, range(1, 3))


@pytest.mark.parametrize("metric", ["identity", "dense"])
def test_explore_log_acceptance_ratios_matches_jax(metric):
    K, n = 3, 6
    jmodel = jm.correlated_gaussian(K, seed=5)
    tmodel = tm.correlated_gaussian(K, seed=5, device="cpu")
    rng = np.random.RandomState(6)
    q, momenta = rng.randn(K), rng.randn(n, K)
    jmet, tmet = (None, None) if metric == "identity" else _dense_pair(K)
    log2_eps = [-6, -2, 0, 1, 3]
    theirs = jd.explore_log_acceptance_ratios(
        jmodel, jnp.asarray(q), log2_eps, metric=jmet,
        momenta=jnp.asarray(momenta))
    ours = td.explore_log_acceptance_ratios(
        tmodel, torch.as_tensor(q), log2_eps, metric=tmet,
        momenta=torch.as_tensor(momenta))
    assert ours.shape == (len(log2_eps), n) == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-12)


def test_explorers_draw_from_the_generator():
    model = tm.std_normal(2, device="cpu")
    q = torch.zeros(2, dtype=torch.float64)
    grid = td.explore_log_acceptance_ratios(model, q, [-5, -2, 0, 2])
    assert grid.shape == (4, 20)
    assert np.abs(grid[0]).max() < 1e-2  # tiny stepsize: near-exact
    assert np.nanmin(grid[-1]) < -1.0  # huge stepsize: much worse
    again = td.explore_log_acceptance_ratios(
        model, q, [-5, -2, 0, 2], generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(grid, again)  # seed 0 by default
    other = td.explore_log_acceptance_ratios(
        model, q, [-5, -2, 0, 2], generator=torch.Generator().manual_seed(1))
    assert not np.array_equal(grid, other)
    traj = td.leapfrog_trajectory(model, q, 0.1, range(-2, 3),
                                  generator=torch.Generator().manual_seed(2))
    assert [r["position"] for r in traj] == [-2, -1, 0, 1, 2]


def test_fixed_stepsize_warmup_stages_match_jax():
    for kwargs in ({}, {"metric_kind": "dense", "middle_steps": 30,
                        "doubling_stages": 3, "pooled": True}):
        ours = tw.fixed_stepsize_warmup_stages(**kwargs)
        theirs = jw.fixed_stepsize_warmup_stages(**kwargs)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert (a.N, a.metric_kind, a.pooled, a.lam, a.shrinkage) == (
                b.N, b.metric_kind, b.pooled, b.lam, b.shrinkage)
            assert type(a.stepsize_adaptation).__name__ == "FixedStepsize"
            assert type(b.stepsize_adaptation).__name__ == "FixedStepsize"


def test_fixed_stepsize_schedule_keeps_eps():
    """The engine takes the fixed-stepsize stages as one homogeneous
    schedule: the metric adapts, the given eps stays."""
    from dynamichmc_tpu_torch import run_chains

    model = tm.mvnormal(np.zeros(2), np.diag([1.0, 4.0]), device="cpu")
    stages = tw.fixed_stepsize_warmup_stages(middle_steps=20,
                                             doubling_stages=2)
    res = run_chains(torch.Generator().manual_seed(0), model, 4, 30,
                     initialization={"eps": 0.4}, warmup_stages=stages,
                     dtype=torch.float64)
    np.testing.assert_array_equal(res.eps.numpy(), np.full(4, 0.4))
    assert tuple(res.metric.m_inv.shape) == (4, 2)
    assert not torch.equal(res.metric.m_inv, torch.ones(4, 2,
                                                        dtype=torch.float64))
