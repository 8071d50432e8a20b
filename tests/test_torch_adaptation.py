"""Port parity: the adaptation folds of dynamichmc_tpu_torch against the JAX
package's, at float64 to 1e-12 (the same formulas on the same inputs; only
reduction orders and the LAPACK calls behind cholesky/solve differ).

Dual averaging (per-chain and pooled), Welford (per-chain and pooled Chan
combine), estimate_metric, the batched stepsize search with injected
momenta, and the schedule normalization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import engine as je
from dynamichmc_tpu import models as jm
from dynamichmc_tpu import stepsize as js
from dynamichmc_tpu import warmup as jw
from dynamichmc_tpu.hamiltonian import EvaluatedPoint as JEvaluatedPoint
from dynamichmc_tpu.metric import dense_metric as j_dense
from dynamichmc_tpu.metric import diagonal_metric as j_diag
from dynamichmc_tpu.tree_batched import _evaluate_b
from dynamichmc_tpu.tree_batched import rand_p_b as j_rand_p_b
from dynamichmc_tpu.utils.welford import WelfordState as JWelford
from dynamichmc_tpu_torch import convert, engine, stepsize, warmup
from dynamichmc_tpu_torch import models as tm
from dynamichmc_tpu_torch.utils import welford

TOL = dict(rtol=1e-12, atol=1e-12)


def _close(t, j, **kw):
    np.testing.assert_allclose(convert.to_numpy(t), np.asarray(j),
                               **(kw or TOL))


@pytest.mark.parametrize("pooled", [False, True])
def test_dual_averaging_fold_matches_jax(pooled):
    rng = np.random.default_rng(0)
    eps0 = rng.uniform(0.1, 1.0, size=8)
    jad = js.DualAveraging(delta=0.75, t0=12)
    tad = stepsize.DualAveraging(delta=0.75, t0=12)
    if pooled:
        jad, tad = js.PooledStepsize(jad), stepsize.PooledStepsize(tad)
    sj = jad.init(jnp.asarray(eps0))
    st = tad.init(torch.as_tensor(eps0))
    for _ in range(30):
        a = rng.uniform(-0.1, 1.1, size=8)  # clipped to [0, 1] inside
        sj = jad.update(sj, jnp.asarray(a))
        st = tad.update(st, torch.as_tensor(a))
        for name in ("mu", "m", "h_bar", "log_eps", "log_eps_bar"):
            _close(getattr(st, name), getattr(sj, name))
        _close(tad.current(st), jad.current(sj))
        _close(tad.final(st), jad.final(sj))


def test_fixed_stepsize_is_a_no_op():
    s = stepsize.FixedStepsize()
    eps = torch.tensor([0.3, 0.4])
    state = s.update(s.init(eps), torch.tensor([0.1, 0.9]))
    assert torch.equal(s.current(state), eps) and torch.equal(s.final(state), eps)


def test_convert_carries_dual_averaging_state():
    sj = js.DualAveraging().update(js.DualAveraging().init(jnp.asarray([0.2, 0.5])),
                                   jnp.asarray([0.7, 0.9]))
    st = convert.dual_averaging_state(sj)
    sj2 = js.DualAveraging().update(sj, jnp.asarray([0.6, 0.3]))
    st2 = stepsize.DualAveraging().update(st, torch.tensor([0.6, 0.3],
                                                           dtype=torch.float64))
    _close(st2.log_eps, sj2.log_eps)


@pytest.mark.parametrize("dense", [False, True])
def test_welford_per_chain_matches_jax(dense):
    rng = np.random.default_rng(1)
    C, K = 6, 4
    wj = je.welford_zero(JEvaluatedPoint(q=jnp.zeros((C, K)), logdensity=None,
                                         grad=None), dense)
    wt = welford.welford_zero(torch.zeros((C, K), dtype=torch.float64), dense)
    for _ in range(25):
        x = rng.normal(size=(C, K)) * 3 + 1
        wj = je.welford_update_b(wj, jnp.asarray(x))
        wt = welford.welford_update_b(wt, torch.as_tensor(x))
    for name in ("count", "mean", "m2"):
        _close(getattr(wt, name), getattr(wj, name))
    kind = "dense" if dense else "diagonal"
    mj = jax.vmap(lambda w: jw.estimate_metric(w, kind, 0.1, None))(wj)
    mt = warmup.estimate_metric(wt, kind, 0.1)
    _close(mt.m_inv, mj.m_inv)
    _close(mt.w if dense else mt.w_diag, mj.w if dense else mj.w_diag)


@pytest.mark.parametrize("dense", [False, True])
def test_welford_pooled_chan_combine_matches_jax(dense):
    rng = np.random.default_rng(2)
    C, K = 16, 5
    wj = je.welford_zero_shared(K, dense, jnp.float64)
    wt = welford.welford_zero_shared(K, dense, torch.float64)
    xs = []
    for _ in range(20):
        x = rng.normal(size=(C, K)) @ rng.normal(size=(K, K)) + 2.0
        xs.append(x)
        wj = je.welford_update_pooled_b(wj, jnp.asarray(x))
        wt = welford.welford_update_pooled_b(wt, torch.as_tensor(x))
    for name in ("count", "mean", "m2"):
        _close(getattr(wt, name), getattr(wj, name))
    # the pooled moments are those of all draws at once
    allx = np.concatenate(xs)
    if dense:
        _close(welford.welford_covariance(wt), np.cov(allx.T), rtol=1e-10,
               atol=1e-10)
    else:
        _close(welford.welford_variance(wt), allx.var(0, ddof=1), rtol=1e-10,
               atol=1e-10)


@pytest.mark.parametrize("kind,lam", [("dense", 0.0), ("dense", 0.2),
                                      ("diagonal", 0.2)])
def test_estimate_metric_matches_jax(kind, lam):
    rng = np.random.default_rng(3)
    K = 4
    a = rng.normal(size=(K, K))
    m2 = (a @ a.T + np.eye(K)) * 30 if kind == "dense" else rng.uniform(1, 9, K) * 30
    wj = JWelford(count=jnp.asarray(31.0), mean=jnp.asarray(rng.normal(size=K)),
                  m2=jnp.asarray(m2))
    mj = jw.estimate_metric(wj, kind, lam, None)
    mt = warmup.estimate_metric(convert.welford_state(wj), kind, lam)
    _close(mt.m_inv, mj.m_inv)
    if kind == "dense":
        _close(mt.w, mj.w)
        # W W^T = M = (M^-1)^-1
        np.testing.assert_allclose((mt.w @ mt.w.mT).numpy(),
                                   np.linalg.inv(mt.m_inv.numpy()), rtol=1e-10)
    else:
        _close(mt.w_diag, mj.w_diag)


@pytest.mark.parametrize("metric_kind", ["diag", "dense"])
def test_batched_stepsize_search_matches_jax(metric_kind):
    K, C = 4, 12
    jmodel = jm.correlated_gaussian(K, dtype=jnp.float64)
    tmodel = tm.correlated_gaussian(K, dtype=torch.float64, device="cpu")
    q0 = np.random.default_rng(4).normal(size=(C, K))
    vals, grads = _evaluate_b(jmodel, jnp.asarray(q0))
    Qj = JEvaluatedPoint(q=jnp.asarray(q0), logdensity=vals, grad=grads)
    cov = np.asarray(jmodel.cov_fn())
    jmetric = (j_dense(jnp.asarray(cov)) if metric_kind == "dense"
               else j_diag(jnp.ones(K, jnp.float64)))
    key = jax.random.PRNGKey(5)
    params = js.InitialStepsizeSearch()
    eps_j, ok_j, l0_j = je.make_search_driver_batched(jmodel, params)(
        key, Qj, jmetric)
    p = j_rand_p_b(key, jmetric, (C, K), jnp.float64)  # the driver's draw
    eps_t, ok_t, l0_t = engine.make_search_driver_batched(
        tmodel, stepsize.InitialStepsizeSearch()
    )(None, convert.evaluated_point(Qj), convert.metric(jmetric),
      p=convert.tensor(p))
    _close(eps_t, eps_j)
    _close(l0_t, l0_j)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))


def test_schedule_normalization_matches_jax():
    kw = dict(metric_kind="dense", pooled=True, pooled_stepsize=False)
    sj = je.WarmupSchedule.from_stages(jw.default_warmup_stages(**kw))
    st = engine.WarmupSchedule.from_stages(warmup.default_warmup_stages(**kw))
    assert st.block_sizes == sj.block_sizes == (75, 25, 50, 100, 200, 400, 50)
    assert st.update_metric == sj.update_metric
    assert st.shrinkages == pytest.approx(sj.shrinkages)
    assert (st.metric_kind, st.pooled) == (sj.metric_kind, sj.pooled)
    # heterogeneous stages are not expressible in either package
    mixed = (warmup.TuningNUTS(N=30, metric_kind="dense"),
             warmup.TuningNUTS(N=30, metric_kind="diagonal"))
    assert engine.WarmupSchedule.from_stages(mixed) is None


def test_promote_metric_is_numerically_a_no_op():
    from dynamichmc_tpu_torch.metric import diagonal_metric
    from dynamichmc_tpu_torch.tree_batched import kinetic_b, psharp_b

    m = diagonal_metric(torch.tensor([0.5, 2.0, 1.5], dtype=torch.float64))
    d = engine.promote_metric(m, "dense")
    p = torch.randn(5, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    _close(psharp_b(d, p), psharp_b(m, p).numpy())
    _close(kinetic_b(d, p), kinetic_b(m, p).numpy())
    assert engine.promote_metric(m, "diagonal") is m
