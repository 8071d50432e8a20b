"""The port's paths as a whole against the JAX package's, statistically.

Both packages run run_chains on correlated_gaussian(5) in float32 with a
short version of the main-path schedule (search, eps-only, two pooled dense
metric blocks, eps-only tail; warmup clamp 2 with a 5-step tail;
NUTS(max_depth=4)), 64 chains and 200 draws. Their random streams differ
(threefry keys against torch.Generator), so the gate is statistical, for
each package: every coordinate's |mean| <= 5 sd / sqrt(ESS), and the
adapted pooled metric within 30% relative Frobenius of the covariance.
The port runs with tree_kernel=True, which on the CPU takes the kernel's
plain version; the JAX run uses its XLA driver.

Slice 2 adds funnel(5) (v-marginal recovery in both packages) and a small
logistic regression run through the port's fused leaf and tree kernel and
through the JAX package, compared coordinate by coordinate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamichmc_tpu import models as jm
from dynamichmc_tpu.nuts import NUTS as JNUTS
from dynamichmc_tpu.parallel import run_chains as j_run_chains
from dynamichmc_tpu.stepsize import InitialStepsizeSearch as JSearch
from dynamichmc_tpu.warmup import TuningNUTS as JTuning
from dynamichmc_tpu_torch import NUTS, TuningNUTS, run_chains
from dynamichmc_tpu_torch.models import correlated_gaussian
from dynamichmc_tpu_torch.ops import tree_kernel
from dynamichmc_tpu_torch.stats import ess_bulk
from dynamichmc_tpu_torch.stepsize import InitialStepsizeSearch

K, C, N = 5, 64, 200
RUN = dict(tune="reference", warmup_depth_clamp=2, warmup_depth_clamp_tail=5)


def _stages(search, tuning):
    return (
        search(),
        tuning(N=30),
        tuning(N=40, metric_kind="dense", pooled=True),
        tuning(N=60, metric_kind="dense", pooled=True),
        tuning(N=20),
    )


def _check(positions, m_inv, cov):
    x = np.asarray(positions, np.float64)
    assert x.shape == (C, N, K) and np.isfinite(x).all()
    sd = np.sqrt(np.diag(cov))
    for j in range(K):
        ess = ess_bulk(x[:, :, j])
        assert abs(x[:, :, j].mean()) <= 5 * sd[j] / np.sqrt(ess), j
    rel = np.linalg.norm(np.asarray(m_inv, np.float64) - cov) / np.linalg.norm(cov)
    assert rel <= 0.3, rel


def test_port_run_chains_recovers_target():
    model = correlated_gaussian(K, dtype=torch.float32, tree_kernel=True, device="cpu")
    tree_kernel.reset_launches()
    res = run_chains(torch.Generator().manual_seed(0), model, C, N,
                     warmup_stages=_stages(InitialStepsizeSearch, TuningNUTS),
                     algorithm=NUTS(max_depth=4), **RUN)
    assert tree_kernel.launches == 0  # CPU tensors: the plain version
    assert int(res.tree_statistics.depth.max()) <= 4
    assert res.eps.shape == (C,)
    _check(res.positions.numpy(), res.metric.m_inv.numpy(),
           model.cov_fn().numpy())


def test_jax_run_chains_recovers_target():
    model = jm.correlated_gaussian(K, dtype=jnp.float32)
    res = j_run_chains(jax.random.PRNGKey(0), model, C, N, dtype=jnp.float32,
                       warmup_stages=_stages(JSearch, JTuning),
                       algorithm=JNUTS(max_depth=4), **RUN)
    _check(res.positions, res.metric.m_inv, np.asarray(model.cov_fn()))


def test_port_rejects_what_is_not_ported():
    import pytest

    model = correlated_gaussian(K, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="tune"):
        run_chains(gen, model, 4, 10, tune="auto")
    with pytest.raises(NotImplementedError, match="homogeneous"):
        run_chains(gen, model, 4, 10, warmup_stages=(
            TuningNUTS(N=20, metric_kind="dense"),
            TuningNUTS(N=20, metric_kind="diagonal")))
    with pytest.raises(ValueError, match="warmup_depth_clamp"):
        run_chains(gen, model, 4, 10, algorithm=NUTS(max_depth=3),
                   warmup_depth_clamp=5)


# --- slice 2: Neal's funnel and Bayesian logistic regression ----------------

FUNNEL_K, FC, FN = 5, 64, 200
FUNNEL_RUN = dict(tune="reference", warmup_depth_clamp=2,
                  warmup_depth_clamp_tail=5)


def _diag_stages(search, tuning):
    return (
        search(),
        tuning(N=30),
        tuning(N=40, metric_kind="diagonal", pooled=True),
        tuning(N=60, metric_kind="diagonal", pooled=True),
        tuning(N=20),
    )


def _check_funnel(positions, divergences):
    """v ~ N(0, 3^2). A short warmup and 200 draws per chain leave the
    neck undersampled, so the band is wide (the JAX package's own
    end-to-end funnel gate uses the same one)."""
    v = np.asarray(positions, np.float64)[:, :, 0]
    assert v.shape == (FC, FN) and np.isfinite(v).all()
    assert abs(v.mean()) < 0.8, v.mean()
    assert 2.0 < v.std() < 4.0, v.std()
    assert divergences < 0.02 * FC * FN


def test_port_funnel_run_chains_recovers_v_marginal():
    from dynamichmc_tpu_torch.models import funnel

    model = funnel(FUNNEL_K, dtype=torch.float32, tree_kernel=True, device="cpu")
    res = run_chains(torch.Generator().manual_seed(1), model, FC, FN,
                     warmup_stages=_diag_stages(InitialStepsizeSearch,
                                                TuningNUTS),
                     algorithm=NUTS(max_depth=6), **FUNNEL_RUN)
    assert res.metric.m_inv.shape == (FUNNEL_K,)  # pooled diagonal
    _check_funnel(res.positions.numpy(),
                  int(res.tree_statistics.is_divergent.sum()))


def test_jax_funnel_run_chains_recovers_v_marginal():
    res = j_run_chains(jax.random.PRNGKey(1),
                       jm.funnel(FUNNEL_K, dtype=jnp.float32), FC, FN,
                       dtype=jnp.float32,
                       warmup_stages=_diag_stages(JSearch, JTuning),
                       algorithm=JNUTS(max_depth=6), **FUNNEL_RUN)
    _check_funnel(res.positions,
                  int(np.asarray(res.tree_statistics.is_divergent).sum()))


def _posterior_summary(positions):
    x = np.asarray(positions, np.float64)
    ess = np.array([ess_bulk(x[:, :, j]) for j in range(x.shape[2])])
    return x.mean((0, 1)), x.reshape(-1, x.shape[2]).std(0), ess


def test_logreg_run_chains_agree_across_packages_and_kernels():
    """The port's fused-leaf run and tree-kernel run (their plain versions
    on the CPU) and the JAX package's run of the same posterior agree in
    every coordinate's mean within 5 combined Monte Carlo standard
    errors."""
    from dynamichmc_tpu_torch import convert
    from dynamichmc_tpu_torch import tree_batched as tb

    C, N = 32, 150
    jmodel = jm.logistic_regression(100, 5, dtype=jnp.float32)
    runs = {}
    res = j_run_chains(jax.random.PRNGKey(2), jmodel, C, N, dtype=jnp.float32,
                       warmup_stages=_diag_stages(JSearch, JTuning),
                       algorithm=JNUTS(max_depth=5), **FUNNEL_RUN)
    runs["jax"] = _posterior_summary(res.positions)
    for name, kw in (("fused", {"fused": True}),
                     ("tree", {"tree_kernel": True})):
        model = convert.logreg_model(jmodel, dtype=torch.float32, device="cpu", **kw)
        tb.reset_fused_leaf_calls()
        res = run_chains(torch.Generator().manual_seed(2), model, C, N,
                         warmup_stages=_diag_stages(InitialStepsizeSearch,
                                                    TuningNUTS),
                         algorithm=NUTS(max_depth=5), **FUNNEL_RUN)
        assert (tb.fused_leaf_calls > 0) == (name == "fused")
        assert np.isfinite(res.positions.numpy()).all()
        runs[name] = _posterior_summary(res.positions.numpy())
    m_j, sd_j, ess_j = runs["jax"]
    for name in ("fused", "tree"):
        m, sd, ess = runs[name]
        mcse = np.sqrt(sd**2 / ess + sd_j**2 / ess_j)
        assert (np.abs(m - m_j) <= 5 * mcse).all(), (name, m - m_j, mcse)
