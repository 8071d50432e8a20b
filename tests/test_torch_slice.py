"""The port's main path as a whole against the JAX package's, statistically.

Both packages run run_chains on correlated_gaussian(5) in float32 with a
short version of the main-path schedule (search, eps-only, two pooled dense
metric blocks, eps-only tail; warmup clamp 2 with a 5-step tail;
NUTS(max_depth=4)), 64 chains and 200 draws. Their random streams differ
(threefry keys against torch.Generator), so the gate is statistical, for
each package: every coordinate's |mean| <= 5 sd / sqrt(ESS), and the
adapted pooled metric within 30% relative Frobenius of the covariance.
The port runs with tree_kernel=True, which on the CPU takes the kernel's
plain version; the JAX run uses its XLA driver.
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
    model = correlated_gaussian(K, dtype=torch.float32, tree_kernel=True)
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

    model = correlated_gaussian(K, dtype=torch.float32)
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
