"""logistic_regression(fused="auto", tree_kernel="auto") on the port: the
rule (ops/logreg_leaf.fused_leaf_pays, ops/tree_kernel.tree_kernel_pays)
reproduces the H100 sweep's decisions at 2048 chains (PERF.md,
scripts/torch_logreg_auto_sweep.py), an "auto" model is the explicit
model of its route bit for bit, and nothing attaches past what a kernel
takes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import models as jm
from dynamichmc_tpu_torch.hamiltonian import evaluate
from dynamichmc_tpu_torch.metric import diagonal_metric
from dynamichmc_tpu_torch.models import (
    logistic_regression,
    logistic_regression_from_data,
)
from dynamichmc_tpu_torch.nuts import NUTS
from dynamichmc_tpu_torch.ops import logreg_leaf, tree_kernel
from dynamichmc_tpu_torch.ops.logreg_leaf import fused_leaf_pays
from dynamichmc_tpu_torch.ops.tree_kernel import tree_kernel_pays
from dynamichmc_tpu_torch.tree_batched import sample_tree_batched

# The sweep at 2048 chains (NVIDIA H100 80GB HBM3, 700 W; each shape's
# state from a short adapted warmup; the median of 3 repeats a route): for
# each (dim, n_obs), the faster route of each pair, "tie" where the two
# routes' ranges of repeats overlap. PERF.md §6 holds the times.
K3, K1, PLAIN, TIE = "k3", "k1", "plain", "tie"
SWEEP_2048 = {  # (dim, n_obs): (k3 vs plain, k1 vs plain, k1 vs k3)
    (8, 250): (K3, K1, K1), (8, 1000): (K3, K1, K1),
    (8, 4000): (K3, K1, K1), (8, 16000): (K3, K1, K1),
    (25, 250): (K3, K1, K1), (25, 1000): (K3, K1, K1),
    (25, 4000): (K3, K1, K1), (25, 16000): (K3, K1, K1),
    (64, 250): (K3, K1, K1), (64, 1000): (K3, K1, K1),
    (64, 4000): (K3, K1, K1), (64, 16000): (K3, K1, K3),
    (128, 250): (K3, K1, K1), (128, 1000): (K3, K1, K1),
    (128, 4000): (K3, K1, K1), (128, 16000): (K3, TIE, K3),
    (256, 250): (K3, K1, K1), (256, 1000): (K3, K1, K1),
    (256, 4000): (K3, K1, K3), (256, 16000): (K3, PLAIN, K3),
    (512, 250): (K3, K1, K1), (512, 1000): (K3, K1, K1),
    (512, 4000): (K3, PLAIN, K3), (512, 16000): (PLAIN, PLAIN, K3),
    (1024, 250): (K3, K1, K1), (1024, 1000): (TIE, PLAIN, K3),
    (1024, 4000): (PLAIN, PLAIN, K3), (1024, 16000): (PLAIN, PLAIN, K3),
}


def _route(model):
    if model.tree_transition_fn is not None:
        return K1
    return K3 if model.fused_leaf_batched_fn is not None else PLAIN


def _undominated(k3_plain, k1_plain, k1_k3):
    """The routes no other route was measured strictly faster than."""
    beaten = set()
    for pair, won in (((K3, PLAIN), k3_plain), ((K1, PLAIN), k1_plain),
                      ((K1, K3), k1_k3)):
        if won != TIE:
            beaten.add(pair[1] if won == pair[0] else pair[0])
    return {K1, K3, PLAIN} - beaten


@pytest.mark.parametrize("dim,n_obs", sorted(SWEEP_2048))
def test_rule_reproduces_the_sweep(dim, n_obs):
    k3_plain, k1_plain, k1_k3 = SWEEP_2048[(dim, n_obs)]
    if k3_plain != TIE:
        assert fused_leaf_pays(n_obs, dim) == (k3_plain == K3)
    if k1_plain != TIE:
        assert tree_kernel_pays(n_obs, dim) == (k1_plain == K1)
    if k1_k3 != TIE:
        assert tree_kernel_pays(n_obs, dim, fused=True) == (k1_k3 == K1)
    # the models' routes: each "auto" alone and both together
    x = np.zeros((n_obs, dim))
    y = np.zeros(n_obs)

    def route(**kw):
        return _route(logistic_regression_from_data(
            x, y, dtype=torch.float32, device="cpu", **kw))

    assert route(fused="auto") == (K3 if fused_leaf_pays(n_obs, dim) else PLAIN)
    assert route(tree_kernel="auto") in (
        {K1, PLAIN} if k1_plain == TIE else {k1_plain})
    assert route(fused=True, tree_kernel="auto") in (
        {K1, K3} if k1_k3 == TIE else {k1_k3})
    assert route(fused="auto", tree_kernel="auto") in _undominated(
        k3_plain, k1_plain, k1_k3)


def test_nothing_attaches_past_what_a_kernel_takes():
    for dim in list(range(1, 40)) + [127, 128, 129, 1023, 1024, 1025,
                                     logreg_leaf.MAX_K, logreg_leaf.MAX_K + 1,
                                     2048]:
        assert fused_leaf_pays(1, dim) == (dim <= logreg_leaf.MAX_K)
        fits = tree_kernel.kernel_fits(dim, tree_kernel.AUTO_MAX_DEPTH,
                                       logreg=True)
        for fused in (False, True):
            assert tree_kernel_pays(1, dim, fused=fused) == fits
    assert not tree_kernel.kernel_fits(1025, 4, logreg=True)
    for n_obs in (1, 10, 1000):
        model = logistic_regression(n_obs, logreg_leaf.MAX_K + 1, device="cpu",
                                    fused="auto", tree_kernel="auto")
        assert _route(model) == PLAIN


@pytest.mark.parametrize("fused_max_x_reads", [logreg_leaf.FUSED_MAX_X_READS,
                                               100_000])
@pytest.mark.parametrize("dim", [8, 64, 128, 256, 512, 1024])
def test_k1_is_held_against_k3_only_where_k3_attaches(dim, fused_max_x_reads,
                                                      monkeypatch):
    """With both "auto", the whole-transition kernel must beat the fused
    leaf only where the fused leaf is attached: where it is not, the
    route is tree_kernel="auto" alone's. Also under a narrower fused
    leaf rule, where the two differ (at 8000 x 128 K1 beats the plain
    driver but not the fused leaf)."""
    monkeypatch.setattr(logreg_leaf, "FUSED_MAX_X_READS", fused_max_x_reads)

    def route(n_obs, **kw):
        return _route(logistic_regression_from_data(
            np.zeros((n_obs, dim)), np.zeros(n_obs), dtype=torch.float32,
            device="cpu", **kw))

    for n_obs in (250, 1000, 1500, 2000, 4000, 8000, 16000):
        fused = fused_leaf_pays(n_obs, dim)
        both = route(n_obs, fused="auto", tree_kernel="auto")
        assert both == (K1 if tree_kernel_pays(n_obs, dim, fused=fused)
                        else K3 if fused else PLAIN)
        if not fused:
            assert both == route(n_obs, tree_kernel="auto")


@pytest.mark.parametrize("n_obs,dim,explicit", [
    (250, 8, {"tree_kernel": True}),
    (16000, 256, {"fused": True}),
    (16000, 512, {}),
])
def test_auto_is_the_explicit_model_bitwise(n_obs, dim, explicit):
    """Both "auto" at three shapes, one a route: one transition of a batch
    from the same generator gives the explicit model's bit for bit; the
    log density is the JAX model's."""
    auto = logistic_regression(n_obs, dim, dtype=torch.float32, device="cpu",
                               fused="auto", tree_kernel="auto")
    model = logistic_regression(n_obs, dim, dtype=torch.float32, device="cpu",
                                **explicit)
    assert _route(auto) == _route(model)
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(4, dim)) * 0.05,
                        dtype=torch.float32)
    metric = diagonal_metric(torch.full((dim,), 0.01))
    outs = []
    for ld in (auto, model):
        gen = torch.Generator().manual_seed(1)
        Q, stats = sample_tree_batched(gen, NUTS(max_depth=3), ld, metric,
                                       evaluate(ld, q), 0.05)
        outs.append((Q.q, Q.logdensity, Q.grad, stats.steps, stats.depth))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    jmodel = jm.logistic_regression(n_obs, dim, dtype=jnp.float64)
    q64 = q[:2].double()
    value, _grad = logistic_regression(
        n_obs, dim, device="cpu", fused="auto",
        tree_kernel="auto").logdensity_and_gradient(q64)
    want = [float(jmodel.logdensity_fn(jnp.asarray(row.numpy()))) for row in q64]
    np.testing.assert_allclose(value.numpy(), want, rtol=1e-12)
