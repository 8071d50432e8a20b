"""Hoffman and Gelman's hierarchical logistic regression on the port
(models/logreg.py ``hierarchical_logistic_regression_from_data``) on the
CPU: its value and gradient and the fused leaf's hierarchical mode (its
plain version here) against the float64 reference
(tests/torch_reference_hlr.py), the reference against its own autograd,
the design's columns, the kernel choices, and a short run_chains with the
program's new spans and counters."""

import contextlib

import numpy as np
import pytest
import torch

import torch_reference_hlr as ref
from dynamichmc_tpu_torch import run_chains
from dynamichmc_tpu_torch.metric import dense_metric, diagonal_metric
from dynamichmc_tpu_torch.models import (
    hierarchical_logistic_regression_from_data as hlr)
from dynamichmc_tpu_torch.nuts import NUTS
from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts
from dynamichmc_tpu_torch.ops.logreg_leaf import fused_leaf_pays
from dynamichmc_tpu_torch.warmup import default_warmup_stages

F64 = torch.float64
RATE = 0.01
N_OBS, N_COV = 40, 4  # -> 1 + 4 + 6 = 11 columns, K = 12


def _data(n_obs=N_OBS, n_cov=N_COV, seed=0):
    rng = np.random.RandomState(seed)
    x = ref.design(rng.randn(n_obs, n_cov))
    beta = 0.5 * rng.randn(x.shape[1])
    y = (rng.uniform(size=n_obs) < 1 / (1 + np.exp(-(x @ beta)))).astype(
        np.float64)
    return x, y


def _q(C, K, seed=1):
    g = torch.Generator().manual_seed(seed)
    q = 0.3 * torch.randn(C, K, dtype=F64, generator=g)
    q[:, -1] = torch.empty(C, dtype=F64).uniform_(-3.0, 2.0, generator=g)
    return q


def test_the_design_s_columns():
    rng = np.random.RandomState(3)
    cov = 2.0 + 3.0 * rng.randn(50, 5)
    x = ref.design(cov)
    assert x.shape == (50, 1 + 5 + 10)
    assert (x[:, 0] == 1).all()
    np.testing.assert_allclose(x[:, 1:].mean(0), 0, atol=1e-12)
    np.testing.assert_allclose(x[:, 1:].std(0), 1, rtol=1e-12)
    z = (cov - cov.mean(0)) / cov.std(0)
    np.testing.assert_allclose(x[:, 1:6], z, rtol=1e-12, atol=1e-12)
    # pairs in lexicographic order: (0, 1), (0, 2), ..., (3, 4)
    pairs = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    for col, (i, j) in enumerate(pairs, start=6):
        w = z[:, i] * z[:, j]
        np.testing.assert_allclose(x[:, col], (w - w.mean()) / w.std(),
                                   rtol=1e-10, atol=1e-12)


def test_the_reference_gradient_is_its_value_s_derivative():
    x, y = _data()
    q = _q(5, x.shape[1] + 1).requires_grad_(True)
    ld, grad = ref.value_and_grad(q.detach(), x, y, RATE)
    auto, = torch.autograd.grad(ref.value_and_grad(q, x, y, RATE)[0].sum(), q)
    torch.testing.assert_close(grad, auto, rtol=1e-12, atol=1e-12)
    assert ld.shape == (5,)


def _leaf_metric(kind, C, K, g):
    if kind == "shared_dense":
        a = torch.randn(K, K, dtype=F64, generator=g)
        return dense_metric(a @ a.T / K + torch.eye(K, dtype=F64))
    shape = (C, K) if kind == "chain_diag" else (K,)
    return diagonal_metric(torch.empty(shape, dtype=F64).uniform_(
        0.5, 2.0, generator=g))


@pytest.mark.parametrize("path", ["logdensity", "shared_diag", "chain_diag",
                                  "shared_dense"])
def test_the_port_matches_the_reference_at_float64(path):
    """``logdensity``: the model's value and autograd gradient; each metric
    form: the fused leaf's hook (its plain version on the CPU) gives ld'
    and g' of the reference at its q', q' the drift from q, and p', pi'
    from the reference's gradient."""
    x, y = _data()
    K = x.shape[1] + 1
    model = hlr(x, y, rate=RATE, dtype=F64, device="cpu", fused=True)
    assert model.dim == K == 12
    q = _q(6, K)
    if path == "logdensity":
        ld, grad = model.logdensity_and_gradient(q)
        ld_ref, g_ref = ref.value_and_grad(q, x, y, RATE)
        torch.testing.assert_close(ld, ld_ref, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(grad, g_ref, rtol=1e-12, atol=1e-12)
        return
    g = torch.Generator().manual_seed(2)
    metric = _leaf_metric(path, 6, K, g)
    p = torch.randn(6, K, dtype=F64, generator=g)
    _, g0 = ref.value_and_grad(q, x, y, RATE)
    eps = torch.empty(6, dtype=F64).uniform_(-0.1, 0.1, generator=g)
    qn, pn, gn, ldn, pin = model.fused_leaf_batched_fn(metric, q, p, g0, eps)
    m = metric.m_inv
    p_mid = p + 0.5 * eps[:, None] * g0
    drift = p_mid * m if m.ndim == 1 or path == "chain_diag" else p_mid @ m
    torch.testing.assert_close(qn, q + eps[:, None] * drift, rtol=1e-12,
                               atol=1e-12)
    ld_ref, g_ref = ref.value_and_grad(qn, x, y, RATE)
    torch.testing.assert_close(ldn, ld_ref, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gn, g_ref, rtol=1e-12, atol=1e-12)
    p_ref = p_mid + 0.5 * eps[:, None] * g_ref
    torch.testing.assert_close(pn, p_ref, rtol=1e-12, atol=1e-12)
    kinetic = 0.5 * (p_ref * (p_ref * m if m.ndim == 1 or path == "chain_diag"
                              else p_ref @ m)).sum(-1)
    torch.testing.assert_close(pin, ld_ref - kinetic, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("tree_kernel,fused", [
    ("auto", "auto"), ("auto", True), ("auto", False), (True, True),
    ("yes", False)])
def test_the_kernels_it_takes(tree_kernel, fused):
    """The whole-transition kernel has no hierarchical prior: "auto"
    attaches nothing (where the flat rule would pick it at this shape)
    and True, or any other value, raises; the fused leaf attaches in its
    hierarchical mode."""
    x, y = _data()
    kw = dict(rate=RATE, dtype=torch.float32, device="cpu")
    if tree_kernel != "auto":
        with pytest.raises(ValueError, match="no hierarchical prior"):
            hlr(x, y, tree_kernel=tree_kernel, fused=fused, **kw)
        return
    model = hlr(x, y, tree_kernel=tree_kernel, fused=fused, **kw)
    assert model.tree_transition_fn is None
    attached = fused is True or (fused == "auto" and fused_leaf_pays(
        N_OBS, x.shape[1] + 1))
    assert (model.fused_leaf_batched_fn is not None) == attached
    if attached:
        assert model.fused_leaf_batched_fn.rate == RATE
        xk, _ = model.fused_leaf_batched_fn.operands
        assert xk.shape == (N_OBS, x.shape[1] + 1)
        assert bool((xk[:, -1] == 0).all())


def test_the_cells_shape_goes_to_the_fused_leaf_and_not_to_k1():
    """1000 rows x 301 columns and t: the fused leaf's rule attaches it
    (1000 x 302 x 2 chunks <= 4,096,000), and nothing attaches K1."""
    from dynamichmc_tpu_torch.ops.tree_kernel import tree_kernel_pays

    assert fused_leaf_pays(1000, 302)
    assert tree_kernel_pays(1000, 302, fused=True)  # the flat rule would


@pytest.mark.parametrize("profiled", [True, False])
def test_a_short_run_is_finite_and_counts_its_leaves(profiled):
    """8 chains x 16 draws through the hook's plain version: finite draws;
    under a profiler ``fused_leaf_rows`` counts the chain rows the hook
    was handed by phase, 8 a leaf, and ``dhmc.leaf`` one span a leaf;
    without one neither is kept. No launch on the CPU."""
    x, y = _data()
    model = hlr(x, y, rate=RATE, dtype=torch.float32, device="cpu",
                fused=True)
    stages = default_warmup_stages(
        init_steps=20, middle_steps=20, doubling_stages=1,
        terminating_steps=20, metric_kind="diagonal", pooled=True)
    reset_launch_counts()
    with torch.profiler.profile() if profiled else contextlib.nullcontext():
        res = run_chains(torch.Generator().manual_seed(4), model, 8, 16,
                         tune="reference", warmup_stages=stages,
                         algorithm=NUTS(max_depth=4), dtype=torch.float32)
        counts = launch_counts()
    assert bool(torch.isfinite(res.positions).all())
    assert res.positions.shape == (8, 16, 12)
    assert counts["logreg_fused_leaf"] == counts[
        "logreg_fused_leaf_hier"] == 0
    if not profiled:
        assert not {"fused_leaf_rows", "spans"} & set(counts)
        return
    rows = counts["fused_leaf_rows"]
    assert set(rows) == {"warmup", "draws"}
    leaves = counts["driver_fused_leaves"]
    assert rows["warmup"] + rows["draws"] == 8 * leaves
    spans = counts["spans"]["dhmc.leaf"]
    assert sum(s["count"] for s in spans.values()) == leaves
    assert spans["draws"]["count"] * 8 == rows["draws"]
    assert counts["draw_steps"] <= rows["draws"]
