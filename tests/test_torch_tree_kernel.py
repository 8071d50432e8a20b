"""The tree-kernel module of the port (dynamichmc_tpu_torch.ops.tree_kernel).

On the CPU its wrapper computes the transition with the plain driver; that
function is held against the JAX Pallas kernel (ops/pallas_tree.py) run in
interpret mode, as tests/test_pallas_tree.py runs it, at float32 with the
JAX hook's exact noise (its key splits repeated here). Tolerance atol 1e-5
with discrete statistics exact, `work` excluded (the Pallas kernel counts
per chain block, the plain driver per batch): the two compute the same f32
transition with different summation orders.

The CUDA kernel itself runs only on a GPU: see tests/test_torch_gpu.py.
"""

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
from dynamichmc_tpu.ops.pallas_tree import _leaf_noise
from dynamichmc_tpu.tree_batched import _evaluate_b
from dynamichmc_tpu.tree_batched import rand_p_b as j_rand_p_b
from dynamichmc_tpu.tree_batched import sample_tree_batched as j_sample
from dynamichmc_tpu_torch import convert
from dynamichmc_tpu_torch import models as tm
from dynamichmc_tpu_torch.hamiltonian import EvaluatedPoint
from dynamichmc_tpu_torch.metric import dense_metric, diagonal_metric
from dynamichmc_tpu_torch.nuts import NUTS
from dynamichmc_tpu_torch.ops import tree_kernel
from dynamichmc_tpu_torch.tree_batched import (
    depth_cap,
    finish_transition,
    sample_tree_batched,
)

KEY = jax.random.PRNGKey(0)
ATOL = 1e-5
F32 = torch.float32


def _model_arrays(K):
    """The kernel's model operands, built as models/gaussian.py builds them."""
    cov = np.asarray(jm.correlated_gaussian(K).cov_fn(), np.float64)
    prec = np.linalg.inv(cov)
    lt = np.linalg.cholesky(prec).T
    prec_t = torch.as_tensor(prec.astype(np.float32)).mT.contiguous()
    lchol = torch.as_tensor(lt.astype(np.float32)).mT.contiguous()
    return cov, prec_t, lchol, torch.zeros(K, dtype=F32)


def _setup(K, C, seed):
    ld_kern = jm.correlated_gaussian(K, dtype=jnp.float32, tree_kernel=True)
    q0 = jnp.asarray(np.random.default_rng(seed).normal(size=(C, K)),
                     jnp.float32)
    vals, grads = _evaluate_b(ld_kern, q0)
    return ld_kern, JEvaluatedPoint(q=q0, logdensity=vals, grad=grads)


def _both(key, md, jmetric, ld_kern, Q, eps, depth_limit=None):
    """(JAX Pallas-kernel transition, port kernel-module transition)."""
    C, K = Q.q.shape
    a = j_sample(key, JNUTS(max_depth=md), ld_kern, jmetric, Q,
                 jnp.asarray(eps, jnp.float32), depth_limit=depth_limit)
    # the JAX hook's noise: split(key, 3), rand_p_b, bits, _leaf_noise
    k_p, k_dir, k_tree = jax.random.split(key, 3)
    p0 = j_rand_p_b(k_p, jmetric, (C, K), jnp.float32)
    dirs = jax.random.bits(k_dir, (C,), jnp.uint32)
    gum, expo = _leaf_noise(k_tree, md, C)
    _cov, prec_t, lchol, mu = _model_arrays(K)
    Qt = convert.evaluated_point(Q, F32)
    raw = tree_kernel.tree_transition(
        Qt.q, convert.tensor(p0, F32), Qt.grad, Qt.logdensity,
        torch.as_tensor(np.broadcast_to(np.asarray(eps, np.float32), (C,))),
        convert.tensor(dirs), convert.tensor(gum, F32),
        convert.tensor(expo, F32), convert.tensor(jmetric.m_inv, F32),
        tree_kernel.gaussian_leaf(prec_t, lchol, mu),
        depth_cap(depth_limit, md), -1000.0, md,
    )
    return a, finish_transition(raw)


def _assert_transition_equal(a, b):
    (Qa, sa), (Qb, sb) = a, b
    for x, y in ((Qa.q, Qb.q), (Qa.logdensity, Qb.logdensity),
                 (Qa.grad, Qb.grad), (sa.acceptance_rate, sb.acceptance_rate)):
        np.testing.assert_allclose(convert.to_numpy(y), np.asarray(x),
                                   atol=ATOL)
    for name in ("depth", "steps", "term_left", "term_right", "is_divergent"):
        np.testing.assert_array_equal(
            convert.to_numpy(getattr(sb, name)), np.asarray(getattr(sa, name)),
            err_msg=name,
        )


def test_plain_kernel_matches_pallas_dense_chained():
    ld_kern, Q = _setup(K=3, C=10, seed=0)
    jmetric = j_dense(jnp.asarray(np.asarray(ld_kern.cov_fn(), np.float32)))
    for i in range(3):
        a, b = _both(jax.random.fold_in(KEY, i), 4, jmetric, ld_kern, Q, 0.3)
        _assert_transition_equal(a, b)
        Q = a[0]


def test_plain_kernel_matches_pallas_diagonal():
    ld_kern, Q = _setup(K=5, C=7, seed=3)
    jmetric = j_diag(jnp.asarray(np.linspace(0.5, 2.0, 5), jnp.float32))
    _assert_transition_equal(*_both(KEY, 4, jmetric, ld_kern, Q, 0.25))


def test_plain_kernel_matches_pallas_per_chain_eps():
    ld_kern, Q = _setup(K=4, C=9, seed=5)
    jmetric = j_diag(jnp.ones((4,), jnp.float32))
    eps = np.random.default_rng(2).uniform(0.1, 0.5, size=9)
    _assert_transition_equal(*_both(KEY, 5, jmetric, ld_kern, Q, eps))


@pytest.mark.parametrize("depth_limit", [2, 3, 0])
def test_plain_kernel_matches_pallas_depth_limit(depth_limit):
    ld_kern, Q = _setup(K=3, C=16, seed=1)
    jmetric = j_dense(jnp.asarray(np.asarray(ld_kern.cov_fn(), np.float32)))
    a, b = _both(KEY, 6, jmetric, ld_kern, Q, 0.2, depth_limit=depth_limit)
    _assert_transition_equal(a, b)
    if depth_limit:
        assert int(b[1].depth.max()) <= depth_limit


def test_plain_kernel_matches_pallas_divergent():
    ld_kern, Q = _setup(K=3, C=12, seed=4)
    jmetric = j_dense(jnp.asarray(np.asarray(ld_kern.cov_fn(), np.float32)))
    a, b = _both(KEY, 4, jmetric, ld_kern, Q, 40.0)
    _assert_transition_equal(a, b)
    assert bool(b[1].is_divergent.any())


def _port_setup(K=3, C=6, dtype=F32):
    model = tm.correlated_gaussian(K, dtype=dtype, tree_kernel=True, device="cpu")
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(C, K)),
                        dtype=dtype)
    v, g = model.logdensity_and_gradient(q)
    return model, EvaluatedPoint(q=q, logdensity=v, grad=g)


def test_hook_declines_outside_its_regime():
    class CustomTurn:
        def leaf(self, metric, z):
            return z

        def combine(self, metric, x, y):
            return x, False

    model, Q = _port_setup()
    hook = model.tree_transition_fn
    gen = torch.Generator().manual_seed(0)
    cov = model.cov_fn().to(F32)
    shared = dense_metric(cov)
    # float64 chains
    model64, Q64 = _port_setup(dtype=torch.float64)
    assert model64.tree_transition_fn(
        gen, NUTS(max_depth=3), dense_metric(cov.double()), Q64, 0.3
    ) is None
    # a turn statistic other than "generalized"
    assert hook(gen, NUTS(max_depth=3, turn_statistic_configuration=CustomTurn()),
                shared, Q, 0.3) is None
    # per-chain metrics, dense and diagonal
    per_chain = dense_metric(cov.expand(6, 3, 3).contiguous())
    assert hook(gen, NUTS(max_depth=3), per_chain, Q, 0.3) is None
    assert hook(gen, NUTS(max_depth=3), diagonal_metric(torch.ones(6, 3)),
                Q, 0.3) is None
    # a CTA that does not fit: > 1024 threads or > 227 KB shared memory
    assert tree_kernel.kernel_fits(100, 4) and tree_kernel.kernel_fits(1024, 10)
    assert not tree_kernel.kernel_fits(1025, 4)
    assert not tree_kernel.kernel_fits(1024, 30)
    assert tree_kernel.smem_bytes(100, 4) == 11520


def test_declined_hook_runs_plain_driver():
    """A declined hook (f64 chains) leaves the transition to the plain
    driver: the same draws as a model without the hook."""
    model64, Q64 = _port_setup(dtype=torch.float64)
    plain64 = tm.correlated_gaussian(3, dtype=torch.float64, device="cpu")
    metric = dense_metric(model64.cov_fn())
    a = sample_tree_batched(torch.Generator().manual_seed(1), NUTS(max_depth=3),
                            model64, metric, Q64, 0.3)
    b = sample_tree_batched(torch.Generator().manual_seed(1), NUTS(max_depth=3),
                            plain64, metric, Q64, 0.3)
    np.testing.assert_array_equal(a[0].q.numpy(), b[0].q.numpy())


def test_hook_on_cpu_takes_plain_version_without_launching():
    tree_kernel.reset_launches()
    model, Q = _port_setup(C=8)
    metric = dense_metric(model.cov_fn().to(F32))
    Q_new, stats = sample_tree_batched(torch.Generator().manual_seed(2),
                                       NUTS(max_depth=4), model, metric, Q,
                                       0.3, depth_limit=2)
    assert tree_kernel.launches == 0
    assert Q_new.q.shape == (8, 3) and torch.isfinite(Q_new.q).all()
    assert int(stats.depth.max()) <= 2
    assert stats.work.dtype == torch.int32


def test_wrapper_rejects_other_devices():
    q = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tree_kernel.tree_transition(q, q, q, q[:, 0], q[:, 0], q[:, 0], q, q,
                                    q, tree_kernel.funnel_leaf(3, 3.0), 1,
                                    -1000.0, 1)



# --- the logreg leaf: one pass over X through a ring of row tiles ----------

def _old_smem_bytes(K, md, n_obs):
    """The earlier design's shared memory: a residual buffer of n_obs
    floats beside the merge stack."""
    kp = (K + 31) // 32 * 32
    return 4 * ((5 * md + 1) * kp + 6 * 32 + n_obs)


@pytest.mark.parametrize("K,md,n_obs,ring", [
    (1024, 10, 100, True), (128, 4, 4000, True), (128, 4, 55000, True),
    (7, 4, 53, True), (33, 6, 300, True), (1000, 9, 2000, True),
    (256, 10, 20000, True), (1, 1, 1, True),
    # the merge stack leaves less than one row per ring stage: the tiles
    # are read from X in place
    (1024, 11, 1, False), (1024, 11, 500, False), (928, 12, 100, False),
    (864, 13, 1, False), (864, 13, 800, False), (1024, 11, 576, False),
])
def test_logreg_kernel_fits_what_fit_before(K, md, n_obs, ring):
    """The logreg leaf's shared memory no longer grows with n_obs: every
    (K, max_depth, n_obs) whose CTA fit with the n_obs-float residual buffer
    still fits, through the ring where one row per stage fits and else with
    the tiles read in place."""
    assert _old_smem_bytes(K, md, n_obs) <= tree_kernel.MAX_SMEM_BYTES
    assert tree_kernel.kernel_fits(K, md, logreg=True)
    tile, got_ring = tree_kernel.logreg_tiles(K, md)
    assert got_ring == ring
    assert 1 <= tile <= tree_kernel.TILE_ROWS
    assert tree_kernel.smem_bytes(K, md, tile, ring) <= tree_kernel.MAX_SMEM_BYTES


def test_logreg_ring_at_the_path_shape_and_at_the_widest_k():
    """K = 128, md 4 (the logreg_tree path): 32 rows per stage, 44,672
    bytes per CTA whatever n_obs (10^6 fits); K = 1024, md 10: the merge
    stack leaves room for 2 rows per stage; K = 1024, md 11 leaves less than
    one, so 32-row tiles are read in place with 128 bytes of residuals;
    md 12 leaves no room for the merge stack itself."""
    assert tree_kernel.logreg_tiles(128, 4) == (32, True)
    assert tree_kernel.smem_bytes(128, 4, 32, True) == 44672
    assert tree_kernel.kernel_fits(128, 4, logreg=True)
    assert _old_smem_bytes(128, 4, 10**6) > tree_kernel.MAX_SMEM_BYTES
    assert tree_kernel.logreg_tiles(1024, 10) == (2, True)
    assert tree_kernel.logreg_tiles(1024, 11) == (32, False)
    assert (tree_kernel.smem_bytes(1024, 11, 32, False)
            == tree_kernel.smem_bytes(1024, 11) + 128)
    assert tree_kernel.kernel_fits(1024, 11, logreg=True)
    assert tree_kernel.logreg_tiles(1024, 12)[0] == 0
    assert not tree_kernel.kernel_fits(1024, 12, logreg=True)
    assert _old_smem_bytes(1024, 12, 1) > tree_kernel.MAX_SMEM_BYTES
    assert not tree_kernel.kernel_fits(1025, 4, logreg=True)


def test_logreg_hook_takes_n_obs_past_the_old_cap():
    """60,001 observations at K = 8, md 2: the earlier hook declined them
    (the residual buffer needed 235 KB); now the hook runs, on the CPU
    through the plain version."""
    assert _old_smem_bytes(8, 2, 60001) > tree_kernel.MAX_SMEM_BYTES
    model = tm.logistic_regression(60001, 8, dtype=F32, device="cpu",
                                   tree_kernel=True)
    q = torch.zeros((2, 8), dtype=F32)
    v, g = model.logdensity_and_gradient(q)
    tree_kernel.reset_launches()
    out = model.tree_transition_fn(
        torch.Generator().manual_seed(0), NUTS(max_depth=2),
        diagonal_metric(torch.full((8,), 1e-4)),
        EvaluatedPoint(q=q, logdensity=v, grad=g), 1e-3)
    assert out is not None and tree_kernel.launches == 0
    assert bool(torch.isfinite(out[0].q).all())


@pytest.mark.parametrize("K", [1, 5, 7, 8, 33, 40, 128])
def test_logreg_leaf_pads_x_and_stores_no_transpose(K):
    """X is stored with zero columns up to a multiple of 4 (16-byte rows)
    beside y, and nothing else: no X^T."""
    rng = np.random.default_rng(K)
    x, y = rng.normal(size=(13, K)), rng.integers(0, 2, 13).astype(float)
    leaf = tree_kernel.logreg_leaf(x, y, 10.0)
    assert len(leaf.operands) == 2 and leaf.n_obs == 13 and leaf.dim == K
    xp, yt = leaf.operands
    kx = (K + 3) // 4 * 4
    assert xp.shape == (13, kx) and xp.dtype == F32 and xp.is_contiguous()
    assert torch.equal(xp[:, :K], torch.as_tensor(x, dtype=F32))
    assert not bool(xp[:, K:].any())
    assert torch.equal(yt, torch.as_tensor(y, dtype=F32))
    assert tree_kernel._operand_shapes(leaf, K) == ((13, kx), (13,))
    x_logical, y_logical = leaf.logreg_data()
    assert torch.equal(x_logical, torch.as_tensor(x, dtype=F32))
    assert y_logical is yt


@pytest.mark.parametrize("n_obs,K", [(53, 7), (300, 33)])
def test_logreg_leaf_value_and_grad_matches_jax_leaf(monkeypatch, n_obs, K):
    """Leaf.value_and_grad on the padded operands against the JAX kernel's
    logreg_leaf (pallas_tree.py), captured from its hook factory, on the
    same numpy inputs at float64. The JAX leaf's dots return float32
    (preferred_element_type), so the tolerance is float32's: 1e-5
    (1 + |x|) on ld and the gradient."""
    from dynamichmc_tpu.ops import pallas_tree

    captured = {}

    def capture(leaf_builder, model_arrays, dim, **kw):
        captured.update(leaf=leaf_builder, arrays=model_arrays)

    monkeypatch.setattr(pallas_tree, "make_tree_transition", capture)
    x, y = _logreg_data(n_obs, K)
    pallas_tree.make_logreg_tree_transition(x, y, prior_scale=2.0)
    q = 0.3 * np.random.default_rng(1).normal(size=(5, K))
    kp = captured["arrays"][0].shape[1]
    q_col = jnp.asarray(np.pad(q.T, ((0, kp - K), (0, 0))), jnp.float64)
    refs = tuple(a.astype(jnp.float64) for a in captured["arrays"])
    ld_j, g_j = captured["leaf"](q_col, refs)
    leaf = tree_kernel.logreg_leaf(x, y, 2.0)
    ld_t, g_t = leaf.value_and_grad(torch.as_tensor(q, dtype=torch.float64))
    assert ld_t.dtype == torch.float64
    for a, b in ((np.asarray(ld_j)[0], ld_t), (np.asarray(g_j)[:K].T, g_t)):
        b = b.numpy()
        assert np.max(np.abs(a - b) / (1 + np.abs(b))) <= 1e-5


def _logreg_data(n_obs, K):
    rng = np.random.RandomState(n_obs)
    x = rng.randn(n_obs, K)
    y = (rng.uniform(size=n_obs) < 0.5).astype(np.float64)
    return x, y


# --- the warp variant (Gaussian and funnel leaves): plan and dispatch -------

@pytest.mark.parametrize("K,md,diag,warps,smem", [
    # the main path: dense, K = 100, max_depth 4: 120,000 bytes of prec^T,
    # L and M^-1, and 8 warps of 10,752 bytes (21 x 128 floats): the
    # registers cap R = 4 at 8 warps (10 would fit in shared memory)
    (100, 4, False, 8, 120000 + 8 * 10752),
    # diagonal: 80,000 bytes of matrices
    (100, 4, True, 8, 80000 + 8 * 10752),
    (100, 10, False, 4, 120000 + 4 * 26112),
    # K = 128: the matrices take 196,608 of the 232,448 bytes
    (128, 4, False, 3, 196608 + 3 * 10752),
    (128, 10, False, 1, 196608 + 26112),
    (128, 13, False, 1, 196608 + 33792),
    (128, 14, False, 0, 0),
    (127, 14, False, 1, 3 * 4 * 16132 + 36352),
    (128, 14, True, 2, 131072 + 2 * 36352),
    # R = 5: past the warp variant
    (129, 4, False, 0, 0), (129, 4, True, 0, 0),
    # small K: 16 warps (R <= 2), K^2 rounded up to 4 floats per matrix
    (1, 4, True, 16, 2 * 16 + 16 * 2688),
    (5, 4, False, 16, 3 * 4 * 28 + 16 * 2688),
    (33, 7, True, 16, 2 * 4 * 1092 + 16 * 4 * 36 * 64),
    # R = 3 at 12 warps: 15 would fit in shared memory
    (96, 4, False, 12, 3 * 4 * 9216 + 12 * 8064),
    (97, 4, False, 8, 3 * 4 * 9412 + 8 * 10752),
    (97, 7, False, 6, 3 * 4 * 9412 + 6 * 18432),
])
def test_gaussian_warp_plan(K, md, diag, warps, smem):
    """Warps per CTA and shared memory of the warp variant: the staged
    matrices (K^2 floats each, rounded up to 4: prec^T, L and, dense, M^-1)
    and one region per warp of (5 max_depth + 1) x 32 R floats, as many as
    227 KB holds, at most 16 warps (12 at R = 3, 8 at R = 4: what the
    registers allow without a spill)."""
    assert tree_kernel.warp_plan(tree_kernel.GAUSSIAN, K, md, diag) == (warps, smem)
    _assert_warps_fill_the_plan(tree_kernel.GAUSSIAN, K, md, warps, smem)


def _assert_warps_fill_the_plan(kind, K, md, warps, smem):
    assert smem <= tree_kernel.MAX_SMEM_BYTES
    if warps:
        r = -(-K // 32)
        per_warp = 4 * (5 * md + 1) * 32 * r
        # one more warp would not fit, or the register cap is reached
        assert (smem + per_warp > tree_kernel.MAX_SMEM_BYTES
                or warps == tree_kernel.warp_max_warps(kind, r))


@pytest.mark.parametrize("K,md,diag,warps,smem", [
    # no matrix with a diagonal metric: at R = 1 10 warps (FUNNEL_WARPS) of
    # (5 md + 1) x 32 floats (2,688 bytes at md 4, 4,608 at md 7, 6,528 at
    # md 10)
    (2, 4, True, 10, 10 * 2688),
    (2, 7, True, 10, 10 * 4608),
    (2, 10, True, 10, 10 * 6528),
    # the funnel path: K = 25, md 7, diagonal
    (25, 7, True, 10, 10 * 4608),
    (25, 4, True, 10, 10 * 2688),
    (25, 10, True, 10, 10 * 6528),
    # dense: M^-1 alone is staged, K^2 floats rounded up to 4 (625 -> 628)
    (2, 7, False, 10, 4 * 4 + 10 * 4608),
    (25, 7, False, 10, 4 * 628 + 10 * 4608),
    (25, 10, False, 10, 4 * 628 + 10 * 6528),
    # R = 2: 16 warps of (5 md + 1) x 64 floats
    (33, 4, True, 16, 16 * 5376),
    (33, 7, True, 16, 16 * 9216),
    (33, 7, False, 16, 4 * 1092 + 16 * 9216),
    # md 10 at R = 2: 13,056 bytes a warp, 17 would fit, the registers cap
    # 16
    (33, 10, True, 16, 16 * 13056),
    # R = 4: 8 warps, or as many as the shared memory holds
    (100, 4, True, 8, 8 * 10752),
    (100, 7, True, 8, 8 * 18432),
    (100, 10, True, 8, 8 * 26112),
    (100, 10, False, 7, 40000 + 7 * 26112),
    (128, 4, False, 8, 65536 + 8 * 10752),
    (128, 7, True, 8, 8 * 18432),
    (128, 10, True, 8, 8 * 26112),
    (128, 10, False, 6, 65536 + 6 * 26112),
    # R = 5: past the warp variant
    (129, 7, True, 0, 0),
])
def test_funnel_warp_plan(K, md, diag, warps, smem):
    """The funnel leaf's warp plan: no staged matrix with a diagonal metric
    and M^-1 alone with a dense one, then one region per warp of merge
    stack and staging vector, as many as 227 KB holds, at most
    warp_max_warps(FUNNEL, R): 10 at R = 1 (two CTAs an SM), the
    Gaussian's 16 / 12 / 8 at R = 2 / 3 / 4."""
    assert tree_kernel.warp_plan(tree_kernel.FUNNEL, K, md, diag) == (warps, smem)
    _assert_warps_fill_the_plan(tree_kernel.FUNNEL, K, md, warps, smem)


def test_logreg_leaf_has_no_warp_plan():
    for K in (1, 25, 128):
        for diag in (False, True):
            assert tree_kernel.warp_plan(tree_kernel.LOGREG, K, 4, diag) == (0, 0)


# --- the logreg leaf's staged-X variant: plan and dispatch ------------------

@pytest.mark.parametrize("K,md,n_obs,diag,warps,smem", [
    # the benchmark's shape: rows of 28 floats (7 chunks, odd), 1000 of X
    # and y in 116,000 bytes, then 8 warps of (5 md + 1) x 32 floats
    (25, 4, 1000, True, 8, 4 * (1000 * 28 + 1000) + 8 * 2688),
    (28, 4, 1000, True, 8, 4 * (1000 * 28 + 1000) + 8 * 2688),
    # dense: M^-1 too, 625 floats rounded up to 628
    (25, 13, 1000, False, 8, 4 * (1000 * 28 + 1000 + 628) + 8 * 8448),
    # the largest n_obs at K = 25, md 4, diagonal: 4 warps, and one row past
    # it none
    (25, 4, 1911, True, 4, 4 * (1911 * 28 + 1912) + 4 * 2688),
    (25, 4, 1912, True, 0, 0),
    # K = 32: 8 chunks a row (even), so a 36-float stride
    (32, 4, 1000, True, 8, 4 * (1000 * 36 + 1000) + 8 * 2688),
    (1, 4, 1000, True, 8, 4 * (1000 * 4 + 1000) + 8 * 2688),
    (1, 10, 10316, False, 4, 4 * (10316 * 4 + 10316 + 4) + 4 * 6528),
    (1, 10, 10317, False, 0, 0),
    # R = 2: 4 lanes a row of 3 chunks each (48 floats), 6 warps fit
    (33, 4, 1000, True, 6, 4 * (1000 * 48 + 1000) + 6 * 5376),
    (33, 10, 919, True, 4, 4 * (919 * 48 + 920) + 4 * 13056),
    (33, 10, 920, True, 0, 0),
    # R = 4: 8 lanes a row of 4 chunks each, made 5 (160 floats)
    (100, 4, 294, True, 4, 4 * (294 * 160 + 296) + 4 * 10752),
    (100, 4, 295, True, 0, 0),
    (128, 10, 96, False, 4, 4 * (96 * 160 + 96 + 16384) + 4 * 26112),
    (128, 13, 49, False, 4, 4 * (49 * 160 + 52 + 16384) + 4 * 33792),
    (128, 13, 50, False, 0, 0),
    # the CTA variant: past K = 128, an X of chip_smoke's logreg_tree, or
    # no observation
    (129, 4, 10, True, 0, 0), (128, 4, 4000, True, 0, 0),
    (8, 4, 60001, True, 0, 0), (25, 4, 0, True, 0, 0),
])
def test_logreg_xstaged_plan(K, md, n_obs, diag, warps, smem):
    """Warps per CTA and shared memory of the staged-X variant: X's rows at
    xs_stride, y rounded up to 4 floats, the dense M^-1 and one region per
    warp of (5 max_depth + 1) x 32 R floats, as many as 227 KB holds, at
    most XS_MAX_WARPS and at least XS_MIN_WARPS."""
    assert tree_kernel.xstaged_plan(K, md, n_obs, diag) == (warps, smem)
    assert smem <= tree_kernel.MAX_SMEM_BYTES
    if warps:
        per_warp = 4 * (5 * md + 1) * 32 * -(-K // 32)
        assert (smem + per_warp > tree_kernel.MAX_SMEM_BYTES
                or warps == tree_kernel.XS_MAX_WARPS)


@pytest.mark.parametrize("K", range(1, 129))
def test_logreg_xstaged_rows_are_bank_conflict_free(K):
    """Each quarter warp's 128-bit loads (8 lanes: 8 / G rows of G lanes,
    lane g of a row reading chunk c G + g) fall in 8 distinct 16-byte bank
    groups, for every chunk c a lane reads; the lanes' chunks cover K
    columns and fit the warp's 32 R-float staging vector."""
    r = -(-K // 32)
    g = tree_kernel.xs_lanes(r)
    stride4 = tree_kernel.xs_stride(K) // 4
    nch = -(-(-(-K // 4)) // g)
    assert K <= 4 * g * nch <= 32 * r and stride4 >= g * nch
    for quarter in range(4):
        lanes = range(8 * quarter, 8 * quarter + 8)
        for c in range(nch):
            banks = {((lane // g) * stride4 + c * g + lane % g) % 8
                     for lane in lanes}
            assert len(banks) == 8, (K, quarter, c)


@pytest.mark.parametrize("K,md,diag,n_obs,variant", [
    (25, 4, True, 1000, "xstaged"), (25, 4, False, 1000, "xstaged"),
    (25, 2, True, 1000, "xstaged"), (25, 4, True, 1912, "cta"),
    (128, 4, True, 4000, "cta"), (8, 4, True, 60001, "cta"),
    (128, 4, True, 0, "cta"), (129, 4, True, 100, "cta"),
    (1024, 12, True, 100, None),
])
def test_logreg_kernel_variant_by_n_obs(K, md, diag, n_obs, variant):
    """The logreg leaf takes the staged-X variant wherever X fits, the CTA
    variant elsewhere: the benchmark's 1000 x 25 at max_depth 4 and at the
    warmup's clamp, against chip_smoke's 4000 x 128 and the GPU tests'
    60,001 x 8."""
    assert tree_kernel.kernel_variant(tree_kernel.LOGREG, K, md, diag,
                                      n_obs) == variant


def test_launch_counts_carry_the_xstaged_launches():
    from dynamichmc_tpu_torch import ops

    tree_kernel.xstaged_launches = 3
    assert ops.launch_counts()["tree_transition_xstaged"] == 3
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    assert counts["tree_transition_xstaged"] == 0
    assert counts["tree_transition"] == counts["tree_transition_warp"] == 0


@pytest.mark.parametrize("kind,K,md,diag,variant", [
    (tree_kernel.GAUSSIAN, 100, 4, False, "warp"),
    (tree_kernel.GAUSSIAN, 100, 4, True, "warp"),
    (tree_kernel.GAUSSIAN, 1, 1, True, "warp"),
    (tree_kernel.GAUSSIAN, 128, 13, False, "warp"),
    (tree_kernel.GAUSSIAN, 128, 14, False, "cta"),
    (tree_kernel.GAUSSIAN, 129, 4, False, "cta"),
    (tree_kernel.GAUSSIAN, 1024, 10, True, "cta"),
    (tree_kernel.GAUSSIAN, 1025, 4, True, None),
    (tree_kernel.GAUSSIAN, 1024, 30, False, None),
    # the funnel leaf takes the warp variant up to K = 128, the logreg leaf
    # keeps one CTA per chain at every K
    (tree_kernel.FUNNEL, 25, 7, True, "warp"),
    (tree_kernel.FUNNEL, 5, 4, False, "warp"),
    (tree_kernel.FUNNEL, 128, 14, False, "warp"),
    (tree_kernel.FUNNEL, 129, 7, True, "cta"),
    (tree_kernel.FUNNEL, 1024, 10, True, "cta"),
    (tree_kernel.LOGREG, 128, 4, True, "cta"),
    (tree_kernel.LOGREG, 1024, 12, True, None),
])
def test_kernel_variant_by_shape(kind, K, md, diag, variant):
    assert tree_kernel.kernel_variant(kind, K, md, diag) == variant


@pytest.mark.parametrize("K,md,diag", [(100, 4, False), (129, 4, True)])
def test_hook_takes_a_variant_and_the_cpu_wrapper_launches_none(K, md, diag):
    """A Gaussian hook runs wherever a variant takes the shape; on CPU
    tensors it takes the plain version and counts no launch of either
    variant."""
    model = tm.correlated_gaussian(K, dtype=F32, tree_kernel=True,
                                   device="cpu")
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(3, K)),
                        dtype=F32)
    v, g = model.logdensity_and_gradient(q)
    cov = model.cov_fn().to(F32)
    metric = (diagonal_metric(torch.diagonal(cov).contiguous()) if diag
              else dense_metric(cov))
    tree_kernel.reset_launches()
    out = model.tree_transition_fn(
        torch.Generator().manual_seed(0), NUTS(max_depth=md), metric,
        EvaluatedPoint(q=q, logdensity=v, grad=g), 0.1, depth_limit=2)
    assert out is not None and bool(torch.isfinite(out[0].q).all())
    assert tree_kernel.launches == tree_kernel.warp_launches == 0
