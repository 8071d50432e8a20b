"""The port's funnel and logreg leaves against the JAX package's kernels.

- The whole-transition kernel's plain version (ops/tree_kernel.py with the
  funnel and logreg leaves) against ``make_funnel_tree_transition`` /
  ``make_logreg_tree_transition`` run in interpret mode, on the JAX hook's
  exact noise (its key splits repeated here): float32, atol 1e-5 on q',
  grad' and the acceptance (ld' 1e-4 for logreg, as test_pallas_tree.py
  holds the JAX kernel), discrete statistics exact.
- The fused logreg leaf's plain version (ops/logreg_leaf.py) against
  ``make_logreg_fused_leaf_batched`` in interpret mode, in all three metric
  forms, with an observation count no tile divides, past 256 coordinates
  and with poisoning; and the CUDA kernel's launch plan (pure Python).
- The plain batch driver with a fused-leaf hook against the JAX driver with
  the same hook, on injected momenta, directions and noise.

The CUDA kernels themselves run only on a GPU: see tests/test_torch_gpu.py.
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
from dynamichmc_tpu.tree import TreeNoise as JTreeNoise
from dynamichmc_tpu.tree_batched import _evaluate_b
from dynamichmc_tpu.tree_batched import rand_p_b as j_rand_p_b
from dynamichmc_tpu.tree_batched import sample_tree_batched as j_sample
from dynamichmc_tpu_torch import convert
from dynamichmc_tpu_torch import tree_batched as tb
from dynamichmc_tpu_torch.nuts import NUTS
from dynamichmc_tpu_torch.ops import logreg_leaf, tree_kernel
from dynamichmc_tpu_torch.tree import TreeNoise
from dynamichmc_tpu_torch.tree_batched import depth_cap, finish_transition

KEY = jax.random.PRNGKey(0)
ATOL = 1e-5
F32 = torch.float32


def _funnel_start(K, C, seed):
    """Draws of funnel(K) with v kept in [-2, 2]: a start off the neck,
    where a float32 trajectory is not chaotic."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-2.0, 2.0, size=(C, 1))
    return np.concatenate([v, np.exp(v / 2) * rng.normal(size=(C, K - 1))], 1)


def _jax_point(jmodel, q0):
    q = jnp.asarray(q0, jnp.float32)
    vals, grads = _evaluate_b(jmodel, q)
    return JEvaluatedPoint(q=q, logdensity=vals, grad=grads)


def _both(key, md, jmetric, jmodel, leaf, Q, eps, depth_limit=None):
    """(JAX Pallas-kernel transition, port kernel-module transition)."""
    C, K = Q.q.shape
    a = j_sample(key, JNUTS(max_depth=md), jmodel, jmetric, Q,
                 jnp.asarray(eps, jnp.float32), depth_limit=depth_limit)
    k_p, k_dir, k_tree = jax.random.split(key, 3)
    p0 = j_rand_p_b(k_p, jmetric, (C, K), jnp.float32)
    dirs = jax.random.bits(k_dir, (C,), jnp.uint32)
    gum, expo = _leaf_noise(k_tree, md, C)
    Qt = convert.evaluated_point(Q, F32)
    raw = tree_kernel.tree_transition(
        Qt.q, convert.tensor(p0, F32), Qt.grad, Qt.logdensity,
        torch.as_tensor(np.broadcast_to(np.asarray(eps, np.float32), (C,))),
        convert.tensor(dirs), convert.tensor(gum, F32),
        convert.tensor(expo, F32), convert.tensor(jmetric.m_inv, F32), leaf,
        depth_cap(depth_limit, md), -1000.0, md,
    )
    return a, finish_transition(raw)


def _assert_transition_equal(a, b, ld_atol=ATOL):
    (Qa, sa), (Qb, sb) = a, b
    for x, y, atol in ((Qa.q, Qb.q, ATOL), (Qa.grad, Qb.grad, ATOL),
                       (Qa.logdensity, Qb.logdensity, ld_atol),
                       (sa.acceptance_rate, sb.acceptance_rate, ATOL)):
        np.testing.assert_allclose(convert.to_numpy(y), np.asarray(x),
                                   atol=atol)
    for name in ("depth", "steps", "term_left", "term_right", "is_divergent"):
        np.testing.assert_array_equal(
            convert.to_numpy(getattr(sb, name)), np.asarray(getattr(sa, name)),
            err_msg=name,
        )


@pytest.mark.parametrize("eps,depth_limit", [(0.2, None), (0.35, 3),
                                             (2.5, None)])
def test_plain_funnel_kernel_matches_pallas(eps, depth_limit):
    K, C, md = 5, 12, 5
    jmodel = jm.funnel(K, dtype=jnp.float32, tree_kernel=True)
    Q = _jax_point(jmodel, _funnel_start(K, C, seed=1))
    jmetric = j_diag(jnp.asarray([3.0, 1.0, 1.5, 0.8, 1.2], jnp.float32))
    a, b = _both(KEY, md, jmetric, jmodel, tree_kernel.funnel_leaf(K, 3.0),
                 Q, eps, depth_limit)
    _assert_transition_equal(a, b)
    if eps > 1:
        assert bool(b[1].is_divergent.any())


def test_plain_funnel_kernel_matches_pallas_chained_dense():
    K, C, md = 5, 12, 4
    jmodel = jm.funnel(K, dtype=jnp.float32, tree_kernel=True)
    Q = _jax_point(jmodel, _funnel_start(K, C, seed=2))
    jmetric = j_dense(jnp.asarray(np.diag([3.0, 1.0, 1.0, 1.0, 1.0])
                                  + 0.1, jnp.float32))
    leaf = tree_kernel.funnel_leaf(K, 3.0)
    for i in range(2):
        a, b = _both(jax.random.fold_in(KEY, i), md, jmetric, jmodel, leaf,
                     Q, 0.25)
        _assert_transition_equal(a, b)
        Q = a[0]


@pytest.mark.parametrize("eps", [0.05, 0.2])
def test_plain_logreg_kernel_matches_pallas(eps):
    K, C, n_obs = 7, 10, 53  # n_obs deliberately not a multiple of 8
    jmodel = jm.logistic_regression(n_obs, K, dtype=jnp.float32,
                                    tree_kernel=True)
    x, y, prior_scale = convert.logreg_data(jmodel)
    Q = _jax_point(jmodel, np.random.default_rng(0).normal(size=(C, K)) * 0.3)
    jmetric = j_diag(jnp.ones((K,), jnp.float32))
    a, b = _both(jax.random.PRNGKey(3), 4, jmetric, jmodel,
                 tree_kernel.logreg_leaf(x, y, prior_scale), Q, eps)
    _assert_transition_equal(a, b, ld_atol=1e-4)


# --- the fused logreg leaf (K3) ---------------------------------------------

def _leaf_operands(seed, C, K, scale=0.5):
    rng = np.random.RandomState(seed)
    q = (scale * rng.randn(C, K)).astype(np.float32)
    p = rng.randn(C, K).astype(np.float32)
    g = rng.randn(C, K).astype(np.float32)
    eps = rng.uniform(-0.2, 0.2, C).astype(np.float32)
    return q, p, g, eps


def _metric_pair(kind, C, K, seed=2):
    rng = np.random.RandomState(seed)
    if kind == "shared_diag":
        m = np.linspace(0.5, 2.0, K).astype(np.float32)
        return j_diag(jnp.asarray(m)), convert.metric(j_diag(jnp.asarray(m)))
    if kind == "chain_diag":
        m = rng.uniform(0.5, 2.0, (C, K)).astype(np.float32)
        return j_diag(jnp.asarray(m)), convert.metric(j_diag(jnp.asarray(m)))
    a = rng.randn(K, K)
    m = (a @ a.T / K + np.eye(K)).astype(np.float32)
    jmet = j_dense(jnp.asarray(m))
    return jmet, convert.metric(jmet, F32)


def _fused_pair(n_obs, K, dtype=jnp.float32):
    jmodel = jm.logistic_regression(n_obs, K, dtype=dtype, fused=True)
    tmodel = convert.logreg_model(jmodel, dtype=F32, fused=True, device="cpu")
    return jmodel.fused_leaf_batched_fn, tmodel.fused_leaf_batched_fn


def _check_leaf(a, b, atol=ATOL, ld_atol=1e-4):
    names = ("q'", "p'", "g'", "ld'", "pi'")
    for name, x, y in zip(names, a, b):
        tol = ld_atol if name in ("ld'", "pi'") else atol
        np.testing.assert_allclose(convert.to_numpy(y), np.asarray(x),
                                   atol=tol, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind", ["shared_diag", "chain_diag", "shared_dense"])
@pytest.mark.parametrize("n_obs,K,C", [(53, 7, 10), (200, 11, 24),
                                       (53, 257, 4), (53, 300, 6)])
def test_plain_fused_leaf_matches_pallas(kind, n_obs, K, C):
    """On CPU tensors the float32 hook takes the plain leaf (no launch) at
    the JAX hook's value, for every K the JAX kernel takes: 257 and 300
    (kp 384 at n_obs 53) lie past the 256 coordinates one CTA of the CUDA
    kernel covers, where it splits the gradient into chunks."""
    jfused, tfused = _fused_pair(n_obs, K)
    jmet, tmet = _metric_pair(kind, C, K)
    q, p, g, eps = _leaf_operands(n_obs, C, K, scale=0.5 if K < 256 else 0.1)
    a = jfused(jmet, *(jnp.asarray(v) for v in (q, p, g, eps)))
    logreg_leaf.reset_launches()
    b = tfused(tmet, *(torch.as_tensor(v) for v in (q, p, g, eps)))
    assert logreg_leaf.launches == 0  # CPU tensors: the plain version
    assert b[0].dtype == F32
    _check_leaf(a, b)


def test_plain_fused_leaf_poisoning_matches_pallas():
    K, C = 7, 6
    jfused, tfused = _fused_pair(53, K)
    jmet, tmet = _metric_pair("shared_diag", C, K)
    q, p, g, eps = _leaf_operands(9, C, K)
    p[0] = 1e25   # the drift overflows: q' = inf, ld' = -inf
    q[1, 2] = np.nan  # non-finite position: poisoned
    p[2] = 3e19   # p'^2 overflows: K(p') = inf, pi' = -inf
    eps[2] = 1e-3
    a = jfused(jmet, *(jnp.asarray(v) for v in (q, p, g, eps)))
    b = tfused(tmet, *(torch.as_tensor(v) for v in (q, p, g, eps)))
    poisoned = {"ld'": 2, "pi'": 3}  # chain 2 keeps a finite (huge) ld'
    for (name, n_bad), x, y in zip(poisoned.items(), a[3:], b[3:]):
        x, y = np.asarray(x), convert.to_numpy(y)
        np.testing.assert_array_equal(np.isneginf(y), np.isneginf(x), name)
        assert np.isneginf(y[:n_bad]).all() and np.isfinite(y[n_bad:]).all()
    _check_leaf([v[3:] for v in a], [v[3:] for v in b])


def test_fused_leaf_declines_to_plain_leaf_in_float64():
    """float64 chains and a per-chain dense metric take the plain leaf in
    the chains' dtype, as the JAX hook's fallback does."""
    K, C = 7, 5
    jfused, tfused = _fused_pair(53, K, dtype=jnp.float64)
    q, p, g, eps = (v.astype(np.float64) for v in _leaf_operands(4, C, K))
    m = np.linspace(0.5, 2.0, K)
    a = jfused(j_diag(jnp.asarray(m)), *(jnp.asarray(v) for v in (q, p, g, eps)))
    b = tfused(convert.metric(j_diag(jnp.asarray(m))),
               *(torch.as_tensor(v) for v in (q, p, g, eps)))
    assert b[0].dtype == torch.float64
    _check_leaf(a, b, atol=1e-10, ld_atol=1e-9)
    cov = np.eye(K) * np.linspace(0.5, 2.0, C)[:, None, None]
    jmet = jax.vmap(j_dense)(jnp.asarray(cov))
    a = jfused(jmet, *(jnp.asarray(v) for v in (q, p, g, eps)))
    b = tfused(convert.metric(jmet),
               *(torch.as_tensor(v) for v in (q, p, g, eps)))
    _check_leaf(a, b, atol=1e-10, ld_atol=1e-9)


# --- the fused leaf's launch plan -------------------------------------------

@pytest.mark.parametrize("sm_count,blocks_per_sm", [(132, 1), (132, 2),
                                                    (78, 3)])
def test_fused_leaf_launch_plan(sm_count, blocks_per_sm):
    """Every K from 1 to MAX_K gets a plan whose slice CTA fits the card's
    227 KB of shared memory: the tiled slice kernel's up to TILED_MAX_K,
    past it the chunked one's with the largest tile that fits; past MAX_K
    there is none. The observations' tiles go to S slices, none empty, of
    at least two tiles when S > 1, and the grid never outgrows what the
    card holds at once; S = 1 where the chain blocks and chunks fill the
    card by themselves. The SM count and the occupancy are arguments here:
    nothing is queried."""
    lp, limit = logreg_leaf, logreg_leaf.MAX_SMEM_BYTES
    assert lp.MAX_K >= 1024  # the tree kernel's widest K
    for K in range(1, lp.MAX_K + 1):
        plan = lp.launch_plan(64, K, 1000, sm_count, blocks_per_sm)
        assert plan.tiled == (K <= lp.TILED_MAX_K)
        if plan.tiled:
            assert plan.smem == lp.tiled_smem_bytes(K) <= limit
            assert plan.tile == lp.TILED_ROWS
            continue
        assert plan.smem == lp.smem_bytes(K, plan.tile) <= limit
        assert plan.tile == max(t for t in lp.TILE_ROWS
                                if lp.smem_bytes(K, t) <= limit)
    with pytest.raises(ValueError, match=f"K = {lp.MAX_K + 1} "):
        lp.launch_plan(64, lp.MAX_K + 1, 1000, sm_count, blocks_per_sm)
    holds = sm_count * blocks_per_sm
    for C, K, n_obs in [(2048, 128, 4000), (37, 300, 53), (16, 1024, 100),
                        (64, 40, 1000), (4096, 7, 100000), (1, 1, 1),
                        (300, 1100, 7000), (16384, 302, 1000),
                        (2048, 400, 4000), (128, 400, 4000), (64, 40, 100),
                        (64, 40, 32)]:
        plan = lp.launch_plan(C, K, n_obs, sm_count, blocks_per_sm)
        n_tiles = -(-n_obs // plan.tile)
        assert ((plan.slices - 1) * plan.tiles_per_slice < n_tiles
                <= plan.slices * plan.tiles_per_slice)
        chains = lp.TILED_CHAINS if plan.tiled else lp.CHAINS
        blocks = -(-C // chains) * plan.chunks
        assert plan.chunks == (1 if plan.tiled else
                               -(-K // (128 if K <= 128 else 256)))
        if blocks >= holds:
            assert plan.slices == 1, (C, K, n_obs)
        elif plan.slices > 1:
            assert plan.tiles_per_slice >= 2
            assert blocks * plan.slices <= holds


def test_fused_leaf_tiled_kernel_covers_the_hierarchical_cell():
    """The tiled slice kernel up to TILED_MAX_K, the widest K whose CTA
    fits in 227 KB, which covers the hierarchical cell's K = 302; MAX_K
    stays where the chunked kernel put it."""
    assert logreg_leaf.MAX_K == 1200
    assert logreg_leaf.TILED_MAX_K == 308
    tiled = logreg_leaf.tiled
    assert tiled(302) and tiled(308) and not tiled(309)
    assert not tiled(0) and not tiled(logreg_leaf.MAX_K + 1)


@pytest.mark.parametrize("K", [0, 2048])
def test_fused_leaf_no_plan_outside_what_a_kernel_takes(K):
    with pytest.raises(ValueError, match=f"K = {K}"):
        logreg_leaf.launch_plan(16, K, 100, 132, 1)


@pytest.mark.parametrize("C,K,n_obs,blocks_per_sm,want", [
    # the hierarchical cell: 256 tiled chain blocks fill the card alone
    (16384, 302, 1000, 1, (True, 1, 32)),
    # 2048 x 128 x 4000 (chip_smoke's logreg_fused): 32 chain blocks, so
    # 8 slices at 2 CTAs an SM and 4 at one
    (2048, 128, 4000, 2, (True, 8, 16)),
    (2048, 128, 4000, 1, (True, 4, 32)),
    # few rows: at least two tiles a slice
    (64, 40, 100, 2, (True, 2, 2)),
    (64, 40, 32, 2, (True, 1, 1)),
    # past TILED_MAX_K: 16-chain blocks times the gradient's chunks (16-row
    # tiles past K = 392)
    (2048, 400, 4000, 1, (False, 1, 250)),
    (128, 400, 4000, 1, (False, 8, 32)),
    (16, 1024, 100, 1, (False, 3, 3)),
])
def test_fused_leaf_launch_plan_on_the_h100(C, K, n_obs, blocks_per_sm, want):
    """(variant, slices, tiles a slice) on the H100's 132 SMs at the
    occupancy given; the rules they follow are test_fused_leaf_launch_plan's."""
    plan = logreg_leaf.launch_plan(C, K, n_obs, 132, blocks_per_sm)
    assert (plan.tiled, plan.slices, plan.tiles_per_slice) == want


@pytest.mark.parametrize("K", [1, 3, 4, 7, 8, 124, 128, 300, 302, 304, 308])
def test_fused_leaf_tiled_smem(K):
    """The tiled kernel's row stride (X's tiles and q'): K rounded up to 4,
    or 4 more where that is an even number of float4s (conflict-free float4
    loads); its shared memory the ring, y, q' of 64 chains and eight warps'
    partial logits."""
    kx = (K + 3) // 4 * 4
    stride = kx if kx // 4 % 2 else kx + 4
    assert stride // 4 % 2 == 1 and stride - kx in (0, 4)
    rows, chains = logreg_leaf.TILED_ROWS, logreg_leaf.TILED_CHAINS
    assert logreg_leaf.tiled_smem_bytes(K) == 4 * (
        2 * rows * (stride + 1) + chains * stride + 8 * rows * (chains + 8))


def test_fused_leaf_tiled_launches_are_counted():
    """``logreg_fused_leaf_tiled`` in ``ops.launch_counts()``, reset with
    the others; on CPU tensors the wrapper takes the plain version and
    launches neither slice kernel."""
    from dynamichmc_tpu_torch.metric import diagonal_metric
    from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    counts = launch_counts()
    assert counts["logreg_fused_leaf_tiled"] == counts["logreg_fused_leaf"] == 0
    logreg_leaf.launches, logreg_leaf.tiled_launches = 3, 2
    try:
        counts = launch_counts()
        assert (counts["logreg_fused_leaf"],
                counts["logreg_fused_leaf_tiled"]) == (3, 2)
    finally:
        reset_launch_counts()
    C, K, n = 5, 9, 40
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((n, K), generator=gen)
    y = (torch.rand(n, generator=gen) < 0.5).float()
    q, p, g = (torch.randn((C, K), generator=gen) for _ in range(3))
    out = logreg_leaf.logreg_leaf(diagonal_metric(torch.ones(K)), q, p, g,
                                  torch.full((C,), 0.1), x, y, 0.01)
    assert all(torch.isfinite(o).all() for o in out)
    counts = launch_counts()
    assert counts["logreg_fused_leaf"] == counts["logreg_fused_leaf_tiled"] == 0


# --- the plain driver with a fused-leaf hook --------------------------------

@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_driver_with_fused_leaf_matches_jax(kind):
    K, C, n_obs, md = 7, 10, 53, 4
    jmodel = jm.logistic_regression(n_obs, K, dtype=jnp.float32, fused=True)
    tmodel = convert.logreg_model(jmodel, dtype=F32, fused=True, device="cpu")
    rng = np.random.default_rng(5)
    Q = _jax_point(jmodel, rng.normal(size=(C, K)) * 0.3)
    Qt = convert.evaluated_point(Q, F32)
    p = rng.normal(size=(C, K)).astype(np.float32)
    dirs = rng.integers(0, 2**32, size=C, dtype=np.uint64).astype(np.uint32)
    gum = rng.gumbel(size=(md, 1 << (md - 1), C)).astype(np.float32)
    expo = rng.exponential(size=(md, C)).astype(np.float32)
    m = np.linspace(0.5, 1.5, K).astype(np.float32)
    jmetric = j_diag(jnp.asarray(m)) if kind == "diag" else j_dense(
        jnp.asarray(np.diag(m) + 0.05, jnp.float32))
    tmetric = convert.metric(jmetric, F32)
    eps = rng.uniform(0.05, 0.2, size=C).astype(np.float32)
    a = j_sample(KEY, JNUTS(max_depth=md), jmodel, jmetric, Q,
                 jnp.asarray(eps), directions=jnp.asarray(dirs),
                 p=jnp.asarray(p),
                 noise=JTreeNoise(jnp.asarray(gum), jnp.asarray(expo)))
    tb.reset_fused_leaf_calls()
    b = tb.sample_tree_batched(
        None, NUTS(max_depth=md), tmodel, tmetric, Qt, torch.as_tensor(eps),
        directions=convert.tensor(dirs), p=torch.as_tensor(p),
        noise=TreeNoise(torch.as_tensor(gum), torch.as_tensor(expo)))
    _assert_transition_equal(a, b, ld_atol=1e-4)
    np.testing.assert_array_equal(convert.to_numpy(b[1].work),
                                  np.asarray(a[1].work))
    # every executed leaf went through the hook
    assert tb.fused_leaf_calls == int(b[1].work[0]) > 0
