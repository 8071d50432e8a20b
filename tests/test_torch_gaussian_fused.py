"""Port parity: the fused Gaussian leaf (K2, ops/gaussian_leaf.py) and the
fused Gaussian leapfrog (K4, ops/gaussian_leapfrog.py) against the JAX
package's hooks on the same model, inputs made with numpy.

On the CPU the port's wrappers take their plain versions; the JAX hooks
run their Pallas kernels in interpret mode (K2, and K4 under vmap) or their
pure reference (K4 unbatched). float32 values agree to 1e-5 (1 + |x|): the
two sides sum the K products of each dot in different orders. The dense
and float64 fallbacks agree to 1e-12. A poisoned row (-inf) matches
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import models as jm
from dynamichmc_tpu.hamiltonian import PhasePoint as JPhasePoint
from dynamichmc_tpu.hamiltonian import evaluate as j_evaluate
from dynamichmc_tpu.hamiltonian import leapfrog as j_leapfrog
from dynamichmc_tpu.metric import dense_metric as j_dense
from dynamichmc_tpu.metric import diagonal_metric as j_diag
from dynamichmc_tpu_torch import convert
from dynamichmc_tpu_torch.hamiltonian import PhasePoint, evaluate, leapfrog
from dynamichmc_tpu_torch.metric import DiagonalMetric, dense_metric
from dynamichmc_tpu_torch.models import mvnormal
from dynamichmc_tpu_torch.ops import gaussian_leaf, gaussian_leapfrog

F32_TOL = 1e-5
F64_TOL = 1e-12


def _cov(K, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(K, K)
    return a @ a.T + K * np.eye(K), rng.randn(K)


def _pair(K, dtype):
    """The same N(mean, cov) with fused hooks in both packages."""
    cov, mean = _cov(K)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jmodel = jm.mvnormal(jnp.asarray(mean, jdt), cov, fused=True)
    tmodel = mvnormal(mean, cov, dtype=dtype, device="cpu", fused=True)
    return jmodel, tmodel


def _inputs(C, K, minv_kind, dtype, seed=1, poison=False):
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    q = rng.normal(size=(C, K)).astype(npdt)
    p = rng.normal(size=(C, K)).astype(npdt)
    g = rng.normal(size=(C, K)).astype(npdt)
    shape = (C, K) if minv_kind == "chain_diag" else (K,)
    if minv_kind == "dense":
        a = rng.normal(size=(K, K))
        minv = (a @ a.T / K + np.eye(K)).astype(npdt)
    else:
        minv = rng.uniform(0.5, 2.0, size=shape).astype(npdt)
    eps = (rng.choice([-1.0, 1.0], C) * rng.uniform(0.1, 0.5, C)).astype(npdt)
    if poison:
        p[0] = 1e25  # in float32 the drift overflows: ld' = -inf
        q[1, 0] = np.nan
    return q, p, g, minv, eps


def _metrics(minv, minv_kind):
    if minv_kind == "dense":
        return j_dense(jnp.asarray(minv)), dense_metric(torch.as_tensor(minv))
    return (j_diag(jnp.asarray(minv)),
            DiagonalMetric(m_inv=torch.as_tensor(minv), w_diag=None))


def _assert_close(x, y, tol):
    """|x - y| <= tol (1 + |y|); the same -inf entries."""
    x, y = convert.to_numpy(x).astype(np.float64), np.asarray(y, np.float64)
    np.testing.assert_array_equal(np.isneginf(x), np.isneginf(y))
    fine = np.isfinite(y)
    assert np.isfinite(x[fine]).all()
    err = np.abs(x[fine] - y[fine]) / (1 + np.abs(y[fine]))
    assert err.size == 0 or err.max() <= tol, err.max()


@pytest.mark.parametrize("minv_kind,dtype,tol", [
    ("shared_diag", torch.float32, F32_TOL),
    ("chain_diag", torch.float32, F32_TOL),
    ("dense", torch.float32, F32_TOL),
    ("shared_diag", torch.float64, F64_TOL),
    ("chain_diag", torch.float64, F64_TOL),
])
@pytest.mark.parametrize("poison", [False, True])
def test_fused_leaf_hook_matches_jax(minv_kind, dtype, tol, poison):
    """K2's hook: (q', p', g', ld', pi') of the JAX hook. float32 with a
    diagonal metric runs the JAX Pallas kernel (interpret mode); a dense
    metric or float64 takes both packages' plain fallbacks."""
    C, K = 11, 6
    jmodel, tmodel = _pair(K, dtype)
    q, p, g, minv, eps = _inputs(C, K, minv_kind, dtype, poison=poison)
    jmetric, tmetric = _metrics(minv, minv_kind)
    gaussian_leaf.reset_launches()
    out = tmodel.fused_leaf_batched_fn(tmetric, *map(torch.as_tensor,
                                                     (q, p, g, eps)))
    ref = jmodel.fused_leaf_batched_fn(jmetric, *map(jnp.asarray,
                                                     (q, p, g, eps)))
    assert gaussian_leaf.launches == 0  # CPU tensors: the plain version
    for x, y in zip(out, ref):
        assert x.dtype == dtype
        _assert_close(x, y, tol)
    if poison:  # row 0 overflows in float32 only, row 1 is NaN
        bad = 2 if dtype == torch.float32 else 1
        for x in out[3:]:
            assert int(torch.isneginf(x).sum()) == bad
            assert bool(torch.isneginf(x[:2]).any())
            assert bool(torch.isfinite(x[2:]).all())


@pytest.mark.parametrize("minv_kind,dtype,tol", [
    ("chain_diag", torch.float32, F32_TOL),
    ("shared_diag", torch.float32, F32_TOL),
    ("chain_diag", torch.float64, F64_TOL),
])
def test_fused_leapfrog_hook_matches_jax_vmap(minv_kind, dtype, tol):
    """K4's hook on a (C, K) batch against ``jax.vmap(leapfrog)`` on the
    JAX fused model, whose vmap rule runs the batched Pallas kernel
    (tests/test_pallas.py's batched case), with a poisoned row."""
    C, K = 12, 7
    jmodel, tmodel = _pair(K, dtype)
    q, p, _g, minv, eps = _inputs(C, K, minv_kind, dtype, seed=2,
                                  poison=True)

    def one(m, qq, pp, e):
        z = JPhasePoint(Q=j_evaluate(jmodel, qq), p=pp)
        return j_leapfrog(jmodel, j_diag(m), z, e)

    axes = 0 if minv_kind == "chain_diag" else None
    ref = jax.vmap(one, in_axes=(axes, 0, 0, 0))(
        jnp.asarray(minv), jnp.asarray(q), jnp.asarray(p), jnp.asarray(eps))
    z = PhasePoint(Q=evaluate(tmodel, torch.as_tensor(q)), p=torch.as_tensor(p))
    metric = DiagonalMetric(m_inv=torch.as_tensor(minv), w_diag=None)
    out = leapfrog(tmodel, metric, z, torch.as_tensor(eps))
    for x, y in ((out.Q.q, ref.Q.q), (out.p, ref.p), (out.Q.grad, ref.Q.grad),
                 (out.Q.logdensity, ref.Q.logdensity)):
        _assert_close(x, y, tol)
    bad = 2 if dtype == torch.float32 else 1  # row 0 overflows in float32
    assert int(torch.isneginf(out.Q.logdensity).sum()) == bad
    assert bool(torch.isneginf(out.Q.logdensity[1]))


@pytest.mark.parametrize("minv_kind,dtype,tol", [
    ("shared_diag", torch.float32, F32_TOL),
    ("dense", torch.float32, F32_TOL),
    ("shared_diag", torch.float64, F64_TOL),
])
def test_fused_leapfrog_unbatched_matches_jax(minv_kind, dtype, tol):
    """One chain's (K,) step: the JAX hook's unbatched call takes its pure
    reference (or its dense / float64 fallback); the port launches the
    kernel on the (1, K) batch, here its plain version."""
    K = 7
    jmodel, tmodel = _pair(K, dtype)
    q, p, _g, minv, eps = _inputs(1, K, minv_kind, dtype, seed=3)
    jmetric, tmetric = _metrics(minv, minv_kind)
    for e in (0.2, -0.35):
        zj = JPhasePoint(Q=j_evaluate(jmodel, jnp.asarray(q[0])),
                         p=jnp.asarray(p[0]))
        ref = j_leapfrog(jmodel, jmetric, zj, e)
        z = PhasePoint(Q=evaluate(tmodel, torch.as_tensor(q[0])),
                       p=torch.as_tensor(p[0]))
        out = leapfrog(tmodel, tmetric, z, torch.tensor(e, dtype=dtype))
        assert out.Q.q.shape == (K,) and out.Q.logdensity.shape == ()
        for x, y in ((out.Q.q, ref.Q.q), (out.p, ref.p),
                     (out.Q.grad, ref.Q.grad),
                     (out.Q.logdensity, ref.Q.logdensity)):
            _assert_close(x, y, tol)


def test_fused_leapfrog_poisoning_matches_jax():
    """tests/test_pallas.py's poisoning case: p = 1e25, eps = 1e10 blows up
    the drift; ld' is -inf in both packages."""
    K = 7
    jmodel, tmodel = _pair(K, torch.float32)
    zj = JPhasePoint(Q=j_evaluate(jmodel, jnp.zeros(K, jnp.float32)),
                     p=jnp.full((K,), 1e25, jnp.float32))
    ref = j_leapfrog(jmodel, j_diag(jnp.ones(K, jnp.float32)), zj, 1e10)
    z = PhasePoint(Q=evaluate(tmodel, torch.zeros(K)),
                   p=torch.full((K,), 1e25))
    out = leapfrog(tmodel, DiagonalMetric(torch.ones(K), None), z,
                   torch.tensor(1e10))
    assert float(ref.Q.logdensity) == float(out.Q.logdensity) == -np.inf


def test_fused_leapfrog_matches_model_leapfrog_float64():
    """At float64 the hook's plain step and the model's own leapfrog
    (value and gradient from the model) agree to 1e-12."""
    K = 5
    cov, mean = _cov(K, seed=4)
    fused = mvnormal(mean, cov, device="cpu", fused=True)
    plain = mvnormal(mean, cov, device="cpu")
    q, p, _g, minv, _eps = _inputs(1, K, "shared_diag", torch.float64, seed=5)
    metric = DiagonalMetric(torch.as_tensor(minv), None)
    z = PhasePoint(Q=evaluate(plain, torch.as_tensor(q[0])),
                   p=torch.as_tensor(p[0]))
    a = leapfrog(fused, metric, z, torch.tensor(0.3, dtype=torch.float64))
    b = leapfrog(plain, metric, z, torch.tensor(0.3, dtype=torch.float64))
    for x, y in ((a.Q.q, b.Q.q), (a.p, b.p), (a.Q.grad, b.Q.grad),
                 (a.Q.logdensity, b.Q.logdensity)):
        _assert_close(x, convert.to_numpy(y), F64_TOL)


@pytest.mark.parametrize("module,fn,plain", [
    (gaussian_leaf, "gaussian_leaf", "gaussian_leaf_plain"),
    (gaussian_leapfrog, "gaussian_leapfrog", "gaussian_leapfrog_plain"),
])
def test_wrapper_takes_plain_version_only_on_cpu(module, fn, plain):
    """A CPU tensor goes to the plain version (no launch); a tensor on
    another device is refused."""
    _jmodel, tmodel = _pair(5, torch.float32)
    ops = tmodel.fused_leaf_batched_fn.operands
    q, p, g, minv, eps = _inputs(4, 5, "chain_diag", torch.float32)
    metric = DiagonalMetric(torch.as_tensor(minv), None)
    args = (metric, *map(torch.as_tensor, (q, p, g, eps)), ops.prec,
            ops.lchol, ops.mu)
    module.reset_launches()
    out = getattr(module, fn)(*args)
    for x, y in zip(out, getattr(module, plain)(*args)):
        assert torch.equal(x, y)
    assert module.launches == 0
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    meta[0] = DiagonalMetric(metric.m_inv.to("meta"), None)
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(module, fn)(*meta)


def test_kernel_launch_checks_operands():
    """The launch path refuses, before it builds or loads anything, what
    the kernel does not take: a dense metric, another dtype, a wrong shape,
    a non-contiguous tensor."""
    _jmodel, tmodel = _pair(5, torch.float32)
    ops = tmodel.fused_leaf_batched_fn.operands
    q, p, g, minv, eps = map(torch.as_tensor,
                             _inputs(4, 5, "chain_diag", torch.float32))
    diag = DiagonalMetric(minv, None)
    ok = (q, p, g, eps, ops.prec, ops.lchol, ops.mu)
    cases = [
        (ValueError, "diagonal", dense_metric(torch.eye(5)), ok),
        (TypeError, "float32", diag, (q.double(),) + ok[1:]),
        (ValueError, "shape", DiagonalMetric(minv[:, :3].contiguous(), None),
         ok),
        (ValueError, "shape", diag, ok[:3] + (eps[:2],) + ok[4:]),
        (ValueError, "contiguous", diag, (q.mT.contiguous().mT,) + ok[1:]),
    ]
    for entry in ("gaussian_leaf_f32", "gaussian_leapfrog_f32"):
        for err, match, metric, args in cases:
            with pytest.raises(err, match=match):
                gaussian_leaf.launch(entry, metric, *args)
    assert not gaussian_leaf.library.loaded


def test_hooks_take_kernel_only_for_float32_diagonal():
    """The JAX hooks' dispatch rule (pallas_leaf.py:100, pallas_leapfrog.py
    :203): float32 chains with a diagonal metric take the kernel; a dense
    metric or float64 the plain math."""
    _jmodel, tmodel = _pair(4, torch.float32)
    ops = tmodel.fused_leapfrog_fn.operands
    diag = DiagonalMetric(torch.ones(4), None)
    assert ops.takes_kernel(diag, torch.float32)
    assert not ops.takes_kernel(diag, torch.float64)
    assert not ops.takes_kernel(dense_metric(torch.eye(4)), torch.float32)
    # the kernels' float32 copies of the model's own full-precision arrays
    full = ops.full(torch.float64)
    assert ops.prec.dtype == torch.float32
    assert torch.equal(ops.lchol, full[1].float())


def test_hooks_send_k_past_max_k_to_the_kernel_which_refuses_it(monkeypatch):
    """A K above the kernel's limit changes nothing in the dispatch rule:
    float32 chains with a diagonal metric still go to the kernel wrappers
    (never the plain math), and the launch raises before it builds or
    loads anything. MAX_K is lowered to 4 so that the model stays small."""
    monkeypatch.setattr(gaussian_leaf, "MAX_K", 4)
    _jmodel, tmodel = _pair(5, torch.float32)
    ops = tmodel.fused_leaf_batched_fn.operands
    q, p, g, minv, eps = map(torch.as_tensor,
                             _inputs(3, 5, "chain_diag", torch.float32))
    diag = DiagonalMetric(minv, None)
    assert ops.takes_kernel(diag, torch.float32)
    for entry in ("gaussian_leaf_f32", "gaussian_leapfrog_f32"):
        with pytest.raises(ValueError, match="K = 5"):
            gaussian_leaf.launch(entry, diag, q, p, g, eps, ops.prec,
                                 ops.lchol, ops.mu)
    assert not gaussian_leaf.library.loaded

    def refuse(*_args):
        raise RuntimeError("kernel wrapper")

    monkeypatch.setattr(gaussian_leaf, "gaussian_leaf", refuse)
    monkeypatch.setattr(gaussian_leapfrog, "gaussian_leapfrog", refuse)
    with pytest.raises(RuntimeError, match="kernel wrapper"):
        tmodel.fused_leaf_batched_fn(diag, q, p, g, eps)
    z = PhasePoint(Q=evaluate(tmodel, q), p=p)
    with pytest.raises(RuntimeError, match="kernel wrapper"):
        tmodel.fused_leapfrog_fn(diag, z, eps)


@pytest.mark.parametrize("K", [25, 100])
def test_launch_plan_is_one_wave_at_4096_chains(K):
    """At 4096 chains on the H100's 132 SMs the grid is one wave: 128 CTAs
    of 32 chains (four warps of R = 8), one per SM, prec and L staged."""
    plan = gaussian_leaf.launch_plan(4096, K, 132)
    assert (plan.R, plan.warps, plan.chains, plan.ctas) == (8, 4, 32, 128)
    assert plan.ctas <= 132 and plan.ctas * plan.chains >= 4096
    assert plan.staged


@pytest.mark.parametrize("C", [2, 7, 33, 4096, 4097, 100_000])
def test_launch_plan_takes_every_k(C):
    """Every K from 1 to MAX_K has a plan at C chains whose CTA fits the
    227 KB of shared memory (its d, p_mid and, when staged, prec and L);
    MAX_K + 1 and C = 0 are refused. Staging stops at one K and never
    resumes."""
    last_staged = gaussian_leaf.staging_limit(C)
    for K in range(1, gaussian_leaf.MAX_K + 1):
        plan = gaussian_leaf.launch_plan(C, K)
        assert plan.chains == plan.R * plan.warps and plan.R == 8
        assert 1 <= plan.warps <= gaussian_leaf.MAX_WARPS
        assert plan.ctas == -(-C // plan.chains)
        assert plan.smem == gaussian_leaf.smem_bytes(K, plan.chains,
                                                     plan.staged)
        assert plan.smem <= 227 * 1024
        assert plan.staged == (K <= last_staged)
    with pytest.raises(ValueError, match="outside"):
        gaussian_leaf.launch_plan(C, gaussian_leaf.MAX_K + 1)
    with pytest.raises(ValueError, match="outside"):
        gaussian_leaf.launch_plan(0, 25)


def test_launch_plan_of_one_chain_is_one_warp():
    """A single chain (K4 on the per_chain path) takes one CTA of one warp
    (R = 1), so that no warp is launched that only returns; prec and L are
    staged while they fit beside its d and p_mid, and past that only those
    two vectors take shared memory."""
    last_staged = gaussian_leaf.staging_limit(1)
    assert last_staged > 100
    for K in range(1, gaussian_leaf.MAX_K + 1):
        plan = gaussian_leaf.launch_plan(1, K)
        assert (plan.R, plan.warps, plan.chains, plan.ctas) == (1, 1, 1, 1)
        assert plan.staged == (K <= last_staged)
        assert plan.smem == gaussian_leaf.smem_bytes(K, 1, plan.staged)
        assert plan.staged or plan.smem == 8 * K


def test_launch_plan_at_the_staging_limit():
    """At 4096 chains the last staged K fills the shared memory with prec,
    L and the tile's vectors, and the next K reads prec and L through
    L1/L2 with the same grid."""
    K = gaussian_leaf.staging_limit(4096)
    staged, unstaged = (gaussian_leaf.launch_plan(4096, k) for k in (K, K + 1))
    assert staged.staged and not unstaged.staged
    assert staged.smem <= 227 * 1024
    assert gaussian_leaf.smem_bytes(K + 1, 32, True) > 227 * 1024
    assert (staged.chains, staged.ctas) == (unstaged.chains, unstaged.ctas)


def test_bound_launch_checks_one_chain_operands():
    """A model's bound operands take one chain's (K,) tensors with a 0-d eps
    (K4's hook on the per_chain path) and refuse, before they build or load
    anything, another eps shape, another rank, another K and a wrong
    m_inv."""
    _jmodel, tmodel = _pair(5, torch.float32)
    kernels = tmodel.fused_leapfrog_fn.operands.kernels
    q, p, g, minv, eps = map(torch.as_tensor,
                             _inputs(1, 5, "shared_diag", torch.float32))
    one = (q[0], p[0], g[0])
    cases = [
        ("eps_signed has shape", minv, one, eps),
        ("q has shape", minv, (q[None],) * 3, eps),
        (r"\(5, 5\) on cpu, expected \(4, 4\)", minv[:4],
         (q[0, :4], p[0, :4], g[0, :4]), eps[0]),
        ("m_inv has shape", minv[:3], one, eps[0]),
    ]
    for match, m, (qq, pp, gg), e in cases:
        for entry in (0, 1):
            with pytest.raises(ValueError, match=match):
                kernels.launch(entry, m, qq, pp, gg, e)
    assert not gaussian_leaf.library.loaded
