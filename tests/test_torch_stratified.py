"""Stratified sampling on the port (``run_chains(stratify_sampling=G)``):
JAX tests/test_stratified.py's four tests, float64, on the CPU, the mesh
case on two gloo ranks (tests/torch_mesh_worker.py).

Stratification is scheduling only: the warmup is untouched (eps and M^-1
bitwise those of the unstratified run), the draws come back in the
caller's chain order, and the target's moments are recovered. Also: the
draws through a draw sink equal the kept draws bit for bit, and the JAX
package's refusals.
"""

import numpy as np
import pytest
import torch

from dynamichmc_tpu_torch import FixedStepsize, TuningNUTS, run_chains
from dynamichmc_tpu_torch.models import mvnormal
from dynamichmc_tpu_torch.nuts import NUTS
from dynamichmc_tpu_torch.warmup import default_warmup_stages
from torch_mesh_worker import spawn, stratified_target

F64 = torch.float64

# the half-length schedule of JAX's tests: the gates check moments, lane
# order and the untouched warmup, none of which needs 900 steps
HALF_STAGES = default_warmup_stages(
    metric_kind="dense", init_steps=40, middle_steps=20, doubling_stages=3,
    terminating_steps=25)


def _target():
    cov = stratified_target()
    return mvnormal(np.zeros(5), cov, dtype=F64, device="cpu"), cov


def _run(n_chains, n_samples, seed=1, **kw):
    ld, _cov = _target()
    kw.setdefault("warmup_stages", HALF_STAGES)
    return run_chains(torch.Generator().manual_seed(seed), ld, n_chains,
                      n_samples, dtype=F64, tune="reference", **kw)


def _check_moments(positions, cov, tol=0.10):
    sd = np.sqrt(np.diag(cov))
    qs = positions.reshape(-1, 5).numpy()
    assert np.abs(qs.std(0) / sd - 1).max() < tol
    assert np.abs(qs.mean(0) / sd).max() < tol


def test_stratified_moments_and_lane_order():
    _ld, cov = _target()
    res = _run(24, 250, stratify_sampling=4)
    assert tuple(res.positions.shape) == (24, 250, 5)
    _check_moments(res.positions, cov)
    assert int(res.tree_statistics.is_divergent.sum()) == 0
    # the warmup is untouched: eps and metric those of the unstratified
    # run, in the caller's chain order
    res0 = _run(24, 8)
    assert torch.equal(res.eps, res0.eps)
    assert torch.equal(res.metric.m_inv, res0.metric.m_inv)


def test_stratified_keeps_each_chain_in_its_place():
    """Chains started a unit apart with a tiny per-chain eps (reversed, so
    the sort moves every chain) barely move: each chain's last draw lies
    by its own start."""
    C = 8
    q0 = torch.arange(C, dtype=F64)[:, None] * torch.ones(5, dtype=F64)
    eps = torch.linspace(2e-3, 1e-3, C, dtype=F64)
    res = _run(C, 4, warmup_stages=(TuningNUTS(
        N=20, stepsize_adaptation=FixedStepsize()),),
        algorithm=NUTS(max_depth=2), stratify_sampling=4,
        initialization={"q": q0, "eps": eps})
    assert torch.equal(res.eps, eps)
    assert float((res.positions[:, -1] - q0).abs().max()) < 0.1


def test_stratified_draw_sink_is_the_kept_draws():
    """Streamed 16 draws at a time, the draws and statistics are the kept
    run's bit for bit (each group's stream does not depend on the chunk)."""
    chunks = []
    streamed = _run(12, 40, stratify_sampling=3, sample_chunk=16,
                    draw_sink=lambda start, q, ld, st: chunks.append(
                        (start, q.clone(), ld.clone())))
    kept = _run(12, 40, stratify_sampling=3)
    assert [c[0] for c in chunks] == [0, 16, 32]
    assert streamed.positions is None
    assert torch.equal(torch.cat([c[1] for c in chunks], dim=1),
                       kept.positions)
    assert torch.equal(torch.cat([c[2] for c in chunks], dim=1),
                       kept.logdensities)
    assert torch.equal(streamed.tree_statistics.steps,
                       kept.tree_statistics.steps)


def test_stratified_requires_divisible_groups():
    with pytest.raises(ValueError, match="divisible"):
        _run(10, 16, stratify_sampling=4)


def test_stratified_pooled_eps_rejected():
    with pytest.raises(ValueError, match="per-chain stepsize"):
        _run(16, 200, stratify_sampling=4, warmup_stages=default_warmup_stages(
            metric_kind="dense", pooled=True, pooled_stepsize=True,
            init_steps=40, middle_steps=20, doubling_stages=3,
            terminating_steps=25))


def test_stratified_refuses_what_jax_refuses():
    with pytest.raises(NotImplementedError, match="group-serial"):
        _run(8, 16, stratify_sampling=2, ess_target=10.0)
    with pytest.raises(ValueError, match="synchronized sampler"):
        _run(8, 16, stratify_sampling=2, sampling_driver="epoch")


def test_stratified_on_mesh_permutation(tmp_path):
    """Over two ranks the sort is a permutation: each rank samples one eps
    band and the draws return home. The gathered moments are the target's,
    each rank's eps and metric are the unstratified mesh run's bit for bit,
    and each chain's draws stay with it (the tiny-eps run)."""
    _ld, cov = _target()
    mesh_ranks = spawn("stratified", 2, tmp_path)
    positions = torch.cat([out["stratified"]["positions"]
                           for out in mesh_ranks])
    assert tuple(positions.shape) == (32, 200, 5)
    _check_moments(positions, cov)
    for out in mesh_ranks:
        assert torch.equal(out["stratified"]["eps"], out["plain"]["eps"])
        assert torch.equal(out["stratified"]["m_inv"], out["plain"]["m_inv"])
        assert out["still"]["max_move"] < 0.1
    # the bands differ from the home chains: the sort moved chains across
    assert mesh_ranks[0]["still"]["band_moved"]
