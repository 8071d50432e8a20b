"""``run_chains`` over a mesh of ranks (``parallel/mesh.py``), against the
JAX package's mesh path.

Each case runs its ranks as separate processes on a gloo group on the CPU
(tests/torch_mesh_worker.py, a ``file://`` rendezvous per spawn, every
spawn killed at its timeout), float64 unless stated:

- the collective helpers, and ``pool_welford_over_group`` over 2 and 4
  ranks, diagonal and dense, against JAX's ``pool_welford_over_axis``
  under ``jax.vmap`` on the same shard states and against one pooled fold
  over the union of the shards' draws, to 1e-12; the pooled stepsize over
  the ranks against the single-process one on the union of the chains;
- a mesh of one rank gives the draws, metric and eps of the call without
  a mesh, bit for bit;
- the mesh cases of JAX tests/test_parallel.py at its tolerances, and on
  every rank the same metric and eps, bit for bit, and other chains;
- generators seeded alike, and a check that fails on one rank only (the
  initial point, the stepsize search), raise on every rank;
- the mesh passes of JAX ``__graft_entry__.dryrun_multichip`` (1-8) at
  float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu.stats import ess_rhat
from dynamichmc_tpu.utils.welford import WelfordState as JWelfordState
from dynamichmc_tpu.utils.welford import pool_welford_over_axis
from dynamichmc_tpu_torch import run_chains
from dynamichmc_tpu_torch.models import std_normal
from dynamichmc_tpu_torch.parallel import ChainMesh, chain_mesh
from dynamichmc_tpu_torch.stepsize import PooledStepsize
from dynamichmc_tpu_torch.utils.welford import (welford_update_pooled_b,
                                                welford_zero_shared)
from torch_mesh_worker import (C_POOL, K_POOL, N_POOL, SIZE1_CONFIGS, T_EPS,
                               collective_inputs, spawn)

F64 = torch.float64
RTOL = 1e-12


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(case, world)``: each rank's result of one spawn of ``case``,
    spawned once per module."""
    cache = {}

    def get(case, world):
        if (case, world) not in cache:
            cache[case, world] = spawn(
                case, world, tmp_path_factory.mktemp(f"{case}{world}"))
        return cache[case, world]

    return get


def _close(actual, expected):
    """Within RTOL of the largest entry of ``expected``."""
    actual = np.asarray(actual, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    scale = max(float(np.abs(expected).max()), 1e-300)
    np.testing.assert_allclose(actual, expected, rtol=RTOL, atol=RTOL * scale)


def _same_on_every_rank(outs, *keys):
    """The value at ``keys`` is bitwise equal on every rank."""
    def at(out):
        for key in keys:
            out = out[key]
        return out

    first = at(outs[0])
    for out in outs[1:]:
        assert torch.equal(at(out), first), keys


def _gathered(outs, name, field):
    return torch.cat([out[name][field] for out in outs])


# --- collectives ------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_collective_helpers(ranks, world):
    outs = ranks("collectives", world)
    rows = torch.cat([torch.arange(6, dtype=F64).reshape(3, 2) + 10 * r
                      for r in range(world)])
    flags = torch.tensor([r % 2 == 0 for r in range(world) for _ in (0, 1)])
    flags[1::2] = True
    for out in outs:
        assert torch.equal(out["gathered"], rows)
        assert out["gathered_bool"].dtype == torch.bool
        assert torch.equal(out["gathered_bool"], flags)
        assert out["broadcast"].item() == world
        assert torch.equal(out["shared_metric"],
                           torch.tensor([1.0, 2.0], dtype=F64))
        assert out["sum"].item() == world * (world + 1) / 2
        assert out["mean"].item() == (world + 1) / 2


@pytest.mark.parametrize("kind", ["diagonal", "dense"])
@pytest.mark.parametrize("world", [2, 4])
def test_pool_welford_over_group_matches_jax(ranks, world, kind):
    """The ranks' pooled state is the same on every rank and is JAX's
    pool_welford_over_axis of the same shard states under jax.vmap."""
    outs = ranks("collectives", world)
    for i in range(3):
        _same_on_every_rank(outs, kind, "pooled", i)
    local = [np.stack([out[kind]["local"][i].numpy() for out in outs])
             for i in range(3)]
    state = JWelfordState(count=jnp.asarray(local[0]),
                          mean=jnp.asarray(local[1]), m2=jnp.asarray(local[2]))
    ref = jax.vmap(lambda w: pool_welford_over_axis(w, "ranks"),
                   axis_name="ranks")(state)
    for mine, theirs in zip(outs[0][kind]["pooled"],
                            (ref.count, ref.mean, ref.m2)):
        _close(mine.numpy(), np.asarray(theirs)[0])


@pytest.mark.parametrize("kind", ["diagonal", "dense"])
@pytest.mark.parametrize("world", [2, 4])
def test_pool_welford_over_group_matches_the_union_fold(ranks, world, kind):
    """The pooled state is the moments of the union of the ranks' draws:
    one pooled fold over all chains of every step."""
    outs = ranks("collectives", world)
    x, _eps, _acc = collective_inputs(world)
    w = welford_zero_shared(K_POOL, kind == "dense", F64)
    for t in range(N_POOL):
        w = welford_update_pooled_b(
            w, torch.from_numpy(x[:, t].reshape(world * C_POOL, K_POOL)))
    assert outs[0][kind]["pooled"][0].item() == world * C_POOL * N_POOL
    for mine, theirs in zip(outs[0][kind]["pooled"], (w.count, w.mean, w.m2)):
        _close(mine.numpy(), theirs.numpy())


@pytest.mark.parametrize("world", [2, 4])
def test_pooled_stepsize_over_ranks_matches_the_union(ranks, world):
    """PooledStepsize with a mesh: init over every rank's chains, update on
    the mean acceptance over the ranks; the single-process PooledStepsize
    on the union of the chains, every state field, to 1e-12."""
    outs = ranks("collectives", world)
    _x, eps, acc = collective_inputs(world)
    adaptation = PooledStepsize()
    state = adaptation.init(torch.from_numpy(eps.reshape(-1)))
    expected = [vars(state)]
    for t in range(T_EPS):
        state = adaptation.update(state, torch.from_numpy(
            acc[:, t].reshape(-1)))
        expected.append(vars(state))
    first = outs[0]["eps_states"]
    for out in outs:
        assert torch.equal(out["eps_final"], outs[0]["eps_final"])
        for mine, ours in zip(out["eps_states"], first):
            for name in ours:
                assert torch.equal(mine[name], ours[name]), name
    assert len(first) == len(expected)
    for mine, theirs in zip(first, expected):
        assert mine.keys() == theirs.keys()
        for name in theirs:
            _close(mine[name].numpy(), theirs[name].numpy())
    _close(outs[0]["eps_final"].numpy(), adaptation.final(state).numpy())


# --- a mesh of one rank -----------------------------------------------------


@pytest.mark.parametrize("config", sorted(SIZE1_CONFIGS))
def test_size1_mesh_is_bitwise_the_plain_run(ranks, config):
    (out,) = ranks("size1", 1)
    mesh_run, plain = out[config]["mesh"], out[config]["plain"]
    assert mesh_run.keys() == plain.keys()
    for name in plain:
        assert torch.equal(mesh_run[name], plain[name]), name
    if config == "pooled_dense":
        assert plain["eps"].ndim == 0 and plain["m_inv"].shape == (3, 3)
    else:
        assert plain["eps"].shape == (8,) and plain["m_inv"].shape == (8, 3)


# --- JAX tests/test_parallel.py, the mesh cases -----------------------------


def test_run_chains_sharded_matches_stats(ranks):
    outs = ranks("parallel", 2)
    positions = _gathered(outs, "sharded", "positions").numpy()
    assert positions.shape == (8, 400, 3)
    assert outs[0]["sharded"]["positions"].shape == (4, 400, 3)
    assert not np.array_equal(positions[:4], positions[4:])
    st = ess_rhat(positions)
    assert st["rhat"].max() < 1.02
    assert np.abs(positions.reshape(-1, 3).mean(0)).max() < 0.1


def test_pooled_adaptation_synchronizes_metric(ranks):
    outs = ranks("parallel", 2)
    _same_on_every_rank(outs, "pooled_metric", "m_inv")
    m_inv = outs[0]["pooled_metric"]["m_inv"].numpy()
    assert m_inv.shape == (3,)
    np.testing.assert_allclose(m_inv, [0.5, 1.0, 2.0], rtol=0.5)


def test_pooled_stepsize_on_mesh_is_globally_shared(ranks):
    outs = ranks("parallel", 2)
    _same_on_every_rank(outs, "pooled_stepsize", "eps")
    _same_on_every_rank(outs, "pooled_stepsize", "m_inv")
    eps = outs[0]["pooled_stepsize"]["eps"].numpy()
    assert eps.ndim == 0 and np.isfinite(eps) and eps > 0
    qs = _gathered(outs, "pooled_stepsize", "positions").numpy()
    assert qs.shape == (16, 100, 3)
    np.testing.assert_allclose(qs.reshape(-1, 3).std(0),
                               np.sqrt([0.5, 1.0, 2.0]), rtol=0.15)


def test_chains_divisibility_check(ranks):
    for out in ranks("parallel", 2):
        assert out["divisibility"] == {
            "type": "ValueError",
            "message": "n_chains=9 not divisible by mesh size 2"}


# --- checks that read every rank --------------------------------------------


def test_generators_seeded_alike_raise_on_every_rank(ranks):
    outs = ranks("errors", 2)
    for out in outs:
        err = out["seeded_alike"]
        assert err["type"] == "DynamicHMCError"
        assert "same state" in err["message"]
        assert len(set(err["payload"]["fingerprints"])) == 1


def test_nonfinite_initial_point_on_one_rank_raises_on_every_rank(ranks):
    outs = ranks("errors", 2)
    for out in outs:
        err = out["initial_point"]
        assert err["type"] == "DynamicHMCError"
        assert err["message"] == "Invalid log posterior at initial positions."
        assert err["payload"]["chains"] == [4 + 2]  # rank 1's chain 2
    assert outs[0]["initial_point"] == outs[1]["initial_point"]


def test_failed_stepsize_search_on_one_rank_raises_on_every_rank(ranks):
    outs = ranks("errors", 2)
    for out in outs:
        err = out["stepsize_search"]
        assert err["type"] == "DynamicHMCError"
        assert "without crossing" in err["message"]
        assert err["payload"]["failed_fraction"] == 1 / 8
        assert len(err["payload"]["eps"]) == 8  # every rank's chains
    assert outs[0]["stepsize_search"] == outs[1]["stepsize_search"]


# --- JAX __graft_entry__.dryrun_multichip, passes 1-8 ----------------------


def test_dryrun_pass1_mixed_stages(ranks):
    """Search, pooled diagonal, pooled dense, an eps-only block."""
    outs = ranks("dryrun", 2)
    for out in outs:
        assert out["pass1"]["positions"].shape == (4, 8, 4)
        assert torch.isfinite(out["pass1"]["positions"]).all()
        assert out["pass1"]["m_inv"].shape == (4, 4)
        assert out["pass1"]["eps"].shape == (4,)
    _same_on_every_rank(outs, "pass1", "m_inv")


def test_dryrun_pass2_shared_metric(ranks):
    outs = ranks("dryrun", 2)
    _same_on_every_rank(outs, "pass2", "m_inv")
    for out in outs:
        assert out["pass2"]["m_inv"].shape == (4, 4)
        assert torch.isfinite(out["pass2"]["positions"]).all()


def test_dryrun_pass3_pooled_stepsize(ranks):
    outs = ranks("dryrun", 2)
    _same_on_every_rank(outs, "pass3", "eps")
    _same_on_every_rank(outs, "pass3", "m_inv")
    assert outs[0]["pass3"]["eps"].ndim == 0
    assert not torch.equal(outs[0]["pass3"]["positions"],
                           outs[1]["pass3"]["positions"])


def test_dryrun_pass4_stratified(ranks):
    """Per-chain eps, stratification over the mesh (a permutation) and a
    warmup clamp: finite draws and a per-chain eps on every rank."""
    outs = ranks("dryrun", 2)
    for out in outs:
        assert out["pass4"]["positions"].shape == (4, 8, 4)
        assert torch.isfinite(out["pass4"]["positions"]).all()
        assert out["pass4"]["eps"].shape == (4,)
    _same_on_every_rank(outs, "pass4", "m_inv")


def test_dryrun_pass5_wavefront_pooled_eps(ranks):
    """The wavefront warmup with a pooled stepsize, epoch-lockstep over
    the ranks: one eps, bitwise the same on both ranks."""
    outs = ranks("dryrun", 2)
    _same_on_every_rank(outs, "pass5", "eps")
    _same_on_every_rank(outs, "pass5", "m_inv")
    assert outs[0]["pass5"]["eps"].ndim == 0
    for out in outs:
        assert torch.isfinite(out["pass5"]["positions"]).all()


def test_dryrun_pass6_epoch(ranks):
    """Epoch sampling over the mesh (no collective in its loop)."""
    outs = ranks("dryrun", 2)
    for out in outs:
        assert out["pass6"]["positions"].shape == (4, 8, 4)
        assert torch.isfinite(out["pass6"]["positions"]).all()
    assert not torch.equal(outs[0]["pass6"]["positions"],
                           outs[1]["pass6"]["positions"])


def test_dryrun_pass7_resume_is_bitwise(ranks):
    """Each rank resumes its own chains and generator from the step-20
    checkpoint: the uninterrupted run's draws, eps and metric, bit for
    bit, on every rank."""
    for out in ranks("dryrun", 2):
        assert out["pass7_steps"] == [0, 20, 40, 60]
        for name, value in out["pass7_ref"].items():
            assert torch.equal(out["pass7_resumed"][name], value), name


def test_dryrun_pass8_ess_target_stops_on_every_rank_alike(ranks):
    outs = ranks("dryrun", 2)
    drawn = [out["pass8"]["positions"].shape[1] for out in outs]
    assert drawn[0] == drawn[1] and drawn[0] < 64 and drawn[0] % 16 == 0
    for out in outs:
        assert torch.isfinite(out["pass8"]["positions"]).all()


def test_resume_from_different_stages_raises_on_every_rank(ranks):
    for out in ranks("dryrun", 2):
        err = out["resume_mismatch"]
        assert err["type"] == "DynamicHMCError"
        assert err["payload"]["stages"] == [2, 3]


# --- in one process ---------------------------------------------------------


def test_mesh_must_be_a_chain_mesh():
    with pytest.raises(TypeError, match="ChainMesh"):
        run_chains(torch.Generator().manual_seed(0),
                   std_normal(2, dtype=F64, device="cpu"), 4, 4,
                   dtype=F64, mesh=object())


def test_chain_mesh_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        chain_mesh(device="cpu")


def test_generator_must_lie_on_the_mesh_device():
    mesh = ChainMesh(None, 0, 1, torch.device("meta"))
    with pytest.raises(ValueError, match="generator lies on cpu"):
        run_chains(torch.Generator().manual_seed(0),
                   std_normal(2, dtype=F64, device="cpu"), 4, 4,
                   dtype=F64, mesh=mesh)
