"""The port's stage fold, keep-warmup and stepwise API against the JAX
package.

- Stage fold vs JAX: both packages' ``sample_tree`` is replaced, in this
  test only, by one deterministic stub that computes q' and an acceptance
  rate from (Q, eps) alone (a rotation of coordinate pairs by angles set by
  eps; acceptance exp(-eps)). Then the port's ``warmup.run_warmup`` gives
  JAX ``warmup.run_warmup``'s stepsize per step, log density per step,
  metric after every stage and final eps to 1e-12 at float64, over a
  heterogeneous stage tuple (none / diagonal / dense / FixedStepsize, eps
  given, no search).
- Stage fold vs engine: on a schedule the JAX engine takes whole, the fold
  gives the metric, eps and draws of that engine's one loop over the global
  step index (written out here as a reference, with the warmup depth
  clamp) bitwise from one seed, per chain and on a batch. Both consume the
  generator in the same order: one search, then one transition per step.
- Ports of JAX tests/test_mcmc.py: test_keep_warmup_inspectable,
  test_stepwise_api, test_stepwise_chunk_matches_next_step (one chain and a
  (C, K) batch), test_warmup_only_run, test_keep_warmup_matches_fast_engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamichmc_tpu.warmup as jwarmup
import dynamichmc_tpu_torch.engine as tengine
from dynamichmc_tpu.hamiltonian import EvaluatedPoint as JEvaluatedPoint
from dynamichmc_tpu.hamiltonian import evaluate as j_evaluate
from dynamichmc_tpu.logdensity import from_logdensity_fn as j_from_fn
from dynamichmc_tpu.metric import identity_metric as j_identity
from dynamichmc_tpu.nuts import NUTS as JNUTS
from dynamichmc_tpu.nuts import TreeStatistics as JTreeStatistics
from dynamichmc_tpu.stepsize import FixedStepsize as JFixed
from dynamichmc_tpu.warmup import TuningNUTS as JTuning
from dynamichmc_tpu.warmup import WarmupState as JWarmupState
from dynamichmc_tpu_torch import (
    NUTS,
    DynamicHMCError,
    FixedStepsize,
    InitialStepsizeSearch,
    TuningNUTS,
    from_logdensity_fn,
    initialize_warmup_state,
    mcmc_keep_warmup,
    mcmc_steps,
    mcmc_steps_from_state,
    mcmc_with_warmup,
)
from dynamichmc_tpu_torch.engine import (
    PER_CHAIN,
    WarmupSchedule,
    batched_ops,
    promote_metric,
    run_sampling,
)
from dynamichmc_tpu_torch.hamiltonian import EvaluatedPoint, evaluate
from dynamichmc_tpu_torch.mcmc import mcmc
from dynamichmc_tpu_torch.nuts import TreeStatistics
from dynamichmc_tpu_torch.parallel.chains import init_chain_states
from dynamichmc_tpu_torch.warmup import estimate_metric, run_warmup

F64 = torch.float64
ATOL = 1e-12


def std_mvn(k):
    return from_logdensity_fn(k, lambda q: -0.5 * (q**2).sum(-1))


# --- stage fold vs JAX under one deterministic stub -------------------------


def _rotate(q, eps, cos, sin, stack):
    """q' of the stub: coordinates (0, 1) rotated by 0.7 + eps, (2, 3) by
    1.9 - eps / 2; the same formula for both packages' arrays."""
    t1, t2 = 0.7 + eps, 1.9 - 0.5 * eps
    c1, s1, c2, s2 = cos(t1), sin(t1), cos(t2), sin(t2)
    return stack([c1 * q[0] - s1 * q[1], s1 * q[0] + c1 * q[1],
                  c2 * q[2] - s2 * q[3], s2 * q[2] + c2 * q[3]])


def j_stub(key, algorithm, ld, metric, Q, eps, **kw):
    q = _rotate(Q.q, eps, jnp.cos, jnp.sin, jnp.stack)
    zero = jnp.int32(0)
    stats = JTreeStatistics(
        logdensity=-0.5 * jnp.sum(q**2), depth=zero, term_left=zero,
        term_right=zero, acceptance_rate=jnp.exp(-eps), steps=zero,
        directions=jnp.uint32(0))
    return JEvaluatedPoint(q=q, logdensity=-0.5 * jnp.sum(q**2), grad=-q), stats


def t_stub(generator, algorithm, ld, metric, Q, eps, **kw):
    q = _rotate(Q.q, eps, torch.cos, torch.sin, torch.stack)
    zero = torch.zeros((), dtype=torch.int32)
    stats = TreeStatistics(
        logdensity=-0.5 * (q**2).sum(), depth=zero, term_left=zero,
        term_right=zero, acceptance_rate=torch.exp(-eps), steps=zero,
        directions=zero)
    return EvaluatedPoint(q=q, logdensity=-0.5 * (q**2).sum(), grad=-q), stats


def _stages(tuning, fixed):
    return (None, tuning(30), tuning(40, "diagonal"), tuning(50, "dense"),
            tuning(30, "diagonal", stepsize_adaptation=fixed()), tuning(25))


def test_stage_fold_matches_jax_under_a_stub(monkeypatch):
    monkeypatch.setattr(jwarmup, "sample_tree", j_stub)
    monkeypatch.setattr(tengine, "sample_tree", t_stub)
    q0 = np.array([1.0, 0.5, -0.7, 1.2])
    jld = j_from_fn(4, lambda q: -0.5 * jnp.sum(q**2))
    jstate = JWarmupState(Q=j_evaluate(jld, jnp.asarray(q0)),
                          metric=j_identity(4, dtype=jnp.float64),
                          eps=jnp.float64(0.5))
    jhist, jfinal = jwarmup.run_warmup(jax.random.PRNGKey(0), jld, JNUTS(),
                                       _stages(JTuning, JFixed), jstate)
    tld = std_mvn(4)
    tstate = initialize_warmup_state(torch.Generator(), tld, q=q0, eps=0.5,
                                     dtype=F64)
    thist, tfinal = run_warmup(torch.Generator(), tld, NUTS(),
                               _stages(TuningNUTS, FixedStepsize), tstate)
    assert len(thist) == len(jhist) == 6
    for s, ((_js, jres, jst), (_ts, tres, tst)) in enumerate(zip(jhist, thist)):
        if jres is None:
            assert tres is None and s == 0
            continue
        for name in ("epss", "logdensities"):
            np.testing.assert_allclose(tres[name].numpy(),
                                       np.asarray(jres[name]), rtol=0,
                                       atol=ATOL, err_msg=f"stage {s} {name}")
        np.testing.assert_allclose(tst.metric.m_inv.numpy(),
                                   np.asarray(jst.metric.m_inv), rtol=0,
                                   atol=ATOL, err_msg=f"stage {s} metric")
        np.testing.assert_allclose(float(tst.eps), float(jst.eps), rtol=0,
                                   atol=ATOL)
    # the stub moved eps and the metric
    assert np.asarray(jhist[3][1]["epss"]).std() > 1e-3
    assert tfinal.metric.m_inv.shape == (4,)
    np.testing.assert_allclose(float(tfinal.eps), float(jfinal.eps), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tfinal.Q.q.numpy(), np.asarray(jfinal.Q.q),
                               rtol=0, atol=ATOL)


# --- stage fold vs the engine loop ------------------------------------------


def _one_loop(generator, ld, algorithm, schedule, state, n_samples, ops,
              clamp=None, tail=0):
    """The JAX engine's semantics of a whole schedule as one loop over the
    global step index: one search, the metric promoted once to the
    schedule's kind, dual averaging restarted and the metric re-estimated
    at each block boundary; the clamp caps every block but the last and
    ``tail`` steps into the last. Returns (metric, eps, positions)."""
    eps, _ok, _l0 = ops.make_search(ld, schedule.search)(
        generator, state.Q, state.metric)
    sizes, kind = schedule.block_sizes, schedule.metric_kind
    total = sum(sizes)
    clamp_until = min(total - sizes[-1] + tail, total - 1)
    boundaries = [sum(sizes[:b + 1]) for b in range(len(sizes))]
    adaptation = schedule.adaptation
    Q, metric = state.Q, promote_metric(state.metric, kind)
    da, wf, b = adaptation.init(eps), ops.welford_zero(Q.q, kind == "dense"), 0
    for i in range(total):
        dl = None if clamp is None else (
            clamp if i < clamp_until else algorithm.max_depth)
        Q, stats = ops.transition(generator, algorithm, ld, metric, Q,
                                  adaptation.current(da), depth_limit=dl)
        da = adaptation.update(da, stats.acceptance_rate)
        if schedule.update_metric[b]:
            wf = ops.welford_update(wf, Q.q)
        if i + 1 == boundaries[b]:
            eps = adaptation.final(da)
            da = adaptation.init(eps)
            if schedule.update_metric[b]:
                metric = estimate_metric(wf, kind, schedule.shrinkages[b])
                wf = ops.welford_zero(Q.q, kind == "dense")
            b += 1
    _q, positions, _lds, _stats = run_sampling(
        generator, ld, algorithm, Q, metric, eps, n_samples, ops=ops)
    return metric, eps, positions


@pytest.mark.parametrize("layout,kind,pooled,clamp", [
    ("per_chain", "diagonal", False, None), ("per_chain", "dense", False, None),
    ("batch", "diagonal", False, None), ("batch", "dense", True, None),
    ("batch", "dense", True, 2),
])
def test_stage_fold_equals_the_engine_loop(layout, kind, pooled, clamp):
    ld = std_mvn(3)
    algorithm = NUTS(max_depth=5)
    stages = (InitialStepsizeSearch(), TuningNUTS(20),
              TuningNUTS(25, kind, pooled=pooled),
              TuningNUTS(30, kind, pooled=pooled), TuningNUTS(20))
    schedule = WarmupSchedule.from_stages(stages)
    assert schedule is not None

    def start(seed=4):
        gen = torch.Generator().manual_seed(seed)
        if layout == "per_chain":
            return gen, initialize_warmup_state(gen, ld, dtype=F64)
        return gen, init_chain_states(gen, ld, 5, dtype=F64,
                                      broadcast_metric=not pooled)

    gen, state = start()
    ops = PER_CHAIN if layout == "per_chain" else batched_ops(pooled)
    metric, eps, positions = _one_loop(gen, ld, algorithm, schedule, state,
                                       12, ops, clamp=clamp, tail=7)
    gen2, state2 = start()
    history, final = run_warmup(gen2, ld, algorithm, stages, state2,
                                depth_clamp=clamp, depth_clamp_tail=7)
    _q2, inference = mcmc(gen2, ld, algorithm, final, 12)
    assert torch.equal(final.metric.m_inv, metric.m_inv)
    assert torch.equal(final.eps, eps)
    assert torch.equal(inference.positions, positions)
    assert metric.m_inv.shape[-1] == 3 and metric.m_inv.ndim == (
        (1 if kind == "diagonal" else 2) + (layout == "batch" and not pooled))
    lead = (5,) if layout == "batch" else ()
    assert history[2][1]["epss"].shape == lead + (25,)
    if clamp is not None:  # the clamp capped the early blocks' trees
        assert int(history[1][1]["tree_statistics"].depth.max()) <= clamp
        assert int(history[4][1]["tree_statistics"].depth[:, 7:].max()) \
            > clamp


def test_stage_fold_errors():
    ld = std_mvn(2)
    gen = torch.Generator().manual_seed(0)
    state = initialize_warmup_state(gen, ld, dtype=F64)
    with pytest.raises(DynamicHMCError, match="no stepsize"):
        run_warmup(gen, ld, NUTS(), (TuningNUTS(20),), state)
    state = initialize_warmup_state(gen, ld, eps=0.3, dtype=F64)
    with pytest.raises(DynamicHMCError, match="manually specified"):
        run_warmup(gen, ld, NUTS(), (InitialStepsizeSearch(),), state)
    with pytest.raises(DynamicHMCError, match="manually specified"):
        mcmc_keep_warmup(gen, ld, 5, initialization={"eps": 0.3})


# --- ports of JAX tests/test_mcmc.py ----------------------------------------


def test_keep_warmup_inspectable():
    out = mcmc_keep_warmup(torch.Generator().manual_seed(5), std_mvn(3), 100,
                           dtype=F64)
    history = out["warmup"]
    assert len(history) == 8  # search + 75 + 5 doubling + 50 (mcmc.jl:415-425)
    _stage0, results0, state0 = history[0]
    assert "eps" in results0 and bool(results0["success"])
    assert float(state0.eps) == float(results0["eps"])
    _stage1, results1, _state1 = history[1]
    assert results1["positions"].shape == (75, 3)
    assert results1["epss"].shape == (75,)
    for idx, n in zip(range(2, 7), [25, 50, 100, 200, 400]):
        assert history[idx][0].N == n
        assert history[idx][1]["positions"].shape == (n, 3)
    assert out["final_warmup_state"].eps is not None
    assert out["inference"].positions.shape == (100, 3)
    assert out["initial_warmup_state"].eps is None


def test_keep_warmup_history_aligned_with_the_stage_tuple():
    """None stages stay in the history as no-ops (JAX mcmc.py:316-336);
    each stage's state is the next stage's start."""
    stages = (None, InitialStepsizeSearch(), TuningNUTS(20), None,
              TuningNUTS(25, "dense"), TuningNUTS(20, "diagonal"))
    out = mcmc_keep_warmup(torch.Generator().manual_seed(1), std_mvn(2), 10,
                           warmup_stages=stages, dtype=F64,
                           collect_warmup_positions=False)
    history = out["warmup"]
    assert [h[0] for h in history] == list(stages)
    assert history[0][1] is None and history[3][1] is None
    assert history[3][2] is history[2][2]
    assert "positions" not in history[2][1]
    assert history[4][2].metric.m_inv.shape == (2, 2)
    assert history[5][2].metric.m_inv.shape == (2,)
    assert torch.equal(out["final_warmup_state"].metric.m_inv,
                       history[5][2].metric.m_inv)


@pytest.fixture(scope="module")
def adapted_2d():
    out = mcmc_keep_warmup(torch.Generator().manual_seed(6), std_mvn(2), 0,
                           dtype=F64)
    return out["final_warmup_state"]


def test_stepwise_api(adapted_2d):
    # mcmc.jl:295-351
    ld = std_mvn(2)
    steps = mcmc_steps(ld, NUTS(), adapted_2d.metric, adapted_2d.eps)
    gen = torch.Generator().manual_seed(0)
    Q, qs = adapted_2d.Q, []
    for _ in range(50):
        Q, _stats = steps.next_step(gen, Q)
        qs.append(Q.q)
    assert float(torch.stack(qs).std()) > 0.1  # the chain moves


def test_stepwise_chunk_matches_next_step(adapted_2d):
    ld = std_mvn(2)
    steps = mcmc_steps_from_state(ld, NUTS(), adapted_2d)
    n = 7
    Q_fin, chunk = steps.next_chunk(torch.Generator().manual_seed(42),
                                    adapted_2d.Q, n)
    assert chunk.positions.shape == (n, 2)
    assert chunk.logdensities.shape == (n,)
    assert chunk.tree_statistics.depth.shape == (n,)
    gen = torch.Generator().manual_seed(42)
    Q = adapted_2d.Q
    for i in range(n):
        Q, stats = steps.next_step(gen, Q)
        assert torch.equal(Q.q, chunk.positions[i])
        assert int(stats.depth) == int(chunk.tree_statistics.depth[i])
    assert torch.equal(Q.q, Q_fin.q)

    # a (C, K) batch runs the batch driver: shapes, chain isolation, and
    # the same draws as next_step on the batch
    Qb = evaluate(ld, torch.stack([adapted_2d.Q.q, adapted_2d.Q.q + 0.5]))
    Qb_fin, bchunk = steps.next_chunk(torch.Generator().manual_seed(42), Qb, n)
    assert bchunk.positions.shape == (n, 2, 2)
    assert bchunk.tree_statistics.depth.shape == (n, 2)
    assert Qb_fin.q.shape == (2, 2)
    assert not torch.allclose(bchunk.positions[:, 0], bchunk.positions[:, 1])
    gen = torch.Generator().manual_seed(42)
    for i in range(n):
        Qb, _stats = steps.next_step(gen, Qb)
        assert torch.equal(Qb.q, bchunk.positions[i])
    with pytest.raises(ValueError, match="n_steps"):
        steps.next_chunk(gen, Qb, 0)


def test_warmup_only_run():
    """n_samples=0 inspects the adaptation only: empty inference arrays of
    the right structure."""
    res = mcmc_with_warmup(torch.Generator().manual_seed(3), std_mvn(3), 0,
                           dtype=F64)
    assert res.positions.shape == (0, 3)
    assert res.logdensities.shape == (0,)
    assert res.tree_statistics.depth.shape == (0,)
    assert float(res.eps) > 0  # adaptation still ran


def test_keep_warmup_matches_fast_engine():
    """mcmc_keep_warmup (the stage fold, keeping every state) and
    mcmc_with_warmup (the same fold, keeping none) from one seed: bitwise
    the same adapted state and draws."""
    ld = std_mvn(3)
    out = mcmc_keep_warmup(torch.Generator().manual_seed(21), ld, 16,
                           dtype=F64)
    res = mcmc_with_warmup(torch.Generator().manual_seed(21), ld, 16,
                           dtype=F64)
    final = out["final_warmup_state"]
    assert torch.equal(final.eps, res.eps)
    assert torch.equal(final.metric.m_inv, res.metric.m_inv)
    assert torch.equal(out["inference"].positions, res.positions)
    tuning = [h for h in out["warmup"] if getattr(h[0], "N", None)]
    assert [h[0].N for h in tuning] == [75, 25, 50, 100, 200, 400, 50]
    for stage, results, _state in tuning:
        assert results["epss"].shape == (stage.N,)
        assert results["tree_statistics"].depth.shape == (stage.N,)


def test_heterogeneous_mcmc_with_warmup_is_keep_warmup():
    """A schedule of two metric kinds: bitwise mcmc_keep_warmup's draws,
    and it recovers N(0, I)."""
    stages = (InitialStepsizeSearch(), TuningNUTS(40),
              TuningNUTS(30, "diagonal"), TuningNUTS(60, "dense"),
              TuningNUTS(30))
    assert WarmupSchedule.from_stages(stages) is None
    ld = std_mvn(2)
    res = mcmc_with_warmup(torch.Generator().manual_seed(8), ld, 400,
                           warmup_stages=stages, dtype=F64)
    out = mcmc_keep_warmup(torch.Generator().manual_seed(8), ld, 400,
                           warmup_stages=stages, dtype=F64)
    assert torch.equal(res.positions, out["inference"].positions)
    assert res.metric.m_inv.shape == (2, 2)
    assert float(res.positions.mean(0).abs().max()) < 0.3
    assert 0.7 < float(res.positions.std(0).min())
    assert float(res.positions.std(0).max()) < 1.3


def test_new_entry_points_refuse_a_model_on_another_device():
    model = dataclasses.replace(std_mvn(2), device="meta")
    gen = torch.Generator().manual_seed(0)
    Q = evaluate(std_mvn(2), torch.zeros(2, dtype=F64))
    steps = mcmc_steps(model, NUTS(), None, 0.1)
    for call in (lambda: mcmc_keep_warmup(gen, model, 5),
                 lambda: steps.next_step(gen, Q),
                 lambda: steps.next_chunk(gen, Q, 2)):
        with pytest.raises(ValueError, match="generator's device"):
            call()
