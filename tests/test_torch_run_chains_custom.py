"""``run_chains`` with a custom turn statistic: the generic per-chain driver
looped over a batch (``engine.looped_ops``), against ``sample_tree`` and
the JAX package.

- The looped transition equals ``sample_tree(fast=False)`` called chain by
  chain from the same generator state, bit for bit, with shared and
  per-chain metrics; the looped search equals JAX's per-chain search on
  injected momenta.
- With injected momenta and direction bits, its depth, steps, termination
  and acceptance equal the JAX package's generic transition vmapped over
  the chains (to 1e-12), for the generalized statistic reimplemented and
  for one that never turns. The merge draws decide only the proposal, and
  they cannot be injected into the generic driver.
- ``run_chains`` with the reimplemented statistic gives the draws of the
  looped ops with the built-in generic driver, bit for bit; a draw sink
  gets them too; ``ess_target`` stops at a checked boundary; a
  heterogeneous schedule runs; ``mcmc`` on a batch takes the looped ops.
- What the JAX package refuses with a custom statistic (pooled stepsize,
  the warmup depth clamp, warmup checkpoint and resume; a batch stepped by
  ``MCMCSteps``), both packages refuse with one message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import models as jm
from dynamichmc_tpu.hamiltonian import PhasePoint as JPhasePoint
from dynamichmc_tpu.hamiltonian import evaluate as j_evaluate
from dynamichmc_tpu.metric import diagonal_metric as j_diag
from dynamichmc_tpu.mcmc import mcmc_steps as j_mcmc_steps
from dynamichmc_tpu.nuts import GeneralizedTurnStatistic as JGeneralized
from dynamichmc_tpu.nuts import NUTS as JNUTS
from dynamichmc_tpu.nuts import sample_tree as j_sample_tree
from dynamichmc_tpu.parallel import run_chains as j_run_chains
from dynamichmc_tpu.stepsize import find_initial_stepsize as j_find
from dynamichmc_tpu.stepsize import local_log_acceptance_ratio as j_local
from dynamichmc_tpu.warmup import default_warmup_stages as j_stages
from dynamichmc_tpu_torch import (
    NUTS,
    InitialStepsizeSearch,
    TuningNUTS,
    WarmupState,
    convert,
    mcmc,
    mcmc_steps,
    run_chains,
)
from dynamichmc_tpu_torch.engine import (
    _looped_transition,
    chain_metric,
    looped_ops,
    make_search_driver_looped,
    run_block,
    run_sampling,
)
from dynamichmc_tpu_torch.hamiltonian import EvaluatedPoint, evaluate
from dynamichmc_tpu_torch.metric import (
    DenseMetric,
    DiagonalMetric,
    dense_metric,
    diagonal_metric,
)
from dynamichmc_tpu_torch.nuts import GeneralizedTurnStatistic, sample_tree
from dynamichmc_tpu_torch.parallel.chains import _auto_tune, init_chain_states
from dynamichmc_tpu_torch.warmup import default_warmup_stages
from torch_turn_statistics import GeneralizedReimpl

F64 = torch.float64
C, K = 3, 4
CUSTOM = NUTS(max_depth=5, turn_statistic_configuration=GeneralizedReimpl())
STAGES = (InitialStepsizeSearch(), TuningNUTS(N=20),
          TuningNUTS(N=20, metric_kind="diagonal"), TuningNUTS(N=20))


class NeverTurning:
    """No merge ever turns: every transition ends at max depth or at a
    divergence."""

    def leaf(self, metric, z):
        return GeneralizedTurnStatistic(
            p_minus=z.p, psharp_minus=z.p, p_plus=z.p, psharp_plus=z.p,
            rho=z.p)

    def combine(self, metric, x, y):
        return GeneralizedTurnStatistic(
            p_minus=x.p_minus, psharp_minus=x.psharp_minus, p_plus=y.p_plus,
            psharp_plus=y.psharp_plus, rho=x.rho + y.rho), torch.tensor(False)


class JNeverTurning:
    def leaf(self, metric, z: JPhasePoint):
        return JGeneralized(p_minus=z.p, psharp_minus=z.p, p_plus=z.p,
                            psharp_plus=z.p, rho=z.p)

    def combine(self, metric, x, y):
        return JGeneralized(
            p_minus=x.p_minus, psharp_minus=x.psharp_minus, p_plus=y.p_plus,
            psharp_plus=y.psharp_plus, rho=x.rho + y.rho), jnp.asarray(False)


class JReimpl:
    """JAX's generalized statistic as a custom configuration (JAX
    tests/test_nuts.py's reimplementation)."""

    def leaf(self, metric, z):
        from dynamichmc_tpu.hamiltonian import calculate_psharp

        ps = calculate_psharp(metric, z)
        return JGeneralized(p_minus=z.p, psharp_minus=ps, p_plus=z.p,
                            psharp_plus=ps, rho=z.p)

    def combine(self, metric, x, y):
        from dynamichmc_tpu.nuts import _combine_turn_statistics

        return _combine_turn_statistics(x, y)


def _models():
    jmodel = jm.correlated_gaussian(K, dtype=jnp.float64)
    return jmodel, convert.gaussian_model(jmodel, device="cpu")


def _metrics(kind):
    """(the batch's metric, each chain's metric): a shared metric, or a
    per-chain one built batched (as the warmup estimates it) with each
    chain's a copy of its row."""
    rng = np.random.default_rng(4)
    if kind.endswith("diag"):
        m_inv = torch.as_tensor(rng.uniform(0.5, 2.0, (C, K)))
        build = diagonal_metric
    else:
        a = rng.normal(size=(C, K, K))
        m_inv = torch.as_tensor(a @ a.transpose(0, 2, 1) / K + np.eye(K))
        build = dense_metric
    if kind.startswith("shared"):
        metric = build(m_inv[0].clone())
        return metric, [metric] * C
    metric = build(m_inv)
    rows = [type(metric)(**{f.name: getattr(metric, f.name)[c].clone()
                            for f in dataclasses.fields(metric)})
            for c in range(C)]
    return metric, rows


def _start(model, seed=0):
    q = torch.as_tensor(np.random.default_rng(seed).normal(size=(C, K)))
    return evaluate(model, q)


def _row(Q, c):
    return EvaluatedPoint(q=Q.q[c], logdensity=Q.logdensity[c],
                          grad=Q.grad[c])


STAT_FIELDS = ("logdensity", "depth", "term_left", "term_right",
               "acceptance_rate", "steps", "directions")


@pytest.mark.parametrize("algorithm", [NUTS(max_depth=5), CUSTOM],
                         ids=["generic", "reimplemented"])
@pytest.mark.parametrize("kind", ["shared_diag", "chain_diag",
                                  "shared_dense", "chain_dense"])
def test_looped_transition_is_sample_tree_chain_by_chain(kind, algorithm):
    _jmodel, model = _models()
    metric, rows = _metrics(kind)
    eps = torch.tensor([0.3, 0.45, 0.6], dtype=F64)
    for c in range(C):
        assert all(torch.equal(getattr(chain_metric(metric, c), f.name),
                               getattr(rows[c], f.name))
                   for f in dataclasses.fields(metric))
    Q = _start(model)
    gen_a = torch.Generator().manual_seed(9)
    gen_b = torch.Generator().manual_seed(9)
    for _ in range(3):
        Qa, sa = _looped_transition(gen_a, algorithm, model, metric, Q, eps)
        outs = [sample_tree(gen_b, algorithm, model, rows[c], _row(Q, c),
                            eps[c], fast=False) for c in range(C)]
        for c, (Qb, sb) in enumerate(outs):
            assert torch.equal(Qa.q[c], Qb.q)
            assert torch.equal(Qa.logdensity[c], Qb.logdensity)
            assert torch.equal(Qa.grad[c], Qb.grad)
            for name in STAT_FIELDS:
                assert torch.equal(getattr(sa, name)[c], getattr(sb, name))
        assert sa.work is None and tuple(sa.depth.shape) == (C,)
        Q = Qa
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


def test_looped_transition_has_no_depth_clamp():
    _jmodel, model = _models()
    metric, _rows = _metrics("shared_diag")
    with pytest.raises(ValueError, match="depth clamp"):
        _looped_transition(torch.Generator(), CUSTOM, model, metric,
                           _start(model), 0.3, depth_limit=2)


@pytest.mark.parametrize("statistic", ["reimplemented", "never turning"])
def test_looped_transition_matches_the_jax_generic_transition(statistic):
    jmodel, model = _models()
    md = 5
    if statistic == "reimplemented":
        algo, jalgo = (NUTS(max_depth=md, turn_statistic_configuration=
                            GeneralizedReimpl()),
                       JNUTS(max_depth=md, turn_statistic_configuration=
                             JReimpl()))
    else:
        algo, jalgo = (NUTS(max_depth=md, turn_statistic_configuration=
                            NeverTurning()),
                       JNUTS(max_depth=md, turn_statistic_configuration=
                             JNeverTurning()))
    rng = np.random.default_rng(11)
    m_inv = rng.uniform(0.5, 2.0, size=(C, K))
    metric = diagonal_metric(torch.as_tensor(m_inv))
    jmetric = jax.vmap(j_diag)(jnp.asarray(m_inv))

    @jax.jit
    def j_step(keys, Q, p, dirs, eps):
        return jax.vmap(lambda k, m, Qc, pc, dc, ec: j_sample_tree(
            k, jalgo, jmodel, m, Qc, ec, p=pc, directions=dc, fast=False))(
            keys, jmetric, Q, p, dirs, eps)

    terms = set()
    for step in range(6):
        q = rng.normal(size=(C, K))
        p = rng.normal(size=(C, K))
        dirs = rng.integers(0, 2**32, size=C, dtype=np.uint64)
        eps = np.full(C, 30.0 if step == 4 else 0.3)  # one divergent step
        eps[1] *= 0.5
        _Qj, sj = j_step(jax.random.split(jax.random.PRNGKey(step), C),
                         jax.vmap(lambda x: j_evaluate(jmodel, x))(
                             jnp.asarray(q)),
                         jnp.asarray(p), jnp.asarray(dirs, jnp.uint32),
                         jnp.asarray(eps))
        _Qt, st = _looped_transition(
            torch.Generator().manual_seed(step), algo, model, metric,
            evaluate(model, torch.as_tensor(q)), torch.as_tensor(eps),
            p=torch.as_tensor(p),
            directions=torch.as_tensor(dirs.astype(np.int64)))
        for name in ("depth", "steps", "term_left", "term_right"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(sj, name)),
                                          err_msg=name)
        np.testing.assert_allclose(st.acceptance_rate.numpy(),
                                   np.asarray(sj.acceptance_rate), rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(
            st.directions.numpy(),
            np.asarray(sj.directions, np.uint32).view(np.int32))
        for c in range(C):
            terms.add("divergent" if bool(st.is_divergent[c]) else
                      "max" if bool(st.reached_max_depth[c]) else "turning")
    want = ({"max", "divergent"} if statistic == "never turning"
            else {"turning", "divergent"})
    assert want <= terms, terms


def test_looped_search_matches_the_jax_per_chain_search():
    """The search of each chain, on injected momenta: JAX's per-chain
    bracketing (what its vmapped search runs), eps and success exactly,
    the starting joint density to 1e-12."""
    from dynamichmc_tpu.stepsize import InitialStepsizeSearch as JSearch

    jmodel, model = _models()
    metric, rows = _metrics("chain_diag")
    Q = _start(model, 2)
    p = torch.as_tensor(np.random.default_rng(3).normal(size=(C, K)))
    eps, success, l0 = make_search_driver_looped(
        model, InitialStepsizeSearch())(None, Q, metric, p=p)
    assert tuple(eps.shape) == tuple(success.shape) == tuple(l0.shape) == (C,)
    for c in range(C):
        jm_c = j_diag(jnp.asarray(rows[c].m_inv.numpy()))
        z = JPhasePoint(Q=j_evaluate(jmodel, jnp.asarray(Q.q[c].numpy())),
                        p=jnp.asarray(p[c].numpy()))
        A, jl0 = j_local(jmodel, jm_c, z)
        jeps, jok = j_find(JSearch(), A, dtype=jnp.float64)
        assert float(eps[c]) == float(jeps) and bool(success[c]) == bool(jok)
        np.testing.assert_allclose(float(l0[c]), float(jl0), rtol=0,
                                   atol=1e-12)


# --- run_chains -------------------------------------------------------------


def _run(algorithm=CUSTOM, stages=STAGES, n_samples=24, seed=5, **kw):
    _jmodel, model = _models()
    return run_chains(torch.Generator().manual_seed(seed), model, C,
                      n_samples, warmup_stages=stages, algorithm=algorithm,
                      dtype=F64, **kw)


_KEPT = {}


def _kept():
    if "res" not in _KEPT:
        _KEPT["res"] = _run()
    return _KEPT["res"]


def test_run_chains_is_the_looped_built_in_generic_driver():
    """run_chains with the reimplemented statistic, and the same fold
    written out with the looped ops and NUTS()'s own generic driver: the
    same draws, statistics, eps and metric, bit for bit."""
    res = _kept()
    _jmodel, model = _models()
    gen = torch.Generator().manual_seed(5)
    states = init_chain_states(gen, model, C, dtype=F64)
    algo = NUTS(max_depth=5)
    ops = looped_ops(False)
    eps, _ok, _l0 = ops.make_search(model, STAGES[0])(gen, states.Q,
                                                      states.metric)
    Q, metric = states.Q, states.metric
    for stage in STAGES[1:]:
        Q, metric, eps, _ = run_block(gen, model, algo, stage, Q, metric, eps,
                                      ops)
    _Q, positions, lds, stats = run_sampling(gen, model, algo, Q, metric, eps,
                                             24, ops=ops)
    assert torch.equal(res.positions, positions)
    assert torch.equal(res.logdensities, lds)
    for name in STAT_FIELDS:
        assert torch.equal(getattr(res.tree_statistics, name),
                           getattr(stats, name)), name
    assert torch.equal(res.eps, eps) and torch.equal(res.metric.m_inv,
                                                     metric.m_inv)
    assert tuple(res.positions.shape) == (C, 24, K)
    assert tuple(res.metric.m_inv.shape) == (C, K)  # per-chain diagonal


def test_auto_leaves_a_custom_statistic_alone():
    """Under tune="auto" a custom statistic gets no stages, no clamp and no
    cap, as in the JAX package (which then logs no autotune line)."""
    for n_chains in (3, 256, 4096):
        algorithm, stages, clamp, tail, cap = _auto_tune(
            n_chains, K, CUSTOM, None, None, 0, False, None)
        assert (algorithm, stages, clamp, tail, cap) == (CUSTOM, None, None,
                                                         0, None)
    lines = []
    _run(n_samples=2, stages=(None, TuningNUTS(N=20)), log=lines.append,
         initialization={"eps": 0.3})
    assert not [line for line in lines if line.startswith("autotune")]


@pytest.mark.parametrize("chunk", [5, None])
def test_draw_sink_gets_the_kept_draws(chunk):
    got = np.zeros((C, 24, K))
    lds = np.zeros((C, 24))

    def sink(start, positions, logdensities, tree_statistics):
        n = positions.shape[1]
        got[:, start:start + n] = positions.numpy()
        lds[:, start:start + n] = logdensities.numpy()

    res = _run(draw_sink=sink, sample_chunk=chunk)
    assert res.positions is None
    np.testing.assert_array_equal(got, _kept().positions.numpy())
    np.testing.assert_array_equal(lds, _kept().logdensities.numpy())
    assert torch.equal(res.tree_statistics.depth,
                       _kept().tree_statistics.depth)


def test_ess_target_stops_at_a_checked_boundary():
    lines = []
    res = _run(ess_target=1e-3, sample_chunk=4, ess_check_start=8,
               log=lines.append)
    assert tuple(res.positions.shape) == (C, 8, K)
    assert torch.equal(res.positions, _kept().positions[:, :8])
    assert [line.split(":")[0] for line in lines
            if line.startswith("ess check")] == ["ess check @ 8 draws"]


def test_heterogeneous_stages_run():
    stages = (InitialStepsizeSearch(), TuningNUTS(N=20),
              TuningNUTS(N=20, metric_kind="dense"),
              TuningNUTS(N=20, metric_kind="diagonal"), TuningNUTS(N=20))
    res = _run(stages=stages, n_samples=10)
    assert tuple(res.positions.shape) == (C, 10, K)
    assert bool(torch.isfinite(res.positions).all())
    assert isinstance(res.metric, DiagonalMetric)
    assert tuple(res.metric.m_inv.shape) == (C, K)


def test_mcmc_on_a_batch_takes_the_looped_ops():
    _jmodel, model = _models()
    metric, _rows = _metrics("chain_dense")
    assert isinstance(metric, DenseMetric)
    state = WarmupState(Q=_start(model), metric=metric,
                        eps=torch.tensor([0.3, 0.4, 0.5], dtype=F64))
    _Q, inference = mcmc(torch.Generator().manual_seed(1), model, CUSTOM,
                         state, 6)
    _Q2, positions, _lds, _stats = run_sampling(
        torch.Generator().manual_seed(1), model, NUTS(max_depth=5), state.Q,
        metric, state.eps, 6, ops=looped_ops(False))
    assert torch.equal(inference.positions, positions)


# --- what both packages refuse ----------------------------------------------

SMALL = dict(init_steps=20, middle_steps=20, doubling_stages=1,
             terminating_steps=20)
REFUSALS = {
    "pooled stepsize": (
        dict(warmup_stages=default_warmup_stages(pooled_stepsize=True,
                                                 **SMALL)),
        dict(warmup_stages=j_stages(pooled_stepsize=True, **SMALL)),
        "pooled stepsize adaptation requires the batch-native drivers "
        r"\(generalized turn statistic\)"),
    "warmup clamp": (
        dict(warmup_depth_clamp=2), dict(warmup_depth_clamp=2),
        r"warmup_depth_clamp requires the batch-native drivers "
        r"\(generalized turn statistic\)"),
    "warmup checkpoint": (
        dict(warmup_checkpoint_sink=print),
        dict(warmup_checkpoint_sink=print),
        r"warmup checkpoint/resume requires the batch-native drivers "
        r"\(generalized turn statistic\)"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refused_as_in_the_jax_package(case):
    port_kw, jax_kw, message = REFUSALS[case]
    jmodel, model = _models()
    port_kw.setdefault("warmup_stages", default_warmup_stages(**SMALL))
    jax_kw.setdefault("warmup_stages", j_stages(**SMALL))
    with pytest.raises(NotImplementedError, match=message):
        run_chains(torch.Generator().manual_seed(0), model, C, 4,
                   algorithm=NUTS(turn_statistic_configuration=NeverTurning()),
                   dtype=F64, **port_kw)
    with pytest.raises(NotImplementedError, match=message):
        j_run_chains(jax.random.PRNGKey(0), jmodel, C, 4,
                     algorithm=JNUTS(turn_statistic_configuration=
                                     JNeverTurning()),
                     dtype=jnp.float64, **jax_kw)


def test_stepping_a_batch_is_refused_as_in_the_jax_package():
    """MCMCSteps on a (C, K) batch runs the batch driver in both packages,
    which takes the generalized statistic only."""
    jmodel, model = _models()
    message = "supports only the generalized turn statistic"
    metric, _rows = _metrics("shared_diag")
    steps = mcmc_steps(model, CUSTOM, metric, 0.3)
    with pytest.raises(NotImplementedError, match=message):
        steps.next_chunk(torch.Generator().manual_seed(0), _start(model), 2)
    jsteps = j_mcmc_steps(jmodel, JNUTS(turn_statistic_configuration=
                                        JNeverTurning()),
                          j_diag(jnp.ones(K)), 0.3)
    with pytest.raises(NotImplementedError, match=message):
        jsteps.next_chunk(jax.random.PRNGKey(0),
                          jax.vmap(lambda x: j_evaluate(jmodel, x))(
                              jnp.zeros((C, K))), 2)
