"""Port parity: the aligned wavefront warmup driver
(dynamichmc_tpu_torch.tree_wavefront) against the JAX package's
(dynamichmc_tpu.tree_wavefront), float64, on the CPU.

With the same injected WavefrontNoise (tests/test_equivalence_wavefront.py's
draws, indexed by each lane's own transition, doubling and leaf) both
drivers are deterministic: final positions agree to 1e-12, and the final
slot counter ``g``, the step, divergence and max-depth counts exactly;
so do the clamped, tail-clamped and pooled-eps stages. The port's
wavefront is also held against the port's own lockstep driver fed the
matching TreeNoise per transition (C = 1), lane by lane (C = 3 against
three C = 1 runs) and across chunked calls. The masked Welford updates
are held against JAX's to 1e-12, and run_chains' wavefront warmup
recovers a small Gaussian's moments.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu.tree_wavefront import _trailing_ones as j_trailing_ones
from dynamichmc_tpu.tree_wavefront import (
    make_wavefront_stage_driver as j_make_stage,
)
from dynamichmc_tpu.tree_wavefront import wavefront_init as j_wavefront_init
from dynamichmc_tpu.tree_wavefront import welford_update_masked as j_masked
from dynamichmc_tpu.tree_wavefront import (
    welford_update_pooled_masked as j_pooled_masked,
)
from dynamichmc_tpu.utils.welford import WelfordState as JWelfordState
from dynamichmc_tpu_torch import convert, run_chains
from dynamichmc_tpu_torch.hamiltonian import evaluate
from dynamichmc_tpu_torch.models import mvnormal, std_normal
from dynamichmc_tpu_torch.nuts import NUTS
from dynamichmc_tpu_torch.stepsize import FixedStepsize, PooledStepsize
from dynamichmc_tpu_torch.tree import TreeNoise
from dynamichmc_tpu_torch.tree_batched import sample_tree_batched
from dynamichmc_tpu_torch.tree_wavefront import (
    WavefrontNoise,
    _trailing_ones,
    make_wavefront_stage_driver,
    wavefront_init,
)
from dynamichmc_tpu_torch.utils.welford import (
    WelfordState,
    welford_update_masked,
    welford_update_pooled_masked,
)
from dynamichmc_tpu_torch.warmup import default_warmup_stages
from test_equivalence_batched import build_case
from test_equivalence_wavefront import (
    CASES_FAST,
    draw_wavefront_noise,
    run_wavefront,
)

F64 = torch.float64
TOL = 1e-12


def port_case(model_key, metric_key):
    """The port's model and metric of JAX build_case(model_key,
    metric_key), and the JAX pair."""
    j_model, j_metric, K = build_case(model_key, metric_key)
    if model_key == "std4":
        model = std_normal(K, dtype=F64, device="cpu")
    else:
        a = np.random.RandomState(3).randn(K, K)
        model = mvnormal(np.zeros(K), a @ a.T + 0.5 * np.eye(K), dtype=F64,
                         device="cpu")
    return model, convert.metric(j_metric), K, j_model, j_metric


def port_noise(nz, cls=WavefrontNoise):
    return cls(*(convert.tensor(np.asarray(x)) for x in nz))


def lane_noise(nz, c):
    """Lane c's draws of a (.., C) noise tuple."""
    return type(nz)(p=nz.p[:, c:c + 1], dirs=nz.dirs[:, c:c + 1],
                    gumbel=nz.gumbel[..., c:c + 1],
                    expo=nz.expo[..., c:c + 1])


def port_wavefront(model, metric, q0, eps, T, max_depth, nz,
                   depth_limit=None, tail_steps=None, g_chunk=None):
    """T transitions a lane through the port's wavefront (FixedStepsize, no
    Welford), in calls of ``g_chunk`` slots if given; the final carry."""
    C = q0.shape[0]
    adaptation = FixedStepsize()
    stage = make_wavefront_stage_driver(model, NUTS(max_depth=max_depth),
                                        adaptation, use_welford=False,
                                        noise=nz)
    Q0 = evaluate(model, torch.as_tensor(q0, dtype=F64))
    carry = wavefront_init(Q0, metric,
                           adaptation.init(torch.full((C,), eps, dtype=F64)),
                           None, max_depth)
    done, stop = False, 0
    while not done:
        stop = None if g_chunk is None else stop + g_chunk
        carry, done = stage(None, metric, carry, T, g_stop=stop,
                            depth_limit=depth_limit, tail_steps=tail_steps)
    return carry


def assert_matches_jax(mine, theirs, label):
    np.testing.assert_allclose(mine["Q"].q.numpy(), np.asarray(theirs["Q"].q),
                               rtol=TOL, atol=TOL, err_msg=f"{label}: q")
    assert mine["g"] == int(theirs["g"]), label
    for field in ("steps_total", "div", "maxd", "t"):
        np.testing.assert_array_equal(mine[field].numpy(),
                                      np.asarray(theirs[field]),
                                      err_msg=f"{label}: {field}")
    np.testing.assert_allclose(mine["acc_sum"].numpy(),
                               np.asarray(theirs["acc_sum"]), rtol=TOL,
                               err_msg=f"{label}: summed acceptance")


# --- the JAX runs, each compiled once ---------------------------------------


class Lazy(dict):
    """A dict whose missing entries ``make(key)`` fills on first read."""

    def __init__(self, make):
        super().__init__()
        self.make = make

    def __missing__(self, key):
        self[key] = self.make(key)
        return self[key]


@pytest.fixture(scope="module")
def jax_runs():
    """key -> (JAX final carry, its inputs), each JAX run made on a test's
    first read (so once per module, and never in a process that runs no
    test): a CASES_FAST case, ("clamp", depth_limit) or "tail"."""
    return Lazy(_jax_run)


def _jax_run(key):
    if key == "tail":  # JAX's per-lane tail-clamp case
        inputs = ("std4", "identity", 0.3, 48, 6, b"wf-tail-clamp", 11,
                  {"depth_limit": 2, "tail_steps": 20})
    elif key[0] == "clamp":  # JAX's clamped cases
        depth_limit = key[1]
        inputs = ("std4", "identity", {2: 0.6, 4: 0.15}[depth_limit], 48, 6,
                  f"wf-clamp/{depth_limit}".encode(), 7,
                  {"depth_limit": depth_limit})
    else:
        model_key, metric_key, eps = key
        inputs = (model_key, metric_key, eps, 64, 6,
                  f"wf/{model_key}/{metric_key}/{eps}".encode(), 5, {})
    model_key, metric_key, eps, T, md, label, q_seed, kw = inputs
    j_model, j_metric, K = build_case(model_key, metric_key)
    nz = draw_wavefront_noise(zlib.crc32(label), T, md, K, j_metric, C=1)
    q0 = np.random.RandomState(q_seed).randn(1, K)
    return (run_wavefront(j_model, j_metric, jnp.asarray(q0), eps, T, md, nz,
                          **kw),
            (model_key, metric_key, eps, T, md, nz, q0, kw))


def _port_of(inputs, **extra):
    model_key, metric_key, eps, T, md, nz, q0, kw = inputs
    model, metric, _K, _jm, _jmet = port_case(model_key, metric_key)
    return port_wavefront(model, metric, q0, eps, T, md, port_noise(nz),
                          **kw, **extra)


@pytest.mark.parametrize("case", [tuple(c) for c in CASES_FAST],
                         ids=["/".join(map(str, c)) for c in CASES_FAST])
def test_wavefront_matches_jax(jax_runs, case):
    theirs, inputs = jax_runs[case]
    assert_matches_jax(_port_of(inputs), theirs, "/".join(map(str, case)))


@pytest.mark.parametrize("key", [("clamp", 2), ("clamp", 4), "tail"],
                         ids=["clamp2", "clamp4", "tail_clamp"])
def test_clamped_wavefront_matches_jax(jax_runs, key):
    """The depth clamp and the per-lane tail clamp, with JAX's cases of
    tests/test_equivalence_wavefront.py: the clamp binds."""
    theirs, inputs = jax_runs[key]
    mine = _port_of(inputs)
    assert_matches_jax(mine, theirs, str(key))
    assert int(mine["maxd"][0]) > 0


def test_chunked_calls_are_bitwise_one_call(jax_runs):
    """g_stop cuts the stage into calls of 24 slots: the same carry."""
    _theirs, inputs = jax_runs[tuple(CASES_FAST[1])]
    one, chunked = _port_of(inputs), _port_of(inputs, g_chunk=24)
    assert one["g"] == chunked["g"]
    for field in ("steps_total", "div", "maxd", "acc_sum"):
        assert torch.equal(one[field], chunked[field]), field
    assert torch.equal(one["Q"].q, chunked["Q"].q)


@pytest.mark.parametrize("case", [tuple(c) for c in CASES_FAST],
                         ids=["/".join(map(str, c)) for c in CASES_FAST])
def test_wavefront_matches_the_port_lockstep_driver(jax_runs, case):
    """C = 1: the wavefront equals the port's tree_batched driver chained
    over the same T transitions, each fed that transition's draws."""
    _theirs, (model_key, metric_key, eps, T, md, nz, q0, _kw) = jax_runs[case]
    model, metric, _K, _jm, _jmet = port_case(model_key, metric_key)
    tnz = port_noise(nz)
    mine = port_wavefront(model, metric, q0, eps, T, md, tnz)
    Q = evaluate(model, torch.as_tensor(q0, dtype=F64))
    steps = div = maxd = 0
    for t in range(T):
        Q, stats = sample_tree_batched(
            None, NUTS(max_depth=md), model, metric, Q,
            torch.full((1,), eps, dtype=F64), directions=tnz.dirs[t],
            p=tnz.p[t], noise=TreeNoise(tnz.gumbel[t], tnz.expo[t]))
        steps += int(stats.steps[0])
        div += int(stats.is_divergent[0])
        maxd += int(stats.reached_max_depth[0])
    np.testing.assert_allclose(mine["Q"].q.numpy(), Q.q.numpy(), rtol=TOL,
                               atol=TOL)
    assert (int(mine["steps_total"][0]), int(mine["div"][0]),
            int(mine["maxd"][0])) == (steps, div, maxd)


def test_lane_isolation():
    """C = 3 with per-lane noise equals three C = 1 runs."""
    T, md, C, eps = 48, 6, 3, 1.0
    model, metric, K, _jm, j_metric = port_case("corr5", "dense")
    nz = port_noise(draw_wavefront_noise(23, T, md, K, j_metric, C=C))
    q0 = np.random.RandomState(6).randn(C, K)
    full = port_wavefront(model, metric, q0, eps, T, md, nz)
    for c in range(C):
        one = port_wavefront(model, metric, q0[c:c + 1], eps, T, md,
                             lane_noise(nz, c))
        np.testing.assert_allclose(one["Q"].q[0].numpy(),
                                   full["Q"].q[c].numpy(), rtol=TOL, atol=TOL)
        for field in ("steps_total", "div", "maxd"):
            assert one[field][0] == full[field][c], (c, field)


def test_pooled_eps_matches_jax():
    """A PooledStepsize stage: one dual-averaging update every 16 slots
    from the completed transitions' mean acceptance. The epochal states,
    the final eps, the slot count and the pooled Welford moments equal
    JAX's."""
    from dynamichmc_tpu.hamiltonian import evaluate as j_evaluate
    from dynamichmc_tpu.nuts import NUTS as JNUTS
    from dynamichmc_tpu.stepsize import PooledStepsize as JPooledStepsize
    from dynamichmc_tpu.utils.welford import welford_init

    T, md, C = 40, 6, 4
    model, metric, K, j_model, j_metric = port_case("corr5", "dense")
    nz = draw_wavefront_noise(57, T, md, K, j_metric, C=C)
    q0 = np.random.RandomState(8).randn(C, K)
    eps0 = np.exp(np.random.RandomState(9).normal(size=C) * 0.3)
    j_adapt = JPooledStepsize()
    j_stage = j_make_stage(j_model, JNUTS(max_depth=md), j_adapt,
                           pooled_welford=True, pooled_eps=True, noise=nz)
    Qj = jax.vmap(lambda q: j_evaluate(j_model, q))(jnp.asarray(q0))
    carry = j_wavefront_init(Qj, j_metric, j_adapt.init(jnp.asarray(eps0)),
                             welford_init(K, True, jnp.float64), md)
    theirs, _ = jax.jit(lambda c: j_stage(
        jax.random.PRNGKey(0), j_metric, c, jnp.int32(T),
        jnp.int32(10**9)))(carry)

    adapt = PooledStepsize()
    stage = make_wavefront_stage_driver(model, NUTS(max_depth=md), adapt,
                                        pooled_welford=True, pooled_eps=True,
                                        noise=port_noise(nz))
    Q0 = evaluate(model, torch.as_tensor(q0, dtype=F64))
    wf0 = WelfordState(count=torch.zeros((), dtype=F64),
                       mean=torch.zeros(K, dtype=F64),
                       m2=torch.zeros((K, K), dtype=F64))
    mine, done = stage(None, metric, wavefront_init(
        Q0, metric, adapt.init(torch.as_tensor(eps0)), wf0, md), T)
    assert done
    assert_matches_jax(mine, theirs, "pooled eps")
    for name in ("mu", "m", "h_bar", "log_eps", "log_eps_bar"):
        np.testing.assert_allclose(getattr(mine["da"], name).numpy(),
                                   np.asarray(getattr(theirs["da"], name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    assert float(mine["da"].m) > 2  # several epochal updates fired
    for name in ("count", "mean", "m2"):
        np.testing.assert_allclose(getattr(mine["wf"], name).numpy(),
                                   np.asarray(getattr(theirs["wf"], name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


# --- pieces -----------------------------------------------------------------


def test_trailing_ones_matches_jax():
    gs = np.arange(0, 4200)
    theirs = np.asarray(jax.vmap(j_trailing_ones)(jnp.asarray(gs, jnp.int32)))
    assert [_trailing_ones(int(g)) for g in gs] == theirs.tolist()


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
@pytest.mark.parametrize("pooled", [False, True], ids=["per_chain", "pooled"])
def test_masked_welford_matches_jax(pooled, dense):
    """30 masked folds of 6 lanes x 3 coordinates, about 40% of the rows
    in each, against JAX's updates, to 1e-12; the pooled fold also equals
    the moments of the rows it took."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(30, 6, 3)) + np.array([1.0, -2.0, 0.5])
    masks = rng.random((30, 6)) < 0.4
    lead = () if pooled else (6,)
    m2 = lead + ((3, 3) if dense else (3,))
    st = WelfordState(count=torch.zeros(lead, dtype=F64),
                      mean=torch.zeros(lead + (3,), dtype=F64),
                      m2=torch.zeros(m2, dtype=F64))
    jst = JWelfordState(count=jnp.zeros(lead), mean=jnp.zeros(lead + (3,)),
                        m2=jnp.zeros(m2))
    mine_fn = welford_update_pooled_masked if pooled else welford_update_masked
    theirs_fn = j_pooled_masked if pooled else j_masked
    for x, m in zip(xs, masks):
        st = mine_fn(st, torch.from_numpy(x), torch.from_numpy(m))
        jst = theirs_fn(jst, jnp.asarray(x), jnp.asarray(m))
    for name in ("count", "mean", "m2"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)), rtol=TOL,
                                   atol=TOL, err_msg=name)
    if pooled:
        rows = xs[masks]
        centred = rows - rows.mean(0)
        want = centred.T @ centred if dense else (centred ** 2).sum(0)
        assert int(st.count) == len(rows)
        np.testing.assert_allclose(st.m2.numpy(), want, rtol=1e-10)


# --- run_chains -------------------------------------------------------------


def _target(dim=4, seed=5):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(dim, dim))
    cov = a @ a.T + 0.3 * np.eye(dim)
    return mvnormal(np.zeros(dim), cov, dtype=F64, device="cpu"), cov


def test_run_chains_wavefront_per_chain_adaptation():
    """JAX tests/test_wavefront.py's per-chain case: every lane adapts its
    own eps, and the draws recover N(0, I_3)."""
    res = run_chains(
        torch.Generator().manual_seed(2), std_normal(3, dtype=F64,
                                                      device="cpu"),
        8, 200, dtype=F64, tune="reference", warmup_driver="wavefront",
        warmup_stages=default_warmup_stages(init_steps=40, middle_steps=20,
                                            doubling_stages=3,
                                            terminating_steps=25))
    assert res.eps.shape == (8,)
    assert len(set(res.eps.tolist())) == 8
    qs = res.positions.reshape(-1, 3).numpy()
    assert np.abs(qs.std(0) - 1).max() < 0.12


@pytest.mark.parametrize("pooled_stepsize", [False, True],
                         ids=["per_chain_eps", "pooled_eps"])
def test_run_chains_wavefront_recovers_moments(pooled_stepsize):
    """A pooled dense metric through the wavefront, with the depth clamp
    and its tail: the moments of a correlated 4-d Gaussian (JAX
    tests/test_wavefront.py's end-to-end bands)."""
    ld, cov = _target()
    res = run_chains(
        torch.Generator().manual_seed(1), ld, 16, 400, dtype=F64,
        tune="reference", warmup_driver="wavefront", warmup_depth_clamp=2,
        warmup_depth_clamp_tail=10,
        warmup_stages=default_warmup_stages(
            metric_kind="dense", pooled=True,
            pooled_stepsize=pooled_stepsize, init_steps=75, middle_steps=25,
            doubling_stages=3, terminating_steps=50))
    sd = np.sqrt(np.diag(cov))
    qs = res.positions.reshape(-1, 4).numpy()
    assert np.abs(qs.std(0) / sd - 1).max() < 0.08
    assert np.abs(qs.mean(0) / sd).max() < 0.08
    assert float(res.tree_statistics.acceptance_rate.mean()) > 0.7
    assert res.eps.ndim == (0 if pooled_stepsize else 1)
    np.testing.assert_allclose(res.metric.m_inv.numpy(), cov,
                               atol=0.4 * np.abs(cov).max())


def test_wavefront_refuses_what_jax_refuses():
    """Checkpoints and custom statistics, as JAX run_chains refuses them."""
    from dynamichmc_tpu_torch import TuningNUTS
    from torch_turn_statistics import GeneralizedReimpl

    ld = std_normal(2, dtype=F64, device="cpu")
    kw = dict(dtype=F64, tune="reference", warmup_driver="wavefront")
    with pytest.raises(NotImplementedError, match="sync"):
        run_chains(torch.Generator(), ld, 4, 4, warmup_checkpoint_sink=print,
                   **kw)
    with pytest.raises(NotImplementedError, match="fast-engine"):
        run_chains(torch.Generator(), ld, 4, 4, warmup_stages=(
            TuningNUTS(20, "diagonal"), TuningNUTS(20, "dense")), **kw)
    with pytest.raises(NotImplementedError, match="batch-native"):
        run_chains(torch.Generator(), ld, 4, 4, algorithm=NUTS(
            turn_statistic_configuration=GeneralizedReimpl()), **kw)
