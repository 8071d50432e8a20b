"""Port parity: the epoch wavefront sampling driver
(dynamichmc_tpu_torch.tree_wavefront_epoch) against the JAX package's
(dynamichmc_tpu.tree_wavefront_epoch), float64, on the CPU.

With the same injected EpochNoise both drivers are deterministic: every
draw agrees (positions, log densities and acceptance to 1e-12; depth,
steps, termination, direction bits and ``work`` exactly), and so does the
final slot counter ``g``, for C = 1 and 3 and for rings 2 and 8. The port's
driver is also held against the port's own lockstep driver over the same
transitions (C = 1), lane by lane, across chunked calls and across ring
sizes (ring 2 gives the draws of ring 32). run_chains'
``sampling_driver="epoch"`` gives draws of the expected shapes and
moments, streams them through a draw sink and refuses what JAX refuses.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu.hamiltonian import evaluate as j_evaluate
from dynamichmc_tpu.nuts import NUTS as JNUTS
from dynamichmc_tpu.tree_wavefront_epoch import (
    epoch_sampling_finish as j_finish,
)
from dynamichmc_tpu.tree_wavefront_epoch import epoch_sampling_init as j_init
from dynamichmc_tpu.tree_wavefront_epoch import (
    make_epoch_sampling_driver as j_make_driver,
)
from dynamichmc_tpu_torch import run_chains
from dynamichmc_tpu_torch.hamiltonian import evaluate
from dynamichmc_tpu_torch.models import std_normal
from dynamichmc_tpu_torch.nuts import NUTS
from dynamichmc_tpu_torch.tree import TreeNoise
from dynamichmc_tpu_torch.tree_batched import sample_tree_batched
from dynamichmc_tpu_torch.tree_wavefront_epoch import (
    EpochNoise,
    epoch_sampling_finish,
    epoch_sampling_init,
    make_epoch_sampling_driver,
)
from test_equivalence_epoch import CASES_FAST, draw_epoch_noise
from test_torch_wavefront import Lazy, lane_noise, port_case, port_noise

F64 = torch.float64
TOL = 1e-12
INT_FIELDS = ("depth", "steps", "term_left", "term_right", "directions",
              "work")


def jax_epoch(j_model, j_metric, q0, eps, T, md, nz, ring=8):
    """JAX's driver run to the end: (final g, (Q', qs, lds, stats))."""
    C = q0.shape[0]
    Q0 = jax.vmap(lambda q: j_evaluate(j_model, q))(jnp.asarray(q0))
    stage = j_make_driver(j_model, JNUTS(max_depth=md), T, ring=ring,
                          noise=nz)
    out, done = jax.jit(lambda c: stage(
        jax.random.PRNGKey(0), j_metric, jnp.full((C,), eps), c,
        jnp.int32(10**9)))(j_init(Q0, j_metric, T, md, ring=ring))
    assert bool(done)
    return int(out["g"]), j_finish(out, T)


def port_epoch(model, metric, q0, eps, T, md, nz, ring=8, g_chunk=None):
    """The port's driver run to the end (in calls of ``g_chunk`` slots if
    given): (final g, (Q', qs, lds, stats))."""
    C = q0.shape[0]
    stage = make_epoch_sampling_driver(model, NUTS(max_depth=md), T,
                                       ring=ring, noise=nz)
    Q0 = evaluate(model, torch.as_tensor(q0, dtype=F64))
    carry = epoch_sampling_init(Q0, metric, T, md, ring=ring)
    done, stop = False, 0
    while not done:
        stop = None if g_chunk is None else stop + g_chunk
        carry, done = stage(None, metric, torch.full((C,), eps, dtype=F64),
                            carry, g_stop=stop)
    return carry["g"], epoch_sampling_finish(carry, T)


def assert_draws_equal(mine, theirs, label, tol=TOL):
    (Qm, qm, lm, sm), (Qt, qt, lt, st) = mine, theirs
    for name, a, b in (("positions", qm, qt), ("logdensities", lm, lt),
                       ("final q", Qm.q, Qt.q),
                       ("joint density", sm.logdensity, st.logdensity)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=f"{label}: {name}")
    np.testing.assert_allclose(np.asarray(sm.acceptance_rate),
                               np.asarray(st.acceptance_rate), rtol=tol,
                               err_msg=f"{label}: acceptance")
    for field in INT_FIELDS:
        b = np.asarray(getattr(st, field))
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        np.testing.assert_array_equal(np.asarray(getattr(sm, field)), b,
                                      err_msg=f"{label}: {field}")


CASES = [tuple(c) + (1, 8) for c in CASES_FAST] + [
    ("corr5", "dense", 1.0, 3, 8),  # three lanes
    ("std4", "diag", 1.1, 4, 2),  # the tightest ring
]
IDS = ["/".join(map(str, c)) for c in CASES]


def case_inputs(case):
    """(T, max_depth, the injected draws, the starts, JAX model, JAX
    metric) of one case."""
    model_key, metric_key, eps, C, _ring = case
    T, md = 64, 6
    _m, _met, K, j_model, j_metric = port_case(model_key, metric_key)
    nz = draw_epoch_noise(
        zlib.crc32(f"ep/{model_key}/{metric_key}/{eps}".encode()),
        T, md, K, j_metric, C=C)
    return T, md, nz, np.random.RandomState(5).randn(C, K), j_model, j_metric


@pytest.fixture(scope="module")
def jax_runs():
    """case -> JAX's (final g, draws), each run when a test first reads it
    (so once per module, and never in a process that runs no test)."""
    def run(case):
        T, md, nz, q0, j_model, j_metric = case_inputs(case)
        return jax_epoch(j_model, j_metric, q0, case[2], T, md, nz,
                         ring=case[4])

    return Lazy(run)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_epoch_matches_jax(jax_runs, case):
    g_theirs, theirs = jax_runs[case]
    T, md, nz, q0, _jm, _jmet = case_inputs(case)
    model_key, metric_key, eps, _C, ring = case
    model, metric, _K, _jm, _jmet = port_case(model_key, metric_key)
    g_mine, mine = port_epoch(model, metric, q0, eps, T, md,
                              port_noise(nz, EpochNoise), ring=ring)
    assert g_mine == g_theirs
    assert_draws_equal(mine, theirs, "/".join(map(str, case)))


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_epoch_matches_the_port_lockstep_driver(case):
    """C = 1: every draw equals the port's tree_batched driver's over the
    same transitions, each fed that transition's draws."""
    T, md, nz, q0, _jm, _jmet = case_inputs(case)
    model_key, metric_key, eps, _C, _ring = case
    model, metric, _K, _jm, _jmet = port_case(model_key, metric_key)
    tnz = port_noise(nz, EpochNoise)
    _g, (Qe, qs, lds, st) = port_epoch(model, metric, q0, eps, T, md, tnz)
    Q = evaluate(model, torch.as_tensor(q0, dtype=F64))
    for t in range(T):
        Q, stats = sample_tree_batched(
            None, NUTS(max_depth=md), model, metric, Q,
            torch.full((1,), eps, dtype=F64), directions=tnz.dirs[t],
            p=tnz.p[t], noise=TreeNoise(tnz.gumbel[t], tnz.expo[t]))
        np.testing.assert_allclose(qs[:, t].numpy(), Q.q.numpy(), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(lds[:, t].numpy(), Q.logdensity.numpy(),
                                   rtol=TOL, atol=TOL)
        for field in ("depth", "steps", "term_left", "term_right",
                      "directions"):
            assert torch.equal(getattr(st, field)[:, t],
                               getattr(stats, field)), (t, field)


def test_lane_isolation():
    """C = 3 with per-lane noise equals three C = 1 runs, per draw."""
    T, md, C, eps = 48, 6, 3, 1.0
    model, metric, K, _jm, j_metric = port_case("corr5", "dense")
    nz = port_noise(draw_epoch_noise(23, T, md, K, j_metric, C=C), EpochNoise)
    q0 = np.random.RandomState(6).randn(C, K)
    _g, (_Q, qs, _l, st) = port_epoch(model, metric, q0, eps, T, md, nz)
    for c in range(C):
        _g, (_Q, qs_c, _l, st_c) = port_epoch(model, metric, q0[c:c + 1],
                                              eps, T, md, lane_noise(nz, c))
        np.testing.assert_allclose(qs_c[0].numpy(), qs[c].numpy(), rtol=TOL,
                                   atol=TOL)
        for field in ("steps", "depth"):
            assert torch.equal(getattr(st_c, field)[0],
                               getattr(st, field)[c]), (c, field)


def test_ring_pressure_leaves_the_draws():
    """ring 2 (every lane at most 2 draws ahead of the slowest) gives the
    draws of ring 32 bit for bit: the ring only schedules."""
    T, md, C, eps = 32, 5, 4, 1.1
    model, metric, K, _jm, j_metric = port_case("std4", "diag")
    nz = port_noise(draw_epoch_noise(91, T, md, K, j_metric, C=C), EpochNoise)
    q0 = np.random.RandomState(3).randn(C, K)
    g2, (_Q, qs2, _l, st2) = port_epoch(model, metric, q0, eps, T, md, nz,
                                        ring=2)
    g32, (_Q, qs32, _l, st32) = port_epoch(model, metric, q0, eps, T, md, nz,
                                           ring=32)
    assert torch.equal(qs2, qs32)
    for field in ("steps", "term_left", "depth"):
        assert torch.equal(getattr(st2, field), getattr(st32, field))
    assert g2 >= g32


def test_chunked_calls_are_bitwise_one_call():
    """g_stop cuts the loop into calls of 24 slots (not a multiple of the
    epoch): the same draws, statistics and slot count, with the
    production random stream."""
    T, md = 24, 6
    model = std_normal(3, dtype=F64, device="cpu")
    from dynamichmc_tpu_torch.metric import identity_metric

    metric = identity_metric(3, dtype=F64)
    Q0 = evaluate(model, torch.as_tensor(
        np.random.RandomState(0).randn(6, 3)))
    eps = torch.full((6,), 0.9, dtype=F64)
    stage = make_epoch_sampling_driver(model, NUTS(max_depth=md), T, ring=4)
    runs = []
    for chunk in (None, 24):
        gen = torch.Generator().manual_seed(3)
        carry = epoch_sampling_init(Q0, metric, T, md, ring=4)
        done, stop = False, 0
        while not done:
            stop = None if chunk is None else stop + chunk
            carry, done = stage(gen, metric, eps, carry, g_stop=stop)
        runs.append((carry["g"], epoch_sampling_finish(carry, T)))
    (g_a, (_Qa, qa, la, sa)), (g_b, (_Qb, qb, lb, sb)) = runs
    assert g_a == g_b
    assert torch.equal(qa, qb) and torch.equal(la, lb)
    for field in INT_FIELDS + ("acceptance_rate",):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field


def test_ring_below_two_is_refused():
    with pytest.raises(ValueError, match="ring"):
        make_epoch_sampling_driver(std_normal(2, dtype=F64, device="cpu"),
                                   NUTS(), 8, ring=1)


# --- run_chains -------------------------------------------------------------


def test_run_chains_epoch_statistics():
    """JAX tests/test_epoch_integration.py's run: 32 chains x 150 draws of
    N(0, I_3) with the default call, the epoch sampler."""
    res = run_chains(torch.Generator().manual_seed(0),
                     std_normal(3, dtype=F64, device="cpu"), 32, 150,
                     dtype=F64, sampling_driver="epoch")
    qs = res.positions.numpy()
    assert qs.shape == (32, 150, 3) and np.isfinite(qs).all()
    assert abs(qs.mean()) < 0.1 and abs(qs.std() - 1.0) < 0.12
    st = res.tree_statistics
    for field in ("depth", "steps", "acceptance_rate", "logdensity",
                  "term_left", "term_right", "directions", "work"):
        assert tuple(getattr(st, field).shape) == (32, 150), field
    assert 0.5 < float(st.acceptance_rate.mean()) <= 1.0
    # work spans the lane's slots from restart to completion, waits too
    assert bool((st.work >= st.steps).all())


def test_run_chains_epoch_draw_sink():
    """The draws leave through one sink call; the statistics stay."""
    got = {}

    def sink(start, qs, lds, stats):
        got.update(start=start, qs=qs.clone(), lds=lds.clone())

    kw = dict(dtype=F64, sampling_driver="epoch", tune="reference")
    ld = std_normal(2, dtype=F64, device="cpu")
    res = run_chains(torch.Generator().manual_seed(1), ld, 8, 40,
                     draw_sink=sink, **kw)
    kept = run_chains(torch.Generator().manual_seed(1), ld, 8, 40, **kw)
    assert got["start"] == 0 and res.positions is None
    assert torch.equal(got["qs"], kept.positions)
    assert torch.equal(got["lds"], kept.logdensities)
    assert torch.equal(res.tree_statistics.steps, kept.tree_statistics.steps)


def test_run_chains_epoch_refuses_what_jax_refuses():
    ld = std_normal(2, dtype=F64, device="cpu")
    gen = torch.Generator()
    with pytest.raises(ValueError, match="sampling_driver"):
        run_chains(gen, ld, 4, 8, sampling_driver="nope")
    with pytest.raises(ValueError, match="stratify_sampling"):
        run_chains(gen, ld, 4, 8, sampling_driver="epoch",
                   stratify_sampling=2)
    with pytest.raises(NotImplementedError, match="sync sampling driver"):
        run_chains(gen, ld, 4, 8, sampling_driver="epoch", ess_target=10.0)
