"""``tune="auto"`` on the port: ``autotune.py`` and ``run_chains``' auto
block, against the JAX package.

- ``auto_choices`` equals JAX's over a grid of chain counts, dimensions,
  depth limits and metric kinds, field by field and in ``describe()``.
- ``run_chains(generator, ld, n_chains, n_samples)`` logs JAX's
  ``autotune:`` line, character for character, over a grid of chain
  counts and dimensions, with and without an ``algorithm``, and resolves
  to JAX's warmup stages. The line is logged before any chain starts, so
  the runs compared here stop at it.
- Every case of JAX tests/test_autotune.py ported at its sizes; its two
  statistical gates under ``slow``.
- The auto configuration gives the draws of the same configuration
  spelled out by hand, bit for bit; ``tune="reference"`` gives the draws
  of the reference defaults spelled out by hand.
- ``run_chains`` takes the JAX package's keywords; the schedulers that
  are not ported raise ``NotImplementedError`` naming their ROADMAP item,
  on one device and over a mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import autotune as jautotune
from dynamichmc_tpu.models import std_normal as j_std_normal
from dynamichmc_tpu.nuts import NUTS as JNUTS
from dynamichmc_tpu.parallel import run_chains as j_run_chains
from dynamichmc_tpu.warmup import default_warmup_stages as j_default_stages
from dynamichmc_tpu_torch import NUTS, autotune, run_chains
from dynamichmc_tpu_torch.autotune import auto_choices
from dynamichmc_tpu_torch.models import correlated_gaussian, funnel, std_normal
from dynamichmc_tpu_torch.parallel import ChainMesh
from dynamichmc_tpu_torch.parallel.chains import _auto_tune
from dynamichmc_tpu_torch.warmup import TuningNUTS, default_warmup_stages

F32, F64 = torch.float32, torch.float64
CONSTANTS = ("POOLED_METRIC_MIN_CHAINS", "DENSE_DIM_MAX", "MAX_DEPTH_CAP",
             "MAX_DEPTH_CAP_MIN_CHAINS", "WARMUP_DEPTH_CLAMP",
             "WARMUP_DEPTH_CLAMP_MIN_CHAINS", "WARMUP_DEPTH_CLAMP_TAIL",
             "CAP_SATURATION_WARN")
GRID_CHAINS = (1, 127, 128, 255, 256, 8192)
GRID_DIMS = (2, 256, 257)


def test_constants_are_the_jax_packages():
    for name in CONSTANTS:
        assert getattr(autotune, name) == getattr(jautotune, name), name


@pytest.mark.parametrize("metric_kind", [None, "diagonal", "dense"])
@pytest.mark.parametrize("max_depth_limit", [3, 10])
@pytest.mark.parametrize("dim", GRID_DIMS)
def test_auto_choices_equal_the_jax_packages(dim, max_depth_limit,
                                             metric_kind):
    for n_chains in GRID_CHAINS:
        mine = auto_choices(n_chains, dim, max_depth_limit, metric_kind)
        ref = jautotune.auto_choices(n_chains, dim, max_depth_limit,
                                     metric_kind)
        assert vars(mine) == vars(ref), (n_chains, dim)
        assert mine.describe() == ref.describe()


class _Stop(Exception):
    pass


def _first_line(run):
    """The first line ``run(log)`` logs; the run stops there (the auto
    block logs before any chain starts)."""
    lines = []

    def log(msg):
        lines.append(msg)
        raise _Stop

    with pytest.raises(_Stop):
        run(log)
    return lines[0]


def _lines(n_chains, dim, port_kw=None, jax_kw=None):
    mine = _first_line(lambda log: run_chains(
        torch.Generator().manual_seed(0), std_normal(dim, dtype=F32,
                                                     device="cpu"),
        n_chains, 8, log=log, **(port_kw or {})))
    ref = _first_line(lambda log: j_run_chains(
        jax.random.PRNGKey(0), j_std_normal(dim, dtype=jnp.float32),
        n_chains, 8, log=log, **(jax_kw or {})))
    return mine, ref


@pytest.mark.parametrize("depth", [None, 3])
@pytest.mark.parametrize("dim", GRID_DIMS)
@pytest.mark.parametrize("n_chains", GRID_CHAINS)
def test_default_call_logs_the_jax_line(n_chains, dim, depth):
    """The plain call (or the call with ``algorithm=NUTS(max_depth=3)``)
    logs JAX's line, and resolves to JAX's stages, max_depth and clamp."""
    port_kw = {} if depth is None else {"algorithm": NUTS(max_depth=depth)}
    jax_kw = {} if depth is None else {"algorithm": JNUTS(max_depth=depth)}
    mine, ref = _lines(n_chains, dim, port_kw, jax_kw)
    assert mine.startswith("autotune: ") and mine == ref
    algorithm, stages, clamp, tail, cap = _auto_tune(
        n_chains, dim, port_kw.get("algorithm"), None, None, 0, False, None)
    choices = jautotune.auto_choices(n_chains, dim,
                                     10 if depth is None else depth)
    want = j_default_stages(metric_kind=choices.metric_kind,
                            pooled=choices.pooled_metric)
    assert [(type(s).__name__, getattr(s, "N", None),
             getattr(s, "metric_kind", None), getattr(s, "pooled", None))
            for s in stages] == [
        (type(s).__name__, getattr(s, "N", None),
         getattr(s, "metric_kind", None), getattr(s, "pooled", None))
        for s in want]
    assert algorithm.max_depth == (
        choices.max_depth if depth is None and choices.max_depth else
        depth or 10)
    assert cap == (choices.max_depth if depth is None else None)
    assert clamp == choices.warmup_depth_clamp
    assert tail == (min(25, want[-1].N // 2) if clamp else 0)


DIM = 6
STAGES_KW = dict(init_steps=20, middle_steps=20, doubling_stages=2,
                 terminating_steps=20)


@pytest.mark.parametrize("case", ["fleet", "small fleet", "explicit stages"])
def test_autotune_line_equals_the_jax_packages(case):
    """The three small calls of JAX tests/test_autotune.py: 256 chains with
    the defaults, 32 chains, explicit stages."""
    if case == "explicit stages":
        mine, ref = _lines(
            256, DIM,
            {"warmup_stages": default_warmup_stages(metric_kind="diagonal",
                                                    **STAGES_KW)},
            {"warmup_stages": j_default_stages(metric_kind="diagonal",
                                               **STAGES_KW)})
        assert mine == ref == "autotune: warmup clamp 2/10"
    else:
        mine, ref = _lines(256 if case == "fleet" else 32, DIM)
        assert mine == ref


# --- JAX tests/test_autotune.py, decision table pins ------------------------


def test_headline_fleet_choices():
    c = auto_choices(4096, 100)
    assert c.metric_kind == "dense"
    assert c.pooled_metric
    assert not c.pooled_stepsize
    assert c.warmup_depth_clamp == 2
    assert c.warmup_depth_clamp_tail == 25
    assert c.max_depth == 4


def test_per_chain_eps_at_every_fleet_size():
    assert not auto_choices(4096, 100).pooled_stepsize
    assert not auto_choices(8192, 100).pooled_stepsize
    assert not auto_choices(16384, 100).pooled_stepsize


def test_small_fleet_keeps_reference_semantics():
    c = auto_choices(64, 100)
    assert c.metric_kind == "diagonal"
    assert not c.pooled_metric
    assert not c.pooled_stepsize
    assert c.warmup_depth_clamp is None
    assert c.max_depth is None


def test_high_dim_goes_diagonal():
    c = auto_choices(4096, 1000)
    assert c.metric_kind == "diagonal"
    assert c.pooled_metric


def test_user_max_depth_limits_cap_and_clamp():
    c = auto_choices(4096, 100, max_depth_limit=3)
    assert c.max_depth == 3
    assert c.warmup_depth_clamp == 2
    c2 = auto_choices(4096, 100, max_depth_limit=1)
    assert c2.max_depth == 1
    assert c2.warmup_depth_clamp == 1


def test_caller_metric_kind_pins_structure():
    c = auto_choices(4096, 100, metric_kind="diagonal")
    assert c.metric_kind == "diagonal"
    assert c.pooled_metric


# --- JAX tests/test_autotune.py, run_chains at its sizes --------------------


def _run(n_chains=256, n_samples=64, **kw):
    logs = []
    res = run_chains(torch.Generator().manual_seed(11),
                     std_normal(DIM, dtype=F32, device="cpu"),
                     n_chains=n_chains, n_samples=n_samples,
                     log=logs.append, **kw)
    return res, logs


_FLEET = {}


def _fleet():
    """The plain call at 256 chains (run once for the tests that read it)."""
    if "run" not in _FLEET:
        _FLEET["run"] = _run(n_chains=256)
    return _FLEET["run"]


def _auto_line(logs):
    lines = [line for line in logs if line.startswith("autotune:")]
    assert len(lines) <= 1
    return lines[0] if lines else ""


def test_auto_applies_and_logs_at_fleet_scale():
    res, logs = _fleet()
    line = _auto_line(logs)
    assert "max_depth=4" in line
    assert "pooled dense metric" in line
    assert "per-chain eps" in line
    assert "warmup clamp 2/25" in line
    assert int(res.tree_statistics.depth.max()) <= 4
    assert tuple(res.metric.m_inv.shape) == (DIM, DIM)  # one shared metric
    assert tuple(res.eps.shape) == (256,)


def test_reference_mode_keeps_reference_defaults():
    res, logs = _run(n_chains=256, tune="reference", n_samples=16)
    assert _auto_line(logs) == ""
    assert tuple(res.metric.m_inv.shape) == (256, DIM)


def test_explicit_algorithm_wins():
    _res, logs = _run(n_chains=256, algorithm=NUTS(), n_samples=16)
    assert "max_depth" not in _auto_line(logs)


def test_explicit_no_clamp():
    _res, logs = _run(n_chains=256, warmup_depth_clamp=0, n_samples=16)
    assert "clamp" not in _auto_line(logs)
    assert "max_depth=4" in _auto_line(logs)


def test_small_fleet_logs_only_structural_choices():
    _res, logs = _run(n_chains=32, n_samples=16)
    line = _auto_line(logs)
    assert "max_depth" not in line
    assert "clamp" not in line


def test_explicit_stages_respected():
    stages = default_warmup_stages(metric_kind="diagonal", **STAGES_KW)
    res, logs = _run(n_chains=256, warmup_stages=stages, n_samples=16)
    assert tuple(res.metric.m_inv.shape) == (256, DIM)
    assert "clamp" in _auto_line(logs)
    assert "max_depth" not in _auto_line(logs)


def test_tune_validates():
    with pytest.raises(ValueError, match="tune"):
        _run(tune="fastest")


# --- the auto configuration is the hand-written one -------------------------


def test_auto_gives_the_explicit_configurations_draws():
    """At 256 chains the plain call and the benchmark's configuration spelled
    out (pooled dense stages, per-chain eps, md 4, clamp 2/25) give the same
    draws, eps and metric bit for bit; so do ``tune="reference"`` and the
    reference defaults spelled out (per-chain diagonal stages, NUTS())."""
    stages = default_warmup_stages(**STAGES_KW)
    pairs = [
        (_fleet()[0],
         _run(tune="reference", warmup_stages=default_warmup_stages(
             metric_kind="dense", pooled=True), algorithm=NUTS(max_depth=4),
             warmup_depth_clamp=2, warmup_depth_clamp_tail=25)[0]),
        (_run(32, 8, tune="reference", warmup_stages=stages)[0],
         _run(32, 8, tune="reference", warmup_stages=stages,
              algorithm=NUTS())[0]),
    ]
    for a, b in pairs:
        assert torch.equal(a.positions, b.positions)
        assert torch.equal(a.eps, b.eps)
        assert torch.equal(a.metric.m_inv, b.metric.m_inv)


# --- JAX tests/test_autotune.py, the statistical gates ----------------------


@pytest.mark.slow
def test_auto_config_moment_recovery():
    """The fleet-scale auto configuration (pooled dense + clamp 2/25 +
    max_depth 4) recovers the moments of a correlated Gaussian."""
    model = correlated_gaussian(DIM, dtype=F64, device="cpu")
    logs = []
    res = run_chains(torch.Generator().manual_seed(5), model, n_chains=256,
                     n_samples=256, dtype=F64, log=logs.append)
    assert "max_depth=4" in _auto_line(logs)
    q = res.positions.reshape(-1, DIM).numpy()
    cov = model.cov_fn().numpy()
    sd = np.sqrt(np.diag(cov))
    assert np.abs(q.mean(0) / sd).max() < 0.05
    assert np.abs(q.std(0) / sd - 1).max() < 0.05
    assert float(res.tree_statistics.acceptance_rate.mean()) > 0.7
    assert float(res.tree_statistics.is_divergent.double().mean()) < 0.001


@pytest.mark.slow
def test_cap_saturation_warning_fires():
    """Neal's funnel builds deep trees that no Euclidean metric removes: the
    auto cap saturates under auto's own pooled stages, and the warning
    says so."""
    model = funnel(8, dtype=F64, device="cpu")
    logs = []
    res = run_chains(torch.Generator().manual_seed(6), model, n_chains=256,
                     n_samples=64, dtype=F64, log=logs.append)
    assert "max_depth=4" in _auto_line(logs)
    depth = res.tree_statistics.depth.numpy()
    assert (depth >= 4).mean() > autotune.CAP_SATURATION_WARN
    assert any("autotune WARNING" in line for line in logs)


def test_warning_reads_the_draws_of_a_sink():
    """The saturation check reads the tree statistics, which a draw sink
    leaves with the result: a cap of 1 saturates every draw, sunk or not,
    and the line is the JAX package's."""
    from dynamichmc_tpu_torch.parallel.chains import _warn_auto_cap

    model = std_normal(2, dtype=F64, device="cpu")
    stages = (None, TuningNUTS(N=20))
    chunks, logs = [], []
    res = run_chains(torch.Generator().manual_seed(0), model, 4, 8,
                     initialization={"eps": 0.5}, warmup_stages=stages,
                     algorithm=NUTS(max_depth=1), dtype=F64,
                     tune="reference", draw_sink=lambda *a: chunks.append(a))
    assert res.positions is None and chunks
    _warn_auto_cap(res.tree_statistics, 1, logs.append)
    assert logs == [
        "autotune WARNING: 100% of draws hit the auto-applied max_depth=1 "
        "cap — this target builds genuinely deep trajectories, and the cap "
        "is costing mixing. Pass algorithm=NUTS() (reference max_depth 10) "
        "or tune='reference' and compare ESS."]
    logs.clear()
    _warn_auto_cap(res.tree_statistics, 2, logs.append)
    assert logs == []


# --- run_chains' signature --------------------------------------------------


def test_signature_is_the_jax_packages():
    """The same keywords in the same order with the same defaults, but for
    the first argument (a generator for a key) and the dtype."""
    import inspect

    mine = inspect.signature(run_chains).parameters
    ref = inspect.signature(j_run_chains).parameters
    assert list(mine)[1:] == list(ref)[1:]
    for name in list(ref)[1:]:
        if name != "dtype":
            assert mine[name].default == ref[name].default, name


SCHEDULER_CALLS = [
    {"mesh": ChainMesh(None, 0, 1, torch.device("cpu")),
     "warmup_driver": "wavefront"},
    {"warmup_driver": "wavefront"},
    {"sampling_driver": "epoch"},
    {"stratify_sampling": 4},
    {"epoch_ring": 4},
]


@pytest.mark.parametrize("kw", SCHEDULER_CALLS, ids=[
    "mesh_wavefront", "wavefront", "epoch", "stratify", "epoch_ring"])
def test_schedulers_do_what_jax_does(kw):
    """The scheduling keywords in the plain call: the port runs where JAX
    run_chains runs (finite draws of the call's shape) and raises the same
    exception type where it raises (a one-device JAX mesh for the port's
    one-rank ChainMesh)."""
    from dynamichmc_tpu.parallel import chain_mesh as j_chain_mesh

    def outcome(call):
        try:
            return call(), None
        except Exception as err:  # noqa: BLE001 - the type is the outcome
            return None, type(err)

    j_kw = dict(kw, mesh=j_chain_mesh(1)) if "mesh" in kw else kw
    theirs, their_error = outcome(lambda: j_run_chains(
        jax.random.PRNGKey(0), j_std_normal(DIM), 4, 4, **j_kw))
    mine, my_error = outcome(lambda: _run(n_chains=4, n_samples=4, **kw))
    assert my_error is their_error
    if my_error is None:
        assert tuple(mine[0].positions.shape) == np.asarray(
            theirs.positions).shape == (4, 4, DIM)
        assert bool(torch.isfinite(mine[0].positions).all())


@pytest.mark.parametrize("kw", [{"warmup_driver": "async"},
                                {"sampling_driver": "wavefront"}])
def test_unknown_schedulers_are_value_errors(kw):
    with pytest.raises(ValueError, match=list(kw)[0]):
        _run(n_chains=4, n_samples=4, **kw)
    with pytest.raises(ValueError, match=list(kw)[0]):
        j_run_chains(jax.random.PRNGKey(0), j_std_normal(2), 4, 4,
                     tune="reference", **kw)


def test_the_defaults_run():
    res, _logs = _run(n_chains=4, n_samples=4, mesh=None, warmup_driver="sync",
                      sampling_driver="sync", stratify_sampling=0,
                      epoch_ring=8,
                      warmup_stages=default_warmup_stages(**STAGES_KW))
    assert tuple(res.positions.shape) == (4, 4, DIM)
