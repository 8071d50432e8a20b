"""Warmup checkpoint and resume on the port, and ``checkpoint.save_state`` /
``load_state``.

- Port of JAX tests/test_resume.py, at float64 on the CPU with a 20/20/20
  schedule: a resume from every checkpoint (search, then each stage), each
  saved to disk and loaded, gives the uninterrupted run's positions, eps,
  M^-1 and tree depths bit for bit, with and without the warmup depth
  clamp and its tail.
- The validations: a chain-state shape, a step outside the schedule, a
  step off its stage boundaries, a custom turn statistic, and (in both
  packages) a stage tuple that the JAX engine cannot take whole.
- ``save_state`` / ``load_state`` round-trip each state type with its
  dtypes and the generator's state.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamichmc_tpu.models import std_normal as j_std_normal
from dynamichmc_tpu.parallel import run_chains as j_run_chains
from dynamichmc_tpu.stepsize import InitialStepsizeSearch as JSearch
from dynamichmc_tpu.warmup import TuningNUTS as JTuning
from dynamichmc_tpu_torch import (
    NUTS,
    DynamicHMCError,
    InitialStepsizeSearch,
    TuningNUTS,
    WarmupCheckpoint,
    WarmupState,
    run_chains,
)
from dynamichmc_tpu_torch.checkpoint import load_state, save_state
from dynamichmc_tpu_torch.hamiltonian import EvaluatedPoint, PhasePoint
from dynamichmc_tpu_torch.metric import dense_metric, diagonal_metric
from dynamichmc_tpu_torch.models import correlated_gaussian, std_normal
from dynamichmc_tpu_torch.nuts import TreeStatistics
from dynamichmc_tpu_torch.utils.welford import WelfordState
from dynamichmc_tpu_torch.warmup import default_warmup_stages
from torch_turn_statistics import GeneralizedReimpl

F64 = torch.float64
CLAMPS = {"no_clamp": {}, "clamp": {"warmup_depth_clamp": 2},
          "clamp_tail": {"warmup_depth_clamp": 2,
                         "warmup_depth_clamp_tail": 5}}


def _stages():
    return default_warmup_stages(metric_kind="dense", init_steps=20,
                                 middle_steps=20, doubling_stages=1,
                                 terminating_steps=20)


def _model():
    return correlated_gaussian(3, dtype=F64, device="cpu")


def _run(seed=7, n_chains=8, **kw):
    return run_chains(torch.Generator().manual_seed(seed), _model(),
                      n_chains=n_chains, n_samples=16,
                      warmup_stages=_stages(), dtype=F64, **kw)


_REFS = {}


def _reference(clamp):
    """The uninterrupted run and its checkpoints, once per clamp."""
    if clamp not in _REFS:
        ckpts = []
        res = _run(warmup_checkpoint_sink=ckpts.append, **CLAMPS[clamp])
        _REFS[clamp] = (res, ckpts)
    return _REFS[clamp]


@pytest.mark.parametrize("clamp", list(CLAMPS))
def test_checkpoints_fall_at_the_stage_boundaries(clamp):
    res, ckpts = _reference(clamp)
    assert [(c.step, c.stage) for c in ckpts] == [(0, 1), (20, 2), (40, 3),
                                                  (60, 4)]
    assert all(c.search is not None for c in ckpts)
    # the sink changes nothing
    plain = _run(**CLAMPS[clamp])
    assert torch.equal(plain.positions, res.positions)
    last = ckpts[-1]
    assert torch.equal(last.eps, res.eps)
    assert torch.equal(last.metric.m_inv, res.metric.m_inv)


@pytest.mark.parametrize("index", range(4))
@pytest.mark.parametrize("clamp", list(CLAMPS))
def test_warmup_resume_bitwise(clamp, index, tmp_path):
    ref, ckpts = _reference(clamp)
    # process death: the checkpoint round-trips through disk
    save_state(str(tmp_path / "ck"), ckpts[index])
    restored, generator_state = load_state(str(tmp_path / "ck"))
    assert generator_state is None
    assert isinstance(restored, WarmupCheckpoint)
    # a fresh generator of another seed: the checkpoint sets its state
    res = _run(seed=123, warmup_resume=restored, **CLAMPS[clamp])
    assert torch.equal(res.positions, ref.positions)
    assert torch.equal(res.eps, ref.eps)
    assert torch.equal(res.metric.m_inv, ref.metric.m_inv)
    assert torch.equal(res.tree_statistics.depth, ref.tree_statistics.depth)


def test_resume_applies_its_own_clamp():
    """A resume with another clamp than the checkpoint's run gives other
    draws: the clamp is applied per stage, not carried in the checkpoint."""
    ref, ckpts = _reference("clamp_tail")
    other = _run(warmup_resume=ckpts[1])
    assert not torch.equal(other.positions, ref.positions)


def test_warmup_resume_validations():
    _ref, ckpts = _reference("no_clamp")
    with pytest.raises(DynamicHMCError, match="shape"):
        _run(n_chains=16, warmup_resume=ckpts[0])
    with pytest.raises(DynamicHMCError, match="outside"):
        _run(warmup_resume=dataclasses.replace(ckpts[1], step=61))
    with pytest.raises(DynamicHMCError, match="not a stage boundary"):
        _run(warmup_resume=dataclasses.replace(ckpts[1], step=10))
    with pytest.raises(DynamicHMCError, match="not a stage boundary"):
        _run(warmup_resume=dataclasses.replace(ckpts[1], stage=3))
    custom = NUTS(turn_statistic_configuration=GeneralizedReimpl())
    for kw in ({"warmup_checkpoint_sink": lambda c: None},
               {"warmup_resume": ckpts[0]}):
        with pytest.raises(NotImplementedError, match="turn statistic"):
            _run(algorithm=custom, **kw)


MIXED = {"port": (InitialStepsizeSearch(), TuningNUTS(20, "diagonal"),
                  TuningNUTS(20, "dense")),
         "jax": (JSearch(), JTuning(20, "diagonal"), JTuning(20, "dense"))}


@pytest.mark.parametrize("kw", [
    {"draw_sink": lambda *a: None}, {"ess_target": 100.0},
    {"warmup_checkpoint_sink": lambda c: None}, {"warmup_resume": "ckpt"},
], ids=["draw_sink", "ess_target", "checkpoint_sink", "resume"])
def test_options_need_a_homogeneous_schedule_in_both_packages(kw):
    """As in the JAX package, where its engine needs the stage tuple whole:
    two metric kinds are refused with a NotImplementedError."""
    port_kw = dict(kw)
    if "warmup_resume" in kw:
        port_kw["warmup_resume"] = _reference("no_clamp")[1][0]
    with pytest.raises(NotImplementedError, match="TuningNUTS blocks"):
        run_chains(torch.Generator().manual_seed(0),
                   std_normal(2, dtype=F64, device="cpu"), 4, 8,
                   warmup_stages=MIXED["port"], dtype=F64, **port_kw)
    with pytest.raises(NotImplementedError, match="TuningNUTS blocks"):
        j_run_chains(jax.random.PRNGKey(0), j_std_normal(2), 4, 8,
                     warmup_stages=MIXED["jax"], tune="reference", **kw)


def _states():
    """Every state type, float64 and float32, with int32 fields."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=F64):
        return torch.randn(shape, generator=g, dtype=F64).to(dtype)

    Q = EvaluatedPoint(q=r(4, 3), logdensity=r(4), grad=r(4, 3))
    diag = diagonal_metric(r(3).exp())
    dense = dense_metric(torch.eye(3, dtype=torch.float32) * 2)
    ints = torch.arange(4, dtype=torch.int32)
    stats = TreeStatistics(logdensity=r(4, 5, dtype=torch.float32),
                           depth=ints, term_left=ints, term_right=ints,
                           acceptance_rate=r(4), steps=ints,
                           directions=ints, work=None)
    ckpt = WarmupCheckpoint(
        step=20, stage=2, Q=Q, metric=diag.__class__(
            m_inv=diag.m_inv.expand(4, 3), w_diag=diag.w_diag.expand(4, 3)),
        eps=r(4), search={"eps": r(4), "success": ints > 1, "l0": r(4)},
        generator_state=torch.Generator().manual_seed(5).get_state())
    return {
        "warmup_state": WarmupState(Q=Q, metric=dense, eps=None),
        "checkpoint": ckpt,
        "evaluated_point": Q,
        "phase_point": PhasePoint(Q=Q, p=r(4, 3, dtype=torch.float32)),
        "diagonal": diag,
        "dense": dense,
        "tree_statistics": stats,
        "welford": WelfordState(count=torch.tensor(7.0, dtype=F64), mean=r(3),
                                m2=r(3, 3)),
        "nested": {"a": [Q, (diag, 3, "x", None)], "b": (1.5, True)},
    }


def _assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("name", list(_states()))
def test_save_load_round_trips_each_state(name, tmp_path):
    state = _states()[name]
    gen = torch.Generator().manual_seed(42)
    torch.rand(3, generator=gen)  # a state past the seed's
    save_state(str(tmp_path / name), state, generator=gen)
    loaded, generator_state = load_state(str(tmp_path / name))
    _assert_same(state, loaded)
    again = torch.Generator()
    again.set_state(generator_state)
    assert torch.equal(torch.rand(5, generator=again),
                       torch.rand(5, generator=gen))
    loaded_cpu, _ = load_state(str(tmp_path / name), device="cpu")
    _assert_same(state, loaded_cpu)


def test_checkpoint_file_loads_weights_only(tmp_path):
    """The file is plain tensors and containers: ``weights_only=True``
    reads it (no pickled class is needed)."""
    save_state(str(tmp_path / "c"), _states()["checkpoint"])
    payload = torch.load(str(tmp_path / "c" / "state.pt"), weights_only=True)
    assert set(payload) == {"state", "generator_state"}


def test_save_state_refuses_what_it_cannot_load(tmp_path):
    with pytest.raises(TypeError, match="cannot save"):
        save_state(str(tmp_path / "x"), {"f": np.zeros(3)})
