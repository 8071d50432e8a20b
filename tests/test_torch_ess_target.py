"""Sample until converged (``run_chains(..., ess_target=...)``) on the port,
against the JAX package.

- Ports of JAX tests/test_ess_target.py: the run stops at the first checked
  chunk boundary whose min bulk ESS meets the target; its draws are a
  fixed run's prefix bit for bit; an unreachable target runs to the cap;
  the geometric schedule never stops earlier than the every-chunk one; a
  draw sink is refused; so are a target <= 0 and a factor < 1.
- Schedule parity: with an unreachable target, the draw counts of the
  ``sampling:`` and ``ess check @`` log lines equal the JAX package's for the
  same (n_samples, sample_chunk, ess_check_start, ess_check_factor).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu.models import std_normal as j_std_normal
from dynamichmc_tpu.parallel import run_chains as j_run_chains
from dynamichmc_tpu.warmup import default_warmup_stages as j_stages
from dynamichmc_tpu_torch import DynamicHMCError, stats
from dynamichmc_tpu_torch.models import std_normal
from dynamichmc_tpu_torch.parallel import run_chains
from dynamichmc_tpu_torch.warmup import default_warmup_stages

DIM = 4
CHAINS = 32
CHUNK = 32
CAP = 256
TARGET = 4000.0


def _stages(stages=default_warmup_stages):
    # search + 20 eps-only + 2 metric blocks + 20 eps-only = 100 warmup steps
    return stages(init_steps=20, middle_steps=20, doubling_stages=2,
                  terminating_steps=20)


def _run(ess_target=None, n_samples=CAP, sample_chunk=CHUNK, n_chains=CHAINS,
         **kw):
    return run_chains(
        torch.Generator().manual_seed(7),
        std_normal(DIM, dtype=torch.float32, device="cpu"),
        n_chains=n_chains, n_samples=n_samples, warmup_stages=_stages(),
        sample_chunk=sample_chunk, ess_target=ess_target, **kw)


_FIXED = {}


def _fixed():
    if "res" not in _FIXED:
        _FIXED["res"] = _run()
    return _FIXED["res"]


def _min_bulk_ess(positions):
    r = stats.ess_rhat(positions.numpy().astype(np.float64))
    return float(np.min(r["ess_bulk"]))


def test_stops_within_one_chunk_of_target():
    """With every chunk boundary checked (factor 1), the run stops at the
    first checked boundary whose min bulk ESS meets the target."""
    res = _run(ess_target=TARGET, ess_check_factor=1.0)
    n_drawn = res.positions.shape[1]
    assert n_drawn < CAP, "a well-conditioned target converges before the cap"
    assert n_drawn % CHUNK == 0 and n_drawn >= 64  # first check at 64
    # the device check and the host oracle agree to ~1e-6; keep JAX's slack
    assert _min_bulk_ess(res.positions) >= 0.99 * TARGET
    if n_drawn > 64:
        assert _min_bulk_ess(res.positions[:, :n_drawn - CHUNK]) < 1.01 * TARGET
    assert tuple(res.tree_statistics.depth.shape) == (CHAINS, n_drawn)
    assert tuple(res.logdensities.shape) == (CHAINS, n_drawn)


def test_early_stop_draws_match_fixed_run():
    res = _run(ess_target=TARGET, ess_check_factor=1.0)
    n_drawn = res.positions.shape[1]
    fixed = _fixed()
    assert torch.equal(res.positions, fixed.positions[:, :n_drawn])
    assert torch.equal(res.logdensities, fixed.logdensities[:, :n_drawn])
    assert torch.equal(res.tree_statistics.depth,
                       fixed.tree_statistics.depth[:, :n_drawn])


def test_unreachable_target_runs_to_cap():
    res = _run(ess_target=1e12, n_samples=4 * CHUNK, ess_check_factor=1.0)
    assert res.positions.shape[1] == 4 * CHUNK
    assert torch.equal(res.positions, _fixed().positions[:, :4 * CHUNK])


def test_geometric_check_schedule():
    every = _run(ess_target=TARGET, ess_check_factor=1.0)
    geo = _run(ess_target=TARGET, ess_check_factor=2.0)
    assert geo.positions.shape[1] >= every.positions.shape[1]
    assert _min_bulk_ess(geo.positions) >= 0.99 * TARGET


def test_ess_target_rejects_draw_sink():
    with pytest.raises(DynamicHMCError, match="draw_sink"):
        _run(ess_target=100.0, draw_sink=lambda *a: None)


@pytest.mark.parametrize("kw,match", [
    ({"ess_target": 0.0}, "ess_target must be > 0"),
    ({"ess_target": -5.0}, "ess_target must be > 0"),
    ({"ess_target": 100.0, "ess_check_factor": 0.5},
     "ess_check_factor must be >= 1.0"),
])
def test_ess_target_value_checks(kw, match):
    with pytest.raises(DynamicHMCError, match=match):
        _run(**kw)


def _counts(lines, pattern):
    return [int(m.group(1)) for m in map(re.compile(pattern).match, lines)
            if m]


def _schedule(lines):
    return (_counts(lines, r"sampling: (\d+)/"),
            _counts(lines, r"ess check @ (\d+) draws"))


# (n_samples, sample_chunk, ess_check_start, ess_check_factor); the
# schedule does not depend on the chain count, so these run 8 chains
SCHEDULE_CHAINS = 8
SCHEDULES = [
    (112, 16, 0, 1.0),    # every chunk from max(chunk, 64): 64, 80, 96
    (160, 16, 0, 2.0),    # geometric: 64, 128
    (160, 16, 40, 2.0),   # a start between two boundaries: 48, 96
    (112, 16, 40, 1.0),   # 48, 64, 80, 96
    (150, 24, 0, 1.5),    # a last chunk shorter than the others: 72, 120
    (600, None, 0, 2.0),  # the default chunk (512): one check, at 512
    (40, None, 0, 1.0),   # the default chunk past n_samples: no check
]


@pytest.mark.parametrize("n,chunk,start,factor", SCHEDULES)
def test_check_schedule_matches_jax(n, chunk, start, factor):
    kw = dict(ess_target=1e12, ess_check_start=start,
              ess_check_factor=factor)
    port_lines = []
    _run(n_samples=n, sample_chunk=chunk, n_chains=SCHEDULE_CHAINS,
         log=port_lines.append, **kw)
    jax_lines = []
    j_run_chains(jax.random.PRNGKey(7), j_std_normal(DIM, dtype=jnp.float32),
                 SCHEDULE_CHAINS, n, warmup_stages=_stages(j_stages),
                 tune="reference", sample_chunk=chunk, log=jax_lines.append,
                 **kw)
    port, jax_ = _schedule(port_lines), _schedule(jax_lines)
    assert port == jax_
    assert port[0][-1] == n  # an unreachable target runs to the cap
