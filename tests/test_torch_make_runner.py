"""mcmc.make_runner: the (warmup fold + sampling) runner of one chain or
a batch, bit for bit what mcmc_keep_warmup gives from the same generator
and initial state, with the JAX package's history layout."""

import pytest
import torch

from dynamichmc_tpu_torch import NUTS, mcmc_keep_warmup
from dynamichmc_tpu_torch.hamiltonian import evaluate
from dynamichmc_tpu_torch.mcmc import make_runner
from dynamichmc_tpu_torch.metric import identity_metric
from dynamichmc_tpu_torch.models import std_normal
from dynamichmc_tpu_torch.warmup import (
    WarmupState,
    default_warmup_stages,
    initialize_warmup_state,
    random_position,
)

F64 = torch.float64
STAGES = default_warmup_stages(init_steps=20, middle_steps=20,
                               doubling_stages=2, terminating_steps=20)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if hasattr(a, "__dataclass_fields__"):
        return type(a) is type(b) and all(
            _same(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)
    return a == b


@pytest.mark.parametrize("keep_states", [True, False])
def test_make_runner_is_mcmc_keep_warmup_bitwise(keep_states):
    ld = std_normal(3, dtype=F64, device="cpu")
    out = mcmc_keep_warmup(torch.Generator().manual_seed(5), ld, 40,
                           warmup_stages=STAGES, dtype=F64)
    gen = torch.Generator().manual_seed(5)
    state = initialize_warmup_state(gen, ld, dtype=F64)
    assert _same(state, out["initial_warmup_state"])
    run = make_runner(ld, NUTS(), STAGES, 40, collect_warmup_positions=True,
                      keep_warmup_states=keep_states)
    history, final, inference = run(gen, state)
    assert _same(inference, out["inference"])
    assert _same(final, out["final_warmup_state"])
    assert len(history) == len(STAGES)
    for (results, st), (_stage, want_results, want_st) in zip(
            history, out["warmup"]):
        assert _same(results, want_results)
        assert _same(st, want_st if keep_states else None)


def test_make_runner_on_a_batch():
    """A (C, K) state runs the batch drivers: the draws are (C, N, K) and
    the same from the same generator; without collected stats only the
    stepsize search's results are kept."""
    ld = std_normal(2, dtype=F64, device="cpu")
    stages = default_warmup_stages(init_steps=20, middle_steps=20,
                                   doubling_stages=1, terminating_steps=20,
                                   pooled=True)
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(1)
        q = random_position(gen, 4, 2, dtype=F64)
        state = WarmupState(Q=evaluate(ld, q),
                            metric=identity_metric(2, dtype=F64), eps=None)
        run = make_runner(ld, NUTS(max_depth=4), stages, 12,
                          collect_warmup_stats=False, chain_axis="chains")
        history, final, inference = run(gen, state)
        assert inference.positions.shape == (4, 12, 2)
        assert final.metric.m_inv.shape == (2,)
        assert "eps" in history[0][0]
        draws.append(inference.positions)
    assert torch.equal(draws[0], draws[1])
