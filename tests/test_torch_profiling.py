"""dynamichmc_tpu_torch.profiling against the JAX package's profiling.py:
``benchmark`` returns JAX's keys, ``transition_throughput`` counts the
leapfrog steps of its own last transition, ``trace`` writes a trace."""

import dataclasses
import glob
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import profiling as jprofiling
from dynamichmc_tpu_torch import profiling
from dynamichmc_tpu_torch.hamiltonian import evaluate
from dynamichmc_tpu_torch.logdensity import from_logdensity_fn
from dynamichmc_tpu_torch.metric import identity_metric
from dynamichmc_tpu_torch.models import std_normal
from dynamichmc_tpu_torch.nuts import NUTS
from dynamichmc_tpu_torch.tree_batched import sample_tree_batched


def _add_one(x):
    return x + 1


def test_benchmark_returns_the_jax_keys():
    want = jprofiling.benchmark(_add_one, jnp.ones(3), iters=3, warmup=2)
    got = profiling.benchmark(_add_one, torch.ones(3), iters=3, warmup=2)
    assert set(got) == set(want)
    assert got["name"] == want["name"] == "_add_one"
    np.testing.assert_array_equal(got["output"].numpy(),
                                  np.asarray(want["output"]))
    assert got["compile_seconds"] >= 0.0
    assert got["first_call_seconds"] > 0.0 and got["seconds_per_iteration"] > 0.0
    named = profiling.benchmark(lambda: (torch.zeros(2), {"a": torch.ones(1)}),
                                iters=1, warmup=0, name="pair")
    assert named["name"] == "pair"


def test_benchmark_counts_the_calls():
    calls = []
    profiling.benchmark(lambda: calls.append(1), iters=4, warmup=3)
    assert len(calls) == 1 + 2 + 4  # first, warmup - 1, iters


def test_transition_throughput_counts_its_transitions_steps():
    """grad_evals_per_second x seconds_per_iteration is the sum of steps
    of the last of its 2 + iters transitions, replayed from the same
    generator seed: q ~ 0.1 N(0, I), identity metric, NUTS()."""
    ld = std_normal(5, dtype=torch.float64, device="cpu")
    C, eps, iters = 16, 0.3, 2
    res = profiling.transition_throughput(
        ld, n_chains=C, eps=eps, iters=iters, dtype=torch.float64,
        generator=torch.Generator().manual_seed(3))
    assert set(res) == (set(jprofiling.benchmark(_add_one, jnp.ones(1)))
                        - {"output"}) | {"grad_evals_per_second"}
    assert res["name"] == "nuts_transition"
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((C, 5), generator=gen, dtype=torch.float64) * 0.1
    Q = evaluate(ld, q)
    metric = identity_metric(5, dtype=torch.float64)
    for _ in range(2 + iters):
        _Q, stats = sample_tree_batched(gen, NUTS(), ld, metric, Q, eps)
    steps = int(stats.steps.sum())
    assert steps >= C
    assert res["grad_evals_per_second"] * res["seconds_per_iteration"] == (
        pytest.approx(steps, rel=1e-12))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path / "tr")
    files = glob.glob(str(tmp_path / "tr" / "trace-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


def test_transition_throughput_runs_where_the_caller_says():
    """Without a generator a model that names no device is measured on
    "cuda" (raising where there is none), never silently on the CPU; a
    CPU generator measures on the CPU; a generator on another device than
    the model's tensors raises."""
    ld = from_logdensity_fn(3, lambda q: -0.5 * (q * q).sum(-1))
    res = profiling.transition_throughput(
        ld, n_chains=4, iters=1, generator=torch.Generator().manual_seed(0))
    assert res["grad_evals_per_second"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="'cuda' is not available"):
            profiling.transition_throughput(ld, n_chains=4, iters=1)
    elsewhere = dataclasses.replace(ld, device="meta")
    with pytest.raises(ValueError, match="lie on meta"):
        profiling.transition_throughput(
            elsewhere, n_chains=4, iters=1,
            generator=torch.Generator().manual_seed(0))
