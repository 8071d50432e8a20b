"""Exhaustive detailed-balance enumeration THROUGH the port's batch driver.

The proof-grade gate of DynamicHMC.jl test/test_trees.jl:171-262 and of
tests/test_db_batched.py, run against ``dynamichmc_tpu_torch``'s shared
merge and termination code (tests/torch_dummy_batched.py): enumerate all
2^depth direction masks as LANES of one batched call (which also exercises
the multi-lane masking), accumulate exact proposal probability vectors, and
verify P(z) P(z'|z) == P(z') P(z|z') for every reachable z'. Imports no
JAX.
"""

import math

import numpy as np
import pytest
import torch

from torch_dummy_batched import OFFSET, dummy_logdensity, dummy_sample_batched


def visited_log_probabilities(z0s, depth, turning, divergent):
    """P(z -> .) over all 2^depth direction masks, (Z, SPAN) log probs.

    All masks run as lanes of ONE batched transition per start point."""
    n_masks = 2**depth
    all_flags = torch.arange(n_masks, dtype=torch.int32)
    rows = []
    for z0 in z0s:
        z0v = torch.full((n_masks,), int(z0), dtype=torch.int32)
        logp, _ = dummy_sample_batched(z0v, all_flags, depth, turning=turning,
                                       divergent=divergent)
        rows.append(torch.logsumexp(logp, dim=0) + depth * math.log(0.5))
    return torch.stack(rows).numpy()


def check_detailed_balance(z0, depth, turning=(1, 0), divergent=(1, 0),
                           atol=1e-8):
    acc0 = visited_log_probabilities([z0], depth, turning, divergent)[0]
    lz0 = dummy_logdensity(z0)
    reachable = np.nonzero(np.isfinite(acc0))[0]
    assert reachable.size > 0
    # transition probabilities from z0 must sum to one
    np.testing.assert_allclose(np.exp(acc0[reachable]).sum(), 1.0, rtol=1e-10)
    z1s = reachable - OFFSET
    acc_all = visited_log_probabilities(z1s, depth, turning, divergent)
    for row, (idx, z1) in enumerate(zip(reachable, z1s)):
        lhs = acc0[idx] + lz0
        rhs = acc_all[row, z0 + OFFSET] + dummy_logdensity(z1)
        assert abs(lhs - rhs) < atol, (
            f"detailed balance violated through the port's batch logic: "
            f"z={z0} z'={z1} depth={depth}: {lhs} vs {rhs}"
        )


DEPTHS = [1, 2, 3, 4] + [pytest.param(5, marks=pytest.mark.slow)]


@pytest.mark.parametrize("depth", DEPTHS)
def test_torch_db_batched_plain(depth):
    check_detailed_balance(0, depth)


@pytest.mark.parametrize("depth", DEPTHS)
def test_torch_db_batched_turning(depth):
    check_detailed_balance(3, depth, turning=(1, 2))


@pytest.mark.parametrize("depth", DEPTHS)
def test_torch_db_batched_divergent(depth):
    check_detailed_balance(3, depth, divergent=(10, 11))


@pytest.mark.parametrize("depth", DEPTHS)
def test_torch_db_batched_both(depth):
    check_detailed_balance(3, depth, divergent=(10, 12), turning=(-3, -2))


def test_torch_batched_dummy_traversal_observables():
    """The shim's shared termination bookkeeping against the reference's
    hand-computed cases (test_trees.jl:126-142): all-forward depth 3 with
    turning at 5..7 stops as InvalidTree(6, 7) after 7 steps; divergence at
    5..7 stops as (5, 5) after 5 steps."""
    start = torch.zeros((1,), dtype=torch.int32)
    forward = torch.full((1,), 0b111111, dtype=torch.int32)
    logp, out = dummy_sample_batched(start, forward, 3, turning=(5, 7))
    assert int(out["term_left"][0]) == 6 and int(out["term_right"][0]) == 7
    assert int(out["steps"][0]) == 7
    assert int(out["depth"][0]) == 2

    logp, out = dummy_sample_batched(start, forward, 3, divergent=(5, 7))
    assert int(out["term_left"][0]) == 5 and int(out["term_right"][0]) == 5
    assert int(out["steps"][0]) == 5

    # full tree: probabilities normalize and depth reaches 3
    logp, out = dummy_sample_batched(
        start, torch.full((1,), 0b101, dtype=torch.int32), 3)
    np.testing.assert_allclose(np.exp(logp[0].numpy()).sum(), 1.0, rtol=1e-12)
    assert int(out["depth"][0]) == 3
    # biased progressive sampling can zero out earlier subtrees, so assert
    # support bounds: within the visited [-2, 5], the final subtree [2, 5]
    # present
    lp = logp[0].numpy()
    support = np.nonzero(np.isfinite(lp))[0] - OFFSET
    assert support.min() >= -2 and support.max() == 5
    assert set(range(2, 6)) <= set(support.tolist())
