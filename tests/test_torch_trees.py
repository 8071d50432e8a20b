"""The port's generic tree driver (``tree.sample_trajectory``) on the dummy
integer trajectory, against the JAX package's.

- Parity: for every direction mask at depths 1-3 and the four dummy
  configurations (plain, turning (1, 2), divergent (10, 11), both), the
  port gives the JAX driver's proposal vector ``logp`` to 1e-12 at float64,
  and the same lo/hi, visited statistics (acceptance sum to 1e-12, steps
  exactly), termination pair and depth. The dummy's proposal combine is
  deterministic, so this is an exact parity.
- The reference's traversal observables (test_trees.jl:126-165).
- The exhaustive detailed-balance enumeration (test_trees.jl:171-262)
  through the port's driver: depths 1-3 here, 4-6 under ``slow`` as
  tests/test_trees.py marks them.
- The termination encoding.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dummy_trajectory as jdummy
from dynamichmc_tpu.tree import sample_trajectory as j_sample_trajectory
from dynamichmc_tpu_torch.tree import (
    TERM_MAX_DEPTH,
    is_divergent_termination,
    is_turning_termination,
    next_direction,
    normalize_termination,
    reached_max_depth,
    sample_trajectory,
)
from torch_dummy_trajectory import OFFSET, dummy_logdensity, make_dummy_ops

CONFIGS = {  # name -> (turning, divergent, start), as tests/test_trees.py
    "plain": ((1, 0), (1, 0), 0),
    "turning": ((1, 2), (1, 0), 3),
    "divergent": ((1, 0), (10, 11), 3),
    "both": ((-3, -2), (10, 12), 3),
}


@functools.lru_cache(maxsize=None)
def _jax_batch(name, depth):
    """The JAX driver over every direction mask at once: (lo, hi, logp,
    acceptance sum, steps, term_left, term_right, depth) per mask."""
    turning, divergent, _z0 = CONFIGS[name]
    ops = jdummy.make_dummy_ops(turning=turning, divergent=divergent)

    def one(z0, flags):
        r = j_sample_trajectory(ops, jax.random.PRNGKey(0), z0, depth, flags)
        lo, hi, logp = r.zeta
        acc, steps = r.v
        return lo, hi, logp, acc, steps, r.term_left, r.term_right, r.depth

    return jax.jit(jax.vmap(one, in_axes=(None, 0)))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_generic_driver_matches_jax_on_every_mask(name, depth):
    turning, divergent, z0 = CONFIGS[name]
    ops = make_dummy_ops(turning=turning, divergent=divergent)
    masks = np.arange(2**depth, dtype=np.uint32)
    j = [np.asarray(x) for x in _jax_batch(name, depth)(jnp.int32(z0), masks)]
    for m, flags in enumerate(masks):
        r = sample_trajectory(ops, z0, depth, int(flags))
        lo, hi, logp = r.zeta
        acc, steps = r.v
        # the JAX dummy's narrower window (its OFFSET) of the port's vector
        window = slice(OFFSET - jdummy.OFFSET, OFFSET + jdummy.OFFSET + 1)
        assert torch.isinf(logp[:window.start]).all()
        assert torch.isinf(logp[window.stop:]).all()
        logp = logp[window].numpy()
        assert (lo, hi) == (int(j[0][m]), int(j[1][m])), (name, depth, m)
        finite = np.isfinite(logp)
        np.testing.assert_array_equal(finite, np.isfinite(j[2][m]))
        np.testing.assert_allclose(logp[finite], j[2][m][finite], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(float(acc), float(j[3][m]), rtol=0,
                                   atol=1e-12)
        assert steps == int(j[4][m])
        assert (r.term_left, r.term_right, r.depth) == (
            int(j[5][m]), int(j[6][m]), int(j[7][m])), (name, depth, m)


# --- the reference's traversal observables (test_trees.jl:126-165) ----------


def test_dummy_full_tree():
    # directions 0b101 at depth 3 visit [1, -1, -2, 2, 3, 4, 5]
    r = sample_trajectory(make_dummy_ops(), 0, 3, 0b101)
    lo, hi, logp = r.zeta
    assert (lo, hi) == (-2, 5)
    np.testing.assert_allclose(float(torch.exp(logp).sum()), 1.0, rtol=1e-12)
    assert r.term_left == 1 and r.term_right == 0 and r.depth == 3
    acc, steps = r.v
    assert steps == 7  # the initial node does not count
    expected = sum(min(math.exp(dummy_logdensity(z)), 1)
                   for z in [1, -1, -2, 2, 3, 4, 5])
    np.testing.assert_allclose(float(acc), expected, rtol=1e-12)


def test_dummy_turning():
    # turning at 5:7, all forward: the depth-2 adjacent tree's merge (6, 7)
    r = sample_trajectory(make_dummy_ops(turning=(5, 7)), 0, 3, 0b111111)
    assert (r.term_left, r.term_right) == (6, 7)
    assert is_turning_termination(torch.tensor(6), torch.tensor(7))
    assert r.depth == 2 and r.v[1] == 7


def test_dummy_divergent():
    r = sample_trajectory(make_dummy_ops(divergent=(5, 7)), 0, 3, 0b111111)
    assert r.term_left == r.term_right == 5
    assert r.v[1] == 5  # visited 1..5, stopped at the divergence
    expected = sum(min(math.exp(dummy_logdensity(z)), 1) for z in range(1, 6))
    np.testing.assert_allclose(float(r.v[0]), expected, rtol=1e-12)


def test_dummy_backward_tree():
    r = sample_trajectory(make_dummy_ops(), 0, 3, 0b000)
    lo, hi, _logp = r.zeta
    assert (lo, hi) == (-7, 0) and r.v[1] == 7


# --- detailed balance through the port's driver -----------------------------


def visited_log_probabilities(ops, z0, depth):
    """P(z0 -> .) over all 2^depth direction masks (test_trees.jl:188-199)."""
    logps = torch.stack([sample_trajectory(ops, z0, depth, flags).zeta[2]
                         for flags in range(2**depth)])
    return (torch.logsumexp(logps, dim=0) + depth * math.log(0.5)).numpy()


def check_detailed_balance(ops, z0, depth, atol=1e-8):
    """P(z) P(z'|z) == P(z') P(z|z') for every reachable z'
    (test_trees.jl:239-246)."""
    acc0 = visited_log_probabilities(ops, z0, depth)
    reachable = np.nonzero(np.isfinite(acc0))[0]
    assert reachable.size > 0
    np.testing.assert_allclose(np.exp(acc0[reachable]).sum(), 1.0, rtol=1e-10)
    for idx in reachable:
        z1 = int(idx) - OFFSET
        back = visited_log_probabilities(ops, z1, depth)
        lhs = acc0[idx] + dummy_logdensity(z0)
        rhs = back[z0 + OFFSET] + dummy_logdensity(z1)
        assert abs(lhs - rhs) < atol, (
            f"detailed balance violated: z={z0} z'={z1} depth={depth}: "
            f"{lhs} vs {rhs}")


SLOW = pytest.mark.slow
DEPTHS_5 = [1, 2, 3, pytest.param(4, marks=SLOW), pytest.param(5, marks=SLOW)]
DEPTHS_6 = DEPTHS_5 + [pytest.param(6, marks=SLOW)]


@pytest.mark.parametrize("depth", DEPTHS_5)
def test_port_detailed_balance_plain(depth):
    check_detailed_balance(make_dummy_ops(), 0, depth)


@pytest.mark.parametrize("depth", DEPTHS_5)
def test_port_detailed_balance_turning(depth):
    check_detailed_balance(make_dummy_ops(turning=(1, 2)), 3, depth)


@pytest.mark.parametrize("depth", DEPTHS_6)
def test_port_detailed_balance_divergent(depth):
    check_detailed_balance(make_dummy_ops(divergent=(10, 11)), 3, depth)


@pytest.mark.parametrize("depth", DEPTHS_6)
def test_port_detailed_balance_both(depth):
    check_detailed_balance(
        make_dummy_ops(divergent=(10, 12), turning=(-3, -2)), 3, depth)


def test_termination_encoding():
    left, right = TERM_MAX_DEPTH
    assert reached_max_depth(left, right)
    assert not is_divergent_termination(left, right)
    assert is_divergent_termination(torch.tensor(4), torch.tensor(4))
    assert is_turning_termination(torch.tensor(2), torch.tensor(5))
    lo, hi = normalize_termination(torch.tensor([5, 1, 4]),
                                   torch.tensor([2, 0, 4]))
    assert lo.tolist() == [2, 1, 4] and hi.tolist() == [5, 0, 4]
    bit, rest = next_direction(0b110101)
    assert bit and rest == 0b11010
