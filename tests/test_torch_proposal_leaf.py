"""The proposal's leaf of a NUTS transition (dynamichmc_tpu_torch.ops.
proposal_leaf), which the GPU checks of the tree kernel put into their
matching masks.

Its float64 trajectory steps as the plain driver does, so the plain
float64 transition's proposal lies exactly on a trajectory point (1e-20 in
squared distance), within the offsets the tree can reach; the plain
float32 transition, which differs by rounding only, lands on the same leaf
of nearly every chain. Torch only, on the CPU.
"""

import numpy as np
import pytest
import torch

from dynamichmc_tpu_torch import models as tm
from dynamichmc_tpu_torch.metric import dense_metric, diagonal_metric
from dynamichmc_tpu_torch.ops import tree_kernel
from dynamichmc_tpu_torch.ops.proposal_leaf import proposal_offsets, trajectory
from dynamichmc_tpu_torch.tree_batched import (
    exponential_like,
    gumbel_like,
    rand_p_b,
    random_directions,
)

F32 = torch.float32


def _args(model, C, md, dcap, kind, eps_range, seed=0):
    """Inputs of tree_kernel.tree_transition on the CPU: starts from numpy,
    M^-1 = I (dense or diagonal), momenta and noise from a generator."""
    K = model.dim
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(C, K)), dtype=F32)
    v, g = model.logdensity_and_gradient(q)
    gen = torch.Generator().manual_seed(seed)
    minv = torch.ones(K) if kind == "diag" else torch.eye(K)
    metric = diagonal_metric(minv) if kind == "diag" else dense_metric(minv)
    eps = torch.as_tensor(rng.uniform(*eps_range, size=C), dtype=F32)
    return (q, rand_p_b(gen, metric, (C, K), F32).contiguous(), g, v, eps,
            random_directions(gen, C, "cpu"),
            gumbel_like(gen, ((1 << md) - 1, C), F32, "cpu"),
            exponential_like(gen, (md, C), F32, "cpu"), minv.contiguous(),
            model.tree_transition_fn.leaf, dcap, -1000.0, md)


@pytest.mark.parametrize("name,kind,dcap", [
    ("gaussian", "dense", 4), ("gaussian", "diag", 4),
    ("gaussian", "dense", 2), ("funnel", "diag", 5),
])
def test_plain_proposals_lie_on_their_leaf(name, kind, dcap):
    if name == "gaussian":
        model = tm.correlated_gaussian(6, dtype=F32, device="cpu",
                                       tree_kernel=True)
        eps_range = (0.05, 0.3)
    else:
        model = tm.funnel(5, dtype=F32, device="cpu", tree_kernel=True)
        eps_range = (0.02, 0.12)
    C, md = 64, 5
    args = _args(model, C, md, dcap, kind, eps_range)
    ref = tree_kernel.tree_transition_plain(*args)
    ref64 = tree_kernel.tree_transition_plain(*(
        a.double() if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args))
    leaf = args[9]
    leaf_32, leaf_64 = proposal_offsets(
        *args[:5], args[8], leaf.value_and_grad, dcap,
        [ref["prop_q"], ref64["prop_q"]])
    reach = (1 << dcap) - 1
    assert int(leaf_64.abs().max()) <= reach
    assert int(leaf_64.abs().max()) > 0  # the chains moved
    points = {j: q for j, q, _p, _ld in trajectory(
        *args[:5], args[8], leaf.value_and_grad, reach)}
    on_leaf = torch.stack([points[int(j)][c] for c, j in enumerate(leaf_64)])
    assert float((on_leaf - ref64["prop_q"]).square().sum(-1).max()) <= 1e-20
    assert float((leaf_32 == leaf_64).float().mean()) >= 0.95


def test_trajectory_starts_at_the_start_and_steps_both_ways():
    model = tm.correlated_gaussian(3, dtype=F32, device="cpu", tree_kernel=True)
    args = _args(model, 4, 3, 3, "dense", (0.1, 0.2))
    offsets = [j for j, *_ in trajectory(*args[:5], args[8],
                                         args[9].value_and_grad, 3)]
    assert offsets == [0, 1, 2, 3, -1, -2, -3]
    j, q, p, ld = next(trajectory(*args[:5], args[8],
                                  args[9].value_and_grad, 3))
    assert j == 0 and q.dtype == torch.float64
    assert torch.equal(q, args[0].double()) and torch.equal(ld, args[3].double())
