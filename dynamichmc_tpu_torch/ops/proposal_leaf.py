"""Which leaf of its trajectory a NUTS transition proposed.

Checks of the tree kernel against its plain versions need to know whether
two transitions chose the same leaf: a Gumbel-argmax or doubling decision
at a near tie can flip under another summation order, and then q', ld' and
grad' differ by whole leapfrog steps, not by rounding. The proposal is the
trajectory point it sits on, so :func:`proposal_offsets` integrates the
float64 leapfrog trajectory from the transition's start both ways
(:func:`trajectory`) and gives, for each chain, the signed step offset of
the point nearest each proposal.

This module imports torch only, so a script can load it by path beside
another checkout's package.
"""

from __future__ import annotations

import torch


def trajectory(q0, p0, g0, ld0, eps, minv, value_and_grad, steps: int):
    """Yield ``(offset, q, p, ld)`` of the float64 leapfrog trajectory from
    (q0, p0) with per-chain stepsizes ``eps`` and the shared M^-1 ``minv``
    ((K,) or (K, K)): offset 0, then 1..steps forward, then -1..-steps
    backward, as the plain driver steps (half a momentum step, a position
    step, half a momentum step). ``value_and_grad(q) -> (ld, grad)`` is the
    target's, in q's dtype."""
    f64 = torch.float64
    q0, p0, g0, ld0, eps, minv = (
        t.to(f64) for t in (q0, p0, g0, ld0, eps, minv))

    def sharp(p):
        return p * minv if minv.ndim == 1 else p @ minv

    yield 0, q0, p0, ld0
    for sign in (1, -1):
        half = 0.5 * sign * eps[:, None]
        q, p, g = q0, p0, g0
        for j in range(1, steps + 1):
            p = p + half * g
            q = q + 2 * half * sharp(p)
            ld, g = value_and_grad(q)
            p = p + half * g
            yield sign * j, q, p, ld


def proposal_offsets(q0, p0, g0, ld0, eps, minv, value_and_grad, dcap: int,
                     props) -> torch.Tensor:
    """(len(props), C) int32: for each proposal (C, K) in ``props`` and each
    chain, the offset in -(2^dcap - 1)..2^dcap - 1 of the trajectory point
    nearest to it (:func:`trajectory`; non-finite points are never
    nearest)."""
    stacked = torch.stack([p.to(torch.float64) for p in props])
    best = torch.full(stacked.shape[:2], torch.inf, dtype=torch.float64,
                      device=stacked.device)
    offset = torch.zeros(stacked.shape[:2], dtype=torch.int32,
                         device=stacked.device)
    for j, q, _p, _ld in trajectory(q0, p0, g0, ld0, eps, minv,
                                    value_and_grad, (1 << dcap) - 1):
        dist = torch.nan_to_num((stacked - q).square().sum(-1),
                                nan=torch.inf)
        closer = dist < best
        best = torch.where(closer, dist, best)
        offset = torch.where(closer, j, offset)
    return offset
