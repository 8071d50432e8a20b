"""Sampler results and host-side checks (port of parts of
``dynamichmc_tpu.mcmc``)."""

from __future__ import annotations

import dataclasses

import torch

from .errors import DynamicHMCError
from .metric import Metric
from .nuts import TreeStatistics


@dataclasses.dataclass
class MCMCResult:
    """Draws (C, N, K), their log densities (C, N), per-draw tree
    statistics (C, N), and the adapted metric and stepsize."""

    positions: torch.Tensor
    logdensities: torch.Tensor
    tree_statistics: TreeStatistics
    metric: Metric
    eps: torch.Tensor


def _check_stepsize_search(results) -> None:
    """Raise what the reference throws on a failed bracketing search: a
    non-finite joint density at the starting point, or no crossing within
    ``maxiter_crossing`` iterations."""
    if results is None:
        return
    l0 = torch.atleast_1d(results["l0"]).cpu()
    bad = torch.nonzero(~torch.isfinite(l0)).flatten()
    if bad.numel():
        raise DynamicHMCError(
            "Starting point has non-finite density.",
            chains=bad.tolist(),
            logdensity=l0[bad].tolist(),
        )
    success = torch.atleast_1d(results["success"]).cpu()
    if not bool(success.all()):
        raise DynamicHMCError(
            "Initial stepsize search reached maximum number of iterations "
            "without crossing.",
            eps=results["eps"].cpu(),
            failed_fraction=float(1 - success.double().mean()),
        )
