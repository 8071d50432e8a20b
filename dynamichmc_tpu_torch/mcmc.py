"""The per-chain entry point, sampler results and host-side checks (port
of parts of ``dynamichmc_tpu.mcmc``).

``mcmc_with_warmup`` is the API DynamicHMC.jl users call: one chain,
staged warmup, then draws, through the per-chain fast driver (nuts.py,
tree.py) and the engine's schedule loop. The stepwise API, keep-warmup and
progress reporters are not ported (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .errors import DynamicHMCError
from .logdensity import LogDensity
from .metric import Metric
from .nuts import NUTS, TreeStatistics


@dataclasses.dataclass
class MCMCResult:
    """Draws, their log densities, per-draw tree statistics, and the
    adapted metric and stepsize: (C, N, K) / (C, N) from run_chains,
    (N, K) / (N,) from mcmc_with_warmup."""

    positions: torch.Tensor
    logdensities: torch.Tensor
    tree_statistics: TreeStatistics
    metric: Metric
    eps: torch.Tensor

    @property
    def posterior_matrix(self) -> torch.Tensor:
        """The reference's [parameter, draw] orientation (mcmc.jl:16-17)."""
        return self.positions.transpose(-1, -2)

    def summary(self) -> str:
        """Human-readable diagnostics: the tree-statistics summary plus,
        for multi-chain results, per-parameter R-hat / ESS extremes."""
        from .diagnostics import summarize_tree_statistics

        parts = [str(summarize_tree_statistics(self.tree_statistics))]
        if self.positions.ndim == 3 and self.positions.shape[0] > 1:
            from .stats import ess_rhat

            st = ess_rhat(self.positions.detach().cpu().numpy())
            parts.append(
                f"  R-hat max: {st['rhat'].max():.4f}; bulk ESS min: "
                f"{st['ess_bulk'].min():.0f}; tail ESS min: "
                f"{st['ess_tail'].min():.0f}"
            )
        return "\n".join(parts)


def mcmc_with_warmup(generator: torch.Generator, ld: LogDensity,
                     n_samples: int, initialization: Optional[dict] = None,
                     warmup_stages=None, algorithm: NUTS = NUTS(),
                     dtype=torch.float32, reporter=None) -> MCMCResult:
    """NUTS with warmup for one chain (mcmc.jl:575-584): the stepsize
    search, the staged warmup, then ``n_samples`` draws, on the generator's
    device with every random number from ``generator``.

    ``initialization`` takes ``q``, ``metric``, ``eps`` and ``strict``
    (:func:`warmup.initialize_warmup_state`). Returns positions (N, K),
    log densities (N,), tree statistics (N,), the adapted metric and eps.
    Raises when the model's tensors lie on another device. Schedules that
    are not an optional search followed by homogeneous TuningNUTS blocks, a
    progress ``reporter`` and a custom turn statistic raise
    NotImplementedError (not ported)."""
    from .engine import PER_CHAIN, WarmupSchedule, execute
    from .warmup import default_warmup_stages, initialize_warmup_state

    if reporter is not None:
        raise NotImplementedError("progress reporters are not ported")
    if algorithm.turn_statistic_configuration != "generalized":
        raise NotImplementedError(
            "custom turn statistics need the generic per-chain driver, which "
            "is not ported (ROADMAP item 14)")
    stages = (tuple(warmup_stages) if warmup_stages is not None
              else default_warmup_stages())
    schedule = WarmupSchedule.from_stages(stages)
    if schedule is None:
        raise NotImplementedError(
            "only homogeneous schedules (an optional stepsize search, then "
            "TuningNUTS blocks sharing one metric kind and adaptation) are "
            "ported")
    state = initialize_warmup_state(generator, ld, dtype=dtype,
                                    **(initialization or {}))
    metric, eps, search_results, inference = execute(
        generator, ld, algorithm, schedule, state.Q, state.metric, state.eps,
        n_samples, ops=PER_CHAIN)
    _check_stepsize_search(search_results)
    _q, positions, logdensities, stats = inference
    return MCMCResult(positions=positions, logdensities=logdensities,
                      tree_statistics=stats, metric=metric, eps=eps)


def _positions_3d(results) -> torch.Tensor:
    """(C, N, K) from a list of results or one result (a single chain's
    (N, K) becomes (1, N, K), not a silent transpose)."""
    if isinstance(results, (list, tuple)):
        return torch.stack([r.positions for r in results])
    positions = results.positions
    return positions[None] if positions.ndim == 2 else positions


def stack_posterior_matrices(results) -> torch.Tensor:
    """[draw, chain, parameter] stack for cross-chain diagnostics
    (mcmc.jl:602-604)."""
    return _positions_3d(results).transpose(0, 1)


def pool_posterior_matrices(results) -> torch.Tensor:
    """[parameter, pooled draw] (mcmc.jl:615-617)."""
    positions = _positions_3d(results)
    c, n, k = positions.shape
    return positions.reshape(c * n, k).T


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
