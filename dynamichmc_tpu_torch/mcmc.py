"""The per-chain entry points, sampler results, the stepwise API and
host-side checks (port of ``dynamichmc_tpu.mcmc``).

``mcmc_with_warmup`` and ``mcmc_keep_warmup`` are the API DynamicHMC.jl
users call (mcmc.jl:521-584): one chain, staged warmup, then draws, through
the per-chain drivers (nuts.py, tree.py). Both run any stage tuple through
the stage fold (warmup.run_warmup); ``mcmc_keep_warmup`` also keeps what
each stage did. ``mcmc_steps`` is the stepwise API (mcmc.jl:295-351).

Progress: ``reporter=None`` means ``reporting.default_reporter()``
(a terminal logs each block, anything else is silent); an explicit step
reporter (``LogProgressReport``, ``TqdmProgressReport``) is told of every
transition. The port runs every transition eagerly, so that is the
reference's own cadence; ``inline_reporting`` is accepted for the JAX
package's signature and changes nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .errors import DynamicHMCError
from .hamiltonian import EvaluatedPoint
from .logdensity import LogDensity, check_device
from .metric import Metric
from .nuts import NUTS, TreeStatistics


@dataclasses.dataclass
class InferenceResult:
    """Draws and per-draw diagnostics: positions (N, K), log densities and
    tree statistics (N,) for one chain; (C, N, K) / (C, N) for a batch."""

    positions: torch.Tensor
    logdensities: torch.Tensor
    tree_statistics: TreeStatistics

    @property
    def posterior_matrix(self) -> torch.Tensor:
        """The reference's [parameter, draw] orientation (mcmc.jl:16-17)."""
        return self.positions.transpose(-1, -2)


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


def _reporting(reporter):
    """(log, step reporter) of a ``reporter`` argument. None means
    ``default_reporter()``, whose messages are logged but which is not told
    of each transition (reporting.jl:184-190); an explicit reporter that
    wants step callbacks is told of every transition."""
    from .reporting import default_reporter, stage_log

    if reporter is None:
        return stage_log(default_reporter()), None
    return (stage_log(reporter),
            reporter if reporter.wants_step_callbacks else None)


def mcmc(generator: torch.Generator, ld: LogDensity, algorithm: NUTS, state,
         n_samples: int, reporter=None):
    """Post-warmup sampling (mcmc.jl:366-381): ``n_samples`` transitions
    from a ``WarmupState`` at its fixed metric and eps, one (K,) chain or a
    (C, K) batch. A ``reporter`` that wants step callbacks is told of every
    draw. A batch with a custom turn statistic runs the generic driver
    looped over its chains (engine.chain_ops). Returns (Q_final,
    InferenceResult)."""
    from .engine import chain_ops, run_sampling

    check_device(ld, generator.device)
    ops = chain_ops(algorithm, state.Q.q.ndim == 2)
    if reporter is not None and not reporter.wants_step_callbacks:
        reporter = None
    Q, positions, lds, stats = run_sampling(
        generator, ld, algorithm, state.Q, state.metric, state.eps,
        n_samples, ops=ops, reporter=reporter)
    return Q, InferenceResult(positions=positions, logdensities=lds,
                              tree_statistics=stats)


def _keep_warmup(generator, ld, n_samples, initial_state, stages, algorithm,
                 collect_positions: bool, collect_stats: bool, reporter):
    """The stage fold, its search check, then the draws: (history, final
    state, inference)."""
    from .warmup import run_warmup

    log, step_reporter = _reporting(reporter)
    history, state = run_warmup(
        generator, ld, algorithm, stages, initial_state,
        collect_positions=collect_positions, collect_stats=collect_stats,
        log=log, reporter=step_reporter)
    _check_stepsize_search(history)
    _q, inference = mcmc(generator, ld, algorithm, state, n_samples,
                         reporter=step_reporter)
    return history, state, inference


def mcmc_keep_warmup(generator: torch.Generator, ld: LogDensity,
                     n_samples: int, initialization: Optional[dict] = None,
                     warmup_stages=None, algorithm: NUTS = NUTS(),
                     dtype=torch.float32,
                     collect_warmup_positions: bool = True, reporter=None,
                     inline_reporting: bool = False) -> dict:
    """Warmup and sampling for one chain, keeping every warmup state
    (mcmc.jl:521-532), on the generator's device with every random number
    from ``generator``.

    Returns a dict: ``initial_warmup_state``; ``warmup``, a list of (stage,
    results, state after the stage) aligned with the stage tuple (None
    stages included), results as ``warmup.warmup_stage`` gives them;
    ``final_warmup_state``; ``inference`` (an :class:`InferenceResult`).
    From one generator seed the draws, eps and metric are bitwise those of
    :func:`mcmc_with_warmup`. Raises when the model's tensors lie on
    another device."""
    from .warmup import default_warmup_stages, initialize_warmup_state

    stages = (tuple(warmup_stages) if warmup_stages is not None
              else default_warmup_stages())
    initial_state = initialize_warmup_state(generator, ld, dtype=dtype,
                                            **(initialization or {}))
    history, final_state, inference = _keep_warmup(
        generator, ld, n_samples, initial_state, stages, algorithm,
        collect_warmup_positions, True, reporter)
    return {
        "initial_warmup_state": initial_state,
        "warmup": history,
        "final_warmup_state": final_state,
        "inference": inference,
    }


def mcmc_with_warmup(generator: torch.Generator, ld: LogDensity,
                     n_samples: int, initialization: Optional[dict] = None,
                     warmup_stages=None, algorithm: NUTS = NUTS(),
                     dtype=torch.float32, reporter=None,
                     inline_reporting: bool = False) -> MCMCResult:
    """NUTS with warmup for one chain (mcmc.jl:575-584): the staged warmup,
    then ``n_samples`` draws, on the generator's device with every random
    number from ``generator``.

    ``initialization`` takes ``q``, ``metric``, ``eps`` and ``strict``
    (:func:`warmup.initialize_warmup_state`). Any stage tuple runs (see
    the module docstring) and any ``algorithm``, a custom turn statistic
    through the generic driver. Returns positions (N, K), log densities
    (N,), tree statistics (N,), the adapted metric and eps. Raises when
    the model's tensors lie on another device."""
    from .warmup import default_warmup_stages, initialize_warmup_state

    stages = (tuple(warmup_stages) if warmup_stages is not None
              else default_warmup_stages())
    state = initialize_warmup_state(generator, ld, dtype=dtype,
                                    **(initialization or {}))
    _history, final, inference = _keep_warmup(
        generator, ld, n_samples, state, stages, algorithm, False, False,
        reporter)
    return MCMCResult(positions=inference.positions,
                      logdensities=inference.logdensities,
                      tree_statistics=inference.tree_statistics,
                      metric=final.metric, eps=final.eps)


# --- stepwise API -----------------------------------------------------------


@dataclasses.dataclass
class StepwiseChunk:
    """What :meth:`MCMCSteps.next_chunk` returns: ``n`` transitions' draws
    and diagnostics, the steps on the leading axis."""

    positions: torch.Tensor  # (n, K) or (n, C, K)
    logdensities: torch.Tensor  # (n,) or (n, C)
    tree_statistics: TreeStatistics  # fields (n,) or (n, C)


@dataclasses.dataclass(frozen=True)
class MCMCSteps:
    """Stepwise sampling handle (mcmc.jl:295-341): a fixed algorithm,
    metric and stepsize; each ``next_step(generator, Q)`` is one
    transition. One chain's (K,) ``Q`` runs ``nuts.sample_tree``; a (C, K)
    batch runs ``tree_batched.sample_tree_batched``, which hands the
    transition to the model's tree kernel or its fused leaf as
    ``run_chains`` does."""

    ld: LogDensity
    algorithm: NUTS
    metric: Metric
    eps: object

    def next_step(self, generator: torch.Generator, Q: EvaluatedPoint):
        """One transition (mcmc.jl:348-351): (Q', TreeStatistics)."""
        from .nuts import sample_tree
        from .tree_batched import sample_tree_batched

        check_device(self.ld, generator.device)
        transition = sample_tree_batched if Q.q.ndim == 2 else sample_tree
        return transition(generator, self.algorithm, self.ld, self.metric, Q,
                          self.eps)

    def next_chunk(self, generator: torch.Generator, Q: EvaluatedPoint,
                   n_steps: int):
        """``n_steps`` (>= 1) transitions: draw for draw the same as
        ``n_steps`` calls of :meth:`next_step` on the same generator.
        Returns (Q_final, StepwiseChunk)."""
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        qs, lds, per_draw = [], [], []
        for _ in range(n_steps):
            Q, stats = self.next_step(generator, Q)
            qs.append(Q.q)
            lds.append(Q.logdensity)
            per_draw.append(stats)
        return Q, StepwiseChunk(
            positions=torch.stack(qs), logdensities=torch.stack(lds),
            tree_statistics=TreeStatistics(**{
                f.name: (None if getattr(per_draw[0], f.name) is None else
                         torch.stack([getattr(s, f.name) for s in per_draw]))
                for f in dataclasses.fields(TreeStatistics)}))


def mcmc_steps(ld: LogDensity, algorithm: NUTS, metric: Metric,
               eps) -> MCMCSteps:
    return MCMCSteps(ld=ld, algorithm=algorithm, metric=metric, eps=eps)


def mcmc_steps_from_state(ld: LogDensity, algorithm: NUTS,
                          state) -> MCMCSteps:
    return MCMCSteps(ld=ld, algorithm=algorithm, metric=state.metric,
                     eps=state.eps)


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


def _check_stepsize_search(history, mesh=None) -> None:
    """Raise what the reference throws on a failed bracketing search
    (stepsize.jl:56-59, 77-79): a non-finite joint density at the starting
    point, or no crossing within ``maxiter_crossing`` iterations.
    ``history``: (stage, results, state) triples; results with ``l0`` and
    ``success`` are a search's. ``mesh`` (a ``parallel.mesh.ChainMesh``):
    the results are this rank's chains, and the check reads every rank's,
    so that every rank raises the same error, naming global chains."""
    for _stage, results, _state in history:
        if not isinstance(results, dict) or "l0" not in results:
            continue
        l0, success, eps = (torch.atleast_1d(results["l0"]),
                            torch.atleast_1d(results["success"]),
                            results["eps"])
        if mesh is not None:
            from .parallel.mesh import all_gather_chains

            l0, success, eps = (all_gather_chains(x, mesh)
                                for x in (l0, success, eps))
        l0 = l0.cpu()
        bad = torch.nonzero(~torch.isfinite(l0)).flatten()
        if bad.numel():
            raise DynamicHMCError(
                "Starting point has non-finite density.",
                chains=bad.tolist(),
                logdensity=l0[bad].tolist(),
            )
        success = success.cpu()
        if not bool(success.all()):
            raise DynamicHMCError(
                "Initial stepsize search reached maximum number of iterations "
                "without crossing.",
                eps=eps.cpu(),
                failed_fraction=float(1 - success.double().mean()),
            )
