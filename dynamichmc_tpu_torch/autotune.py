"""The configuration rules behind ``run_chains(tune="auto")`` (port of
``dynamichmc_tpu.autotune``).

``auto_choices`` fills every knob of a fleet run that the caller left
out, keyed on the chain count and the target's dimension, so that a
plain ``run_chains(generator, ld, n_chains, n_samples)`` runs the
benchmark's configuration: a pooled metric (dense up to
``DENSE_DIM_MAX`` coordinates) once the fleet can estimate one,
per-chain dual-averaging eps, and for large lockstep fleets a warmup
depth clamp and a sampling ``max_depth`` cap. Every choice can be
overridden argument by argument, and ``run_chains`` logs what it applied
and warns after the run when more than ``CAP_SATURATION_WARN`` of the
draws hit the cap. ``tune="reference"`` keeps the reference's defaults:
per-chain diagonal metric, per-chain eps, max_depth 10, no clamp
(NUTS.jl:178-195, mcmc.jl:415-425).

The thresholds are the JAX package's, measured there on a TPU v5e (its
BENCH_NOTES.md): pooling lifted 1024-chain dense runs about 20x, the
clamp cut the warmup's lockstep straggler waste from 65% to about 5% at
the same total ESS, and the cap at 4 gave the same total min ESS in less
wall time. They have not been measured on the H100 yet (ROADMAP Queue 3
F); a capped kernel is ordinary NUTS (Stan's treedepth), so the cap
costs mixing on targets that need deep trees, never exactness.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# the JAX package's thresholds (a TPU v5e's measurements); module constants
# so that tests pin them
POOLED_METRIC_MIN_CHAINS = 128
DENSE_DIM_MAX = 256
MAX_DEPTH_CAP = 4
MAX_DEPTH_CAP_MIN_CHAINS = 256
WARMUP_DEPTH_CLAMP = 2
WARMUP_DEPTH_CLAMP_MIN_CHAINS = 256
WARMUP_DEPTH_CLAMP_TAIL = 25
CAP_SATURATION_WARN = 0.2  # warn when > 20% of draws hit the auto cap


@dataclasses.dataclass(frozen=True)
class TuningChoices:
    """The choices for one run; every field maps to a ``run_chains``
    argument (``max_depth=None``: leave the algorithm's alone)."""

    metric_kind: str
    pooled_metric: bool
    pooled_stepsize: bool
    warmup_depth_clamp: Optional[int]
    warmup_depth_clamp_tail: int
    max_depth: Optional[int]

    def describe(self) -> str:
        eps = "pooled" if self.pooled_stepsize else "per-chain"
        metric = ("pooled " if self.pooled_metric else "per-chain ") + (
            self.metric_kind
        )
        clamp = (
            f"warmup clamp {self.warmup_depth_clamp}"
            f"/{self.warmup_depth_clamp_tail}"
            if self.warmup_depth_clamp
            else "no warmup clamp"
        )
        md = (
            f"max_depth {self.max_depth}" if self.max_depth
            else "reference max_depth"
        )
        return f"{metric} metric, {eps} eps, {clamp}, {md}"


def auto_choices(
    n_chains: int,
    dim: int,
    max_depth_limit: int = 10,
    metric_kind: Optional[str] = None,
) -> TuningChoices:
    """The decision table, keyed on (n_chains, dim).

    ``metric_kind`` pins the metric's structure when the caller chose one
    (only the pooling is decided); ``max_depth_limit`` bounds the clamp
    and the cap (a caller's smaller max_depth wins).
    """
    pooled_metric = n_chains >= POOLED_METRIC_MIN_CHAINS
    if metric_kind is None:
        # dense only when pooled (no per-chain (C, K, K) metric) and while
        # the dimension keeps its matmuls and estimate cheap
        metric_kind = (
            "dense" if (pooled_metric and dim <= DENSE_DIM_MAX) else "diagonal"
        )
    cap = (
        min(MAX_DEPTH_CAP, max_depth_limit)
        if n_chains >= MAX_DEPTH_CAP_MIN_CHAINS
        else None
    )
    # the clamp and the cap cut the lockstep straggler waste of a large
    # fleet; small fleets keep the reference's warmup
    clamp = None
    if n_chains >= WARMUP_DEPTH_CLAMP_MIN_CHAINS:
        clamp = min(
            WARMUP_DEPTH_CLAMP, cap if cap is not None else max_depth_limit
        )
    return TuningChoices(
        metric_kind=metric_kind,
        pooled_metric=pooled_metric,
        pooled_stepsize=False,  # per-chain eps at every fleet size
        warmup_depth_clamp=clamp,
        warmup_depth_clamp_tail=WARMUP_DEPTH_CLAMP_TAIL if clamp else 0,
        max_depth=cap,
    )
