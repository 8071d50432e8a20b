"""Stepsize search parameters and adaptation (port of
``dynamichmc_tpu.stepsize``).

Dual averaging is a pure state fold with per-chain ``(C,)`` state (or a
scalar state when pooled). The bracketing search of one chain is
``local_log_acceptance_ratio`` + ``find_initial_stepsize`` (eager, one host
read per iteration); the batched search lives in
engine.make_search_driver_batched.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .hamiltonian import PhasePoint, joint_logdensity, leapfrog
from .logdensity import LogDensity
from .metric import Metric
from .profiling import host_bool


@dataclasses.dataclass(frozen=True)
class InitialStepsizeSearch:
    """Bracketing parameters: double/halve the stepsize until the local log
    acceptance ratio crosses ``log_threshold``."""

    initial_eps: float = 0.1
    log_threshold: float = math.log(0.8)
    maxiter_crossing: int = 400

    def __post_init__(self):
        if not (math.isfinite(self.log_threshold) and self.log_threshold < 0):
            raise ValueError("log_threshold must be finite and negative")
        if not (math.isfinite(self.initial_eps) and self.initial_eps > 0):
            raise ValueError("initial_eps must be finite and positive")
        if self.maxiter_crossing < 50:
            raise ValueError("maxiter_crossing must be >= 50")


def local_log_acceptance_ratio(ld: LogDensity, metric: Metric, z: PhasePoint):
    """(A, l0): A(eps) is the uncapped one-step log acceptance ratio around
    ``z`` (stepsize.jl:75-85), l0 the joint log density at ``z``."""
    l0 = joint_logdensity(metric, z)

    def A(eps):
        z1 = leapfrog(ld, metric, z, eps)
        return joint_logdensity(metric, z1) - l0

    return A, l0


def find_initial_stepsize(params: InitialStepsizeSearch, A, dtype=None,
                          device=None):
    """The bracketing search of one chain (stepsize.jl:46-60): double or
    halve eps until A(eps) crosses ``log_threshold``.

    Returns ``(eps, success)`` as 0-d tensors; ``success`` is False when no
    crossing came within ``maxiter_crossing`` iterations (the caller raises
    on the host, as the JAX package does)."""
    eps = torch.tensor(params.initial_eps, dtype=dtype, device=device)
    thr = params.log_threshold
    double = host_bool("chain_search", A(eps) > thr)
    found, it = False, 0
    while not found and it < params.maxiter_crossing:
        eps = eps * 2 if double else eps / 2
        a = A(eps)
        found = host_bool("chain_search", a < thr if double else a > thr)
        it += 1
    return eps, torch.tensor(found, device=device)


@dataclasses.dataclass
class DualAveragingState:
    mu: torch.Tensor
    m: torch.Tensor  # iteration counter, kept as float for the formulas
    h_bar: torch.Tensor
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DualAveraging:
    """Nesterov dual averaging of log-stepsize toward a target acceptance
    rate ``delta`` (Hoffman & Gelman 2014, Alg. 6)."""

    delta: float = 0.8
    gamma: float = 0.05
    kappa: float = 0.75
    t0: int = 10

    def __post_init__(self):
        if not 0 < self.delta < 1:
            raise ValueError("delta must be in (0, 1)")
        if not self.gamma > 0:
            raise ValueError("gamma must be positive")
        if not 0.5 < self.kappa <= 1:
            raise ValueError("kappa must be in (0.5, 1]")
        if self.t0 < 0:
            raise ValueError("t0 must be non-negative")

    def init(self, eps) -> DualAveragingState:
        """mu = log(10) + log(eps), m = 1."""
        log_eps = torch.log(torch.as_tensor(eps))
        return DualAveragingState(
            mu=math.log(10.0) + log_eps,
            m=torch.ones_like(log_eps),
            h_bar=torch.zeros_like(log_eps),
            log_eps=log_eps,
            log_eps_bar=torch.zeros_like(log_eps),
        )

    def update(self, state: DualAveragingState, a) -> DualAveragingState:
        """``a`` is the tree-averaged acceptance rate."""
        a = torch.clamp(torch.as_tensor(a), 0.0, 1.0)
        m = state.m + 1
        h_bar = state.h_bar + (self.delta - a - state.h_bar) / (m + self.t0)
        log_eps = state.mu - torch.sqrt(m) / self.gamma * h_bar
        log_eps_bar = state.log_eps_bar + m ** (-self.kappa) * (
            log_eps - state.log_eps_bar
        )
        return DualAveragingState(
            mu=state.mu, m=m, h_bar=h_bar, log_eps=log_eps,
            log_eps_bar=log_eps_bar,
        )

    def current(self, state: DualAveragingState):
        """Stepsize for the next transition while tuning."""
        return torch.exp(state.log_eps)

    def final(self, state: DualAveragingState):
        """Averaged stepsize after adaptation."""
        return torch.exp(state.log_eps_bar)


@dataclasses.dataclass(frozen=True)
class PooledStepsize:
    """One shared stepsize for the whole fleet, adapted from the batch-mean
    acceptance rate (warmup-only coupling; sampling runs a fixed shared
    eps). The initial eps is the geometric mean of the chains' eps.

    ``mesh`` (a ``parallel.mesh.ChainMesh``): pool over every chain of
    every rank, the counterpart of the JAX package's ``axis_name``. Only
    the warmup sets it, on the copy a stage runs with over a mesh
    (``dataclasses.replace``); an instance a user builds leaves it None."""

    inner: object = None
    mesh: object = None

    def __post_init__(self):
        if self.inner is None:
            object.__setattr__(self, "inner", DualAveraging())

    def init(self, eps):
        eps = torch.as_tensor(eps)
        if eps.ndim > 0:
            log_eps = torch.log(eps)
            if self.mesh is None or self.mesh.size == 1:  # bit for bit
                eps = torch.exp(torch.mean(log_eps))
            else:
                # the sum of log eps over the global chains, over their count
                from .parallel.mesh import all_sum

                eps = torch.exp(all_sum(log_eps.sum(), self.mesh)
                                / (log_eps.numel() * self.mesh.size))
        return self.inner.init(eps)

    def update(self, state, a):
        a = torch.as_tensor(a)
        a = a if a.ndim == 0 else a.mean()
        if self.mesh is not None:
            from .parallel.mesh import all_mean

            a = all_mean(a, self.mesh)
        return self.inner.update(state, a)

    def current(self, state):
        return self.inner.current(state)

    def final(self, state):
        return self.inner.final(state)


@dataclasses.dataclass(frozen=True)
class FixedStepsize:
    """No-op adaptation with the same four-function interface."""

    def init(self, eps):
        return torch.as_tensor(eps)

    def update(self, state, a):
        return state

    def current(self, state):
        return state

    def final(self, state):
        return state
