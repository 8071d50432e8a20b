"""Constrained-parameter transforms: sample on R^n, report in the domain
(port of ``dynamichmc_tpu.constraints``).

The reference leaves domain transforms to its sibling packages
(TransformVariables, TransformedLogDensities); this is the in-tree minimum:
elementwise and block transforms with their log-Jacobian terms, a function
that turns a log density on a constrained domain into an unconstrained
:class:`LogDensity`, and the map of draws back to the domain.

Every transform works on tensors batched over the leading axes, as the
port's log densities do: ``forward`` takes ``x (..., input_dim)`` and
returns ``(y (..., output_dim), log|det J| (...))``. Constants are made on
the input's device and dtype; the gradient of a transformed density comes
from autograd through :class:`LogDensity`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

from .logdensity import LogDensity


@dataclasses.dataclass(frozen=True)
class Transform:
    """A bijection from a block of unconstrained reals to a constrained
    domain.

    input_dim: unconstrained inputs consumed; output_dim: constrained
    outputs produced.
    forward: ``x (..., input_dim) -> (y (..., output_dim), log|det J| (...))``.
    inverse: ``y -> x``.
    """

    input_dim: int
    output_dim: int
    forward: Callable
    inverse: Callable


def _const(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def identity(dim: int = 1) -> Transform:
    """Unconstrained block."""
    return Transform(
        input_dim=dim, output_dim=dim,
        forward=lambda x: (x, torch.zeros(x.shape[:-1], dtype=x.dtype,
                                          device=x.device)),
        inverse=lambda y: y,
    )


def positive(dim: int = 1) -> Transform:
    """(0, inf) via exp; log|J| = sum(x)."""
    return Transform(
        input_dim=dim, output_dim=dim,
        forward=lambda x: (torch.exp(x), x.sum(-1)),
        inverse=torch.log,
    )


def bounded(lo: float, hi: float, dim: int = 1) -> Transform:
    """(lo, hi) via a scaled logistic; log|J| = sum(log sigmoid'(x)) +
    log w."""
    if not lo < hi:
        raise ValueError("need lo < hi")
    width = hi - lo

    def forward(x):
        w = _const(width, x)
        y = _const(lo, x) + w * torch.sigmoid(x)
        log_j = (torch.log(w) + F.logsigmoid(x) + F.logsigmoid(-x)).sum(-1)
        return y, log_j

    def inverse(y):
        u = (y - _const(lo, y)) / _const(width, y)
        return torch.log(u) - torch.log1p(-u)

    return Transform(input_dim=dim, output_dim=dim, forward=forward,
                     inverse=inverse)


def _stick_offsets(k: int, like: torch.Tensor) -> torch.Tensor:
    """log(k), log(k - 1), ..., log(1): the offsets that centre the
    stick-breaking fractions at the simplex's centre."""
    return torch.log(torch.arange(k, 0, -1, dtype=like.dtype,
                                  device=like.device))


def simplex(n: int) -> Transform:
    """The (n-1)-dim stick-breaking parameterization of the n-simplex
    (as in Stan): n-1 unconstrained inputs -> n positive outputs summing
    to 1."""
    if n < 2:
        raise ValueError("simplex needs n >= 2")
    k = n - 1

    def forward(x):
        z = torch.sigmoid(x - _stick_offsets(k, x))  # break fractions
        remaining = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
        ys, ljs = [], []
        for i in range(k):
            zi = z[..., i]
            yi = remaining * zi
            # d y_i / d x_i = remaining * z_i * (1 - z_i); the map is lower
            # triangular, so the log-determinant is the sum of these
            ljs.append(torch.log(remaining) + torch.log(zi)
                       + torch.log1p(-zi))
            ys.append(yi)
            remaining = remaining - yi
        y = torch.stack(ys + [remaining], dim=-1)
        return y, torch.stack(ljs, dim=-1).sum(-1)

    def inverse(y):
        head = y[..., :k]
        # the stick used before each break: 0, y_0, y_0 + y_1, ...
        cums = torch.cat([torch.zeros_like(head[..., :1]),
                          torch.cumsum(head[..., :-1], dim=-1)], dim=-1)
        z = head / (1 - cums)
        return torch.log(z) - torch.log1p(-z) + _stick_offsets(k, y)

    return Transform(input_dim=k, output_dim=n, forward=forward,
                     inverse=inverse)


@dataclasses.dataclass(frozen=True)
class TransformStack:
    """An ordered sequence of transforms applied to contiguous blocks of
    the unconstrained vector (the last axis)."""

    transforms: Tuple[Transform, ...]

    @property
    def input_dim(self) -> int:
        return sum(t.input_dim for t in self.transforms)

    @property
    def output_dim(self) -> int:
        return sum(t.output_dim for t in self.transforms)

    def forward_with_logdet(self, x):
        if x.shape[-1] != self.input_dim:
            # a mismatched vector would silently slice short of or past
            # the data and return wrong but plausible values
            raise ValueError(
                f"expected an unconstrained vector of length "
                f"{self.input_dim}, got {x.shape[-1]}")
        ys, off = [], 0
        log_j = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for t in self.transforms:
            y, lj = t.forward(x[..., off:off + t.input_dim])
            ys.append(y)
            log_j = log_j + lj
            off += t.input_dim
        return torch.cat(ys, dim=-1), log_j

    def forward(self, x):
        return self.forward_with_logdet(x)[0]

    def inverse(self, y):
        if y.shape[-1] != self.output_dim:
            raise ValueError(
                f"expected a constrained vector of length "
                f"{self.output_dim}, got {y.shape[-1]}")
        xs, off = [], 0
        for t in self.transforms:
            xs.append(t.inverse(y[..., off:off + t.output_dim]))
            off += t.output_dim
        return torch.cat(xs, dim=-1)


def as_stack(transforms: Sequence[Transform]) -> TransformStack:
    return TransformStack(transforms=tuple(transforms))


def transformed_logdensity(constrained_logdensity_fn: Callable,
                           transforms: Sequence[Transform]) -> LogDensity:
    """An unconstrained :class:`LogDensity` from a log density on a
    constrained domain: lp(x) = lp_constrained(T(x)) + log|det J_T(x)|.
    ``constrained_logdensity_fn`` takes ``y (..., output_dim)`` and returns
    ``(...)``. Map draws back with :func:`constrain_draws`."""
    stack = as_stack(transforms)

    def logdensity_fn(x):
        y, log_j = stack.forward_with_logdet(x)
        return constrained_logdensity_fn(y) + log_j

    return LogDensity(dim=stack.input_dim, logdensity_fn=logdensity_fn)


def constrain_draws(transforms: Sequence[Transform], draws) -> torch.Tensor:
    """Map unconstrained draws (..., input_dim), e.g. (N, K) or (C, N, K),
    to their constrained values (..., output_dim)."""
    return as_stack(transforms).forward(torch.as_tensor(draws))
