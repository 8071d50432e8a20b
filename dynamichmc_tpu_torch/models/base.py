"""Test/benchmark targets with exactly characterized distributions (port of
``dynamichmc_tpu.models.base``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..logdensity import LogDensity


@dataclasses.dataclass(frozen=True, eq=False)
class TestModel(LogDensity):
    """A LogDensity with an optional exact sampler
    ``sample(generator, n) -> (n, dim)`` and optional known moments."""

    __test__ = False  # not a pytest test class

    sample_fn: Optional[Callable] = None
    mean_fn: Optional[Callable] = None  # () -> (dim,)
    cov_fn: Optional[Callable] = None  # () -> (dim, dim)
    # additive constant c such that logdensity_fn(q) + c is normalized
    log_normalization: Optional[float] = None

    def sample(self, generator, n: int):
        if self.sample_fn is None:
            raise NotImplementedError("no exact sampler for this model")
        return self.sample_fn(generator, n)

    @property
    def has_exact_sampler(self) -> bool:
        return self.sample_fn is not None
