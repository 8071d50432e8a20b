"""The measured window and what a run records.

Calls run back to back in a closed loop, one user job each, until the sum
of their walls reaches the window's length; the call in flight at the
deadline finishes and counts, so a rate is all the work of the window over
all its time. Between calls, outside the clock, the benchmark reads the
call's draws (bulk ESS, the check's samples) and frees them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class CallRecord:
    """One run_chains call: its wall (entry to the synchronise after it
    returns), the draws it made (chains x draws), the smallest bulk ESS over
    coordinates, the leapfrog steps of its draws, the port's launch counts,
    the device memory peak during the call, and why it failed, if it did."""

    wall_s: float
    n_draws: int = 0
    min_ess: Optional[float] = None
    draw_steps: int = 0
    launches: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    warmup_s: Optional[float] = None  # traced calls: entry to warmup's end
    read_s: float = 0.0  # reading the draws after the call, off the clock
    failure: Optional[str] = None

    @property
    def failed(self) -> bool:
        return self.failure is not None


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read: the cell and its configuration, the
    reference module of its model, the set-up seconds, the window's calls
    (or the traced call) and, traced, the profiler's summary."""

    cell: dict
    config: dict
    reference: object
    setup_s: float
    calls: List[CallRecord]
    trace: Optional[object] = None

    @property
    def window_s(self) -> float:
        return float(sum(c.wall_s for c in self.calls))


def run_window(call: Callable[[int], CallRecord], seconds: float
               ) -> List[CallRecord]:
    """Call ``call(0)``, ``call(1)``, ... until their walls add up to
    ``seconds``; the last call starts before that and counts whole."""
    calls: List[CallRecord] = []
    total = 0.0
    while total < seconds:
        record = call(len(calls))
        calls.append(record)
        total += record.wall_s
    return calls


def call_seed(seed: int, index: int, stream: int = 0) -> int:
    """A 63-bit seed for call ``index`` of a run with ``--seed`` (``stream``
    tells apart the generators of one call: 0 the chains', 1 the check's
    sample); any whole ``seed`` >= 0, however large."""
    words = [int(seed) >> 32 & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF,
             index + 1, stream]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1
