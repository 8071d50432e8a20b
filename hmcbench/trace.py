"""The traced call: torch.profiler over one run_chains call, its events
kept in memory, reduced to the device's busy time, its operations by
kernel name and its idle gaps by what the host was doing.

The benchmark's own spans are profiler annotations: ``hmcbench.call``
around the call, ``hmcbench.draws`` from the warmup's end (where the
traced call synchronises) to the call's end. Every time below is on the
profiler's clock, in seconds from the call's start.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

CALL, DRAWS = "hmcbench.call", "hmcbench.draws"
TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class TraceRecord:
    """A traced call. ``device``: (name, start_s, end_s) of every device
    operation (kernels, copies, fills) inside the call; ``host``: the same
    of every host event; ``window_s``: the call's length; ``draws_start_s``:
    the warmup's end, or None."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window_s: float
    draws_start_s: Optional[float]

    def kernels(self, pattern: str, after: float = 0.0):
        """Device operations whose name contains ``pattern`` and that start
        at or after ``after``."""
        return [e for e in self.device if pattern in e[0] and e[1] >= after]

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in _union(self.device))

    def breakdown(self) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps, each named by the benchmark span and the
        innermost host event at its start."""
        by_name = {}
        for name, a, b in self.device:
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps, t = [], 0.0
        for a, b in _union(self.device) + [(self.window_s, self.window_s)]:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._host_label(a), b - a] for a, b in gaps]}

    def _host_label(self, t: float) -> str:
        span = ("draws" if self.draws_start_s is not None
                and t >= self.draws_start_s else "warmup")
        inner = None
        for name, a, b in self.host:
            if a <= t < b and not name.startswith("hmcbench.") and (
                    inner is None or a >= inner[1]):
                inner = (name, a)
        return span if inner is None else f"{span}: {short_name(inner[0])}"


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip()[:160]


def _union(events) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def profile(fn):
    """Run ``fn(mark_draws)``, which ends with a synchronise, under
    torch.profiler inside the ``hmcbench.call`` span; ``mark_draws()``
    (called by ``fn`` at the warmup's end, after a synchronise) opens the
    ``hmcbench.draws`` span.
    Returns (fn's result, TraceRecord)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    draws = record_function(DRAWS)
    opened = []

    def mark_draws():
        draws.__enter__()
        opened.append(True)

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(CALL):
            out = fn(mark_draws)  # ends with a synchronise
            if opened:
                draws.__exit__(None, None, None)
    events = prof.profiler.kineto_results.events()
    # the spans as the host opened them (the profiler also draws each on
    # the device's timeline, from its first kernel to its last)
    spans = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events if e.name() in (CALL, DRAWS)
             and e.device_type() != DeviceType.CUDA}
    t0, t1 = spans[CALL]
    device, host = [], []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= t0 or a >= t1 or e.name().startswith("hmcbench."):
            continue
        item = (e.name(), (max(a, t0) - t0) * 1e-9, (min(b, t1) - t0) * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            device.append(item)
        else:
            host.append(item)
    draws_start = ((spans[DRAWS][0] - t0) * 1e-9 if DRAWS in spans else None)
    return out, TraceRecord(device=device, host=host,
                            window_s=(t1 - t0) * 1e-9,
                            draws_start_s=draws_start)
