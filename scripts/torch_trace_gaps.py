#!/usr/bin/env python3
"""Put the card's longest idle gaps in one run_chains call down to the
program's spans.

    python3 scripts/torch_trace_gaps.py [--cell gauss100_dense.fleet16k]
        [--seed N] [--out DIR] [--top 10]

Builds a benchmark cell's model (hmcbench's configuration and data), warms
its shapes up with the cell's short warm-up call, times one call without
a profiler, then runs one call under ``profiling.trace`` and reads the
Chrome trace it writes: the device's busy intervals (kernels, copies and
fills; the spans' own device-side ranges left out), the gaps between them
inside the call, and for each gap the innermost ``dhmc.*`` span and host
operator open at its start. Prints one JSON line: both walls, the
``ops.launch_counts()`` of the traced call, and the ``--top`` longest
gaps of the warmup and of the whole call. The trace (hundreds of MB at a
cell's size) stays in ``--out``, by default profiling.trace's directory
under the temporary directory. Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(events, t):
    """The name of the latest-starting event open at ``t``, or None."""
    best = None
    for name, a, b in events:
        if a <= t < b and (best is None or a >= best[1]):
            best = (name, a)
    return None if best is None else best[0]


def gaps(path: str, top: int) -> dict:
    """The call's idle gaps in the Chrome trace at ``path``, longest first,
    each [microseconds, start in ms from the call's start, innermost
    dhmc.* span, innermost host operator]."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = [(e["name"].split("#")[0], e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("dhmc.")]
    call = [s for s in spans if s[0] == "dhmc.run_chains"][-1]
    warmup = [s for s in spans if s[0] == "dhmc.warmup"
              and call[1] <= s[1] < call[2]]
    ops = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "cpu_op" and call[1] <= e["ts"] < call[2]]
    busy = _union([(max(e["ts"], call[1]), min(e["ts"] + e["dur"], call[2]))
                   for e in events if e.get("cat") in DEVICE_CATS
                   and e["ts"] < call[2] and e["ts"] + e["dur"] > call[1]])
    idle, t = [], call[1]
    for a, b in busy + [[call[2], call[2]]]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    inside = [s for s in spans if call[1] <= s[1] < call[2]]

    def row(gap):
        a, b = gap
        return [round(b - a, 1), round((a - call[1]) / 1e3, 3),
                _innermost(inside, a), _innermost(ops, a)]

    def in_warmup(gap):
        return any(w[1] <= gap[0] < w[2] for w in warmup)

    longest = sorted(idle, key=lambda g: g[0] - g[1])
    window = call[2] - call[1]
    busy_us = sum(b - a for a, b in busy)
    return {"window_ms": window / 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 100.0 * (1 - busy_us / window),
            "warmup_gaps": [row(g) for g in
                            [g for g in longest if in_warmup(g)][:top]],
            "gaps": [row(g) for g in longest[:top]]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cell", default="gauss100_dense.fleet16k")
    parser.add_argument("--seed", type=int, default=2**31 + 211)
    parser.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "dynamichmc_tpu_torch_trace"))
    parser.add_argument("--top", type=int, default=10)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from dynamichmc_tpu_torch import profiling
    from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts
    from hmcbench import harness, program

    device = torch.device("cuda", 0)
    cell = harness.Cell(args.cell, device, ROOT)
    cell.call(args.seed, -1, warm=True)
    chains, draws = int(cell.workload["chains"]), int(cell.workload["draws"])

    def one(index):
        generator = torch.Generator(device=device).manual_seed(
            args.seed + index)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        program.run_chains(generator, cell.model, chains, draws,
                           cell.options, None)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain_s = one(0)
    os.makedirs(args.out, exist_ok=True)
    before = set(os.listdir(args.out))
    with profiling.trace(args.out):
        traced_s = one(1)
    counts = launch_counts()
    (name,) = set(os.listdir(args.out)) - before
    out = {"cell": args.cell, "device": torch.cuda.get_device_name(device),
           "plain_wall_s": plain_s, "traced_wall_s": traced_s,
           "trace": os.path.join(args.out, name),
           **gaps(os.path.join(args.out, name), args.top),
           "launch_counts": counts}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
