"""One run of one cell: set-up, the window (or one traced call), the
metrics, the check.

Set-up builds the configuration's data (the reference's), the port's model
on the device from it, and warms up the cell's own shapes with one short
run_chains call at the cell's chains, dimension and route, then reads that
call as the window's calls are read. The window then drives run_chains
(window.py); each call has its own generator on the device, seeded from
``--seed`` and the call's index.
"""

from __future__ import annotations

import sys
import time
import traceback

import torch

from . import checks, program, registry, trace as tracing
from .reference import ess
from .window import CallRecord, RunRecord, call_seed, run_window


class TraceError(RuntimeError):
    """The traced call's trace names none of a kernel the cell runs."""


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def frozen_chains(positions: torch.Tensor, block: int = 1024) -> int:
    """Chains whose draws never move: every draw equal to the first."""
    frozen = 0
    for lo in range(0, positions.shape[0], block):
        x = positions[lo:lo + block]
        frozen += int((x == x[:, :1]).flatten(1).all(1).sum())
    return frozen


class Cell:
    """A cell set up on ``device``: its files, the reference's data and
    target, and the port's model built from that data."""

    def __init__(self, name: str, device, root: str = registry.ROOT):
        self.reg = registry.Registry(root)
        self.entry = self.reg.cell_entry(name)
        self.workload = self.reg.workload(name)
        self.config = self.reg.config(self.workload["config"])
        self.device = torch.device(device)
        model = self.config["model"]
        self.reference = registry.reference(model)
        self.data = self.reference.make_data(self.config)
        self.model = registry.target(model).build(
            self.config, self.data, self.workload.get("model_options", {}),
            self.device)
        self.options = program.run_options(self.config, self.workload,
                                           self.config["warmup"])
        warm = self.workload["warmup_call"]
        self.warm_options = program.run_options(self.config, self.workload,
                                                warm["warmup"])
        self.warm_draws = int(warm["draws"])
        self.target = self.moments = None

    def call(self, seed: int, index: int, traced: bool = False,
             warm: bool = False):
        """One run_chains call; returns (CallRecord, checks.Samples or None,
        TraceRecord or None). The wall runs from the call's entry to the
        synchronise after it returns; the rest is outside the clock."""
        options = self.warm_options if warm else self.options
        chains = int(self.workload["chains"])
        draws = self.warm_draws if warm else int(self.workload["draws"])
        n_stages = len(options["warmup_stages"])
        generator = torch.Generator(device=self.device).manual_seed(
            call_seed(seed, index))
        last = {}

        def timed(mark_draws=None):
            def sink(checkpoint):
                if checkpoint.stage == n_stages:
                    last["checkpoint"] = checkpoint
                    if mark_draws is not None:
                        synchronize(self.device)
                        last["warm_end"] = time.perf_counter()
                        mark_draws()

            synchronize(self.device)
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            program.reset_launch_counts()
            t0 = last["start"] = time.perf_counter()
            try:
                result = program.run_chains(generator, self.model, chains,
                                            draws, options, sink)
            except Exception as err:  # the run goes on and reports it
                traceback.print_exc(file=sys.stderr)
                result = err
            synchronize(self.device)
            last["wall"] = time.perf_counter() - t0
            return result

        trace = None
        if traced:
            result, trace = tracing.profile(timed)
        else:
            result = timed()
        record = CallRecord(wall_s=last["wall"],
                            launches=program.launch_counts())
        if self.device.type == "cuda":
            record.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))
        if "warm_end" in last:
            record.warmup_s = last["warm_end"] - last["start"]
        if isinstance(result, Exception):
            record.failure = f"raised {type(result).__name__}: {result}"
            return record, None, trace
        t0 = time.perf_counter()
        samples = self.read(result, last.get("checkpoint"), record,
                            call_seed(seed, index, stream=1))
        del result
        record.read_s = time.perf_counter() - t0
        return record, samples, trace

    def read(self, result, checkpoint, record: CallRecord, sample_seed: int):
        """Read one call's draws into ``record`` (failure, bulk ESS, steps)
        and take the check's samples; then the draws can go."""
        positions = result.positions
        C, N, _ = positions.shape
        record.n_draws = C * N
        record.draw_steps = int(result.tree_statistics.steps.sum())
        eps = torch.as_tensor(result.eps)
        if not (bool(torch.isfinite(positions).all())
                and bool(torch.isfinite(result.logdensities).all())):
            record.failure = "non-finite draws"
        elif not bool(((eps > 0) & torch.isfinite(eps)).all()):
            record.failure = "a stepsize that is not finite and positive"
        else:
            frozen = frozen_chains(positions)
            if frozen:
                record.failure = f"{frozen} chains never moved"
        if record.failure is None:
            min_ess = float(ess.ess_bulk(positions).min())
            record.min_ess = min_ess
            if not min_ess > 0 or min_ess == float("inf"):
                record.failure = f"bulk ESS {min_ess}"
        generator = torch.Generator().manual_seed(sample_seed)
        return checks.take_samples(result, checkpoint,
                                   int(self.workload["check_draws"]),
                                   generator, record.min_ess)

    def free_program(self) -> None:
        """Drop the port's model, so the reference runs on a freed device."""
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, samples, calls, source: str = "program"):
        """(correct, numbers beside their limits) for the samples kept."""
        if self.target is None:
            self.target = self.reference.make_target(self.data, self.device,
                                                     self.config)
            self.moments = self.reference.posterior_moments(self.target,
                                                            self.config)
        values = checks.numbers([s for s in samples if s is not None],
                                self.target, self.device, source,
                                self.moments)
        failed = sum(c.failed for c in calls)
        return checks.verdict(values, self.workload["limits"], len(calls),
                              failed)


def device_info(device, chips: int, peak_bytes: int) -> dict:
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": kind, "count": chips, "memory_peak_bytes": peak_bytes}


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, root: str = registry.ROOT):
    """One run of cell ``name``: the result line's object, its checks last.
    ``t_start``: the process's start on ``time.perf_counter``'s clock."""
    cell = Cell(name, device, root)
    record, _, _ = cell.call(seed, -1, warm=True)
    if record.failed:
        print(f"the warm-up call failed: {record.failure}", file=sys.stderr)
    synchronize(cell.device)
    setup_s = time.perf_counter() - t_start

    kept, trace = [], None
    if traced:
        record, samples, trace = cell.call(seed, 0, traced=True)
        calls = [record]
        kept.append(samples)
    else:
        def one(index: int) -> CallRecord:
            record, samples, _ = cell.call(seed, index)
            kept.append(samples)
            return record

        calls = run_window(one, seconds)
    peak = max(c.peak_bytes for c in calls)
    run = RunRecord(cell=cell.workload, config=cell.config,
                    reference=cell.reference, setup_s=setup_s, calls=calls,
                    trace=trace)
    metrics = {}
    for metric in cell.reg.metrics(name, traced):
        value = cell.reg.reader(metric["name"])(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    if traced:
        for pattern in cell.workload["kernels"]:
            if not trace.kernels(pattern):
                raise TraceError(f"the trace holds no kernel named like "
                                 f"{pattern!r}: the profiler recorded "
                                 f"{len(trace.device)} device operations")
    cell.free_program()
    t0 = time.perf_counter()
    correct, lines = cell.check(kept, calls)
    print(f"{len(calls)} calls, window {run.window_s:.3f} s, reading the "
          f"draws {sum(c.read_s for c in calls):.3f} s, the check "
          f"{time.perf_counter() - t0:.3f} s; walls "
          f"{[round(c.wall_s, 3) for c in calls]}", file=sys.stderr)
    chips = int(cell.entry["chips"])
    result = {"correct": correct, "attempted": len(calls),
              "failed": sum(c.failed for c in calls), "metrics": metrics,
              "device": device_info(cell.device, chips, peak)}
    if traced:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    for c in calls:
        if c.failed:
            print(f"a call failed: {c.failure}", file=sys.stderr)
    result["checks"] = lines
    return result


def stray_modules(forbidden=("jax", "jaxlib", "flax", "dynamichmc_tpu")):
    """Loaded modules whose top-level name is one of ``forbidden``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(forbidden))
