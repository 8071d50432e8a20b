"""Performance tracing and transition benchmarks (port of
``dynamichmc_tpu.profiling``).

``trace`` records a ``torch.profiler`` trace (the host's operators, the
``dhmc.*`` spans of ``run_chains`` and, on a GPU, every kernel the card
ran) and writes it as a Chrome trace, which ``chrome://tracing``,
Perfetto or TensorBoard open. ``benchmark`` times a callable with its
first call apart from the steady state. ``transition_throughput``
measures leapfrog gradient evaluations per second of one NUTS transition
over a batch of chains: the package's own measure of its hot path. The
numerical trajectory tracers live in diagnostics.py.

The program's spans and counters (:func:`span`, :func:`count_transition`,
:func:`host_read`) are read through ``ops.launch_counts()``. With no
torch.profiler session active a span is one shared no-op context: no
clock read, no ``record_function``, no device operation and no host read.
Under any profiler it adds its duration and one count to an aggregate by
name and phase; only inside :func:`trace` does it also open a
``record_function``, so that it lies on the profiler's timeline beside
the kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import tempfile
import time
from typing import Callable, Optional

import torch
from torch.autograd import _profiler_enabled

CALL_SPAN = "dhmc.run_chains"
PHASE_SPANS = {"dhmc.warmup": "warmup", "dhmc.draws": "draws"}
# steps tensors kept a phase before they are summed into one, on their
# device: a run's 900 warmup transitions stay far below it
KEEP_LIMIT = 4096


class _Record:
    """What the program counted since ``ops.reset_launch_counts()``: one
    per process, as the kernels' launch counts are. ``phase`` is the
    innermost open phase span's ("call" outside both), ``mirror`` the
    :func:`trace` contexts open, ``calls`` the ``dhmc.run_chains`` spans
    drawn on a trace's timeline (their ordinal)."""

    def __init__(self):
        self.phase = "call"
        self.mirror = 0
        self.calls = 0
        self.reset()

    def reset(self) -> None:
        self.transitions = {"warmup": 0, "draws": 0}
        self.host_reads = {}
        self.spans = {}  # name -> phase -> [count, ns]
        self.kept = {}  # phase -> steps tensors (under a profiler only)


_record = _Record()
_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "outer", "function", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.outer = _record.phase
        _record.phase = PHASE_SPANS.get(self.name, self.outer)
        self.function = None
        if _record.mirror:
            label = self.name
            if label == CALL_SPAN:
                _record.calls += 1
                label = f"{CALL_SPAN}#{_record.calls}"
            self.function = torch.profiler.record_function(label)
            self.function.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.function is not None:
            self.function.__exit__(*exc)
        entry = _record.spans.setdefault(self.name, {}).setdefault(
            _record.phase, [0, 0])
        entry[0] += 1
        entry[1] += ns
        _record.phase = self.outer
        return False


def span(name: str):
    """A context around one piece of the program named ``name``
    (``dhmc.*``): the shared no-op context while no torch.profiler session
    is active; else it adds its host-clock duration and one count to
    ``name``'s aggregate under the enclosing phase (``warmup`` inside
    ``dhmc.warmup``, ``draws`` inside ``dhmc.draws``, else ``call``), and
    inside :func:`trace` opens ``torch.profiler.record_function(name)``
    (``dhmc.run_chains#<n>`` for the n-th call on a trace's timeline)."""
    if not _profiler_enabled():
        return _NOOP
    return _Span(name)


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count_transition(phase: str, steps: Optional[torch.Tensor] = None,
                     n: int = 1) -> None:
    """Count ``n`` batch transitions of ``phase`` ("warmup" or "draws").
    Under a profiler, keep a reference to ``steps`` (the transition's
    ``tree_statistics.steps``), summed only when the counts are read, so
    the call itself adds no device operation and no host read."""
    _record.transitions[phase] += n
    if steps is None or not _profiler_enabled():
        return
    kept = _record.kept.setdefault(phase, [])
    kept.append(steps)
    if len(kept) >= KEEP_LIMIT:
        kept[:] = [_steps_sum(kept)]


def _steps_sum(kept) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in kept]).sum(dtype=torch.int64)


def host_read(site: str) -> None:
    """Count one read of a device value to the host, or one
    synchronisation, at ``site`` (a short stable name). Counted on every
    device, so a CPU run counts the reads the card would make."""
    _record.host_reads[site] = _record.host_reads.get(site, 0) + 1


def host_bool(site: str, flag: torch.Tensor) -> bool:
    """``bool(flag)``, counted as a host read at ``site``."""
    host_read(site)
    return bool(flag)


def reset_counts() -> None:
    """Clear the counters, the span aggregates and the kept steps."""
    _record.reset()


def counts() -> dict:
    """The counters since :func:`reset_counts`: ``transitions_warmup``,
    ``transitions_draws`` and ``host_reads`` ({site: n}) always; where a
    profiler was active, ``spans`` ({name: {phase: {"count", "ns"}}}) and
    ``warmup_steps`` / ``draw_steps`` (the phase's leapfrog steps, summed
    here: one host read)."""
    out = {"transitions_warmup": _record.transitions["warmup"],
           "transitions_draws": _record.transitions["draws"],
           "host_reads": dict(_record.host_reads)}
    if _record.spans:
        out["spans"] = {
            name: {phase: {"count": c, "ns": ns}
                   for phase, (c, ns) in by_phase.items()}
            for name, by_phase in _record.spans.items()}
    for phase, key in (("warmup", "warmup_steps"), ("draws", "draw_steps")):
        if _record.kept.get(phase):
            out[key] = int(_steps_sum(_record.kept[phase]))
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a trace of everything inside the context; yields
    ``log_dir``, into which ``trace-<pid>-<ns>.json`` is written when the
    context closes. The program's ``dhmc.*`` spans are drawn on its
    timeline, nested as they ran, on the kernels' clock. The CUDA
    activity is recorded where a GPU is present:
    the device is synchronised as the context opens and before it closes,
    and one small kernel of the trace's own runs before the body, so that
    a trace that recorded no kernel at all is known to have lost the
    card's activity: it raises then, after writing the file (torch.profiler
    can do so in a long-running process, PERF.md §7). ``log_dir``
    defaults to ``dynamichmc_tpu_torch_trace`` under the temporary
    directory::

        with profiling.trace("traces") as d:
            run_chains(...)
    """
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "dynamichmc_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()  # earlier work stays out of the trace
    with torch.profiler.profile(activities=activities) as prof:
        if cuda:
            torch.zeros(1, device="cuda")  # a kernel every trace holds
        _record.mirror += 1
        try:
            yield log_dir
        finally:
            _record.mirror -= 1
        if cuda:
            torch.cuda.synchronize()  # the context's kernels end inside it
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if cuda and not any(e.device_type() == torch.autograd.DeviceType.CUDA
                        for e in prof.profiler.kineto_results.events()):
        raise RuntimeError(f"torch.profiler recorded no kernel on the card "
                           f"in {path}, not even the trace's own")


def _devices(out, found):
    """The CUDA devices of every tensor in ``out`` (tuples, lists, dicts
    and dataclasses searched)."""
    if torch.is_tensor(out):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _devices(x, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _devices(getattr(out, f.name), found)
    return found


def _block(out):
    """Wait for the work that produced ``out``: a synchronisation of each
    CUDA device its tensors lie on (the JAX package blocks on every output
    leaf). CPU tensors are ready when returned."""
    for device in _devices(out, set()):
        torch.cuda.synchronize(device)
    return out


def benchmark(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 2,
    name: Optional[str] = None,
    **kwargs,
):
    """Wall-clock ``fn(*args, **kwargs)`` with its first call apart from
    the steady state.

    Returns a dict: ``name``; ``first_call_seconds``, the first call; on
    the port that call also builds and loads each CUDA kernel it reaches
    for the first time in the process (nvcc and the library load), where
    the JAX package traces and compiles; ``compile_seconds``, the first
    call less one steady-state iteration; ``seconds_per_iteration``, the
    mean of ``iters`` calls after ``warmup`` in all; ``output``, the last
    call's output. Each timed region ends with a synchronisation of the
    CUDA devices the outputs lie on."""
    t0 = time.perf_counter()
    out = _block(fn(*args, **kwargs))
    first_call_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        _block(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _block(out)
    per_iter = (time.perf_counter() - t0) / iters
    return {
        "name": name or getattr(fn, "__name__", "fn"),
        "compile_seconds": max(first_call_s - per_iter, 0.0),
        "first_call_seconds": first_call_s,
        "seconds_per_iteration": per_iter,
        "output": out,
    }


def transition_throughput(
    ld,
    n_chains: int = 1024,
    eps: float = 0.2,
    iters: int = 5,
    dtype=None,
    generator: Optional[torch.Generator] = None,
):
    """NUTS transition throughput of a model at a chain batch: leapfrog
    gradient evaluations per second, the sum of the last transition's
    steps over the chains divided by the seconds a transition takes.

    The chains start at q ~ 0.1 N(0, I) with an identity metric and
    ``NUTS()``, as in the JAX package; each transition is one
    ``tree_batched.sample_tree_batched`` call, so a model's
    whole-transition kernel runs where it has one. ``generator`` draws the
    start and every transition's randomness, on its own device; the
    model's tensors must lie there. Without one, a generator seeded 0 is
    made on the model's device, or on ``"cuda"`` for a model that names
    none (a CPU measurement takes a CPU generator). Returns :func:`benchmark`'s dict without ``output``, plus
    ``grad_evals_per_second``."""
    from .hamiltonian import evaluate
    from .logdensity import check_device, resolve_device
    from .metric import identity_metric
    from .nuts import NUTS
    from .tree_batched import sample_tree_batched

    dtype = dtype or torch.float32
    if generator is None:
        device = resolve_device(ld.device if ld.device is not None else "cuda")
        generator = torch.Generator(device=device).manual_seed(0)
    device = generator.device
    check_device(ld, device)
    metric = identity_metric(ld.dim, dtype=dtype, device=device)
    q = torch.randn((n_chains, ld.dim), generator=generator, dtype=dtype,
                    device=device) * 0.1
    Q = evaluate(ld, q)
    algorithm = NUTS()

    def nuts_transition():
        return sample_tree_batched(generator, algorithm, ld, metric, Q, eps)

    res = benchmark(nuts_transition, iters=iters, name="nuts_transition")
    steps = int(res["output"][1].steps.to(torch.int64).sum())
    res["grad_evals_per_second"] = steps / res["seconds_per_iteration"]
    del res["output"]
    return res
