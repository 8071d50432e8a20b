#!/usr/bin/env python3
"""Host time, device time and output digests of the fused Gaussian leaf
(K2) and leapfrog (K4), for the package of any checkout.

    python3 scripts/torch_gaussian_leaf_compare.py [--root DIR] [--parts host,time,plans,digest]

``--root`` names the checkout whose ``dynamichmc_tpu_torch`` is imported
(default: this one), so that one call can run this tree's kernels beside
another commit's unpacked with ``git archive``, in turns. The inputs,
timing and bounds come from this checkout's ``chip_smoke.py``. Needs CUDA.
Prints one JSON line per measurement, each with the nvidia-smi name and
power limit.

1. ``host``: microseconds of host time per call (``time.perf_counter_ns``,
   the median of 5 rounds of 2000 calls, no synchronisation inside a
   round) of each step of a launch as the parent's ``launch()`` and hooks
   take them (the operand checks, the library lock, five allocations, the
   current stream, the 14 pointers, the ctypes call with and without a
   kernel launch) and of the operations a leaner launch path could use in
   their place; then of the whole ``launch()``, wrapper and hook of the
   imported package. At 1 x 25 (K4's shape on the per_chain path) and
   4096 x 25 (K2's on gauss_fused).
2. ``time``: per call, the wrapper (CUDA events over 200 back-to-back
   calls, as chip_smoke's phase 5) and the kernel's own device time
   (torch.profiler), with the bound, at K2 4096 x 25 and 4096 x 100, K4
   1 x 25 and 4096 x 25, the two hooks as the paths call them (K2's at
   4096 x 25 with a per-chain diagonal, K4's at 1 x 25 on one chain's (K,)
   tensors and a 0-d eps with a shared diagonal) and the wrapper at
   C = 1, K = 1; the launch plan where the package has one.
3. ``plans``: K2's and K4's device time at the phase-5 shapes and at
   1 x 1 under every launch plan of R in {1, 8} chains a warp, 1-8 warps
   a CTA, prec and L staged or read through L1/L2, where the imported
   package has a launch plan.
4. ``digest``: the SHA-256 of every output of K2 and K4 on fixed inputs at
   the shapes of the tests and of chip_smoke's phase 3, so that two
   checkouts' outputs can be held bit for bit against each other.
"""

import argparse
import hashlib
import importlib.util
import itertools
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS, CALLS = 5, 2000
N_TIME, N_DEVICE = 200, 50
DIGEST_SHAPES = [  # (C, K, metric form)
    (1, 1, "shared_diag"), (1, 25, "shared_diag"), (7, 25, "chain_diag"),
    (31, 25, "chain_diag"), (33, 25, "shared_diag"), (4096, 25, "chain_diag"),
    (4096, 25, "shared_diag"), (4096, 31, "chain_diag"),
    (4096, 32, "chain_diag"), (4096, 33, "shared_diag"),
    (4096, 100, "chain_diag"), (1, 100, "shared_diag"), (64, 130, "shared_diag"),
    (4096, 150, "chain_diag"), (4096, 160, "chain_diag"),
    (4096, 166, "chain_diag"), (4096, 167, "chain_diag"),
    (16, 200, "chain_diag"), (1025, 256, "shared_diag"),
]


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_us(fn, sync=False):
    """Median over ROUNDS of the host microseconds per call of ``fn()``."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter_ns()
        for _ in range(CALLS):
            fn()
        rounds.append((time.perf_counter_ns() - t0) / CALLS / 1e3)
        if sync:
            torch.cuda.synchronize()
    return statistics.median(rounds)


def model_for(K, dev):
    from dynamichmc_tpu_torch.models import correlated_gaussian, mvnormal

    if K in (1, 25):
        return mvnormal(np.zeros(K), np.eye(K), dtype=torch.float32,
                        device=dev, fused=True)
    return correlated_gaussian(K, dtype=torch.float32, device=dev, fused=True)


def host_steps(chip, dev, C, K):
    """Part 1 at (C, K): the parent's launch steps one by one, candidate
    replacements, and the imported package's whole functions."""
    from dynamichmc_tpu_torch.hamiltonian import EvaluatedPoint, PhasePoint
    from dynamichmc_tpu_torch.metric import DiagonalMetric
    from dynamichmc_tpu_torch.ops import gaussian_leaf, gaussian_leapfrog

    model = model_for(K, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    kind = "shared_diag" if C == 1 else "chain_diag"
    args = chip.gaussian_leaf_inputs(model, C, kind, gen)
    metric, q, p, g, eps, prec, lchol, mu = args
    minv = metric.m_inv
    lib = gaussian_leaf.library.load()
    leaf_fn = lib.gaussian_leaf_f32
    outs = [torch.empty_like(q) for _ in range(3)]
    rows = [torch.empty((C,), dtype=q.dtype, device=dev) for _ in range(2)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (q, p, g, minv)]
    ptrs2 = [t.data_ptr() for t in (eps, prec, lchol, mu, *outs, *rows)]
    chain_minv = int(minv.ndim == 2)

    def check_tensors():
        tensors = {"q": q, "p": p, "g": g, "m_inv": minv, "eps_signed": eps,
                   "prec": prec, "lchol": lchol, "mu": mu}
        for _name, t in tensors.items():
            if t.device != q.device or not t.is_contiguous():
                raise ValueError
            if t.dtype != torch.float32:
                raise TypeError

    def check_shapes():
        shapes = {"p": (p, (C, K)), "g": (g, (C, K)), "eps_signed": (eps, (C,)),
                  "prec": (prec, (K, K)), "lchol": (lchol, (K, K)),
                  "mu": (mu, (K,))}
        for _name, (t, shape) in shapes.items():
            if tuple(t.shape) != shape:
                raise ValueError

    def alloc_5():
        [torch.empty_like(q) for _ in range(3)]
        [torch.empty((C,), dtype=q.dtype, device=q.device) for _ in range(2)]

    def views_5(buf):
        n = C * K
        return (buf[:n].view(C, K), buf[n:2 * n].view(C, K),
                buf[2 * n:3 * n].view(C, K), buf[3 * n:3 * n + C], buf[3 * n + C:])

    steps = {
        # the parent's launch(), step by step
        "launch: metric type and m_inv shape": lambda: (
            isinstance(metric, DiagonalMetric)
            and tuple(minv.shape) in ((K,), (C, K))),
        "launch: 8 tensors' device, contiguity, dtype": check_tensors,
        "launch: 6 shapes": check_shapes,
        "launch: library.load() (lock)": gaussian_leaf.library.load,
        "launch: 5 torch.empty": alloc_5,
        "launch: torch.cuda.current_stream(q.device)": lambda: (
            torch.cuda.current_stream(q.device).cuda_stream),
        "launch: 14 data_ptr()": lambda: [
            t.data_ptr() for t in (q, p, g, minv, eps, prec, lchol, mu, *outs,
                                   *rows)],
        # single operations a leaner launch path may use
        "op: q.device": lambda: q.device,
        "op: q.is_cuda": lambda: q.is_cuda,
        "op: q.dtype": lambda: q.dtype,
        "op: q.shape": lambda: q.shape,
        "op: q.is_contiguous()": q.is_contiguous,
        "op: q.data_ptr()": q.data_ptr,
        "op: q.contiguous() (already contiguous)": q.contiguous,
        "op: q.reshape(-1, K)": lambda: q.reshape(-1, K),
        "op: DiagonalMetric(m_inv, None)": lambda: DiagonalMetric(m_inv=minv,
                                                                  w_diag=None),
        "op: torch.empty((3 C K + 2 C,))": lambda: torch.empty(
            (3 * C * K + 2 * C,), dtype=torch.float32, device=dev),
        "op: torch.empty((3, C, K)).unbind(0)": lambda: torch.empty(
            (3, C, K), dtype=torch.float32, device=dev).unbind(0),
        "op: torch.empty_like(q)": lambda: torch.empty_like(q),
        "op: one buffer viewed as the 5 outputs": lambda: views_5(torch.empty(
            (3 * C * K + 2 * C,), dtype=torch.float32, device=dev)),
        "op: torch.empty((2, C)).unbind(0)": lambda: torch.empty(
            (2, C), dtype=torch.float32, device=dev).unbind(0),
        "op: torch.cuda.current_stream().cuda_stream": lambda: (
            torch.cuda.current_stream().cuda_stream),
    }
    launching = set()
    if len(leaf_fn.argtypes) == 17:  # the parent's C interface
        steps["launch: ctypes call, no kernel (K = 0)"] = lambda: leaf_fn(
            *ptrs, chain_minv, *ptrs2, C, 0, stream)
        steps["launch: ctypes call with the kernel launch"] = lambda: leaf_fn(
            *ptrs, chain_minv, *ptrs2, C, K, stream)
    if hasattr(gaussian_leaf, "KernelOperands"):  # the bound launch path
        kernels = model.fused_leaf_batched_fn.operands.kernels
        plan = gaussian_leaf.launch_plan(C, K, gaussian_leaf.sm_count(dev.index))
        new_args = [*ptrs, ptrs2[0], *kernels.pointers, *ptrs2[4:], C, K,
                    chain_minv, plan.R, plan.warps, int(plan.staged), stream]
        no_kernel = list(new_args)
        no_kernel[13] = 0  # C = 0: refused before the launch
        steps.update({
            "new: launch_plan (cached)": lambda: gaussian_leaf.launch_plan(
                C, K, gaussian_leaf.sm_count(dev.index)),
            "new: 5 empty_like": lambda: (
                torch.empty_like(q), torch.empty_like(q), torch.empty_like(q),
                torch.empty_like(eps), torch.empty_like(eps)),
            "new: ctypes call, no kernel (C = 0)": lambda: leaf_fn(*no_kernel),
            "new: ctypes call with the kernel launch": lambda: leaf_fn(*new_args),
            "new: KernelOperands.launch, K2": lambda: kernels.launch(
                0, minv, q, p, g, eps),
        })
        launching |= {"new: ctypes call with the kernel launch",
                      "new: KernelOperands.launch, K2"}
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        steps["op: torch._C._cuda_getCurrentRawStream(index)"] = lambda: (
            torch._C._cuda_getCurrentRawStream(0))
    launching.add("launch: ctypes call with the kernel launch")

    # the parent's hooks' own steps
    leaf_hook = model.fused_leaf_batched_fn
    ops = leaf_hook.operands
    steps.update({
        "K2 hook: takes_kernel": lambda: ops.takes_kernel(metric, q.dtype),
        "K2 hook: DiagonalMetric + 5 contiguous()": lambda: (
            DiagonalMetric(m_inv=minv.contiguous(), w_diag=None),
            q.contiguous(), p.contiguous(), g.contiguous(), eps.contiguous()),
    })
    q1, p1, g1 = q[0], p[0], g[0]
    e0 = eps[0]
    z = PhasePoint(Q=EvaluatedPoint(q=q1, logdensity=e0, grad=g1), p=p1)
    shape1 = q1.shape

    def k4_eps():
        e = torch.as_tensor(e0, dtype=q1.dtype, device=q1.device)
        return e.reshape(-1).expand(1).contiguous()

    def k4_wrap():
        return PhasePoint(
            Q=EvaluatedPoint(q=q1.reshape(shape1),
                             logdensity=e0.reshape(shape1[:-1]),
                             grad=g1.reshape(shape1)),
            p=p1.reshape(shape1))

    steps.update({
        "K4 hook: 3 reshape(-1, K)": lambda: [
            t.reshape(-1, K) for t in (z.Q.q, z.p, z.Q.grad)],
        "K4 hook: eps as_tensor/reshape/expand/contiguous": k4_eps,
        "K4 hook: DiagonalMetric + 4 contiguous()": lambda: (
            DiagonalMetric(m_inv=minv.contiguous(), w_diag=None),
            q1.contiguous(), p1.contiguous(), g1.contiguous()),
        "K4 hook: 4 reshapes + PhasePoint + EvaluatedPoint": k4_wrap,
    })

    # the imported package's whole functions
    wrappers = {
        "whole: launch() K2": lambda: gaussian_leaf.launch(
            "gaussian_leaf_f32", *args),
        "whole: gaussian_leaf wrapper": lambda: gaussian_leaf.gaussian_leaf(*args),
        "whole: gaussian_leapfrog wrapper": lambda: (
            gaussian_leapfrog.gaussian_leapfrog(*args)),
        "whole: K2 hook": lambda: leaf_hook(metric, q, p, g, eps),
    }
    if C == 1:
        step_hook = model.fused_leapfrog_fn
        wrappers["whole: K4 hook on (K,) tensors, 0-d eps"] = lambda: step_hook(
            metric, z, e0)
    steps.update(wrappers)
    launching |= set(wrappers)
    for name, fn in steps.items():
        yield name, host_us(fn, sync=name in launching)


def plan_of(gaussian_leaf, C, K):
    """The launch plan of (C, K), where the imported package has one."""
    if not hasattr(gaussian_leaf, "launch_plan"):
        return None
    plan = gaussian_leaf.launch_plan(C, K)
    return {f: getattr(plan, f) for f in plan.__dataclass_fields__}


def timing(chip, dev):
    """Part 2: wrapper and device time per call at each shape."""
    from dynamichmc_tpu_torch.hamiltonian import EvaluatedPoint, PhasePoint
    from dynamichmc_tpu_torch.ops import gaussian_leaf, gaussian_leapfrog

    gen = torch.Generator(device=dev).manual_seed(2)
    leaf, step = gaussian_leaf.gaussian_leaf, gaussian_leapfrog.gaussian_leapfrog
    cases = [  # name, fn, write_pi, C, K, metric form, hook
        ("K2 wrapper", leaf, True, 4096, 25, "chain_diag", None),
        ("K2 wrapper", leaf, True, 4096, 100, "chain_diag", None),
        ("K4 wrapper", step, False, 1, 25, "shared_diag", None),
        ("K4 wrapper", step, False, 4096, 25, "chain_diag", None),
        ("K2 hook", leaf, True, 4096, 25, "chain_diag", "leaf"),
        ("K4 hook", step, False, 1, 25, "shared_diag", "leapfrog"),
        ("K2 wrapper", leaf, True, 1, 1, "shared_diag", None),
    ]
    for name, fn, write_pi, C, K, kind, hook in cases:
        model = model_for(K, dev)
        args = chip.gaussian_leaf_inputs(model, C, kind, gen)
        call, call_args = fn, args
        if hook == "leaf":
            call = model.fused_leaf_batched_fn
            call_args = args[:5]
        elif hook == "leapfrog":
            metric, q, p, g, eps = args[:5]
            z = PhasePoint(Q=EvaluatedPoint(q=q[0], logdensity=eps[0], grad=g[0]),
                           p=p[0])
            call = model.fused_leapfrog_fn
            call_args = (metric, z, eps[0])
        ms = chip.time_call(call, call_args, N_TIME)
        dev_ms = chip.device_ms(call, call_args, N_DEVICE, "gaussian_leaf_kernel")
        bound_ms, bound_by = chip.gaussian_bound(args, write_pi)
        yield {"time": name, "shape": [C, K, kind], "ms": ms,
               "device_ms": dev_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "plan": plan_of(gaussian_leaf, C, K)}


def plans(chip, dev):
    """Part 3: the device time of K2's and K4's kernels under other launch
    plans than the imported package's own (the C entry points called
    directly): R in {1, 8} chains a warp, 1-8 warps a CTA, prec and L
    staged (where they fit) or read through L1/L2."""
    from dynamichmc_tpu_torch.ops import gaussian_leaf

    if not hasattr(gaussian_leaf, "launch_plan"):
        return
    lib = gaussian_leaf.library.load()
    gen = torch.Generator(device=dev).manual_seed(3)
    for entry, C, K, kind in ((0, 4096, 25, "chain_diag"),
                              (1, 4096, 25, "chain_diag"),
                              (0, 4096, 100, "chain_diag"),
                              (1, 1, 25, "shared_diag"),
                              (0, 1, 1, "shared_diag")):
        args = chip.gaussian_leaf_inputs(model_for(K, dev), C, kind, gen)
        metric, q, p, g, eps, prec, lchol, mu = args
        own = gaussian_leaf.launch_plan(C, K, gaussian_leaf.sm_count(dev.index))
        outs = [torch.empty_like(q) for _ in range(3)] + [
            torch.empty_like(eps) for _ in range(2 - entry)]
        fn = getattr(lib, gaussian_leaf.ENTRIES[entry])
        for R, warps, staged in itertools.product((1, 8), (1, 2, 4, 8),
                                                  (1, 0)):
            smem = gaussian_leaf.smem_bytes(K, R * warps, staged)
            if smem > gaussian_leaf.MAX_SMEM_BYTES or R * warps > 8 * C:
                continue
            call = [t.data_ptr() for t in (
                q, p, g, metric.m_inv, eps, prec, lchol, mu, *outs)]
            call += [C, K, int(metric.m_inv.ndim == 2), R, warps, staged,
                     torch.cuda.current_stream(dev).cuda_stream]
            assert fn(*call) == 0
            try:
                ms = chip.device_ms(lambda: fn(*call), (), N_DEVICE,
                                    "gaussian_leaf_kernel")
            except chip.PhaseFailed:  # the profiler lost the launches
                ms = None
            yield {"plan_ms": gaussian_leaf.ENTRIES[entry],
                   "shape": [C, K, kind], "R": R, "warps": warps,
                   "staged": staged, "ctas": -(-C // (R * warps)),
                   "own": (R, warps, staged) == (
                       own.R, own.warps, int(own.staged)),
                   "device_ms": ms}


def digests(chip, dev):
    """Part 4: the SHA-256 of K2's and K4's outputs at each digest shape."""
    from dynamichmc_tpu_torch.ops import gaussian_leaf, gaussian_leapfrog

    for C, K, kind in DIGEST_SHAPES:
        model = model_for(K, dev)
        gen = torch.Generator(device=dev).manual_seed(1000 * K + C)
        args = chip.gaussian_leaf_inputs(model, C, kind, gen)
        for name, fn in (("K2", gaussian_leaf.gaussian_leaf),
                         ("K4", gaussian_leapfrog.gaussian_leapfrog)):
            out = fn(*args)
            torch.cuda.synchronize()
            h = hashlib.sha256()
            for t in out:
                h.update(t.cpu().numpy().tobytes())
            yield {"digest": name, "shape": [C, K, kind],
                   "sha256": h.hexdigest()[:16]}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--parts", default="host,time,plans,digest")
    opts = parser.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    chip = load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    from dynamichmc_tpu_torch.ops import gaussian_leaf

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gaussian_leaf.library.build()
    tag = {"root": os.path.relpath(root, HERE), "gpu": chip.nvidia_smi_line()}
    parts = opts.parts.split(",")
    if "host" in parts:
        for C, K in ((1, 25), (4096, 25)):
            line = dict(host_steps(chip, dev, C, K))
            print(json.dumps({"host_us": [C, K], "steps": line, **tag}),
                  flush=True)
    if "time" in parts:
        for line in timing(chip, dev):
            print(json.dumps({**line, **tag}), flush=True)
    if "plans" in parts:
        for line in plans(chip, dev):
            print(json.dumps({**line, **tag}), flush=True)
    if "digest" in parts:
        for line in digests(chip, dev):
            print(json.dumps({**line, **tag}), flush=True)


if __name__ == "__main__":
    main()
