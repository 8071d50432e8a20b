"""Whole-transition NUTS kernel for Gaussian targets: build, binding, plain
version and the ``LogDensity.tree_transition_fn`` hook.

The kernel (csrc/tree_kernel.cu, CUDA C++ for sm_90a) replaces the Pallas
kernel ``dynamichmc_tpu/ops/pallas_tree.py::_build_kernel`` with its
``_gaussian_leaf``: one complete NUTS transition per chain, one CTA per
chain. It is compiled with ``nvcc`` at first use into a content-hashed
shared library under ``dynamichmc_tpu_torch/_build/`` and called through a
plain C entry point with ``ctypes``, on PyTorch's current stream.

:func:`tree_transition` is the wrapper. A tensor on the CPU goes to
:func:`tree_transition_plain`, the same transition computed by the plain
batched driver (tree_batched.py) from the same injected noise. A CUDA tensor
launches the kernel or raises; nothing falls back. ``launches`` counts the
kernel launches.

``work`` differs between the two on purpose: the kernel reports each
chain's own executed leaf count, the plain driver the lockstep count of the
whole batch. Every other output is the same transition.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

from ..hamiltonian import EvaluatedPoint
from ..logdensity import LogDensity
from ..metric import DenseMetric, DiagonalMetric, Metric
from ..nuts import NUTS
from ..tree import TreeNoise
from ..tree_batched import (
    depth_cap,
    exponential_like,
    finish_transition,
    gumbel_like,
    rand_p_b,
    random_directions,
    transition_raw,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "tree_kernel.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
MAX_THREADS = 1024  # one thread per coordinate, one CTA per chain
MAX_SMEM_BYTES = 232448  # H100: 227 KB of dynamic shared memory per CTA

launches = 0  # kernel launches made by tree_transition

_lock = threading.Lock()
_lib = None
build_log = ""  # compiler output of the last build (ptxas resource usage)


def reset_launches() -> None:
    global launches
    launches = 0


def smem_bytes(K: int, max_depth: int) -> int:
    """Dynamic shared memory of one CTA (smem_bytes in the
    CUDA source): the 5 x S x Kp merge stack, one staging vector and the
    reduction scratch."""
    kp = (K + 31) // 32 * 32
    return 4 * ((5 * max_depth + 1) * kp + 6 * 32)


def kernel_fits(K: int, max_depth: int) -> bool:
    return (K + 31) // 32 * 32 <= MAX_THREADS and (
        smem_bytes(K, max_depth) <= MAX_SMEM_BYTES
    )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or (
        "/usr/local/cuda"
    )
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the tree kernel is built from "
            "source at first use"
        )
    return found


def library_path() -> str:
    """Content-hashed library name: an edited source or flag set never loads
    a stale binary."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"tree_kernel-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile csrc/tree_kernel.cu for sm_90a if its library is missing;
    returns the library path. Raises with the compiler's output on
    failure."""
    global build_log
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.tree_transition_f32.argtypes = (
                [vp] * 9 + [ci] + [vp] * 13 + [ci] * 4
                + [ctypes.c_float, vp]
            )
            lib.tree_transition_f32.restype = ci
            _lib = lib
        return _lib


def _noise_from_rows(gum: torch.Tensor, expo: torch.Tensor,
                     max_depth: int) -> TreeNoise:
    """Kernel noise layout -> TreeNoise: gum row (1 << d) - 1 + n is
    gumbel[d, n]."""
    C = gum.shape[1]
    gumbel = torch.zeros((max_depth, 1 << (max_depth - 1), C),
                         dtype=gum.dtype, device=gum.device)
    for d in range(max_depth):
        gumbel[d, : 1 << d] = gum[(1 << d) - 1:(1 << (d + 1)) - 1]
    return TreeNoise(gumbel=gumbel, expo=expo)


def tree_transition_plain(q0, p0, g0, ld0, eps, dirs, gum, expo, minv,
                          prec_t, lchol, mu, dcap: int, min_delta: float,
                          max_depth: int) -> dict:
    """The kernel's transition computed by the plain batched driver.

    Arguments as for :func:`tree_transition`; returns the same raw fields
    (termination not normalized)."""

    def value_and_grad(q):
        # row form of the model's L^T d and prec d (models/gaussian.py)
        d = q - mu
        w = d @ lchol
        return -0.5 * (w * w).sum(-1), -(d @ prec_t)

    ld = LogDensity(dim=q0.shape[1], logdensity_fn=None,
                    logdensity_and_gradient_fn=value_and_grad)
    metric = (DiagonalMetric(m_inv=minv, w_diag=None) if minv.ndim == 1
              else DenseMetric(m_inv=minv, w=None))
    Q = EvaluatedPoint(q=q0, logdensity=ld0, grad=g0)
    return transition_raw(
        None, NUTS(max_depth=max_depth, min_delta=min_delta), ld, metric, Q,
        eps, directions=dirs, p=p0, noise=_noise_from_rows(gum, expo, max_depth),
        depth_limit=dcap,
    )


def tree_transition(q0, p0, g0, ld0, eps, dirs, gum, expo, minv, prec_t,
                    lchol, mu, dcap: int, min_delta: float,
                    max_depth: int) -> dict:
    """One NUTS transition of a Gaussian target for C chains.

    q0, p0, g0: (C, K); ld0, eps: (C,); dirs: (C,) int32 holding the uint32
    direction bits; gum: (2^max_depth - 1, C) Gumbel rows, row
    (1 << d) - 1 + n for doubling d and leaf n; expo: (max_depth, C);
    minv: shared M^-1, (K, K) dense or (K,) diagonal; prec_t = prec^T and
    lchol = L with prec = L L^T, both (K, K); mu: (K,); dcap in
    1..max_depth. All float32 except dirs.

    Returns the raw fields prop_q, prop_grad, prop_ld, prop_pi, depth,
    term_left, term_right, log_sum, steps, work, directions.
    """
    global launches
    if q0.device.type == "cpu":
        return tree_transition_plain(q0, p0, g0, ld0, eps, dirs, gum, expo,
                                     minv, prec_t, lchol, mu, dcap,
                                     min_delta, max_depth)
    if q0.device.type != "cuda":
        raise ValueError(f"tree kernel: unsupported device {q0.device}")
    C, K = q0.shape
    floats = (q0, p0, g0, ld0, eps, gum, expo, minv, prec_t, lchol, mu)
    for t in floats + (dirs,):
        if t.device != q0.device or not t.is_contiguous():
            raise ValueError("tree kernel: inputs must be contiguous tensors "
                             f"on {q0.device}")
    if any(t.dtype != torch.float32 for t in floats) or dirs.dtype != torch.int32:
        raise TypeError("tree kernel: float32 inputs and int32 dirs only")
    shapes = {
        "p0": (p0, (C, K)), "g0": (g0, (C, K)), "ld0": (ld0, (C,)),
        "eps": (eps, (C,)), "dirs": (dirs, (C,)),
        "gum": (gum, ((1 << max_depth) - 1, C)), "expo": (expo, (max_depth, C)),
        "prec_t": (prec_t, (K, K)), "lchol": (lchol, (K, K)), "mu": (mu, (K,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"tree kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if tuple(minv.shape) not in ((K,), (K, K)):
        raise ValueError("tree kernel: minv must be (K,) or (K, K)")
    if not (1 <= dcap <= max_depth) or not kernel_fits(K, max_depth):
        raise ValueError("tree kernel: dcap or shape outside the kernel")
    lib = load_library()
    f32, i32 = torch.float32, torch.int32
    qn = torch.empty((C, K), dtype=f32, device=q0.device)
    gn = torch.empty((C, K), dtype=f32, device=q0.device)
    rows = {n: torch.empty((C,), dtype=f32, device=q0.device)
            for n in ("prop_ld", "prop_pi", "log_sum")}
    ints = {n: torch.empty((C,), dtype=i32, device=q0.device)
            for n in ("depth", "term_left", "term_right", "steps", "work")}
    stream = torch.cuda.current_stream(q0.device).cuda_stream
    err = lib.tree_transition_f32(
        q0.data_ptr(), p0.data_ptr(), g0.data_ptr(), ld0.data_ptr(),
        eps.data_ptr(), dirs.data_ptr(), gum.data_ptr(), expo.data_ptr(),
        minv.data_ptr(), int(minv.ndim == 1), prec_t.data_ptr(),
        lchol.data_ptr(), mu.data_ptr(), qn.data_ptr(), gn.data_ptr(),
        rows["prop_ld"].data_ptr(), rows["prop_pi"].data_ptr(),
        ints["depth"].data_ptr(), ints["term_left"].data_ptr(),
        ints["term_right"].data_ptr(), rows["log_sum"].data_ptr(),
        ints["steps"].data_ptr(), ints["work"].data_ptr(),
        C, K, max_depth, int(dcap), float(min_delta), stream,
    )
    if err != 0:
        raise RuntimeError(f"tree kernel launch failed: CUDA error {err}")
    launches += 1
    return {"prop_q": qn, "prop_grad": gn, **rows, **ints, "directions": dirs}


def make_gaussian_tree_transition(prec: torch.Tensor, mu: torch.Tensor,
                                  prec_chol_t: torch.Tensor):
    """The ``tree_transition_fn`` hook of a Gaussian model:

    ``(generator, algorithm, metric, Q, eps, depth_limit) -> (Q', stats) |
    None``

    It declines (returns None, and the plain driver runs) for chains that
    are not float32, a turn statistic other than "generalized", a per-chain
    metric, or a K or max_depth whose CTA does not fit the card (more than
    1024 threads or 227 KB of shared memory). Otherwise it draws the
    momenta, direction bits, Gumbel rows and Exponential rows with the
    caller's generator on the chains' device and runs :func:`tree_transition`.
    """
    f32 = torch.float32
    prec_t = prec.to(f32).mT.contiguous()
    lchol = prec_chol_t.to(f32).mT.contiguous()
    mu32 = mu.to(f32).contiguous()

    def transition(generator: Optional[torch.Generator], algorithm: NUTS,
                   metric: Metric, Q: EvaluatedPoint, eps, depth_limit=None):
        if Q.q.dtype != f32:
            return None
        if algorithm.turn_statistic_configuration != "generalized":
            return None
        diag = isinstance(metric, DiagonalMetric)
        if metric.m_inv.ndim != (1 if diag else 2):
            return None  # per-chain metric
        C, K = Q.q.shape
        md = algorithm.max_depth
        if not kernel_fits(K, md):
            return None
        device = Q.q.device
        p0 = rand_p_b(generator, metric, (C, K), f32)
        dirs = random_directions(generator, C, device)
        gum = gumbel_like(generator, ((1 << md) - 1, C), f32, device)
        expo = exponential_like(generator, (md, C), f32, device)
        eps_b = torch.as_tensor(eps, dtype=f32, device=device).expand(C)
        raw = tree_transition(
            Q.q.contiguous(), p0.contiguous(), Q.grad.contiguous(),
            Q.logdensity.contiguous(), eps_b.contiguous(), dirs, gum, expo,
            metric.m_inv.to(f32).contiguous(), prec_t.to(device),
            lchol.to(device), mu32.to(device), depth_cap(depth_limit, md),
            float(algorithm.min_delta), md,
        )
        return finish_transition(raw)

    transition.operands = (prec_t, lchol, mu32)  # the kernel's model arrays
    return transition
