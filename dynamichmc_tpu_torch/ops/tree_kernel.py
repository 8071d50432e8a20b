"""Whole-transition NUTS kernel: build, binding, leaves, plain version and
the ``LogDensity.tree_transition_fn`` hooks.

The kernel (csrc/tree_kernel.cu, CUDA C++ for sm_90a) replaces the Pallas
kernel ``dynamichmc_tpu/ops/pallas_tree.py::_build_kernel`` with each of its
leaves (``_gaussian_leaf``, ``funnel_leaf``, ``logreg_leaf``): one complete
NUTS transition per chain. It comes in three variants, chosen by shape alone
(:func:`kernel_variant`): the Gaussian and funnel leaves run one warp per
chain, with the leaf's matrices staged once per CTA in shared memory,
wherever :func:`warp_plan` gives them a warp (K <= 128); the logreg leaf
runs the same tree control with all of X staged once per CTA wherever
:func:`xstaged_plan` fits X (K <= 128); every other launch runs one CTA
per chain. A :class:`Leaf` names the model: its id in the CUDA source, its
float32 arrays and scalars, and the same value and gradient in torch for
the plain version. The library is built with ``nvcc`` at first
use (ops/cuda_build.py) and called through a plain C entry point with
``ctypes``, on PyTorch's current stream.

:func:`tree_transition` is the wrapper. A tensor on the CPU goes to
:func:`tree_transition_plain`, the same transition computed by the plain
batched driver (tree_batched.py) from the same injected noise with the
leaf's torch value and gradient. A CUDA tensor launches the kernel or
raises; nothing falls back. ``launches`` counts the kernel launches,
``warp_launches`` and ``xstaged_launches`` those of the warp and staged-X
variants among them, ``declined`` the transitions the hook of
:func:`make_tree_transition` declined, by reason.

``work`` differs between the two on purpose: the kernel reports each
chain's own executed leaf count, the plain driver the lockstep count of the
whole batch. Every other output is the same transition.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..hamiltonian import EvaluatedPoint
from ..logdensity import LogDensity
from ..metric import DenseMetric, DiagonalMetric, Metric
from ..nuts import NUTS
from ..profiling import span
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
from .cuda_build import CudaLibrary
from .logreg_leaf import sigmoid, softplus

MAX_THREADS = 1024  # one thread per coordinate, one CTA per chain
MAX_SMEM_BYTES = 232448  # H100: 227 KB of dynamic shared memory per CTA

GAUSSIAN, FUNNEL, LOGREG = 0, 1, 2  # leaf ids of csrc/tree_kernel.cu

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
library = CudaLibrary("tree_kernel", {
    "tree_transition_f32": (
        [_vp] * 9 + [_ci, _ci] + [_vp] * 3 + [_ci, _cf, _cf] + [_vp] * 11
        + [_ci] * 4 + [_cf, _vp],
        _ci,
    ),
    "tree_warp_plan": ([_ci] * 4 + [_vp] * 4, _ci),
    "tree_xstaged_plan": ([_ci] * 4 + [_vp] * 4, _ci),
    "tree_cta_plan": ([_ci] * 4 + [_vp] * 4, _ci),
})

launches = 0  # kernel launches made by tree_transition
warp_launches = 0  # the launches among them that ran the warp variant
xstaged_launches = 0  # and those that ran the staged-X logreg variant
DECLINE_REASONS = ("dtype", "statistic", "per_chain_metric", "shape")
declined = dict.fromkeys(DECLINE_REASONS, 0)  # the hooks' declines, by reason


def reset_launches() -> None:
    global launches, warp_launches, xstaged_launches
    launches = 0
    warp_launches = 0
    xstaged_launches = 0
    declined.update(dict.fromkeys(DECLINE_REASONS, 0))


def _decline(reason: str) -> None:
    """Count one declined transition; None is the hook's answer."""
    declined[reason] += 1


TILE_ROWS, STAGES = 32, 2  # the logreg leaf's tiles of X (kTileRows, kStages)


def _kx(K: int) -> int:
    """Row length of the logreg leaf's X: K rounded up to 4 floats."""
    return (K + 3) // 4 * 4


def smem_bytes(K: int, max_depth: int, tile: int = 0,
               ring: bool = False) -> int:
    """Dynamic shared memory of one CTA (smem_bytes in the CUDA source):
    the 5 x S x Kp merge stack, one staging vector, the reduction scratch
    and, for the logreg leaf, ``tile`` residuals and, with the ring, STAGES
    stages of ``tile`` rows of X and y. It does not depend on n_obs."""
    kp = (K + 31) // 32 * 32
    per_row = STAGES * (_kx(K) + 1) + 1 if ring else 1
    return 4 * ((5 * max_depth + 1) * kp + 6 * 32 + tile * per_row)


def logreg_tiles(K: int, max_depth: int) -> tuple:
    """``(tile, ring)`` of the logreg leaf (logreg_tiles in the CUDA
    source): TILE_ROWS rows per tile through the ring, fewer where the
    merge stack leaves less room; where not even one row per stage fits,
    tiles read from X in place with only their residuals in shared memory.
    ``tile`` is 0 when not even one residual fits."""
    free = max(0, MAX_SMEM_BYTES - smem_bytes(K, max_depth))
    per_row = smem_bytes(K, max_depth, 1, True) - smem_bytes(K, max_depth)
    ring = free >= per_row
    return min(TILE_ROWS, free // (per_row if ring else 4)), ring


WARP_MAX_R = 4  # the warp variant keeps R = ceil(K / 32) <= 4 coordinates a lane


FUNNEL_WARPS = 10  # warps per CTA of the funnel leaf at R = 1 (kFunnelWarps)


def warp_max_warps(kind: int, r: int) -> int:
    """Warps per CTA of the warp variant at most, by leaf and R
    (warp_max_warps in the CUDA source): for the Gaussian, what the
    registers allow at one CTA per SM without a spill; for the funnel at
    R = 1, FUNNEL_WARPS, with several CTAs per SM."""
    if kind == FUNNEL and r == 1:
        return FUNNEL_WARPS
    return 16 if r <= 2 else 12 if r == 3 else 8


def _warp_matrices(kind: int, diag: bool) -> int:
    """K x K matrices the warp variant stages per CTA for the leaf
    (warp_matrices in the CUDA source): prec^T and L, and the dense M^-1
    unless ``diag``, for the Gaussian; the dense M^-1 alone for the
    funnel."""
    if kind == GAUSSIAN:
        return 2 if diag else 3
    return 0 if diag else 1


def warp_plan(kind: int, K: int, max_depth: int, diag: bool) -> tuple:
    """``(warps_per_cta, smem_bytes)`` of the warp variant for leaf ``kind``
    (warp_plan in the CUDA source): the leaf's staged matrices (each K^2
    floats rounded up to 4) and one region per warp of merge stack and
    staging vector, (5 max_depth + 1) x 32 R floats, with as many warps as
    MAX_SMEM_BYTES holds, at most :func:`warp_max_warps`. ``(0, 0)`` where
    it takes no warp: the logreg leaf, past K = 128, or where the matrices
    leave no room for one warp's region."""
    r = -(-K // 32)
    if not (kind in (GAUSSIAN, FUNNEL) and K >= 1 and r <= WARP_MAX_R
            and max_depth >= 1):
        return 0, 0
    mats = 4 * _warp_matrices(kind, diag) * ((K * K + 3) // 4 * 4)
    per_warp = 4 * (5 * max_depth + 1) * 32 * r
    warps = min(warp_max_warps(kind, r),
                max(0, MAX_SMEM_BYTES - mats) // per_warp)
    return (warps, mats + warps * per_warp) if warps else (0, 0)


XS_MAX_WARPS = 8  # warps per CTA of the staged-X variant at most (kXsWarps)
XS_MIN_WARPS = 4  # fewer fit beside X and the launch takes the CTA variant


def xs_lanes(r: int) -> int:
    """Lanes per row of X in the staged-X variant by R = ceil(K / 32)
    (xs_lanes in the CUDA source): at most 32 columns a lane."""
    return 1 if r == 1 else 8 if r == 4 else 4


def xs_stride(K: int) -> int:
    """Floats between two rows of X staged by the staged-X variant
    (xs_stride in the CUDA source): each of the row's G lanes reads n
    float4 chunks, n = ceil(ceil(K / 4) / G), and the stride is 4 G n with
    n made odd, so that a quarter warp's 128-bit loads of 8 / G rows fall
    in 8 distinct 16-byte bank groups."""
    g = xs_lanes(-(-K // 32))
    n = -(-(-(-K // 4)) // g)
    return 4 * g * (n | 1)


def xstaged_plan(K: int, max_depth: int, n_obs: int, diag: bool) -> tuple:
    """``(warps_per_cta, smem_bytes)`` of the logreg leaf's staged-X
    variant (xstaged_plan in the CUDA source): X's n_obs rows at
    :func:`xs_stride`, y rounded up to 4 floats, the dense M^-1 unless
    ``diag`` (K^2 floats rounded up to 4), and one region per warp of merge
    stack and staging vector, (5 max_depth + 1) x 32 R floats, with as many
    warps as MAX_SMEM_BYTES holds, at most XS_MAX_WARPS. ``(0, 0)`` where
    it takes the CTA variant: past K = 128, without observations, or where
    fewer than XS_MIN_WARPS warps fit beside X."""
    r = -(-K // 32)
    if not (K >= 1 and r <= WARP_MAX_R and max_depth >= 1 and n_obs >= 1):
        return 0, 0
    fixed = 4 * (n_obs * xs_stride(K) + (n_obs + 3) // 4 * 4
                 + (0 if diag else (K * K + 3) // 4 * 4))
    per_warp = 4 * (5 * max_depth + 1) * 32 * r
    warps = min(XS_MAX_WARPS, max(0, MAX_SMEM_BYTES - fixed) // per_warp)
    if warps < XS_MIN_WARPS:
        return 0, 0
    return warps, fixed + warps * per_warp


def kernel_variant(kind: int, K: int, max_depth: int, diag: bool,
                   n_obs: int = 0):
    """The kernel a launch of leaf ``kind`` takes, by shape only: "warp"
    wherever :func:`warp_plan` gives the leaf a warp (Gaussian and funnel,
    K <= 128), "xstaged" wherever :func:`xstaged_plan` fits the logreg
    leaf's ``n_obs`` rows of X, else "cta" where one chain's CTA fits
    (:func:`kernel_fits`), else None (the launch raises, the hook
    declines)."""
    if warp_plan(kind, K, max_depth, diag)[0]:
        return "warp"
    if kind == LOGREG and xstaged_plan(K, max_depth, n_obs, diag)[0]:
        return "xstaged"
    return "cta" if kernel_fits(K, max_depth, kind == LOGREG) else None


@dataclasses.dataclass(frozen=True)
class KernelInfo:
    """What the CUDA source and runtime say of one variant's launch for
    (leaf, K, max_depth, diag): warps per CTA, dynamic shared memory per
    CTA (the source's plan), registers per thread, CTAs per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the card's SMs."""

    warps: int
    smem: int
    registers: int
    ctas_per_sm: int
    sm_count: int

    @property
    def resident_warps(self) -> int:
        """Warps an SM holds at once."""
        return self.warps * self.ctas_per_sm


def _plan(fn: str, device, **shape):
    """The four ints the source's ``fn`` reports for ``shape`` (its
    arguments, in order), and the card's SMs."""
    lib = library.load()
    out = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*(int(v) for v in shape.values()),
                               *(ctypes.byref(x) for x in out))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    if err != 0:
        raise RuntimeError(f"tree kernel: {fn} failed for {shape} "
                           f"(CUDA error {err})")
    return [x.value for x in out], sms


def warp_kernel_info(device, kind: int, K: int, max_depth: int,
                     diag: bool) -> KernelInfo:
    """:class:`KernelInfo` of the warp variant's launch on ``device``, from
    the built library (all zero where the plan takes no warp)."""
    values, sms = _plan("tree_warp_plan", device, leaf=kind, K=K,
                        max_depth=max_depth, diag=diag)
    return KernelInfo(*values, sms)


def xstaged_kernel_info(device, K: int, max_depth: int, n_obs: int,
                        diag: bool) -> KernelInfo:
    """:class:`KernelInfo` of the staged-X variant's launch on ``device``
    for the logreg leaf with ``n_obs`` rows, from the built library (all
    zero where the plan takes the CTA variant)."""
    values, sms = _plan("tree_xstaged_plan", device, K=K, max_depth=max_depth,
                        n_obs=n_obs, diag=diag)
    return KernelInfo(*values, sms)


def cta_kernel_info(device, kind: int, K: int, max_depth: int,
                    diag: bool) -> KernelInfo:
    """:class:`KernelInfo` of the CTA variant's launch on ``device`` (one
    CTA of round_up(K, 32) threads per chain), from the built library;
    raises where no CTA fits."""
    (threads, smem, regs, per_sm), sms = _plan(
        "tree_cta_plan", device, leaf=kind, K=K, max_depth=max_depth,
        diag=diag)
    return KernelInfo(threads // 32, smem, regs, per_sm, sms)


def kernel_fits(K: int, max_depth: int, logreg: bool = False) -> bool:
    """Whether the CTA variant's CTA of one chain fits the card: at most
    1024 threads and 227 KB of shared memory, with at least one residual of
    the logreg leaf's tiles. It does not depend on n_obs."""
    if (K + 31) // 32 * 32 > MAX_THREADS:
        return False
    if logreg:
        return logreg_tiles(K, max_depth)[0] >= 1
    return smem_bytes(K, max_depth) <= MAX_SMEM_BYTES


# tree_kernel_pays: the whole-transition kernel with the logreg leaf, in
# which every chain streams all of X at every leaf, beats the plain driver
# (autograd) where X's elements weighted by its 256-wide column blocks
# (n_obs * dim * ceil(dim / 256): its time an element grew about 1.5x at
# dim 512 and 3x at 1024 over dims 64-256) are at most TREE_MAX_X_WORK,
# and the fused leaf where X holds at most TREE_MAX_X_ELEMENTS_VS_FUSED
# elements (n_obs * dim). scripts/torch_logreg_auto_sweep.py at 2048
# chains, NUTS(max_depth=4), each shape's state from a short adapted
# warmup (15 leapfrog steps a chain at most shapes), on an NVIDIA H100
# 80GB HBM3 at 700 W: it beat the plain driver up to a weighted 1,024,000,
# tied at 2,048,000 and lost from 4,096,000; it beat the fused leaf up to
# 512,000 elements and lost from 1,024,000.
TREE_MAX_X_WORK = 2_048_000
TREE_MAX_X_ELEMENTS_VS_FUSED = 512_000
AUTO_MAX_DEPTH = 4  # the max_depth of the sweep behind the rule


def tree_kernel_pays(n_obs: int, dim: int, fused: bool = False) -> bool:
    """The rule of ``logistic_regression(tree_kernel="auto")``: attach the
    whole-transition kernel where it was measured to beat the plain driver
    on the H100 and, with ``fused`` (the fused leaf is attached), the
    fused leaf too; never where its CTA does not fit at
    AUTO_MAX_DEPTH (:func:`kernel_fits`; at a deeper max_depth the hook
    may still decline at run time). A pure function of the shape."""
    if not kernel_fits(dim, AUTO_MAX_DEPTH, logreg=True):
        return False
    if fused:
        return n_obs * dim <= TREE_MAX_X_ELEMENTS_VS_FUSED
    return n_obs * dim * -(-dim // 256) <= TREE_MAX_X_WORK


@dataclasses.dataclass(frozen=True, eq=False)
class Leaf:
    """The model inside the kernel: ``kind`` (GAUSSIAN, FUNNEL or LOGREG),
    up to three float32 arrays (m0..m2 of the CUDA source), two scalars
    (s0, s1) and, for logreg, the observation count and the coordinates
    (``dim``: X's columns before its padding, see :meth:`logreg_data`)."""

    kind: int
    operands: tuple = ()
    scalars: tuple = (0.0, 0.0)
    n_obs: int = 0
    dim: int = 0

    def to(self, device) -> "Leaf":
        return dataclasses.replace(
            self, operands=tuple(t.to(device) for t in self.operands))

    def logreg_data(self):
        """The logreg leaf's X (n_obs, K) without its pad columns, and y."""
        x, y = self.operands
        return x[:, :self.dim], y

    def value_and_grad(self, q):
        """The kernel leaf's value and analytic gradient in torch, row form
        (q: (C, K)), in q's dtype."""
        s0, s1 = self.scalars
        if self.kind == GAUSSIAN:
            prec_t, lchol, mu = (t.to(q.dtype) for t in self.operands)
            d = q - mu
            w = d @ lchol
            return -0.5 * (w * w).sum(-1), -(d @ prec_t)
        if self.kind == FUNNEL:
            v = q[:, 0]
            x2 = (q * q).sum(-1) - v * v
            emv = torch.exp(-v)
            ld = -0.5 * (v * v) / s0 - s1 * v - 0.5 * emv * x2
            gv = -v / s0 - s1 + 0.5 * emv * x2
            return ld, torch.cat([gv[:, None], -emv[:, None] * q[:, 1:]], 1)
        x, y = (t.to(q.dtype) for t in self.logreg_data())
        logits = q @ x.mT
        ll = (y * logits - softplus(logits)).sum(-1)
        grad = (y - sigmoid(logits)) @ x - s0 * q
        return ll + (-0.5 * s0 * (q * q).sum(-1)), grad


def gaussian_leaf(prec_t, lchol, mu) -> Leaf:
    """prec^T and L with prec = L L^T, both (K, K), and mu (K,)."""
    return Leaf(GAUSSIAN, (prec_t, lchol, mu))


def funnel_leaf(dim: int, sigma_v: float) -> Leaf:
    return Leaf(FUNNEL, scalars=(float(sigma_v) ** 2, 0.5 * (dim - 1)))


def logreg_leaf(x, y, prior_scale: float, device=None) -> Leaf:
    """X (n_obs, K) and y (n_obs,) as float32, X with its columns
    zero-padded to a multiple of 4, so that every row starts 16 bytes
    apart for the kernel's asynchronous copies."""
    x = np.asarray(x, np.float32)
    n_obs, K = x.shape
    x_pad = np.zeros((n_obs, _kx(K)), np.float32)
    x_pad[:, :K] = x
    y32 = np.ascontiguousarray(np.asarray(y, np.float32))
    return Leaf(LOGREG, tuple(torch.as_tensor(a, device=device)
                              for a in (x_pad, y32)),
                scalars=(1.0 / float(prior_scale) ** 2, 0.0), n_obs=n_obs,
                dim=K)


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
                          leaf: Leaf, dcap: int, min_delta: float,
                          max_depth: int) -> dict:
    """The kernel's transition computed by the plain batched driver with
    the leaf's torch value and gradient, in q0's dtype.

    Arguments as for :func:`tree_transition`; returns the same raw fields
    (termination not normalized)."""
    ld = LogDensity(dim=q0.shape[1], logdensity_fn=None,
                    logdensity_and_gradient_fn=leaf.to(q0.device).value_and_grad)
    metric = (DiagonalMetric(m_inv=minv, w_diag=None) if minv.ndim == 1
              else DenseMetric(m_inv=minv, w=None))
    Q = EvaluatedPoint(q=q0, logdensity=ld0, grad=g0)
    return transition_raw(
        None, NUTS(max_depth=max_depth, min_delta=min_delta), ld, metric, Q,
        eps, directions=dirs, p=p0, noise=_noise_from_rows(gum, expo, max_depth),
        depth_limit=dcap,
    )


def _operand_shapes(leaf: Leaf, K: int) -> tuple:
    if leaf.kind == GAUSSIAN:
        return ((K, K), (K, K), (K,))
    if leaf.kind == FUNNEL:
        return ()
    if leaf.kind == LOGREG:
        n = leaf.n_obs
        return ((n, _kx(K)), (n,))
    raise ValueError(f"tree kernel: unknown leaf kind {leaf.kind}")


_queues: dict = {}  # (device, stream) -> the warp variants' chain queue


def _queue(device, stream: int) -> torch.Tensor:
    """The chain queue of the warp and staged-X variants for launches on
    ``stream``: the next chain a warp takes and the warps done, two int32s
    that each launch leaves zeroed for the next one on the stream."""
    key = (device, stream)
    if key not in _queues:
        _queues[key] = torch.zeros((2,), dtype=torch.int32, device=device)
    return _queues[key]


def tree_transition(q0, p0, g0, ld0, eps, dirs, gum, expo, minv,
                    leaf: Leaf, dcap: int, min_delta: float,
                    max_depth: int) -> dict:
    """One NUTS transition of the leaf's target for C chains.

    q0, p0, g0: (C, K); ld0, eps: (C,); dirs: (C,) int32 holding the uint32
    direction bits; gum: (2^max_depth - 1, C) Gumbel rows, row
    (1 << d) - 1 + n for doubling d and leaf n; expo: (max_depth, C);
    minv: shared M^-1, (K, K) dense or (K,) diagonal; leaf: the model
    (its operands on q0's device); dcap in 1..max_depth. All float32
    except dirs.

    Returns the raw fields prop_q, prop_grad, prop_ld, prop_pi, depth,
    term_left, term_right, log_sum, steps, work, directions.
    """
    global launches, warp_launches, xstaged_launches
    if q0.device.type == "cpu":
        return tree_transition_plain(q0, p0, g0, ld0, eps, dirs, gum, expo,
                                     minv, leaf, dcap, min_delta, max_depth)
    if q0.device.type != "cuda":
        raise ValueError(f"tree kernel: unsupported device {q0.device}")
    C, K = q0.shape
    operands = tuple(leaf.operands)
    floats = (q0, p0, g0, ld0, eps, gum, expo, minv) + operands
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
    }
    want = _operand_shapes(leaf, K)
    if len(operands) != len(want):
        raise ValueError(f"tree kernel: leaf {leaf.kind} takes {len(want)} "
                         f"operands, got {len(operands)}")
    for i, (t, shape) in enumerate(zip(operands, want)):
        shapes[f"m{i}"] = (t, shape)
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"tree kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if tuple(minv.shape) not in ((K,), (K, K)):
        raise ValueError("tree kernel: minv must be (K,) or (K, K)")
    variant = kernel_variant(leaf.kind, K, max_depth, minv.ndim == 1,
                             leaf.n_obs)
    if not (1 <= dcap <= max_depth) or variant is None:
        raise ValueError("tree kernel: dcap or shape outside the kernel")
    if leaf.kind == LOGREG and (leaf.n_obs < 1 or operands[0].data_ptr() % 16):
        raise ValueError("tree kernel: the logreg leaf needs observations "
                         "and a 16-byte-aligned X")
    lib = library.load()
    f32, i32 = torch.float32, torch.int32
    qn = torch.empty((C, K), dtype=f32, device=q0.device)
    gn = torch.empty((C, K), dtype=f32, device=q0.device)
    rows = {n: torch.empty((C,), dtype=f32, device=q0.device)
            for n in ("prop_ld", "prop_pi", "log_sum")}
    ints = {n: torch.empty((C,), dtype=i32, device=q0.device)
            for n in ("depth", "term_left", "term_right", "steps", "work")}
    ptrs = [t.data_ptr() for t in operands] + [None] * (3 - len(operands))
    stream = torch.cuda.current_stream(q0.device).cuda_stream
    queue = _queue(q0.device, stream) if variant != "cta" else None
    err = lib.tree_transition_f32(
        q0.data_ptr(), p0.data_ptr(), g0.data_ptr(), ld0.data_ptr(),
        eps.data_ptr(), dirs.data_ptr(), gum.data_ptr(), expo.data_ptr(),
        minv.data_ptr(), int(minv.ndim == 1), int(leaf.kind), *ptrs,
        int(leaf.n_obs), float(leaf.scalars[0]), float(leaf.scalars[1]),
        qn.data_ptr(), gn.data_ptr(),
        rows["prop_ld"].data_ptr(), rows["prop_pi"].data_ptr(),
        ints["depth"].data_ptr(), ints["term_left"].data_ptr(),
        ints["term_right"].data_ptr(), rows["log_sum"].data_ptr(),
        ints["steps"].data_ptr(), ints["work"].data_ptr(),
        None if queue is None else queue.data_ptr(),
        C, K, max_depth, int(dcap), float(min_delta), stream,
    )
    if err != 0:
        raise RuntimeError(f"tree kernel launch failed: CUDA error {err}")
    launches += 1
    if variant == "warp":
        warp_launches += 1
    elif variant == "xstaged":
        xstaged_launches += 1
    return {"prop_q": qn, "prop_grad": gn, **rows, **ints, "directions": dirs}


def make_tree_transition(leaf: Leaf, dim: int):
    """The ``tree_transition_fn`` hook of a model whose value and gradient
    the kernel computes as ``leaf``:

    ``(generator, algorithm, metric, Q, eps, depth_limit) -> (Q', stats) |
    None``

    It declines (returns None, and the plain driver runs) for chains that
    are not float32, a turn statistic other than "generalized", a per-chain
    metric, or a K and max_depth that no variant takes (:func:`kernel_variant`:
    the CTA variant needs at most 1024 threads and 227 KB of shared memory,
    whatever n_obs), and counts each decline under its reason in
    ``declined`` ("dtype", "statistic", "per_chain_metric", "shape").
    Otherwise it draws
    the momenta, direction bits, Gumbel rows and Exponential rows with the
    caller's generator on the chains' device (span ``dhmc.noise``) and runs
    :func:`tree_transition` (span ``dhmc.kernel``).
    """
    f32 = torch.float32

    def transition(generator: Optional[torch.Generator], algorithm: NUTS,
                   metric: Metric, Q: EvaluatedPoint, eps, depth_limit=None):
        if Q.q.dtype != f32:
            return _decline("dtype")
        if algorithm.turn_statistic_configuration != "generalized":
            return _decline("statistic")
        diag = isinstance(metric, DiagonalMetric)
        if metric.m_inv.ndim != (1 if diag else 2):
            return _decline("per_chain_metric")
        C, K = Q.q.shape
        md = algorithm.max_depth
        if K != dim or kernel_variant(leaf.kind, K, md, diag,
                                      leaf.n_obs) is None:
            return _decline("shape")
        device = Q.q.device
        with span("dhmc.noise"):
            p0 = rand_p_b(generator, metric, (C, K), f32)
            dirs = random_directions(generator, C, device)
            gum = gumbel_like(generator, ((1 << md) - 1, C), f32, device)
            expo = exponential_like(generator, (md, C), f32, device)
            eps_b = torch.as_tensor(eps, dtype=f32, device=device).expand(C)
        with span("dhmc.kernel"):
            raw = tree_transition(
                Q.q.contiguous(), p0.contiguous(), Q.grad.contiguous(),
                Q.logdensity.contiguous(), eps_b.contiguous(), dirs, gum,
                expo, metric.m_inv.to(f32).contiguous(), leaf.to(device),
                depth_cap(depth_limit, md), float(algorithm.min_delta), md,
            )
            return finish_transition(raw)

    transition.leaf = leaf  # the kernel's model
    return transition


def make_gaussian_tree_transition(prec: torch.Tensor, mu: torch.Tensor,
                                  prec_chol_t: torch.Tensor):
    """Hook of a Gaussian model (models/gaussian.py): the leaf takes prec^T
    and L = (L^T)^T, so that thread j of the kernel reads column j."""
    f32 = torch.float32
    leaf = gaussian_leaf(prec.to(f32).mT.contiguous(),
                         prec_chol_t.to(f32).mT.contiguous(),
                         mu.to(f32).contiguous())
    return make_tree_transition(leaf, mu.shape[0])


def make_funnel_tree_transition(dim: int, sigma_v: float = 3.0):
    """Hook of Neal's funnel (models/funnel.py) with the analytic gradient
    (pallas_tree.py::make_funnel_tree_transition)."""
    return make_tree_transition(funnel_leaf(dim, sigma_v), dim)


def make_logreg_tree_transition(x, y, prior_scale: float = 10.0, device=None):
    """Hook of Bayesian logistic regression (models/logreg.py):
    pallas_tree.py::make_logreg_tree_transition without its padding."""
    leaf = logreg_leaf(x, y, prior_scale, device=device)
    return make_tree_transition(leaf, leaf.dim)
