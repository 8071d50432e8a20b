"""Fused logistic-regression leaf: build, binding, launch plan, plain
version and the ``LogDensity.fused_leaf_batched_fn`` hook.

The kernel (csrc/logreg_leaf.cu, CUDA C++ for sm_90a) replaces the Pallas
kernel ``dynamichmc_tpu/ops/pallas_logreg.py::_make_kernel``: one whole
leapfrog leaf of Bayesian logistic regression for every chain of the
batch (both half-kicks, the drift, both products with X, the log density,
its gradient and pi = ld - K(p')). A slice kernel, one CTA per block of 16
chains, slice of the observations and chunk of the gradient, writes
partial sums to a workspace; a finish kernel sums them in a fixed order.
:func:`launch_plan` sizes the grid.

:func:`logreg_leaf` is the wrapper. A tensor on the CPU goes to
:func:`logreg_leaf_plain`, the same leaf in torch ops. A CUDA tensor
launches the kernel or raises; nothing falls back. ``launches`` counts the
wrapper's launches (one slice and one finish kernel each).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..metric import DenseMetric, DiagonalMetric, Metric
from ..tree_batched import kinetic_b, psharp_b
from .cuda_build import CudaLibrary

CHAINS = 16  # chains per CTA of the slice kernel
STAGES = 2  # stages of the ring of X tiles
TILE_ROWS = (64, 16)  # rows of X per tile: the first whose CTA fits
MAX_SMEM_BYTES = 232448  # H100: dynamic shared memory of one CTA

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
library = CudaLibrary("logreg_leaf", {
    "logreg_leaf_f32": (
        [_vp] * 5 + [_ci] + [_vp] * 8 + [_ci] * 6 + [_cf, _vp], _ci,
    ),
    "logreg_leaf_info": ([_ci] * 3 + [_vp] * 3, _ci),
})


def _kx(K: int) -> int:
    """X's row length in the kernel: K rounded up to 4 (16-byte rows)."""
    return (K + 3) // 4 * 4


def smem_bytes(K: int, tile: int) -> int:
    """Dynamic shared memory of one slice-kernel CTA (slice_smem_bytes in
    the CUDA source): the ring's STAGES tiles of X (rows of KX + 4 floats)
    and their y, q' of 16 chains and the tile's residuals."""
    kx = _kx(K)
    return 4 * (STAGES * tile * (kx + 5) + CHAINS * kx + tile * CHAINS)


def tile_rows(K: int) -> int:
    """Rows of X per tile: the first of TILE_ROWS whose CTA fits in shared
    memory, 0 if none does."""
    return next((t for t in TILE_ROWS if smem_bytes(K, t) <= MAX_SMEM_BYTES), 0)


# the widest K the kernel takes: the smallest tile's CTA fills the shared
# memory (smem_bytes is affine in KX)
_T = TILE_ROWS[-1]
MAX_K = ((MAX_SMEM_BYTES - smem_bytes(0, _T))
         // ((smem_bytes(4, _T) - smem_bytes(0, _T)) // 4) // 4 * 4)


def gradient_chunks(K: int) -> int:
    """CTAs of the slice kernel over the gradient's coordinates, each of
    which streams all of X: 128 coordinates each up to K = 128, 256 past
    it."""
    return -(-K // (128 if K <= 128 else 256))


# fused_leaf_pays: the fused leaf beats the plain driver's autograd leaf
# where it streams at most this many elements of X a leaf (n_obs * dim *
# gradient_chunks(dim)), and loses past it (scripts/torch_logreg_auto_sweep.py
# at 2048 chains, NUTS(max_depth=4), each shape's state from a short
# adapted warmup, on an NVIDIA H100 80GB HBM3 at 700 W: it won or tied at
# 4,096,000 and lost from 16,384,000).
FUSED_MAX_X_READS = 4_096_000


def fused_leaf_pays(n_obs: int, dim: int) -> bool:
    """The rule of ``logistic_regression(fused="auto")``: attach the fused
    leaf where it was measured to beat the plain driver on the H100, and
    never past the widest K it takes (MAX_K). A pure function of the
    shape, as the JAX package's is."""
    return (1 <= dim <= MAX_K
            and n_obs * dim * gradient_chunks(dim) <= FUSED_MAX_X_READS)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The grid of one launch: ``tile`` rows of X per tile, ``smem`` bytes
    of shared memory per slice CTA, ``chunks`` CTAs over the gradient's
    coordinates (128 each up to K = 128, 256 past it), ``slices`` CTAs over
    the observations with ``tiles_per_slice`` tiles each (the last may have
    fewer, none is empty)."""

    tile: int
    smem: int
    chunks: int
    slices: int
    tiles_per_slice: int


def launch_plan(C: int, K: int, n_obs: int, sm_count: int,
                blocks_per_sm: int) -> Plan:
    """The launch plan of (C, K, n_obs) on a card of ``sm_count`` SMs that
    holds ``blocks_per_sm`` slice CTAs each (:func:`kernel_info`); raises
    past MAX_K.

    S, the slices: the grid takes as many CTAs as the card holds at once
    and no more (a second, partial wave would take as long as a full one),
    with at least two tiles per slice; one slice where the chain blocks and
    chunks fill the card by themselves."""
    tile = tile_rows(K)
    if not (C >= 1 and 1 <= K and tile and n_obs >= 1):
        raise ValueError(f"logreg leaf kernel: K = {K} outside 1..{MAX_K}, "
                         f"or no chains or observations")
    chunks = gradient_chunks(K)
    blocks = -(-C // CHAINS) * chunks
    n_tiles = -(-n_obs // tile)
    slices = max(1, min(sm_count * blocks_per_sm // blocks, n_tiles // 2))
    per_slice = -(-n_tiles // slices)
    return Plan(tile, smem_bytes(K, tile), chunks, -(-n_tiles // per_slice),
                per_slice)


@dataclasses.dataclass(frozen=True)
class KernelInfo:
    """What the CUDA runtime says of the slice kernel of one (mode, K):
    the card's SMs, registers per thread, shared memory per CTA (bytes) and
    CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""

    sm_count: int
    registers: int
    smem: int
    blocks_per_sm: int


_infos: dict = {}


def kernel_info(device, mode: int, K: int) -> KernelInfo:
    """:class:`KernelInfo` of the slice kernel that (mode, K) launches on
    ``device``, queried once per (device, mode, K). mode: 0 shared
    diagonal, 1 per-chain diagonal, 2 shared dense."""
    key = (device.index, mode, K)
    if key not in _infos:
        lib = library.load()
        smem, regs, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            err = lib.logreg_leaf_info(mode, K, tile_rows(K), ctypes.byref(smem),
                                       ctypes.byref(regs), ctypes.byref(per_sm))
            sms = torch.cuda.get_device_properties(device).multi_processor_count
        if err != 0:
            raise RuntimeError(f"logreg leaf kernel: no kernel for mode {mode}, "
                               f"K = {K} (CUDA error {err})")
        _infos[key] = KernelInfo(sms, regs.value, smem.value, per_sm.value)
    return _infos[key]


def pad_columns(x):
    """x (n, K) as a view of a zero-padded (n, KX) float32 tensor: rows 16
    bytes aligned for the kernel, the same (n, K) values for everyone
    else."""
    n, K = x.shape
    out = torch.zeros((n, _kx(K)), dtype=torch.float32, device=x.device)
    out[:, :K] = x
    return out[:, :K]


launches = 0  # wrapper launches made by logreg_leaf


def reset_launches() -> None:
    global launches
    launches = 0


def softplus(x):
    """log(1 + e^x) = max(x, 0) + log1p(e^-|x|): overflow-free."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def sigmoid(x):
    """tanh form, stable at both tails (pallas_logreg.py::_sigmoid)."""
    return 0.5 * (torch.tanh(0.5 * x) + 1.0)


def logreg_leaf_plain(metric: Metric, q, p, g, eps_signed, x, y,
                      inv_s2: float):
    """The leaf in torch ops, in q's dtype, for any metric form (per-chain
    dense too). Returns (q', p', g', ld', pi') with the kernel's -inf
    poisoning."""
    half = 0.5 * eps_signed[:, None]
    p_mid = p + half * g
    q_new = q + eps_signed[:, None] * psharp_b(metric, p_mid)
    logits = q_new @ x.mT
    ld = (y * logits - softplus(logits)).sum(-1) + (
        -0.5 * inv_s2 * (q_new * q_new).sum(-1))
    g_new = (y - sigmoid(logits)) @ x - inv_s2 * q_new
    p_new = p_mid + half * g_new
    pi = ld - kinetic_b(metric, p_new)
    ok = torch.isfinite(ld) & torch.isfinite(g_new).all(-1)
    ld = torch.where(ok | (ld == -torch.inf), ld, -torch.inf)
    pi = torch.where(torch.isfinite(pi) & torch.isfinite(ld), pi, -torch.inf)
    return q_new, p_new, g_new, ld, pi


def _metric_mode(metric: Metric, C: int, K: int) -> int:
    """The CUDA source's metric mode: 0 shared diagonal, 1 per-chain
    diagonal, 2 shared dense."""
    shape = tuple(metric.m_inv.shape)
    if isinstance(metric, DiagonalMetric):
        if shape == (K,):
            return 0
        if shape == (C, K):
            return 1
    elif isinstance(metric, DenseMetric) and shape == (K, K):
        return 2
    raise ValueError(f"logreg leaf kernel: metric m_inv of shape {shape} "
                     "is not shared diagonal, per-chain diagonal or shared "
                     "dense")


def logreg_leaf(metric: Metric, q, p, g, eps_signed, x, y, inv_s2: float):
    """One leapfrog leaf of Bayesian logistic regression for C chains.

    q, p, g: (C, K); eps_signed: (C,); metric: shared diagonal (K,),
    per-chain diagonal (C, K) or shared dense (K, K) M^-1; x: (n_obs, K);
    y: (n_obs,); all float32 on one CUDA device (or the CPU, which takes
    the plain version). The kernel reads x's rows with a stride of K
    rounded up to 4: an x laid out otherwise is copied so first
    (:func:`pad_columns`; the hook's operand needs no copy). Raises for
    K > MAX_K. Returns (q', p', g', ld', pi')."""
    global launches
    if q.device.type == "cpu":
        return logreg_leaf_plain(metric, q, p, g, eps_signed, x, y, inv_s2)
    if q.device.type != "cuda":
        raise ValueError(f"logreg leaf kernel: unsupported device {q.device}")
    C, K = q.shape
    n_obs = x.shape[0]
    mode = _metric_mode(metric, C, K)
    minv = metric.m_inv
    tensors = {"q": q, "p": p, "g": g, "eps_signed": eps_signed, "minv": minv,
               "x": x, "y": y}
    for name, t in tensors.items():
        if t.device != q.device or not (t.is_contiguous() or name == "x"):
            raise ValueError(f"logreg leaf kernel: {name} must be a "
                             f"contiguous tensor on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"logreg leaf kernel: {name} is {t.dtype}, "
                            "float32 only")
    shapes = {"p": (p, (C, K)), "g": (g, (C, K)), "eps_signed": (eps_signed, (C,)),
              "x": (x, (n_obs, K)), "y": (y, (n_obs,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"logreg leaf kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if not 1 <= K <= MAX_K or n_obs < 1:
        raise ValueError(f"logreg leaf kernel: K = {K} outside 1..{MAX_K} "
                         f"or no observations")
    info = kernel_info(q.device, mode, K)
    plan = launch_plan(C, K, n_obs, info.sm_count, info.blocks_per_sm)
    if x.stride() != (_kx(K), 1) or x.data_ptr() % 16:
        x = pad_columns(x)  # the hook's operand is padded already
    lib = library.load()
    qn, pn, gn = (torch.empty_like(q) for _ in range(3))
    ldn = torch.empty((C,), dtype=q.dtype, device=q.device)
    pin = torch.empty_like(ldn)
    ws = torch.empty((plan.slices, C, K + 1), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.logreg_leaf_f32(
        q.data_ptr(), p.data_ptr(), g.data_ptr(), eps_signed.data_ptr(),
        minv.data_ptr(), mode, x.data_ptr(), y.data_ptr(), qn.data_ptr(),
        pn.data_ptr(), gn.data_ptr(), ldn.data_ptr(), pin.data_ptr(),
        ws.data_ptr(), C, K, n_obs, plan.tile, plan.slices,
        plan.tiles_per_slice, float(inv_s2), stream,
    )
    if err != 0:
        raise RuntimeError(f"logreg leaf kernel launch failed: CUDA error {err}")
    launches += 1
    return qn, pn, gn, ldn, pin


def make_logreg_fused_leaf_batched(x, y, prior_scale: float = 10.0,
                                   device=None):
    """Hook for ``LogDensity.fused_leaf_batched_fn`` on the logistic
    regression posterior of models/logreg.py, with the semantics of
    pallas_logreg.py::make_logreg_fused_leaf_batched:

    ``(metric, q, p, g, eps_signed) -> (q', p', g', ld', pi')``

    float32 chains with a shared diagonal, per-chain diagonal or shared
    dense metric take :func:`logreg_leaf`: the kernel on a GPU, which
    raises for K > MAX_K rather than run the plain math on the card; the
    plain leaf on the CPU. Other dtypes (float64 runs) and per-chain dense
    metrics take the plain leaf in the chains' dtype, as the JAX hook's
    fallback does for them. The float32 X is kept with its columns padded
    to a multiple of 4 (:func:`pad_columns`)."""
    x_full = torch.as_tensor(np.asarray(x), device=device)
    y_full = torch.as_tensor(np.asarray(y), device=device)
    x32 = pad_columns(x_full)
    y32 = y_full.to(torch.float32).contiguous()
    inv_s2 = 1.0 / float(prior_scale) ** 2

    def fused(metric, q, p, g, eps_signed):
        dense = isinstance(metric, DenseMetric)
        if q.dtype != torch.float32 or (dense and metric.m_inv.ndim == 3):
            return logreg_leaf_plain(metric, q, p, g, eps_signed,
                                     x_full.to(q.device, q.dtype),
                                     y_full.to(q.device, q.dtype), inv_s2)
        if isinstance(metric, DiagonalMetric):
            metric = DiagonalMetric(m_inv=metric.m_inv.contiguous(), w_diag=None)
        else:
            metric = DenseMetric(m_inv=metric.m_inv.contiguous(), w=None)
        return logreg_leaf(metric, q.contiguous(), p.contiguous(),
                           g.contiguous(), eps_signed.contiguous(),
                           x32.to(q.device), y32.to(q.device), inv_s2)

    fused.operands = (x32, y32)  # the kernel's data
    fused.inv_s2 = inv_s2
    return fused
