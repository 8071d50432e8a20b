"""Fused Gaussian leaf (K2): build, binding, launch plan, plain version and
the ``LogDensity.fused_leaf_batched_fn`` hook.

The kernel (csrc/gaussian_leaf.cu, CUDA C++ for sm_90a, entry point
``gaussian_leaf_f32``) replaces the Pallas kernel
``dynamichmc_tpu/ops/pallas_leaf.py::_kernel``: one whole leapfrog leaf of a
Gaussian target for every chain of the batch (both half-kicks, the drift,
the gradient, the whitened log density and pi = ld - K(p')), a block of
chains per CTA (:func:`launch_plan`). The same source holds the leapfrog
without pi (K4, ops/gaussian_leapfrog.py); :data:`library` builds it once
for both.

:func:`gaussian_leaf` is the wrapper. A tensor on the CPU goes to
:func:`gaussian_leaf_plain`, the same leaf in torch ops. A CUDA tensor
launches the kernel or raises; nothing falls back. ``launches`` counts the
kernel launches.

The launch path is what a call costs on the host (tens of microseconds on
the card's host, against a few on the device). :class:`KernelOperands`
binds a model's prec, L and mu once, checked, with their pointers; a call
then checks only its own operands, allocates its outputs with
``torch.empty_like``, reads the current stream through the raw-stream call
PyTorch's own generated kernels use, and makes one ctypes call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..metric import DiagonalMetric, Metric
from ..tree_batched import kinetic_b, psharp_b
from .cuda_build import CudaLibrary

F32 = torch.float32
MAX_SMEM_BYTES = 232448  # H100: dynamic shared memory of one CTA
MAX_WARPS = 8  # warps per CTA (kMaxWarps in the source)
CHAINS_PER_WARP = 8  # R of every launch but a single chain's
H100_SMS = 132

# The tile of one warp (8 chains' d and p_mid, 16 K floats) fits in shared
# memory; every K up to it launches
MAX_K = MAX_SMEM_BYTES // (4 * 2 * CHAINS_PER_WARP)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
library = CudaLibrary("gaussian_leaf", {
    "gaussian_leaf_f32": ([_vp] * 13 + [_ci] * 6 + [_vp], _ci),
    "gaussian_leapfrog_f32": ([_vp] * 12 + [_ci] * 6 + [_vp], _ci),
    "gaussian_leaf_info": ([_ci] * 6 + [_vp] * 3, _ci),
})
ENTRIES = ("gaussian_leaf_f32", "gaussian_leapfrog_f32")

launches = 0  # kernel launches made by gaussian_leaf and the K2 hook


def reset_launches() -> None:
    global launches
    launches = 0


def _current_stream(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# The current stream of a device as an int: 0.1-0.2 us against 4-7 us for
# torch.cuda.current_stream(), which builds a Stream object (PERF.md
# section 5). The raw call is the one PyTorch's generated Triton launchers
# use; a build without it takes the public call.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _current_stream)


def smem_bytes(K: int, chains: int, staged: bool) -> int:
    """Dynamic shared memory of one CTA (smem_bytes in the CUDA source):
    the tile's d and p_mid (K floats a chain each); when staged, also prec
    and L (K^2 floats each, rounded up to 4) and the tile's m_inv and
    eps / 2 (K + 1 floats a chain), which the epilogue then reads from
    shared memory."""
    if staged:
        return 4 * (2 * ((K * K + 3) // 4 * 4) + 3 * chains * K + chains)
    return 4 * 2 * chains * K


@dataclasses.dataclass(frozen=True)
class Plan:
    """The grid of one launch: ``R`` chains per warp, ``warps`` warps per
    CTA, ``chains`` = R x warps per CTA, ``ctas`` CTAs, prec and L
    ``staged`` in shared memory or read through L1/L2, ``smem`` bytes of
    dynamic shared memory per CTA."""

    R: int
    warps: int
    chains: int
    ctas: int
    staged: bool
    smem: int


def launch_plan(C: int, K: int, sm_count: int = H100_SMS) -> Plan:
    """The launch plan of C chains of dimension K on a card of ``sm_count``
    SMs; raises outside C >= 1, 1 <= K <= MAX_K.

    A single chain takes one warp (R = 1). Otherwise R = 8 chains a warp
    and the fewest warps a CTA (at most MAX_WARPS) that put every chain in
    one wave of one CTA per SM (4 at 4096 chains on 132 SMs: 128 CTAs of
    32 chains), fewer where the tile's d and p_mid would not fit. prec and
    L are staged once per CTA wherever they fit beside the tile, for a
    single warp too: all of a CTA's copies are in flight at once, where
    the products' loads from L2 would wait in turn (one chain at 1 x 25:
    3.80 us unstaged against 2.79 for the staged parent, PERF.md section
    6)."""
    if not (C >= 1 and 1 <= K <= MAX_K):
        raise ValueError(f"gaussian leaf kernel: C = {C}, K = {K} outside "
                         f"C >= 1, 1 <= K <= {MAX_K}")
    return _plan(C, K, sm_count)


@functools.lru_cache(maxsize=256)
def _plan(C: int, K: int, sm_count: int) -> Plan:
    R = 1 if C == 1 else CHAINS_PER_WARP
    warps = min(MAX_WARPS, -(-C // (R * sm_count)))
    while warps > 1 and smem_bytes(K, warps * R, False) > MAX_SMEM_BYTES:
        warps -= 1
    chains = warps * R
    staged = smem_bytes(K, chains, True) <= MAX_SMEM_BYTES
    return Plan(R, warps, chains, -(-C // chains), staged,
                smem_bytes(K, chains, staged))


def staging_limit(C: int, sm_count: int = H100_SMS) -> int:
    """The largest K whose launch plan stages prec and L at C chains (0 if
    none does): past it they are read through L1/L2."""
    return max((K for K in range(1, MAX_K + 1)
                if _plan.__wrapped__(C, K, sm_count).staged), default=0)


_sm_counts: dict = {}


def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, queried once."""
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


@dataclasses.dataclass(frozen=True)
class KernelInfo:
    """What the CUDA runtime says of the kernel one launch plan runs:
    registers per thread, dynamic shared memory per CTA (bytes) and CTAs
    per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""

    registers: int
    smem: int
    ctas_per_sm: int


def kernel_info(device, write_pi: bool, chain_minv: bool, K: int,
                plan: Plan) -> KernelInfo:
    """:class:`KernelInfo` of the instantiation and plan on ``device``."""
    lib = library.load()
    smem, regs, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = lib.gaussian_leaf_info(
            int(write_pi), int(chain_minv), K, plan.R, plan.warps,
            int(plan.staged), ctypes.byref(smem), ctypes.byref(regs),
            ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"gaussian leaf kernel: no kernel for K = {K}, "
                           f"{plan} (CUDA error {err})")
    return KernelInfo(regs.value, smem.value, per_sm.value)


def gaussian_leapfrog_plain(metric: Metric, q, p, g, eps_signed, prec, lchol,
                            mu):
    """The plain version of K4 (ops/gaussian_leapfrog.py): one leapfrog step
    of log p = -1/2 ||(q - mu) L||^2 (prec = L L^T) for C chains in q's
    dtype, any metric form: (q', p', g', ld') with ld' -inf-poisoned
    (pallas_leapfrog.py:228-230). eps_signed: (C,)."""
    half = 0.5 * eps_signed[:, None]
    p_mid = p + half * g
    q_new = q + eps_signed[:, None] * psharp_b(metric, p_mid)
    d = q_new - mu
    g_new = -(d @ prec)
    w = d @ lchol
    ld = -0.5 * (w * w).sum(-1)
    p_new = p_mid + half * g_new
    ok = torch.isfinite(ld) & torch.isfinite(g_new).all(-1)
    ld = torch.where(ok | (ld == -torch.inf), ld, -torch.inf)
    return q_new, p_new, g_new, ld


def gaussian_leaf_plain(metric: Metric, q, p, g, eps_signed, prec, lchol, mu):
    """The leaf in torch ops, in q's dtype, for any metric form: (q', p',
    g', ld', pi') with the kernel's -inf poisoning (pallas_leaf.py:159-163)."""
    q_new, p_new, g_new, ld = gaussian_leapfrog_plain(
        metric, q, p, g, eps_signed, prec, lchol, mu)
    pi = ld - kinetic_b(metric, p_new)
    pi = torch.where(torch.isfinite(pi) & torch.isfinite(ld), pi, -torch.inf)
    return q_new, p_new, g_new, ld, pi


def _device_name(index: int) -> str:
    return "cpu" if index < 0 else f"cuda:{index}"


class KernelOperands:
    """A model's prec, L and mu bound for the kernels: checked once (float32,
    contiguous, (K, K), (K, K) and (K,), on one device) with their
    pointers, so that a launch checks only its own operands. K is not
    checked against MAX_K here: a launch past it raises."""

    __slots__ = ("K", "index", "tensors", "pointers")

    def __init__(self, prec, lchol, mu):
        K = mu.shape[0] if mu.ndim == 1 else -1
        index = mu.get_device()
        for name, t, shape in (("prec", prec, (K, K)), ("lchol", lchol, (K, K)),
                               ("mu", mu, (K,))):
            if t.get_device() != index or not t.is_contiguous():
                raise ValueError(f"gaussian leaf kernel: {name} must be a "
                                 f"contiguous tensor on {_device_name(index)}")
            if t.dtype != F32:
                raise TypeError(f"gaussian leaf kernel: {name} is {t.dtype}, "
                                "float32 only")
            if tuple(t.shape) != shape:
                raise ValueError(f"gaussian leaf kernel: {name} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
        self.K, self.index = K, index
        self.tensors = (prec, lchol, mu)  # kept alive for the pointers
        self.pointers = (prec.data_ptr(), lchol.data_ptr(), mu.data_ptr())

    def launch(self, entry: int, minv, q, p, g, eps_signed):
        """Check the call's operands and launch ``ENTRIES[entry]`` (0: K2,
        1: K4) on PyTorch's current stream. q, p, g: (C, K), or (K,) for one
        chain; minv: (K,) or q's shape; eps_signed: q's shape without its
        last axis. Returns (q', p', g', ld'[, pi']) shaped as q and eps."""
        shape = q.shape
        index = self.index
        # every check in one expression; on a failure _refuse names it
        if not (len(shape) in (1, 2) and shape[-1] == self.K
                and q.dtype is F32 and p.dtype is F32 and g.dtype is F32
                and minv.dtype is F32 and eps_signed.dtype is F32
                and p.shape == shape and g.shape == shape
                and eps_signed.shape == shape[:-1]
                and (minv.shape == shape or minv.shape == shape[-1:])
                and q.is_contiguous() and p.is_contiguous()
                and g.is_contiguous() and minv.is_contiguous()
                and eps_signed.is_contiguous()
                and q.get_device() == index and p.get_device() == index
                and g.get_device() == index and minv.get_device() == index
                and eps_signed.get_device() == index):
            self._refuse(minv, q, p, g, eps_signed)
        C = shape[0] if len(shape) == 2 else 1
        plan = launch_plan(C, self.K, sm_count(index) if index >= 0 else H100_SMS)
        fn = getattr(library.load(), ENTRIES[entry])
        qn, pn, gn = (torch.empty_like(q), torch.empty_like(q),
                      torch.empty_like(q))
        ldn = torch.empty_like(eps_signed)
        pin = torch.empty_like(eps_signed) if entry == 0 else None
        prec, lchol, mu = self.pointers
        err = fn(q.data_ptr(), p.data_ptr(), g.data_ptr(), minv.data_ptr(),
                 eps_signed.data_ptr(), prec, lchol, mu, qn.data_ptr(),
                 pn.data_ptr(), gn.data_ptr(), ldn.data_ptr(),
                 *((pin.data_ptr(),) if entry == 0 else ()), C, self.K,
                 int(minv.ndim == 2), plan.R, plan.warps, int(plan.staged),
                 _raw_stream(index))
        if err != 0:
            raise RuntimeError(f"{ENTRIES[entry]} launch failed: CUDA error "
                               f"{err}")
        return (qn, pn, gn, ldn, pin) if entry == 0 else (qn, pn, gn, ldn)

    def _refuse(self, minv, q, p, g, eps_signed):
        """Raise what the launch does not take, naming the operand."""
        shape = q.shape
        if not 1 <= len(shape) <= 2:
            raise ValueError(f"gaussian leaf kernel: q has shape "
                             f"{tuple(shape)}, expected (C, K) or (K,)")
        K = shape[-1]
        if minv.shape != shape and tuple(minv.shape) != (K,):
            raise ValueError(f"gaussian leaf kernel: m_inv has shape "
                             f"{tuple(minv.shape)}, expected ({K},) or "
                             f"{tuple(shape)}")
        index = q.get_device()
        for name, t in (("q", q), ("p", p), ("g", g), ("m_inv", minv),
                        ("eps_signed", eps_signed)):
            if t.get_device() != index or not t.is_contiguous():
                raise ValueError(f"gaussian leaf kernel: {name} must be a "
                                 f"contiguous tensor on {_device_name(index)}")
            if t.dtype != F32:
                raise TypeError(f"gaussian leaf kernel: {name} is {t.dtype}, "
                                "float32 only")
        for name, t, want in (("p", p, shape), ("g", g, shape),
                              ("eps_signed", eps_signed, shape[:-1])):
            if t.shape != want:
                raise ValueError(f"gaussian leaf kernel: {name} has shape "
                                 f"{tuple(t.shape)}, expected {tuple(want)}")
        raise ValueError(
            f"gaussian leaf kernel: prec, lchol and mu are ({self.K}, "
            f"{self.K}) on {_device_name(self.index)}, expected ({K}, {K}) "
            f"on {_device_name(index)}")


def launch(entry: str, metric: Metric, q, p, g, eps_signed, prec, lchol, mu):
    """Check every operand and launch one entry point of the library on
    PyTorch's current stream. Returns (q', p', g', ld'[, pi'])."""
    if not isinstance(metric, DiagonalMetric):
        raise ValueError("gaussian leaf kernel: diagonal metrics only")
    return KernelOperands(prec, lchol, mu).launch(
        ENTRIES.index(entry), metric.m_inv, q, p, g, eps_signed)


def gaussian_leaf(metric: Metric, q, p, g, eps_signed, prec, lchol, mu):
    """One Gaussian leapfrog leaf for C chains.

    q, p, g: (C, K); eps_signed: (C,); metric: diagonal, m_inv (K,) or
    (C, K); prec, lchol: (K, K) with prec = lchol lchol^T; mu: (K,); all
    float32 on one CUDA device (or the CPU, which takes the plain version).
    Returns (q', p', g', ld', pi')."""
    global launches
    if not q.is_cuda:
        if q.device.type == "cpu":
            return gaussian_leaf_plain(metric, q, p, g, eps_signed, prec,
                                       lchol, mu)
        raise ValueError(f"gaussian leaf kernel: unsupported device {q.device}")
    out = launch("gaussian_leaf_f32", metric, q, p, g, eps_signed, prec,
                 lchol, mu)
    launches += 1
    return out


class GaussianOperands:
    """A Gaussian model's arrays for the hooks: the model's own (full
    precision, the model's dtype) and float32 copies for the kernels, bound
    once (``kernels``, a :class:`KernelOperands`). ``prec_chol_t`` is the
    model's f64-built L^T, so the kernels evaluate the same whitened value
    as the model's log density."""

    def __init__(self, prec, mu, prec_chol_t):
        f32 = torch.float32
        self.prec_full = prec
        self.lchol_full = prec_chol_t.mT
        self.mu_full = mu
        self.prec = prec.to(f32).contiguous()
        self.lchol = self.lchol_full.to(f32).contiguous()
        self.mu = mu.to(f32).contiguous()
        self.dim = mu.shape[0]
        self.kernels = KernelOperands(self.prec, self.lchol, self.mu)

    def full(self, dtype):
        """(prec, lchol, mu) at full precision, cast to ``dtype``."""
        return (self.prec_full.to(dtype), self.lchol_full.to(dtype),
                self.mu_full.to(dtype))

    def takes_kernel(self, metric: Metric, dtype) -> bool:
        """The JAX hooks' dispatch rule: float32 chains with a diagonal
        metric run the kernel; a dense metric or another dtype runs the
        plain math in the caller's dtype with the full-precision arrays."""
        return isinstance(metric, DiagonalMetric) and dtype == torch.float32


def make_gaussian_fused_leaf_batched(prec, mu, prec_chol_t):
    """Hook for ``LogDensity.fused_leaf_batched_fn`` on a Gaussian model
    (pallas_leaf.py::make_gaussian_fused_leaf_batched):

    ``(metric, q, p, g, eps_signed (C,)) -> (q', p', g', ld', pi')``

    float32 chains with a shared (K,) or per-chain (C, K) diagonal metric
    take the kernel on a GPU (through the model's bound operands) and
    :func:`gaussian_leaf` elsewhere; a dense metric or another dtype takes
    :func:`gaussian_leaf_plain` in the chains' dtype with the model's
    full-precision arrays. Operands of any layout are taken
    (``contiguous()`` returns a contiguous tensor itself)."""
    ops = GaussianOperands(prec, mu, prec_chol_t)
    kernels = ops.kernels

    def fused(metric, q, p, g, eps_signed):
        global launches
        if not ops.takes_kernel(metric, q.dtype):
            return gaussian_leaf_plain(metric, q, p, g, eps_signed,
                                       *ops.full(q.dtype))
        if q.is_cuda:
            out = kernels.launch(0, metric.m_inv.contiguous(), q.contiguous(),
                                 p.contiguous(), g.contiguous(),
                                 eps_signed.contiguous())
            launches += 1
            return out
        return gaussian_leaf(
            DiagonalMetric(m_inv=metric.m_inv.contiguous(), w_diag=None),
            q.contiguous(), p.contiguous(), g.contiguous(),
            eps_signed.contiguous(), ops.prec, ops.lchol, ops.mu)

    fused.operands = ops
    return fused
