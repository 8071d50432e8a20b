"""Fused Gaussian leaf (K2): build, binding, plain version and the
``LogDensity.fused_leaf_batched_fn`` hook.

The kernel (csrc/gaussian_leaf.cu, CUDA C++ for sm_90a, entry point
``gaussian_leaf_f32``) replaces the Pallas kernel
``dynamichmc_tpu/ops/pallas_leaf.py::_kernel``: one whole leapfrog leaf of a
Gaussian target for every chain of the batch (both half-kicks, the drift,
the gradient, the whitened log density and pi = ld - K(p')), one warp per
chain. The same source holds the leapfrog without pi (K4,
ops/gaussian_leapfrog.py); :data:`library` builds it once for both.

:func:`gaussian_leaf` is the wrapper. A tensor on the CPU goes to
:func:`gaussian_leaf_plain`, the same leaf in torch ops. A CUDA tensor
launches the kernel or raises; nothing falls back. ``launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..metric import DiagonalMetric, Metric
from ..tree_batched import kinetic_b, psharp_b
from .cuda_build import CudaLibrary

# The kernel keeps p_mid and d of its 8 chains (16 K floats) in shared memory,
# at most 227 KB on the H100
MAX_K = 227 * 1024 // (4 * 16)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
library = CudaLibrary("gaussian_leaf", {
    "gaussian_leaf_f32": ([_vp] * 4 + [_ci] + [_vp] * 9 + [_ci, _ci, _vp], _ci),
    "gaussian_leapfrog_f32": ([_vp] * 4 + [_ci] + [_vp] * 8 + [_ci, _ci, _vp],
                              _ci),
})

launches = 0  # kernel launches made by gaussian_leaf


def reset_launches() -> None:
    global launches
    launches = 0


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


def launch(entry: str, metric: Metric, q, p, g, eps_signed, prec, lchol, mu):
    """Check the operands and launch one entry point of the library on
    PyTorch's current stream. Returns (q', p', g', ld'[, pi'])."""
    C, K = q.shape
    if not isinstance(metric, DiagonalMetric):
        raise ValueError("gaussian leaf kernel: diagonal metrics only")
    minv = metric.m_inv
    if tuple(minv.shape) not in ((K,), (C, K)):
        raise ValueError(f"gaussian leaf kernel: m_inv has shape "
                         f"{tuple(minv.shape)}, expected ({K},) or ({C}, {K})")
    tensors = {"q": q, "p": p, "g": g, "m_inv": minv, "eps_signed": eps_signed,
               "prec": prec, "lchol": lchol, "mu": mu}
    for name, t in tensors.items():
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"gaussian leaf kernel: {name} must be a "
                             f"contiguous tensor on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gaussian leaf kernel: {name} is {t.dtype}, "
                            "float32 only")
    shapes = {"p": (p, (C, K)), "g": (g, (C, K)),
              "eps_signed": (eps_signed, (C,)), "prec": (prec, (K, K)),
              "lchol": (lchol, (K, K)), "mu": (mu, (K,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"gaussian leaf kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if not (C >= 1 and 1 <= K <= MAX_K):
        raise ValueError(f"gaussian leaf kernel: C = {C}, K = {K} outside "
                         f"C >= 1, 1 <= K <= {MAX_K}")
    lib = library.load()
    outs = [torch.empty_like(q) for _ in range(3)]
    rows = [torch.empty((C,), dtype=q.dtype, device=q.device)
            for _ in range(2 if entry == "gaussian_leaf_f32" else 1)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, entry)(
        q.data_ptr(), p.data_ptr(), g.data_ptr(), minv.data_ptr(),
        int(minv.ndim == 2), eps_signed.data_ptr(), prec.data_ptr(),
        lchol.data_ptr(), mu.data_ptr(), *(t.data_ptr() for t in outs + rows),
        C, K, stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return (*outs, *rows)


def gaussian_leaf(metric: Metric, q, p, g, eps_signed, prec, lchol, mu):
    """One Gaussian leapfrog leaf for C chains.

    q, p, g: (C, K); eps_signed: (C,); metric: diagonal, m_inv (K,) or
    (C, K); prec, lchol: (K, K) with prec = lchol lchol^T; mu: (K,); all
    float32 on one CUDA device (or the CPU, which takes the plain version).
    Returns (q', p', g', ld', pi')."""
    global launches
    if q.device.type == "cpu":
        return gaussian_leaf_plain(metric, q, p, g, eps_signed, prec, lchol, mu)
    if q.device.type != "cuda":
        raise ValueError(f"gaussian leaf kernel: unsupported device {q.device}")
    out = launch("gaussian_leaf_f32", metric, q, p, g, eps_signed, prec,
                 lchol, mu)
    launches += 1
    return out


class GaussianOperands:
    """A Gaussian model's arrays for the hooks: the model's own (full
    precision, the model's dtype) and float32 copies for the kernels.
    ``prec_chol_t`` is the model's f64-built L^T, so the kernels evaluate the
    same whitened value as the model's log density."""

    def __init__(self, prec, mu, prec_chol_t):
        f32 = torch.float32
        self.prec_full = prec
        self.lchol_full = prec_chol_t.mT
        self.mu_full = mu
        self.prec = prec.to(f32).contiguous()
        self.lchol = self.lchol_full.to(f32).contiguous()
        self.mu = mu.to(f32).contiguous()
        self.dim = mu.shape[0]

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
    take :func:`gaussian_leaf` (the kernel on a GPU); a dense metric or
    another dtype takes :func:`gaussian_leaf_plain` in the chains' dtype
    with the model's full-precision arrays."""
    ops = GaussianOperands(prec, mu, prec_chol_t)

    def fused(metric, q, p, g, eps_signed):
        if not ops.takes_kernel(metric, q.dtype):
            return gaussian_leaf_plain(metric, q, p, g, eps_signed,
                                       *ops.full(q.dtype))
        metric = DiagonalMetric(m_inv=metric.m_inv.contiguous(), w_diag=None)
        return gaussian_leaf(metric, q.contiguous(), p.contiguous(),
                             g.contiguous(), eps_signed.contiguous(),
                             ops.prec, ops.lchol, ops.mu)

    fused.operands = ops
    return fused
