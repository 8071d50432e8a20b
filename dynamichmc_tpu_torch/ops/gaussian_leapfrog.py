"""Fused Gaussian leapfrog (K4): wrapper, plain version and the
``LogDensity.fused_leapfrog_fn`` hook of the per-chain drivers.

The kernel (entry point ``gaussian_leapfrog_f32`` of csrc/gaussian_leaf.cu,
built by ``ops.gaussian_leaf.library``, which also holds the launch and
:func:`gaussian_leapfrog_plain` since K2's leaf is this step plus pi)
replaces the Pallas kernel
``dynamichmc_tpu/ops/pallas_leapfrog.py::_kernel``: one velocity-Verlet step
of a Gaussian target (both half-kicks, the drift, the gradient and the
whitened log density; no pi) for a batch of chains, a block of chains per
CTA (one warp for a single chain).

Dispatch differs from the JAX package in one place. There the per-chain
drivers are vmapped, and ``custom_vmap`` hands the whole chain batch to the
kernel while an unbatched call takes the pure ``reference``
(pallas_leapfrog.py:166-180). The port's per-chain drivers run one chain
eagerly, so the hook launches the kernel on the chain's own (K,) tensors,
a batch of one, through the model's bound operands: no reshape, and the
outputs are allocated in the chain's shapes. Both compute the same
function.

:func:`gaussian_leapfrog` is the wrapper. A tensor on the CPU goes to
:func:`gaussian_leapfrog_plain`. A CUDA tensor launches the kernel or
raises; nothing falls back. ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from ..hamiltonian import EvaluatedPoint, PhasePoint
from ..metric import DiagonalMetric, Metric
from .gaussian_leaf import GaussianOperands, gaussian_leapfrog_plain, launch

launches = 0  # kernel launches made by gaussian_leapfrog


def reset_launches() -> None:
    global launches
    launches = 0


def gaussian_leapfrog(metric: Metric, q, p, g, eps_signed, prec, lchol, mu):
    """One Gaussian leapfrog step for C chains.

    q, p, g: (C, K); eps_signed: (C,); metric: diagonal, m_inv (K,) or
    (C, K); prec, lchol: (K, K) with prec = lchol lchol^T; mu: (K,); all
    float32 on one CUDA device (or the CPU, which takes the plain version).
    Returns (q', p', g', ld')."""
    global launches
    if q.device.type == "cpu":
        return gaussian_leapfrog_plain(metric, q, p, g, eps_signed, prec,
                                       lchol, mu)
    if q.device.type != "cuda":
        raise ValueError(f"gaussian leapfrog kernel: unsupported device "
                         f"{q.device}")
    out = launch("gaussian_leapfrog_f32", metric, q, p, g, eps_signed, prec,
                 lchol, mu)
    launches += 1
    return out


def make_gaussian_fused_leapfrog(prec, mu, prec_chol_t):
    """Hook for ``LogDensity.fused_leapfrog_fn`` on a Gaussian model
    (pallas_leapfrog.py::make_gaussian_fused_leapfrog):

    ``(metric, z: PhasePoint, eps_signed) -> PhasePoint``

    ``z`` holds one chain ((K,) tensors, eps a scalar) or a batch ((C, K),
    eps (C,) or a scalar). float32 chains with a diagonal metric ((K,) or
    (C, K)) take the kernel on a GPU (through the model's bound operands)
    and :func:`gaussian_leapfrog` elsewhere; a dense metric or another
    dtype takes the plain step in the chains' dtype with the model's
    full-precision arrays."""
    ops = GaussianOperands(prec, mu, prec_chol_t)
    kernels = ops.kernels

    def fused_leapfrog(metric, z: PhasePoint, eps_signed) -> PhasePoint:
        global launches
        q = z.Q.q
        if q.is_cuda and q.dim() <= 2 and ops.takes_kernel(metric, q.dtype):
            lead = q.shape[:-1]
            eps = eps_signed
            if not (torch.is_tensor(eps) and eps.dtype == q.dtype
                    and eps.shape == lead
                    and eps.get_device() == q.get_device()):
                eps = torch.as_tensor(eps, dtype=q.dtype, device=q.device)
                eps = eps.reshape(-1).expand(lead.numel()).reshape(lead)
            qn, pn, gn, ld = kernels.launch(
                1, metric.m_inv.contiguous(), q.contiguous(), z.p.contiguous(),
                z.Q.grad.contiguous(), eps.contiguous())
            launches += 1
            return PhasePoint(Q=EvaluatedPoint(q=qn, logdensity=ld, grad=gn),
                              p=pn)
        shape, K = q.shape, q.shape[-1]
        q2, p2, g2 = (t.reshape(-1, K) for t in (q, z.p, z.Q.grad))
        eps = torch.as_tensor(eps_signed, dtype=q.dtype, device=q.device)
        eps = eps.reshape(-1).expand(q2.shape[0])
        if ops.takes_kernel(metric, q.dtype):
            metric = DiagonalMetric(m_inv=metric.m_inv.contiguous(), w_diag=None)
            out = gaussian_leapfrog(metric, q2.contiguous(), p2.contiguous(),
                                    g2.contiguous(), eps.contiguous(),
                                    ops.prec, ops.lchol, ops.mu)
        else:
            out = gaussian_leapfrog_plain(metric, q2, p2, g2, eps,
                                          *ops.full(q.dtype))
        qn, pn, gn, ld = out
        return PhasePoint(
            Q=EvaluatedPoint(q=qn.reshape(shape), logdensity=ld.reshape(shape[:-1]),
                             grad=gn.reshape(shape)),
            p=pn.reshape(shape),
        )

    fused_leapfrog.operands = ops
    return fused_leapfrog
