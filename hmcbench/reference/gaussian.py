"""The Gaussian N(0, Sigma) of Neal (2011, "MCMC using Hamiltonian
dynamics", section 5.3.3, its 100-dimensional example): independent
coordinates whose standard deviations run evenly from ``sd_first`` to
``sd_last`` (0.01, 0.02, ..., 1.00 at dimension 100).

The reference value is -0.5 ||L^T (q - mu)||^2 with prec = Sigma^-1 =
L L^T, and the gradient -prec (q - mu); the posterior's moments are mu and
Sigma themselves.
"""

from __future__ import annotations

import numpy as np
import torch

from . import precision as P
from .tree_kernel import launch_bytes as _launch_bytes

BLOCK_ROWS = 1 << 15


def make_data(config: dict) -> dict:
    """{"mean", "cov"}: float64 numpy arrays."""
    dim = int(config["dim"])
    sd = np.linspace(float(config["sd_first"]), float(config["sd_last"]), dim)
    return {"mean": np.zeros(dim), "cov": np.diag(sd * sd)}


class Target:
    """The log density and its gradient on ``device``."""

    def __init__(self, data: dict, device):
        prec = np.linalg.inv(data["cov"])
        f64 = dict(dtype=torch.float64, device=device)
        self.mean = torch.as_tensor(data["mean"], **f64)
        self.prec = torch.as_tensor(prec, **f64)
        self.prec_chol_t = torch.as_tensor(np.linalg.cholesky(prec).T, **f64)
        self.cov = torch.as_tensor(data["cov"], **f64)

    def ld_grad(self, q: torch.Tensor, precision: str = "float64"):
        """(log density (S,), gradient (S, K)) at the rows of ``q``, in
        float64 or at TF32 precision (:mod:`precision`)."""
        lds, grads = [], []
        for lo in range(0, q.shape[0], BLOCK_ROWS):
            d = P.cast(q[lo:lo + BLOCK_ROWS], precision) - P.cast(
                self.mean, precision)
            w = P.matmul(d, self.prec_chol_t.mT, precision)
            lds.append(-0.5 * (w * w).sum(-1))
            grads.append(-P.matmul(d, self.prec.mT, precision))
        return (torch.cat(lds).to(torch.float64),
                torch.cat(grads).to(torch.float64))


def make_target(data: dict, device, config: dict) -> Target:
    return Target(data, device)


def posterior_moments(target: Target, config: dict):
    """(mean, covariance, draws behind them): exact, so no draws' error."""
    return target.mean, target.cov, float("inf")


def leaf_flops(config: dict) -> int:
    """Operations of one leaf: 8 K^2 + 30 K with a dense M^-1 (drift M^-1 p,
    gradient, value, M^-1 p'), 4 K^2 + 30 K with a diagonal one."""
    K = int(config["dim"])
    return (8 if config["metric"] == "dense" else 4) * K * K + 30 * K


def launch_bytes(config: dict, chains: int) -> int:
    """One launch: the tree kernel's interface, M^-1 and the leaf's
    operands (prec^T, L and mu)."""
    K = int(config["dim"])
    metric = K * K if config["metric"] == "dense" else K
    return _launch_bytes(chains, K, int(config["max_depth"]), metric,
                         2 * K * K + K)
