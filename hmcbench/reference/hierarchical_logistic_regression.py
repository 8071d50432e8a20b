"""Hoffman and Gelman's hierarchical logistic regression (2014, JMLR 15,
section 4, model HLR): German credit's shape, 1000 rows of 24
standardised covariates and their 276 pairwise products, each
standardised, and an intercept; all 301 coefficients b share one scale,
b_i ~ N(0, sigma^2), sigma^2 ~ Exponential(``rate``). The sampled
coordinates are q = (b, t), t = log sigma^2, K = 302.

The data are seeded: from ``np.random.RandomState(data_seed)``, the
covariates ~ N(0, 1) (the draw of the LR configuration), then the
coefficients: ``coef_scale`` x N(0, 1) for the main effects and
``interaction_scale`` x N(0, 1) for the products, with the intercept
``intercept``, then y ~ Bernoulli(sigmoid(X b)). X's columns: the ones,
the covariates, then the products z_i z_j for i < j in lexicographic
order.

The reference value, with l = X b and P = 301:

    ld  = sum(y l - log(1 + e^l)) - 1/2 e^-t |b|^2 - P/2 t - rate e^t + t
    g_b = X^T (y - sigmoid(l)) - e^-t b
    g_t = 1/2 e^-t |b|^2 - P/2 - rate e^t + 1

The joint density has no mode (it grows without bound as b -> 0 and
t -> -inf), so the posterior's moments come by importance sampling in the
non-centered coordinates u = (z, t), z = b e^{-t/2}, where it has one:
log p(z, t) = sum(y l - log(1 + e^l)) - 1/2 |z|^2 - rate e^t + t with
l = e^{t/2} X z. The draws are mapped back to (b, t).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import math
import os
import sys

import numpy as np
import torch

from . import precision as P

BLOCK_ROWS = 4096
# the annealed importance sampler (importance_moments): proposals a block,
# the tempering of the proposal's t, and each level's HMC step (its
# leapfrogs and their size, in coordinates where q0 is N(0, I))
BLOCK_DRAWS = 1 << 14
TEMPER = 0.9
LEAPFROGS = 3
STEP = 0.6


def _standardise(a):
    return (a - a.mean(0)) / a.std(0)


def make_data(config: dict) -> dict:
    """{"x" (n_obs, 1 + covariates + interactions), "y" (n_obs,)}: float64
    numpy arrays."""
    n, d = int(config["n_obs"]), int(config["covariates"])
    rng = np.random.RandomState(int(config["data_seed"]))
    z = _standardise(rng.randn(n, d))
    pairs = list(itertools.combinations(range(d), 2))
    if len(pairs) != int(config["interactions"]):
        raise ValueError(f"{d} covariates make {len(pairs)} pairs, not "
                         f"{config['interactions']}")
    w = _standardise(np.stack([z[:, i] * z[:, j] for i, j in pairs], 1))
    x = np.concatenate([np.ones((n, 1)), z, w], axis=1)
    beta = np.concatenate([
        [float(config["intercept"])],
        float(config["coef_scale"]) * rng.randn(d),
        float(config["interaction_scale"]) * rng.randn(len(pairs))])
    probs = 1 / (1 + np.exp(-(x @ beta)))
    y = (rng.uniform(size=n) < probs).astype(np.float64)
    return {"x": x, "y": y}


class Target:
    """The log density and its gradient on ``device``."""

    def __init__(self, data: dict, device, rate: float):
        f64 = dict(dtype=torch.float64, device=device)
        self.x = torch.as_tensor(data["x"], **f64)
        self.y = torch.as_tensor(data["y"], **f64)
        self.rate = float(rate)
        self.P = self.x.shape[1]

    def ld_grad(self, q: torch.Tensor, precision: str = "float64",
                grad: bool = True):
        """(log density (S,), gradient (S, K) or None) at the rows of ``q``,
        in float64 or at TF32 precision (:mod:`precision`)."""
        lds, grads = [], []
        y = P.cast(self.y, precision)
        Pn = self.P
        for lo in range(0, q.shape[0], BLOCK_ROWS):
            rows = P.cast(q[lo:lo + BLOCK_ROWS], precision)
            b, t = rows[:, :Pn], rows[:, Pn]
            logits = P.matmul(b, self.x.mT, precision)
            zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
            loglik = (y * logits).sum(-1) - torch.logaddexp(zero, logits).sum(-1)
            prec, et = torch.exp(-t), torch.exp(t)
            sq = (b * b).sum(-1)
            lds.append(loglik - 0.5 * prec * sq - 0.5 * Pn * t
                       - self.rate * et + t)
            if grad:
                resid = y - torch.sigmoid(logits)
                g_b = P.matmul(resid, self.x, precision) - prec[:, None] * b
                g_t = 0.5 * prec * sq - 0.5 * Pn - self.rate * et + 1
                grads.append(torch.cat([g_b, g_t[:, None]], 1))
        return (torch.cat(lds).to(torch.float64),
                torch.cat(grads).to(torch.float64) if grad else None)

    def noncentered(self, z: torch.Tensor, t: torch.Tensor,
                    grad: bool = False):
        """(log p(z, t) up to a constant, its gradient in z or None) at the
        rows z (S, P), t (S,) of the non-centered coordinates, float64."""
        s = torch.exp(0.5 * t)[:, None]
        eta = s * (z @ self.x.mT)
        zero = torch.zeros((), dtype=eta.dtype, device=eta.device)
        log_p = ((self.y * eta).sum(-1) - torch.logaddexp(zero, eta).sum(-1)
                 - 0.5 * (z * z).sum(-1) - self.rate * torch.exp(t) + t)
        if not grad:
            return log_p, None
        return log_p, s * ((self.y - torch.sigmoid(eta)) @ self.x) - z

    def conditional(self, t: float, z=None, steps: int = 100):
        """Given t: (z*, L, log m). z* is the mode of log p(z | t), concave
        in z, by Newton's method from ``z`` (zero) to a Newton decrement of
        1e-12, each step halved until the value rises; L the Cholesky
        factor of minus the Hessian there; log m the Laplace approximation
        of log p(t) up to a constant, log p(z*, t) - log det L."""
        eye = torch.eye(self.P, dtype=torch.float64, device=self.x.device)
        s = math.exp(0.5 * t)
        t_row = torch.full((1,), t, dtype=torch.float64, device=self.x.device)

        def terms(z):
            log_p, grad = self.noncentered(z[None], t_row, grad=True)
            p = torch.sigmoid(s * (self.x @ z))
            hess = (s * s) * (self.x.mT * (p * (1 - p))) @ self.x + eye
            return float(log_p), grad[0], torch.linalg.cholesky(hess)

        if z is None:
            z = torch.zeros(self.P, dtype=torch.float64, device=self.x.device)
        value, grad, chol = terms(z)
        for _ in range(steps):
            step = torch.cholesky_solve(grad[:, None], chol)[:, 0]
            if float(grad @ step) < 1e-12:  # the Newton decrement
                break
            for _ in range(30):
                new = terms(z + step)
                if new[0] >= value:
                    break
                step = step / 2
            else:
                break  # no step raises the value: z is the mode
            z = z + step
            value, grad, chol = new
        log_m = value - float(torch.log(torch.diagonal(chol)).sum())
        return z, chol, log_m


def make_target(data: dict, device, config: dict) -> Target:
    return Target(data, device, config["rate"])


def t_grid(target: Target, lo: float = -12.0, hi: float = 4.0,
           coarse: float = 0.5, fine: float = 0.05, span: float = 30.0):
    """Cells of width ``fine`` over the t where the Laplace log p(t) lies
    within ``span`` nats of its largest on a ``coarse`` scan of [lo, hi]:
    (centres (G,), z* (G, P), log m (G,))."""
    z, scan = None, []
    for t in torch.arange(hi, lo - coarse / 2, -coarse).tolist():
        z, _, log_m = target.conditional(t, z)
        scan.append((t, log_m, z))
    best = max(m for _, m, _ in scan)
    kept = [t for t, m, _ in scan if m >= best - span]
    start, stop = max(min(kept) - coarse, lo), min(max(kept) + coarse, hi)
    z = next(z for t, _, z in scan if t == max(kept))
    cells = []
    n = int(round((stop - start) / fine))
    for i in range(n, -1, -1):  # down from the top, warm-started
        t = start + i * fine
        z, _, log_m = target.conditional(t, z)
        cells.append((t, z, log_m))
    cells.reverse()
    f64 = dict(dtype=torch.float64, device=target.x.device)
    return (torch.tensor([c[0] for c in cells], **f64),
            torch.stack([c[1] for c in cells]),
            torch.tensor([c[2] for c in cells], **f64))


class _Annealer:
    """The proposal and the annealed transitions of
    :func:`importance_moments`, in whitened coordinates xi: given t,
    z = z*_g + V (d_t * xi) with B = X^T W X = V diag(lam) V^T (W the
    logistic weights at the marginal's most likely cell) and d_t =
    (e^t lam + 1)^-1/2, so that xi ~ N(0, I) is the Laplace approximation
    of z | t with W held fixed."""

    def __init__(self, target: Target):
        self.target = target
        self.centres, self.z_modes, log_m = t_grid(target)
        self.width = float(self.centres[1] - self.centres[0])
        log_pi = TEMPER * (log_m - log_m.max())
        self.log_pi = log_pi - torch.logsumexp(log_pi, 0)
        g = int(log_m.argmax())
        s = math.exp(0.5 * float(self.centres[g]))
        p = torch.sigmoid(s * (target.x @ self.z_modes[g]))
        self.lam, self.V = torch.linalg.eigh(
            (target.x.mT * (p * (1 - p))) @ target.x)

    def draw(self, n: int, generator):
        """(cell, t, d, xi) of n proposals."""
        f64 = dict(dtype=torch.float64, device=self.centres.device)
        cell = torch.multinomial(self.log_pi.exp(), n, replacement=True,
                                 generator=generator)
        t = self.centres[cell] + self.width * (
            torch.rand(n, generator=generator, **f64) - 0.5)
        d = torch.rsqrt(torch.exp(t)[:, None] * self.lam + 1)
        xi = torch.randn(n, self.target.P, generator=generator, **f64)
        return cell, t, d, xi

    def z(self, cell, d, xi):
        return self.z_modes[cell] + (d * xi) @ self.V.mT

    def ell(self, cell, t, d, xi):
        """log p(z, t) - log q0(z, t) at each row, and its gradient in xi;
        log q0 = log pi_g - log width - sum log d - |xi|^2 / 2."""
        log_p, g_z = self.target.noncentered(self.z(cell, d, xi), t, grad=True)
        log_q = (self.log_pi[cell] - math.log(self.width)
                 - torch.log(d).sum(-1) - 0.5 * (xi * xi).sum(-1))
        return log_p - log_q, d * (g_z @ self.V) + xi


def importance_moments(target: Target, n_draws: int,
                       generator: torch.Generator, temps: int = 64):
    """(mean, covariance, Kish's effective draws) of (b, t) by annealed
    importance sampling (Neal 2001, Statistics and Computing 11) in
    u = (z, t), each draw mapped back to b = z e^{t/2}.

    The proposal q0 follows the posterior's own shape, not a Laplace
    approximation at the joint mode of (z, t): there the fit's value
    outweighs the volume of z (at 301 coefficients the joint mode lies
    near t = 4.7, the marginal's mass near t = -5), and such a proposal
    gets weights of which one takes all. t is drawn from the cells of
    :func:`t_grid`, cell g with probability proportional to m_g^TEMPER
    (tempered: heavier tails than the marginal), uniformly within it; z | t
    from :class:`_Annealer`'s Gaussian. Even so, z | t is skewed by the
    logistic likelihood in all of its 301 directions (a Gaussian proposal
    leaves log-weights of variance ~3 near t = -5), so each draw is then
    annealed with t held, through ``temps`` levels beta_k = (k / temps)^4
    of q0^(1 - beta) p^beta, one HMC step of LEAPFROGS leapfrogs of STEP
    in xi at each level but the last (``temps`` 1: plain importance
    sampling from q0); log w = sum_k (beta_k -
    beta_{k-1}) (log p - log q0) at the state before level k's step."""
    ann = _Annealer(target)
    K, Pn = target.P + 1, target.P
    f64 = dict(dtype=torch.float64, device=ann.centres.device)
    betas = [(k / temps) ** 4 for k in range(temps + 1)]
    shift = None
    sw = sw2 = 0.0
    s1 = torch.zeros(K, **f64)
    s2 = torch.zeros(K, K, **f64)
    for lo in range(0, n_draws, BLOCK_DRAWS):
        n = min(BLOCK_DRAWS, n_draws - lo)
        cell, t, d, xi = ann.draw(n, generator)
        log_w = torch.zeros(n, **f64)
        ell, grad = ann.ell(cell, t, d, xi)
        for k in range(1, temps + 1):
            log_w += (betas[k] - betas[k - 1]) * ell
            if k == temps:
                break
            beta = betas[k]
            # HMC on log pi_beta = -|xi|^2 / 2 + beta ell(xi)
            mom = torch.randn(n, Pn, generator=generator, **f64)
            energy0 = 0.5 * (xi * xi).sum(-1) - beta * ell + 0.5 * (
                mom * mom).sum(-1)
            x1, m1, g1 = xi, mom, grad
            m1 = m1 + 0.5 * STEP * (beta * g1 - x1)
            for j in range(LEAPFROGS):
                x1 = x1 + STEP * m1
                e1, g1 = ann.ell(cell, t, d, x1)
                force = beta * g1 - x1
                m1 = m1 + (STEP if j < LEAPFROGS - 1 else 0.5 * STEP) * force
            energy1 = 0.5 * (x1 * x1).sum(-1) - beta * e1 + 0.5 * (
                m1 * m1).sum(-1)
            accept = torch.log(torch.rand(n, generator=generator, **f64)) < (
                energy0 - energy1)
            accept &= torch.isfinite(energy1)
            xi = torch.where(accept[:, None], x1, xi)
            ell = torch.where(accept, e1, ell)
            grad = torch.where(accept[:, None], g1, grad)
        z = ann.z(cell, d, xi)
        x = torch.cat([z * torch.exp(0.5 * t)[:, None], t[:, None]], 1)
        if shift is None:
            shift = float(log_w.max())
        w = torch.exp(log_w - shift)
        sw += float(w.sum())
        sw2 += float(w.square().sum())
        s1 += w @ x
        s2 += (x * w[:, None]).mT @ x
    if not math.isfinite(sw) or sw2 == 0:
        raise FloatingPointError("importance weights overflowed")
    mean = s1 / sw
    covariance = s2 / sw - torch.outer(mean, mean)
    return mean, (covariance + covariance.mT) / 2, sw * sw / sw2


# The moments of the benchmark's configuration, computed once on an H100
# by ``python3 -m hmcbench.reference.hierarchical_logistic_regression
# CONFIG OUT`` (about 30 s there, hours on a CPU): they depend on the
# configuration and on this module's sampler, never on the program.
FROZEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "hierarchical_logistic_regression_moments.json")
# what the moments depend on: the configuration's data and prior, the
# proposals' count and seed
MOMENT_KEYS = ("n_obs", "covariates", "interactions", "rate", "data_seed",
               "intercept", "coef_scale", "interaction_scale",
               "reference_draws")


def moments_key(config: dict) -> str:
    """SHA-256 of what :func:`compute_moments` reads: the configuration's
    ``MOMENT_KEYS`` and the annealed sampler's constants."""
    keyed = {k: config[k] for k in MOMENT_KEYS}
    keyed.update(block_draws=BLOCK_DRAWS, temper=TEMPER, leapfrogs=LEAPFROGS,
                 step=STEP, temps=64)
    return hashlib.sha256(json.dumps(keyed, sort_keys=True).encode()
                          ).hexdigest()


def compute_moments(target: Target, config: dict):
    """(mean, covariance, effective draws behind them) of the posterior of
    (b, t), by :func:`importance_moments` with ``reference_draws``
    proposals from a generator seeded with ``data_seed``."""
    generator = torch.Generator(device=target.x.device).manual_seed(
        int(config["data_seed"]))
    return importance_moments(target, int(config["reference_draws"]),
                              generator)


def frozen_moments(config: dict, device, path: str = FROZEN):
    """:func:`compute_moments`' result for ``config`` as ``path`` keeps
    it, on ``device``; None where the file keeps another key or is
    missing."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        kept = json.load(f)
    if kept["key"] != moments_key(config):
        return None
    f64 = dict(dtype=torch.float64, device=device)
    K = len(kept["mean"])
    cov = torch.zeros(K, K, **f64)
    rows, cols = torch.tril_indices(K, K, device=device)
    cov[rows, cols] = torch.tensor(kept["covariance_lower"], **f64)
    cov = cov + torch.tril(cov, -1).mT
    return torch.tensor(kept["mean"], **f64), cov, float(kept["kish"])


def write_moments(config: dict, device, path: str) -> None:
    """Compute the moments of ``config`` on ``device`` and keep them at
    ``path``: the mean and the covariance's lower triangle (row by row)
    to ten significant digits, far below their Monte Carlo error."""
    target = make_target(make_data(config), device, config)
    mean, cov, kish = compute_moments(target, config)
    rows, cols = torch.tril_indices(len(mean), len(mean), device=device)
    digits = lambda v: [float(f"{x:.10g}") for x in v.tolist()]  # noqa: E731
    with open(path, "w") as f:
        json.dump({"key": moments_key(config),
                   "config": {k: config[k] for k in MOMENT_KEYS},
                   "kish": kish, "mean": digits(mean),
                   "covariance_lower": digits(cov[rows, cols])}, f)
        f.write("\n")


def posterior_moments(target: Target, config: dict):
    """:func:`frozen_moments` where the kept file is ``config``'s, else
    :func:`compute_moments`."""
    frozen = frozen_moments(config, target.x.device)
    return frozen if frozen is not None else compute_moments(target, config)


def leaf_flops(config: dict) -> int:
    """Operations of one chain's leaf: 4 n P + 10 n + 30 K (the two
    products with X, the softplus and sigmoid terms, the leapfrog) and the
    prior, 4 P + 20 (|b|^2, e^-t b, t's terms)."""
    n = int(config["n_obs"])
    Pn = 1 + int(config["covariates"]) + int(config["interactions"])
    return 4 * n * Pn + 10 * n + 30 * (Pn + 1) + 4 * Pn + 20


def launch_bytes(config: dict, chains: int) -> int:
    """One launch of the fused leaf: q, p, g in and q', p', g' out (C x K
    each), eps in and ld', pi' out (C each), a shared diagonal M^-1 (K),
    X with t's zero column and its rows padded to a multiple of 4, and y;
    four bytes each, every one once."""
    n = int(config["n_obs"])
    K = 2 + int(config["covariates"]) + int(config["interactions"])
    kx = -(-K // 4) * 4
    return 4 * (6 * chains * K + 3 * chains + K + n * kx + n)


if __name__ == "__main__":
    # python3 -m hmcbench.reference.hierarchical_logistic_regression CONFIG OUT
    with open(sys.argv[1]) as f:
        write_moments(json.load(f), torch.device(
            "cuda" if torch.cuda.is_available() else "cpu"), sys.argv[2])
