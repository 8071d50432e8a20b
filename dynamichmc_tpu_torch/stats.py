"""Split rank-normalized R-hat and ESS (port of ``dynamichmc_tpu.stats``).

Vehtari, Gelman, Simpson, Carpenter, Bürkner (2021): "Rank-normalization,
folding, and localization: an improved R-hat for assessing convergence of
MCMC". Host-side numpy and scipy on (chains, draws) arrays, so the port
computes ESS on a machine without JAX. Same algorithm and numbers as the
JAX package's module.
"""

from __future__ import annotations

import numpy as np
from scipy.special import ndtri


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(C, N) -> (2C, N//2): split each chain in half."""
    _c, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Average-tied ranks over all chains and draws, then the inverse normal
    CDF with Blom offsets. Tie averaging matters: ess_tail ranks 0/1
    indicator series that are mostly ties."""
    shape = x.shape
    flat = x.ravel()
    n = flat.size
    order = np.argsort(flat, kind="mergesort")
    svals = flat[order]
    starts = np.empty(n, dtype=bool)
    starts[0] = True
    np.not_equal(svals[1:], svals[:-1], out=starts[1:])
    run_id = np.cumsum(starts) - 1
    start_idx = np.flatnonzero(starts)
    end_idx = np.append(start_idx[1:], n)
    avg = (start_idx + 1 + end_idx) / 2.0
    ranks = np.empty(n, dtype=np.float64)
    ranks[order] = avg[run_id]
    return ndtri((ranks - 0.375) / (n + 0.25)).reshape(shape)


def _rhat_basic(x: np.ndarray) -> float:
    """Classic split R-hat on (C, N)."""
    _c, n = x.shape
    chain_means = x.mean(axis=1)
    w = x.var(axis=1, ddof=1).mean()
    b = n * chain_means.var(ddof=1)
    if w == 0:
        return 1.0
    return float(np.sqrt(((n - 1) / n * w + b / n) / w))


def rhat(x: np.ndarray) -> float:
    """Maximum of bulk (rank-normalized) and tail (folded) split R-hat for
    one parameter's (chains, draws)."""
    xs = _split_chains(np.asarray(x, np.float64))
    bulk = _rhat_basic(_rank_normalize(xs))
    tail = _rhat_basic(_rank_normalize(np.abs(xs - np.median(xs))))
    return max(bulk, tail)


def _autocovariance_fft(x: np.ndarray) -> np.ndarray:
    """Biased autocovariance of each row via FFT: (C, N) -> (C, N)."""
    _c, n = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, size, axis=1)
    acov = np.fft.irfft(f * np.conjugate(f), size, axis=1)[:, :n].real
    return acov / n


def ess_basic(x: np.ndarray) -> float:
    """ESS on (C, N) with Geyer's initial monotone positive sequence,
    combined across chains as in Vehtari et al. (2021), eq. 10."""
    x = np.asarray(x, np.float64)
    c, n = x.shape
    if n < 4:
        return float(c * n)
    acov = _autocovariance_fft(x)
    mean_var = (acov[:, 0] * n / (n - 1)).mean()
    var_plus = mean_var * (n - 1) / n
    if c > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus == 0:
        return float(c * n)
    rho_hat = np.zeros(n)
    rho_hat[0] = 1.0
    rho_hat_even = 1.0
    rho_hat_odd = 1 - (mean_var - acov[:, 1].mean()) / var_plus
    rho_hat[1] = rho_hat_odd
    # Geyer initial positive sequence
    t = 1
    while t < n - 3 and (rho_hat_even + rho_hat_odd) > 0:
        rho_hat_even = 1 - (mean_var - acov[:, t + 1].mean()) / var_plus
        rho_hat_odd = 1 - (mean_var - acov[:, t + 2].mean()) / var_plus
        if rho_hat_even + rho_hat_odd >= 0:
            rho_hat[t + 1] = rho_hat_even
            rho_hat[t + 2] = rho_hat_odd
        t += 2
    max_t = t - 2
    if rho_hat_even > 0:
        rho_hat[max_t + 1] = rho_hat_even
    # Geyer initial monotone sequence
    t = 1
    while t <= max_t - 2:
        if rho_hat[t + 1] + rho_hat[t + 2] > rho_hat[t - 1] + rho_hat[t]:
            rho_hat[t + 1] = (rho_hat[t - 1] + rho_hat[t]) / 2
            rho_hat[t + 2] = rho_hat[t + 1]
        t += 2
    ess_total = c * n
    tau_hat = -1 + 2 * rho_hat[:max_t + 1].sum() + rho_hat[max_t + 1]
    tau_hat = max(tau_hat, 1 / np.log10(ess_total))
    return float(ess_total / tau_hat)


def ess_bulk(x: np.ndarray) -> float:
    """Bulk ESS: rank-normalized, split."""
    return ess_basic(_rank_normalize(_split_chains(np.asarray(x, np.float64))))


def ess_tail(x: np.ndarray) -> float:
    """Tail ESS: min of the 5% and 95% quantile-indicator ESS."""
    x = np.asarray(x, np.float64)
    q05, q95 = np.quantile(x, [0.05, 0.95])
    lo = ess_basic(_rank_normalize(_split_chains((x <= q05).astype(np.float64))))
    hi = ess_basic(_rank_normalize(_split_chains((x <= q95).astype(np.float64))))
    return min(lo, hi)


def ess_rhat(positions: np.ndarray) -> dict:
    """Per-parameter bulk/tail ESS and R-hat of (chains, draws, params)
    draws; a (draws, params) array is one chain."""
    positions = np.asarray(positions, np.float64)
    if positions.ndim == 2:
        positions = positions[None]
    k = positions.shape[2]
    out = {"ess_bulk": np.empty(k), "ess_tail": np.empty(k), "rhat": np.empty(k)}
    for j in range(k):
        x = positions[:, :, j]
        out["ess_bulk"][j] = ess_bulk(x)
        out["ess_tail"][j] = ess_tail(x)
        out["rhat"][j] = rhat(x)
    return out
