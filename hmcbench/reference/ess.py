"""Bulk effective sample size of (chains, draws, params) draws, in float64
on the draws' device.

A frozen copy of the port's ``stats_device.ess_bulk_device`` arithmetic
(Vehtari et al. 2021, "Rank-normalization, folding, and localization: an
improved R-hat", Bayesian Analysis 16(2)): split chains, average-tied
ranks, the inverse normal CDF with Blom offsets, FFT autocovariance, and
Geyer's initial monotone positive sequence in closed form. The benchmark
grades the port with this copy, so a change to the port's statistics
cannot change the yardstick.
"""

from __future__ import annotations

import torch

CHUNK_ELEMENTS = 1 << 26  # chain-draw-parameter elements per block


def _split_chains(x):
    """(P, C, N) -> (P, 2C, N//2): split each chain in half."""
    half = x.shape[-1] // 2
    return torch.cat([x[..., :half], x[..., half:2 * half]], dim=-2)


def _rank_normalize(x):
    """Average-tied ranks over each parameter's chains and draws, then the
    inverse normal CDF with Blom offsets."""
    shape = x.shape
    flat = x.reshape(shape[0], -1)
    m = flat.shape[1]
    svals, order = torch.sort(flat, dim=1)
    idx = torch.arange(m, device=x.device).expand_as(flat)
    ones = torch.ones((flat.shape[0], 1), dtype=torch.bool, device=x.device)
    starts = torch.cat([ones, svals[:, 1:] != svals[:, :-1]], dim=1)
    start_of_run = torch.cummax(torch.where(starts, idx, -1), dim=1).values
    is_end = torch.cat([starts[:, 1:], ones], dim=1)
    end_of_run = torch.flip(torch.cummin(
        torch.flip(torch.where(is_end, idx, m), [1]), dim=1).values, [1])
    avg = (start_of_run + end_of_run).to(x.dtype) * 0.5 + 1.0
    ranks = torch.empty_like(flat).scatter_(1, order, avg)
    return torch.special.ndtri((ranks - 0.375) / (m + 0.25)).reshape(shape)


def _autocovariance_fft(x):
    """Biased autocovariance of each row: (..., N) -> (..., N)."""
    n = x.shape[-1]
    xc = x - x.mean(dim=-1, keepdim=True)
    size = 1
    while size < 2 * n:
        size *= 2
    f = torch.fft.rfft(xc, size, dim=-1)
    return torch.fft.irfft(f * f.conj(), size, dim=-1)[..., :n] / n


def _ess_basic(x):
    """ESS of each parameter, (P, C, N) -> (P,): Geyer's initial monotone
    positive sequence combined across chains, in closed form."""
    P, c, n = x.shape
    ess_total = torch.full((P,), float(c * n), dtype=x.dtype, device=x.device)
    if n < 4:
        return ess_total
    acov = _autocovariance_fft(x)
    mean_var = (acov[..., 0] * n / (n - 1)).mean(-1)
    var_plus = mean_var * (n - 1) / n
    if c > 1:
        var_plus = var_plus + x.mean(-1).var(dim=-1, correction=1)
    safe_vp = torch.where(var_plus == 0, 1.0, var_plus)
    rho = 1.0 - (mean_var[:, None] - acov.mean(1)) / safe_vp[:, None]
    rho[:, 0] = 1.0

    npairs = n // 2
    k = torch.arange(npairs, device=x.device)
    pair_sums = rho[:, 2 * k] + rho[:, torch.clamp(2 * k + 1, max=n - 1)]
    q0 = 1.0 + rho[:, 1]
    pos = (pair_sums > 0).to(torch.int64)
    prev_all_pos = torch.cat([
        torch.ones((P, 1), dtype=torch.bool, device=x.device),
        torch.cumprod(pos, dim=1)[:, :-1].bool(),
    ], dim=1)
    computed = prev_all_pos & (2 * k - 1 < n - 3) & (k >= 1)
    n_computed = computed.sum(1)
    interior = computed & (k < n_computed[:, None])
    seq = torch.where(interior, pair_sums, torch.inf)
    seq[:, 0] = q0
    mono = torch.cummin(seq, dim=1).values
    interior_sum = torch.where(interior, mono, 0.0).sum(1)
    rows = torch.arange(P, device=x.device)
    last_even = rho[rows, torch.clamp(2 * n_computed, max=n - 1)]
    last_pair = pair_sums[rows, torch.clamp(n_computed, max=npairs - 1)]
    final_term = torch.where(
        n_computed == 0, 1.0,
        torch.where((last_pair >= 0) | (last_even > 0), last_even, 0.0))
    tau = -1.0 + 2.0 * (torch.where(n_computed >= 1, q0, 0.0)
                        + interior_sum) + final_term
    tau = torch.maximum(tau, 1.0 / torch.log10(ess_total))
    return torch.where(var_plus == 0, ess_total, ess_total / tau)


def ess_bulk(positions: torch.Tensor) -> torch.Tensor:
    """Bulk ESS of each parameter of (chains, draws, params) draws, (params,)
    in float64, a block of parameters at a time (CHUNK_ELEMENTS)."""
    c, n, k = positions.shape
    chunk = max(1, CHUNK_ELEMENTS // max(c * n, 1))
    parts = []
    for lo in range(0, k, chunk):
        x = positions[:, :, lo:lo + chunk].permute(2, 0, 1).to(torch.float64)
        parts.append(_ess_basic(_rank_normalize(_split_chains(x))))
        del x
    return torch.cat(parts)
