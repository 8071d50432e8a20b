"""Split rank-normalized R-hat and bulk/tail ESS on the draws' device (port
of ``dynamichmc_tpu.stats_device``).

Same algorithm and numbers as :mod:`stats` (Vehtari et al. 2021), written
with tensor operations over a leading parameter axis so that it runs where
the draws are: FFT autocovariance (``torch.fft``), average-tied ranks by a
sort plus cummax/cummin run reconstruction, ``torch.special.ndtri``, and
the Geyer initial-positive and monotone sequences as closed-form masked
reductions instead of data-dependent loops. Computed in float64.

Why it exists: the host ESS of 4096 chains x 512 draws x 100 parameters
takes minutes, while the draws already lie on the card. Parity with
:mod:`stats` is ~1e-6 relative in float64.
"""

from __future__ import annotations

import torch


def _split_chains(x):
    """(P, C, N) -> (P, 2C, N//2): split each chain in half."""
    half = x.shape[-1] // 2
    return torch.cat([x[..., :half], x[..., half:2 * half]], dim=-2)


def _rank_normalize(x):
    """Average-tied ranks over each parameter's chains and draws, then the
    inverse normal CDF with Blom offsets (stats._rank_normalize). Tie runs
    are reconstructed from the sorted values with cummax/cummin."""
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


def _rhat_basic(x):
    """Classic split R-hat of each parameter: (P, C, N) -> (P,)."""
    n = x.shape[-1]
    w = x.var(dim=-1, correction=1).mean(-1)
    b = n * x.mean(-1).var(dim=-1, correction=1)
    var_plus = (n - 1) / n * w + b / n
    safe_w = torch.where(w == 0, 1.0, w)
    return torch.where(w == 0, 1.0, torch.sqrt(var_plus / safe_w))


def _ess_basic(x):
    """ESS of each parameter, (P, C, N) -> (P,): Geyer's initial monotone
    positive sequence combined across chains, the closed form of
    stats.ess_basic's loops (see dynamichmc_tpu.stats_device._ess_basic for
    the derivation)."""
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


def _median(flat):
    """np.median of each row: the mean of the two middle values for an even
    count, computed as numpy does (torch.quantile's interpolation can
    differ in the last bit, which reorders near-tied folded draws)."""
    s = torch.sort(flat, dim=1).values
    m = s.shape[1]
    if m % 2:
        return s[:, m // 2]
    return (s[:, m // 2 - 1] + s[:, m // 2]) / 2


def _param_stats(x):
    """(P, C, N) series -> (ess_bulk, ess_tail, rhat), each (P,)."""
    xs = _split_chains(x)
    z = _rank_normalize(xs)
    ess_b = _ess_basic(z)
    flat = x.reshape(x.shape[0], -1)
    qs = torch.quantile(flat, torch.tensor([0.05, 0.95], dtype=x.dtype,
                                           device=x.device), dim=1)
    lo = _ess_basic(_rank_normalize(_split_chains(
        (x <= qs[0][:, None, None]).to(x.dtype))))
    hi = _ess_basic(_rank_normalize(_split_chains(
        (x <= qs[1][:, None, None]).to(x.dtype))))
    folded = (xs - _median(xs.reshape(x.shape[0], -1))[:, None, None]).abs()
    rhat = torch.maximum(_rhat_basic(z), _rhat_basic(_rank_normalize(folded)))
    return ess_b, torch.minimum(lo, hi), rhat


def _param_chunks(x, chunk: int = 0):
    """(C, N, K) draws -> (P, C, N) blocks of ``chunk`` parameters (0 picks
    ~16M chain-draw elements, which bounds the sort and FFT scratch;
    torch.quantile also takes at most 2^24 elements per row)."""
    c, n, k = x.shape
    if chunk <= 0:
        chunk = max(1, (1 << 24) // max(c * n, 1))
    for lo in range(0, k, chunk):
        yield x[:, :, lo:lo + chunk].permute(2, 0, 1).contiguous()


def ess_rhat_device(positions, param_chunk: int = 0) -> dict:
    """Per-parameter bulk/tail ESS and R-hat of (chains, draws, params)
    draws, on their device in float64 (a (draws, params) array is one
    chain). Returns a dict of (params,) tensors ``ess_bulk``, ``ess_tail``
    and ``rhat``, the contract of :func:`stats.ess_rhat`. ``param_chunk``
    parameters are processed at a time (0 picks ~16M elements)."""
    x = torch.as_tensor(positions).to(torch.float64)
    if x.ndim == 2:
        x = x[None]
    parts = [_param_stats(xk) for xk in _param_chunks(x, param_chunk)]
    return {key: torch.cat([p[i] for p in parts])
            for i, key in enumerate(("ess_bulk", "ess_tail", "rhat"))}


def ess_bulk_device(x):
    """Bulk ESS of each parameter of (chains, draws, params) draws, or of
    one (chains, draws) series (then a 0-d tensor), in float64."""
    x = torch.as_tensor(x).to(torch.float64)
    if x.ndim == 2:
        return _ess_basic(_rank_normalize(_split_chains(x[None])))[0]
    return torch.cat([_ess_basic(_rank_normalize(_split_chains(xk)))
                      for xk in _param_chunks(x)])
