// fastdiag: native batch convergence diagnostics for dynamichmc_tpu_torch.
//
// Split rank-normalized R-hat and bulk/tail ESS (Vehtari et al. 2021) over
// (chains, draws, params) arrays, OpenMP-parallel over params. Exact
// computational parity with the numpy implementation in ../stats.py (which
// remains the fallback and the test oracle): average-tied ranks (scipy
// rankdata(method="average")), Blom offsets, Geyer initial monotone
// positive sequence on the biased autocovariance.
//
// The reference (tpapp/DynamicHMC.jl) delegates these statistics to
// MCMCDiagnosticTools; this host engine serves 4096-chain fleets, where
// the per-parameter Python loop dominates post-processing time. It is the
// JAX package's native/fastdiag.cpp, kept as the port's own source.
//
// Build: g++ -O3 -march=native -fPIC -shared -fopenmp -std=c++17, at first
// use, by native/__init__.py; loaded via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Acklam's rational approximation to the inverse normal CDF, refined with
// one Halley step: ~1e-15 relative accuracy, matching scipy.special.ndtri
// to double precision for our purposes.
double inv_norm_cdf(double p) {
    if (p <= 0.0) return -HUGE_VAL;
    if (p >= 1.0) return HUGE_VAL;
    static const double a[] = {-3.969683028665376e+01, 2.209460984245205e+02,
                               -2.759285104469687e+02, 1.383577518672690e+02,
                               -3.066479806614716e+01, 2.506628277459239e+00};
    static const double b[] = {-5.447609879822406e+01, 1.615858368580409e+02,
                               -1.556989798598866e+02, 6.680131188771972e+01,
                               -1.328068155288572e+01};
    static const double c[] = {-7.784894002430293e-03, -3.223964580411365e-01,
                               -2.400758277161838e+00, -2.549732539343734e+00,
                               4.374664141464968e+00,  2.938163982698783e+00};
    static const double d[] = {7.784695709041462e-03, 3.224671290700398e-01,
                               2.445134137142996e+00, 3.754408661907416e+00};
    const double plow = 0.02425, phigh = 1 - plow;
    double x;
    if (p < plow) {
        double q = std::sqrt(-2 * std::log(p));
        x = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) /
            ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1);
    } else if (p <= phigh) {
        double q = p - 0.5, r = q * q;
        x = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q /
            (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1);
    } else {
        double q = std::sqrt(-2 * std::log(1 - p));
        x = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) /
            ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1);
    }
    // one Halley refinement
    double e = 0.5 * std::erfc(-x / std::sqrt(2.0)) - p;
    double u = e * std::sqrt(2 * M_PI) * std::exp(x * x / 2);
    x = x - u / (1 + x * u / 2);
    return x;
}

// Rank-normalize in place: average-tied ranks (1-based, scipy
// rankdata(method="average") semantics, matching stats.py) -> Blom -> ndtri.
// Tie averaging is load-bearing for tail ESS: the 0/1 quantile-indicator
// series is ~95% ties, and ordinal ranks would inject an artificial
// per-chain monotone ramp that collapses the ESS.
void rank_normalize(double* x, int64_t n, std::vector<int64_t>& order) {
    order.resize(n);
    std::iota(order.begin(), order.end(), 0);
    // NaN-aware comparator: plain `x[i] < x[j]` makes NaN "equivalent" to
    // everything while finite elements stay ordered — not a strict weak
    // ordering, which is UB for std::stable_sort. Order NaN last
    // deterministically (numpy argsort semantics).
    std::stable_sort(order.begin(), order.end(), [&](int64_t i, int64_t j) {
        const bool ni = std::isnan(x[i]), nj = std::isnan(x[j]);
        if (ni || nj) return nj && !ni;
        return x[i] < x[j];
    });
    const double denom = n + 0.25;
    int64_t r = 0;
    while (r < n) {
        int64_t run_end = r + 1;
        const double v = x[order[r]];
        while (run_end < n && x[order[run_end]] == v) ++run_end;
        // average 1-based rank of the tied run [r, run_end)
        const double avg_rank = (double(r + 1) + double(run_end)) / 2.0;
        const double z = inv_norm_cdf((avg_rank - 0.375) / denom);
        for (int64_t i = r; i < run_end; ++i) x[order[i]] = z;
        r = run_end;
    }
}

// Classic split R-hat on (C, N) row-major data.
double rhat_basic(const double* x, int64_t c, int64_t n) {
    double w = 0.0, mean_of_means = 0.0;
    std::vector<double> means(c);
    for (int64_t i = 0; i < c; ++i) {
        const double* row = x + i * n;
        double m = 0;
        for (int64_t t = 0; t < n; ++t) m += row[t];
        m /= n;
        means[i] = m;
        double v = 0;
        for (int64_t t = 0; t < n; ++t) {
            double d = row[t] - m;
            v += d * d;
        }
        w += v / (n - 1);
        mean_of_means += m;
    }
    w /= c;
    mean_of_means /= c;
    double b = 0;
    for (int64_t i = 0; i < c; ++i) {
        double d = means[i] - mean_of_means;
        b += d * d;
    }
    b = n * b / (c - 1);
    double var_plus = (n - 1.0) / n * w + b / n;
    if (w == 0) return 1.0;
    return std::sqrt(var_plus / w);
}

// Bulk ESS on (C, N): biased autocovariances computed directly per lag
// (identical values to the FFT route), Geyer initial monotone positive
// sequence, combined across chains (Vehtari et al. 2021 eq. 10).
double ess_basic(const double* x, int64_t c, int64_t n) {
    if (n < 4) return double(c) * n;
    std::vector<double> means(c), acov0(c);
    for (int64_t i = 0; i < c; ++i) {
        const double* row = x + i * n;
        double m = 0;
        for (int64_t t = 0; t < n; ++t) m += row[t];
        means[i] = m / n;
    }
    auto acov_lag = [&](int64_t lag) {
        // mean over chains of the biased autocovariance at `lag`
        double total = 0;
        for (int64_t i = 0; i < c; ++i) {
            const double* row = x + i * n;
            const double m = means[i];
            double s = 0;
            for (int64_t t = 0; t + lag < n; ++t)
                s += (row[t] - m) * (row[t + lag] - m);
            total += s / n;
        }
        return total / c;
    };
    double mean_acov0 = 0;
    for (int64_t i = 0; i < c; ++i) {
        const double* row = x + i * n;
        double s = 0;
        for (int64_t t = 0; t < n; ++t) {
            double d = row[t] - means[i];
            s += d * d;
        }
        acov0[i] = s / n;
        mean_acov0 += acov0[i];
    }
    mean_acov0 /= c;
    double mean_var = mean_acov0 * double(n) / (n - 1);
    double var_plus = mean_var * (n - 1.0) / n;
    if (c > 1) {
        double mm = 0;
        for (int64_t i = 0; i < c; ++i) mm += means[i];
        mm /= c;
        double b = 0;
        for (int64_t i = 0; i < c; ++i) {
            double d = means[i] - mm;
            b += d * d;
        }
        var_plus += b / (c - 1);
    }
    if (var_plus == 0) return double(c) * n;

    std::vector<double> rho(n, 0.0);
    rho[0] = 1.0;
    double rho_even = 1.0;
    double rho_odd = 1 - (mean_var - acov_lag(1)) / var_plus;
    rho[1] = rho_odd;
    int64_t t = 1;
    while (t < n - 3 && (rho_even + rho_odd) > 0) {
        rho_even = 1 - (mean_var - acov_lag(t + 1)) / var_plus;
        rho_odd = 1 - (mean_var - acov_lag(t + 2)) / var_plus;
        if (rho_even + rho_odd >= 0) {
            rho[t + 1] = rho_even;
            rho[t + 2] = rho_odd;
        }
        t += 2;
    }
    int64_t max_t = t - 2;
    if (rho_even > 0) rho[max_t + 1] = rho_even;
    t = 1;
    while (t <= max_t - 2) {
        if (rho[t + 1] + rho[t + 2] > rho[t - 1] + rho[t]) {
            rho[t + 1] = (rho[t - 1] + rho[t]) / 2;
            rho[t + 2] = rho[t + 1];
        }
        t += 2;
    }
    double ess_total = double(c) * n;
    double tau = -1.0;
    for (int64_t k = 0; k <= max_t; ++k) tau += 2 * rho[k];
    tau += rho[max_t + 1];
    tau = std::max(tau, 1.0 / std::log10(ess_total));
    return ess_total / tau;
}

// numpy type-7 (linear interpolation) quantile of unsorted data.
double quantile7(std::vector<double> v, double q) {
    if (v.empty()) return std::numeric_limits<double>::quiet_NaN();
    std::sort(v.begin(), v.end());
    double pos = q * (v.size() - 1);
    int64_t lo = (int64_t)std::floor(pos);
    int64_t hi = std::min<int64_t>(lo + 1, v.size() - 1);
    double frac = pos - lo;
    return v[lo] * (1 - frac) + v[hi] * frac;
}

struct Work {
    std::vector<double> split;   // (2C, N/2)
    std::vector<double> buf;     // scratch for rank/fold
    std::vector<int64_t> order;  // sort scratch
};

// Full per-parameter pipeline on (C, N) data for one parameter.
void one_param(const double* x, int64_t c, int64_t n, Work& w, double* ess_bulk,
               double* ess_tail, double* rhat) {
    int64_t half = n / 2, c2 = 2 * c, m = c2 * half;
    if (half < 2) {
        // split rank-normalized statistics need >= 2 draws per half; a
        // degenerate n would index empty buffers (out-of-bounds) below
        const double nan = std::numeric_limits<double>::quiet_NaN();
        *ess_bulk = *ess_tail = *rhat = nan;
        return;
    }
    w.split.resize(m);
    for (int64_t i = 0; i < c; ++i) {
        std::memcpy(&w.split[i * half], x + i * n, half * sizeof(double));
        std::memcpy(&w.split[(c + i) * half], x + i * n + half,
                    half * sizeof(double));
    }
    // bulk ESS + bulk rhat on rank-normalized split chains
    w.buf.assign(w.split.begin(), w.split.end());
    rank_normalize(w.buf.data(), m, w.order);
    *ess_bulk = ess_basic(w.buf.data(), c2, half);
    double bulk_rhat = rhat_basic(w.buf.data(), c2, half);
    // tail rhat: folded around the median, rank-normalized
    std::vector<double> med_src(w.split);
    double med = quantile7(med_src, 0.5);
    w.buf.resize(m);
    for (int64_t i = 0; i < m; ++i) w.buf[i] = std::fabs(w.split[i] - med);
    rank_normalize(w.buf.data(), m, w.order);
    double tail_rhat = rhat_basic(w.buf.data(), c2, half);
    *rhat = std::max(bulk_rhat, tail_rhat);
    // tail ESS: indicator chains at the 5% / 95% quantiles of the raw draws
    std::vector<double> all(x, x + c * n);
    double q05 = quantile7(all, 0.05), q95 = quantile7(all, 0.95);
    double tails[2];
    for (int k = 0; k < 2; ++k) {
        double thr = k == 0 ? q05 : q95;
        for (int64_t i = 0; i < m; ++i)
            w.buf[i] = w.split[i] <= thr ? 1.0 : 0.0;
        rank_normalize(w.buf.data(), m, w.order);
        tails[k] = ess_basic(w.buf.data(), c2, half);
    }
    *ess_tail = std::min(tails[0], tails[1]);
}

}  // namespace

extern "C" {

// x: (C, N, K) row-major doubles. Outputs: K-vectors.
void ess_rhat_batch(const double* x, int64_t c, int64_t n, int64_t k,
                    double* ess_bulk, double* ess_tail, double* rhat) {
#pragma omp parallel
    {
        Work w;
        std::vector<double> param((size_t)c * n);
#pragma omp for schedule(dynamic)
        for (int64_t j = 0; j < k; ++j) {
            // gather parameter j into contiguous (C, N)
            for (int64_t i = 0; i < c; ++i)
                for (int64_t t = 0; t < n; ++t)
                    param[i * n + t] = x[(i * n + t) * k + j];
            one_param(param.data(), c, n, w, &ess_bulk[j], &ess_tail[j],
                      &rhat[j]);
        }
    }
}

int fastdiag_version() { return 1; }
}
