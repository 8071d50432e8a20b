// One batched leapfrog leaf of Bayesian logistic regression, written for
// Hopper (sm_90a). It replaces the Pallas kernel
// dynamichmc_tpu/ops/pallas_logreg.py::_make_kernel (the
// fused_leaf_batched_fn hook make_logreg_fused_leaf_batched).
//
// For each chain c:
//   p_mid = p + eps/2 g
//   q'    = q + eps (M^-1 p_mid)           M^-1 shared diagonal (K),
//                                           per-chain diagonal (C, K) or
//                                           shared dense (K, K)
//   l     = X q'                            (n_obs logits)
//   ld'   = sum_i y_i l_i - softplus(l_i) - 1/2 ||q'||^2 / s^2
//   g'    = X^T (y - sigmoid(l)) - q' / s^2
//   p'    = p_mid + eps/2 g'
//   pi'   = ld' - 1/2 p'^T M^-1 p'
// with the stable softplus and the tanh-form sigmoid of pallas_logreg.py and
// its -inf poisoning: ld' becomes -inf when it or any g' is non-finite
// (unless it is -inf already), pi' becomes -inf when it or ld' is
// non-finite.
//
// Design. The leaf has no tree state, so chains are independent and one CTA
// takes a block of BC = 16 chains with 256 threads. It walks X in tiles of
// TN = 64 observations: each tile is staged once in shared memory and used
// by all 16 chains for both products, the Hopper counterpart of the TPU
// kernel keeping X resident in VMEM across both matmuls.
// - Phase A, logits: thread (o, chain group) computes the 4 logits of
//   observation o for 4 chains, reading the tile row and q' as float4 from
//   shared memory (q' is a broadcast; rows are padded by 4 floats so the
//   lanes of a quarter warp hit distinct banks). It adds the chain's
//   likelihood terms and writes the residuals y - sigmoid(l) to shared
//   memory. Observations past n_obs in the last tile are masked: their
//   residual and likelihood term are 0.
// - Phase B, gradient: thread (k, half) accumulates g'[c, k] for 8 chains
//   in registers over the tile's observations: one tile element and two
//   broadcast float4 residual loads per 8 FMAs. Each tile's sum is added
//   to the running sum once, which keeps float32 rounding at the level of
//   cuBLAS's blocked sums (a single running sum over 4000 observations
//   was 5x further from float64, measured on the H100).
// Sums over observations and coordinates are taken in a fixed order (warp
// shuffles, then shared memory), so the result is deterministic. Products
// are plain fp32 FMAs; no TF32.
//
// What bounds it on the H100: 2 n_obs K FMAs per chain (1.0 M at n_obs
// 4000, K 128; 4.2 GFLOP per leaf at 2048 chains) issued from shared memory,
// about 2.5 shared-memory wavefronts per 8 FMAs; X (2 MB) is read from L2
// once per CTA: 256 MB per leaf at 2048 chains. The tile load is not
// overlapped with compute inside a CTA (no cp.async / TMA pipeline yet), and
// 2048 chains make 128 CTAs, one per SM. Tensor cores over the chain block
// (wgmma with fp32-exact splitting) and a TMA ring for the tiles are later
// work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 16;  // chains per CTA
constexpr int kTile = 64;    // observations per staged tile of X
constexpr int kRedFloats = 8 * 24 + 8 * 4;

constexpr int kSharedDiag = 0;
constexpr int kChainDiag = 1;
constexpr int kSharedDense = 2;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 0.5f * (tanhf(0.5f * x) + 1.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// MODE: kSharedDiag, kChainDiag or kSharedDense. KM: K <= 128 * KM.
template <int MODE, int KM>
__global__ void __launch_bounds__(kThreads)
    logreg_leaf_kernel(const float* __restrict__ q, const float* __restrict__ p,
                       const float* __restrict__ g, const float* __restrict__ eps,
                       const float* __restrict__ minv, const float* __restrict__ X,
                       const float* __restrict__ y, float* __restrict__ qn,
                       float* __restrict__ pn, float* __restrict__ gn, float* __restrict__ ldn,
                       float* __restrict__ pin, int C, int K, int n_obs, float inv_s2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int KP4 = (K + 3) & ~3;
  const int XS = KP4 + 4;            // tile row stride (floats)
  float* Xs = smem;                  // [kTile][XS]
  float* Qs = Xs + kTile * XS;       // [kChains][KP4]  q'
  float* Ps = Qs + kChains * KP4;    // [kChains][KP4]  p_mid, then p' (dense)
  float* Rs = Ps + kChains * KP4;    // [kTile][kChains] residuals
  float* red = Rs + kTile * kChains; // reduction scratch
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int c0 = blockIdx.x * kChains;

  // (k, half) mapping: coordinates kl + 128 m of chains ch * 8 + i
  const int kl = t & 127, ch = t >> 7;
  float eps_c[8], half_c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + ch * 8 + i;
    eps_c[i] = c < C ? eps[c] : 0.f;
    half_c[i] = 0.5f * eps_c[i];
  }
  for (int idx = t; idx < 2 * kChains * KP4; idx += kThreads) Qs[idx] = 0.f;  // pads
  __syncthreads();

  float pm[KM][8], qv[KM][8];
#pragma unroll
  for (int m = 0; m < KM; ++m) {
    const int k = kl + 128 * m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + ch * 8 + i;
      const bool v = k < K && c < C;
      const size_t off = (size_t)c * K + k;
      pm[m][i] = (v ? p[off] : 0.f) + half_c[i] * (v ? g[off] : 0.f);
      if (MODE == kSharedDense && k < K) Ps[(ch * 8 + i) * KP4 + k] = pm[m][i];
    }
  }
  if (MODE == kSharedDense) __syncthreads();
#pragma unroll
  for (int m = 0; m < KM; ++m) {
    const int k = kl + 128 * m;
    float drift[8];
    if (MODE == kSharedDense) {
#pragma unroll
      for (int i = 0; i < 8; ++i) drift[i] = 0.f;
      if (k < K) {
        for (int ii = 0; ii < K; ++ii) {
          const float mv = __ldg(minv + (size_t)ii * K + k);
#pragma unroll
          for (int i = 0; i < 8; ++i) drift[i] = fmaf(Ps[(ch * 8 + i) * KP4 + ii], mv, drift[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + ch * 8 + i;
      const bool v = k < K && c < C;
      const size_t off = (size_t)c * K + k;
      if (MODE == kSharedDiag) drift[i] = (k < K ? __ldg(minv + k) : 0.f) * pm[m][i];
      if (MODE == kChainDiag) drift[i] = (v ? __ldg(minv + off) : 0.f) * pm[m][i];
      qv[m][i] = (v ? q[off] : 0.f) + eps_c[i] * drift[i];
      if (k < K) Qs[(ch * 8 + i) * KP4 + k] = qv[m][i];
    }
  }

  // tiles of X: logits (phase A), then the gradient (phase B)
  const int oa = t & (kTile - 1), cg = t / kTile;  // cg in 0..3: chains cg*4..cg*4+3
  float ll[4] = {0.f, 0.f, 0.f, 0.f};
  float G[KM][8];
#pragma unroll
  for (int m = 0; m < KM; ++m)
#pragma unroll
    for (int i = 0; i < 8; ++i) G[m][i] = 0.f;

  for (int o0 = 0; o0 < n_obs; o0 += kTile) {
    __syncthreads();  // the last tile's readers are done; q' is staged
    for (int idx = t; idx < kTile * KP4; idx += kThreads) {
      const int o = idx / KP4;
      const int k = idx - o * KP4;
      const int og = o0 + o;
      Xs[o * XS + k] = (og < n_obs && k < K) ? __ldg(X + (size_t)og * K + k) : 0.f;
    }
    __syncthreads();

    float l[4] = {0.f, 0.f, 0.f, 0.f};
    const float4* xrow = reinterpret_cast<const float4*>(Xs + oa * XS);
    const float4* qrow = reinterpret_cast<const float4*>(Qs + cg * 4 * KP4);
    const int kp4 = KP4 / 4;
    for (int k4 = 0; k4 < kp4; ++k4) {
      const float4 xv = xrow[k4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 q4 = qrow[cc * kp4 + k4];
        l[cc] = fmaf(xv.x, q4.x, l[cc]);
        l[cc] = fmaf(xv.y, q4.y, l[cc]);
        l[cc] = fmaf(xv.z, q4.z, l[cc]);
        l[cc] = fmaf(xv.w, q4.w, l[cc]);
      }
    }
    const int og = o0 + oa;
    const float yi = og < n_obs ? __ldg(y + og) : 0.f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const bool valid = og < n_obs && c0 + cg * 4 + cc < C;
      if (valid) ll[cc] += yi * l[cc] - softplus(l[cc]);
      Rs[oa * kChains + cg * 4 + cc] = valid ? yi - sigmoid(l[cc]) : 0.f;
    }
    __syncthreads();

    // the tile's partial sums, then one add into G: a two-level sum whose
    // rounding error grows with 64 + n_obs / 64 terms, not with n_obs
    float T[KM][8];
#pragma unroll
    for (int m = 0; m < KM; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i) T[m][i] = 0.f;
    const float4* r4 = reinterpret_cast<const float4*>(Rs);
    for (int o = 0; o < kTile; ++o) {
      const float4 ra = r4[o * (kChains / 4) + ch * 2];
      const float4 rb = r4[o * (kChains / 4) + ch * 2 + 1];
      const float rr[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int m = 0; m < KM; ++m) {
        const int k = kl + 128 * m;
        const float xv = k < K ? Xs[o * XS + k] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) T[m][i] = fmaf(xv, rr[i], T[m][i]);
      }
    }
#pragma unroll
    for (int m = 0; m < KM; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i) G[m][i] += T[m][i];
  }
  __syncthreads();  // every reader of Ps (the dense drift) is done

  // epilogue: g', p', outputs, and the per-chain sums
  float kin[8], sq[8], bad[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) kin[i] = sq[i] = bad[i] = 0.f;
  float pnv[KM][8];
#pragma unroll
  for (int m = 0; m < KM; ++m) {
    const int k = kl + 128 * m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + ch * 8 + i;
      const bool v = k < K && c < C;
      const size_t off = (size_t)c * K + k;
      const float gnew = G[m][i] - inv_s2 * qv[m][i];
      const float pnew = pm[m][i] + half_c[i] * gnew;
      pnv[m][i] = pnew;
      if (k < K) {
        sq[i] += qv[m][i] * qv[m][i];
        bad[i] += isfinite(gnew) ? 0.f : 1.f;
        if (MODE == kSharedDiag) kin[i] += __ldg(minv + k) * pnew * pnew;
        if (MODE == kChainDiag && v) kin[i] += __ldg(minv + off) * pnew * pnew;
        if (MODE == kSharedDense) Ps[(ch * 8 + i) * KP4 + k] = pnew;
      }
      if (v) {
        qn[off] = qv[m][i];
        pn[off] = pnew;
        gn[off] = gnew;
      }
    }
  }
  if (MODE == kSharedDense) {
    __syncthreads();
#pragma unroll
    for (int m = 0; m < KM; ++m) {
      const int k = kl + 128 * m;
      if (k < K) {
        float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int ii = 0; ii < K; ++ii) {
          const float mv = __ldg(minv + (size_t)ii * K + k);
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i] = fmaf(Ps[(ch * 8 + i) * KP4 + ii], mv, s[i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) kin[i] += pnv[m][i] * s[i];
      }
    }
  }

  // warp sums: 24 values per warp of the (k, half) mapping (a warp lies in
  // one half), 4 likelihood sums per warp of the phase-A mapping
  float* redB = red;           // [8 warps][24]
  float* redA = red + 8 * 24;  // [8 warps][4]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a = warp_sum(kin[i]), b = warp_sum(sq[i]), d = warp_sum(bad[i]);
    if (lane == 0) {
      redB[warp * 24 + i] = a;
      redB[warp * 24 + 8 + i] = b;
      redB[warp * 24 + 16 + i] = d;
    }
  }
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const float a = warp_sum(ll[cc]);
    if (lane == 0) redA[warp * 4 + cc] = a;
  }
  __syncthreads();
  if (t < kChains && c0 + t < C) {
    const int c = c0 + t;
    const int hb = t / 8, i = t % 8;  // (k, half) mapping: warps 4 hb .. 4 hb + 3
    const int ga = t / 4, cc = t % 4;  // phase-A mapping: warps 2 ga, 2 ga + 1
    float k_sum = 0.f, q_sum = 0.f, n_bad = 0.f;
    for (int w = 0; w < 4; ++w) {
      k_sum += redB[(hb * 4 + w) * 24 + i];
      q_sum += redB[(hb * 4 + w) * 24 + 8 + i];
      n_bad += redB[(hb * 4 + w) * 24 + 16 + i];
    }
    const float l_sum = redA[(ga * 2) * 4 + cc] + redA[(ga * 2 + 1) * 4 + cc];
    float ld = l_sum + (-0.5f * inv_s2 * q_sum);
    float pi = ld - 0.5f * k_sum;
    const bool ok = isfinite(ld) && n_bad == 0.f;
    if (!(ok || ld == neg_inf())) ld = neg_inf();
    if (!isfinite(pi) || !isfinite(ld)) pi = neg_inf();
    ldn[c] = ld;
    pin[c] = pi;
  }
}

size_t smem_bytes(int K) {
  const int KP4 = (K + 3) & ~3;
  return sizeof(float) *
         ((size_t)kTile * (KP4 + 4) + 2 * kChains * KP4 + kTile * kChains + kRedFloats);
}

template <int MODE, int KM>
int launch(const float* q, const float* p, const float* g, const float* eps,
           const float* minv, const float* X, const float* y, float* qn, float* pn,
           float* gn, float* ldn, float* pin, int C, int K, int n_obs, float inv_s2,
           cudaStream_t s) {
  const size_t smem = smem_bytes(K);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(logreg_leaf_kernel<MODE, KM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int blocks = (C + kChains - 1) / kChains;
  logreg_leaf_kernel<MODE, KM><<<blocks, kThreads, smem, s>>>(
      q, p, g, eps, minv, X, y, qn, pn, gn, ldn, pin, C, K, n_obs, inv_s2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One leaf for C chains on `stream`. mode: 0 shared diagonal minv (K),
// 1 per-chain diagonal (C, K), 2 shared dense (K, K). X is (n_obs, K)
// row-major, y (n_obs). K <= 256. Returns the cudaGetLastError() of the
// launch (0 on success).
int logreg_leaf_f32(const float* q, const float* p, const float* g, const float* eps,
                    const float* minv, int mode, const float* X, const float* y, float* qn,
                    float* pn, float* gn, float* ldn, float* pin, int C, int K, int n_obs,
                    float inv_s2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > 256 || C < 1 || n_obs < 1) return (int)cudaErrorInvalidValue;
#define LEAF_LAUNCH(M, KM) \
  launch<M, KM>(q, p, g, eps, minv, X, y, qn, pn, gn, ldn, pin, C, K, n_obs, inv_s2, s)
  const bool wide = K > 128;
  switch (mode) {
    case kSharedDiag:
      return wide ? LEAF_LAUNCH(kSharedDiag, 2) : LEAF_LAUNCH(kSharedDiag, 1);
    case kChainDiag:
      return wide ? LEAF_LAUNCH(kChainDiag, 2) : LEAF_LAUNCH(kChainDiag, 1);
    case kSharedDense:
      return wide ? LEAF_LAUNCH(kSharedDense, 2) : LEAF_LAUNCH(kSharedDense, 1);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LEAF_LAUNCH
}

}  // extern "C"
