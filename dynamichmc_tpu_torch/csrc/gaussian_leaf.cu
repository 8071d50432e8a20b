// The Gaussian leapfrog leaf, written for Hopper (sm_90a). One source, two
// entry points:
//   gaussian_leaf_f32      replaces the Pallas kernel
//                          dynamichmc_tpu/ops/pallas_leaf.py::_kernel (the
//                          fused_leaf_batched_fn hook of the plain batch
//                          driver): q', p', g', ld' and pi';
//   gaussian_leapfrog_f32  replaces dynamichmc_tpu/ops/pallas_leapfrog.py::
//                          _kernel (the fused_leapfrog_fn hook of the
//                          per-chain leapfrog): q', p', g', ld'.
//
// For each chain c, with log p(q) = -1/2 (q - mu)^T prec (q - mu) and
// prec = L L^T (L lower):
//   p_mid = p + eps/2 g
//   q'    = q + eps (m_inv * p_mid)          m_inv diagonal: shared (K) or
//                                             per chain (C, K)
//   d     = q' - mu
//   g'    = -(d prec)                         (row vector times matrix)
//   ld'   = -1/2 ||d L||^2                    the whitened sum of squares,
//                                             never d . (prec d)
//   p'    = p_mid + eps/2 g'
//   pi'   = ld' - 1/2 sum m_inv p'^2          (gaussian_leaf_f32 only)
// eps is signed, one per chain. The -inf poisoning of the JAX hooks is
// applied here: ld' becomes -inf when it or any g' is non-finite (unless it
// is -inf already); pi' becomes -inf when it or ld' is non-finite.
//
// Design. A leaf has no tree state, so chains are independent: one warp per
// chain, kWarps = 8 chains per CTA. prec and L are staged in shared memory
// once per CTA when both fit (2 K^2 floats: 5 KB at K = 25, 80 KB at
// K = 100) and read through L1/L2 otherwise. Each warp first writes its
// chain's p_mid and d to shared memory; then lane j of the warp computes
// g'_j and (d L)_j for j = lane, lane + 32, ... as dot products of d (a
// shared-memory broadcast) with column j of prec and of L (consecutive
// lanes read consecutive words: no bank conflicts). The three per-chain
// sums (||d L||^2, the kinetic energy, the count of non-finite g') are
// warp shuffles in a fixed order, so the result is deterministic.
// Arithmetic is plain fp32 FMA: no tensor cores, no TF32, no library call.
//
// What bounds it on the H100: per chain 2 K^2 FMAs and 4 K floats in,
// 3 K + 2 out. At 4096 x 25 that is 5.1 M FMAs and 2.9 MB (about 1 us at
// 3.35 TB/s): far below a launch, so the kernel is launch-bound at the
// path's shapes. At 4096 x 100 the 82 M FMAs read prec and L from shared
// memory (three 4-byte shared loads per two FMAs), and the 512 CTAs stage
// 80 KB each from L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // chains per CTA, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// WRITE_PI: the tree leaf (K2) also writes pi'; otherwise the leapfrog (K4).
// CHAIN_MINV: m_inv is (C, K); otherwise (K,) shared by every chain.
template <bool WRITE_PI, bool CHAIN_MINV>
__global__ void __launch_bounds__(kThreads)
    gaussian_leaf_kernel(const float* __restrict__ q, const float* __restrict__ p,
                         const float* __restrict__ g, const float* __restrict__ minv,
                         const float* __restrict__ eps, const float* __restrict__ prec,
                         const float* __restrict__ lchol, const float* __restrict__ mu,
                         float* __restrict__ qn, float* __restrict__ pn,
                         float* __restrict__ gn, float* __restrict__ ldn,
                         float* __restrict__ pin, int C, int K, int staged) {
  extern __shared__ float smem[];
  const int KK = K * K;
  float* vec = smem + (staged ? 2 * KK : 0);  // [kWarps][2][K]: p_mid, d
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (staged) {
    for (int idx = threadIdx.x; idx < KK; idx += kThreads) {
      smem[idx] = __ldg(prec + idx);
      smem[KK + idx] = __ldg(lchol + idx);
    }
  }
  const float* P = staged ? smem : prec;
  const float* L = staged ? smem + KK : lchol;
  const int c = blockIdx.x * kWarps + warp;
  const bool active = c < C;
  float* pm = vec + warp * 2 * K;
  float* ds = pm + K;
  const float e = active ? __ldg(eps + c) : 0.f;
  const float half = 0.5f * e;
  const size_t row = (size_t)c * K;
  if (active) {
    for (int j = lane; j < K; j += 32) {
      const float m = CHAIN_MINV ? __ldg(minv + row + j) : __ldg(minv + j);
      const float pmj = __ldg(p + row + j) + half * __ldg(g + row + j);
      const float qj = __ldg(q + row + j) + e * (m * pmj);
      pm[j] = pmj;
      ds[j] = qj - __ldg(mu + j);
      qn[row + j] = qj;
    }
  }
  __syncthreads();  // the staged matrices and every warp's p_mid and d
  if (!active) return;

  float w2 = 0.f, kin = 0.f, bad = 0.f;
  for (int j = lane; j < K; j += 32) {
    float pd = 0.f, w = 0.f;
    for (int i = 0; i < K; ++i) {
      const float di = ds[i];
      pd = fmaf(di, P[i * K + j], pd);
      w = fmaf(di, L[i * K + j], w);
    }
    const float gj = -pd;
    const float pj = pm[j] + half * gj;
    w2 = fmaf(w, w, w2);
    if (WRITE_PI) {
      const float m = CHAIN_MINV ? __ldg(minv + row + j) : __ldg(minv + j);
      kin += m * pj * pj;
    }
    bad += isfinite(gj) ? 0.f : 1.f;
    gn[row + j] = gj;
    pn[row + j] = pj;
  }
  w2 = warp_sum(w2);
  bad = warp_sum(bad);
  if (WRITE_PI) kin = warp_sum(kin);
  if (lane == 0) {
    float ld = -0.5f * w2;
    const bool ok = isfinite(ld) && bad == 0.f;
    if (!(ok || ld == neg_inf())) ld = neg_inf();
    ldn[c] = ld;
    if (WRITE_PI) {
      float pi = ld - 0.5f * kin;
      if (!isfinite(pi) || !isfinite(ld)) pi = neg_inf();
      pin[c] = pi;
    }
  }
}

size_t smem_bytes(int K, bool staged) {
  return sizeof(float) * ((staged ? 2 * (size_t)K * K : 0) + (size_t)kWarps * 2 * K);
}

template <bool WRITE_PI, bool CHAIN_MINV>
int launch(const float* q, const float* p, const float* g, const float* minv,
           const float* eps, const float* prec, const float* lchol, const float* mu,
           float* qn, float* pn, float* gn, float* ldn, float* pin, int C, int K,
           cudaStream_t s) {
  const bool staged = smem_bytes(K, true) <= kMaxSmem;
  const size_t smem = smem_bytes(K, staged);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gaussian_leaf_kernel<WRITE_PI, CHAIN_MINV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (C + kWarps - 1) / kWarps;
  gaussian_leaf_kernel<WRITE_PI, CHAIN_MINV><<<blocks, kThreads, smem, s>>>(
      q, p, g, minv, eps, prec, lchol, mu, qn, pn, gn, ldn, pin, C, K, (int)staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One Gaussian tree leaf (K2) for C chains on `stream`. q, p, g, qn, pn, gn
// are (C, K) row-major; minv is (C, K) when chain_minv is 1, else (K,); eps,
// ldn, pin are (C,); prec and lchol (K, K) row-major; mu (K,). Returns the
// cudaGetLastError() of the launch (0 on success).
int gaussian_leaf_f32(const float* q, const float* p, const float* g, const float* minv,
                      int chain_minv, const float* eps, const float* prec,
                      const float* lchol, const float* mu, float* qn, float* pn, float* gn,
                      float* ldn, float* pin, int C, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || K < 1) return (int)cudaErrorInvalidValue;
  return chain_minv
             ? launch<true, true>(q, p, g, minv, eps, prec, lchol, mu, qn, pn, gn, ldn, pin, C, K, s)
             : launch<true, false>(q, p, g, minv, eps, prec, lchol, mu, qn, pn, gn, ldn, pin, C, K, s);
}

// One Gaussian leapfrog step (K4): as gaussian_leaf_f32 without pi'.
int gaussian_leapfrog_f32(const float* q, const float* p, const float* g, const float* minv,
                          int chain_minv, const float* eps, const float* prec,
                          const float* lchol, const float* mu, float* qn, float* pn,
                          float* gn, float* ldn, int C, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || K < 1) return (int)cudaErrorInvalidValue;
  return chain_minv
             ? launch<false, true>(q, p, g, minv, eps, prec, lchol, mu, qn, pn, gn, ldn, nullptr, C, K, s)
             : launch<false, false>(q, p, g, minv, eps, prec, lchol, mu, qn, pn, gn, ldn, nullptr, C, K, s);
}

}  // extern "C"
