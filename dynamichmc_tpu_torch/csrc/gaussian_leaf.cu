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
// Design: a block of chains per CTA, as the JAX kernel's (block_c, K) tile
// times the whole matrices, register-tiled by hand. A CTA of W warps takes
// a tile of W * R chains (the launch plan, ops/gaussian_leaf.py::
// launch_plan, picks R and W; R is 8, or 1 for a single chain):
//   1. prec and L are staged once per CTA with cp.async (16 bytes a thread
//      where the matrices are 16-byte aligned, a 4-byte tail), while the
//      CTA's threads run the tile's kick and drift over its rows, which lie
//      contiguous in memory (coalesced, 8 elements in flight a thread, 2
//      for a single chain). The tile's d goes to shared memory with the R
//      chains of a warp adjacent for each coordinate i, p_mid beside it,
//      and, when the matrices are staged, m_inv and eps / 2 too, so that
//      the epilogue makes no global load. Where the matrices do not fit
//      beside the tile, they are read through L1/L2.
//   2. Warp w owns chains w R .. w R + R - 1; lane j computes g'_j and
//      (d L)_j for j = lane, lane + 32, ... for its R chains at once: per
//      coordinate i it loads prec[i][j] and L[i][j] once (consecutive lanes
//      on consecutive words: no bank conflicts) and the R chains' d_i in
//      two 16-byte broadcast loads, for 2 R FMAs: at R = 8, 4 shared loads
//      per 16 FMAs, so the FMA units and not shared memory set the pace.
//   3. Each lane sums ||d L||^2 and the kinetic energy over its own
//      columns; then the xor butterfly over the warp's 32 lanes, for the 8
//      chains at once (warp_sum_transposed: 9 shuffles a sum, not 40), and
//      one OR-reduction of the chains' poison flags.
// Every output is computed in the order of the one-warp-per-chain kernel
// this design replaced (a sequential fmaf over i per column, the lane's
// columns in order, the same butterfly tree and expression forms), so q',
// p', g', ld' and pi' are bitwise that kernel's at every K up to kExactK =
// 256; past it each column's sum is compensated (see column()).
// Arithmetic is plain fp32 FMA: no tensor cores, no TF32, no library call.
//
// What bounds it on the H100: per chain 2 K^2 FMAs and 4 K floats in, 3 K
// + 2 out. At 4096 x 25 that is 5.1 M FMAs and 2.9 MB (about 1 us at
// 3.35 TB/s): one launch and a single wave of 128 CTAs of 32 chains,
// whose time is latency (a first round trip to memory of some 2,000
// clocks, the products' shared loads with one warp a scheduler). At
// 4096 x 100 the 82 M FMAs are the work: 128 CTAs of 4 warps stage 80 KB
// each, and each warp runs 16 FMAs per 4 shared loads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxWarps = 8;          // warps per CTA, at most
constexpr int kExactK = 256;  // past it the column sums are compensated
constexpr size_t kMaxSmem = 232448;   // H100: dynamic shared memory per CTA

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// warp_sum of the R values of every lane at once, for R = 8: on return
// lane l holds the sum of v[l / 4] (and v[l / 4] of every lane), bitwise
// what warp_sum(v[l / 4]) gives. Each of the xor steps 16, 8 and 4 adds
// the same pairs as warp_sum's but keeps half of the values a lane holds,
// the ones its lane bit 4, 3, 2 selects, so 4 + 2 + 1 + 1 + 1 shuffles
// replace 8 x 5.
template <int R>
__device__ __forceinline__ float warp_sum_transposed(const float (&v)[R], int lane) {
  static_assert(R == 8, "the transposed butterfly is for R = 8");
  float a[4], b[2];
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float mine = h4 ? v[4 + k] : v[k];
    a[k] = mine + __shfl_xor_sync(0xffffffffu, h4 ? v[k] : v[4 + k], 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float mine = h3 ? a[2 + k] : a[k];
    b[k] = mine + __shfl_xor_sync(0xffffffffu, h3 ? a[k] : a[2 + k], 8);
  }
  float s = (h2 ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, h2 ? b[0] : b[1], 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

// 16-byte asynchronous copy global -> shared, bypassing L1 (cg).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
// 4-byte asynchronous copy global -> shared (cg takes 16 bytes only).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Floats of one staged matrix: K^2 rounded up to 4, so that what follows
// stays 16-byte aligned.
__host__ __device__ __forceinline__ int matrix_floats(int K) { return (K * K + 3) & ~3; }

// Dynamic shared memory of one CTA (ops/gaussian_leaf.py::smem_bytes): the
// tile's d and p_mid; when staged, also prec and L and the tile's m_inv and
// eps / 2, which the epilogue then reads from shared memory.
size_t smem_bytes(int K, int chains, bool staged) {
  const size_t TK = (size_t)chains * K;
  return sizeof(float) * (staged ? 2 * (size_t)matrix_floats(K) + 3 * TK + chains : 2 * TK);
}

// s + c += a b, with the product's and the addition's rounding errors
// (TwoProduct by fmaf, TwoSum) carried in c. The _rn intrinsics are never
// contracted into an FMA, which would void TwoSum.
__device__ __forceinline__ void dot2_step(float a, float b, float& s, float& c) {
  const float p = __fmul_rn(a, b);
  const float pe = fmaf(a, b, -p);
  const float t = __fadd_rn(s, p);
  const float z = __fsub_rn(t, s);
  const float se = __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(p, z));
  c = __fadd_rn(c, __fadd_rn(se, pe));
  s = t;
}

// The R chains' d_i, adjacent in shared memory (16-byte aligned for R = 8).
template <int R>
__device__ __forceinline__ void load_chains(const float* src, float (&d)[R]) {
  if constexpr (R == 8) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
    d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
  } else {
    static_assert(R == 1, "R is 1 or 8");
    d[0] = src[0];
  }
}

// Column j of d prec and d L for the warp's R chains. Up to K = kExactK a
// sequential fmaf over i, the order of the one-warp-per-chain kernel; past
// it a compensated sum (the products' and the additions' rounding errors
// carried in a second float, Ogita, Rump and Oishi's Dot2), since one
// running sum over K = 3632 lay 2.7 times as far from float64 as the plain
// float32 version on the H100. STAGED: prec and L in shared memory;
// otherwise through L1/L2.
template <int R, bool STAGED, bool COMPENSATED>
__device__ __forceinline__ void column(const float* __restrict__ P,
                                       const float* __restrict__ L,
                                       const float* __restrict__ dw, int K, int j,
                                       float (&pd)[R], float (&w)[R]) {
  float cp[R], cw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) pd[r] = w[r] = cp[r] = cw[r] = 0.f;
#pragma unroll 4
  for (int i = 0; i < K; ++i) {
    const float pij = STAGED ? P[i * K + j] : __ldg(P + i * K + j);
    const float lij = STAGED ? L[i * K + j] : __ldg(L + i * K + j);
    float d[R];
    load_chains<R>(dw + i * R, d);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (COMPENSATED) {
        dot2_step(d[r], pij, pd[r], cp[r]);
        dot2_step(d[r], lij, w[r], cw[r]);
      } else {
        pd[r] = fmaf(d[r], pij, pd[r]);
        w[r] = fmaf(d[r], lij, w[r]);
      }
    }
  }
  if (COMPENSATED) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pd[r] += cp[r];
      w[r] += cw[r];
    }
  }
}

// m_inv at column j of the n (at most R) chains from chain c, into m; left
// as it is past the last column.
template <bool CHAIN_MINV, int R>
__device__ __forceinline__ void minv_column(const float* __restrict__ minv, int c, int n,
                                            int K, int j, float (&m)[R]) {
  if (j >= K) return;
  const float shared_m = CHAIN_MINV ? 0.f : __ldg(minv + j);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < n) m[r] = CHAIN_MINV ? __ldg(minv + (size_t)(c + r) * K + j) : shared_m;
}

// WRITE_PI: the tree leaf (K2) also writes pi'; otherwise the leapfrog (K4).
// CHAIN_MINV: m_inv is (C, K); otherwise (K,) shared by every chain.
// R: chains per warp. The CTA's blockDim.x / 32 warps take blockDim.x / 32
// * R consecutive chains. COMPENSATED: the column sums of K > kExactK.
// One CTA per SM is all a plan asks (the grid is one wave), so the
// registers are not capped for a second.
template <bool WRITE_PI, bool CHAIN_MINV, int R, bool COMPENSATED>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    gaussian_leaf_kernel(const float* __restrict__ q, const float* __restrict__ p,
                         const float* __restrict__ g, const float* __restrict__ minv,
                         const float* __restrict__ eps, const float* __restrict__ prec,
                         const float* __restrict__ lchol, const float* __restrict__ mu,
                         float* __restrict__ qn, float* __restrict__ pn,
                         float* __restrict__ gn, float* __restrict__ ldn,
                         float* __restrict__ pin, int C, int K, int staged) {
  // Kick-and-drift elements in flight a thread: 8 with 8 chains a warp, 2
  // for a single chain, whose shorter code path paid more than the loads
  // in flight when both were timed on the H100 at 1 x 1 and 1 x 25.
  constexpr int kKick = R == 1 ? 2 : 8;
  extern __shared__ __align__(16) float smem[];
  const int threads = blockDim.x;
  const int T = (threads >> 5) * R;  // chains of the tile
  const int c0 = blockIdx.x * T;
  const int nc = min(T, C - c0);  // of them, chains that exist
  const int KK = K * K;
  const int mat = staged ? matrix_floats(K) : 0;
  float* const ds = smem + 2 * mat;  // [warp][i][R]: d, R chains adjacent
  float* const pm = ds + T * K;      // [chain][j]: p_mid
  float* const ms = pm + T * K;      // [chain][j]: m_inv, when staged
  float* const hs = ms + T * K;      // [chain]: eps / 2, when staged

  if (staged) {  // lands while the kick and drift run
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(prec) | reinterpret_cast<uintptr_t>(lchol)) & 15) == 0;
    const int n4 = aligned ? KK / 4 : 0;
    for (int v = threadIdx.x; v < n4; v += threads) {
      cp_async16(smem + 4 * v, prec + 4 * v);
      cp_async16(smem + mat + 4 * v, lchol + 4 * v);
    }
    for (int idx = 4 * n4 + threadIdx.x; idx < KK; idx += threads) {
      cp_async4(smem + idx, prec + idx);
      cp_async4(smem + mat + idx, lchol + idx);
    }
  }

  // Kick and drift: the tile's rows are nc K contiguous floats from c0 K,
  // kKick elements a thread at a time, all their loads sent first.
  const size_t base = (size_t)c0 * K;
  const int TK = T * K, NK = nc * K;
  const int step_c = threads / K, step_j = threads - step_c * K;
  int cl_next = threadIdx.x / K, j_next = threadIdx.x - cl_next * K;
  for (int e0 = threadIdx.x; e0 < TK; e0 += kKick * threads) {
    float ev[kKick], mv[kKick], pv[kKick], gv[kKick], qv[kKick], muv[kKick];
    int clv[kKick], jv[kKick];  // element e0 + u threads is (clv, jv)
#pragma unroll
    for (int u = 0; u < kKick; ++u) {
      clv[u] = cl_next;
      jv[u] = j_next;
      cl_next += step_c;
      j_next += step_j;
      if (j_next >= K) {
        j_next -= K;
        ++cl_next;
      }
    }
#pragma unroll
    for (int u = 0; u < kKick; ++u) {
      const int e = e0 + u * threads;
      if (e < NK) {
        ev[u] = __ldg(eps + c0 + clv[u]);
        mv[u] = CHAIN_MINV ? __ldg(minv + base + e) : __ldg(minv + jv[u]);
        pv[u] = __ldg(p + base + e);
        gv[u] = __ldg(g + base + e);
        qv[u] = __ldg(q + base + e);
        muv[u] = __ldg(mu + jv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kKick; ++u) {
      const int e = e0 + u * threads;
      if (e < TK) {
        const int cl = clv[u], j = jv[u];
        float pmj = 0.f, dj = 0.f;
        if (e < NK) {
          const float half = 0.5f * ev[u];
          pmj = pv[u] + half * gv[u];
          const float qj = qv[u] + ev[u] * (mv[u] * pmj);
          dj = qj - muv[u];
          qn[base + e] = qj;
        }
        pm[e] = pmj;
        ds[((cl / R) * K + j) * R + cl % R] = dj;
        if (staged) {
          if (WRITE_PI) ms[e] = e < NK ? mv[u] : 0.f;
          if (j == 0) hs[cl] = e < NK ? 0.5f * ev[u] : 0.f;
        }
      }
    }
  }
  // Unstaged, the epilogue's eps and m_inv come from global memory, loaded
  // here, after the kick's loads, so that the barrier and the products
  // hide them: eps once, m_inv of the first column (of each next one
  // before that column's products).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = warp * R;  // the warp's first chain in the tile
  float half[R], m_next[R];
#pragma unroll
  for (int r = 0; r < R; ++r) half[r] = m_next[r] = 0.f;
  if (!staged) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (cw + r < nc) half[r] = 0.5f * __ldg(eps + c0 + cw + r);
    if (WRITE_PI) minv_column<CHAIN_MINV, R>(minv, c0 + cw, nc - cw, K, lane, m_next);
  }
  if (staged) cp_async_wait_all();
  __syncthreads();  // the staged matrices and the tile's d and p_mid
  if (cw >= nc) return;  // whole warps only: no barrier follows

  const float* const dw = ds + warp * K * R;
  float w2[R], kin[R];
  bool bad[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    w2[r] = kin[r] = 0.f;
    bad[r] = false;
  }
  if (staged) {
#pragma unroll
    for (int r = 0; r < R; ++r) half[r] = hs[cw + r];
  }
  for (int j = lane; j < K; j += 32) {
    float m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = m_next[r];
    if (WRITE_PI && !staged)
      minv_column<CHAIN_MINV, R>(minv, c0 + cw, nc - cw, K, j + 32, m_next);
    float pd[R], w[R];
    if (staged)
      column<R, true, COMPENSATED>(smem, smem + mat, dw, K, j, pd, w);
    else
      column<R, false, COMPENSATED>(prec, lchol, dw, K, j, pd, w);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int cl = cw + r;
      if (cl < nc) {
        const size_t idx = (size_t)(c0 + cl) * K + j;
        const float gj = -pd[r];
        const float pj = pm[cl * K + j] + half[r] * gj;
        w2[r] = fmaf(w[r], w[r], w2[r]);
        if (WRITE_PI) {
          const float mj = staged ? ms[cl * K + j] : m[r];
          kin[r] += mj * pj * pj;
        }
        bad[r] |= !isfinite(gj);
        gn[idx] = gj;
        pn[idx] = pj;
      }
    }
  }
  // The chains' sums: lane 4 r (R = 8) or lane 0 (R = 1) writes chain r.
  unsigned bad_mask = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) bad_mask |= bad[r] ? 1u << r : 0u;
  bad_mask = __reduce_or_sync(0xffffffffu, bad_mask);
  const int r = R == 8 ? lane >> 2 : 0;
  float s, k = 0.f;
  if constexpr (R == 8) {
    s = warp_sum_transposed<R>(w2, lane);
    if (WRITE_PI) k = warp_sum_transposed<R>(kin, lane);
  } else {
    s = warp_sum(w2[0]);
    if (WRITE_PI) k = warp_sum(kin[0]);
  }
  if ((lane & (R == 8 ? 3 : 31)) == 0 && cw + r < nc) {
    const int c = c0 + cw + r;
    float ld = -0.5f * s;
    const bool ok = isfinite(ld) && !((bad_mask >> r) & 1u);
    if (!(ok || ld == neg_inf())) ld = neg_inf();
    ldn[c] = ld;
    if (WRITE_PI) {
      float pi = ld - 0.5f * k;
      if (!isfinite(pi) || !isfinite(ld)) pi = neg_inf();
      pin[c] = pi;
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                        const float*, const float*, const float*, float*, float*, float*,
                        float*, float*, int, int, int);

template <bool WRITE_PI, bool CHAIN_MINV>
Kernel kernel_for(int R, bool compensated) {
  if (R == 8)
    return compensated ? gaussian_leaf_kernel<WRITE_PI, CHAIN_MINV, 8, true>
                       : gaussian_leaf_kernel<WRITE_PI, CHAIN_MINV, 8, false>;
  if (R == 1)
    return compensated ? gaussian_leaf_kernel<WRITE_PI, CHAIN_MINV, 1, true>
                       : gaussian_leaf_kernel<WRITE_PI, CHAIN_MINV, 1, false>;
  return nullptr;
}

// The instantiation of (write_pi, chain_minv, R) for K: compensated past
// kExactK.
Kernel kernel_for(bool write_pi, bool chain_minv, int R, int K) {
  const bool comp = K > kExactK;
  if (write_pi)
    return chain_minv ? kernel_for<true, true>(R, comp) : kernel_for<true, false>(R, comp);
  return chain_minv ? kernel_for<false, true>(R, comp) : kernel_for<false, false>(R, comp);
}

// The kernel of (write_pi, chain_minv, R, K), allowed the whole of the
// shared memory the first time it needs more than 48 KB on the current
// device. Sets err on failure.
Kernel prepared(bool write_pi, bool chain_minv, int R, int K, size_t smem, cudaError_t& err) {
  static std::atomic<unsigned long long> opened[16];  // devices, by kernel
  err = cudaSuccess;
  Kernel kern = kernel_for(write_pi, chain_minv, R, K);
  if (kern == nullptr) {
    err = cudaErrorInvalidValue;
    return nullptr;
  }
  if (smem > 48 * 1024) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return nullptr;
    const int slot = (write_pi ? 8 : 0) + (chain_minv ? 4 : 0) + (R == 8 ? 2 : 0) +
                     (K > kExactK ? 1 : 0);
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(opened[slot].load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
      if (err != cudaSuccess) return nullptr;
      opened[slot].fetch_or(bit);
    }
  }
  return kern;
}

// A plan the kernel takes: R 1 or 8, 1-8 warps a CTA, the CTA's shared
// memory in the card's.
bool valid_plan(int C, int K, int R, int warps, int staged) {
  return C >= 1 && K >= 1 && (R == 1 || R == 8) && warps >= 1 && warps <= kMaxWarps &&
         (staged == 0 || staged == 1) && smem_bytes(K, warps * R, staged) <= kMaxSmem;
}

int launch(bool write_pi, const float* q, const float* p, const float* g, const float* minv,
           int chain_minv, const float* eps, const float* prec, const float* lchol,
           const float* mu, float* qn, float* pn, float* gn, float* ldn, float* pin, int C,
           int K, int R, int warps, int staged, void* stream) {
  if (!valid_plan(C, K, R, warps, staged)) return (int)cudaErrorInvalidValue;
  const int chains = warps * R;
  const size_t smem = smem_bytes(K, chains, staged);
  cudaError_t err;
  Kernel kern = prepared(write_pi, chain_minv != 0, R, K, smem, err);
  if (kern == nullptr) return (int)err;
  kern<<<(C + chains - 1) / chains, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      q, p, g, minv, eps, prec, lchol, mu, qn, pn, gn, ldn, pin, C, K, staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One Gaussian tree leaf (K2) for C chains on `stream`, with the launch
// plan (R chains per warp, `warps` warps per CTA, `staged` prec and L in
// shared memory) of ops/gaussian_leaf.py::launch_plan. q, p, g, qn, pn, gn
// are (C, K) row-major; minv is (C, K) when chain_minv is 1, else (K,);
// eps, ldn, pin are (C,); prec and lchol (K, K) row-major; mu (K,).
// Returns the cudaGetLastError() of the launch (0 on success).
int gaussian_leaf_f32(const float* q, const float* p, const float* g, const float* minv,
                      const float* eps, const float* prec, const float* lchol,
                      const float* mu, float* qn, float* pn, float* gn, float* ldn,
                      float* pin, int C, int K, int chain_minv, int R, int warps,
                      int staged, void* stream) {
  return launch(true, q, p, g, minv, chain_minv, eps, prec, lchol, mu, qn, pn, gn, ldn, pin,
                C, K, R, warps, staged, stream);
}

// One Gaussian leapfrog step (K4): as gaussian_leaf_f32 without pi'.
int gaussian_leapfrog_f32(const float* q, const float* p, const float* g, const float* minv,
                          const float* eps, const float* prec, const float* lchol,
                          const float* mu, float* qn, float* pn, float* gn, float* ldn,
                          int C, int K, int chain_minv, int R, int warps, int staged,
                          void* stream) {
  return launch(false, q, p, g, minv, chain_minv, eps, prec, lchol, mu, qn, pn, gn, ldn,
                nullptr, C, K, R, warps, staged, stream);
}

// The kernel that (write_pi, chain_minv, K, R, warps, staged) launches: its
// dynamic shared memory (bytes), registers per thread and CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a CUDA error
// code (0 on success).
int gaussian_leaf_info(int write_pi, int chain_minv, int K, int R, int warps, int staged,
                       int* smem, int* regs, int* ctas_per_sm) {
  if (!valid_plan(1, K, R, warps, staged)) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(K, warps * R, staged);
  cudaError_t err;
  Kernel kern = prepared(write_pi != 0, chain_minv != 0, R, K, bytes, err);
  if (kern == nullptr) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kern));
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, 32 * warps, bytes);
  *smem = (int)bytes;
  *regs = attr.numRegs;
  return (int)err;
}

}  // extern "C"
