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
// non-finite. The hierarchical mode (Hoffman and Gelman's HLR) replaces the
// fixed 1/s^2 by each chain's e^-t, its last coordinate t = log sigma^2
// (logreg_leaf_finish_kernel<MODE, true>).
//
// Design. The leaf has no tree state, so chains are independent. Two
// kernels run one after the other on the caller's stream: a slice kernel,
// which writes each chain's partial sums over a slice of the observations
// to a workspace of S x C x (K + 1) floats that the caller allocates, and
// logreg_leaf_finish_kernel, one warp per chain, which sums the S partials
// in slice order, then forms g', p', the kinetic energy, ld' and pi' with
// the poisoning. The slice kernel comes in two variants, chosen by K alone
// (ops/logreg_leaf.py: tiled, launch_plan):
// - logreg_leaf_slice_kernel_tiled, wherever its CTA fits (K up to 308):
//   one CTA of 256 threads takes a block of 64 chains and one slice of the
//   observations (grid: chain blocks x slices). It computes the drift q' of
//   its chains, then walks its slice of X in tiles of 32 rows, each staged
//   once in shared memory: every logit of the block once per tile (phase A,
//   split over K across the eight warps), then the whole gradient from the
//   same staging (phase B). Both products are register-tiled: 8 x 8 logits
//   a thread in phase A, 8 chains x 10 coordinates in phase B (the comment
//   at the kernel).
// - logreg_leaf_slice_kernel past it: one CTA takes a block of 16 chains,
//   one slice and one chunk of the gradient's coordinates (grid: chain
//   blocks x slices x chunks), each chunk's CTA recomputing the logits.
//   * Phase A, logits: thread (o, chain group) computes the logits of tile
//     row o for TN / 16 chains, reading the row and q' as float4 from
//     shared memory (q' is a broadcast; rows are padded by 4 floats so the
//     lanes of a quarter warp hit distinct banks). It adds the chain's
//     likelihood terms and writes the residuals y - sigmoid(l) to shared
//     memory. Rows past n_obs are zero and masked: residual and likelihood
//     term 0.
//   * Phase B, gradient: thread (k, half) accumulates the chunk's
//     coordinates k, k + 128 of 8 chains in registers over the tile's rows:
//     one tile element and two broadcast float4 residual loads per 8 FMAs.
//   The per-thread gradient registers cover 256 coordinates, so past K =
//   256 the grid's third dimension splits the gradient into 256-wide
//   chunks. The tile has 64 rows while its CTA fits in shared memory (K up
//   to 392) and 16 rows past that; with 16 rows the CTA's shared memory,
//   2 x 16 (K + 5) + 16 K + 256 floats, bounds K at 1200
//   (ops/logreg_leaf.py: MAX_K, the plan).
// Both variants bring the tiles through a ring of two stages: cp.async.cg
// copies tile i + 1's rows (16 bytes a thread, L1 bypassed; X's rows are
// padded to a multiple of 4 floats) and cp.async.ca their y while tile i is
// computed. Each tile's gradient sums are added to the slice's running sums
// once, which keeps float32 rounding at the level of cuBLAS's blocked sums
// (a single running sum over 4000 observations was 5x further from
// float64, measured on the H100). Every sum runs in a fixed order (no
// atomics), so two launches on the same inputs are bitwise equal. Products
// are plain fp32 FMAs on the CUDA cores; no TF32.
//
// The slices. The caller (ops/logreg_leaf.py: launch_plan) picks S, the
// slices of the observations, so that the grid holds as many CTAs as the
// card runs at once: 2048 chains make 128 chunked chain blocks, one CTA on
// 128 of the 132 SMs, where every barrier and global load would stall its
// SM.
//
// What bounds it on the H100: 2 n_obs K FMAs per chain (9.9 G FMAs, 0.30
// ms at 67 TFLOP/s, at the hierarchical cell's 16,384 x 302 x 1000) issued
// from shared memory; X (1.2 MB there) is read from L2 once per chain block.
// The chunked kernel streamed X from shared memory at about 2.5 wavefronts
// per 8 FMAs and, past K = 256, computed the logits twice: 2.69 ms a leaf
// at that shape, 0.25 ms at 2048 x 128 x 4000 (H100 80GB HBM3, 700 W;
// chip_smoke.py phase 5). The tiled kernel computes them once with about
// 4 FMAs a loaded float: 0.82 ms and 0.23 ms (scripts/
// torch_logreg_leaf_compare.py), at 254 and 236 registers, one CTA an SM.
// Tensor cores over the chain block (wgmma with fp32-exact splitting) are
// later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 16;                    // chains per chunked slice-kernel CTA
constexpr int kFinishChains = kThreads / 32;   // finish kernel: a warp per chain
constexpr int kStages = 2;                     // stages of the ring of X tiles, >= 2
constexpr size_t kMaxSmem = 232448;            // H100: dynamic shared memory per CTA
constexpr int kTiledChains = 64;               // chains per tiled slice-kernel CTA
constexpr int kTiledRows = 32;                 // rows of X per tile of the tiled kernel
constexpr int kTiledGroups = 5;                // its float2 coordinate groups a thread, at most

constexpr int kSharedDiag = 0;
constexpr int kChainDiag = 1;
constexpr int kSharedDense = 2;

// 16-byte asynchronous copy global -> shared, bypassing L1 (cg).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
// 4-byte asynchronous copy global -> shared (through L1: cg takes 16 only).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 0.5f * (tanhf(0.5f * x) + 1.f);
}

// The dense drift M^-1 p_mid at coordinate k of 8 chains, whose p_mid rows
// start at ps, `stride` floats apart: for each chain the sum over ii < K of
// p_mid[ii] minv[ii, k] in blocks of 32 terms, each block's sum added to the
// running sum once. A single running sum over K = 302 put g' 2.7x further
// from float64 than the plain float32 leaf through cuBLAS (the flat leaf at
// 300 x 302 x 1000, |eps| <= 0.2, measured on the H100); blocks of 32 bring
// the drift's share to a fifth of that (replayed in float32 on the CPU).
// The full blocks are unrolled whole: with a loop bound of min(K, b0 + 32)
// the chunked kernel's dense drift at 256 x 512 x 4000 took 0.74 ms a leaf
// against 0.58 ms unrolled (H100, scripts/torch_logreg_leaf_compare.py).
__device__ __forceinline__ void dense_drift8(const float* ps, int stride,
                                             const float* __restrict__ minv, int K, int k,
                                             float drift[8]) {
  int b0 = 0;
  for (; b0 + 32 <= K; b0 += 32) {
    float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ii = b0; ii < b0 + 32; ++ii) {
      const float mv = __ldg(minv + (size_t)ii * K + k);
#pragma unroll
      for (int i = 0; i < 8; ++i) part[i] = fmaf(ps[i * stride + ii], mv, part[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) drift[i] += part[i];
  }
  if (b0 < K) {
    float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int ii = b0; ii < K; ++ii) {
      const float mv = __ldg(minv + (size_t)ii * K + k);
#pragma unroll
      for (int i = 0; i < 8; ++i) part[i] = fmaf(ps[i * stride + ii], mv, part[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) drift[i] += part[i];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of one slice-kernel CTA: the ring of kStages tiles of X (TN
// rows of KX + 4 floats) with their y (TN floats), q' of its 16 chains (KX
// floats each) and the tile's residuals (TN x 16). p_mid of the dense
// drift lies in the ring's place before the first copy. KX = K rounded up
// to 4: X's rows as the caller pads them.
size_t slice_smem_bytes(int K, int TN) {
  const size_t KX = (K + 3) & ~3;
  return sizeof(float) *
         ((size_t)kStages * TN * (KX + 5) + kChains * KX + (size_t)TN * kChains);
}

// MODE: kSharedDiag, kChainDiag or kSharedDense. KM: the CTA's gradient
// chunk is 128 KM coordinates. TN: rows of X per tile (a multiple of 16).
template <int MODE, int KM, int TN>
__global__ void __launch_bounds__(kThreads)
    logreg_leaf_slice_kernel(const float* __restrict__ q, const float* __restrict__ p,
                             const float* __restrict__ g, const float* __restrict__ eps,
                             const float* __restrict__ minv, const float* __restrict__ X,
                             const float* __restrict__ y, float* __restrict__ qn,
                             float* __restrict__ ws, int C, int K, int n_obs,
                             int tiles_per_slice) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int KX = (K + 3) & ~3;
  const int XS = KX + 4;              // tile row stride (floats)
  float* Xr = smem;                   // [kStages][TN][XS] the ring of tiles
  float* Yr = Xr + kStages * TN * XS; // [kStages][TN]     their y
  float* Qs = Yr + kStages * TN;      // [kChains][KX]  q'
  float* Rs = Qs + kChains * KX;      // [TN][kChains] residuals
  float* Ps = Xr;                     // [kChains][KX]  p_mid (dense), before the ring
  const int t = threadIdx.x;
  const int c0 = blockIdx.x * kChains;
  const int slice = blockIdx.y;
  const int kc0 = blockIdx.z * 128 * KM;  // the chunk's first coordinate

  // drift: thread (kl, ch) takes coordinates kl, kl + 128, ... of chains
  // ch * 8 .. ch * 8 + 7; q' of every coordinate goes to Qs (0 past K)
  const int kl = t & 127, ch = t >> 7;
  const bool write_q = slice == 0 && blockIdx.z == 0;
  float eps_c[8], half_c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + ch * 8 + i;
    eps_c[i] = c < C ? eps[c] : 0.f;
    half_c[i] = 0.5f * eps_c[i];
  }
  for (int k = kl; k < KX; k += 128) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + ch * 8 + i;
      const bool v = k < K && c < C;
      const size_t off = (size_t)c * K + k;
      const float pm = (v ? p[off] : 0.f) + half_c[i] * (v ? g[off] : 0.f);
      if (MODE == kSharedDense) {
        Ps[(ch * 8 + i) * KX + k] = pm;
      } else {
        const float m = MODE == kSharedDiag ? (k < K ? __ldg(minv + k) : 0.f)
                                            : (v ? __ldg(minv + off) : 0.f);
        const float qv = (v ? q[off] : 0.f) + eps_c[i] * (m * pm);
        Qs[(ch * 8 + i) * KX + k] = k < K ? qv : 0.f;
        if (write_q && v) qn[off] = qv;
      }
    }
  }
  if (MODE == kSharedDense) {
    __syncthreads();  // p_mid is staged
    for (int k = kl; k < KX; k += 128) {
      float drift[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k < K) dense_drift8(Ps + ch * 8 * KX, KX, minv, K, k, drift);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + ch * 8 + i;
        const bool v = k < K && c < C;
        const size_t off = (size_t)c * K + k;
        const float qv = (v ? q[off] : 0.f) + eps_c[i] * drift[i];
        Qs[(ch * 8 + i) * KX + k] = k < K ? qv : 0.f;
        if (write_q && v) qn[off] = qv;
      }
    }
  }

  // the slice's tiles of X: logits (phase A), then the gradient (phase B)
  constexpr int CPT = TN / 16;  // phase A: chains per thread
  const int oa = t % TN, cg = t / TN;  // chains cg * CPT .. cg * CPT + CPT - 1
  const int n_tiles = (n_obs + TN - 1) / TN;
  const int t_begin = slice * tiles_per_slice;
  const int t_end = min(n_tiles, t_begin + tiles_per_slice);
  float ll[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) ll[cc] = 0.f;
  float G[KM][8];
#pragma unroll
  for (int m = 0; m < KM; ++m)
#pragma unroll
    for (int i = 0; i < 8; ++i) G[m][i] = 0.f;

  // copy tile `tile` (its rows below n_obs, and their y) into `stage`;
  // rows past n_obs (the last tile only) are zeroed instead, so that phase
  // B's zero residuals meet finite values
  const int kx4 = KX / 4;
  auto load_tile = [&](int tile, int stage) {
    const int o0 = tile * TN;
    const int rows = min(TN, n_obs - o0);
    float* xs = Xr + stage * TN * XS;
    float* ys = Yr + stage * TN;
    const float* src = X + (size_t)o0 * KX;
    for (int i = t; i < rows * kx4; i += kThreads) {
      const int r = i / kx4, c4 = i - r * kx4;
      cp_async16(xs + r * XS + 4 * c4, src + (size_t)r * KX + 4 * c4);
    }
    for (int r = t; r < rows; r += kThreads) cp_async4(ys + r, y + o0 + r);
    for (int i = rows * XS + t; i < TN * XS; i += kThreads) xs[i] = 0.f;
    for (int r = rows + t; r < TN; r += kThreads) ys[r] = 0.f;
    cp_async_commit();
  };

  // Every thread runs every copy loop trip, wait and barrier below: the
  // trip counts depend on n_obs, TN and the slice only.
  const int nt = t_end - t_begin;  // >= 1 (the caller leaves no slice empty)
  __syncthreads();  // p_mid's readers are done before a copy lands in its place
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nt) {
      load_tile(t_begin + i, i);
    } else {
      cp_async_commit();  // empty groups keep the wait count uniform
    }
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i have landed
    __syncthreads();  // everyone's have; tile i - 1's stage and Rs are free; q' is staged
    if (i + kStages - 1 < nt) {
      load_tile(t_begin + i + kStages - 1, (i + kStages - 1) % kStages);
    } else {
      cp_async_commit();
    }
    const float* Xs = Xr + (i % kStages) * TN * XS;
    const float* Ys = Yr + (i % kStages) * TN;
    const int o0 = (t_begin + i) * TN;

    float l[CPT];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) l[cc] = 0.f;
    const float4* xrow = reinterpret_cast<const float4*>(Xs + oa * XS);
    const float4* qrow = reinterpret_cast<const float4*>(Qs + cg * CPT * KX);
    for (int k4 = 0; k4 < kx4; ++k4) {
      const float4 xv = xrow[k4];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float4 q4 = qrow[cc * kx4 + k4];
        l[cc] = fmaf(xv.x, q4.x, l[cc]);
        l[cc] = fmaf(xv.y, q4.y, l[cc]);
        l[cc] = fmaf(xv.z, q4.z, l[cc]);
        l[cc] = fmaf(xv.w, q4.w, l[cc]);
      }
    }
    const int og = o0 + oa;
    const float yi = Ys[oa];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const bool valid = og < n_obs && c0 + cg * CPT + cc < C;
      if (valid) ll[cc] += yi * l[cc] - softplus(l[cc]);
      Rs[oa * kChains + cg * CPT + cc] = valid ? yi - sigmoid(l[cc]) : 0.f;
    }
    __syncthreads();

    // the tile's partial sums, then one add into G: a two-level sum whose
    // rounding error grows with TN + n_obs / TN terms, not with n_obs
    float T[KM][8];
#pragma unroll
    for (int m = 0; m < KM; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i) T[m][i] = 0.f;
    const float4* r4 = reinterpret_cast<const float4*>(Rs);
    for (int o = 0; o < TN; ++o) {
      const float4 ra = r4[o * (kChains / 4) + ch * 2];
      const float4 rb = r4[o * (kChains / 4) + ch * 2 + 1];
      const float rr[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int m = 0; m < KM; ++m) {
        const int k = kc0 + kl + 128 * m;
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

  // the slice's partials: the likelihood sum of each chain over the TN
  // row threads in row order (Rs reused), and the chunk's gradient
  __syncthreads();  // the last tile's readers of Rs are done
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) Rs[(cg * CPT + cc) * TN + oa] = ll[cc];
  __syncthreads();
  float* wsl = ws + (size_t)slice * C * (K + 1);
  if (blockIdx.z == 0 && t < kChains && c0 + t < C) {
    float s = 0.f;
    for (int o = 0; o < TN; ++o) s += Rs[t * TN + o];
    wsl[(size_t)(c0 + t) * (K + 1) + K] = s;
  }
#pragma unroll
  for (int m = 0; m < KM; ++m) {
    const int k = kc0 + kl + 128 * m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + ch * 8 + i;
      if (k < K && c < C) wsl[(size_t)c * (K + 1) + k] = G[m][i];
    }
  }
}

// The tiled kernel's row stride in shared memory (floats), for X's tile rows
// and q': KX, or KX + 4 where KX / 4 is even, so that the stride is an odd
// number of float4s and eight consecutive rows' float4s at one column fall
// in eight distinct groups of four banks.
__host__ __device__ __forceinline__ int tiled_stride(int KX) {
  return (KX / 4) % 2 ? KX : KX + 4;
}

// Shared memory of one tiled slice-kernel CTA: the ring of kStages tiles of
// X (kTiledRows rows of the tiled stride) with their y, q' of its
// kTiledChains chains (the same stride) and the eight warps' partial logits
// of the tile (8 x kTiledRows x (kTiledChains + 8)), the first of which
// become its residuals. p_mid of the dense drift lies in the ring's place
// before the first copy.
size_t tiled_smem_bytes(int K) {
  const size_t XS = tiled_stride((K + 3) & ~3);
  return sizeof(float) * ((size_t)kStages * kTiledRows * (XS + 1) + kTiledChains * XS +
                          8 * (size_t)kTiledRows * (kTiledChains + 8));
}

// The tiled slice kernel: one CTA takes a block of CB = kTiledChains chains
// and one slice of the observations, with no gradient chunks. Per tile of TN
// = kTiledRows rows it computes every logit of its chains once (phase A),
// then the gradient over all of K from the same staging (phase B); both are
// register-tiled products from shared memory. KG: ceil(K / 64).
// - Phase A, split over K: warp w sums an eighth of the float4 columns; its
//   lane (ra, ca) holds the partial logits of rows ra + 4 i (i < TN / 4) and
//   chains ca + 8 j (j < CB / 8), 8 x 8 at TN 32, CB 64: 256 FMAs per 16
//   float4 loads. A quarter warp's lanes read 4 consecutive rows (distinct
//   banks: the tiled stride) and 2 consecutive chains. The warps' partials go
//   to shared memory; each logit is their sum in warp order, whose softplus
//   and sigmoid one thread forms (thread t: chain t % CB, rows t / CB + (256
//   / CB) i), adding the likelihood term and writing the residual y -
//   sigmoid(l) over warp 0's partial.
// - Phase B: thread (kb, cb) accumulates float2 coordinate groups kb + 32 m
//   (m < KG, none past KX) of chains cb CH .. cb CH + CH - 1 (CH = CB / 8):
//   per row CH / 4 broadcast float4 residual loads and KG float2 loads of X
//   for 2 KG CH FMAs, 80 per 9 loads at K 302. Each tile's partial sums are
//   added to the slice's running sums once, as in the chunked kernel.
template <int MODE, int KG>
__global__ void __launch_bounds__(kThreads, 1)
    logreg_leaf_slice_kernel_tiled(const float* __restrict__ q, const float* __restrict__ p,
                                   const float* __restrict__ g, const float* __restrict__ eps,
                                   const float* __restrict__ minv, const float* __restrict__ X,
                                   const float* __restrict__ y, float* __restrict__ qn,
                                   float* __restrict__ ws, int C, int K, int n_obs,
                                   int tiles_per_slice) {
  constexpr int CB = kTiledChains, TN = kTiledRows, NW = kThreads / 32;
  constexpr int RA = TN / 4, CA = CB / 8, CH = CB / 8;
  constexpr int RS = CB + 8;  // partials' and residuals' row stride: stores hit 32 banks
  constexpr int RC = kThreads / CB;  // row groups of the residuals' threads
  static_assert(NW == 8 && TN % 4 == 0 && CB % 32 == 0, "tile shape");
  static_assert(kThreads % CB == 0 && TN % RC == 0, "residual threads");
  static_assert(CB <= kStages * TN, "p_mid fits in the ring's place");
  static_assert(CB * (RC + 1) <= TN * RS, "the likelihood sums fit in the residuals' place");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int KX = (K + 3) & ~3, kx4 = KX / 4, kx2 = KX / 2;
  const int XS = tiled_stride(KX), xs4 = XS / 4, xs2 = XS / 2;
  float* Xr = smem;                   // [kStages][TN][XS] the ring of tiles
  float* Yr = Xr + kStages * TN * XS; // [kStages][TN]     their y
  float* Qs = Yr + kStages * TN;      // [CB][XS]  q'
  float* Rs = Qs + CB * XS;           // [NW][TN][RS] the warps' partial logits;
                                      // the residuals over warp 0's
  float* Ps = Xr;                     // [CB][XS]  p_mid (dense), before the ring
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c0 = blockIdx.x * CB;
  const int slice = blockIdx.y;

  // drift: q' of every (chain, coordinate) of the block to Qs (0 past K or
  // C); the dense metric's matvec runs from p_mid staged in Ps
  for (int i = t; i < CB * KX; i += kThreads) {
    const int cl = i / KX, k = i - cl * KX, c = c0 + cl;
    const bool v = k < K && c < C;
    const size_t off = (size_t)c * K + k;
    const float e = v ? eps[c] : 0.f;
    const float pm = (v ? p[off] : 0.f) + (0.5f * e) * (v ? g[off] : 0.f);
    if (MODE == kSharedDense) {
      Ps[cl * XS + k] = pm;
    } else {
      const float m = MODE == kSharedDiag ? (k < K ? __ldg(minv + k) : 0.f)
                                          : (v ? __ldg(minv + off) : 0.f);
      const float qv = (v ? q[off] : 0.f) + e * (m * pm);
      Qs[cl * XS + k] = qv;
      if (slice == 0 && v) qn[off] = qv;
    }
  }
  if (MODE == kSharedDense) {
    // thread (kl, dg): coordinates kl, kl + NK, ... of chains dg * 8 .. dg * 8 + 7
    constexpr int NK = kThreads / (CB / 8);
    const int kl = t % NK, dg = t / NK;
    __syncthreads();  // p_mid is staged
    for (int k = kl; k < KX; k += NK) {
      float drift[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k < K) dense_drift8(Ps + dg * 8 * XS, XS, minv, K, k, drift);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + dg * 8 + i;
        const bool v = k < K && c < C;
        const size_t off = (size_t)c * K + k;
        const float qv = (v ? q[off] : 0.f) + (v ? eps[c] : 0.f) * drift[i];
        Qs[(dg * 8 + i) * XS + k] = qv;
        if (slice == 0 && v) qn[off] = qv;
      }
    }
  }

  const int ra = lane & 3, ca = lane >> 2;  // phase A
  const int n4 = (kx4 + NW - 1) / NW, k4a = min(kx4, warp * n4), k4b = min(kx4, k4a + n4);
  const int cr = t % CB, rr = t / CB;  // the residuals
  const int kb = (warp & 3) * 8 + (lane & 7), cb = (warp >> 2) * 4 + (lane >> 3);  // phase B
  const bool last_group = kb + 32 * (KG - 1) < kx2;  // the thread's group KG - 1 exists
  const int n_tiles = (n_obs + TN - 1) / TN;
  const int t_begin = slice * tiles_per_slice;
  const int t_end = min(n_tiles, t_begin + tiles_per_slice);
  float ll = 0.f;
  float G[KG][CH][2];
#pragma unroll
  for (int m = 0; m < KG; ++m)
#pragma unroll
    for (int c = 0; c < CH; ++c) G[m][c][0] = G[m][c][1] = 0.f;

  // copy tile `tile` (its rows below n_obs, and their y) into `stage`;
  // rows past n_obs (the last tile only) are zeroed instead
  auto load_tile = [&](int tile, int stage) {
    const int o0 = tile * TN;
    const int rows = min(TN, n_obs - o0);
    float* xs = Xr + stage * TN * XS;
    float* ys = Yr + stage * TN;
    const float* src = X + (size_t)o0 * KX;
    for (int i = t; i < rows * kx4; i += kThreads) {
      const int r = i / kx4, c4 = i - r * kx4;
      cp_async16(xs + r * XS + 4 * c4, src + (size_t)r * KX + 4 * c4);
    }
    for (int r = t; r < rows; r += kThreads) cp_async4(ys + r, y + o0 + r);
    for (int i = rows * XS + t; i < TN * XS; i += kThreads) xs[i] = 0.f;
    for (int r = rows + t; r < TN; r += kThreads) ys[r] = 0.f;
    cp_async_commit();
  };

  // Every thread runs every copy loop trip, wait and barrier below.
  const int nt = t_end - t_begin;  // >= 1 (the caller leaves no slice empty)
  __syncthreads();  // p_mid's readers are done before a copy lands in its place
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nt) {
      load_tile(t_begin + i, i);
    } else {
      cp_async_commit();
    }
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i has landed; tile i - 1's stage and Rs are free; q' is staged
    if (i + kStages - 1 < nt) {
      load_tile(t_begin + i + kStages - 1, (i + kStages - 1) % kStages);
    } else {
      cp_async_commit();
    }
    const float* Xs = Xr + (i % kStages) * TN * XS;
    const float* Ys = Yr + (i % kStages) * TN;
    const float4* x4 = reinterpret_cast<const float4*>(Xs);
    const float2* x2 = reinterpret_cast<const float2*>(Xs);
    const float4* q4 = reinterpret_cast<const float4*>(Qs);
    const int o0 = (t_begin + i) * TN;

    // phase A: the warp's partial logits, each a sum over its k in order
    float l[RA][CA];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int j = 0; j < CA; ++j) l[a][j] = 0.f;
    for (int k4 = k4a; k4 < k4b; ++k4) {
      float4 xv[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) xv[a] = x4[(ra + 4 * a) * xs4 + k4];
#pragma unroll
      for (int j = 0; j < CA; ++j) {
        const float4 qv = q4[(ca + 8 * j) * xs4 + k4];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          l[a][j] = fmaf(xv[a].x, qv.x, l[a][j]);
          l[a][j] = fmaf(xv[a].y, qv.y, l[a][j]);
          l[a][j] = fmaf(xv[a].z, qv.z, l[a][j]);
          l[a][j] = fmaf(xv[a].w, qv.w, l[a][j]);
        }
      }
    }
    float* Pw = Rs + warp * TN * RS;
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int j = 0; j < CA; ++j) Pw[(ra + 4 * a) * RS + ca + 8 * j] = l[a][j];
    __syncthreads();

    // the logits (the warps' partials in order), the likelihood terms and
    // the residuals
    const bool live = c0 + cr < C;
#pragma unroll
    for (int a = 0; a < TN / RC; ++a) {
      const int r = rr + RC * a, idx = r * RS + cr;
      float lv = Rs[idx];
#pragma unroll
      for (int w = 1; w < NW; ++w) lv += Rs[w * TN * RS + idx];
      const float yi = Ys[r];
      const bool valid = live && o0 + r < n_obs;
      if (valid) ll += yi * lv - softplus(lv);
      Rs[idx] = valid ? yi - sigmoid(lv) : 0.f;
    }
    __syncthreads();

    // phase B: the tile's partial sums over its rows below n_obs, then one
    // add into G
    float T[KG][CH][2];
#pragma unroll
    for (int m = 0; m < KG; ++m)
#pragma unroll
      for (int c = 0; c < CH; ++c) T[m][c][0] = T[m][c][1] = 0.f;
    const int rows = min(TN, n_obs - o0);
#pragma unroll 2
    for (int o = 0; o < rows; ++o) {
      float rv[CH];
      const float4* r4 = reinterpret_cast<const float4*>(Rs + o * RS + cb * CH);
#pragma unroll
      for (int c = 0; c < CH / 4; ++c) {
        const float4 v = r4[c];
        rv[4 * c] = v.x; rv[4 * c + 1] = v.y; rv[4 * c + 2] = v.z; rv[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < KG; ++m) {
        if (m < KG - 1 || last_group) {
          const float2 xv = x2[o * xs2 + kb + 32 * m];
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            T[m][c][0] = fmaf(xv.x, rv[c], T[m][c][0]);
            T[m][c][1] = fmaf(xv.y, rv[c], T[m][c][1]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < KG; ++m)
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        G[m][c][0] += T[m][c][0];
        G[m][c][1] += T[m][c][1];
      }
  }

  // the slice's partials: each chain's likelihood sum over its RC row
  // groups in order (Rs reused), and its gradient over all of K
  __syncthreads();  // the last tile's readers of Rs are done
  float* Ls = Rs;   // [CB][RC + 1]
  Ls[cr * (RC + 1) + rr] = ll;
  __syncthreads();
  float* wsl = ws + (size_t)slice * C * (K + 1);
  if (t < CB && c0 + t < C) {
    float s = 0.f;
    for (int r = 0; r < RC; ++r) s += Ls[t * (RC + 1) + r];
    wsl[(size_t)(c0 + t) * (K + 1) + K] = s;
  }
#pragma unroll
  for (int m = 0; m < KG; ++m)
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int chain = c0 + cb * CH + c;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * (kb + 32 * m) + e;
        if (k < K && chain < C) wsl[(size_t)chain * (K + 1) + k] = G[m][c][e];
      }
    }
}

// One warp per chain: the S partials summed in slice order, then g', p',
// the kinetic energy, ld' and pi'. q' is read back from qn (the slice
// kernel wrote it). Dense: p' of the warp's chain is staged in shared
// memory (kFinishChains x KX floats) for the matvec.
//
// HIER, the hierarchical prior: the last coordinate is t = log sigma^2,
// the others b share a N(0, e^t) prior and e^t an Exponential(`prior`)
// one, so with P = K - 1 and the chain's own precision e^-t
//   ld' = sum_i y_i l_i - softplus(l_i) - 1/2 e^-t ||b'||^2 - P/2 t - prior e^t + t
//   g'_b = X^T (y - sigmoid(l)) - e^-t b'
//   g'_t = 1/2 e^-t ||b'||^2 - P/2 - prior e^t + 1
// X's last column is zero (the caller's), so the slice kernel's logits are
// those of b' and its partial sums for t are 0 and go unread; g'_t waits
// for the warp's sum ||b'||^2. Flat (HIER false): `prior` is 1/s^2.
template <int MODE, bool HIER>
__global__ void __launch_bounds__(kThreads)
    logreg_leaf_finish_kernel(const float* __restrict__ p, const float* __restrict__ g,
                              const float* __restrict__ eps, const float* __restrict__ minv,
                              const float* __restrict__ qn, const float* __restrict__ ws,
                              float* __restrict__ pn, float* __restrict__ gn,
                              float* __restrict__ ldn, float* __restrict__ pin, int C, int K,
                              int S, float prior) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kFinishChains + warp;
  if (c >= C) return;  // a whole warp; no CTA barrier follows
  const int KX = (K + 3) & ~3;
  float* Pw = reinterpret_cast<float*>(smem4) + warp * KX;
  const float half = 0.5f * eps[c];
  const size_t stride = (size_t)C * (K + 1);  // one slice of the workspace
  const float* wc = ws + (size_t)c * (K + 1);
  const int KB = HIER ? K - 1 : K;  // the coordinates under the Gaussian prior
  const float t = HIER ? qn[(size_t)c * K + K - 1] : 0.f;
  const float prec = HIER ? expf(-t) : prior;
  float kin = 0.f, sq = 0.f, bad = 0.f;
  for (int k = lane; k < KB; k += 32) {
    const size_t off = (size_t)c * K + k;
    float G = wc[k];
    for (int s = 1; s < S; ++s) G += wc[s * stride + k];
    const float qv = qn[off];
    const float pm = p[off] + half * g[off];
    const float gnew = G - prec * qv;
    const float pnew = pm + half * gnew;
    sq += qv * qv;
    bad += isfinite(gnew) ? 0.f : 1.f;
    if (MODE == kSharedDiag) kin += __ldg(minv + k) * pnew * pnew;
    if (MODE == kChainDiag) kin += __ldg(minv + off) * pnew * pnew;
    if (MODE == kSharedDense) Pw[k] = pnew;
    pn[off] = pnew;
    gn[off] = gnew;
  }
  const float et = HIER ? expf(t) : 0.f;
  if (HIER) {
    sq = warp_sum(sq);
    if (lane == 0) {
      const size_t off = (size_t)c * K + K - 1;
      const float gnew = 0.5f * prec * sq - 0.5f * (float)(K - 1) - prior * et + 1.f;
      const float pnew = p[off] + half * g[off] + half * gnew;
      bad += isfinite(gnew) ? 0.f : 1.f;
      if (MODE == kSharedDiag) kin += __ldg(minv + K - 1) * pnew * pnew;
      if (MODE == kChainDiag) kin += __ldg(minv + off) * pnew * pnew;
      if (MODE == kSharedDense) Pw[K - 1] = pnew;
      pn[off] = pnew;
      gn[off] = gnew;
    }
  }
  if (MODE == kSharedDense) {
    __syncwarp();
    for (int k = lane; k < K; k += 32) {
      float s = 0.f;
      for (int ii = 0; ii < K; ++ii) s = fmaf(Pw[ii], __ldg(minv + (size_t)ii * K + k), s);
      kin += Pw[k] * s;
    }
  }
  kin = warp_sum(kin);
  if (!HIER) sq = warp_sum(sq);
  bad = warp_sum(bad);
  if (lane == 0) {
    float l_sum = wc[K];
    for (int s = 1; s < S; ++s) l_sum += wc[s * stride + K];
    float ld = l_sum + (-0.5f * prec * sq);
    if (HIER) ld += t - 0.5f * (float)(K - 1) * t - prior * et;
    float pi = ld - 0.5f * kin;
    const bool ok = isfinite(ld) && bad == 0.f;
    if (!(ok || ld == neg_inf())) ld = neg_inf();
    if (!isfinite(pi) || !isfinite(ld)) pi = neg_inf();
    ldn[c] = ld;
    pin[c] = pi;
  }
}

using SliceKernel = void (*)(const float*, const float*, const float*, const float*,
                             const float*, const float*, const float*, float*, float*, int,
                             int, int, int);
using FinishKernel = void (*)(const float*, const float*, const float*, const float*,
                              const float*, const float*, float*, float*, float*, float*, int,
                              int, int, float);

// The chunked slice kernel for (K, TN): 128-coordinate chunks up to K =
// 128, 256 past it; the tiled one (TN = kTiledRows) for K up to 64
// kTiledGroups, ceil(K / 64) float2 groups a thread (its CTA fits up to K =
// 308: prepared_slice_kernel). nullptr for a TN or K without an
// instantiation.
template <int MODE>
SliceKernel slice_kernel_for(int K, int TN, bool tiled) {
  if (tiled) {
    if (TN != kTiledRows) return nullptr;
    static_assert(kTiledGroups == 5, "one case per group count");
    switch ((K + 63) / 64) {
      case 1: return logreg_leaf_slice_kernel_tiled<MODE, 1>;
      case 2: return logreg_leaf_slice_kernel_tiled<MODE, 2>;
      case 3: return logreg_leaf_slice_kernel_tiled<MODE, 3>;
      case 4: return logreg_leaf_slice_kernel_tiled<MODE, 4>;
      case 5: return logreg_leaf_slice_kernel_tiled<MODE, 5>;
      default: return nullptr;
    }
  }
  if (TN == 64) {
    return K <= 128 ? logreg_leaf_slice_kernel<MODE, 1, 64>
                    : logreg_leaf_slice_kernel<MODE, 2, 64>;
  }
  if (TN == 16) return logreg_leaf_slice_kernel<MODE, 2, 16>;
  return nullptr;
}

SliceKernel slice_kernel(int mode, int K, int TN, bool tiled) {
  switch (mode) {
    case kSharedDiag: return slice_kernel_for<kSharedDiag>(K, TN, tiled);
    case kChainDiag: return slice_kernel_for<kChainDiag>(K, TN, tiled);
    case kSharedDense: return slice_kernel_for<kSharedDense>(K, TN, tiled);
    default: return nullptr;
  }
}

template <bool HIER>
FinishKernel finish_kernel_for(int mode) {
  switch (mode) {
    case kSharedDiag: return logreg_leaf_finish_kernel<kSharedDiag, HIER>;
    case kChainDiag: return logreg_leaf_finish_kernel<kChainDiag, HIER>;
    case kSharedDense: return logreg_leaf_finish_kernel<kSharedDense, HIER>;
    default: return nullptr;
  }
}

FinishKernel finish_kernel(int mode, int hier) {
  return hier ? finish_kernel_for<true>(mode) : finish_kernel_for<false>(mode);
}

// The slice kernel for (mode, K, TN, tiled) with its dynamic shared memory
// allowed; nullptr where there is none or it does not fit.
SliceKernel prepared_slice_kernel(int mode, int K, int TN, bool tiled, size_t& smem) {
  SliceKernel kern = K < 1 ? nullptr : slice_kernel(mode, K, TN, tiled);
  smem = tiled ? tiled_smem_bytes(K) : slice_smem_bytes(K, TN);
  if (kern == nullptr || K < 1 || smem > kMaxSmem) return nullptr;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return nullptr;
  return kern;
}

}  // namespace

extern "C" {

// The slice kernel that (mode, K, tile, tiled) launches: its dynamic shared
// memory (bytes), registers per thread and CTAs per SM at 256 threads
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a CUDA error
// code (0 on success).
int logreg_leaf_info(int mode, int K, int tile, int tiled, int* smem, int* regs,
                     int* blocks_per_sm) {
  size_t bytes = 0;
  SliceKernel kern = prepared_slice_kernel(mode, K, tile, tiled != 0, bytes);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kern));
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, kThreads, bytes);
  *smem = (int)bytes;
  *regs = attr.numRegs;
  return (int)err;
}

// One leaf for C chains on `stream`. mode: 0 shared diagonal minv (K),
// 1 per-chain diagonal (C, K), 2 shared dense (K, K). hier: 0 the flat
// N(0, 1 / prior) prior, 1 the hierarchical one with rate `prior` (its t
// the last coordinate, X's last column zero). X is (n_obs, KX)
// row-major with KX = K rounded up to 4 and zero pad columns; y (n_obs).
// ws: slices x C x (K + 1) floats of workspace. tiled: 1 the tiled slice
// kernel (tile = kTiledRows, K up to 308), 0 the chunked one.
// The observations' n_tiles tiles of `tile` rows go to `slices` slices of
// tiles_per_slice tiles, none empty. Returns the cudaGetLastError() of the
// launches (0 on success).
int logreg_leaf_f32(const float* q, const float* p, const float* g, const float* eps,
                    const float* minv, int mode, int hier, const float* X, const float* y,
                    float* qn, float* pn, float* gn, float* ldn, float* pin, float* ws, int C,
                    int K, int n_obs, int tile, int tiled, int slices, int tiles_per_slice,
                    float prior, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || K < 1 + hier || n_obs < 1 || slices < 1 || tiles_per_slice < 1)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n_obs + tile - 1) / tile;
  if ((long long)slices * tiles_per_slice < n_tiles ||
      (long long)(slices - 1) * tiles_per_slice >= n_tiles)
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  SliceKernel slice = prepared_slice_kernel(mode, K, tile, tiled != 0, smem);
  FinishKernel finish = finish_kernel(mode, hier);
  if (slice == nullptr || finish == nullptr) return (int)cudaErrorInvalidValue;
  const int chunk = K <= 128 ? 128 : 256;
  const dim3 grid = tiled ? dim3((C + kTiledChains - 1) / kTiledChains, slices, 1)
                          : dim3((C + kChains - 1) / kChains, slices, (K + chunk - 1) / chunk);
  slice<<<grid, kThreads, smem, s>>>(q, p, g, eps, minv, X, y, qn, ws, C, K, n_obs,
                                     tiles_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t KX = (K + 3) & ~3;
  const size_t fsmem = mode == kSharedDense ? sizeof(float) * kFinishChains * KX : 0;
  if (fsmem > 48 * 1024) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(finish),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fsmem);
    if (err != cudaSuccess) return (int)err;
  }
  finish<<<(C + kFinishChains - 1) / kFinishChains, kThreads, fsmem, s>>>(
      p, g, eps, minv, qn, ws, pn, gn, ldn, pin, C, K, slices, prior);
  return (int)cudaGetLastError();
}

}  // extern "C"
