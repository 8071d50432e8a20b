// Whole-transition NUTS kernel, written for Hopper (sm_90a). It replaces the
// Pallas kernel dynamichmc_tpu/ops/pallas_tree.py::_build_kernel with each of
// its three leaves: _gaussian_leaf, funnel_leaf (make_funnel_tree_transition)
// and logreg_leaf (make_logreg_tree_transition).
//
// One complete NUTS transition per chain: every leapfrog leaf, -inf poisoning
// of ld and +inf poisoning of the kinetic energy, the running Gumbel-argmax
// proposal (strict score > best), the trailing-ones merge stack with the
// 5-statistic generalized U-turn (psharp carried), the divergence test
// delta < min_delta, InvalidTree termination positions, the biased doubling
// combine with Exponential noise, and the runtime depth cap dcap.
//
// Three variants, chosen by shape alone (tree_transition_f32): the Gaussian
// and funnel leaves run tree_transition_warp_kernel, one warp per chain
// (below, before warp_plan), wherever warp_plan gives them a warp (K <= 128,
// the staged matrices leaving room for one warp's merge stack); the logreg
// leaf runs tree_transition_kernel_xstaged, the same tree control with all
// of X staged once per CTA (below, before xstaged_plan), wherever
// xstaged_plan fits X, y and the per-warp regions of kXsMinWarps warps
// (K <= 128); every other launch runs the CTA variant described here.
//
// Design. One CTA per chain, one thread per coordinate (blockDim =
// round_up(K, 32)). Thread j keeps coordinate j of every per-chain vector
// (edges, walking point, proposal, best leaf, turn statistics) in registers;
// the merge stack (5 x S x Kp floats) and a staging vector for the matvecs
// live in shared memory: (5 S + 1) Kp floats plus 192 floats of reduction
// scratch, 11.5 KB at K = 100 and max_depth 4. Dot products are warp
// shuffles plus one shared-memory pass; every thread reads the same reduced
// value, so all control flow is uniform across the CTA. Each chain leaves its
// own loops as soon as it terminates. That yields exactly the q', ld', depth,
// steps, termination and acceptance of the lockstep block (a lane whose
// subtree stopped building changes none of its outputs afterwards); only
// `work` changes meaning: it is the chain's own executed leaf count.
//
// The leaf is a template parameter (LEAF), the model's arrays and scalars
// the Model operands:
// - kGaussian (models/gaussian.py): d = q - mu, ld = -1/2 ||L^T d||^2,
//   grad = -prec d. m0 = prec^T, m1 = L, m2 = mu.
// - kFunnel (models/funnel.py): v = q[0], ld = -1/2 v^2 / sigma_v^2
//   - (K-1)/2 v - 1/2 e^-v sum_{i>0} q_i^2, with its analytic gradient.
//   One block reduction gives sum q^2 and v together (every thread but
//   thread 0 adds 0 to v, so v arrives exact); coordinate 0's gradient
//   differs from the rest. s0 = sigma_v^2, s1 = (K-1)/2.
// - kLogreg (models/logreg.py): logits = X q, ld = sum y l - softplus(l)
//   - 1/2 ||q||^2 / s^2, grad = X^T (y - sigmoid(l)) - q / s^2, with the
//   stable softplus and tanh-form sigmoid of ops/pallas_logreg.py.
//   m0 = X with its columns zero-padded to KX = round_up(K, 4) (n_obs x
//   KX, rows 16-byte aligned; zero columns add nothing to either product),
//   m1 = y, s0 = 1/s^2. One pass over X per leaf, in tiles of T rows:
//   cp.async.cg (16 bytes a thread, L1 bypassed) fills a ring of kStages
//   stages in shared memory with the tile's rows of X (and cp.async.ca
//   their y), so the next tiles load while tile t is computed. Two
//   barriers per tile: one after the wait for tile t (which also frees
//   tile t - 1's stage for the next copy), one after the residuals. From
//   each staged tile:
//   * logits: eight threads per row, two rows per group at a time, each
//     thread reading float4s of the rows and of q (staged in xbuf), summed
//     by xor shuffles; an 8-lane quarter warp reads 32 consecutive words,
//     so the rows need no bank padding. Lane 0 of the group finishes row
//     a, lane 1 row b, side by side: y l - softplus(l) into the lane's
//     running ll, y - sigmoid(l) into a T-float residual buffer. Rows past
//     n_obs in the last tile are neither copied nor read.
//   * gradient: thread j sums X_tile[i][j] r_i over the tile's rows
//     (consecutive threads, consecutive words; r_i four at a time as a
//     broadcast float4) in four interleaved partial sums, and adds the
//     tile's sum to its running sum once: a two-level sum, as in
//     logreg_leaf.cu. Both running sums across the tiles (ll and the
//     gradient) are compensated (Kahan).
//   T = min(kTileRows, what the shared memory left by the merge stack
//   holds), down to one row per stage. Where not even one row per stage
//   fits (K near 1024 at max_depth 11-13), the tiles are read from X in
//   place in global memory, with only the T residuals in shared memory, so
//   every (K, max_depth) whose merge stack fits takes any n_obs
//   (logreg_tiles). Sums run in a fixed order, so a launch is
//   deterministic.
//
// What bounds it on the H100:
// - Gaussian, dense: four K x K matvecs per leaf (M^-1 p_mid, L^T d and
//   prec d in one pass, M^-1 p_new), 8 K^2 FMA operations: 160 KB of
//   matrix reads per chain-leaf at K = 100 (three 40 KB matrices, M^-1
//   twice). The CTA variant reads them from L1/L2 in every chain's CTA and
//   crosses about a dozen CTA barriers per leaf. The warp variant reads
//   them from shared memory, staged once per CTA (120,000 bytes dense,
//   80,000 diagonal at K = 100): lane l reads A[i][l + 32 s], 32
//   consecutive words per warp-wide load, with x_i a broadcast float4 of
//   the warp's staging vector, so each matvec row costs R shared-memory
//   wavefronts for R compensated FMAs a lane (kahan_fma, four fp32
//   instructions a term). Shared memory serves 128 bytes a clock per SM
//   (about 29 TB/s over 132 SMs at 1.7 GHz): about 0.26 ms for the ~7.4
//   GB a 4096-chain md-4 transition reads, the variant's floor, against
//   0.0575 ms for the fp32 operations. On the H100 (700 W) the variant
//   takes about 0.70 ms there, and an edited copy of it with plain
//   running sums took 0.47 ms: why the compensation costs that much is
//   not measured.
//   Its dot products are xor butterflies over the warp, with no barrier;
//   its warps per CTA, W = min(warp_max_warps(leaf, R), what the shared memory
//   left by the matrices holds), are 8 at the main shape (the registers'
//   limit; 206,016 bytes, one CTA per SM). Each warp takes its next chain
//   from a queue counter, so a short tree frees its warp for the next
//   chain at once; the last warp to finish zeroes the counter, so the
//   wrapper keeps one per stream. Both variants compensate the Gaussian
//   leaf's matvec sums (kahan_fma). Past K = 128 the CTA variant runs
//   the leaf: about 1.96 ms at 4096 x 129, md 4, dense (0.42 diagonal) on
//   the H100, against 2.26 (0.29) with plain sums. Thread j of the CTA
//   variant reads
//   column j of each matrix, so consecutive threads read consecutive
//   addresses: minv is symmetric, and the wrapper passes prec^T and L for
//   that.
// - Funnel: elementwise, 30 K operations a leaf, so no bound of the card
//   comes near: the time is the serial leaf loop of the longest chains (up
//   to 127 leaves at max_depth 7) and the instructions of every leaf. The
//   CTA variant, one 32-thread CTA per chain at K = 25, pays a block
//   reduction (two CTA barriers and a shared-memory round trip) for every
//   dot product, and its one-warp CTAs of 72 registers (diagonal) hold 28
//   warps an SM. The warp variant runs the leaf with no CTA barrier:
//   every reduction is a butterfly, v is a shuffle from lane 0, there is
//   no matrix to stage with a diagonal metric (the dense M^-1 only
//   otherwise), and at R = 1 its launch bounds take two 10-warp CTAs an
//   SM at 93-95 registers (kFunnelWarps): 2,640 warps on 132 SMs for the
//   funnel path's 4096 chains, the queue sharing out the rest. About 0.18
//   ms a call at 4096 x 25, md 7 (diagonal) against the CTA variant's
//   0.31 on the H100 (700 W).
// - Logreg: 2 n_obs K FMAs per chain per leaf (1.0 M at n_obs 4000, K 128;
//   4.2 GFLOP per fleet leaf at 2048 chains), and each CTA reads X once
//   from L2 on every leaf: 2 MB per chain-leaf at n_obs 4000, K 128 (the
//   design before read X and X^T, 4 MB), 4 GB per fleet leaf. At that
//   shape T = 32 rows in 2 stages, and a CTA holds 44,672 bytes of shared
//   memory (11,520 of merge stack, xbuf and reduction scratch, 33,024 of
//   ring, 128 of residuals). ptxas -v (printed by chip_smoke.py's build
//   phase) gives tree_transition_kernel 103 registers for the diagonal
//   metric and 104 for the dense one, no spill: 4 CTAs of 128 threads per
//   SM by registers (5 by shared memory). On the H100 (700 W) a transition
//   of the logreg_tree path takes about 12.3 ms in phase 5 of
//   chip_smoke.py, against 15.5 ms for the design before: about 5 TB/s of
//   X from L2, computed from the bytes and the time, not profiled.
//   Past 608 threads (K > 608) a CTA of tree_transition_kernel would need
//   more than an SM's 65,536 registers, and the launch takes
//   tree_transition_kernel_wide, held to 64 registers (the logreg leaf
//   then spills 72 bytes, 160 with the tiles read in place).
//   One chain per CTA remains, because the tree control is per chain, so
//   every chain streams its own copy of X. Where all of X fits in a CTA's
//   shared memory the staged-X variant reads it from L2 once per CTA
//   instead; for a wider X, cluster multicast of the tiles and tensor cores
//   with an fp32-exact split are later work.
// Tensor cores (wgmma) and reuse of one matrix load across several chains
// (lockstep) are left to later work. Products are plain fp32 FMAs; no TF32
// anywhere.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kNumStats = 5;  // p_minus, p_plus, rho, psharp_minus, psharp_plus
constexpr int kRedSlots = 6;  // widest simultaneous block reduction
constexpr int kTileRows = 32;  // logreg: most rows of X per tile
constexpr int kStages = 2;     // logreg: stages of the ring of X, >= 2
constexpr size_t kMaxSmem = 232448;  // H100: dynamic shared memory per CTA

constexpr int kGaussian = 0;
constexpr int kFunnel = 1;
constexpr int kLogreg = 2;
// kLogreg with its tiles read from X in place, for a CTA whose merge stack
// leaves no room for the ring (chosen at launch; not a leaf id of the API)
constexpr int kLogregInPlace = 3;

struct Model {
  const float* m0;
  const float* m1;
  const float* m2;
  int n_obs;
  int tile;  // logreg: rows of X per tile
  float s0, s1;
};

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
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// logaddexp that maps (-inf, -inf) to -inf instead of NaN.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == neg_inf()) return neg_inf();
  return m + log1pf(expf(fminf(a, b) - m));
}

// log(1 + e^x) = max(x, 0) + log1p(e^-|x|): overflow-free
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// tanh form: stable at both tails
__device__ __forceinline__ float sigmoid(float x) {
  return 0.5f * (tanhf(0.5f * x) + 1.f);
}

// Sum N per-thread values over the CTA. Lane 0 of each warp publishes its
// warp sum and every thread adds the warp sums in the same order, so all
// threads hold bitwise-identical results.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * 32 + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[i * 32 + w];
    v[i] = s;
  }
}

// s += a x as a compensated sum with compensation c (the term formed by one
// FMA), for the matvecs: M^-1 p of the dense metric, and the Gaussian
// leaf's L^T d and prec d. Plain float32 running sums over K = 128-129
// terms of correlated_gaussian's prec (condition number ~7e3) put the
// transition more than twice as far from float64 as the plain version's
// cuBLAS products (measured on the H100).
__device__ __forceinline__ void kahan_fma(float& s, float& c, float a, float x) {
  const float u = fmaf(a, x, -c);
  const float t = s + u;
  c = (t - s) - u;
  s = t;
}

// Publish x_j into the staging vector, then return sum_i A[i, j] x_i
// (compensated, i in order).
__device__ __forceinline__ float stage_matvec(float x, const float* __restrict__ A,
                                              float* xbuf, int K, int j) {
  __syncthreads();  // earlier readers of xbuf are done
  xbuf[j] = x;
  __syncthreads();
  float s = 0.f, c = 0.f;
  if (j < K) {
    for (int i = 0; i < K; ++i) kahan_fma(s, c, __ldg(A + (size_t)i * K + j), xbuf[i]);
  }
  return s;
}

struct Tau {
  float pm, pp, rho, spm, spp;
};

// combine_dir of the 5-statistic generalized U-turn: `first` precedes
// `second` in traversal order; swapped into time order when moving backward.
__device__ __forceinline__ bool combine_dir(const Tau& first, const Tau& second,
                                            bool fwd, Tau& out, float* red) {
  const Tau& x = fwd ? first : second;
  const Tau& y = fwd ? second : first;
  const float r1 = x.rho + y.pm;
  const float r2 = x.pp + y.rho;
  const float rho = x.rho + y.rho;
  float v[6] = {x.spm * r1, y.spm * r1, x.spp * r2, y.spp * r2, x.spm * rho, y.spp * rho};
  block_sum<6>(v, red);
  out.pm = x.pm;
  out.pp = y.pp;
  out.rho = rho;
  out.spm = x.spm;
  out.spp = y.spp;
  return (v[0] < 0.f) | (v[1] < 0.f) | (v[2] < 0.f) | (v[3] < 0.f) | (v[4] < 0.f) |
         (v[5] < 0.f);
}

// s += x as a compensated (Kahan) sum with compensation c: the error stays
// at a few ulp of s however many terms are added.
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// One tile of the logreg leaf: rows rows of X at xs (KX floats apart) and
// their y at ys, staged in the ring or in place in global memory. Adds the
// rows' likelihood terms to ll and the tile's gradient sum to gsum (both
// compensated); resid: T floats, 16-byte aligned. Two barriers, reached by
// every thread.
__device__ __forceinline__ void logreg_tile(const float* xs, const float* ys, int rows, int KX,
                                            const float4* q4, float* resid, int j, bool own,
                                            float& ll, float& ll_c, float& gsum,
                                            float& gsum_c) {
  const int KX4 = KX >> 2;
  const int lane8 = j & 7;   // lane within the row's group of eight
  const int group = j >> 3;  // row of the tile pass
  const int groups = blockDim.x >> 3;

  // logits, likelihood terms and residuals: eight threads per row, two
  // rows per group at a time; lane 0 finishes row a, lane 1 row b
  for (int r0 = 0; r0 < rows; r0 += 2 * groups) {
    const int ra = r0 + group, rb = ra + groups;
    const bool va = ra < rows, vb = rb < rows;
    const float4* row_a = reinterpret_cast<const float4*>(xs + ra * KX);
    const float4* row_b = reinterpret_cast<const float4*>(xs + rb * KX);
    float la = 0.f, lb = 0.f;
    for (int c = lane8; c < KX4; c += 8) {
      const float4 qv = q4[c];
      if (va) {
        const float4 xv = row_a[c];
        la = fmaf(xv.x, qv.x, la);
        la = fmaf(xv.y, qv.y, la);
        la = fmaf(xv.z, qv.z, la);
        la = fmaf(xv.w, qv.w, la);
      }
      if (vb) {
        const float4 xv = row_b[c];
        lb = fmaf(xv.x, qv.x, lb);
        lb = fmaf(xv.y, qv.y, lb);
        lb = fmaf(xv.z, qv.z, lb);
        lb = fmaf(xv.w, qv.w, lb);
      }
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, o);
      lb += __shfl_xor_sync(0xffffffffu, lb, o);
    }
    if ((lane8 == 0 && va) || (lane8 == 1 && vb)) {
      const int r = lane8 == 0 ? ra : rb;
      const float l = lane8 == 0 ? la : lb;
      const float yi = ys[r];
      kahan_add(ll, ll_c, yi * l - softplus(l));
      resid[r] = yi - sigmoid(l);
    }
  }
  __syncthreads();  // the tile's residuals are written

  // gradient: the tile's partial sum, then one add into the running sum
  if (own) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int i = 0;
    for (; i + 4 <= rows; i += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(resid + i);
      a0 = fmaf(xs[i * KX + j], r4.x, a0);
      a1 = fmaf(xs[(i + 1) * KX + j], r4.y, a1);
      a2 = fmaf(xs[(i + 2) * KX + j], r4.z, a2);
      a3 = fmaf(xs[(i + 3) * KX + j], r4.w, a3);
    }
    for (; i < rows; ++i) a0 = fmaf(xs[i * KX + j], resid[i], a0);
    kahan_add(gsum, gsum_c, (a0 + a1) + (a2 + a3));
  }
}

// The logreg leaf's value and gradient at the staged position (xbuf, zero
// past K); see the header. RING: the tiles go through xring (kStages x T x
// KX floats) and yring (kStages x T); else they are read from X in place.
// resid: T floats, 16-byte aligned. Every
// thread of the CTA runs every loop trip, barrier and cp.async wait: the
// trip counts depend on n_obs and T only. Returns the raw ld; g is thread
// j's gradient coordinate.
template <bool RING>
__device__ __forceinline__ float logreg_value_grad(float q_new, const Model& model,
                                                   const float* xbuf, float* xring,
                                                   float* yring, float* resid, float* red,
                                                   int K, int j, bool own, float& g) {
  const int n_obs = model.n_obs;
  const int T = model.tile;
  const int Kp = blockDim.x;
  const int KX = (K + 3) & ~3;
  const float* __restrict__ X = model.m0;
  const float* __restrict__ y = model.m1;
  const float4* q4 = reinterpret_cast<const float4*>(xbuf);
  const int n_tiles = (n_obs + T - 1) / T;

  // copy tile t (its rows below n_obs, and their y) into stage t % kStages
  auto load_tile = [&](int t) {
    const int o0 = t * T;
    const int rows = min(T, n_obs - o0);
    const int stage = t % kStages;
    float* dst = xring + stage * T * KX;
    const float* src = X + (size_t)o0 * KX;
    for (int c = j; c < rows * (KX >> 2); c += Kp) cp_async16(dst + 4 * c, src + 4 * c);
    for (int r = j; r < rows; r += Kp) cp_async4(yring + stage * T + r, y + o0 + r);
    cp_async_commit();
  };

  // Running sums over the tiles, compensated: one thread adds n_obs / (Kp /
  // 4) likelihood terms (7,500 at n_obs 60,001, K 8), and a plain float32
  // running sum of them lost enough of ld to flip proposals (measured on
  // the H100)
  float ll = 0.f, ll_c = 0.f, gsum = 0.f, gsum_c = 0.f;
  if constexpr (RING) {
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) {
        load_tile(t);
      } else {
        cp_async_commit();  // empty groups keep the wait count uniform
      }
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int o0 = t * T;
    const int rows = min(T, n_obs - o0);
    if constexpr (RING) {
      cp_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
      __syncthreads();  // everyone's have, and tile t - 1 and resid are read
      if (t + kStages - 1 < n_tiles) {
        load_tile(t + kStages - 1);  // into tile t - 1's stage
      } else {
        cp_async_commit();
      }
      logreg_tile(xring + (t % kStages) * T * KX, yring + (t % kStages) * T, rows, KX, q4,
                  resid, j, own, ll, ll_c, gsum, gsum_c);
    } else {
      __syncthreads();  // resid is read
      logreg_tile(X + (size_t)o0 * KX, y + o0, rows, KX, q4, resid, j, own, ll, ll_c, gsum,
                  gsum_c);
    }
  }
  g = own ? gsum - model.s0 * q_new : 0.f;
  float r[2] = {ll, q_new * q_new};
  block_sum<2>(r, red);
  return r[0] + (-0.5f * model.s0 * r[1]);
}

// The transition of chain blockIdx.x, run by the two kernels below.
template <bool DIAG, int LEAF>
__device__ __forceinline__ void tree_transition(
    const float* __restrict__ q0_, const float* __restrict__ p0_,
    const float* __restrict__ g0_, const float* __restrict__ ld0_,
    const float* __restrict__ eps_, const uint32_t* __restrict__ dirs_,
    const float* __restrict__ gum, const float* __restrict__ expo,
    const float* __restrict__ minv, const Model model,
    float* __restrict__ qn, float* __restrict__ gn, float* __restrict__ ldn,
    float* __restrict__ pin, int* __restrict__ depth_o, int* __restrict__ tl_o,
    int* __restrict__ tr_o, float* __restrict__ logsum_o, int* __restrict__ steps_o,
    int* __restrict__ work_o, int C, int K, int S, int dcap, float min_delta) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int j = threadIdx.x;
  const int Kp = blockDim.x;
  const bool own = j < K;
  float* stack = smem;                       // [kNumStats][S][Kp]
  float* xbuf = smem + kNumStats * S * Kp;   // [Kp]
  float* red = xbuf + Kp;                    // [kRedSlots * 32]
  float* xring = red + kRedSlots * 32;       // [kStages][tile][KX], kLogreg only
  float* resid = xring + (LEAF == kLogreg ? kStages * model.tile * ((K + 3) & ~3) : 0);
  float* yring = resid + model.tile;         // [kStages][tile], kLogreg only

  const size_t base = (size_t)c * K + j;
  const float q0 = own ? q0_[base] : 0.f;
  const float p0 = own ? p0_[base] : 0.f;
  const float g0 = own ? g0_[base] : 0.f;
  const float ld0 = ld0_[c];
  const float eps = eps_[c];
  const uint32_t dirs = dirs_[c];
  const float minv_j = (DIAG && own) ? minv[j] : 0.f;
  const float mu_j = (LEAF == kGaussian && own) ? model.m2[j] : 0.f;

  auto psharp = [&](float p) -> float {
    if (DIAG) return p * minv_j;
    return stage_matvec(p, minv, xbuf, K, j);
  };
  // joint log density pi = ld - K(p) with K from the same M^-1 as the
  // dynamics; non-finite K counts as +inf, non-finite ld gives -inf
  auto joint = [&](float ld, float p, float sp) -> float {
    float r[1] = {p * sp};
    block_sum<1>(r, red);
    float kin = 0.5f * r[0];
    if (!isfinite(kin)) kin = pos_inf();
    return isfinite(ld) ? ld - kin : neg_inf();
  };
  auto stack_at = [&](int stat, int level) -> float& {
    return stack[(stat * S + level) * Kp + j];
  };

  const float sp0 = psharp(p0);
  const float pi0 = joint(ld0, p0, sp0);

  // edges (minus / plus), proposal, trajectory turn statistic
  float zmq = q0, zmp = p0, zmg = g0, zpq = q0, zpp = p0, zpg = g0;
  float pq = q0, pg = g0, prop_ld = ld0, prop_pi = pi0;
  Tau tau = {p0, p0, p0, sp0, sp0};
  int i_minus = 0, i_plus = 0;
  float omega = 0.f, log_sum = neg_inf();
  int steps = 0, depth = 0, term_left = 1, term_right = 0, work = 0;
  bool terminated = false;

  for (int d = 0; d < dcap && !terminated; ++d) {
    const bool fwd = ((dirs >> d) & 1u) == 1u;
    float wq = fwd ? zpq : zmq;
    float wp = fwd ? zpp : zmp;
    float wg = fwd ? zpg : zmg;
    const int i_edge = fwd ? i_plus : i_minus;
    const int step = fwd ? 1 : -1;
    const float eps_s = fwd ? eps : -eps;
    const float half = 0.5f * eps_s;
    const int row0 = (1 << d) - 1;  // gum row of this doubling's leaf 0
    const int n_leaves = 1 << d;

    // --- the depth-d adjacent tree ------------------------------------
    bool building = true;
    float a_logsum = neg_inf(), a_omega = neg_inf(), best_score = neg_inf();
    int a_steps = 0, inv_left = 0, inv_right = 0;
    float bq = 0.f, bg = 0.f, best_ld = 0.f, best_pi = 0.f;
    Tau node;
    int n = 0;
    while (n < n_leaves && building) {
      // leapfrog leaf with the model's value and gradient
      const float p_mid = wp + half * wg;
      const float q_new = wq + eps_s * psharp(p_mid);
      float g_new, ld_new;
      bool grad_ok;
      if constexpr (LEAF == kGaussian) {
        const float dq = own ? q_new - mu_j : 0.f;
        __syncthreads();
        xbuf[j] = dq;
        __syncthreads();
        float w = 0.f, pd = 0.f, w_c = 0.f, pd_c = 0.f;
        if (own) {
          for (int i = 0; i < K; ++i) {
            const float di = xbuf[i];
            kahan_fma(w, w_c, __ldg(model.m1 + (size_t)i * K + j), di);
            kahan_fma(pd, pd_c, __ldg(model.m0 + (size_t)i * K + j), di);
          }
        }
        g_new = -pd;
        float r[2] = {w * w, isfinite(g_new) ? 0.f : 1.f};
        block_sum<2>(r, red);
        ld_new = -0.5f * r[0];
        grad_ok = r[1] == 0.f;
      } else if constexpr (LEAF == kFunnel) {
        float r[2] = {q_new * q_new, j == 0 ? q_new : 0.f};
        block_sum<2>(r, red);
        const float v = r[1];
        const float x2 = r[0] - v * v;
        const float emv = expf(-v);
        ld_new = -0.5f * (v * v) / model.s0 - model.s1 * v - 0.5f * emv * x2;
        const float gv = -v / model.s0 - model.s1 + 0.5f * emv * x2;
        g_new = own ? (j == 0 ? gv : -emv * q_new) : 0.f;
        grad_ok = !__syncthreads_or(own && !isfinite(g_new));
      } else {
        __syncthreads();  // earlier readers of xbuf are done
        xbuf[j] = q_new;
        __syncthreads();
        ld_new = logreg_value_grad<LEAF == kLogreg>(q_new, model, xbuf, xring, yring, resid,
                                                    red, K, j, own, g_new);
        grad_ok = !__syncthreads_or(own && !isfinite(g_new));
      }
      // -inf poisoning, as the plain driver's evaluate
      if (!((isfinite(ld_new) && grad_ok) || ld_new == neg_inf())) ld_new = neg_inf();
      const float p_new = p_mid + half * g_new;
      const float sp = psharp(p_new);
      const float pi = joint(ld_new, p_new, sp);
      wq = q_new;
      wp = p_new;
      wg = g_new;

      const int i_new = i_edge + step * (n + 1);
      const float delta = pi - pi0;
      const bool divergent = delta < min_delta;
      a_logsum = logaddexp(a_logsum, fminf(delta, 0.f));
      a_steps += 1;
      const float score = divergent ? neg_inf() : delta + gum[(size_t)(row0 + n) * C + c];
      if (score > best_score) {
        best_score = score;
        bq = q_new;
        bg = g_new;
        best_ld = ld_new;
        best_pi = pi;
      }
      a_omega = logaddexp(a_omega, divergent ? neg_inf() : delta);

      if (divergent) {
        inv_left = i_new;
        inv_right = i_new;
        building = false;
      } else {
        // trailing-ones merge run of the leaf counter
        node = Tau{p_new, p_new, p_new, sp, sp};
        int level = 0;
        bool turned = false;
        while ((n >> level) & 1) {
          const Tau popped = {stack_at(0, level), stack_at(1, level), stack_at(2, level),
                              stack_at(3, level), stack_at(4, level)};
          Tau merged;
          if (combine_dir(popped, node, fwd, merged, red)) {
            turned = true;
            inv_left = i_edge + step * (n - (1 << (level + 1)) + 2);
            inv_right = i_new;
            break;
          }
          node = merged;
          ++level;
        }
        if (turned) {
          building = false;
        } else {
          stack_at(0, level) = node.pm;
          stack_at(1, level) = node.pp;
          stack_at(2, level) = node.rho;
          stack_at(3, level) = node.spm;
          stack_at(4, level) = node.spp;
        }
      }
      ++n;
    }
    work += n;

    // --- doubling bookkeeping ------------------------------------------
    log_sum = logaddexp(log_sum, a_logsum);
    steps += a_steps;
    if (!building) {
      // invalid adjacent tree: divergence or a turning subtree
      term_left = inv_left;
      term_right = inv_right;
      terminated = true;
      continue;
    }
    // `node` holds the completed subtree's statistic (stack slot d)
    const int i_end = i_edge + step * n;
    if (fwd) {
      zpq = wq; zpp = wp; zpg = wg; i_plus = i_end;
    } else {
      zmq = wq; zmp = wp; zmg = wg; i_minus = i_end;
    }
    const float omega_old = omega;
    omega = logaddexp(omega_old, a_omega);
    Tau merged;
    const bool turning = combine_dir(tau, node, fwd, merged, red);
    if (!turning) tau = merged;
    depth += 1;
    if (turning) {
      term_left = i_minus;
      term_right = i_plus;
      terminated = true;
    }
    // biased progressive combine: accept with probability min(1, e^lp2)
    const float lp2 = a_omega - omega_old;
    const bool accept = (lp2 >= 0.f) | (expo[(size_t)d * C + c] > -lp2);
    if (accept) {
      pq = bq;
      pg = bg;
      prop_ld = best_ld;
      prop_pi = best_pi;
    }
  }

  if (own) {
    qn[base] = pq;
    gn[base] = pg;
  }
  if (j == 0) {
    ldn[c] = prop_ld;
    pin[c] = prop_pi;
    depth_o[c] = depth;
    tl_o[c] = term_left;
    tr_o[c] = term_right;
    logsum_o[c] = log_sum;
    steps_o[c] = steps;
    work_o[c] = work;
  }
}

template <bool DIAG, int LEAF>
__global__ void tree_transition_kernel(
    const float* __restrict__ q0_, const float* __restrict__ p0_,
    const float* __restrict__ g0_, const float* __restrict__ ld0_,
    const float* __restrict__ eps_, const uint32_t* __restrict__ dirs_,
    const float* __restrict__ gum, const float* __restrict__ expo,
    const float* __restrict__ minv, const Model model,
    float* __restrict__ qn, float* __restrict__ gn, float* __restrict__ ldn,
    float* __restrict__ pin, int* __restrict__ depth_o, int* __restrict__ tl_o,
    int* __restrict__ tr_o, float* __restrict__ logsum_o, int* __restrict__ steps_o,
    int* __restrict__ work_o, int C, int K, int S, int dcap, float min_delta) {
  tree_transition<DIAG, LEAF>(q0_, p0_, g0_, ld0_, eps_, dirs_, gum, expo, minv, model, qn, gn,
                              ldn, pin, depth_o, tl_o, tr_o, logsum_o, steps_o, work_o, C, K, S,
                              dcap, min_delta);
}

// The same for a CTA wider than the registers tree_transition_kernel takes
// allow on an SM (65,536): at most 64 registers a thread, so that 1024
// threads fit, spilling where they must. Only the widest K launch it
// (launch).
template <bool DIAG, int LEAF>
__global__ void __launch_bounds__(1024, 1) tree_transition_kernel_wide(
    const float* __restrict__ q0_, const float* __restrict__ p0_,
    const float* __restrict__ g0_, const float* __restrict__ ld0_,
    const float* __restrict__ eps_, const uint32_t* __restrict__ dirs_,
    const float* __restrict__ gum, const float* __restrict__ expo,
    const float* __restrict__ minv, const Model model,
    float* __restrict__ qn, float* __restrict__ gn, float* __restrict__ ldn,
    float* __restrict__ pin, int* __restrict__ depth_o, int* __restrict__ tl_o,
    int* __restrict__ tr_o, float* __restrict__ logsum_o, int* __restrict__ steps_o,
    int* __restrict__ work_o, int C, int K, int S, int dcap, float min_delta) {
  tree_transition<DIAG, LEAF>(q0_, p0_, g0_, ld0_, eps_, dirs_, gum, expo, minv, model, qn, gn,
                              ldn, pin, depth_o, tl_o, tr_o, logsum_o, steps_o, work_o, C, K, S,
                              dcap, min_delta);
}

// --- The Gaussian and funnel leaves, one warp per chain ---------------------
//
// tree_transition_warp_kernel<DIAG, LEAF, R> runs the transition of
// tree_transition<DIAG, LEAF> (LEAF kGaussian or kFunnel) for K <= 32 R
// coordinates with one warp per chain: lane l keeps coordinates l + 32 s,
// s < R, of every per-chain vector in registers. Every dot product is the
// lane's R partials added in order, then an xor butterfly over the warp,
// which leaves the bitwise same value in every lane, so the warp's control
// flow stays uniform. The CTA copies the leaf's matrices into shared memory
// once and crosses one barrier: prec^T, L and the dense M^-1 for the
// Gaussian, the dense M^-1 alone for the funnel, and nothing (no barrier)
// for the funnel with a diagonal metric. After it each warp takes chains
// from the queue counter until none is left, with no CTA barrier inside a
// transition. Each warp keeps its merge stack (5 x S x 32 R floats) and one
// staging vector (32 R floats) in shared memory; a lane reads and writes
// only its own coordinates of the stack, and __syncwarp fences the staging
// vector. The funnel leaf: Sigma q^2 by warp_sum, v = q[0] by a shuffle
// from lane 0 (exact), then the CTA variant's formula; lane 0's s = 0 slot
// takes d/dv. Each doubling loads its Exponential as it starts and each
// leaf the Gumbel of the next one, so that no noise load waits on the
// leaf's serial path. At K <= 32 every sum runs in the CTA variant's order,
// so the funnel's two variants give bitwise the same transition there. The
// kernel's body (warp_tree_transitions) also runs the logreg leaf's
// staged-X variant, tree_transition_kernel_xstaged (below).

constexpr int kWarpMaxR = 4;  // K <= 128

// The funnel leaf at R = 1 (K <= 32, the funnel path's K = 25): warps per
// CTA, and CTAs per SM that its launch bounds ask of ptxas. Two 10-warp
// CTAs leave it 102 registers a thread: ptxas takes 93-95 and spills
// nothing, and an SM holds 20 of its warps. Of the launch bounds tried
// (scripts/torch_tree_funnel_sweep.sh), the tighter ones that hold 24-32
// warps an SM (64-80 registers) spill (at 80, 6 bytes of the diagonal
// instantiation) and run slower on the H100.
constexpr int kFunnelWarps = 10, kFunnelCtas = 2;

// Warps per CTA at most, by leaf and R. The Gaussian: what the registers
// allow at one CTA per SM without a spill. The register file is split over
// the SM's 4 schedulers, so W warps leave 16,384 / (32 ceil(W / 4))
// registers a thread: 128 for 13-16 warps (R <= 2), 168 for 9-12 (R = 3),
// 255 for 8 (R = 4). The funnel at R = 1: kFunnelWarps.
__host__ __device__ constexpr int warp_max_warps(int leaf, int R) {
  return leaf == kFunnel && R == 1 ? kFunnelWarps : R <= 2 ? 16 : R == 3 ? 12 : 8;
}

// CTAs per SM the launch bounds ask of ptxas. The Gaussian stages its
// matrices once per CTA and takes the SM's shared memory with one CTA. The
// funnel stages at most M^-1, so its residency at R = 1 is set by its
// registers (kFunnelCtas); a cap written on the Gaussian's instantiations
// would change their code.
__host__ __device__ constexpr int warp_min_ctas(int leaf, int R) {
  return leaf == kFunnel && R == 1 ? kFunnelCtas : 1;
}

// Matrices of K x K floats that the CTA stages for the leaf.
__host__ __device__ constexpr int warp_matrices(int leaf, bool diag) {
  return leaf == kGaussian ? (diag ? 2 : 3) : (diag ? 0 : 1);
}

template <int R>
struct TauW {
  float pm[R], pp[R], rho[R], spm[R], spp[R];
};

// The lane's R partials in order, then the xor butterfly over the warp.
template <int R>
__device__ __forceinline__ float warp_sum(const float (&v)[R]) {
  float s = v[0];
#pragma unroll
  for (int i = 1; i < R; ++i) s += v[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// combine_dir over the lane's coordinates: `first` precedes `second` in
// traversal order. Selected element by element: a select between two
// register arrays by reference would put them in local memory.
template <int R>
__device__ __forceinline__ bool combine_dir_warp(const TauW<R>& first, const TauW<R>& second,
                                                 bool fwd, TauW<R>& out) {
  float v[6][R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const float xpm = fwd ? first.pm[s] : second.pm[s];
    const float xpp = fwd ? first.pp[s] : second.pp[s];
    const float xrho = fwd ? first.rho[s] : second.rho[s];
    const float xspm = fwd ? first.spm[s] : second.spm[s];
    const float xspp = fwd ? first.spp[s] : second.spp[s];
    const float ypm = fwd ? second.pm[s] : first.pm[s];
    const float ypp = fwd ? second.pp[s] : first.pp[s];
    const float yrho = fwd ? second.rho[s] : first.rho[s];
    const float yspm = fwd ? second.spm[s] : first.spm[s];
    const float yspp = fwd ? second.spp[s] : first.spp[s];
    const float r1 = xrho + ypm;
    const float r2 = xpp + yrho;
    const float rho = xrho + yrho;
    v[0][s] = xspm * r1;
    v[1][s] = yspm * r1;
    v[2][s] = xspp * r2;
    v[3][s] = yspp * r2;
    v[4][s] = xspm * rho;
    v[5][s] = yspp * rho;
    out.pm[s] = xpm;
    out.pp[s] = ypp;
    out.rho[s] = rho;
    out.spm[s] = xspm;
    out.spp[s] = yspp;
  }
  bool turn = false;
#pragma unroll
  for (int k = 0; k < 6; ++k) turn |= warp_sum<R>(v[k]) < 0.f;
  return turn;
}

// y[m][s] = sum_i A[m][i][lane + 32 s] x_i over the staged x (xbuf, K
// floats, 16-byte aligned) for NM matrices in one pass, i in order and
// compensated (kahan_fma). Lane l reads A[m][i][l + 32 s], 32 consecutive
// words (no bank conflict), and x_i as a broadcast float4.
template <int R, int NM>
__device__ __forceinline__ void staged_matvec(const float* const (&A)[NM], const float* xbuf,
                                              int K, int lane, bool own_last,
                                              float (&y)[NM][R]) {
  float c[NM][R];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int s = 0; s < R; ++s) y[m][s] = c[m][s] = 0.f;
  auto row = [&](int i, float xi) {
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float* a = A[m] + i * K + lane;
#pragma unroll
      for (int s = 0; s < R; ++s) {
        if (s < R - 1 || own_last) kahan_fma(y[m][s], c[m][s], a[32 * s], xi);
      }
    }
  };
  int i = 0;
  for (; i + 4 <= K; i += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(xbuf + i);
    row(i, x4.x);
    row(i + 1, x4.y);
    row(i + 2, x4.z);
    row(i + 3, x4.w);
  }
  for (; i < K; ++i) row(i, xbuf[i]);
}

// Copy n floats of a matrix into shared memory with every thread of the
// CTA, 16 bytes a thread where src is 16-byte aligned.
__device__ __forceinline__ void stage_matrix(float* dst, const float* __restrict__ src, int n) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
    i0 = 4 * n4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// Floats of one staged K x K matrix: rounded up to 4, so that the next
// starts 16 bytes aligned.
__host__ __device__ __forceinline__ int padded_kk(int K) { return (K * K + 3) & ~3; }

// --- The logreg leaf with X staged once per CTA, one warp per chain --------
//
// tree_transition_kernel_xstaged<DIAG, R> runs the logreg leaf's transition
// for K <= 32 R coordinates with the warp variant's body
// (warp_tree_transitions: one chain per warp from the queue, lane l keeping
// coordinates l + 32 s) wherever xstaged_plan fits all of X in the CTA's
// shared memory; every other logreg launch runs the CTA variant. X is the
// same for every chain, so the CTA copies X, y and the dense M^-1 into
// shared memory once and crosses its only barrier: at n_obs 1000, K 25 the
// CTAs of a launch read 15 MB of X from L2, where the CTA variant reads X
// once per chain-leaf (13.3 GB a 16,384-chain draws launch). X and y lie
// after the per-warp regions, so that the body's other pointers are the
// warp variant's.
// The leaf (xstaged_logreg_leaf) gives rows to lanes: G = xs_lanes(R)
// lanes per row (1 at K <= 32), 32 / G rows a warp step. Lane g of a row
// reads its float4 chunks c G + g of the staged row once, forms the row's
// partial logit against q (those columns of q, in registers) in four
// interleaved partial sums and adds the G partials by xor shuffles. Then
// one exponential e = exp(-|l|) (expf, as the CTA leaf's softplus) gives
// both y l - softplus(l) = y l - max(l, 0) - log1p(e) (lane g = 0 only)
// and the residual r = y - sigmoid(l), sigmoid(l) = (l >= 0 ? 1 : e) /
// (1 + e) (stable at both tails, as the CTA leaf's tanh form), and the
// lane adds r x into its own gradient partials. The division is
// __fdividef, within 2 ulp for a divisor in [2^-126, 2^126], and 1 + e
// lies in [1, 2]. expf and
// log1pf stay the accurate ones: the fast exponential's error grows with
// |l|, and the card's fast logarithm, summed over 1911 rows, put log_sum
// 1.19 times the GPU tests' float64 allowance from float64. A lane sums
// kXsBlockRows of its rows plainly, then adds the block into its running
// ll and gradient sums compensated (kahan_add). After the last row one xor butterfly per column
// over the lanes of one part (fixed order) gives the column's sum; lanes
// 0..G-1 publish the gradient in the warp's staging vector, and lane l
// reads its coordinates back. A staged row is xs_stride floats long: G
// chunks more where each lane's chunk count is even, so that the 8 lanes of
// each quarter-warp phase of a 128-bit load (8 / G rows) read 8 distinct
// 16-byte bank groups. Products are fp32 FMAs, no TF32; every sum runs in a
// fixed order, so a launch is deterministic whichever warp takes a chain.

constexpr int kXsWarps = 8;      // warps per CTA at most: its launch bounds, one CTA per SM
constexpr int kXsMinWarps = 4;   // fewer fit beside X and the launch takes the CTA variant
constexpr int kXsBlockRows = 16;  // a lane's rows summed plainly before each compensated add

// Lanes per row of X by R, and float4 chunks of a row a lane reads at most:
// at most 32 columns of q and of each gradient sum a lane.
__host__ __device__ constexpr int xs_lanes(int R) { return R == 1 ? 1 : R == 4 ? 8 : 4; }
__host__ __device__ constexpr int xs_max_chunks(int R) { return 8 * R / xs_lanes(R); }

// Chunks of a row each of its G lanes reads: ceil(ceil(K / 4) / G).
__host__ __device__ __forceinline__ int xs_chunks(int K, int G) {
  return ((K + 3) / 4 + G - 1) / G;
}

// Floats between two staged rows: 4 G n for n chunks a lane, n made odd.
__host__ __device__ __forceinline__ int xs_stride(int K, int G) {
  return 4 * G * (xs_chunks(K, G) | 1);
}

// Copy the chunks of X's rows that lanes read (zero past X's KX columns)
// to s_x at xs_stride, and y after them, with every thread of the CTA.
template <int R>
__device__ __forceinline__ void stage_xy(float* s_x, const Model& model, int K) {
  constexpr int G = xs_lanes(R);
  const int n_obs = model.n_obs;
  const int KS = xs_stride(K, G);
  float* s_y = s_x + n_obs * KS;
  const int row4 = G * xs_chunks(K, G), kx4 = (K + 3) >> 2;
  const float4* X4 = reinterpret_cast<const float4*>(model.m0);
  for (int t = threadIdx.x; t < n_obs * row4; t += blockDim.x) {
    const int i = t / row4, k = t - i * row4;
    reinterpret_cast<float4*>(s_x + i * KS)[k] =
        k < kx4 ? __ldg(X4 + i * kx4 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < n_obs; i += blockDim.x) s_y[i] = __ldg(model.m1 + i);
}

// logreg: where X's rows begin, after the dense M^-1 and every warp's region
// of merge stack and staging vector; y follows X.
template <bool DIAG, int R>
__device__ __forceinline__ float* xs_rows(float* smem, int K, int S) {
  return smem + warp_matrices(kLogreg, DIAG) * padded_kk(K) +
         (blockDim.x >> 5) * (kNumStats * S + 1) * 32 * R;
}

// The logreg leaf's value and gradient at q_new (lane l's coordinates
// l + 32 s, 0 past K) from X staged at s_x and y after it, for one warp;
// see above. g_new: the lane's gradient coordinates; bad: set where one is
// not finite.
template <int R>
__device__ __forceinline__ void xstaged_logreg_leaf(const float (&q_new)[R], float (&g_new)[R],
                                                    float& ld_new, bool& bad, const float* s_x,
                                                    float* xbuf, const Model& model, int K,
                                                    int lane, bool own_last) {
  constexpr int G = xs_lanes(R);
  constexpr int NCH = xs_max_chunks(R);
  constexpr int kStepRows = 32 / G;
  const int n_obs = model.n_obs;
  const int nch = xs_chunks(K, G);
  const int KS = xs_stride(K, G);
  const float* s_y = s_x + n_obs * KS;
  const int g = lane % G;      // the lane's part of its row
  const int rlane = lane / G;  // the lane's row in a step
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();  // earlier readers of xbuf are done
#pragma unroll
  for (int s = 0; s < R; ++s) xbuf[lane + 32 * s] = q_new[s];
  __syncwarp();
  const float4* xbuf4 = reinterpret_cast<const float4*>(xbuf);
  float4 q[NCH], gs[NCH], gc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    q[c] = c < nch ? xbuf4[c * G + g] : zero4;
    gs[c] = gc[c] = zero4;
  }
  // Running sums, compensated: a plain float32 running sum of the
  // likelihood terms lost enough of ld to flip proposals at 60,001 rows
  // (measured on the H100)
  float ll = 0.f, ll_c = 0.f;
  for (int i0 = 0; i0 < n_obs; i0 += kXsBlockRows * kStepRows) {
    float bl = 0.f;
    float4 gb[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) gb[c] = zero4;
    for (int b = 0; b < kXsBlockRows && i0 + b * kStepRows < n_obs; ++b) {
      const int i = i0 + b * kStepRows + rlane;
      const bool valid = i < n_obs;
      const float4* row = reinterpret_cast<const float4*>(s_x + i * KS) + g;
      // the row's chunks, all loads ahead of the products (zero past nch)
      float4 x[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) x[c] = valid && c < nch ? row[c * G] : zero4;
      float l0 = 0.f, l1 = 0.f, l2 = 0.f, l3 = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        l0 = fmaf(x[c].x, q[c].x, l0);
        l1 = fmaf(x[c].y, q[c].y, l1);
        l2 = fmaf(x[c].z, q[c].z, l2);
        l3 = fmaf(x[c].w, q[c].w, l3);
      }
      float l = (l0 + l1) + (l2 + l3);
#pragma unroll
      for (int o = 1; o < G; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      const float yi = valid ? s_y[i] : 0.f;
      const float e = expf(-fabsf(l));
      if (valid && g == 0) bl += yi * l - (fmaxf(l, 0.f) + log1pf(e));
      const float r = valid ? yi - __fdividef(l >= 0.f ? 1.f : e, 1.f + e) : 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        gb[c].x = fmaf(x[c].x, r, gb[c].x);
        gb[c].y = fmaf(x[c].y, r, gb[c].y);
        gb[c].z = fmaf(x[c].z, r, gb[c].z);
        gb[c].w = fmaf(x[c].w, r, gb[c].w);
      }
    }
    kahan_add(ll, ll_c, bl);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      kahan_add(gs[c].x, gc[c].x, gb[c].x);
      kahan_add(gs[c].y, gc[c].y, gb[c].y);
      kahan_add(gs[c].z, gc[c].z, gb[c].z);
      kahan_add(gs[c].w, gc[c].w, gb[c].w);
    }
  }
  // each column's sum over the lanes of its part, the likelihood's over the
  // warp: xor butterflies, so every lane holds the same bits
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int o = G; o < 32; o <<= 1) {
      gs[c].x += __shfl_xor_sync(0xffffffffu, gs[c].x, o);
      gs[c].y += __shfl_xor_sync(0xffffffffu, gs[c].y, o);
      gs[c].z += __shfl_xor_sync(0xffffffffu, gs[c].z, o);
      gs[c].w += __shfl_xor_sync(0xffffffffu, gs[c].w, o);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ll += __shfl_xor_sync(0xffffffffu, ll, o);
  __syncwarp();  // every lane has read q from xbuf
  if (rlane == 0) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c < nch) reinterpret_cast<float4*>(xbuf)[c * G + g] = gs[c];
    }
  }
  __syncwarp();
  float sq[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const bool own = s < R - 1 || own_last;
    g_new[s] = own ? xbuf[lane + 32 * s] - model.s0 * q_new[s] : 0.f;
    sq[s] = q_new[s] * q_new[s];
    bad |= !isfinite(g_new[s]);
  }
  ld_new = ll + (-0.5f * model.s0 * warp_sum<R>(sq));
}

// The body of tree_transition_warp_kernel (LEAF kGaussian or kFunnel) and
// of tree_transition_kernel_xstaged (kLogreg).
template <bool DIAG, int LEAF, int R>
__device__ __forceinline__ void warp_tree_transitions(
    const float* __restrict__ q0_, const float* __restrict__ p0_,
    const float* __restrict__ g0_, const float* __restrict__ ld0_,
    const float* __restrict__ eps_, const uint32_t* __restrict__ dirs_,
    const float* __restrict__ gum, const float* __restrict__ expo,
    const float* __restrict__ minv, const Model model,
    float* __restrict__ qn, float* __restrict__ gn, float* __restrict__ ldn,
    float* __restrict__ pin, int* __restrict__ depth_o, int* __restrict__ tl_o,
    int* __restrict__ tr_o, float* __restrict__ logsum_o, int* __restrict__ steps_o,
    int* __restrict__ work_o, int* __restrict__ queue, int C, int K, int S, int dcap,
    float min_delta) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kk = padded_kk(K);
  constexpr bool kGauss = LEAF == kGaussian;
  float* s_prec = smem;                        // Gaussian: prec^T
  float* s_chol = smem + kk;                   // Gaussian: L
  float* s_minv = smem + (kGauss ? 2 * kk : 0);  // dense M^-1
  float* stack = smem + warp_matrices(LEAF, DIAG) * kk + warp * (kNumStats * S + 1) * 32 * R;
  float* xbuf = stack + kNumStats * S * 32 * R;  // [32 R], 16-byte aligned

  if constexpr (kGauss) {
    stage_matrix(s_prec, model.m0, K * K);
    stage_matrix(s_chol, model.m1, K * K);
  }
  if constexpr (LEAF == kLogreg) stage_xy<R>(xs_rows<DIAG, R>(smem, K, S), model, K);
  if constexpr (warp_matrices(LEAF, DIAG) > 0 || LEAF == kLogreg) {
    if (!DIAG) stage_matrix(s_minv, minv, K * K);
    __syncthreads();  // the CTA's only barrier
  }

  // lane owns coordinate lane + 32 s for every s < R - 1, and for s = R - 1
  // when own_last
  const bool own_last = lane + 32 * (R - 1) < K;
  auto own = [&](int s) { return s < R - 1 || own_last; };
  float mu[R], mdiag[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    mu[s] = (kGauss && own(s)) ? model.m2[lane + 32 * s] : 0.f;
    mdiag[s] = (DIAG && own(s)) ? minv[lane + 32 * s] : 0.f;
  }

  // publish x (0 past K) into the staging vector
  auto stage = [&](const float (&x)[R]) {
    __syncwarp();  // earlier readers of xbuf are done
#pragma unroll
    for (int s = 0; s < R; ++s) xbuf[lane + 32 * s] = x[s];
    __syncwarp();
  };
  const float* const minv_mat[1] = {s_minv};
  auto psharp = [&](const float (&p)[R], float (&sp)[R]) {
    if constexpr (DIAG) {
#pragma unroll
      for (int s = 0; s < R; ++s) sp[s] = p[s] * mdiag[s];
    } else {
      stage(p);
      float y[1][R];
      staged_matvec<R, 1>(minv_mat, xbuf, K, lane, own_last, y);
#pragma unroll
      for (int s = 0; s < R; ++s) sp[s] = y[0][s];
    }
  };
  // joint log density pi = ld - K(p), as in tree_transition
  auto joint = [&](float ld, const float (&p)[R], const float (&sp)[R]) -> float {
    float t[R];
#pragma unroll
    for (int s = 0; s < R; ++s) t[s] = p[s] * sp[s];
    float kin = 0.5f * warp_sum<R>(t);
    if (!isfinite(kin)) kin = pos_inf();
    return isfinite(ld) ? ld - kin : neg_inf();
  };
  auto stack_at = [&](int stat, int level, int s) -> float& {
    return stack[(stat * S + level) * 32 * R + lane + 32 * s];
  };

  for (;;) {
    int c = 0;
    if (lane == 0) c = atomicAdd(queue, 1);
    c = __shfl_sync(0xffffffffu, c, 0);
    if (c >= C) {
      // queue[1] counts the warps done; the last one zeroes the queue for
      // the next launch on the stream (every other warp has taken its last
      // index by then)
      if (lane == 0) {
        __threadfence();
        if (atomicAdd(queue + 1, 1) == (int)(gridDim.x * (blockDim.x >> 5)) - 1) {
          queue[0] = 0;
          queue[1] = 0;
        }
      }
      return;
    }

    const size_t base = (size_t)c * K + lane;
    float zmq[R], zmp[R], zmg[R], zpq[R], zpp[R], zpg[R], pq[R], pg[R], sp0[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      zmq[s] = own(s) ? q0_[base + 32 * s] : 0.f;
      zmp[s] = own(s) ? p0_[base + 32 * s] : 0.f;
      zmg[s] = own(s) ? g0_[base + 32 * s] : 0.f;
    }
    const float ld0 = ld0_[c];
    const float eps = eps_[c];
    const uint32_t dirs = dirs_[c];
    psharp(zmp, sp0);
    const float pi0 = joint(ld0, zmp, sp0);

    // edges (minus / plus), proposal, trajectory turn statistic
    TauW<R> tau;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      zpq[s] = pq[s] = zmq[s];
      zpp[s] = tau.pm[s] = tau.pp[s] = tau.rho[s] = zmp[s];
      zpg[s] = pg[s] = zmg[s];
      tau.spm[s] = tau.spp[s] = sp0[s];
    }
    float prop_ld = ld0, prop_pi = pi0;
    int i_minus = 0, i_plus = 0;
    float omega = 0.f, log_sum = neg_inf();
    int steps = 0, depth = 0, term_left = 1, term_right = 0, work = 0;
    bool terminated = false;

    for (int d = 0; d < dcap && !terminated; ++d) {
      const bool fwd = ((dirs >> d) & 1u) == 1u;
      float wq[R], wp[R], wg[R];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        wq[s] = fwd ? zpq[s] : zmq[s];
        wp[s] = fwd ? zpp[s] : zmp[s];
        wg[s] = fwd ? zpg[s] : zmg[s];
      }
      const int i_edge = fwd ? i_plus : i_minus;
      const int step = fwd ? 1 : -1;
      const float eps_s = fwd ? eps : -eps;
      const float half = 0.5f * eps_s;
      const int row0 = (1 << d) - 1;  // gum row of this doubling's leaf 0
      const int n_leaves = 1 << d;
      // the doubling's noise, loaded ahead of its use: its Exponential now,
      // each leaf's Gumbel while the leaf before it is computed
      const float expo_d = expo[(size_t)d * C + c];
      float gum_next = gum[(size_t)row0 * C + c];

      // --- the depth-d adjacent tree ----------------------------------
      bool building = true;
      float a_logsum = neg_inf(), a_omega = neg_inf(), best_score = neg_inf();
      int a_steps = 0, inv_left = 0, inv_right = 0;
      float bq[R], bg[R], best_ld = 0.f, best_pi = 0.f;
      TauW<R> node;
#pragma unroll
      for (int s = 0; s < R; ++s) bq[s] = bg[s] = 0.f;
      int n = 0;
      while (n < n_leaves && building) {
        const float gum_n = gum_next;
        if (n + 1 < n_leaves) gum_next = gum[(size_t)(row0 + n + 1) * C + c];
        // leapfrog leaf with the model's value and gradient
        float p_mid[R], sp[R], q_new[R], g_new[R];
#pragma unroll
        for (int s = 0; s < R; ++s) p_mid[s] = wp[s] + half * wg[s];
        psharp(p_mid, sp);
#pragma unroll
        for (int s = 0; s < R; ++s) q_new[s] = wq[s] + eps_s * sp[s];
        float ld_new;
        bool bad = false;
        if constexpr (kGauss) {
          // d = q - mu, ld = -1/2 ||L^T d||^2, grad = -prec d
          float dq[R];
#pragma unroll
          for (int s = 0; s < R; ++s) dq[s] = own(s) ? q_new[s] - mu[s] : 0.f;
          stage(dq);
          const float* const leaf_mats[2] = {s_chol, s_prec};
          float wpd[2][R];  // L^T d and prec d in one pass over the staged d
          staged_matvec<R, 2>(leaf_mats, xbuf, K, lane, own_last, wpd);
          float ww[R];
#pragma unroll
          for (int s = 0; s < R; ++s) {
            g_new[s] = -wpd[1][s];
            ww[s] = wpd[0][s] * wpd[0][s];
            bad |= !isfinite(g_new[s]);
          }
          ld_new = -0.5f * warp_sum<R>(ww);
        } else if constexpr (LEAF == kFunnel) {
          // v = q[0], ld = -1/2 v^2 / s0 - s1 v - 1/2 e^-v sum_{i>0} q_i^2
          float sq[R];
#pragma unroll
          for (int s = 0; s < R; ++s) sq[s] = q_new[s] * q_new[s];
          const float total = warp_sum<R>(sq);
          const float v = __shfl_sync(0xffffffffu, q_new[0], 0);
          const float x2 = total - v * v;
          const float emv = expf(-v);
          ld_new = -0.5f * (v * v) / model.s0 - model.s1 * v - 0.5f * emv * x2;
          const float gv = -v / model.s0 - model.s1 + 0.5f * emv * x2;
#pragma unroll
          for (int s = 0; s < R; ++s) {
            g_new[s] = own(s) ? ((s == 0 && lane == 0) ? gv : -emv * q_new[s]) : 0.f;
            bad |= !isfinite(g_new[s]);
          }
        } else {
          xstaged_logreg_leaf<R>(q_new, g_new, ld_new, bad, xs_rows<DIAG, R>(smem, K, S), xbuf,
                                 model, K, lane, own_last);
        }
        const bool grad_ok = !__any_sync(0xffffffffu, bad);
        // -inf poisoning, as the plain driver's evaluate
        if (!((isfinite(ld_new) && grad_ok) || ld_new == neg_inf())) ld_new = neg_inf();
        float p_new[R];
#pragma unroll
        for (int s = 0; s < R; ++s) p_new[s] = p_mid[s] + half * g_new[s];
        psharp(p_new, sp);
        const float pi = joint(ld_new, p_new, sp);
#pragma unroll
        for (int s = 0; s < R; ++s) {
          wq[s] = q_new[s];
          wp[s] = p_new[s];
          wg[s] = g_new[s];
        }

        const int i_new = i_edge + step * (n + 1);
        const float delta = pi - pi0;
        const bool divergent = delta < min_delta;
        a_logsum = logaddexp(a_logsum, fminf(delta, 0.f));
        a_steps += 1;
        const float score = divergent ? neg_inf() : delta + gum_n;
        if (score > best_score) {
          best_score = score;
#pragma unroll
          for (int s = 0; s < R; ++s) {
            bq[s] = q_new[s];
            bg[s] = g_new[s];
          }
          best_ld = ld_new;
          best_pi = pi;
        }
        a_omega = logaddexp(a_omega, divergent ? neg_inf() : delta);

        if (divergent) {
          inv_left = i_new;
          inv_right = i_new;
          building = false;
        } else {
          // trailing-ones merge run of the leaf counter
#pragma unroll
          for (int s = 0; s < R; ++s) {
            node.pm[s] = node.pp[s] = node.rho[s] = p_new[s];
            node.spm[s] = node.spp[s] = sp[s];
          }
          int level = 0;
          bool turned = false;
          while ((n >> level) & 1) {
            TauW<R> popped, merged;
#pragma unroll
            for (int s = 0; s < R; ++s) {
              popped.pm[s] = stack_at(0, level, s);
              popped.pp[s] = stack_at(1, level, s);
              popped.rho[s] = stack_at(2, level, s);
              popped.spm[s] = stack_at(3, level, s);
              popped.spp[s] = stack_at(4, level, s);
            }
            if (combine_dir_warp<R>(popped, node, fwd, merged)) {
              turned = true;
              inv_left = i_edge + step * (n - (1 << (level + 1)) + 2);
              inv_right = i_new;
              break;
            }
            node = merged;
            ++level;
          }
          if (turned) {
            building = false;
          } else {
#pragma unroll
            for (int s = 0; s < R; ++s) {
              stack_at(0, level, s) = node.pm[s];
              stack_at(1, level, s) = node.pp[s];
              stack_at(2, level, s) = node.rho[s];
              stack_at(3, level, s) = node.spm[s];
              stack_at(4, level, s) = node.spp[s];
            }
          }
        }
        ++n;
      }
      work += n;

      // --- doubling bookkeeping ----------------------------------------
      log_sum = logaddexp(log_sum, a_logsum);
      steps += a_steps;
      if (!building) {
        // invalid adjacent tree: divergence or a turning subtree
        term_left = inv_left;
        term_right = inv_right;
        terminated = true;
        continue;
      }
      // `node` holds the completed subtree's statistic (stack slot d)
      const int i_end = i_edge + step * n;
      if (fwd) {
#pragma unroll
        for (int s = 0; s < R; ++s) {
          zpq[s] = wq[s];
          zpp[s] = wp[s];
          zpg[s] = wg[s];
        }
        i_plus = i_end;
      } else {
#pragma unroll
        for (int s = 0; s < R; ++s) {
          zmq[s] = wq[s];
          zmp[s] = wp[s];
          zmg[s] = wg[s];
        }
        i_minus = i_end;
      }
      const float omega_old = omega;
      omega = logaddexp(omega_old, a_omega);
      TauW<R> merged;
      const bool turning = combine_dir_warp<R>(tau, node, fwd, merged);
      if (!turning) tau = merged;
      depth += 1;
      if (turning) {
        term_left = i_minus;
        term_right = i_plus;
        terminated = true;
      }
      // biased progressive combine: accept with probability min(1, e^lp2)
      const float lp2 = a_omega - omega_old;
      const bool accept = (lp2 >= 0.f) | (expo_d > -lp2);
      if (accept) {
#pragma unroll
        for (int s = 0; s < R; ++s) {
          pq[s] = bq[s];
          pg[s] = bg[s];
        }
        prop_ld = best_ld;
        prop_pi = best_pi;
      }
    }

#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (own(s)) {
        qn[base + 32 * s] = pq[s];
        gn[base + 32 * s] = pg[s];
      }
    }
    if (lane == 0) {
      ldn[c] = prop_ld;
      pin[c] = prop_pi;
      depth_o[c] = depth;
      tl_o[c] = term_left;
      tr_o[c] = term_right;
      logsum_o[c] = log_sum;
      steps_o[c] = steps;
      work_o[c] = work;
    }
  }
}

template <bool DIAG, int LEAF, int R>
__global__ void __launch_bounds__(32 * warp_max_warps(LEAF, R), warp_min_ctas(LEAF, R))
    tree_transition_warp_kernel(
    const float* __restrict__ q0_, const float* __restrict__ p0_,
    const float* __restrict__ g0_, const float* __restrict__ ld0_,
    const float* __restrict__ eps_, const uint32_t* __restrict__ dirs_,
    const float* __restrict__ gum, const float* __restrict__ expo,
    const float* __restrict__ minv, const Model model,
    float* __restrict__ qn, float* __restrict__ gn, float* __restrict__ ldn,
    float* __restrict__ pin, int* __restrict__ depth_o, int* __restrict__ tl_o,
    int* __restrict__ tr_o, float* __restrict__ logsum_o, int* __restrict__ steps_o,
    int* __restrict__ work_o, int* __restrict__ queue, int C, int K, int S, int dcap,
    float min_delta) {
  warp_tree_transitions<DIAG, LEAF, R>(q0_, p0_, g0_, ld0_, eps_, dirs_, gum, expo, minv, model,
                                       qn, gn, ldn, pin, depth_o, tl_o, tr_o, logsum_o,
                                       steps_o, work_o, queue, C, K, S, dcap, min_delta);
}

template <bool DIAG, int R>
__global__ void __launch_bounds__(32 * kXsWarps, 1) tree_transition_kernel_xstaged(
    const float* __restrict__ q0_, const float* __restrict__ p0_,
    const float* __restrict__ g0_, const float* __restrict__ ld0_,
    const float* __restrict__ eps_, const uint32_t* __restrict__ dirs_,
    const float* __restrict__ gum, const float* __restrict__ expo,
    const float* __restrict__ minv, const Model model,
    float* __restrict__ qn, float* __restrict__ gn, float* __restrict__ ldn,
    float* __restrict__ pin, int* __restrict__ depth_o, int* __restrict__ tl_o,
    int* __restrict__ tr_o, float* __restrict__ logsum_o, int* __restrict__ steps_o,
    int* __restrict__ work_o, int* __restrict__ queue, int C, int K, int S, int dcap,
    float min_delta) {
  warp_tree_transitions<DIAG, kLogreg, R>(q0_, p0_, g0_, ld0_, eps_, dirs_, gum, expo, minv,
                                          model, qn, gn, ldn, pin, depth_o, tl_o, tr_o,
                                          logsum_o, steps_o, work_o, queue, C, K, S, dcap,
                                          min_delta);
}

// Warps per CTA of tree_transition_warp_kernel for the leaf, K coordinates
// and max_depth S (0 when it does not take the shape) and its dynamic shared
// memory: the leaf's staged matrices (warp_matrices) and W per-warp regions
// of merge stack and staging vector, W as many as fit in kMaxSmem, at most
// warp_max_warps(leaf, R). Only the Gaussian and funnel leaves have a warp
// variant.
int warp_plan(int leaf, int K, int S, bool diag, size_t& smem) {
  smem = 0;
  const int R = (K + 31) / 32;
  if ((leaf != kGaussian && leaf != kFunnel) || K < 1 || R > kWarpMaxR || S < 1) return 0;
  const size_t mats = sizeof(float) * warp_matrices(leaf, diag) * (size_t)padded_kk(K);
  const size_t per_warp = sizeof(float) * (size_t)(kNumStats * S + 1) * 32 * R;
  if (mats >= kMaxSmem) return 0;
  size_t w = (kMaxSmem - mats) / per_warp;
  if (w > (size_t)warp_max_warps(leaf, R)) w = warp_max_warps(leaf, R);
  if (w >= 1) smem = mats + w * per_warp;
  return (int)w;
}

using WarpKernel = decltype(&tree_transition_warp_kernel<true, kGaussian, 1>);

template <int LEAF>
WarpKernel warp_kernel_of(bool diag, int R) {
  switch (R) {
    case 1:
      return diag ? &tree_transition_warp_kernel<true, LEAF, 1>
                  : &tree_transition_warp_kernel<false, LEAF, 1>;
    case 2:
      return diag ? &tree_transition_warp_kernel<true, LEAF, 2>
                  : &tree_transition_warp_kernel<false, LEAF, 2>;
    case 3:
      return diag ? &tree_transition_warp_kernel<true, LEAF, 3>
                  : &tree_transition_warp_kernel<false, LEAF, 3>;
    case 4:
      return diag ? &tree_transition_warp_kernel<true, LEAF, 4>
                  : &tree_transition_warp_kernel<false, LEAF, 4>;
    default: return nullptr;
  }
}

WarpKernel warp_kernel(int leaf, bool diag, int R) {
  if (leaf == kGaussian) return warp_kernel_of<kGaussian>(diag, R);
  if (leaf == kFunnel) return warp_kernel_of<kFunnel>(diag, R);
  return nullptr;
}

// Warps per CTA of tree_transition_kernel_xstaged for K coordinates,
// max_depth S, n_obs rows and the metric (0 where the launch takes the CTA
// variant), and its dynamic shared memory: the dense M^-1 (padded_kk), W
// per-warp regions of merge stack and staging vector, X's rows at
// xs_stride and y rounded up to 4 floats, W as many as fit in kMaxSmem, at
// most kXsWarps and at least kXsMinWarps.
int xstaged_plan(int K, int S, int n_obs, bool diag, size_t& smem) {
  smem = 0;
  const int R = (K + 31) / 32;
  if (K < 1 || R > kWarpMaxR || S < 1 || n_obs < 1) return 0;
  const size_t fixed =
      sizeof(float) * ((size_t)n_obs * xs_stride(K, xs_lanes(R)) + (((size_t)n_obs + 3) & ~3) +
                       (diag ? 0 : (size_t)padded_kk(K)));
  const size_t per_warp = sizeof(float) * (size_t)(kNumStats * S + 1) * 32 * R;
  if (fixed >= kMaxSmem) return 0;
  size_t w = (kMaxSmem - fixed) / per_warp;
  if (w > (size_t)kXsWarps) w = kXsWarps;
  if (w < (size_t)kXsMinWarps) return 0;
  smem = fixed + w * per_warp;
  return (int)w;
}

WarpKernel xstaged_kernel(bool diag, int R) {
  switch (R) {
    case 1:
      return diag ? &tree_transition_kernel_xstaged<true, 1>
                  : &tree_transition_kernel_xstaged<false, 1>;
    case 2:
      return diag ? &tree_transition_kernel_xstaged<true, 2>
                  : &tree_transition_kernel_xstaged<false, 2>;
    case 3:
      return diag ? &tree_transition_kernel_xstaged<true, 3>
                  : &tree_transition_kernel_xstaged<false, 3>;
    case 4:
      return diag ? &tree_transition_kernel_xstaged<true, 4>
                  : &tree_transition_kernel_xstaged<false, 4>;
    default: return nullptr;
  }
}

// The warp kernel of (leaf, K, S, diag) with its warps per CTA and its CTAs
// per SM; nullptr where the plan takes no warp. For the logreg leaf (n_obs
// rows) that is tree_transition_kernel_xstaged under xstaged_plan. The
// kernel may take all of kMaxSmem: the attribute belongs to the function,
// which every (K, S) of one R shares, so it is not set to one plan's bytes.
// The carveout asks for the most shared memory, so that the occupancy query
// and the launch see the same SM.
WarpKernel prepared_warp_kernel(int leaf, int K, int S, bool diag, int n_obs, int& warps,
                                size_t& smem, int& per_sm, cudaError_t& err) {
  per_sm = 0;
  err = cudaSuccess;
  const bool xs = leaf == kLogreg;
  warps = xs ? xstaged_plan(K, S, n_obs, diag, smem) : warp_plan(leaf, K, S, diag, smem);
  if (warps < 1) return nullptr;
  WarpKernel kernel =
      xs ? xstaged_kernel(diag, (K + 31) / 32) : warp_kernel(leaf, diag, (K + 31) / 32);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  return kernel;
}

// A warp-kernel launch of (device, leaf, K, S, diag, n_obs; n_obs 0 but for
// the logreg leaf): the kernel (nullptr where the plan takes no warp), its
// plan, CTAs per SM and the device's SMs.
struct WarpLaunch {
  int dev, leaf, K, S;
  bool diag;
  int n_obs;
  WarpKernel kernel;
  int warps, per_sm, sms;
  size_t smem;
};

// The WarpLaunch of (current device, leaf, K, S, diag, n_obs), prepared on
// its first launch and kept: the function attributes, the occupancy query
// and the SM count are host calls that every launch would otherwise repeat.
cudaError_t warp_launch_for(int leaf, int K, int S, bool diag, int n_obs, WarpLaunch& out) {
  static std::mutex mutex;
  static std::vector<WarpLaunch> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  for (const WarpLaunch& w : cache) {
    if (w.dev == dev && w.leaf == leaf && w.K == K && w.S == S && w.diag == diag &&
        w.n_obs == n_obs) {
      out = w;
      return cudaSuccess;
    }
  }
  WarpLaunch w{dev, leaf, K, S, diag, n_obs, nullptr, 0, 0, 0, 0};
  w.kernel = prepared_warp_kernel(leaf, K, S, diag, n_obs, w.warps, w.smem, w.per_sm, err);
  if (err == cudaSuccess && w.kernel != nullptr)
    err = cudaDeviceGetAttribute(&w.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  cache.push_back(w);
  out = w;
  return cudaSuccess;
}

// Shared-memory bytes per CTA for max_depth S, K coordinates and, for the
// logreg leaf, tile residuals and, with the ring, kStages stages of tile
// rows of X and y (tile = 0 otherwise).
size_t smem_bytes(int K, int S, int tile, bool ring) {
  const int Kp = (K + 31) / 32 * 32;
  const int KX = (K + 3) & ~3;
  return sizeof(float) * ((size_t)(kNumStats * S + 1) * Kp + kRedSlots * 32 +
                          (size_t)tile * (ring ? kStages * (KX + 1) + 1 : 1));
}

// The logreg leaf's tiles: kTileRows rows through the ring, or fewer where
// the merge stack leaves less room. Where not even one row per stage fits,
// kTileRows rows (or as many residuals as fit) read from X in place, so
// the leaf fits wherever the merge stack leaves room for one float. Returns
// false when not even that fits.
bool logreg_tiles(int K, int S, int& tile, bool& ring) {
  const size_t base = smem_bytes(K, S, 0, false);
  const size_t per_row = smem_bytes(K, S, 1, true) - base;
  const size_t free = base < kMaxSmem ? kMaxSmem - base : 0;
  ring = free >= per_row;
  const size_t rows = free / (ring ? per_row : sizeof(float));
  tile = rows < (size_t)kTileRows ? (int)rows : kTileRows;
  return tile >= 1;
}

using CtaKernel = decltype(&tree_transition_kernel<true, kGaussian>);

// tree_transition_kernel<DIAG, LEAF> for K coordinates, or its wide form
// past the threads a CTA of it may have, allowed smem bytes of dynamic
// shared memory.
template <bool DIAG, int LEAF>
CtaKernel cta_kernel_of(int K, size_t smem, cudaError_t& err) {
  CtaKernel kernel = tree_transition_kernel<DIAG, LEAF>;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return nullptr;
  if ((K + 31) / 32 * 32 > attr.maxThreadsPerBlock)
    kernel = tree_transition_kernel_wide<DIAG, LEAF>;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return err == cudaSuccess ? kernel : nullptr;
}

// The CTA kernel of (leaf, diag) for K coordinates (the logreg leaf with
// its tiles through the ring, or read in place), and its dynamic shared
// memory for max_depth S and the logreg leaf's tile rows; nullptr where no
// CTA fits, err saying why.
CtaKernel cta_kernel(int leaf, bool diag, int K, int S, int tile, bool ring, size_t& smem,
                     cudaError_t& err) {
  smem = smem_bytes(K, S, tile, leaf == kLogreg && ring);
  err = cudaErrorInvalidValue;
  if (smem > kMaxSmem) return nullptr;
  switch (leaf) {
    case kGaussian:
      return diag ? cta_kernel_of<true, kGaussian>(K, smem, err)
                  : cta_kernel_of<false, kGaussian>(K, smem, err);
    case kFunnel:
      return diag ? cta_kernel_of<true, kFunnel>(K, smem, err)
                  : cta_kernel_of<false, kFunnel>(K, smem, err);
    case kLogreg:
      if (!ring)
        return diag ? cta_kernel_of<true, kLogregInPlace>(K, smem, err)
                    : cta_kernel_of<false, kLogregInPlace>(K, smem, err);
      return diag ? cta_kernel_of<true, kLogreg>(K, smem, err)
                  : cta_kernel_of<false, kLogreg>(K, smem, err);
    default:
      return nullptr;
  }
}

// What tree_warp_plan and tree_xstaged_plan report of prepared_warp_kernel.
int reported_plan(int leaf, int K, int max_depth, bool diag, int n_obs, int* warps, int* smem,
                  int* regs, int* ctas_per_sm) {
  size_t bytes = 0;
  int per_sm = 0;
  cudaError_t err;
  WarpKernel kernel =
      prepared_warp_kernel(leaf, K, max_depth, diag, n_obs, *warps, bytes, per_sm, err);
  *smem = (int)bytes;
  *regs = 0;
  *ctas_per_sm = per_sm;
  if (kernel == nullptr || err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  *regs = attr.numRegs;
  return (int)err;
}

}  // namespace

extern "C" {

// The warp kernel's plan for (leaf, K, max_depth, diag): warps per CTA (0
// where the launch takes the CTA kernel), dynamic shared memory per CTA
// (bytes), registers per thread and CTAs per SM (0 and 0 without warps).
// Returns a CUDA error code (0 on success).
int tree_warp_plan(int leaf, int K, int max_depth, int diag, int* warps, int* smem, int* regs,
                   int* ctas_per_sm) {
  return reported_plan(leaf, K, max_depth, diag != 0, 0, warps, smem, regs, ctas_per_sm);
}

// The same for the logreg leaf's staged-X kernel with n_obs rows.
int tree_xstaged_plan(int K, int max_depth, int n_obs, int diag, int* warps, int* smem,
                      int* regs, int* ctas_per_sm) {
  return reported_plan(kLogreg, K, max_depth, diag != 0, n_obs, warps, smem, regs,
                       ctas_per_sm);
}

// The CTA kernel's plan for (leaf, K, max_depth, diag): threads per CTA,
// dynamic shared memory per CTA (bytes), registers per thread and CTAs per
// SM. Returns a CUDA error code (0 on success; cudaErrorInvalidValue where
// no CTA fits).
int tree_cta_plan(int leaf, int K, int max_depth, int diag, int* threads, int* smem, int* regs,
                  int* ctas_per_sm) {
  int tile = 0;
  bool ring = false;
  *threads = (K + 31) / 32 * 32;
  *smem = *regs = *ctas_per_sm = 0;
  if (leaf == kLogreg && !logreg_tiles(K, max_depth, tile, ring))
    return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  cudaError_t err;
  CtaKernel kernel = cta_kernel(leaf, diag != 0, K, max_depth, tile, ring, bytes, err);
  *smem = (int)bytes;
  if (kernel == nullptr) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, *threads, bytes);
}

// Launches one transition for C chains on `stream`. `leaf` selects the
// model (0 Gaussian, 1 funnel, 2 logreg; see the header for m0..m2, n_obs,
// s0, s1). The Gaussian and funnel leaves take tree_transition_warp_kernel
// wherever warp_plan gives them a warp, the logreg leaf
// tree_transition_kernel_xstaged wherever xstaged_plan does, with `queue`
// two zeroed int32s the caller keeps for the stream (the kernel leaves them
// zeroed again); every other launch takes the CTA kernel, with queue null.
// Returns the cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for a CTA that does not fit, a queue given or
// missing against the plan, or a logreg leaf with no observation or an X
// that is not 16-byte aligned.
int tree_transition_f32(const float* q0, const float* p0, const float* g0, const float* ld0,
                        const float* eps, const uint32_t* dirs, const float* gum,
                        const float* expo, const float* minv, int diag, int leaf,
                        const float* m0, const float* m1, const float* m2, int n_obs, float s0,
                        float s1, float* qn, float* gn, float* ldn, float* pin, int* depth,
                        int* term_left, int* term_right, float* log_sum, int* steps, int* work,
                        int* queue, int C, int K, int max_depth, int dcap, float min_delta,
                        void* stream) {
  int tile = 0;
  bool ring = false;
  if (leaf == kLogreg && (!logreg_tiles(K, max_depth, tile, ring) || n_obs < 1 ||
                          (reinterpret_cast<uintptr_t>(m0) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const Model model{m0, m1, m2, n_obs, tile, s0, s1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WarpLaunch w{};
  if (leaf == kGaussian || leaf == kFunnel || leaf == kLogreg) {
    const cudaError_t err =
        warp_launch_for(leaf, K, max_depth, diag != 0, leaf == kLogreg ? n_obs : 0, w);
    if (err != cudaSuccess) return (int)err;
  }
  if ((w.kernel != nullptr) != (queue != nullptr)) return (int)cudaErrorInvalidValue;
  if (w.kernel != nullptr) {
    // persistent CTAs: as many as the card holds at once, no more than the
    // chains need
    const long long need = ((long long)C + w.warps - 1) / w.warps;
    const long long fit = (long long)w.sms * w.per_sm;
    w.kernel<<<(int)(need < fit ? need : fit), 32 * w.warps, w.smem, s>>>(
        q0, p0, g0, ld0, eps, dirs, gum, expo, minv, model, qn, gn, ldn, pin, depth, term_left,
        term_right, log_sum, steps, work, queue, C, K, max_depth, dcap, min_delta);
    return (int)cudaGetLastError();
  }
  size_t smem = 0;
  cudaError_t err;
  CtaKernel kernel = cta_kernel(leaf, diag != 0, K, max_depth, tile, ring, smem, err);
  if (kernel == nullptr) return (int)err;
  kernel<<<C, (K + 31) / 32 * 32, smem, s>>>(
      q0, p0, g0, ld0, eps, dirs, gum, expo, minv, model, qn, gn, ldn, pin, depth, term_left,
      term_right, log_sum, steps, work, C, K, max_depth, dcap, min_delta);
  return (int)cudaGetLastError();
}

}  // extern "C"
