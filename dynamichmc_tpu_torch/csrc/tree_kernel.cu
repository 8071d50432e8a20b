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
//   stable softplus and tanh-form sigmoid of ops/pallas_logreg.py. q is
//   staged in shared memory; threads stride over the observations reading
//   X^T (K x n_obs), neighbouring threads at neighbouring addresses, four
//   observations per thread at a time; the residuals y - sigmoid(l) go to a
//   shared buffer of n_obs floats (16 KB at n_obs = 4000); then thread j sums
//   X[:, j] * resid. The loops stop at n_obs, so no padded observation row
//   exists to be masked. m0 = X (n_obs x K), m1 = X^T, m2 = y, s0 = 1/s^2.
//
// What bounds it on the H100:
// - Gaussian, dense: four K x K matvecs per leaf (M^-1 p_mid, L^T d and
//   prec d in one pass, M^-1 p_new) whose matrices (3 x 40 KB at K = 100)
//   are read from L1/L2 by every chain: about 160 KB per leaf, plus two
//   block reductions per leaf and six per merge. Thread j reads column j of
//   each matrix, so consecutive threads read consecutive addresses: minv is
//   symmetric, and the wrapper passes prec^T and L for that.
// - Funnel: elementwise, one warp per chain at K = 25; bound by the block
//   reductions, the merge stack's shared-memory traffic and the serial
//   leaf loop (up to 127 leaves at max_depth 7).
// - Logreg: 2 n_obs K FMAs per chain per leaf (1.0 M at n_obs 4000, K 128;
//   4.2 GFLOP per fleet leaf at 2048 chains), and each CTA reads X and X^T
//   (4 MB together) from L2 on every leaf: 8 GB per fleet leaf. The kernel
//   is bound by L2 bandwidth and FMA issue. Sharing each tile of X across a
//   block of chains with tensor cores is later work (the fused leaf,
//   logreg_leaf.cu, shares X across chains; this kernel keeps one chain per
//   CTA because its control flow is per chain).
// Tensor cores (wgmma), TMA staging of the matrices into shared memory and
// several chains per CTA are left to later work. Products are plain fp32
// FMAs; no TF32 anywhere.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNumStats = 5;  // p_minus, p_plus, rho, psharp_minus, psharp_plus
constexpr int kRedSlots = 6;  // widest simultaneous block reduction

constexpr int kGaussian = 0;
constexpr int kFunnel = 1;
constexpr int kLogreg = 2;

struct Model {
  const float* m0;
  const float* m1;
  const float* m2;
  int n_obs;
  float s0, s1;
};

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

// Publish x_j into the staging vector, then return sum_i A[i, j] x_i.
__device__ __forceinline__ float stage_matvec(float x, const float* __restrict__ A,
                                              float* xbuf, int K, int j) {
  __syncthreads();  // earlier readers of xbuf are done
  xbuf[j] = x;
  __syncthreads();
  float s = 0.f;
  if (j < K) {
    for (int i = 0; i < K; ++i) s = fmaf(__ldg(A + (size_t)i * K + j), xbuf[i], s);
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

// The logreg leaf's value and gradient at the staged position (xbuf); see
// the header. Returns the raw ld; g is thread j's gradient coordinate.
__device__ __forceinline__ float logreg_value_grad(float q_new, const Model& model,
                                                   const float* xbuf, float* resid, float* red,
                                                   int K, int j, bool own, float& g) {
  const int n_obs = model.n_obs;
  const int Kp = blockDim.x;
  const float* __restrict__ X = model.m0;
  const float* __restrict__ Xt = model.m1;
  const float* __restrict__ y = model.m2;
  float ll = 0.f;
  for (int base = j; base < n_obs; base += 4 * Kp) {
    float l[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < K; ++k) {
      const float qk = xbuf[k];
      const float* row = Xt + (size_t)k * n_obs;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * Kp;
        if (i < n_obs) l[u] = fmaf(__ldg(row + i), qk, l[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * Kp;
      if (i < n_obs) {
        const float yi = __ldg(y + i);
        ll += yi * l[u] - softplus(l[u]);
        resid[i] = yi - sigmoid(l[u]);
      }
    }
  }
  __syncthreads();  // every residual is written
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (own) {
    int i = 0;
    for (; i + 4 <= n_obs; i += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] = fmaf(__ldg(X + (size_t)(i + u) * K + j), resid[i + u], acc[u]);
    }
    for (; i < n_obs; ++i) acc[0] = fmaf(__ldg(X + (size_t)i * K + j), resid[i], acc[0]);
  }
  g = own ? ((acc[0] + acc[1]) + (acc[2] + acc[3])) - model.s0 * q_new : 0.f;
  float r[2] = {ll, q_new * q_new};
  block_sum<2>(r, red);
  return r[0] + (-0.5f * model.s0 * r[1]);
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
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int j = threadIdx.x;
  const int Kp = blockDim.x;
  const bool own = j < K;
  float* stack = smem;                       // [kNumStats][S][Kp]
  float* xbuf = smem + kNumStats * S * Kp;   // [Kp]
  float* red = xbuf + Kp;                    // [kRedSlots * 32]
  float* resid = red + kRedSlots * 32;       // [n_obs], logreg only

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
        float w = 0.f, pd = 0.f;
        if (own) {
          for (int i = 0; i < K; ++i) {
            const float di = xbuf[i];
            w = fmaf(__ldg(model.m1 + (size_t)i * K + j), di, w);
            pd = fmaf(__ldg(model.m0 + (size_t)i * K + j), di, pd);
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
        ld_new = logreg_value_grad(q_new, model, xbuf, resid, red, K, j, own, g_new);
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

// Shared-memory bytes per CTA for max_depth S, K coordinates and a residual
// buffer of n_res floats (the logreg leaf's n_obs, 0 otherwise).
size_t smem_bytes(int K, int S, int n_res) {
  const int Kp = (K + 31) / 32 * 32;
  return sizeof(float) * ((size_t)(kNumStats * S + 1) * Kp + kRedSlots * 32 + n_res);
}

template <bool DIAG, int LEAF>
int launch(const float* q0, const float* p0, const float* g0, const float* ld0,
           const float* eps, const uint32_t* dirs, const float* gum, const float* expo,
           const float* minv, const Model& model, float* qn, float* gn, float* ldn, float* pin,
           int* depth, int* term_left, int* term_right, float* log_sum, int* steps, int* work,
           int C, int K, int max_depth, int dcap, float min_delta, cudaStream_t s) {
  const int Kp = (K + 31) / 32 * 32;
  const size_t smem = smem_bytes(K, max_depth, LEAF == kLogreg ? model.n_obs : 0);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(tree_transition_kernel<DIAG, LEAF>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  tree_transition_kernel<DIAG, LEAF><<<C, Kp, smem, s>>>(
      q0, p0, g0, ld0, eps, dirs, gum, expo, minv, model, qn, gn, ldn, pin, depth,
      term_left, term_right, log_sum, steps, work, C, K, max_depth, dcap, min_delta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one transition for C chains on `stream`. `leaf` selects the
// model (0 Gaussian, 1 funnel, 2 logreg; see the header for m0..m2, n_obs,
// s0, s1). Returns the cudaGetLastError() of the launch (0 on success).
int tree_transition_f32(const float* q0, const float* p0, const float* g0, const float* ld0,
                        const float* eps, const uint32_t* dirs, const float* gum,
                        const float* expo, const float* minv, int diag, int leaf,
                        const float* m0, const float* m1, const float* m2, int n_obs, float s0,
                        float s1, float* qn, float* gn, float* ldn, float* pin, int* depth,
                        int* term_left, int* term_right, float* log_sum, int* steps, int* work,
                        int C, int K, int max_depth, int dcap, float min_delta, void* stream) {
  const Model model{m0, m1, m2, n_obs, s0, s1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TREE_LAUNCH(D, L)                                                                  \
  launch<D, L>(q0, p0, g0, ld0, eps, dirs, gum, expo, minv, model, qn, gn, ldn, pin, depth, \
               term_left, term_right, log_sum, steps, work, C, K, max_depth, dcap,          \
               min_delta, s)
  switch (leaf) {
    case kGaussian:
      return diag ? TREE_LAUNCH(true, kGaussian) : TREE_LAUNCH(false, kGaussian);
    case kFunnel:
      return diag ? TREE_LAUNCH(true, kFunnel) : TREE_LAUNCH(false, kFunnel);
    case kLogreg:
      return diag ? TREE_LAUNCH(true, kLogreg) : TREE_LAUNCH(false, kLogreg);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TREE_LAUNCH
}

}  // extern "C"
