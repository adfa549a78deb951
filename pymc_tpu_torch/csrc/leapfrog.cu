// Leapfrog kernels of batched NUTS with a diagonal mass, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pymc_tpu/ops/pallas_kernels.py:
//   leapfrog_kick_drift  (body _kick_drift_kernel)  -> kick_drift_kernel
//   leapfrog_final_kick  (body _final_kick_kernel)  -> final_kick_kernel
// and, inside a NUTS subtree, the final kick together with the per-leaf
// tree bookkeeping of pymc_tpu/sampling/nuts.py::_build_subtree_b (`body`)
// and the next leaf's kick-drift                   -> nuts_leaf_kernel
//
// What bounds them on this card: at the sampler's shapes (C = 64 chains,
// D = 175 parameters) kick_drift moves 6 * C * D + C values (about 270 KB in
// float32) and final_kick 4 * C * D + 2 * C, which the card's 3.35 TB/s streams
// in well under a microsecond. Both are bound by the launch (a few
// microseconds each), not by bandwidth or arithmetic.
//
// What the design does about it: one pass each, no scratch in device memory,
// and nothing allocated or synchronised inside the kernel, so each costs one
// launch. The TPU kernels' tiling (8 full rows per block, C % 8 == 0) is not
// carried over: any C >= 1 and D >= 1 run on one path.
//   - kick_drift_kernel: one thread per element with a grid-stride loop; the
//     element's chain row c = i / D selects its signed step eps[c].
//   - final_kick_kernel: one block per chain row loops over D, writes p' and
//     reduces 0.5 * sum_d p' * m^-1 * p' with warp shuffles and then shared
//     memory. No atomics: the summation order is fixed, so the kinetic energy
//     is the same from run to run.
//
// nuts_leaf_kernel: one leaf of a NUTS subtree for every chain row, after
// logp+grad at the leaf's point q'. In eager PyTorch that leaf took the pair
// and about 150 small launches of bookkeeping; here it is one launch.
//   What bounds it: bytes. A row that steps reads p_half, grad', q' and
//   inv_mass, p_sum where it adds to it or checkpoints it, and two
//   checkpoint rows per active slot at odd n; it writes q, p, grad, the
//   proposal where it takes it, p_sum, two checkpoint rows at even n and the
//   next q_half, p_half. A row that does not step reads q, p, grad and
//   inv_mass and writes the next q_half, p_half. At (C, D) = (64, 175)
//   float32 that is some 6 to 20 arrays of C * D * 4 bytes, under 1 us at
//   3.35 TB/s. Like the pair it is bound by its launch.
//   Design: one block per chain row (32 threads where D <= 32, else 128),
//   since every decision of a leaf is per chain and the only work across
//   threads is row sums.
//     Phase A over D: p' = p_half + eps/2 * grad', kept in registers for the
//       first kLeafCache elements a thread (D <= 512 at 128 threads) and
//       computed again from p_half and grad' beyond; ke reduced with
//       shuffles and shared memory.
//     One barrier; then every thread computes the row's scalars from the
//       same partial sums in the same order: energy error, divergence,
//       logaddexp as torch computes it, the multinomial take against the
//       injected uniform u, the checkpoint slot popcount(n) (__popc) and the
//       slot range of the U-turn checks.
//     Phase B over D: the masked state, proposal, p_sum and checkpoint
//       writes, then the next leaf's half kick and drift from the updated
//       (q, p, grad).
//     Phase C, rows at odd n only: the U-turn dots over the active slots
//       [popcount(n) - t_ones, popcount(n) - 1], kLeafSlots slots a pass,
//       accumulated in registers and reduced with one barrier per pass.
//     Thread 0 writes the row's scalars, the next `act`, and adds the row to
//       the count of active chains with an integer atomicAdd (the same from
//       run to run). Block 0 zeroes the other of the two counters, which the
//       next launch adds to.
//   No float atomics: every sum has a fixed order, so a row's result does
//   not change from run to run. Each element is read and written by one
//   thread in every phase, so the in-place updates of q_half and p_half
//   need no barrier.
//
// C interface (bound with ctypes): every pointer and the stream are void*;
// each function launches on the given stream, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKickDriftThreads = 256;
constexpr int kFinalKickThreads = 128;
constexpr int kMaxGrid = 65535;

template <typename T>
__global__ void kick_drift_kernel(const T* __restrict__ q, const T* __restrict__ p,
                                  const T* __restrict__ grad,
                                  const T* __restrict__ inv_mass,
                                  const T* __restrict__ eps, T* __restrict__ q_out,
                                  T* __restrict__ p_half, int64_t n, int64_t D) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const T e = eps[i / D];
    const T ph = p[i] + T(0.5) * e * grad[i];
    p_half[i] = ph;
    q_out[i] = q[i] + e * (inv_mass[i] * ph);
  }
}

template <typename T>
__device__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void final_kick_kernel(const T* __restrict__ p_half, const T* __restrict__ grad,
                                  const T* __restrict__ inv_mass,
                                  const T* __restrict__ eps, T* __restrict__ p_out,
                                  T* __restrict__ ke, int64_t D) {
  __shared__ T partial[kFinalKickThreads / 32];
  const int64_t row = blockIdx.x;
  const int64_t base = row * D;
  const T e = eps[row];
  T acc = T(0);
  for (int64_t d = threadIdx.x; d < D; d += blockDim.x) {
    const T pn = p_half[base + d] + T(0.5) * e * grad[base + d];
    p_out[base + d] = pn;
    acc += pn * inv_mass[base + d] * pn;
  }
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = T(0);
    for (int w = 0; w < kFinalKickThreads / 32; ++w) total += partial[w];
    ke[row] = T(0.5) * total;
  }
}

template <typename T>
int launch_kick_drift(const void* q, const void* p, const void* grad, const void* inv_mass,
                      const void* eps, void* q_out, void* p_half, int64_t C, int64_t D,
                      void* stream) {
  const int64_t n = C * D;
  const int64_t blocks = (n + kKickDriftThreads - 1) / kKickDriftThreads;
  const int grid = (int)(blocks < kMaxGrid ? blocks : kMaxGrid);
  kick_drift_kernel<T><<<grid, kKickDriftThreads, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)p, (const T*)grad, (const T*)inv_mass, (const T*)eps,
      (T*)q_out, (T*)p_half, n, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_final_kick(const void* p_half, const void* grad, const void* inv_mass,
                      const void* eps, void* p_out, void* ke, int64_t C, int64_t D,
                      void* stream) {
  // one block per chain row: gridDim.x allows 2^31 - 1 rows
  final_kick_kernel<T><<<(unsigned)C, kFinalKickThreads, 0, (cudaStream_t)stream>>>(
      (const T*)p_half, (const T*)grad, (const T*)inv_mass, (const T*)eps, (T*)p_out,
      (T*)ke, D);
  return (int)cudaGetLastError();
}

constexpr int kLeafThreads = 128;
constexpr int kLeafWarps = kLeafThreads / 32;
constexpr int kLeafCache = 4;   // p' values a thread keeps in registers
constexpr int kLeafSlots = 8;   // U-turn slots a pass of phase C
constexpr double kMaxEnergyError = 1000.0;

// The buffers of one subtree, fixed while it is built. The ctypes Structure
// `_LeafBuffers` of ops/leapfrog.py has the same fields in the same order.
struct LeafBuffers {
  const void* inv_mass;  // (C, D)
  const void* eps;       // (C,) signed step
  const void* h0;        // (C,) energy at the trajectory's start
  const bool* active0;   // (C,)
  const int32_t* n_target;
  int32_t* n;            // leaves built so far
  void* q;               // (C, D) last leaf
  void* p;
  void* grad;
  void* logp;            // (C,)
  void* prop_q;          // (C, D) multinomial proposal
  void* prop_p;
  void* prop_grad;
  void* prop_logp;       // (C,)
  void* prop_energy;
  void* log_size;
  void* sum_accept;
  void* max_eerr;
  void* p_sum;           // (C, D)
  void* p_ckpt;          // (C, S, D)
  void* psum_ckpt;       // (C, S, D)
  bool* turning;         // (C,)
  bool* diverging;
  bool* act;             // the rows that step at this leaf
  void* q_half;          // (C, D) this leaf's q'; then the next leaf's
  void* p_half;
  int32_t* count;        // (2,) active rows after launch k in count[k & 1]
  int64_t C, D, S;
};

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
template <typename T>
__device__ __forceinline__ bool finite_(T x) { return abs_(x) < T(INFINITY); }  // false for NaN

// torch.logaddexp: equal infinities pass through, else max + log1p(exp(-|a - b|))
template <typename T>
__device__ __forceinline__ T logaddexp_(T a, T b) {
  if (abs_(a) == T(INFINITY) && a == b) return a;
  const T m = a < b ? b : a;
  return m + log1p_(exp_(-abs_(a - b)));
}

// Every thread returns the block's sum of v, added in a fixed order.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red, int nwarps) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = T(0);
  for (int w = 0; w < nwarps; ++w) total += red[w];
  return total;
}

template <typename T>
__global__ void nuts_leaf_kernel(const LeafBuffers b, const T* __restrict__ logp_new,
                                 const T* __restrict__ grad_new, const T* __restrict__ u,
                                 int64_t leaf) {
  __shared__ T red[kLeafWarps];
  __shared__ T red_dots[2 * kLeafSlots][kLeafWarps];
  const int64_t c = blockIdx.x;
  const int64_t D = b.D, S = b.S;
  const int64_t base = c * D;
  const int tid = threadIdx.x, nt = blockDim.x, nwarps = nt >> 5;

  const T* __restrict__ im = (const T*)b.inv_mass;
  T* __restrict__ q = (T*)b.q;
  T* __restrict__ p = (T*)b.p;
  T* __restrict__ grad = (T*)b.grad;
  T* __restrict__ prop_q = (T*)b.prop_q;
  T* __restrict__ prop_p = (T*)b.prop_p;
  T* __restrict__ prop_grad = (T*)b.prop_grad;
  T* __restrict__ p_sum = (T*)b.p_sum;
  T* __restrict__ p_ckpt = (T*)b.p_ckpt;
  T* __restrict__ psum_ckpt = (T*)b.psum_ckpt;
  T* __restrict__ q_half = (T*)b.q_half;
  T* __restrict__ p_half = (T*)b.p_half;

  // the row's scalars, read by every thread before the first barrier (thread
  // 0 writes them back after it)
  const T e = ((const T*)b.eps)[c];
  const T h0 = ((const T*)b.h0)[c];
  const T lp_new = logp_new[c];
  const T log_size = ((const T*)b.log_size)[c];
  const T max_eerr = ((const T*)b.max_eerr)[c];
  const T sum_accept = ((const T*)b.sum_accept)[c];
  const T log_u = log_(u[c]);
  const bool act = b.act[c];
  const bool turning = b.turning[c];
  const bool diverging_old = b.diverging[c];
  const bool active0 = b.active0[c];
  const int32_t n_target = b.n_target[c];
  const int32_t n = b.n[c];

  // Phase A: p' and the kinetic energy, on rows that step (a row that does
  // not step reads neither p_half nor grad')
  T cache[kLeafCache];
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < kLeafCache; ++i) {
    const int64_t d = tid + (int64_t)i * nt;
    cache[i] = T(0);
    if (act && d < D) {
      const T pn = p_half[base + d] + T(0.5) * e * grad_new[base + d];
      cache[i] = pn;
      acc += pn * im[base + d] * pn;
    }
  }
  for (int64_t d = tid + (int64_t)kLeafCache * nt; act && d < D; d += nt) {
    const T pn = p_half[base + d] + T(0.5) * e * grad_new[base + d];
    acc += pn * im[base + d] * pn;
  }
  const T ke = T(0.5) * block_sum(acc, red, nwarps);

  // the row's decisions
  const T energy = -lp_new + ke;
  const T eerr = energy - h0;
  const bool eerr_ok = finite_(eerr);
  const bool div = act && (!eerr_ok || eerr > T(kMaxEnergyError));
  const T eerr_safe = eerr_ok ? eerr : T(INFINITY);
  const T log_w = -eerr_safe;
  const T log_size_new = logaddexp_(log_size, log_w);
  const T accept_prob = exp_(log_w < T(0) ? log_w : T(0));
  const bool take = act && !div && (log_u < log_w - log_size_new);
  const bool is_even = (n & 1) == 0;
  const int pc = __popc((unsigned)n);
  const bool write_ckpt = act && is_even && pc < S;
  const bool add_psum = act && !div;
  const bool check_turn = act && !is_even && !div;
  const int t_ones = __popc((unsigned)n ^ ((unsigned)n + 1u)) - 1;
  const int64_t slot_lo = pc - t_ones > 0 ? pc - t_ones : 0;
  const int64_t slot_hi = pc - 1 < S - 1 ? pc - 1 : S - 1;
  const int64_t ckpt_row = (c * S + pc) * D;

  // Phase B: masked writes, then the next leaf's half kick and drift
  auto update = [&](int64_t d, T pn) {
    const int64_t i = base + d;
    T q_cur, p_cur, g_cur;
    if (act) {
      q_cur = q_half[i];
      p_cur = pn;
      g_cur = grad_new[i];
      q[i] = q_cur;
      p[i] = p_cur;
      grad[i] = g_cur;
      if (take) {
        prop_q[i] = q_cur;
        prop_p[i] = p_cur;
        prop_grad[i] = g_cur;
      }
      if (write_ckpt || add_psum) {
        const T ps = p_sum[i];
        if (write_ckpt) {
          p_ckpt[ckpt_row + d] = pn;
          psum_ckpt[ckpt_row + d] = ps;
        }
        if (add_psum) p_sum[i] = ps + pn;
      }
    } else {
      q_cur = q[i];
      p_cur = p[i];
      g_cur = grad[i];
    }
    const T ph = p_cur + T(0.5) * e * g_cur;
    p_half[i] = ph;
    q_half[i] = q_cur + e * (im[i] * ph);
  };
#pragma unroll
  for (int i = 0; i < kLeafCache; ++i) {
    const int64_t d = tid + (int64_t)i * nt;
    if (d < D) update(d, cache[i]);
  }
  for (int64_t d = tid + (int64_t)kLeafCache * nt; d < D; d += nt) {
    // p_half still holds this leaf's value: this thread writes it just after
    update(d, act ? p_half[base + d] + T(0.5) * e * grad_new[base + d] : T(0));
  }

  // Phase C: U-turn checks of the subtrees that end at this (odd) leaf,
  // against p and p_sum as this thread wrote them in phase B
  bool turning_new = turning;
  if (check_turn) {
    bool any_turn = false;
    for (int64_t s0 = slot_lo; s0 <= slot_hi; s0 += kLeafSlots) {
      const int m = (int)(slot_hi - s0 + 1 < kLeafSlots ? slot_hi - s0 + 1 : kLeafSlots);
      T dot_start[kLeafSlots], dot_leaf[kLeafSlots];
#pragma unroll
      for (int k = 0; k < kLeafSlots; ++k) dot_start[k] = dot_leaf[k] = T(0);
      for (int64_t d = tid; d < D; d += nt) {
        const T imd = im[base + d];
        const T ps = p_sum[base + d];
        const T v_leaf = imd * p[base + d];
#pragma unroll
        for (int k = 0; k < kLeafSlots; ++k) {
          if (k < m) {
            const int64_t off = (c * S + s0 + k) * D + d;
            const T rho = ps - psum_ckpt[off];
            dot_start[k] += (imd * p_ckpt[off]) * rho;
            dot_leaf[k] += rho * v_leaf;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kLeafSlots; ++k) {
        dot_start[k] = warp_sum(dot_start[k]);
        dot_leaf[k] = warp_sum(dot_leaf[k]);
      }
      if (s0 > slot_lo) __syncthreads();  // the last pass's sums are read
      if ((tid & 31) == 0) {
#pragma unroll
        for (int k = 0; k < kLeafSlots; ++k) {
          red_dots[k][tid >> 5] = dot_start[k];
          red_dots[kLeafSlots + k][tid >> 5] = dot_leaf[k];
        }
      }
      __syncthreads();
      for (int k = 0; k < m; ++k) {
        T ds = T(0), dl = T(0);
        for (int w = 0; w < nwarps; ++w) {
          ds += red_dots[k][w];
          dl += red_dots[kLeafSlots + k][w];
        }
        any_turn = any_turn || ds <= T(0) || dl <= T(0);
      }
    }
    turning_new = turning || any_turn;
  }

  if (tid == 0) {
    const int32_t n_new = act ? n + 1 : n;
    const bool div_new = act ? div : diverging_old;
    if (act) {
      b.n[c] = n_new;
      ((T*)b.logp)[c] = lp_new;
      ((T*)b.sum_accept)[c] = sum_accept + accept_prob;
      b.diverging[c] = div;
      if (abs_(eerr_safe) > abs_(max_eerr)) ((T*)b.max_eerr)[c] = eerr_safe;
    }
    if (take) {
      ((T*)b.prop_logp)[c] = lp_new;
      ((T*)b.prop_energy)[c] = energy;
    }
    if (add_psum) ((T*)b.log_size)[c] = log_size_new;
    b.turning[c] = turning_new;
    const bool act_next = active0 && n_new < n_target && !turning_new && !div_new;
    b.act[c] = act_next;
    if (act_next) atomicAdd(&b.count[leaf & 1], 1);
    if (c == 0) b.count[(leaf + 1) & 1] = 0;
  }
}

template <typename T>
int launch_nuts_leaf(const void* buffers, const void* logp_new, const void* grad_new,
                     const void* u, int64_t leaf, void* stream) {
  const LeafBuffers& b = *(const LeafBuffers*)buffers;
  const int threads = b.D <= 32 ? 32 : kLeafThreads;
  nuts_leaf_kernel<T><<<(unsigned)b.C, threads, 0, (cudaStream_t)stream>>>(
      b, (const T*)logp_new, (const T*)grad_new, (const T*)u, leaf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pt_leapfrog_kick_drift_f32(const void* q, const void* p, const void* grad,
                               const void* inv_mass, const void* eps, void* q_out,
                               void* p_half, int64_t C, int64_t D, void* stream) {
  return launch_kick_drift<float>(q, p, grad, inv_mass, eps, q_out, p_half, C, D, stream);
}

int pt_leapfrog_kick_drift_f64(const void* q, const void* p, const void* grad,
                               const void* inv_mass, const void* eps, void* q_out,
                               void* p_half, int64_t C, int64_t D, void* stream) {
  return launch_kick_drift<double>(q, p, grad, inv_mass, eps, q_out, p_half, C, D, stream);
}

int pt_leapfrog_final_kick_f32(const void* p_half, const void* grad, const void* inv_mass,
                               const void* eps, void* p_out, void* ke, int64_t C, int64_t D,
                               void* stream) {
  return launch_final_kick<float>(p_half, grad, inv_mass, eps, p_out, ke, C, D, stream);
}

int pt_leapfrog_final_kick_f64(const void* p_half, const void* grad, const void* inv_mass,
                               const void* eps, void* p_out, void* ke, int64_t C, int64_t D,
                               void* stream) {
  return launch_final_kick<double>(p_half, grad, inv_mass, eps, p_out, ke, C, D, stream);
}

// sizeof(LeafBuffers): the caller's copy of the struct must match it
int64_t pt_nuts_leaf_buffers_size() { return (int64_t)sizeof(LeafBuffers); }

// buffers: a LeafBuffers, filled once per subtree by the caller
int pt_nuts_leaf_f32(const void* buffers, const void* logp_new, const void* grad_new,
                     const void* u, int64_t leaf, void* stream) {
  return launch_nuts_leaf<float>(buffers, logp_new, grad_new, u, leaf, stream);
}

int pt_nuts_leaf_f64(const void* buffers, const void* logp_new, const void* grad_new,
                     const void* u, int64_t leaf, void* stream) {
  return launch_nuts_leaf<double>(buffers, logp_new, grad_new, u, leaf, stream);
}

}  // extern "C"
