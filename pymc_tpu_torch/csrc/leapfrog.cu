// Leapfrog kernels of batched NUTS with a diagonal mass, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pymc_tpu/ops/pallas_kernels.py:
//   leapfrog_kick_drift  (body _kick_drift_kernel)  -> kick_drift_kernel
//   leapfrog_final_kick  (body _final_kick_kernel)  -> final_kick_kernel
// and, inside a NUTS subtree, the final kick together with the per-leaf
// tree bookkeeping of pymc_tpu/sampling/nuts.py::_build_subtree_b (`body`)
// and the next leaf's kick-drift                   -> nuts_leaf_row_kernel
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
// The NUTS leaf: one leaf of a NUTS subtree for every chain row, after
// logp+grad at the leaf's point q'. In eager PyTorch that leaf took the pair
// and about 150 small launches of bookkeeping; here it is one launch.
//   What bounds it: bytes, and at the sampler's shapes the launch and the
//   latency of its dependent memory round trips. A row that steps reads
//   p_half, grad', q' and inv_mass, p_sum where it adds to it or
//   checkpoints it, and two checkpoint rows per U-turn slot at odd n; it
//   writes q, p, grad, the proposal where it takes it, p_sum, two
//   checkpoint rows at even n and the next q_half, p_half. A row that does
//   not step touches no row of D values. At (C, D) = (64, 175) float32 that
//   is under 1 us of the card's 3.35 TB/s, so the time is the launch plus
//   the round trips that wait on one another.
//   Design: every decision of a leaf is per chain row and the only work
//   across threads is row sums, so a row is one block.
//   nuts_leaf_row_kernel<T, E, W>: a row is W = 2, 4 or 8 warps (the
//   launcher picks W from C, D and the card's SM count: kFewRows,
//   kManyRows), each thread holding E <= kRowMaxE of its values in registers
//   from the first read to the last write. nuts_leaf_long_row_kernel<T, W>
//   runs the same leaf on rows longer than 32 * W * kRowMaxE and streams the
//   rest (the tail code only there: in the row kernel it took registers
//   and time at every D).
//     1. One round trip for the row's 13 scalars. A row that does not step
//        then writes its next `act` and leaves: `act` never comes back
//        within a subtree, so its q_half and p_half (dead) keep their last
//        values and it reads and writes nothing else.
//     2. One round trip for everything else the row reads, issued together:
//        p_half, grad', inv_mass, q_half and p_sum, and on odd leaves the
//        first kLeafPrefetch U-turn slots' p_ckpt and psum_ckpt values,
//        which follow from n alone.
//     A: p', the kinetic energy and those slots' U-turn dots (p_sum after
//        the leaf is p_sum + p' wherever a turn is checked), reduced
//        together: one butterfly of __shfl_xor in each warp, whose two
//        partners add the same two values, then the warps' sums in order
//        after one barrier, so every thread holds the same bits and takes
//        the same decisions (energy error, divergence, logaddexp as torch
//        computes it, the multinomial take against the injected uniform u,
//        the checkpoint slot popcount(n), the U-turn). On even leaves the
//        kinetic energy alone.
//     B: the masked writes of the state, proposal, p_sum and checkpoint,
//        and the next leaf's half kick and drift, all from registers.
//     C: the U-turn slots past kLeafPrefetch (a leaf n with more trailing
//        ones: 5 or more in float32 where E = 2, 1 odd leaf in 16), read in
//        passes.
//     Thread 0 writes the row's scalars, the next `act`, and adds the row to
//     the count of active chains with an integer atomicAdd.
//   No float atomics, every sum in a fixed order, so a row's result does
//   not change from run to run; each value is read and written by one
//   thread, so the in-place updates need no barrier. Row 0 zeroes the other
//   of the two counters, which the next launch adds to.
//   Measured on the H100 (PERF.md section 6, the NUTS leaf's redesign;
//   scripts/probe_torch_leaf.py): one warp a row was slower than the best of
//   2, 4 and 8 at every D from 32 to 256, its single warp issuing every
//   memory instruction of the row; U-turn slots copied to shared memory
//   with cp.async, or read after the decisions, arrived later than slots
//   read with the row; the row's vectors read with its scalars, before
//   `act` is known, were no faster on mid-subtree states and slower where
//   all rows but one had stopped.
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

constexpr double kMaxEnergyError = 1000.0;
// The most values of each of a row's vectors that a thread of the leaf
// kernel keeps in registers
constexpr int kRowMaxE = 8;
// The longest row the leaf kernel takes: its in-row indices are 32-bit
constexpr int64_t kMaxRow = int64_t(1) << 30;
// U-turn slots whose values a thread reads with the row, 32 bytes of p_ckpt
// and of psum_ckpt a thread in registers (float32 at E = 2: 4 slots, 15 odd
// leaves in 16); later slots are read in phase C
template <typename T, int E>
constexpr int kLeafPrefetch = 32 / (E * (int)sizeof(T)) > 1 ? 32 / (E * (int)sizeof(T)) : 1;

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

// A row's scalars, all read in one round trip.
template <typename T>
struct LeafRow {
  T e, h0, lp_new, log_size, max_eerr, sum_accept, u;
  bool act, turning, diverging, active0;
  int32_t n_target, n;
};

template <typename T>
__device__ __forceinline__ LeafRow<T> load_row(const LeafBuffers& b, const T* logp_new,
                                                const T* u, int64_t c) {
  LeafRow<T> r;
  r.e = ((const T*)b.eps)[c];
  r.h0 = ((const T*)b.h0)[c];
  r.lp_new = logp_new[c];
  r.log_size = ((const T*)b.log_size)[c];
  r.max_eerr = ((const T*)b.max_eerr)[c];
  r.sum_accept = ((const T*)b.sum_accept)[c];
  r.u = u[c];
  r.act = b.act[c];
  r.turning = b.turning[c];
  r.diverging = b.diverging[c];
  r.active0 = b.active0[c];
  r.n_target = b.n_target[c];
  r.n = b.n[c];
  return r;
}

// A row's decisions at this leaf, from its kinetic energy.
template <typename T>
struct LeafDecision {
  T energy, eerr_safe, log_size_new, accept_prob;
  bool div, take, write_ckpt, add_psum, check_turn;
  int pc;
};

template <typename T>
__device__ __forceinline__ LeafDecision<T> decide(const LeafRow<T>& r, T ke, int64_t S) {
  LeafDecision<T> d;
  d.energy = -r.lp_new + ke;
  const T eerr = d.energy - r.h0;
  const bool eerr_ok = finite_(eerr);
  d.div = !eerr_ok || eerr > T(kMaxEnergyError);
  d.eerr_safe = eerr_ok ? eerr : T(INFINITY);
  const T log_w = -d.eerr_safe;
  d.log_size_new = logaddexp_(r.log_size, log_w);
  d.accept_prob = exp_(log_w < T(0) ? log_w : T(0));
  d.take = !d.div && (log_(r.u) < log_w - d.log_size_new);
  const bool is_even = (r.n & 1) == 0;
  d.pc = __popc((unsigned)r.n);
  d.write_ckpt = is_even && d.pc < S;
  d.add_psum = !d.div;
  d.check_turn = !is_even && !d.div;
  return d;
}

// The number of U-turn slots of a leaf at n, from *lo on: the subtrees that
// end at an odd leaf start at slots [popcount(n) - t_ones, popcount(n) - 1],
// t_ones the trailing ones of n, clipped to [0, S - 1]; on even n, none.
__device__ __forceinline__ int turn_slots(int32_t n, int64_t S, int* lo) {
  if ((n & 1) == 0) return 0;
  const int pc = __popc((unsigned)n);
  const int t_ones = __popc((unsigned)n ^ ((unsigned)n + 1u)) - 1;
  *lo = pc - t_ones > 0 ? pc - t_ones : 0;
  const int hi = pc - 1 < S - 1 ? pc - 1 : (int)S - 1;
  return hi >= *lo ? hi - *lo + 1 : 0;
}

// A row that does not step: its next `act` and its count (the same formula
// as a stepping row, on state this leaf leaves as it is).
template <typename T>
__device__ __forceinline__ void finish_idle_row(const LeafBuffers& b, const LeafRow<T>& r,
                                                int64_t c, int64_t leaf) {
  const bool act_next = r.active0 && r.n < r.n_target && !r.turning && !r.diverging;
  b.act[c] = act_next;
  if (act_next) atomicAdd(&b.count[leaf & 1], 1);
  if (c == 0) b.count[(leaf + 1) & 1] = 0;
}

// A row that stepped: its scalars, the next `act` and its count.
template <typename T>
__device__ __forceinline__ void finish_row(const LeafBuffers& b, const LeafRow<T>& r,
                                           const LeafDecision<T>& d, bool turning_new,
                                           int64_t c, int64_t leaf) {
  const int32_t n_new = r.n + 1;
  b.n[c] = n_new;
  ((T*)b.logp)[c] = r.lp_new;
  ((T*)b.sum_accept)[c] = r.sum_accept + d.accept_prob;
  b.diverging[c] = d.div;
  if (abs_(d.eerr_safe) > abs_(r.max_eerr)) ((T*)b.max_eerr)[c] = d.eerr_safe;
  if (d.take) {
    ((T*)b.prop_logp)[c] = r.lp_new;
    ((T*)b.prop_energy)[c] = d.energy;
  }
  if (d.add_psum) ((T*)b.log_size)[c] = d.log_size_new;
  b.turning[c] = turning_new;
  const bool act_next = r.active0 && n_new < r.n_target && !turning_new && !d.div;
  b.act[c] = act_next;
  if (act_next) atomicAdd(&b.count[leaf & 1], 1);
  if (c == 0) b.count[(leaf + 1) & 1] = 0;
}

// The row's sums of the V values v over its W warps, the same bits in every
// thread: each warp's butterfly of __shfl_xor, whose two partners add the
// same two values, then the warps' sums in their order through shared
// memory `red`, after one barrier. The values reduce together, so their
// shuffles overlap; a value that is 0 in every thread stays 0.
template <typename T, int W, int V>
__device__ __forceinline__ void row_sums(T (&v)[V], T (*red)[W]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[j][threadIdx.x >> 5] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < V; ++j) {
    v[j] = T(0);
#pragma unroll
    for (int k = 0; k < W; ++k) v[j] += red[j][k];
  }
}

// One leaf of one row, a block of W warps, E values a thread in registers:
// the thread's i-th value is d = (i * W + w) * 32 + lane for warp w, so each
// warp reads and writes 128 contiguous bytes at a time, and the guard
// (i * W + w) * 32 < D is the same for the whole warp. With kTail the row is
// longer than the 32 * W * E values the team holds and the rest, its tail,
// is streamed: thread t owns the tail's values d = 32 * W * E + t + j * 32 *
// W, reads them in phase A, reads them again and writes them in phase B,
// and reads what it wrote in phase C. The warps' sums meet in shared memory.
template <typename T, int E, int W, bool kTail>
__device__ __forceinline__ void leaf_row(const LeafBuffers& b, const T* __restrict__ logp_new,
                                         const T* __restrict__ grad_new,
                                         const T* __restrict__ u, int64_t leaf) {
  constexpr int P = kLeafPrefetch<T, E>;
  __shared__ T red[1 + 2 * P][W];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t c = blockIdx.x;
  const bool leader = threadIdx.x == 0;
  const int64_t S = b.S;
  const int D = (int)b.D;  // the launcher takes rows of at most kMaxRow values
  const int64_t base = c * b.D;

  // the row's buffers; the thread's values d(i) = (i * W + w) * 32 + lane
  const T* __restrict__ im_r = (const T*)b.inv_mass + base;
  const T* __restrict__ gn_r = grad_new + base;
  T* __restrict__ ph_r = (T*)b.p_half + base;
  T* __restrict__ qh_r = (T*)b.q_half + base;
  T* __restrict__ ps_r = (T*)b.p_sum + base;
  const T* __restrict__ p_ckpt = (const T*)b.p_ckpt;
  const T* __restrict__ psum_ckpt = (const T*)b.psum_ckpt;
  const int lead = w * 32 + lane;
  auto held = [&](int i) {  // the warp-uniform guard, then the lane's
    return (i * W + w) * 32 < D && lead + i * W * 32 < D;
  };
  const int tail0 = 32 * W * E + threadIdx.x;  // the thread's first tail value

  // one round trip for the row's scalars; a row that does not step leaves
  const LeafRow<T> r = load_row<T>(b, logp_new, u, c);
  if (!r.act) {
    if (leader) finish_idle_row<T>(b, r, c, leaf);
    return;
  }

  // one more for everything else the row reads: its vectors and, on odd
  // leaves, the first P U-turn slots' p_ckpt and psum_ckpt values, which
  // follow from n; `load_slots` reads later ones
  T pn[E], gn[E], im[E], qh[E], ps[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int d = lead + i * W * 32;
    pn[i] = gn[i] = im[i] = qh[i] = ps[i] = T(0);
    if (held(i)) {
      pn[i] = ph_r[d];
      gn[i] = gn_r[d];
      im[i] = im_r[d];
      qh[i] = qh_r[d];
      ps[i] = ps_r[d];
    }
  }
  int slot_lo = 0;
  const int n_slots = turn_slots(r.n, S, &slot_lo);
  T ck[P][E], cs[P][E];
  auto slot_row = [&](int k) { return (c * S + slot_lo + k) * D; };
  auto load_slots = [&](int first, int m) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k < m) {
        const int64_t row = slot_row(first + k);
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int d = lead + i * W * 32;
          ck[k][i] = cs[k][i] = T(0);
          if (held(i)) {
            ck[k][i] = p_ckpt[row + d];
            cs[k][i] = psum_ckpt[row + d];
          }
        }
      }
    }
  };
  // the U-turn dots of slots [first, first + m) over the thread's values:
  // p_sum after this leaf is p_sum + p' wherever a turn is checked (on rows
  // that do not diverge); a tail value's p' and p_sum are computed from
  // this leaf's inputs before phase B and read back after it (`written`)
  T* __restrict__ p_r = (T*)b.p + base;
  auto slot_dots = [&](T(&v)[1 + 2 * P], int first, int m, bool written) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      v[1 + k] = v[1 + P + k] = T(0);
      if (k < m) {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          if (held(i)) {
            const T rho = (ps[i] + pn[i]) - cs[k][i];
            v[1 + k] += (im[i] * ck[k][i]) * rho;
            v[1 + P + k] += rho * (im[i] * pn[i]);
          }
        }
        if constexpr (kTail) {
          const int64_t row = slot_row(first + k);
          for (int d = tail0; d < D; d += 32 * W) {
            const T m_d = im_r[d];
            const T x = written ? p_r[d] : ph_r[d] + T(0.5) * r.e * gn_r[d];
            const T s_d = written ? ps_r[d] : ps_r[d] + x;
            const T rho = s_d - psum_ckpt[row + d];
            v[1 + k] += (m_d * p_ckpt[row + d]) * rho;
            v[1 + P + k] += rho * (m_d * x);
          }
        }
      }
    }
  };
  auto turned = [&](const T(&v)[1 + 2 * P], int m) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k < m) any = any || v[1 + k] <= T(0) || v[1 + P + k] <= T(0);
    }
    return any;
  };
  const int n_pf = n_slots < P ? n_slots : P;
  load_slots(0, n_pf);

  // A: p', the kinetic energy and the first P slots' U-turn dots, reduced
  // together
  const T e = r.e;
  T sums[1 + 2 * P];
  sums[0] = T(0);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    pn[i] = pn[i] + T(0.5) * e * gn[i];
    if (held(i)) sums[0] += pn[i] * im[i] * pn[i];
  }
  if constexpr (kTail) {
    for (int d = tail0; d < D; d += 32 * W) {
      const T x = ph_r[d] + T(0.5) * e * gn_r[d];
      sums[0] += x * im_r[d] * x;
    }
  }
  if (n_pf == 0) {  // an even leaf: the kinetic energy alone
    T ke[1] = {sums[0]};
    row_sums<T, W, 1>(ke, red);
    sums[0] = ke[0];
  } else {
    slot_dots(sums, 0, n_pf, false);
    row_sums<T, W, 1 + 2 * P>(sums, red);
  }
  const LeafDecision<T> dec = decide<T>(r, T(0.5) * sums[0], S);
  bool turning_new = r.turning;
  if (dec.check_turn) turning_new = turning_new || turned(sums, n_pf);

  // B: masked writes, then the next leaf's half kick and drift
  T* __restrict__ q_r = (T*)b.q + base;
  T* __restrict__ g_r = (T*)b.grad + base;
  T* __restrict__ pq_r = (T*)b.prop_q + base;
  T* __restrict__ pp_r = (T*)b.prop_p + base;
  T* __restrict__ pg_r = (T*)b.prop_grad + base;
  T* __restrict__ ck_r = (T*)b.p_ckpt + (c * S + dec.pc) * D;
  T* __restrict__ cs_r = (T*)b.psum_ckpt + (c * S + dec.pc) * D;
  auto update = [&](int d, T x, T g, T m, T qv, T s) {
    q_r[d] = qv;
    p_r[d] = x;
    g_r[d] = g;
    if (dec.take) {
      pq_r[d] = qv;
      pp_r[d] = x;
      pg_r[d] = g;
    }
    if (dec.write_ckpt) {
      ck_r[d] = x;
      cs_r[d] = s;
    }
    if (dec.add_psum) ps_r[d] = s + x;
    const T ph = x + T(0.5) * e * g;
    ph_r[d] = ph;
    qh_r[d] = qv + e * (m * ph);
  };
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (held(i)) update(lead + i * W * 32, pn[i], gn[i], im[i], qh[i], ps[i]);
  }
  if constexpr (kTail) {
    for (int d = tail0; d < D; d += 32 * W) {
      // p_half still holds this leaf's value: this thread writes it in update
      update(d, ph_r[d] + T(0.5) * e * gn_r[d], gn_r[d], im_r[d], qh_r[d], ps_r[d]);
    }
  }

  // C: the U-turn slots past the first P (a leaf n with more trailing
  // ones), P a pass, read here; in the tail, p' and p_sum as phase B wrote
  // them
  if (dec.check_turn) {
    for (int s0 = P; s0 < n_slots; s0 += P) {
      const int m = n_slots - s0 < P ? n_slots - s0 : P;
      __syncthreads();  // the last sums are read
      load_slots(s0, m);
      sums[0] = T(0);
      slot_dots(sums, s0, m, true);
      row_sums<T, W, 1 + 2 * P>(sums, red);
      turning_new = turning_new || turned(sums, m);
    }
  }
  if (leader) finish_row<T>(b, r, dec, turning_new, c, leaf);
}

// Rows the team holds in registers
template <typename T, int E, int W>
__global__ void __launch_bounds__(32 * W)
    nuts_leaf_row_kernel(const LeafBuffers b, const T* __restrict__ logp_new,
                         const T* __restrict__ grad_new, const T* __restrict__ u,
                         int64_t leaf) {
  leaf_row<T, E, W, false>(b, logp_new, grad_new, u, leaf);
}

// Longer rows: 32 * W * kRowMaxE values in registers and the tail streamed.
// One block an SM lets ptxas give the longer code the registers it needs
// (under the default bound it spilled).
template <typename T, int W>
__global__ void __launch_bounds__(32 * W, 1)
    nuts_leaf_long_row_kernel(const LeafBuffers b, const T* __restrict__ logp_new,
                              const T* __restrict__ grad_new, const T* __restrict__ u,
                              int64_t leaf) {
  leaf_row<T, kRowMaxE, W, true>(b, logp_new, grad_new, u, leaf);
}

template <typename T, int E, int W>
int launch_leaf_rows(const LeafBuffers& b, const T* logp_new, const T* grad_new, const T* u,
                     int64_t leaf, cudaStream_t stream) {
  nuts_leaf_row_kernel<T, E, W><<<(unsigned)b.C, 32 * W, 0, stream>>>(b, logp_new, grad_new,
                                                                       u, leaf);
  return (int)cudaGetLastError();
}

// E: the least power of two with D <= 32 * W * E; a row longer than 32 * W *
// kRowMaxE streams its tail
template <typename T, int W>
int launch_leaf_team(const LeafBuffers& b, const T* lp, const T* g, const T* u, int64_t leaf,
                     cudaStream_t st) {
  const int64_t per_thread = (b.D + 32 * W - 1) / (32 * W);
  if (per_thread <= 1) return launch_leaf_rows<T, 1, W>(b, lp, g, u, leaf, st);
  if (per_thread <= 2) return launch_leaf_rows<T, 2, W>(b, lp, g, u, leaf, st);
  if (per_thread <= 4) return launch_leaf_rows<T, 4, W>(b, lp, g, u, leaf, st);
  if (per_thread <= kRowMaxE) return launch_leaf_rows<T, kRowMaxE, W>(b, lp, g, u, leaf, st);
  nuts_leaf_long_row_kernel<T, W><<<(unsigned)b.C, 32 * W, 0, st>>>(b, lp, g, u, leaf);
  return (int)cudaGetLastError();
}

// The team: warps a chain row. (largest D, warps), the first that holds D,
// from kFewRows where the batch has no more rows than the card has SMs
// (more warps a row then cost no SM a second row) and from kManyRows
// otherwise; the last entry of each takes every longer row. Chosen on the
// H100 by timing each team at C = 64 and 1024, D from 32 to 4097, float32
// and float64 (PERF.md section 6, the NUTS leaf's redesign:
// scripts/probe_torch_leaf.py --sweep). A build with -DPT_LEAF_WARPS=W
// gives every row W warps (the probe's sweep).
struct LeafTeam {
  int64_t max_d;
  int warps;
};
constexpr LeafTeam kFewRows[] = {{64, 2}, {INT64_MAX, 8}};
constexpr LeafTeam kManyRows[] = {{128, 2}, {1024, 4}, {INT64_MAX, 8}};

template <int N>
int team_warps(const LeafTeam (&table)[N], int64_t D) {
  for (const LeafTeam& t : table) {
    if (D <= t.max_d) return t.warps;
  }
  return table[N - 1].warps;
}

// The current device's SM count, read once a device (0 if it cannot be read)
int sm_count() {
  constexpr int kDevices = 64;
  static int sms[kDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kDevices) return 0;
  if (sms[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess) {
      sms[dev] = n;
    }
  }
  return sms[dev];
}

template <typename T>
int launch_nuts_leaf(const void* buffers, const void* logp_new, const void* grad_new,
                     const void* u, int64_t leaf, void* stream) {
  const LeafBuffers& b = *(const LeafBuffers*)buffers;
  const T* lp = (const T*)logp_new;
  const T* g = (const T*)grad_new;
  const T* un = (const T*)u;
  cudaStream_t st = (cudaStream_t)stream;
  if (b.D > kMaxRow) return (int)cudaErrorInvalidValue;
#ifdef PT_LEAF_WARPS
  const int warps = PT_LEAF_WARPS;
#else
  const int warps = b.C <= sm_count() ? team_warps(kFewRows, b.D) : team_warps(kManyRows, b.D);
#endif
  switch (warps) {
    case 2: return launch_leaf_team<T, 2>(b, lp, g, un, leaf, st);
    case 4: return launch_leaf_team<T, 4>(b, lp, g, un, leaf, st);
    default: return launch_leaf_team<T, 8>(b, lp, g, un, leaf, st);
  }
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
