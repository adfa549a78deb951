// Leapfrog kernels of batched NUTS with a diagonal mass, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pymc_tpu/ops/pallas_kernels.py:
//   leapfrog_kick_drift  (body _kick_drift_kernel)  -> kick_drift_kernel
//   leapfrog_final_kick  (body _final_kick_kernel)  -> final_kick_kernel
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
// Fusing the two halves with the NUTS tree bookkeeping, so a leaf costs one
// launch instead of several dozen, is the later step.
//
// C interface (bound with ctypes): every pointer and the stream are void*;
// each function launches on the given stream, returns cudaGetLastError().

#include <cuda_runtime.h>
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

}  // extern "C"
