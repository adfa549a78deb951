// Batched lower Cholesky factor of small SPD matrices, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pymc_tpu/ops/linalg.py::_pallas_chol (bodies
// _chol_kernel and _chol_inplace), which factors a (C, n, n) stack with the
// batch in the TPU's 128 lanes, n identity-padded to 16-row panels. None of
// that layout is carried over: here one thread block factors one matrix.
//
// Design: block c copies the lower triangle of A[c] (row-major, n <= 160)
// into dynamic shared memory, neighbouring threads on neighbouring addresses
// (the upper triangle is neither read nor used), and runs the
// right-looking factorisation in place. For k = 0 .. n-1:
//   A. d = sqrt(a_kk) (every thread reads it); the column below the
//      diagonal is scaled by 1/d and also kept in a shared vector `col`;
//   B. the trailing lower triangle gets the rank-1 update
//      a_ij -= l_ik * l_jk, one warp per row i, its lanes on consecutive j
//      (conflict-free shared-memory banks: l_ik is a broadcast, l_jk comes
//      from `col`); thread 0 writes d into a_kk, which nothing in B reads.
// A __syncthreads() closes each phase: 2n barriers per matrix. L is written
// back row-major with exact zeros above the diagonal.
//
// Matrices that are not positive definite are not checked, as on the TPU:
// the sqrt of a negative pivot is NaN, which spreads through that matrix's
// trailing block only. The caller (the MvNormal log-density) turns a
// non-finite or non-positive diagonal into -inf. The kernel never traps.
//
// Bound on this card at the GP path's shape (C = 64, n = 150, float32): A's
// lower triangle is read once and the dense L written once,
// C * (n (n + 1) / 2 + n^2) * 4 B = 8.66 MB, or 2.58 us at 3.35 TB/s; the
// arithmetic is C * n^3 / 3 = 72 MFLOP, 1.07 us at 67 TFLOP/s float32. So it
// is memory-bound at 2.58 us. What this simple design leaves on the table:
// 64 blocks occupy 64 of the 132 SMs; each block
// runs n dependent steps of two barriers each, and the rank-1 update uses
// CUDA cores, not tensor cores, on a shrinking triangle, so late steps leave
// most warps idle. A blocked (left-looking, panel) kernel with several
// matrices per SM, or several SMs per matrix, would close that gap.
//
// C interface (bound with ctypes): pointers and the stream are void*. Each
// function returns the cudaError_t of the shared-memory attribute call if
// that failed, else cudaGetLastError() after the launch. Shapes: A and L are
// contiguous (C, n, n); 1 <= n <= 160 (the wrapper checks), 1 <= C < 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cholesky_kernel(const T* __restrict__ A, T* __restrict__ L, int n) {
  extern __shared__ unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // n * n, row-major
  T* col = s + n * n;                     // n: the scaled column k
  const int nn = n * n;
  const int64_t base = (int64_t)blockIdx.x * nn;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / n;
    if (idx - i * n <= i) s[idx] = A[base + idx];
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const T d = dev_sqrt(s[k * n + k]);
    // A. scale the column below the diagonal
    for (int i = k + 1 + tid; i < n; i += kThreads) {
      const T l = s[i * n + k] / d;
      s[i * n + k] = l;
      col[i] = l;
    }
    __syncthreads();
    // B. rank-1 update of the trailing lower triangle
    if (tid == 0) s[k * n + k] = d;
    for (int i = k + 1 + warp; i < n; i += kWarps) {
      const T li = col[i];
      T* row = s + i * n;
      for (int j = k + 1 + lane; j <= i; j += 32) row[j] -= li * col[j];
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / n;
    const int j = idx - i * n;
    L[base + idx] = j <= i ? s[idx] : T(0);
  }
}

template <typename T>
int launch_cholesky(const void* A, void* L, int64_t C, int64_t n, void* stream) {
  const size_t smem = (size_t)(n * n + n) * sizeof(T);
  // above 48 KB a block's dynamic shared memory must be asked for first
  static size_t configured = kDefaultSmem;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        cholesky_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  cholesky_kernel<T><<<(unsigned)C, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)A, (T*)L, (int)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pt_cholesky_f32(const void* A, void* L, int64_t C, int64_t n, void* stream) {
  return launch_cholesky<float>(A, L, C, n, stream);
}

int pt_cholesky_f64(const void* A, void* L, int64_t C, int64_t n, void* stream) {
  return launch_cholesky<double>(A, L, C, n, stream);
}

}  // extern "C"
