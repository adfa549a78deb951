// Batched lower Cholesky factor of SPD matrices, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pymc_tpu/ops/linalg.py::_pallas_chol (bodies
// _chol_kernel and _chol_inplace), which factors a (C, n, n) stack with the
// batch in the TPU's 128 lanes, n identity-padded to 16-row panels. None of
// that layout is carried over: here one thread block factors one matrix.
//
// Bound on this card at the GP path's shape (C = 64, n = 150, float32): A's
// lower triangle is read once and the dense L written once,
// C * (n (n + 1) / 2 + n^2) * 4 B = 8.66 MB, or 2.58 us at 3.35 TB/s; the
// arithmetic is C * n^3 / 3 = 72 MFLOP, 1.07 us at 67 TFLOP/s float32. What
// keeps a kernel far from that is latency: the factorisation is a chain of n
// dependent pivots, and an unblocked loop pays two block-wide barriers for
// each (300 at n = 150) while most warps idle on a shrinking triangle.
//
// Design: blocked right-looking factorisation over 32 x 32 tiles (panel
// width nb = 32). The matrix is padded to T = ceil(n / 32) tile rows with
// the identity, which leaves the factor of the real part unchanged, and only
// its lower T (T + 1) / 2 tiles are stored: tile (ti, tj), tj <= ti, at index
// ti (ti + 1) / 2 + tj, each row-major with the column XOR-swizzled by the
// row, so that a warp reading one column of a tile, or one row, touches 32
// distinct shared-memory banks. Tile (0, 0) is factored first, as in step 3;
// then for k = 0 .. T-1:
//   1. all threads solve the panel below the diagonal tile (k, k),
//      L_ik = A_ik L_kk^-T, one row per thread (the rows are independent),
//      the row in registers, the rows of L_kk in 128-bit loads;
//   2. the trailing lower triangle of tiles gets A_ij -= L_ik L_jk^T, a
//      register-tiled product: each thread keeps a 4 x 4 block of outputs in
//      registers over the 32-deep sum and reads both operands from the tiles
//      in 128-bit loads (8 loads for 64 FMA, conflict-free through the
//      swizzle); micro-tiles above the diagonal of a diagonal tile are
//      skipped. Tile column k + 1 is updated first (look-ahead); then
//   3. one warp factors the diagonal tile (k + 1, k + 1) in registers, lane i
//      holding row i, the 32 pivots inside the warp (rsqrt; each pivot sent
//      by one shuffle as soon as it is known, each scaled column broadcast
//      through shared memory in 128-bit loads),
//      while the other seven warps update the rest of the triangle and write
//      the finished tile column k of L to device memory.
// A __syncthreads() closes each phase: 3 T barriers (15 at n = 150). The
// update is float32 FFMA (float64 DFMA) on the CUDA cores: TF32 tensor cores
// would keep 3 decimal digits and buy nothing at this size.
//
// Where the lower tiles fit a block's 227 KB (T (T + 1) / 2 * 1024 * sizeof
// elements: n <= 320 in float32, n <= 224 in float64) they live in dynamic
// shared memory, loaded with cp.async (element j <= i of A only, the rest is
// padding written directly): tile column 0 first, then the rest by seven
// warps while the eighth factors tile (0, 0), arriving while the first
// panel is solved. Beyond that the same code runs on the tiles in a device-memory
// workspace that the caller allocates (C * T (T + 1) / 2 * 1024 elements,
// L2-resident at these sizes); that path is right, not fast.
//
// At C = 64 one block per matrix fills 64 of the 132 SMs; at n = 150 a block
// takes 60 KB of shared memory, so at large C several matrices share an SM
// (as many as registers allow; see PERF.md).
//
// Matrices that are not positive definite are not checked, as on the TPU:
// the rsqrt of a negative pivot is NaN, which spreads through the rest of that
// matrix's factor only. The caller (the MvNormal log-density) turns a
// non-finite or non-positive diagonal into -inf. The kernel never traps, uses
// no atomics, and gives the same bits for the same input.
//
// ptxas (sm_90a, CUDA 12.8): float32 in shared memory 128 registers (the
// cap of two blocks an SM) with 180 B spilled, 256 B static shared memory
// besides the tiles (60 KB at n = 150); float32 on the workspace 255
// registers, 260 B spilled; float64 255 registers, none spilled in shared
// memory and 100 B on the workspace, 512 B static shared memory.
//
// C interface (bound with ctypes): pointers and the stream are void*.
// pt_cholesky_workspace(C, n, elem_bytes) gives the elements of device
// workspace a call needs (0 where the tiles fit in shared memory). Each
// launch function returns the cudaError_t of the shared-memory attribute call
// if that failed, cudaErrorInvalidValue if a needed workspace is missing,
// else cudaGetLastError() after the launch. Shapes: A and L are contiguous
// (C, n, n); n >= 1, 1 <= C < 2^31 (the wrapper checks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNb = 32;               // panel width and tile edge
constexpr int kTile = kNb * kNb;      // elements of one tile
constexpr int kMicro = 4;             // a thread's output block in the update
constexpr int kMicros = kNb / kMicro; // micro-tiles along a tile edge
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;
// dynamic shared memory one block may ask for on Hopper (227 KB), less 1 KB
// for the kernel's static shared memory
constexpr int64_t kMaxSmem = 232448 - 1024;

__host__ __device__ constexpr int64_t stored_tiles(int64_t n) {
  return ((n + kNb - 1) / kNb) * ((n + kNb - 1) / kNb + 1) / 2;
}

// element (r, c) of a tile
__device__ __forceinline__ int sw(int r, int c) { return r * kNb + (c ^ r); }

__device__ __forceinline__ float dev_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double dev_rsqrt(double x) { return rsqrt(x); }

// four consecutive elements, 16-byte aligned, in one or two vector accesses
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double v[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

template <typename T>
__device__ __forceinline__ void copy_async(T* smem_dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src),
               "n"(sizeof(T))
               : "memory");
#else
  *smem_dst = *src;
#endif
}

__device__ __forceinline__ void copy_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int kPending>
__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
#endif
}

template <typename T>
struct Tiles {
  T* base;
  __device__ __forceinline__ T* at(int ti, int tj) const {
    return base + ((int64_t)ti * (ti + 1) / 2 + tj) * kTile;
  }
};

// Tile (ti, tj) of the padded matrix: A's elements j <= i < n, the identity
// on the padding, 0 above the diagonal.
template <typename T, bool kShared>
__device__ __forceinline__ void load_tile(const T* __restrict__ A, int n, T* dst, int ti, int tj,
                                          int first, int stride) {
  for (int e = first; e < kTile; e += stride) {
    const int r = e / kNb, c = e % kNb;
    const int gi = ti * kNb + r, gj = tj * kNb + c;
    T* d = dst + sw(r, c);
    if (gi < n && gj <= gi) {
      if (kShared) {
        copy_async(d, A + (int64_t)gi * n + gj);
      } else {
        *d = A[(int64_t)gi * n + gj];
      }
    } else {
      *d = gi == gj ? T(1) : T(0);
    }
  }
}

// One warp: lane i holds row i of the diagonal tile. Each pivot comes from
// its lane by a shuffle; the scaled column goes through `col` in shared
// memory, from which every lane reads the entries it needs in 128-bit
// broadcast loads (8 at most, not 31 shuffles). Elements above the diagonal
// are left as they are; lane j writes 1 / l_jj to rdiag[j] for the panel.
template <typename T>
__device__ __forceinline__ void factor_diagonal(T* D, T* col, T* rdiag, int lane) {
  T a[kNb];
  T rd = T(0);
#pragma unroll
  for (int c = 0; c < kNb; ++c) a[c] = D[sw(lane, c)];
  T piv = __shfl_sync(0xffffffffu, a[0], 0);
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    const T inv = dev_rsqrt(piv);
    if (lane == j) {
      a[j] = piv * inv;
      rd = inv;
    } else if (lane > j) {
      a[j] *= inv;
    }
    if (j + 1 < kNb) {
      // the next pivot first: lane j + 1 needs only its own l_{j+1,j}, so
      // the broadcast below stays off the chain of pivots
      const T next = __shfl_sync(0xffffffffu, a[j + 1] - a[j] * a[j], j + 1);
      col[lane] = a[j];  // l_ij for the lanes i > j
      __syncwarp();
#pragma unroll
      for (int g = (j + 1) / kMicro; g < kNb / kMicro; ++g) {
        T c4[kMicro];
        load4(col + g * kMicro, c4);
#pragma unroll
        for (int e = 0; e < kMicro; ++e) {
          const int k = g * kMicro + e;
          if (k > j && lane >= k) a[k] -= a[j] * c4[e];
        }
      }
      __syncwarp();
      piv = next;
    }
  }
#pragma unroll
  for (int c = 0; c < kNb; ++c) D[sw(lane, c)] = a[c];
  rdiag[lane] = rd;
}

// Row r of a panel tile: x L_kk^T = a by forward substitution. Row j of L_kk
// holds columns 4 g .. 4 g + 3 at j * 32 + 4 (g ^ (j / 4)) + (e ^ (j % 4)):
// one 128-bit broadcast load each, with j fixed at compile time; the dot
// product runs in four partial sums.
template <typename T>
__device__ __forceinline__ void solve_panel_row(const T* D, const T* rdiag, T* P, int r) {
  T x[kNb];
#pragma unroll
  for (int c = 0; c < kNb; ++c) x[c] = P[sw(r, c)];
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    T acc[kMicro] = {};
#pragma unroll
    for (int g = 0; g * kMicro < j; ++g) {
      T d4[kMicro];
      load4(D + j * kNb + (g ^ (j / kMicro)) * kMicro, d4);
#pragma unroll
      for (int e = 0; e < kMicro; ++e) {
        const int q = g * kMicro + e;
        if (q < j) acc[e] += x[q] * d4[e ^ (j % kMicro)];
      }
    }
    x[j] = (x[j] - ((acc[0] + acc[1]) + (acc[2] + acc[3]))) * rdiag[j];
  }
#pragma unroll
  for (int c = 0; c < kNb; ++c) P[sw(r, c)] = x[c];
}

// Micro-tile (mr, mc) of A_ij -= L_ik L_jk^T. Row r = 4 mr + a of a tile
// holds columns 4 g .. 4 g + 3 at r * 32 + 4 (g ^ mr) + (e ^ a), e = 0..3:
// one vector load, the order within it fixed by a.
template <typename T>
__device__ __forceinline__ void update_micro(const T* Li, const T* Lj, T* Aij, int mr, int mc) {
  T acc[kMicro][kMicro] = {};
  const T* li = Li + mr * kMicro * kNb;
  const T* lj = Lj + mc * kMicro * kNb;
#pragma unroll 2
  for (int g = 0; g < kNb / kMicro; ++g) {
    T x[kMicro][kMicro], y[kMicro][kMicro];
#pragma unroll
    for (int a = 0; a < kMicro; ++a) load4(li + a * kNb + (g ^ mr) * kMicro, x[a]);
#pragma unroll
    for (int b = 0; b < kMicro; ++b) load4(lj + b * kNb + (g ^ mc) * kMicro, y[b]);
#pragma unroll
    for (int e = 0; e < kMicro; ++e)
#pragma unroll
      for (int a = 0; a < kMicro; ++a)
#pragma unroll
        for (int b = 0; b < kMicro; ++b) acc[a][b] += x[a][e ^ a] * y[b][e ^ b];
  }
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    T* row = Aij + (mr * kMicro + a) * kNb + (mc ^ mr) * kMicro;
    T v[kMicro];
    load4(row, v);
#pragma unroll
    for (int b = 0; b < kMicro; ++b) v[b ^ a] -= acc[a][b];
    store4(row, v);
  }
}

// The trailing update of step k, m tile rows below the diagonal tile: tile
// column k + 1 alone (all threads), the look-ahead that the next diagonal
// tile waits for.
template <typename T>
__device__ __forceinline__ void update_next_column(const Tiles<T>& t, int k, int m) {
  for (int u = threadIdx.x; u < m * kMicros * kMicros; u += kThreads) {
    const int a = u / (kMicros * kMicros);
    const int mr = u / kMicros % kMicros, mc = u % kMicros;
    if (a == 0 && mc > mr) continue;
    update_micro(t.at(k + 1 + a, k), t.at(k + 1, k), t.at(k + 1 + a, k + 1), mr, mc);
  }
}

// The rest of step k's trailing update, tile columns k + 2 .. T - 1, by
// `stride` threads numbered from `first`.
template <typename T>
__device__ __forceinline__ void update_rest(const Tiles<T>& t, int k, int m, int first,
                                            int stride) {
  const int mm = m - 1;
  const int units = mm * (mm + 1) / 2 * kMicros * kMicros;
  for (int u = first; u < units; u += stride) {
    const int s = u / (kMicros * kMicros);
    const int mr = u / kMicros % kMicros, mc = u % kMicros;
    int a = 0;
    while ((a + 1) * (a + 2) / 2 <= s) ++a;
    const int b = s - a * (a + 1) / 2;
    if (a == b && mc > mr) continue;
    update_micro(t.at(k + 2 + a, k), t.at(k + 2 + b, k), t.at(k + 2 + a, k + 2 + b), mr, mc);
  }
}

// Columns tc * 32 .. tc * 32 + 31 of L, zeros above the diagonal: warp w of
// nw takes rows w, w + nw, ..., its lanes on consecutive columns.
template <typename T>
__device__ __forceinline__ void write_column(const Tiles<T>& t, T* __restrict__ L, int n, int tc,
                                             int w, int nw) {
  const int lane = threadIdx.x & 31;
  const int j = tc * kNb + lane;
  if (j >= n) return;
  for (int i = w; i < n; i += nw)
    L[(int64_t)i * n + j] = j <= i ? t.at(i / kNb, tc)[sw(i % kNb, lane)] : T(0);
}

// Blocks an SM should hold: two float32 matrices up to n = 224 fit in its
// shared memory (60 KB each at n = 150), if a thread keeps to 128 registers.
// In float64 shared memory allows one at n > 128 (n = 150: 120 KB).
template <typename T, bool kShared>
constexpr int min_blocks() {
  return kShared && sizeof(T) == 4 ? 2 : 1;
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, kShared>()))
    cholesky_kernel(const T* __restrict__ A, T* __restrict__ L, T* work, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T rdiag[kNb];                // 1 / l_jj of the current diagonal tile
  __shared__ __align__(16) T col[kNb];     // the column being eliminated in it
  const int nt = (n + kNb - 1) / kNb;
  const int64_t base = (int64_t)blockIdx.x * n * n;
  const Tiles<T> t{kShared ? reinterpret_cast<T*>(smem_raw)
                           : work + (int64_t)blockIdx.x * stored_tiles(n) * kTile};
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* Ab = A + base;
  T* Lb = L + base;

  // tile column 0 first; then one warp factors tile (0, 0) while the others
  // bring in the rest
  for (int ti = 0; ti < nt; ++ti) load_tile<T, kShared>(Ab, n, t.at(ti, 0), ti, 0, tid, kThreads);
  copy_async_commit();
  copy_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    factor_diagonal(t.at(0, 0), col, rdiag, lane);
  } else {
    for (int ti = 1; ti < nt; ++ti)
      for (int tj = 1; tj <= ti; ++tj)
        load_tile<T, kShared>(Ab, n, t.at(ti, tj), ti, tj, tid - 32, kThreads - 32);
    copy_async_commit();
  }
  __syncthreads();

  for (int k = 0;; ++k) {
    const int m = nt - k - 1;  // tile rows below the diagonal tile (k, k)
    for (int rr = tid; rr < m * kNb; rr += kThreads)
      solve_panel_row(t.at(k, k), rdiag, t.at(k + 1 + rr / kNb, k), rr % kNb);
    if (k == 0) copy_async_wait<0>();  // the rest of A, for the update
    __syncthreads();
    if (m == 0) break;
    update_next_column(t, k, m);
    __syncthreads();
    // one warp factors the next diagonal tile while the others update the
    // rest and write the finished tile column k out
    if (warp == 0) {
      factor_diagonal(t.at(k + 1, k + 1), col, rdiag, lane);
    } else {
      write_column(t, Lb, n, k, warp - 1, kWarps - 1);
      update_rest(t, k, m, tid - 32, kThreads - 32);
    }
    __syncthreads();
  }
  write_column(t, Lb, n, nt - 1, warp, kWarps);
}

template <typename T>
int launch_cholesky(const void* A, void* L, void* work, int64_t C, int64_t n, void* stream) {
  const int64_t smem = stored_tiles(n) * kTile * (int64_t)sizeof(T);
  if (smem <= kMaxSmem) {
    // above 48 KB a block's dynamic shared memory must be asked for first
    static int64_t configured = kDefaultSmem;
    if (smem > configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          cholesky_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      configured = smem;
    }
    cholesky_kernel<T, true><<<(unsigned)C, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
        (const T*)A, (T*)L, nullptr, (int)n);
  } else {
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    cholesky_kernel<T, false><<<(unsigned)C, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)A, (T*)L, (T*)work, (int)n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int64_t pt_cholesky_workspace(int64_t C, int64_t n, int64_t elem_bytes) {
  const int64_t elems = stored_tiles(n) * kTile;
  return elems * elem_bytes <= kMaxSmem ? 0 : C * elems;
}

int pt_cholesky_f32(const void* A, void* L, void* work, int64_t C, int64_t n, void* stream) {
  return launch_cholesky<float>(A, L, work, C, n, stream);
}

int pt_cholesky_f64(const void* A, void* L, void* work, int64_t C, int64_t n, void* stream) {
  return launch_cholesky<double>(A, L, work, C, n, stream);
}

}  // extern "C"
