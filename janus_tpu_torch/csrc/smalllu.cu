// Batched pivot-free small-matrix LU factor (K1), substitution (K2) and the
// fused factor-and-solve (K3) in the SoA layout, for sm_90a.
//
// Replaces the TPU kernels janus_tpu/ops/smalllu_pallas.py:lu_factor_t (K1),
// :lu_solve_t (K2) and :linsolve_fused (K3). Layout as there: matrix entry (i, j) of lane m lives
// at a_t[(i*D + j)*M + m], a right-hand side row i at b_t[i*M + m], so
// neighbouring threads read neighbouring addresses (coalesced).
//
// Shape of the work: one thread per lane. D is a template parameter
// (1..16), so the loops unroll and the matrix lives in registers; a grid-
// stride loop covers any M and masks the ragged end. K1 and K3 above
// ops/smalllu.py:MAX_UNROLLED_D (the split-complex blocks of Radau at
// D >= 9) are csrc/smalllu_tile.cu's: a tile of lanes whole in shared
// memory, a lane's rows spread over threads. K2 above 16 takes D at run
// time here (lu_solve_t_rt_kernel): one lane a thread, in place on the
// solution in device memory, whose accesses coalesce across the lanes of a
// warp as the loads above do; every operation reads and writes through the
// L1/L2 caches.
//
// What bounds it on this card: each lane is independent and does O(D^3/3)
// flops on D^2 values, so at the slice's D <= 4 the kernels are memory
// bound: K1 moves 2*D^2 values per lane (read A, write L\U), K2 moves
// D^2 + 2*D (read L\U and b, write x), K3 D^2 + 2*D (read A and b, write
// x; the factors never leave registers) -- in f64 8*(2*D^2) and
// 8*(D^2 + 2*D) bytes. The design answers that by touching each value exactly once, with
// coalesced loads and stores, and keeping every intermediate in registers.
// Above D ~ 8 in f64 the register file spills to local memory.
//
// Arithmetic: that of janus_tpu/linalg/smalllu.py in its pivot-free mode,
// which is what the reference runs off the TPU -- K1 divides by the pivot
// with a zero pivot guarded to 1, K2 divides by the diagonal with zero
// guarded to 1. K3 keeps the reference fused kernel's own arithmetic: the
// multiplier is a[i][k] * (1/a[k][k]) with no zero guard, b is eliminated
// in the same loop, and back substitution divides by the diagonal. Built
// with -fmad=false (ops/_build.py:NVCC_FLAGS): no a - m*b is contracted to
// an FMA, so each kernel does its twin's IEEE operations and agrees with it
// to the bit on the card.
//
// C interface (ctypes): every entry returns cudaGetLastError() after its
// launch; dtype 0 = float, 1 = double.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
lu_factor_t_kernel(const T* __restrict__ a, T* __restrict__ lu, int64_t m) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       lane < m; lane += stride) {
    T r[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) r[i][j] = a[(i * D + j) * m + lane];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const T piv = r[k][k];
      const T safe = piv == T(0) ? T(1) : piv;
#pragma unroll
      for (int i = k + 1; i < D; ++i) {
        const T mult = r[i][k] / safe;
        r[i][k] = mult;
#pragma unroll
        for (int j = k + 1; j < D; ++j) r[i][j] = r[i][j] - mult * r[k][j];
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) lu[(i * D + j) * m + lane] = r[i][j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
lu_solve_t_kernel(const T* __restrict__ lu, const T* __restrict__ b,
                  T* __restrict__ x, int64_t m) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       lane < m; lane += stride) {
    T v[D];
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = b[i * m + lane];
    // forward substitution with the unit-lower factor
#pragma unroll
    for (int i = 1; i < D; ++i)
#pragma unroll
      for (int j = 0; j < i; ++j) v[i] = v[i] - lu[(i * D + j) * m + lane] * v[j];
    // back substitution
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
#pragma unroll
      for (int j = i + 1; j < D; ++j) v[i] = v[i] - lu[(i * D + j) * m + lane] * v[j];
      const T diag = lu[(i * D + i) * m + lane];
      v[i] = v[i] / (diag == T(0) ? T(1) : diag);
    }
#pragma unroll
    for (int i = 0; i < D; ++i) x[i * m + lane] = v[i];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
linsolve_fused_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ x, int64_t m) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       lane < m; lane += stride) {
    T r[D][D];
    T v[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      v[i] = b[i * m + lane];
#pragma unroll
      for (int j = 0; j < D; ++j) r[i][j] = a[(i * D + j) * m + lane];
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const T inv = T(1) / r[k][k];
#pragma unroll
      for (int i = k + 1; i < D; ++i) {
        const T mult = r[i][k] * inv;
#pragma unroll
        for (int j = k + 1; j < D; ++j) r[i][j] = r[i][j] - mult * r[k][j];
        v[i] = v[i] - mult * v[k];
      }
    }
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
#pragma unroll
      for (int j = i + 1; j < D; ++j) v[i] = v[i] - r[i][j] * v[j];
      v[i] = v[i] / r[i][i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) x[i * m + lane] = v[i];
  }
}

// ---- K2 above 16, D at run time ----------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_solve_t_rt_kernel(const T* __restrict__ lu, const T* __restrict__ b,
                     T* __restrict__ x, int d, int64_t m) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       lane < m; lane += stride) {
#define LU(i, j) lu[((int64_t)(i) * d + (j)) * m + lane]
#define V(i) x[(int64_t)(i) * m + lane]
    for (int i = 0; i < d; ++i) V(i) = b[(int64_t)i * m + lane];
    for (int i = 1; i < d; ++i)
      for (int j = 0; j < i; ++j) V(i) = V(i) - LU(i, j) * V(j);
    for (int i = d - 1; i >= 0; --i) {
      for (int j = i + 1; j < d; ++j) V(i) = V(i) - LU(i, j) * V(j);
      const T diag = LU(i, i);
      V(i) = V(i) / (diag == T(0) ? T(1) : diag);
    }
#undef LU
#undef V
  }
}

int grid_for(int64_t m) {
  // enough resident blocks to fill 132 SMs several times over; the grid-
  // stride loop takes the rest
  const int64_t need = (m + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;
  return (int)(need < cap ? need : cap);
}

template <typename T, int D>
void launch_factor(const void* a, void* lu, int64_t m, cudaStream_t s) {
  lu_factor_t_kernel<T, D><<<grid_for(m), kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<T*>(lu), m);
}

template <typename T, int D>
void launch_solve(const void* lu, const void* b, void* x, int64_t m,
                  cudaStream_t s) {
  lu_solve_t_kernel<T, D><<<grid_for(m), kThreads, 0, s>>>(
      static_cast<const T*>(lu), static_cast<const T*>(b),
      static_cast<T*>(x), m);
}

template <typename T, int D>
void launch_fused(const void* a, const void* b, void* x, int64_t m,
                  cudaStream_t s) {
  linsolve_fused_kernel<T, D><<<grid_for(m), kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(x), m);
}

template <typename T>
bool dispatch_factor(int d, const void* a, void* lu, int64_t m,
                     cudaStream_t s) {
  switch (d) {
#define JANUS_CASE(D) case D: launch_factor<T, D>(a, lu, m, s); return true;
    JANUS_CASE(1) JANUS_CASE(2) JANUS_CASE(3) JANUS_CASE(4)
    JANUS_CASE(5) JANUS_CASE(6) JANUS_CASE(7) JANUS_CASE(8)
    JANUS_CASE(9) JANUS_CASE(10) JANUS_CASE(11) JANUS_CASE(12)
    JANUS_CASE(13) JANUS_CASE(14) JANUS_CASE(15) JANUS_CASE(16)
#undef JANUS_CASE
    default:
      return false;   // above 16: csrc/smalllu_tile.cu
  }
}

template <typename T>
bool dispatch_solve(int d, const void* lu, const void* b, void* x, int64_t m,
                    cudaStream_t s) {
  switch (d) {
#define JANUS_CASE(D) case D: launch_solve<T, D>(lu, b, x, m, s); return true;
    JANUS_CASE(1) JANUS_CASE(2) JANUS_CASE(3) JANUS_CASE(4)
    JANUS_CASE(5) JANUS_CASE(6) JANUS_CASE(7) JANUS_CASE(8)
    JANUS_CASE(9) JANUS_CASE(10) JANUS_CASE(11) JANUS_CASE(12)
    JANUS_CASE(13) JANUS_CASE(14) JANUS_CASE(15) JANUS_CASE(16)
#undef JANUS_CASE
    default:
      if (d < 1) return false;
      lu_solve_t_rt_kernel<T><<<grid_for(m), kThreads, 0, s>>>(
          static_cast<const T*>(lu), static_cast<const T*>(b),
          static_cast<T*>(x), d, m);
      return true;
  }
}

template <typename T>
bool dispatch_fused(int d, const void* a, const void* b, void* x, int64_t m,
                    cudaStream_t s) {
  switch (d) {
#define JANUS_CASE(D) case D: launch_fused<T, D>(a, b, x, m, s); return true;
    JANUS_CASE(1) JANUS_CASE(2) JANUS_CASE(3) JANUS_CASE(4)
    JANUS_CASE(5) JANUS_CASE(6) JANUS_CASE(7) JANUS_CASE(8)
    JANUS_CASE(9) JANUS_CASE(10) JANUS_CASE(11) JANUS_CASE(12)
    JANUS_CASE(13) JANUS_CASE(14) JANUS_CASE(15) JANUS_CASE(16)
#undef JANUS_CASE
    default:
      return false;   // above 16: csrc/smalllu_tile.cu
  }
}

}  // namespace

extern "C" {

// K1: lu_t[D*D, M] = packed pivot-free L\U of a_t[D*D, M], D = 1..16.
int janus_lu_factor_t(const void* a_t, void* lu_t, int d, int64_t m,
                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dtype == 1 ? dispatch_factor<double>(d, a_t, lu_t, m, s)
                             : dispatch_factor<float>(d, a_t, lu_t, m, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K2: x_t[D, M] = (L\U)^-1 b_t with K1's packed factors lu_t[D*D, M].
int janus_lu_solve_t(const void* lu_t, const void* b_t, void* x_t, int d,
                     int64_t m, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dtype == 1 ? dispatch_solve<double>(d, lu_t, b_t, x_t, m, s)
                             : dispatch_solve<float>(d, lu_t, b_t, x_t, m, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K3: x_t[D, M] = A^-1 b_t for a_t[D*D, M], factor and solve in one pass,
// D = 1..16.
int janus_linsolve_fused(const void* a_t, const void* b_t, void* x_t, int d,
                         int64_t m, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dtype == 1 ? dispatch_fused<double>(d, a_t, b_t, x_t, m, s)
                             : dispatch_fused<float>(d, a_t, b_t, x_t, m, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
