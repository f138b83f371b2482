// The operations of a generated right-hand side functor
// (ops/rhs_codegen.py) that are more than one C++ operator, each as
// PyTorch's CUDA kernel computes it, and the entry that evaluates a functor
// and its Jacobian columns for the card tests.
//
// A generated functor is the per-lane program of f's aten graph. The single
// IEEE operations (+, -, *, /, sqrt, comparisons, selects) are written
// inline; the library functions and PyTorch's compound formulas are the
// -fmad=true functions of libm_fmad.cu and pow_fmad.cu; the NaN rules of
// maximum, minimum, clamp and sign are PyTorch's (MaxMinElementwiseKernel,
// UnarySignKernels, TensorCompare.cu).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "dual.cuh"

__device__ double janus_exp_fmad(double x);
__device__ float janus_exp_fmad(float x);
__device__ double janus_log_fmad(double x);
__device__ float janus_log_fmad(float x);
__device__ double janus_sin_fmad(double x);
__device__ float janus_sin_fmad(float x);
__device__ double janus_cos_fmad(double x);
__device__ float janus_cos_fmad(float x);
__device__ double janus_tanh_fmad(double x);
__device__ float janus_tanh_fmad(float x);
__device__ double janus_rsqrt_fmad(double x);
__device__ float janus_rsqrt_fmad(float x);
__device__ double janus_pow_fmad(double x, double y);
__device__ float janus_pow_fmad(float x, float y);
__device__ double janus_tanh_backward_fmad(double a, double b);
__device__ float janus_tanh_backward_fmad(float a, float b);
__device__ double janus_add_alpha_fmad(double a, double b, double alpha);
__device__ float janus_add_alpha_fmad(float a, float b, float alpha);

namespace {

// torch.maximum / torch.minimum: a NaN operand is the result
template <typename T>
__device__ __forceinline__ T janus_maximum(T a, T b) {
  return a != a ? a : (b != b ? b : ::max(a, b));
}
template <typename T>
__device__ __forceinline__ T janus_minimum(T a, T b) {
  return a != a ? a : (b != b ? b : ::min(a, b));
}

// torch.clamp with number bounds (either may be absent): NaN stays NaN
template <typename T>
__device__ __forceinline__ T janus_clamp(T v, bool has_lo, T lo, bool has_hi,
                                         T hi) {
  if (v != v) return v;
  if (has_lo) v = ::max(v, lo);
  if (has_hi) v = ::min(v, hi);
  return v;
}

// torch.sign / torch.sgn of a real number: (0 < a) - (a < 0)
template <typename T>
__device__ __forceinline__ T janus_sign(T a) {
  return T((T(0) < a) - (a < T(0)));
}

constexpr int kEvalThreads = 128;

// f and its D Jacobian columns at every lane: y [D, M], params [NP, M],
// f_out [D, M], jac [D*D, M] (entry (i, j) = df_i/dy_j at row i*D + j).
template <typename T, typename P>
__global__ void __launch_bounds__(kEvalThreads)
rhs_eval_kernel(const T* __restrict__ t, const T* __restrict__ y,
                const T* __restrict__ params, T* __restrict__ f_out,
                T* __restrict__ jac, int64_t m) {
  constexpr int D = P::D;
  const int64_t lane = (int64_t)blockIdx.x * kEvalThreads + threadIdx.x;
  if (lane >= m) return;
  T yv[D], fv[D], p[P::NP > 0 ? P::NP : 1];
#pragma unroll
  for (int i = 0; i < D; ++i) yv[i] = y[(int64_t)i * m + lane];
#pragma unroll
  for (int j = 0; j < P::NP; ++j) p[j] = params[(int64_t)j * m + lane];
  const T tv = t[lane];
  P::template f<T, T>(tv, yv, p, fv);
#pragma unroll
  for (int i = 0; i < D; ++i) f_out[(int64_t)i * m + lane] = fv[i];
#pragma unroll 1
  for (int jc = 0; jc < D; ++jc) {
    Dual<T> yd[D], col[D];
#pragma unroll
    for (int i = 0; i < D; ++i) yd[i] = Dual<T>(yv[i], i == jc ? T(1) : T(0));
    P::template f<T, Dual<T>>(tv, yd, p, col);
#pragma unroll
    for (int i = 0; i < D; ++i) jac[(int64_t)(i * D + jc) * m + lane] = col[i].d;
  }
}

template <typename T, typename P>
cudaError_t rhs_eval(const void* t, const void* y, const void* params,
                     void* f_out, void* jac, int64_t m, cudaStream_t s) {
  rhs_eval_kernel<T, P><<<(int)((m + kEvalThreads - 1) / kEvalThreads),
                          kEvalThreads, 0, s>>>(
      static_cast<const T*>(t), static_cast<const T*>(y),
      static_cast<const T*>(params), static_cast<T*>(f_out),
      static_cast<T*>(jac), m);
  return cudaGetLastError();
}

}  // namespace
