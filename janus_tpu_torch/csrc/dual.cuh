// Forward-mode dual numbers for the fused Radau5 step kernel (K4).
//
// Dual<T> carries a value v and one tangent d. Evaluating a problem functor
// on Dual<T> with a one-hot tangent on y gives one Jacobian column, as
// jax.jvp of the inlined f does in the reference kernel
// (janus_tpu/solve/radau_fused.py:185-199). Scalars of type T (t and the
// problem's parameters) carry no tangent. The product rule sums
// a.d*b.v + a.v*b.d, in the order of JAX's mul JVP.

#pragma once

template <typename T>
struct Dual {
  T v;
  T d;
  __host__ __device__ Dual() : v(T(0)), d(T(0)) {}
  __host__ __device__ Dual(T value, T tangent) : v(value), d(tangent) {}
};

template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
  return Dual<T>(-a.v, -a.d);
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v + b.v, a.d + b.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) {
  return Dual<T>(a.v + b, a.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, Dual<T> b) {
  return Dual<T>(a + b.v, b.d);
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v - b.v, a.d - b.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, T b) {
  return Dual<T>(a.v - b, a.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) {
  return Dual<T>(a - b.v, -b.d);
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v * b.v, a.d * b.v + a.v * b.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) {
  return Dual<T>(a.v * b, a.d * b);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) {
  return Dual<T>(a * b.v, a * b.d);
}

template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  // (a/b)' = a'/b - a*b'/b^2, as JAX's div JVP
  return Dual<T>(a.v / b.v, a.d / b.v - a.v / b.v * (b.d / b.v));
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T b) {
  return Dual<T>(a.v / b, a.d / b);
}
