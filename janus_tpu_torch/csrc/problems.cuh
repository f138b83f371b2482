// Device RHS functors of the fused Radau5 step kernel (K4).
//
// Hopper has no in-kernel jvp, so each problem the kernel runs is written
// here as a functor templated on the scalar type S: S = T evaluates f,
// S = Dual<T> with a one-hot tangent on y gives one Jacobian column. t and
// the parameters p (one value per name, in the order of the problem's
// DeviceProblem entry in janus_tpu_torch/models/problems.py) are plain T.
// Each functor computes what its torch twin in models/problems.py computes,
// operation for operation.

#pragma once

#include "dual.cuh"

// Stiff Van der Pol (models/problems.py:vdp_rhs); p = {mu}.
struct VdP {
  static constexpr int D = 2;
  static constexpr int NP = 1;
  template <typename T, typename S>
  __device__ static void f(T /*t*/, const S (&y)[D], const T* p,
                           S (&out)[D]) {
    const T mu = p[0];
    const S x = y[0];
    const S v = y[1];
    out[0] = v;
    out[1] = mu * (T(1) - x * x) * v - x;
  }
};

// Robertson kinetics (models/problems.py:robertson_rhs); p = {a, b, c}.
struct Robertson {
  static constexpr int D = 3;
  static constexpr int NP = 3;
  template <typename T, typename S>
  __device__ static void f(T /*t*/, const S (&y)[D], const T* p,
                           S (&out)[D]) {
    const T a = p[0], b = p[1], c = p[2];
    const S d1 = -a * y[0] + b * y[1] * y[2];
    const S d3 = c * y[1] * y[1];
    out[0] = d1;
    out[1] = -d1 - d3;
    out[2] = d3;
  }
};
