// The elementwise functions of generated right-hand sides
// (ops/rhs_codegen.py, rhs_ops.cuh) as PyTorch's CUDA kernels compute them.
//
// A generated functor mirrors, op for op, what the torch version of f does
// on the card, and K4 is held to that to the bit. PyTorch builds its
// kernels with nvcc's default contraction (-fmad=true); libdevice's
// functions are compiled into their caller with the caller's setting, and
// PyTorch's compound formulas (tanh's derivative, an add with alpha) are
// contracted where nvcc finds a multiply-add. K4 is built with
// -fmad=false, so each such function is written here as PyTorch's kernel
// writes it (ATen/native/cuda: UnaryOpsKernel.cu, UnaryLogKernels.cu,
// UnaryGeometric*.cu, PowKernel.cu, BinaryMiscBackwardOpsKernels.cu,
// BinaryAddSubKernel.cu) and built like them, with -fmad=true and as
// relocatable device code that the generated unit links (ops/_build.py).
// Double's pow is pow_fmad.cu's.

__device__ double janus_exp_fmad(double x) { return ::exp(x); }
__device__ float janus_exp_fmad(float x) { return ::exp(x); }
__device__ double janus_log_fmad(double x) { return ::log(x); }
__device__ float janus_log_fmad(float x) { return ::log(x); }
__device__ double janus_sin_fmad(double x) { return ::sin(x); }
__device__ float janus_sin_fmad(float x) { return ::sin(x); }
__device__ double janus_cos_fmad(double x) { return ::cos(x); }
__device__ float janus_cos_fmad(float x) { return ::cos(x); }
__device__ double janus_tanh_fmad(double x) { return ::tanh(x); }
__device__ float janus_tanh_fmad(float x) { return ::tanh(x); }
__device__ double janus_rsqrt_fmad(double x) { return ::rsqrt(x); }
__device__ float janus_rsqrt_fmad(float x) { return ::rsqrt(x); }
__device__ float janus_pow_fmad(float x, float y) { return ::pow(x, y); }

// tanh_backward(grad, tanh(x)): grad * (1 - y^2), in opmath
__device__ double janus_tanh_backward_fmad(double a, double b) {
  return a * (1. - b * b);
}
__device__ float janus_tanh_backward_fmad(float a, float b) {
  return a * (1.f - b * b);
}

// add(a, b, alpha) for alpha other than 1: a + b * alpha
__device__ double janus_add_alpha_fmad(double a, double b, double alpha) {
  return a + b * alpha;
}
__device__ float janus_add_alpha_fmad(float a, float b, float alpha) {
  return a + b * alpha;
}
