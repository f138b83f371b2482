// pow in double as PyTorch's CUDA kernels compute it, for K4
// (radau5_step.cuh), which is built without FMA contraction.
//
// libdevice's pow is compiled into the code that calls it, with that code's
// contraction setting. PyTorch builds its kernels with nvcc's default
// -fmad=true; built with -fmad=false the same pow returns another last bit
// for about 1 in 10^5 f64 inputs with an integral exponent and 1 in 10^7
// with 0.25 (H100, 2^25 inputs), so K4 would leave its plain twin on rare
// lanes. This file alone is compiled with -fmad=true (ops/_build.py) and
// as relocatable device code, and K4 calls it. In float the two builds
// agree on every input tried, so K4 keeps powf inline.

__device__ double janus_pow_fmad(double x, double y) { return pow(x, y); }
