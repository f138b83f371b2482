// K4's entry points for the hand-written problem functors (problems.cuh).
//
// The kernel itself, its design and its arithmetic are in radau5_step.cuh;
// this translation unit instantiates it for the two registered problems of
// janus_tpu_torch/models/problems.py:DEVICE_PROBLEMS and names them for
// ctypes (ops/radau_fused.py). Every other right-hand side runs through a
// functor that ops/rhs_codegen.py generates and builds in a translation unit
// of its own around the same header.
//
// C interface: returns the first CUDA error of the launch sequence (0 when
// none), or cudaErrorInvalidValue for an unknown problem or a D / parameter
// count that does not match the functor; dtype 0 = float, 1 = double.

#include <cstring>

#include "radau5_step.cuh"
#include "problems.cuh"

extern "C" {

// K4: up to max_attempts Radau5 step attempts per lane on the packed state
// [5D+15, M], in place. problem names the device functor: "vdp" or
// "robertson" (models/problems.py:DEVICE_PROBLEMS).
int janus_radau5_step(void* state, const void* tf_row, const void* params,
                      int64_t m, const char* problem, int d, int n_params,
                      int dtype, const JanusRadauConsts* consts,
                      int max_attempts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (std::strcmp(problem, "vdp") == 0)
    return launch<VdP>(state, tf_row, params, m, d, n_params, dtype, *consts,
                       max_attempts, s);
  if (std::strcmp(problem, "robertson") == 0)
    return launch<Robertson>(state, tf_row, params, m, d, n_params, dtype,
                             *consts, max_attempts, s);
  return (int)cudaErrorInvalidValue;
}

// K4's build and residency on the current device for one instantiation
// (out[0..5] as attributes_t in radau5_step.cuh).
int janus_radau5_attributes(const char* problem, int dtype, int* out) {
  if (std::strcmp(problem, "vdp") == 0) return attributes<VdP>(dtype, out);
  if (std::strcmp(problem, "robertson") == 0)
    return attributes<Robertson>(dtype, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
