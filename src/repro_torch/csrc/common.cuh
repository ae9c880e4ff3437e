// Shared helpers of the port's CUDA kernels.  Each kernel source compiles
// on its own into a shared library with a plain C interface (loaded with
// ctypes by repro_torch/kernels/_build.py), so this header is included by
// exactly one translation unit per library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

// Message of a cudaError_t returned by one of the launch functions.
REPRO_API const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floor modulus (the sign of the result follows m, as jnp's and torch's
// `%`); CUDA's `%` truncates, which differs on negative x.
__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}
