// Shared helpers of the port's kernels.
//
// The plain PyTorch twins (and the JAX reference) propagate NaN through
// maximum/minimum/clip, where fmaxf/fminf would drop it; these helpers keep
// the kernels' float semantics equal to the twins'.
#pragma once

#include <cuda_runtime.h>

namespace coloc {

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

__device__ __forceinline__ float nan_clip(float x, float lo, float hi) {
  return nan_min(nan_max(x, lo), hi);
}

// sign(x) with sign(0) = 0 and sign(NaN) = NaN (jnp.sign / torch.sign)
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// Every launcher selects the tensor's device first: this library carries its
// own CUDA runtime, whose current device is not PyTorch's.
inline cudaError_t set_device(int device) { return cudaSetDevice(device); }

}  // namespace coloc
