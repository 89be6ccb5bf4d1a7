// Per-keypoint window copy: one (64, 256) float32 window of the smoothed
// stacked raster per keypoint.
//
// Replaces coloc_tpu/ops/patches.py::_extract_kernel (Pallas, launched by
// _extract_pallas for extract_patches). Window k starts at
//   r0 = clamp(floor8(row0[k]), 0, R - 64),  c0 = clamp(floor128(col0[k]), 0, WP - 256):
// the TPU kernel's rounding to the (8, 128) tile grid, then the clamp of
// coloc_tpu's dynamic_slice fallback, so no origin reads outside the
// raster. The plain twin is ops/patches.py::extract_patches_plain; a copy
// is exact.
//
// Bound: pure copy, 64 KiB written per keypoint (64 MiB a drone at 1024
// keypoints), the frame's largest tensor; the reads overlap between
// neighbouring keypoints and come largely from L2. Design: one block of
// 256 threads per keypoint, 16-byte loads and stores (c0 and WP are
// multiples of 128 floats, so every window row starts 16-byte aligned),
// consecutive threads on consecutive addresses. Removing the tensor
// altogether (window in shared memory, orientation and descriptor in the
// same block) is a later redesign.
#include "common.cuh"

namespace {

constexpr int kPH = 64;
constexpr int kPW = 256;
constexpr int kVecPerRow = kPW / 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
extract_kernel(const float4* __restrict__ src, const int* __restrict__ row0,
               const int* __restrict__ col0, float4* __restrict__ out, int R, int WP) {
  const int k = blockIdx.x;
  const int r0 = min(max(row0[k] & ~7, 0), R - kPH);
  const int c0 = min(max(col0[k] & ~127, 0), WP - kPW);
  const int wp4 = WP / 4;
  const float4* win = src + static_cast<size_t>(r0) * wp4 + c0 / 4;
  float4* dst = out + static_cast<size_t>(k) * kPH * kVecPerRow;
#pragma unroll 4
  for (int i = threadIdx.x; i < kPH * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c = i % kVecPerRow;
    dst[i] = win[static_cast<size_t>(r) * wp4 + c];
  }
}

}  // namespace

// src (R, WP) float32 with WP % 128 == 0 and R >= 64, WP >= 256; row0, col0
// (K,) int32 -> out (K, 64, 256) float32. Returns the launch's cudaError_t.
extern "C" int coloc_extract(const void* src, const void* row0, const void* col0, void* out,
                             int R, int WP, int K, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (K <= 0) return cudaSuccess;
  extract_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(src), static_cast<const int*>(row0),
      static_cast<const int*>(col0), static_cast<float4*>(out), R, WP);
  return cudaGetLastError();
}
