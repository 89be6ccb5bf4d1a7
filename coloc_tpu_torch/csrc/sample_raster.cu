// Nearest samples of C channel windows of a bf16 row-stacked raster, at NS
// window-local coordinates per keypoint.
//
// Replaces coloc_tpu/ops/patches.py::_sample_raster_kernel (Pallas,
// launched by _sample_raster_pallas for sample_raster_flat). The TPU kernel
// DMAs each keypoint's (ph, pw) window of every channel into VMEM and
// samples it with one-hot matrix products; each sample is one bf16 element,
// returned exactly. Here it is a direct gather: channel c of keypoint k
// reads the window at rows clamp(floor8(row0[k]) + c * stride, 0, R - ph)
// and columns clamp(floor128(col0[k]), 0, WP - pw) (the TPU's tile grid,
// then coloc_tpu's dynamic_slice clamp), the coordinate clipped to the
// window and rounded half to even (rintf), and writes the element widened
// to float32. The plain twin is ops/patches.py::sample_raster_plain; a
// gather is exact.
//
// Bound: bytes. At the AKAZE frame (K = 5000) the descriptor pass writes
// 3 x 5000 x 464 floats (28 MB) and reads the coordinates (19 MB) and
// about as many scattered bf16 elements, which sit in a few dozen
// overlapping rows of the raster and come from L2. Design: one warp per
// keypoint, 8 a block, lanes over the samples, so coordinate reads and
// output writes are coalesced; no window copy and no one-hot product.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
sample_raster_kernel(const __nv_bfloat16* __restrict__ src, const int* __restrict__ row0,
                     const int* __restrict__ col0, const float* __restrict__ lx,
                     const float* __restrict__ ly, float* __restrict__ out, int R, int WP,
                     int stride, int K, int NS, int C, int ph, int pw) {
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= K) return;
  const int lane = threadIdx.x & 31;
  const int r_base = row0[k] & ~7;
  const int c0 = min(max(col0[k] & ~127, 0), WP - pw);
  const float* kx = lx + static_cast<size_t>(k) * NS;
  const float* ky = ly + static_cast<size_t>(k) * NS;
  for (int i = lane; i < NS; i += 32) {
    const int ci = static_cast<int>(rintf(coloc::nan_clip(kx[i], 0.0f, static_cast<float>(pw - 1))));
    const int ri = static_cast<int>(rintf(coloc::nan_clip(ky[i], 0.0f, static_cast<float>(ph - 1))));
    for (int c = 0; c < C; ++c) {
      const int r0 = min(max(r_base + c * stride, 0), R - ph);
      const __nv_bfloat16 v = src[static_cast<size_t>(r0 + ri) * WP + c0 + ci];
      out[(static_cast<size_t>(c) * K + k) * NS + i] = __bfloat162float(v);
    }
  }
}

}  // namespace

// src (R, WP) bf16 with R >= ph, WP >= pw; row0, col0 (K,) int32; lx, ly
// (K, NS) float32 -> out (C, K, NS) float32. Returns the launch's
// cudaError_t.
extern "C" int coloc_sample_raster(const void* src, const void* row0, const void* col0,
                                   const void* lx, const void* ly, void* out, int R, int WP,
                                   int stride, int K, int NS, int C, int ph, int pw, int device,
                                   void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (K <= 0 || NS <= 0 || C <= 0) return cudaSuccess;
  const dim3 grid((K + kWarps - 1) / kWarps);
  sample_raster_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<const int*>(row0),
      static_cast<const int*>(col0), static_cast<const float*>(lx),
      static_cast<const float*>(ly), static_cast<float*>(out), R, WP, stride, K, NS, C, ph,
      pw);
  return cudaGetLastError();
}
