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
// overlapping rows of the raster and come from L2. Design: the K x NS
// samples are one flat run (lx, ly and each channel of out are contiguous),
// and a thread owns 4 consecutive samples of it, which may belong to two
// keypoints. It starts its coordinate loads (one 16-byte load of lx and one
// of ly where K * NS % 4 == 0 and the rows are 16-byte aligned, at NS = 49
// as at NS = 464; else up to 4 scalar loads each) and its keypoints'
// origins, then all C x 4 gathers, then its stores (16 bytes a channel
// where aligned), so up to 12 gathers are in flight a thread where the
// parent kernel made one dependent coordinate-then-gather trip at a time.
// The raster, the coordinates and the origins go through the read-only
// path (__ldg). C is a template parameter for 1-3 channels, which keeps all
// gathers ahead of the stores (a runtime channel loop, even in unrolled
// batches of 3, measured 25% slower at C = 3); a runtime loop above that.
#include <cuda_bf16.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // samples a thread

template <int kC, bool kVec>
__global__ void __launch_bounds__(kThreads)
sample_raster_kernel(const __nv_bfloat16* __restrict__ src, const int* __restrict__ row0,
                     const int* __restrict__ col0, const float* __restrict__ lx,
                     const float* __restrict__ ly, float* __restrict__ out, int R, int WP,
                     int stride, int K, int NS, int C_rt, int ph, int pw) {
  const int total = K * NS;
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (j0 >= total) return;
  const int n = min(kPer, total - j0);
  float fx[kPer], fy[kPer];
  if constexpr (kVec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(lx + j0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(ly + j0));
    fx[0] = a.x; fx[1] = a.y; fx[2] = a.z; fx[3] = a.w;
    fy[0] = b.x; fy[1] = b.y; fy[2] = b.z; fy[3] = b.w;
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      fx[u] = u < n ? __ldg(lx + j0 + u) : 0.0f;
      fy[u] = u < n ? __ldg(ly + j0 + u) : 0.0f;
    }
  }
  // each sample's keypoint: its window's first row (channel 0) and the
  // element offset of the sample in it
  int k = j0 / NS, i = j0 - k * NS;
  int rb[kPer], at[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int kk = min(k, K - 1);
    const int c0 = min(max(__ldg(col0 + kk) & ~127, 0), WP - pw);
    rb[u] = __ldg(row0 + kk) & ~7;
    const int ci = static_cast<int>(rintf(coloc::nan_clip(fx[u], 0.0f, pw - 1.0f)));
    const int ri = static_cast<int>(rintf(coloc::nan_clip(fy[u], 0.0f, ph - 1.0f)));
    at[u] = ri * WP + c0 + ci;
    if (++i == NS) {
      i = 0;
      ++k;
    }
  }
  auto gather = [&](int c, float (&v)[kPer]) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const size_t r0 = min(max(rb[u] + c * stride, 0), R - ph);
      v[u] = u < n ? __bfloat162float(__ldg(src + r0 * WP + at[u])) : 0.0f;
    }
  };
  auto store = [&](int c, const float (&v)[kPer]) {
    float* o = out + static_cast<size_t>(c) * total + j0;
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (u < n) o[u] = v[u];
    }
  };
  if constexpr (kC > 0) {
    float v[kC][kPer];
#pragma unroll
    for (int c = 0; c < kC; ++c) gather(c, v[c]);
#pragma unroll
    for (int c = 0; c < kC; ++c) store(c, v[c]);
  } else {
    for (int c = 0; c < C_rt; ++c) {
      float v[kPer];
      gather(c, v);
      store(c, v);
    }
  }
}

template <int kC>
cudaError_t launch(bool vec, dim3 grid, cudaStream_t stream, const __nv_bfloat16* src,
                   const int* row0, const int* col0, const float* lx, const float* ly,
                   float* out, int R, int WP, int stride, int K, int NS, int C, int ph, int pw) {
  if (vec)
    sample_raster_kernel<kC, true><<<grid, kThreads, 0, stream>>>(
        src, row0, col0, lx, ly, out, R, WP, stride, K, NS, C, ph, pw);
  else
    sample_raster_kernel<kC, false><<<grid, kThreads, 0, stream>>>(
        src, row0, col0, lx, ly, out, R, WP, stride, K, NS, C, ph, pw);
  return cudaGetLastError();
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
  if (K > (INT_MAX - kThreads * kPer) / NS) return cudaErrorInvalidValue;
  const int total = K * NS;
  const dim3 grid((total + kThreads * kPer - 1) / (kThreads * kPer));
  // 16-byte coordinate loads and stores where every run of 4 samples, in
  // lx, ly and each channel of out, starts on a 16-byte boundary
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = total % kPer == 0 && aligned(lx) && aligned(ly) && aligned(out);
  const auto* s = static_cast<const __nv_bfloat16*>(src);
  const auto* r = static_cast<const int*>(row0);
  const auto* c = static_cast<const int*>(col0);
  const auto* x = static_cast<const float*>(lx);
  const auto* y = static_cast<const float*>(ly);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kc) {
    return launch<decltype(kc)::value>(vec, grid, st, s, r, c, x, y, o, R, WP, stride, K, NS,
                                       C, ph, pw);
  };
  switch (C) {
    case 1: return go(std::integral_constant<int, 1>{});
    case 2: return go(std::integral_constant<int, 2>{});
    case 3: return go(std::integral_constant<int, 3>{});
    default: return go(std::integral_constant<int, 0>{});
  }
}
