// FAST-9 score + 3x3 non-max suppression over one float32 raster.
//
// Replaces coloc_tpu/ops/fast.py::_make_fast_nms_kernel (Pallas, launched
// by fast_nms_pallas). Per pixel (y, x) of an (h, w) raster:
//   dev_k = I(y + dy_k, x + dx_k) - I(y, x), ring k of RING_OFFSETS, the
//           ring read at clamped indices (edge-replicate padding);
//   score = max over the 16 arcs of 9 consecutive ring pixels of
//           max(min dev, min -dev), kept if > threshold, else 0;
//   raw   = score, 0 on the raster's 3-px border;
//   nms   = raw where raw >= its 8 neighbours and raw > its 4 earlier
//           (raster-order) neighbours (-1,-1) (-1,0) (-1,1) (0,-1), else 0;
//           neighbours outside the raster read 0.
// The border is the whole raster's (a stacked pyramid batch is one
// raster); per-level borders are the caller's mask. Only subtractions,
// negations, min, max and compares: exact in float32, so the kernel equals
// the plain twin ops/fast.py::fast_nms_plain bit for bit.
//
// Bound: per pixel 4 bytes in, 8 out, against ~180 ALU ops (16 deviations,
// two 16-arc min cascades, the maxima, the NMS compares): arithmetic once
// the halo is reused. Design: one block per 32x32 output tile; the tile
// plus a 4-px halo (40x40) is loaded once into shared memory, scores for
// the tile plus a 1-px ring (34x34) go to shared memory, and the NMS reads
// its neighbours there. The TPU kernel's double-buffered window DMA has
// no counterpart: the halo loads are coalesced reads that L2 serves to
// neighbouring tiles.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 4;                  // ring radius 3 + NMS radius 1
constexpr int kIn = kTile + 2 * kHalo;    // 40
constexpr int kSc = kTile + 2;            // 34
constexpr int kThreads = 256;

__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// max over the 16 starts s of min(v[s], ..., v[s+8 mod 16])
__device__ __forceinline__ float best_arc(const float (&v)[16]) {
  float m2[16], m4[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) m2[s] = fminf(v[s], v[(s + 1) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) m4[s] = fminf(m2[s], m2[(s + 2) & 15]);
  float best = -INFINITY;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const float m8 = fminf(m4[s], m4[(s + 4) & 15]);
    best = fmaxf(best, fminf(m8, v[(s + 8) & 15]));
  }
  return best;
}

__global__ void __launch_bounds__(kThreads)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ raw,
                float* __restrict__ nms, int h, int w, float threshold) {
  __shared__ float in[kIn][kIn + 1];
  __shared__ float sc[kSc][kSc + 1];
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;

  for (int i = threadIdx.x; i < kIn * kIn; i += kThreads) {
    const int r = i / kIn, c = i % kIn;
    const int gy = min(max(y0 - kHalo + r, 0), h - 1);
    const int gx = min(max(x0 - kHalo + c, 0), w - 1);
    in[r][c] = img[static_cast<size_t>(gy) * w + gx];
  }
  __syncthreads();

  // scores of the tile and its 1-px ring; score cell (r, c) is pixel
  // (y0 - 1 + r, x0 - 1 + c) and input cell (r + 3, c + 3)
  for (int i = threadIdx.x; i < kSc * kSc; i += kThreads) {
    const int r = i / kSc, c = i % kSc;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float s = 0.0f;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      const float center = in[r + 3][c + 3];
      float bright[16], dark[16];
      bool nan = false;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float d = in[r + 3 + kRingDy[k]][c + 3 + kRingDx[k]] - center;
        bright[k] = d;
        dark[k] = -d;
        nan |= d != d;
      }
      // the twin's min/max propagate NaN, and NaN > threshold is false;
      // fminf/fmaxf drop it, so a NaN deviation zeroes the score here
      const float best = fmaxf(best_arc(bright), best_arc(dark));
      s = (!nan && best > threshold) ? best : 0.0f;
    }
    sc[r][c] = s;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    const float s = sc[r + 1][c + 1];
    const float earlier = fmaxf(fmaxf(sc[r][c], sc[r][c + 1]),
                                fmaxf(sc[r][c + 2], sc[r + 1][c]));
    const float later = fmaxf(fmaxf(sc[r + 1][c + 2], sc[r + 2][c]),
                              fmaxf(sc[r + 2][c + 1], sc[r + 2][c + 2]));
    const bool keep = s >= fmaxf(earlier, later) && earlier < s;
    const size_t o = static_cast<size_t>(gy) * w + gx;
    raw[o] = s;
    nms[o] = keep ? s : 0.0f;
  }
}

}  // namespace

// img, raw, nms: (h, w) float32. Returns the launch's cudaError_t.
extern "C" int coloc_fast_nms(const void* img, void* raw, void* nms, int h, int w,
                              float threshold, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (h <= 0 || w <= 0) return cudaSuccess;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  fast_nms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(raw), static_cast<float*>(nms), h,
      w, threshold);
  return cudaGetLastError();
}
