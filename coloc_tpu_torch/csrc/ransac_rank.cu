// Fused RANSAC pre-rank: reprojection residual + threshold-ladder count.
//
// Replaces coloc_tpu/ops/ransac_rank.py::_rank_kernel (Pallas, launched by
// _p3p_ladder_rank_pallas for p3p_ladder_rank, zmode "pos", and for
// homography_ladder_rank, zmode "nonzero"). Per model m it returns
//   rank[m] = sum_l mask[l] * alive[m,l] * #{j : s[m,l] < thr * 4^j * t0[m,l]}
// for rungs j in [jmin, jmin + n_rungs), in the TPU kernel's product form:
//   A_k = E[m, 4k:4k+4] . xh[:, l]     (three planes, 4 products each)
//   u = A_0 - obs_x Z,  v = A_1 - obs_y Z,  s = u^2 + v^2,  Z = A_2
//   "pos":     t0 = max(Z, 1e-9)^2, alive = Z > 0
//   "nonzero": t0 = Z^2,            alive = |Z| >= 1e-9
// The (Hm, M) residual matrix is never written; only (Hm,) leaves the kernel.
// Counts are integers below 2^24, so the float sums are exact in any order.
// The plain twin is ops/ransac_rank.py::ladder_rank_plain.
//
// Bound: at Hm = M = 1024 the work is ~1M residuals x ~30 flops (~30 MFLOP)
// over 28 KB of inputs: arithmetic, not bandwidth. Design: a block of 256
// threads owns 8 models (their 96 floats in shared memory); each thread
// walks the correspondences with a 256 stride (coalesced loads of xh, obs,
// mask, each reused for 8 models), keeps 8 partial counts in registers, and
// the block reduces them with warp shuffles and one shared-memory pass.
#include "common.cuh"

namespace {

using coloc::nan_max;

constexpr int kModels = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
rank_kernel(const float* __restrict__ E, const float* __restrict__ xh,
            const float* __restrict__ obs, const float* __restrict__ mask,
            float* __restrict__ rank, int Hm, int M, float thr_sq, int jmin,
            int n_rungs, int zmode) {
  __shared__ float e[kModels][12];
  __shared__ float partial[kWarps][kModels];
  const int h0 = blockIdx.x * kModels;
  for (int k = threadIdx.x; k < kModels * 12; k += blockDim.x) {
    const int m = k / 12;
    e[m][k % 12] = (h0 + m < Hm) ? E[static_cast<size_t>(h0 + m) * 12 + (k % 12)] : 0.0f;
  }
  __syncthreads();

  float acc[kModels];
#pragma unroll
  for (int m = 0; m < kModels; ++m) acc[m] = 0.0f;

  for (int l = threadIdx.x; l < M; l += blockDim.x) {
    const float x0 = xh[l], x1 = xh[M + l], x2 = xh[2 * M + l], x3 = xh[3 * M + l];
    const float ox = obs[l], oy = obs[M + l];
    const float msk = mask[l];
#pragma unroll
    for (int m = 0; m < kModels; ++m) {
      const float* em = e[m];
      float A0 = em[0] * x0;
      A0 = A0 + em[1] * x1;
      A0 = A0 + em[2] * x2;
      A0 = A0 + em[3] * x3;
      float A1 = em[4] * x0;
      A1 = A1 + em[5] * x1;
      A1 = A1 + em[6] * x2;
      A1 = A1 + em[7] * x3;
      float Z = em[8] * x0;
      Z = Z + em[9] * x1;
      Z = Z + em[10] * x2;
      Z = Z + em[11] * x3;
      const float u = A0 - ox * Z;
      const float v = A1 - oy * Z;
      const float s = u * u + v * v;
      float t0, alive;
      if (zmode == 0) {
        const float zc = nan_max(Z, 1e-9f);
        t0 = zc * zc;
        alive = Z > 0.0f ? msk : 0.0f;
      } else {
        t0 = Z * Z;
        alive = fabsf(Z) >= 1e-9f ? msk : 0.0f;
      }
      float cnt = 0.0f;
      for (int j = 0; j < n_rungs; ++j)
        cnt = cnt + (s < ldexpf(thr_sq, 2 * (jmin + j)) * t0 ? 1.0f : 0.0f);
      acc[m] = acc[m] + cnt * alive;
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kModels; ++m) {
    float a = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) partial[warp][m] = a;
  }
  __syncthreads();
  if (threadIdx.x < kModels && h0 + threadIdx.x < Hm) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += partial[w][threadIdx.x];
    rank[h0 + threadIdx.x] = a;
  }
}

}  // namespace

// E (Hm,12), xh (4,M), obs (2,M), mask (M,) float32 -> rank (Hm,) float32.
// zmode 0 = "pos", 1 = "nonzero". Returns the launch's cudaError_t.
extern "C" int coloc_ransac_rank(const void* E, const void* xh, const void* obs,
                                 const void* mask, void* rank, int Hm, int M, float thr_sq,
                                 int jmin, int n_rungs, int zmode, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (Hm <= 0) return cudaSuccess;
  rank_kernel<<<(Hm + kModels - 1) / kModels, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(E), static_cast<const float*>(xh), static_cast<const float*>(obs),
      static_cast<const float*>(mask), static_cast<float*>(rank), Hm, M, thr_sq, jmin, n_rungs,
      zmode);
  return cudaGetLastError();
}
