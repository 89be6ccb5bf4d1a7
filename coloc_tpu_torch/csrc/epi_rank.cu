// Fused RANSAC pre-rank for essential/fundamental models: symmetric epipolar
// distance + threshold-ladder count.
//
// Replaces coloc_tpu/ops/ransac_rank.py::_epi_rank_kernel (Pallas, launched
// by _epi_ladder_rank_pallas for epipolar_ladder_rank). Per model m:
//   rank[m] = sum_l mask[l] * #{j : lhs[m,l] < c 4^j rhs[m,l]}
// for rungs j in [jmin, jmin + n_rungs), with three K = 9 contractions
//   A    = E[m, 0:9]   . D[0:9, l]    (h2^T E h1)
//   den2 = max(E[m, 9:18]  . D[9:18, l], 0)    (s1 ||(E h1)_xy||^2)
//   den1 = max(E[m, 18:27] . D[18:27, l], 0)   (s2 ||(E^T h2)_xy||^2)
//   lhs = A^2 (den1 + den2),  rhs = den1 den2
// the product form of err < thr 4^j with the focal scales folded into D and
// c = thr / (s1 s2). The (Hm, M) residual matrix is never written; only (Hm,)
// leaves the kernel. Counts are integers below 2^24, so the float sums are
// exact in any order. The plain twin is ops/ransac_rank.py::epi_rank_plain.
//
// Bound: at Hm = 7680 models x M = 1024 correspondences, 7.9 M pairs x ~70
// flops (27 multiply-adds, the epilogue, 5 rung compares) = 0.55 GFLOP, 8 us
// at the fp32 peak; the inputs are 0.9 MB: compute-bound. Design, as B3's:
// Hopper blocks run in no order, so a block of 256 threads owns 8 models
// (their 216 floats in shared memory) for all M correspondences; each thread
// walks the correspondences with a 256 stride (coalesced loads of the 27
// data rows, each reused for 8 models), keeps 8 counts in registers, and the
// block reduces them with warp shuffles and one shared-memory pass.
#include "common.cuh"

namespace {

using coloc::nan_max;

constexpr int kModels = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
epi_rank_kernel(const float* __restrict__ E, const float* __restrict__ D,
                const float* __restrict__ mask, const float* __restrict__ c_ptr,
                float* __restrict__ rank, int Hm, int M, int jmin, int n_rungs) {
  const float c = *c_ptr;
  __shared__ float e[kModels][27];
  __shared__ float partial[kWarps][kModels];
  const int h0 = blockIdx.x * kModels;
  for (int k = threadIdx.x; k < kModels * 27; k += blockDim.x) {
    const int m = k / 27;
    e[m][k % 27] = (h0 + m < Hm) ? E[static_cast<size_t>(h0 + m) * 27 + (k % 27)] : 0.0f;
  }
  __syncthreads();

  float acc[kModels];
#pragma unroll
  for (int m = 0; m < kModels; ++m) acc[m] = 0.0f;

  for (int l = threadIdx.x; l < M; l += blockDim.x) {
    float d[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) d[k] = D[static_cast<size_t>(k) * M + l];
    const float msk = mask[l];
#pragma unroll
    for (int m = 0; m < kModels; ++m) {
      const float* em = e[m];
      float A = em[0] * d[0];
      float s2 = em[9] * d[9];
      float s1 = em[18] * d[18];
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        A = A + em[k] * d[k];
        s2 = s2 + em[9 + k] * d[9 + k];
        s1 = s1 + em[18 + k] * d[18 + k];
      }
      const float den2 = nan_max(s2, 0.0f);
      const float den1 = nan_max(s1, 0.0f);
      const float num = A * A;
      const float lhs = num * (den1 + den2);
      const float rhs = den1 * den2;
      float cnt = 0.0f;
      for (int j = 0; j < n_rungs; ++j)
        cnt = cnt + (lhs < ldexpf(c, 2 * (jmin + j)) * rhs ? 1.0f : 0.0f);
      acc[m] = acc[m] + cnt * msk;
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

// E (Hm, 27), D (27, M), mask (M,) float32, the rung scale c as a (1,)
// float32 on the card (read there, so the host never waits for it) -> rank
// (Hm,) float32. Returns the launch's cudaError_t.
extern "C" int coloc_epi_rank(const void* E, const void* D, const void* mask, const void* c,
                              void* rank, int Hm, int M, int jmin, int n_rungs, int device,
                              void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (Hm <= 0) return cudaSuccess;
  epi_rank_kernel<<<(Hm + kModels - 1) / kModels, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(E), static_cast<const float*>(D),
      static_cast<const float*>(mask), static_cast<const float*>(c), static_cast<float*>(rank),
      Hm, M, jmin, n_rungs);
  return cudaGetLastError();
}
