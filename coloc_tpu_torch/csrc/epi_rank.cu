// Fused RANSAC pre-rank for essential/fundamental models: symmetric epipolar
// distance + threshold-ladder count.
//
// Replaces coloc_tpu/ops/ransac_rank.py::_epi_rank_kernel (:272, Pallas,
// launched by _epi_ladder_rank_pallas for epipolar_ladder_rank). Per model m:
//   rank[m] = sum_l mask[l] * #{j : lhs[m,l] < c 4^j rhs[m,l]}
// for rungs j in [jmin, jmin + n_rungs), with three K = 9 contractions
//   A    = E[m, 0:9]   . D[0:9, l]    (h2^T E h1)
//   den2 = max(E[m, 9:18]  . D[9:18, l], 0)    (s1 ||(E h1)_xy||^2)
//   den1 = max(E[m, 18:27] . D[18:27, l], 0)   (s2 ||(E^T h2)_xy||^2)
//   lhs = A^2 (den1 + den2),  rhs = den1 den2
// the product form of err < thr 4^j with the focal scales folded into D and
// c = thr / (s1 s2). Every value is the plain twin's operation in its order
// (each contraction from e[c0] d[c0], then + e[c0+k] d[c0+k], built with
// -fmad=false; the clamps propagate NaN as torch.clamp does; the rungs
// ldexpf(c, 2j) equal the twin's c * 4.0**j, both exact scalings), so with
// 0/1 masks the rank equals ops/ransac_rank.py::epi_rank_plain bit for bit:
// a count is an integer below 2^24, exact in any order. The (Hm, M)
// residual matrix is never written; only (Hm,) leaves the kernel.
//
// Bound: at Hm = 7680 models x M = 1024 correspondences, 7.9 M pairs x ~70
// flops (27 multiplies, 24 adds, the clamps and epilogue, 5 rung compares) =
// 0.55 GFLOP, 8 us at the fp32 peak; the inputs are 0.9 MB: compute-bound,
// and with no FMA about 70 issued instructions a pair. Design:
//   - A lane owns two models, their 54 floats in registers, so a CTA of 8
//     warps owns 64 models and every warp walks a share of the points for
//     all 64: a point's values are the same address for every lane, one
//     broadcast shared-memory load serves the warp's 64 models, and a
//     model's count needs no reduction across lanes. The CTA's models come
//     into shared memory first, coalesced, and a lane reads its own there.
//   - The CTA stages up to 1024 points at a time in shared memory, 4 a
//     thread with 16-byte loads where M is a multiple of 4, all 27 rows'
//     loads issued before the first store. Only points whose mask is 1
//     are kept, compacted in order (a block-wide scan of the 0/1 flags),
//     and their run is padded to a multiple of 4 with zero columns, which
//     count 0 against any model (0 < 0 and NaN compares are false): a
//     masked point costs no arithmetic, and a warp reads 4 points' row k
//     with one 16-byte broadcast load.
//   - n_rungs == 5 is unrolled with its 5 scales formed once a thread;
//     a compare is one set.lt mask (-1 or 0) and the masks are summed as
//     integers. Other rung counts take a generic loop.
//   - A mask other than 0 or 1 (never produced by the callers, which pass
//     valid.to(float32)) is counted on a float path, count * mask, in a
//     second pass over the global mask, so a NaN mask propagates as in the
//     twin; such sums are exact only up to order.
//   - Hm = 7680 gives 120 CTAs, one an SM (119 KB of shared memory), one
//     wave; the 8 warps' counts are summed through shared memory. With the
//     staging at about a sixth of the time, the 70 instructions a pair set
//     it (scripts/prof_torch_rank_split.py).
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kLane = 2;                // models a lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kModels = 32 * kLane;    // a CTA's models
constexpr int kStage = 4 * kThreads;   // points staged at a time, 4 a thread
constexpr int kPitch = kStage + 4;     // a staged row: kept points + zero padding
constexpr int kRows = 27;
constexpr int kRungs = 5;              // the ladder's rung count, unrolled

// -1 where a < b, else 0 (false where either is NaN, as C's a < b)
__device__ __forceinline__ int lt_mask(float a, float b) {
  int d;
  asm("set.lt.s32.f32 %0, %1, %2;" : "=r"(d) : "f"(a), "f"(b));
  return d;
}

// max(x, 0) with NaN propagated (torch.clamp(min=0)); the sign of a zero
// result may differ, which no product or compare of the rank can see
__device__ __forceinline__ float clamp0(float x) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(x), "f"(0.0f));
  return d;
}

// The number of rungs a (lhs, rhs) pair clears: the 5 scales unrolled
// (kGeneric false), or a loop over n rungs of ldexpf(c, 2 (jmin + j)).
template <bool kGeneric>
struct Ladder {
  float r[kRungs];
  __device__ Ladder(float c, int jmin, int) {
#pragma unroll
    for (int j = 0; j < kRungs; ++j) r[j] = ldexpf(c, 2 * (jmin + j));
  }
  __device__ __forceinline__ int count(float lhs, float rhs) const {
    int m = 0;
#pragma unroll
    for (int j = 0; j < kRungs; ++j) m += lt_mask(lhs, r[j] * rhs);
    return -m;
  }
};

template <>
struct Ladder<true> {
  float c;
  int jmin, n;
  __device__ Ladder(float c_, int jmin_, int n_) : c(c_), jmin(jmin_), n(n_) {}
  __device__ __forceinline__ int count(float lhs, float rhs) const {
    int k = 0;
    for (int j = 0; j < n; ++j) k += lhs < ldexpf(c, 2 * (jmin + j)) * rhs;
    return k;
  }
};

// lhs and rhs of a model from its three contractions
__device__ __forceinline__ void epilogue(float A, float s2, float s1, float& lhs, float& rhs) {
  const float den2 = clamp0(s2);
  const float den1 = clamp0(s1);
  const float num = A * A;
  lhs = num * (den1 + den2);
  rhs = den1 * den2;
}

template <bool kGeneric>
__global__ void __launch_bounds__(kThreads, 1)
epi_rank_kernel(const float* __restrict__ E, const float* __restrict__ D,
                const float* __restrict__ mask, const float* __restrict__ c_ptr,
                float* __restrict__ rank, int Hm, int M, int jmin, int n_rungs) {
  extern __shared__ float4 smem_raw[];
  float* pts = reinterpret_cast<float*>(smem_raw);  // [kRows][kPitch]
  __shared__ float models[kModels * kRows];  // the CTA's models, copied in at the start
  __shared__ int scan[kWarps];
  __shared__ int part[kWarps][kModels];
  __shared__ float part_odd[kWarps][kModels];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the CTA's models, coalesced, ahead of the points (zeros past Hm);
  // the first stage's barrier publishes them
  const int n_model = min(kModels, Hm - static_cast<int>(blockIdx.x) * kModels) * kRows;
  const float* E0 = E + static_cast<size_t>(blockIdx.x) * kModels * kRows;
  for (int i = threadIdx.x; i < kModels * kRows; i += kThreads)
    models[i] = i < n_model ? E0[i] : 0.0f;
  // read after each stage, when the staged points' registers are dead: a
  // lane's 27 floats at stride 27, so the 32 lanes hit 32 banks
  float e[kLane][kRows];
  auto load_models = [&]() {
#pragma unroll
    for (int m = 0; m < kLane; ++m)
#pragma unroll
      for (int k = 0; k < kRows; ++k) e[m][k] = models[(32 * m + lane) * kRows + k];
  };
  const float c = *c_ptr;
  const Ladder<kGeneric> ladder(c, jmin, n_rungs);
  const bool vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(D) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 16 == 0;

  int cnt[kLane];
#pragma unroll
  for (int m = 0; m < kLane; ++m) cnt[m] = 0;
  for (int base = 0; base < M; base += kStage) {
    // this thread's 4 points: their masks, which are kept, and where
    const int l0 = base + 4 * threadIdx.x;
    const bool in = l0 < M;
    float mk[4];
    if (vec && in) {
      const float4 v = *reinterpret_cast<const float4*>(mask + l0);
      mk[0] = v.x, mk[1] = v.y, mk[2] = v.z, mk[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) mk[j] = l0 + j < M ? mask[l0 + j] : 0.0f;
    }
    unsigned keep = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) keep |= (mk[j] == 1.0f ? 1u : 0u) << j;
    float d[kRows][4];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const float* row = D + static_cast<size_t>(k) * M;
      if (vec && in) {
        const float4 v = *reinterpret_cast<const float4*>(row + l0);
        d[k][0] = v.x, d[k][1] = v.y, d[k][2] = v.z, d[k][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) d[k][j] = (keep >> j & 1u) ? row[l0 + j] : 0.0f;
      }
    }
    // exclusive scan of the kept counts in thread order
    const int n_keep = __popc(keep);
    int incl = n_keep;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) scan[warp] = incl;
    __syncthreads();
    int pos = incl - n_keep, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = scan[w];
      pos += w < warp ? s : 0;
      total += s;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (keep >> j & 1u) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) pts[k * kPitch + pos] = d[k][j];
        ++pos;
      }
    }
    const int padded = (total + 3) & ~3;
    if (static_cast<int>(threadIdx.x) < padded - total) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) pts[k * kPitch + total + threadIdx.x] = 0.0f;
    }
    __syncthreads();  // the stage is complete
    load_models();

    // every warp takes groups of 4 kept points for its lanes' models
    for (int p = 4 * warp; p < padded; p += 4 * kWarps) {
      float A[kLane][4], s2[kLane][4], s1[kLane][4];
      {
        const float4 va = *reinterpret_cast<const float4*>(&pts[p]);
        const float4 vb = *reinterpret_cast<const float4*>(&pts[9 * kPitch + p]);
        const float4 vc = *reinterpret_cast<const float4*>(&pts[18 * kPitch + p]);
#pragma unroll
        for (int m = 0; m < kLane; ++m) {
          A[m][0] = e[m][0] * va.x, A[m][1] = e[m][0] * va.y;
          A[m][2] = e[m][0] * va.z, A[m][3] = e[m][0] * va.w;
          s2[m][0] = e[m][9] * vb.x, s2[m][1] = e[m][9] * vb.y;
          s2[m][2] = e[m][9] * vb.z, s2[m][3] = e[m][9] * vb.w;
          s1[m][0] = e[m][18] * vc.x, s1[m][1] = e[m][18] * vc.y;
          s1[m][2] = e[m][18] * vc.z, s1[m][3] = e[m][18] * vc.w;
        }
      }
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        const float4 va = *reinterpret_cast<const float4*>(&pts[k * kPitch + p]);
        const float4 vb = *reinterpret_cast<const float4*>(&pts[(9 + k) * kPitch + p]);
        const float4 vc = *reinterpret_cast<const float4*>(&pts[(18 + k) * kPitch + p]);
#pragma unroll
        for (int m = 0; m < kLane; ++m) {
          A[m][0] = A[m][0] + e[m][k] * va.x, A[m][1] = A[m][1] + e[m][k] * va.y;
          A[m][2] = A[m][2] + e[m][k] * va.z, A[m][3] = A[m][3] + e[m][k] * va.w;
          s2[m][0] = s2[m][0] + e[m][9 + k] * vb.x, s2[m][1] = s2[m][1] + e[m][9 + k] * vb.y;
          s2[m][2] = s2[m][2] + e[m][9 + k] * vb.z, s2[m][3] = s2[m][3] + e[m][9 + k] * vb.w;
          s1[m][0] = s1[m][0] + e[m][18 + k] * vc.x, s1[m][1] = s1[m][1] + e[m][18 + k] * vc.y;
          s1[m][2] = s1[m][2] + e[m][18 + k] * vc.z, s1[m][3] = s1[m][3] + e[m][18 + k] * vc.w;
        }
      }
#pragma unroll
      for (int m = 0; m < kLane; ++m) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float lhs, rhs;
          epilogue(A[m][j], s2[m][j], s1[m][j], lhs, rhs);
          cnt[m] += ladder.count(lhs, rhs);
        }
      }
    }
    __syncthreads();  // every warp is done with the stage before it is refilled
  }

  // points whose mask is neither 0 nor 1: count * mask on a float path
  float odd[kLane];
#pragma unroll
  for (int m = 0; m < kLane; ++m) odd[m] = 0.0f;
  __syncthreads();  // the models are in, also where M == 0 staged nothing
  load_models();
  for (int base = warp * 32; base < M; base += kThreads) {
    const float w = base + lane < M ? mask[base + lane] : 0.0f;
    unsigned ball = __ballot_sync(0xffffffffu, !(w == 0.0f || w == 1.0f));
    while (ball) {
      const int j = __ffs(ball) - 1;
      ball &= ball - 1;
      const size_t l = base + j;
      const float wj = __shfl_sync(0xffffffffu, w, j);
#pragma unroll
      for (int m = 0; m < kLane; ++m) {
        float A = e[m][0] * D[l], s2 = e[m][9] * D[9 * static_cast<size_t>(M) + l];
        float s1 = e[m][18] * D[18 * static_cast<size_t>(M) + l];
        for (int k = 1; k < 9; ++k) {
          A = A + e[m][k] * D[k * static_cast<size_t>(M) + l];
          s2 = s2 + e[m][9 + k] * D[(9 + k) * static_cast<size_t>(M) + l];
          s1 = s1 + e[m][18 + k] * D[(18 + k) * static_cast<size_t>(M) + l];
        }
        float lhs, rhs;
        epilogue(A, s2, s1, lhs, rhs);
        odd[m] = odd[m] + static_cast<float>(ladder.count(lhs, rhs)) * wj;
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kLane; ++m) {
    part[warp][32 * m + lane] = cnt[m];
    part_odd[warp][32 * m + lane] = odd[m];
  }
  __syncthreads();
  if (threadIdx.x < kModels) {
    const int h = blockIdx.x * kModels + threadIdx.x;
    if (h < Hm) {
      int total = 0;
      float f = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        total += part[w][threadIdx.x];
        f = f + part_odd[w][threadIdx.x];
      }
      rank[h] = static_cast<float>(total) + f;
    }
  }
}

template <bool kGeneric>
cudaError_t launch(const float* E, const float* D, const float* mask, const float* c,
                   float* rank, int Hm, int M, int jmin, int n_rungs, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * kRows * kPitch;
  cudaError_t err = cudaFuncSetAttribute(
      epi_rank_kernel<kGeneric>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  epi_rank_kernel<kGeneric><<<(Hm + kModels - 1) / kModels, kThreads, smem, stream>>>(
      E, D, mask, c, rank, Hm, M, jmin, n_rungs);
  return cudaGetLastError();
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
  const auto* e = static_cast<const float*>(E);
  const auto* d = static_cast<const float*>(D);
  const auto* m = static_cast<const float*>(mask);
  const auto* cc = static_cast<const float*>(c);
  auto* r = static_cast<float*>(rank);
  const auto s = static_cast<cudaStream_t>(stream);
  return n_rungs == kRungs ? launch<false>(e, d, m, cc, r, Hm, M, jmin, n_rungs, s)
                           : launch<true>(e, d, m, cc, r, Hm, M, jmin, n_rungs, s);
}
