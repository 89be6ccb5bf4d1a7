// Fused RANSAC pre-rank: reprojection residual + threshold-ladder count.
//
// Replaces coloc_tpu/ops/ransac_rank.py::_rank_kernel (Pallas, launched by
// _p3p_ladder_rank_pallas for p3p_ladder_rank, zmode "pos", and for
// homography_ladder_rank, zmode "nonzero"). Per model m it returns
//   rank[m] = sum_l mask[l] * alive[m,l] * #{j : s[m,l] < r_j * t0[m,l]}
// with r_j = thr_sq * 4^(jmin + j), j < n_rungs, in the TPU kernel's
// product form:
//   A_k = E[m, 4k:4k+4] . xh[:, l]     (three planes, 4 products each)
//   u = A_0 - obs_x Z,  v = A_1 - obs_y Z,  s = u^2 + v^2,  Z = A_2
//   "pos":     t0 = max(Z, 1e-9)^2, alive = Z > 0
//   "nonzero": t0 = Z^2,            alive = |Z| >= 1e-9
// Every value comes from the plain twin's operations in its order (built
// with -fmad=false), so with a 0/1 mask the rank equals the twin's bit for
// bit: a count is an integer below 2^24, exact in any order. The (Hm, M)
// residual matrix is never written; only (Hm,) leaves the kernel. The
// plain twin is ops/ransac_rank.py::ladder_rank_plain.
//
// Bound: ~44 flops a (model, point) pair, 28 bytes a point and 48 a model:
// at Hm = 1024 the work is operations, 0.7 us at M = 1024 and 3.4 us at
// M = 5000 on the fp32 peak; in issued instructions (~45 a pair with no
// FMA) about twice that. Design, to fill 132 SMs with that little work:
//   - a CTA of 8 warps owns 16 models, 2 a warp; every lane of the warp
//     holds the warp's 2 models (24 floats) in registers and walks its own
//     points, each point read once and used for both models;
//   - the points are split over a __cluster_dims__(1, 8, 1) cluster: CTA
//     rank r takes the r-th eighth (rounded to whole warps) of the point
//     axis, so Hm = 1024 launches 512 CTAs, ~4 an SM;
//   - a CTA stages its points (xh, obs, mask: 28 bytes each) in shared
//     memory, up to 1024 at a time, so each thread's loads are all issued
//     before the first wait and the 8 warps read them from shared memory;
//   - n_rungs == 5 is unrolled at compile time, its rungs r_j computed by
//     the launcher and passed by value; other counts take a generic loop;
//     a compare is one set.lt mask (-1 or 0) and the 5 masks are summed as
//     integers; where a point is not alive, or its mask is 0, t0 is 0,
//     which no s >= 0 is below, so the count needs no separate select;
//   - a warp sums its lanes with __reduce_add_sync, and every CTA stores
//     its 16 partial counts into rank 0's shared memory (distributed
//     shared memory); rank 0 alone waits on the cluster barrier and sums
//     the 8 partials in rank order: no scratch buffer, no memset, one
//     launch.
// A mask value other than 0 or 1 (never produced by the callers, which
// pass valid.to(float32)) takes a float path, count * mask, so NaN masks
// propagate as in the twin; such sums are exact only up to order.
// A drone axis is the grid's z: z reads its own (Hm, 12), (4, M), (2, M),
// (M,) slabs and writes its own (Hm,) ranks, so D drones are one launch
// (coloc_ransac_rank_batched) and each drone's ranks are those of a D = 1
// launch on its slabs (coloc_ransac_rank).
#include <cooperative_groups.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 8;                          // CTAs a cluster over the points
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpModels = 2;                     // models a warp, held by every lane
constexpr int kTileModels = kWarps * kWarpModels;  // models a CTA
constexpr int kStage = 1024;                       // points staged at a time

struct Partial {
  int count;
  float odd;  // the float part of points whose mask is neither 0 nor 1
};

// The cluster barrier in two halves (PTX barrier.cluster): an arrival that
// does not wait, and the wait for every CTA's arrival.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int kRungs = 5;  // the ladder's rung count, unrolled

// r_j = ldexp(thr_sq, 2 (jmin + j)) for the unrolled ladder, computed by
// the launcher (ldexp is exact, on the host as on the card)
struct Rungs {
  float r[kRungs];
};

// -1 where a < b, else 0 (false where either is NaN, as C's a < b)
__device__ __forceinline__ int lt_mask(float a, float b) {
  int d;
  asm("set.lt.s32.f32 %0, %1, %2;" : "=r"(d) : "f"(a), "f"(b));
  return d;
}

// The number of rungs s clears: the 5 rungs unrolled (kGeneric false), or
// a loop over n_rungs rungs of ldexpf(thr_sq, 2 (jmin + j)).
template <bool kGeneric>
struct Ladder {
  Rungs rungs;
  __device__ Ladder(const Rungs& r, float, int, int) : rungs(r) {}
  __device__ __forceinline__ int count(float s, float t0) const {
    int m = 0;
#pragma unroll
    for (int j = 0; j < kRungs; ++j) m += lt_mask(s, rungs.r[j] * t0);
    return -m;
  }
};

template <>
struct Ladder<true> {
  float thr_sq;
  int jmin, n;
  __device__ Ladder(const Rungs&, float thr_sq_, int jmin_, int n_)
      : thr_sq(thr_sq_), jmin(jmin_), n(n_) {}
  __device__ __forceinline__ int count(float s, float t0) const {
    int c = 0;
    for (int j = 0; j < n; ++j) c += s < ldexpf(thr_sq, 2 * (jmin + j)) * t0;
    return c;
  }
};

// s and Z of model e at point x, in the twin's order of operations
__device__ __forceinline__ float residual(const float (&e)[12], const float (&x)[4], float ox,
                                          float oy, float& Z) {
  float A0 = e[0] * x[0];
  A0 = A0 + e[1] * x[1];
  A0 = A0 + e[2] * x[2];
  A0 = A0 + e[3] * x[3];
  float A1 = e[4] * x[0];
  A1 = A1 + e[5] * x[1];
  A1 = A1 + e[6] * x[2];
  A1 = A1 + e[7] * x[3];
  Z = e[8] * x[0];
  Z = Z + e[9] * x[1];
  Z = Z + e[10] * x[2];
  Z = Z + e[11] * x[3];
  const float u = A0 - ox * Z;
  const float v = A1 - oy * Z;
  return u * u + v * v;
}

// alive, and t0 where alive ("pos": Z > 0 is not NaN, so max(Z, 1e-9)
// needs no NaN rule there)
template <int kZmode>
__device__ __forceinline__ bool alive_t0(float Z, float& t0) {
  if (kZmode == 0) {
    const float zc = fmaxf(Z, 1e-9f);
    t0 = zc * zc;
    return Z > 0.0f;
  }
  t0 = Z * Z;
  return fabsf(Z) >= 1e-9f;
}

template <bool kGeneric, int kZmode>
__global__ void __cluster_dims__(1, kSplit, 1) __launch_bounds__(kThreads, 4)
rank_kernel(const float* __restrict__ E, const float* __restrict__ xh,
            const float* __restrict__ obs, const float* __restrict__ mask,
            float* __restrict__ rank, int Hm, int M, Rungs rungs, float thr_sq, int jmin,
            int n_rungs) {
  __shared__ float pts[7][kStage];
  __shared__ Partial part[kSplit][kTileModels];  // rank 0's receives every CTA's
  cluster_arrive_relaxed();  // this CTA has started; waited on before any remote store
  // drone z's slabs
  const size_t z = blockIdx.z;
  E += z * Hm * 12;
  xh += z * 4 * M;
  obs += z * 2 * M;
  mask += z * M;
  rank += z * Hm;
  const int split = static_cast<int>(cg::this_cluster().block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = blockIdx.x * kTileModels + warp * kWarpModels;

  float e[kWarpModels][12];
#pragma unroll
  for (int k = 0; k < kWarpModels; ++k)
#pragma unroll
    for (int c = 0; c < 12; ++c)
      e[k][c] = h0 + k < Hm ? E[static_cast<size_t>(h0 + k) * 12 + c] : 0.0f;
  const Ladder<kGeneric> ladder(rungs, thr_sq, jmin, n_rungs);

  // this CTA's points: an eighth of M, rounded up to whole warps
  const int chunk = ((M + kSplit - 1) / kSplit + 31) & ~31;
  const int l_end = min(M, (split + 1) * chunk);

  int cnt[kWarpModels];
  float odd[kWarpModels];
#pragma unroll
  for (int k = 0; k < kWarpModels; ++k) {
    cnt[k] = 0;
    odd[k] = 0.0f;
  }
  bool any_odd = false;
  for (int base = split * chunk; base < l_end; base += kStage) {
    const int n = min(kStage, l_end - base);
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int l = base + i;
      pts[0][i] = xh[l];
      pts[1][i] = xh[M + l];
      pts[2][i] = xh[2 * M + l];
      pts[3][i] = xh[3 * M + l];
      pts[4][i] = obs[l];
      pts[5][i] = obs[M + l];
      pts[6][i] = mask[l];
    }
    __syncthreads();
    for (int i = lane; i < n; i += 32) {
      const float w = pts[6][i];
      const float x[4] = {pts[0][i], pts[1][i], pts[2][i], pts[3][i]};
      const float ox = pts[4][i], oy = pts[5][i];
      if (w == 0.0f || w == 1.0f) {
        // a point adds its count where alive and w is 1, else 0: there t0
        // is 0, which no s (>= 0 or NaN) is below
        const bool live = w != 0.0f;
#pragma unroll
        for (int k = 0; k < kWarpModels; ++k) {
          float Z, t0;
          const float s = residual(e[k], x, ox, oy, Z);
          const bool alive = alive_t0<kZmode>(Z, t0);
          cnt[k] += ladder.count(s, alive && live ? t0 : 0.0f);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kWarpModels; ++k) {
          float Z, t0;
          const float s = residual(e[k], x, ox, oy, Z);
          if (alive_t0<kZmode>(Z, t0)) {
            odd[k] = odd[k] + static_cast<float>(ladder.count(s, t0)) * w;
            any_odd = true;
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the stage before it is refilled
  }

  // the warps' sums, stored into rank 0's shared memory
  const bool warp_odd = __any_sync(0xffffffffu, any_odd);
  cluster_wait();  // every CTA of the cluster has started
  Partial* dst = cg::this_cluster().map_shared_rank(&part[split][0], 0);
#pragma unroll
  for (int k = 0; k < kWarpModels; ++k) {
    const int total = __reduce_add_sync(0xffffffffu, cnt[k]);
    float f = odd[k];
    if (warp_odd) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) f += __shfl_down_sync(0xffffffffu, f, off);
    }
    if (lane == 0) dst[warp * kWarpModels + k] = Partial{total, f};
  }
  cluster_arrive_release();  // this CTA's partials are stored
  if (split != 0) return;    // rank 0's shared memory outlives every store: it waits
  cluster_wait();
  const int h = blockIdx.x * kTileModels + threadIdx.x;
  if (threadIdx.x < kTileModels && h < Hm) {
    int total = 0;
    float f = 0.0f;
#pragma unroll
    for (int src = 0; src < kSplit; ++src) {
      total += part[src][threadIdx.x].count;
      f = f + part[src][threadIdx.x].odd;
    }
    rank[h] = static_cast<float>(total) + f;
  }
}

template <bool kGeneric, int kZmode>
cudaError_t launch(const float* E, const float* xh, const float* obs, const float* mask,
                   float* rank, int D, int Hm, int M, float thr_sq, int jmin, int n_rungs,
                   cudaStream_t stream) {
  Rungs rungs{};
  if (!kGeneric)
    for (int j = 0; j < kRungs; ++j) rungs.r[j] = std::ldexp(thr_sq, 2 * (jmin + j));
  const dim3 grid((Hm + kTileModels - 1) / kTileModels, kSplit, D);
  rank_kernel<kGeneric, kZmode><<<grid, kThreads, 0, stream>>>(E, xh, obs, mask, rank, Hm, M,
                                                                rungs, thr_sq, jmin, n_rungs);
  return cudaGetLastError();
}

}  // namespace

namespace {

int launch_any(const void* E, const void* xh, const void* obs, const void* mask, void* rank,
               int D, int Hm, int M, float thr_sq, int jmin, int n_rungs, int zmode,
               int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (Hm <= 0 || D <= 0) return cudaSuccess;
  if (D > 65535) return cudaErrorInvalidValue;
  const auto* e = static_cast<const float*>(E);
  const auto* x = static_cast<const float*>(xh);
  const auto* o = static_cast<const float*>(obs);
  const auto* m = static_cast<const float*>(mask);
  auto* r = static_cast<float*>(rank);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_rungs == kRungs)
    return zmode == 0 ? launch<false, 0>(e, x, o, m, r, D, Hm, M, thr_sq, jmin, n_rungs, s)
                      : launch<false, 1>(e, x, o, m, r, D, Hm, M, thr_sq, jmin, n_rungs, s);
  return zmode == 0 ? launch<true, 0>(e, x, o, m, r, D, Hm, M, thr_sq, jmin, n_rungs, s)
                    : launch<true, 1>(e, x, o, m, r, D, Hm, M, thr_sq, jmin, n_rungs, s);
}

}  // namespace

// E (Hm,12), xh (4,M), obs (2,M), mask (M,) float32 -> rank (Hm,) float32.
// zmode 0 = "pos", 1 = "nonzero". Returns the launch's cudaError_t.
extern "C" int coloc_ransac_rank(const void* E, const void* xh, const void* obs,
                                 const void* mask, void* rank, int Hm, int M, float thr_sq,
                                 int jmin, int n_rungs, int zmode, int device, void* stream) {
  return launch_any(E, xh, obs, mask, rank, 1, Hm, M, thr_sq, jmin, n_rungs, zmode, device,
                    stream);
}

// The same over a drone axis: E (D,Hm,12), xh (D,4,M), obs (D,2,M), mask
// (D,M) -> rank (D,Hm), one launch (grid z = D, at most 65535).
extern "C" int coloc_ransac_rank_batched(const void* E, const void* xh, const void* obs,
                                         const void* mask, void* rank, int D, int Hm, int M,
                                         float thr_sq, int jmin, int n_rungs, int zmode,
                                         int device, void* stream) {
  return launch_any(E, xh, obs, mask, rank, D, Hm, M, thr_sq, jmin, n_rungs, zmode, device,
                    stream);
}
