// Pose-only Levenberg-Marquardt and its covariance: sfm/ba.py's
// pose_lm_steps and pose_lm_finish for CUDA tensors, one lane (a drone or a
// stream) a CTA.
//
// Replaces no Pallas kernel. coloc_tpu runs this LM as XLA ops inside a
// lax.while_loop (coloc_tpu/sfm/ba.py refine_pose_only), which XLA fuses. In
// the port the same loop as PyTorch ops launched ~175 kernels an iteration
// and ~360 for the covariance, among them one-tile batched GEMMs of 2x3 @
// 3x6 a correspondence and the cyclic Jacobi's 90 batched 6x6 products: in
// the captured frame step those launches, not the arithmetic, took the
// device's time. The plain twins are ba._pose_lm_steps_plain and
// ba._pose_lm_finish_plain (the CPU path). This file repeats their
// arithmetic in float32 under -fmad=false, formula for formula: the clamped
// perspective divide and its `through_z` cut, radial k1..k3, the Huber
// sqrt-weight times the inlier mask (so a masked point contributes J * 0,
// NaN where the twin's is NaN), Marquardt damping on the clamped diagonal,
// the 1e-12 ridge, Cholesky with two triangular solves (a failed pivot or a
// non-finite entry gives a zero step entry), so3.exp with its series below
// theta^2 = 1e-8, and the exits and damping updates in the twin's order.
// Sums run in another order than cuBLAS's, so U and g differ from the
// twin's at float32 rounding.
//
// Bound: a pass reads 21 bytes a correspondence (X, uv, the inlier flag)
// and does ~250 flops on it: at the session's D = 2, L = 5000 a call's bytes
// and flops take well under a microsecond of the card. What bounds the
// kernel is latency: n dependent iterations, each a pass over the lane's
// points, a block reduction and a serial 6x6 solve.
// Design:
//   - one CTA a lane, its state in shared memory for the call's n
//     iterations; the host reads nothing and the launch is captured as it
//     is;
//   - a pass linearizes every point at a pose and reduces U's 21 upper
//     entries, g and the cost in a fixed order (each thread over its points
//     in index order, a shuffle butterfly in the warp, the warps in order):
//     no atomics, two launches give the same bits;
//   - the pass at the candidate pose computes the whole linearization, not
//     only its cost: an accepted step keeps it as the next iteration's, so an
//     iteration costs one pass where the twin makes two, with the same
//     results (the same function of the same pose);
//   - thread 0 solves the damped system, takes so3.exp and keeps the LM's
//     bookkeeping;
//   - 512 threads a CTA at every L: on the H100 it was as fast as 256 at
//     L = 1024 and the fastest at 5000 (PERF.md's kernel table);
//   - a stopped lane, or an iteration past max_iterations, runs no pass and
//     changes nothing but `it`, so n = 3 twice gives the bits of n = 6 once.
// pose_cov_kernel: one pass at the solution (the undamped U, the masked
// squared residuals, the inlier count), then warp 0 runs the cyclic Jacobi
// of ba._jacobi_eigh (lane 6 k + i updates row and column i of round pair k)
// and forms V diag(1 / max(lambda, floor)) V^T and the rmse.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using coloc::nan_clip;
using coloc::nan_max;
using coloc::nan_min;

// ba._DIAG_MIN, _DIAG_MAX, _STEP_TOL, _JACOBI_SWEEPS, _JACOBI_ROUNDS
constexpr float kDiagMin = 1e-6f;
constexpr float kDiagMax = 1e32f;
constexpr float kStepTol = 1e-5f;
constexpr int kJacobiSweeps = 6;
__constant__ int kRoundP[5][3] = {{0, 2, 4}, {0, 1, 3}, {0, 1, 2}, {0, 1, 2}, {0, 1, 3}};
__constant__ int kRoundQ[5][3] = {{1, 3, 5}, {2, 4, 5}, {3, 5, 4}, {4, 3, 5}, {5, 2, 4}};

constexpr int kLin = 28;  // U's 21 upper entries (row-major), g's 6 sums, the cost
constexpr int kCov = 23;  // U's 21 upper entries, sum of masked r^2, the inlier count
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Cam {
  float fx, fy, cx, cy, k1, k2, k3;
};

__device__ __forceinline__ Cam load_cam(const float* K, const float* dist, int d) {
  const float* k = K + 9 * d;
  const float* c = dist + 3 * d;
  return Cam{__ldg(k + 0), __ldg(k + 4), __ldg(k + 2), __ldg(k + 5),
             __ldg(c + 0), __ldg(c + 1), __ldg(c + 2)};
}

// One point through the pose (R, C): ba._jacobians' weighted pose Jacobian
// Jw (2x6), weighted residual rw, the squared residual and the weight
// (Huber sqrt-weight times the inlier mask).
struct Point {
  float Jw[2][6];
  float rw[2];
  float res_sq;
  float mask;
};

__device__ __forceinline__ Point linearize(const float (&R)[9], const float (&C)[3],
                                           const Cam& cam, const float* X, const float* uv,
                                           const bool* inl, int l, float delta_sq) {
  const float d0 = __ldg(X + 3 * l) - C[0];
  const float d1 = __ldg(X + 3 * l + 1) - C[1];
  const float d2 = __ldg(X + 3 * l + 2) - C[2];
  // Xc = (X - C) @ R^T
  const float x0 = R[0] * d0 + R[1] * d1 + R[2] * d2;
  const float x1 = R[3] * d0 + R[4] * d1 + R[5] * d2;
  const float z = R[6] * d0 + R[7] * d1 + R[8] * d2;
  const float zc = nan_max(z, 1e-9f);
  // the residual: camera.project_cam (a divide) - uv
  float r0, r1;
  {
    const float x = x0 / zc, y = x1 / zc;
    const float r2 = x * x + y * y;
    const float fac = 1.0f + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3));
    r0 = (x * fac) * cam.fx + cam.cx - __ldg(uv + 2 * l);
    r1 = (y * fac) * cam.fy + cam.cy - __ldg(uv + 2 * l + 1);
  }
  // the Jacobian: the clamped divide (inv), radial distortion, pose
  const float inv = 1.0f / zc;
  const float x = x0 * inv, y = x1 * inv;
  const float r2 = x * x + y * y;
  const float dfac = cam.k1 + r2 * (2.0f * cam.k2 + 3.0f * cam.k3 * r2);
  const float fac = 1.0f + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3));
  const float tz = z > 1e-9f ? inv : 0.0f;          // the clamp cuts dz
  const float dxy[2][3] = {{inv, 0.0f, -x * tz}, {0.0f, inv, -y * tz}};
  const float xy[2] = {x, y};
  const float f[2] = {cam.fx, cam.fy};
  float dpix[2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float dd0 = fac * (a == 0 ? 1.0f : 0.0f) + 2.0f * dfac * xy[a] * xy[0];
    const float dd1 = fac * (a == 1 ? 1.0f : 0.0f) + 2.0f * dfac * xy[a] * xy[1];
#pragma unroll
    for (int c = 0; c < 3; ++c) dpix[a][c] = f[a] * (dd0 * dxy[0][c] + dd1 * dxy[1][c]);
  }
  // d_pose = [-hat(Xc) | -R]
  const float dpose[3][6] = {
      {-0.0f, z, -x1, -R[0], -R[1], -R[2]},
      {-z, -0.0f, x0, -R[3], -R[4], -R[5]},
      {x1, -x0, -0.0f, -R[6], -R[7], -R[8]},
  };
  Point p;
  p.res_sq = r0 * r0 + r1 * r1;
  // Huber IRLS sqrt-weight
  const float w = p.res_sq <= delta_sq ? 1.0f : sqrtf(delta_sq / nan_max(p.res_sq, 1e-12f));
  p.mask = __ldg(reinterpret_cast<const unsigned char*>(inl) + l) ? 1.0f : 0.0f;
  const float wt = sqrtf(w) * p.mask;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const float J = dpix[a][0] * dpose[0][c] + dpix[a][1] * dpose[1][c]
                      + dpix[a][2] * dpose[2][c];
      p.Jw[a][c] = J * wt;
    }
  }
  p.rw[0] = r0 * wt;
  p.rw[1] = r1 * wt;
  return p;
}

// Sum v over the CTA in a fixed order into out[0..N) (shared memory): a
// shuffle butterfly in each warp, then thread k adds the warps' k-th sums in
// warp order. Every thread of the CTA calls it.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* part, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    v[k] = s;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) part[warp * N + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = part[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += part[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// The LM's pass: U (21 upper entries), the sums of Jw^T rw (g = -them) and
// the cost at (R, C), into out[kLin].
__device__ void lm_pass(const float* sR, const float* sC, const Cam& cam, const float* X,
                        const float* uv, const bool* inl, int L, float delta_sq, float* part,
                        float* out) {
  float R[9], C[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = sR[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) C[i] = sC[i];
  float acc[kLin];
#pragma unroll
  for (int k = 0; k < kLin; ++k) acc[k] = 0.0f;
  for (int l = threadIdx.x; l < L; l += kThreads) {
    const Point p = linearize(R, C, cam, X, uv, inl, l, delta_sq);
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) acc[k++] += p.Jw[0][i] * p.Jw[0][j] + p.Jw[1][i] * p.Jw[1][j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] += p.Jw[0][i] * p.rw[0] + p.Jw[1][i] * p.rw[1];
    acc[27] += p.rw[0] * p.rw[0] + p.rw[1] * p.rw[1];
  }
  block_sum<kLin>(acc, part, out);
}

// The damped step of one iteration from the pass's sums: Marquardt damping
// on the clamped diagonal, the 1e-12 ridge, Cholesky and the two triangular
// solves of ba._pose_lm_steps_plain. -> dp (6); an entry is 0 where the
// factorization failed (a pivot not > 0, LAPACK's test) or it is not finite.
__device__ void damped_step(const float* lin, float lam, float (&dp)[6]) {
  float A[6][6];
  {
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) {
        A[i][j] = lin[k];
        A[j][i] = lin[k];
        ++k;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    A[i][i] = (A[i][i] + lam * nan_clip(A[i][i], kDiagMin, kDiagMax)) + 1e-12f;
  float Lc[6][6];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= Lc[j][k] * Lc[j][k];
    ok = ok && s > 0.0f;
    Lc[j][j] = sqrtf(s);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= Lc[i][k] * Lc[j][k];
      Lc[i][j] = t / Lc[j][j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = -lin[21 + i];                         // g = -sum Jw^T rw
#pragma unroll
    for (int k = 0; k < i; ++k) t -= Lc[i][k] * y[k];
    y[i] = t / Lc[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) t -= Lc[k][i] * dp[k];
    dp[i] = t / Lc[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) dp[i] = (ok && isfinite(dp[i])) ? dp[i] : 0.0f;
}

// Rn = so3.exp(w) @ R (Rodrigues, the series below theta^2 = 1e-8)
__device__ void exp_times(const float* w, const float* R, float* Rn) {
  const float theta_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(theta_sq + 1e-12f);
  const bool big = theta_sq > 1e-8f;
  const float a = big ? sinf(theta) / theta : 1.0f - theta_sq / 6.0f;
  const float b = big ? (1.0f - cosf(theta)) / theta_sq : 0.5f - theta_sq / 24.0f;
  const float W[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]}, {-w[1], w[0], 0.0f}};
  float E[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float WW = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      E[i][j] = ((i == j ? 1.0f : 0.0f) + a * W[i][j]) + b * WW;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = E[i][0] * R[j] + E[i][1] * R[3 + j] + E[i][2] * R[6 + j];
  }
}

__global__ void __launch_bounds__(kThreads) pose_lm_kernel(
    const float* __restrict__ R_in, const float* __restrict__ C_in,
    const float* __restrict__ lam_in, const float* __restrict__ nu_in,
    const float* __restrict__ g0_in, const bool* __restrict__ active_in,
    const int* __restrict__ iters_in, const int* __restrict__ it_in,
    const float* __restrict__ X, const float* __restrict__ uv, const bool* __restrict__ inl,
    const float* __restrict__ K, const float* __restrict__ dist,
    float* __restrict__ R_out, float* __restrict__ C_out, float* __restrict__ lam_out,
    float* __restrict__ nu_out, float* __restrict__ g0_out, bool* __restrict__ active_out,
    int* __restrict__ iters_out, int* __restrict__ it_out,
    int D, int L, int n, int max_iter, float delta_sq, float rel_tol) {
  __shared__ float part[kWarps * kLin];
  __shared__ float lin[kLin], lin_n[kLin];        // at (R, C) and at (Rn, Cn)
  __shared__ float sR[9], sC[3], sRn[9], sCn[3];
  __shared__ float s_lam, s_nu, s_g0;
  __shared__ int s_iters, s_active;
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  const int it0 = __ldg(it_in);
  if (d == 0 && tid == 0) *it_out = it0 + n;
  if (d >= D) return;                             // D = 0: the grid's one CTA moves `it`
  X += static_cast<size_t>(d) * L * 3;
  uv += static_cast<size_t>(d) * L * 2;
  inl += static_cast<size_t>(d) * L;
  if (tid < 9) sR[tid] = R_in[9 * d + tid];
  if (tid < 3) sC[tid] = C_in[3 * d + tid];
  if (tid == 0) {
    s_lam = lam_in[d];
    s_nu = nu_in[d];
    s_g0 = g0_in[d];
    s_iters = iters_in[d];
    s_active = active_in[d] ? 1 : 0;
  }
  const Cam cam = load_cam(K, dist, d);
  __syncthreads();
  bool have_lin = false;                          // lin holds the pass at (sR, sC)
  for (int k = 0; k < n; ++k) {
    const int it = it0 + k;
    const bool active = s_active && it < max_iter;
    // a stopped lane changes nothing; at it == 0 the twin still sets g0
    if (!active && it != 0) continue;
    if (!have_lin) {
      lm_pass(sR, sC, cam, X, uv, inl, L, delta_sq, part, lin);
      have_lin = true;
    }
    float dp[6];
    if (tid == 0) {
      damped_step(lin, s_lam, dp);
      exp_times(dp, sR, sRn);
#pragma unroll
      for (int i = 0; i < 3; ++i) sCn[i] = sC[i] + dp[3 + i];
    }
    __syncthreads();
    lm_pass(sRn, sCn, cam, X, uv, inl, L, delta_sq, part, lin_n);
    if (tid == 0) {
      const float cost = lin[27], new_cost = lin_n[27];
      const bool accept = new_cost < cost;
      const float rel_improve = (cost - new_cost) / nan_max(cost, 1e-12f);
      bool done = accept && rel_improve < rel_tol;
      // gradient tolerance, relative to the first iteration's gradient
      float g_norm = fabsf(lin[21]);
#pragma unroll
      for (int i = 1; i < 6; ++i) g_norm = nan_max(g_norm, fabsf(lin[21 + i]));
      if (it == 0) s_g0 = g_norm;
      done = done || g_norm <= 1e-6f * s_g0 + 1e-12f;
      // parameter tolerance
      float dp_sq = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i) dp_sq += dp[i] * dp[i];
      const float c_norm = sqrtf(sC[0] * sC[0] + sC[1] * sC[1] + sC[2] * sC[2] + 1.0f);
      done = done || sqrtf(dp_sq) <= kStepTol * (c_norm + kStepTol);
      // Nielsen-style escalation on consecutive rejections
      const float lam_new = accept ? nan_max(s_lam / 3.0f, 1e-8f) : nan_min(s_lam * s_nu, 1e8f);
      const float nu_new = accept ? 4.0f : nan_min(s_nu * 2.0f, 1e4f);
      if (active && accept) {
#pragma unroll
        for (int i = 0; i < 9; ++i) sR[i] = sRn[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) sC[i] = sCn[i];
#pragma unroll
        for (int i = 0; i < kLin; ++i) lin[i] = lin_n[i];
      }
      if (active) {
        s_lam = lam_new;
        s_nu = nu_new;
        s_iters += 1;
      }
      s_active = active && !(done || lam_new >= 1e8f);
    }
    __syncthreads();
  }
  if (tid < 9) R_out[9 * d + tid] = sR[tid];
  if (tid < 3) C_out[3 * d + tid] = sC[tid];
  if (tid == 0) {
    lam_out[d] = s_lam;
    nu_out[d] = s_nu;
    g0_out[d] = s_g0;
    iters_out[d] = s_iters;
    // the twin's `active &= it < max_iterations` of the iterations skipped
    active_out[d] = s_active != 0 && (n == 0 || it0 + n - 1 < max_iter);
  }
}

__global__ void __launch_bounds__(kThreads) pose_cov_kernel(
    const float* __restrict__ R_in, const float* __restrict__ C_in,
    const float* __restrict__ X, const float* __restrict__ uv, const bool* __restrict__ inl,
    const float* __restrict__ K, const float* __restrict__ dist, float* __restrict__ cov,
    float* __restrict__ rmse, int* __restrict__ n_obs, int L, float delta_sq) {
  __shared__ float part[kWarps * kCov];
  __shared__ float sums[kCov];
  __shared__ float A[36], V[36];
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  X += static_cast<size_t>(d) * L * 3;
  uv += static_cast<size_t>(d) * L * 2;
  inl += static_cast<size_t>(d) * L;
  const Cam cam = load_cam(K, dist, d);
  float R[9], C[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = __ldg(R_in + 9 * d + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) C[i] = __ldg(C_in + 3 * d + i);
  float acc[kCov];
#pragma unroll
  for (int k = 0; k < kCov; ++k) acc[k] = 0.0f;
  for (int l = tid; l < L; l += kThreads) {
    const Point p = linearize(R, C, cam, X, uv, inl, l, delta_sq);
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) acc[k++] += p.Jw[0][i] * p.Jw[0][j] + p.Jw[1][i] * p.Jw[1][j];
    }
    acc[21] += p.res_sq * p.mask;
    acc[22] += p.mask;      // an integer count, exact in float32 below 2^24
  }
  block_sum<kCov>(acc, part, sums);
  if (tid >= 32) return;
  // warp 0: the cyclic Jacobi of ba._jacobi_eigh on A = U
  const int lane = tid;
  for (int e = lane; e < 36; e += 32) {
    const int i = e / 6, j = e % 6;
    const int a = i <= j ? i : j, b = i <= j ? j : i;
    A[e] = sums[a * 6 - a * (a - 1) / 2 + (b - a)];   // upper entry (a, b)
    V[e] = i == j ? 1.0f : 0.0f;
  }
  __syncwarp();
  const bool on = lane < 18;
  const int pair = lane / 6, i = lane % 6;
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
    for (int round = 0; round < 5; ++round) {
      float c = 0.0f, s = 0.0f;
      int p = 0, q = 0;
      if (on) {
        p = kRoundP[round][pair];
        q = kRoundQ[round][pair];
        const float theta = 0.5f * atan2f(2.0f * A[6 * p + q], A[6 * q + q] - A[6 * p + p]);
        c = cosf(theta);
        s = sinf(theta);
      }
      __syncwarp();
      if (on) {                // rows p, q of J^T A (column i), and V J (row i)
        const float ap = A[6 * p + i], aq = A[6 * q + i];
        A[6 * p + i] = c * ap - s * aq;
        A[6 * q + i] = s * ap + c * aq;
        const float vp = V[6 * i + p], vq = V[6 * i + q];
        V[6 * i + p] = c * vp - s * vq;
        V[6 * i + q] = s * vp + c * vq;
      }
      __syncwarp();
      if (on) {                // columns p, q of (J^T A) J (row i)
        const float ap = A[6 * i + p], aq = A[6 * i + q];
        A[6 * i + p] = c * ap - s * aq;
        A[6 * i + q] = s * ap + c * aq;
      }
      __syncwarp();
    }
  }
  // ba._spd_inv_jacobi: the relative eigenvalue floor, V diag(1/lambda) V^T
  float amax = fabsf(A[0]);
#pragma unroll
  for (int j = 1; j < 6; ++j) amax = nan_max(amax, fabsf(A[7 * j]));
  const float floor_ = 1e-6f * amax + 1e-12f;
  float inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) inv[j] = 1.0f / nan_max(A[7 * j], floor_);
  for (int e = lane; e < 36; e += 32) {
    const int r = e / 6, k = e % 6;
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) t += (V[6 * r + j] * inv[j]) * V[6 * k + j];
    cov[36 * d + e] = t;
  }
  if (lane == 0) {
    const int n = static_cast<int>(sums[22]);
    n_obs[d] = n;
    rmse[d] = sqrtf(sums[21] / static_cast<float>(n > 1 ? n : 1));
  }
}

}  // namespace

// n masked LM iterations of D lanes. Pointers: the state in (R, C, lam, nu,
// g0, active, iterations, it), the problem (X, uv, inliers, K, dist), the
// state out (the same eight).
extern "C" int coloc_pose_lm(const void* R, const void* C, const void* lam, const void* nu,
                             const void* g0, const void* active, const void* iters,
                             const void* it, const void* X, const void* uv, const void* inl,
                             const void* K, const void* dist, void* R_o, void* C_o,
                             void* lam_o, void* nu_o, void* g0_o, void* active_o,
                             void* iters_o, void* it_o, int D, int L, int n, int max_iter,
                             float delta_sq, float rel_tol, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (D < 0 || L < 0 || n < 0) return cudaErrorInvalidValue;
  pose_lm_kernel<<<D > 0 ? D : 1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(C),
      static_cast<const float*>(lam), static_cast<const float*>(nu),
      static_cast<const float*>(g0), static_cast<const bool*>(active),
      static_cast<const int*>(iters), static_cast<const int*>(it),
      static_cast<const float*>(X), static_cast<const float*>(uv),
      static_cast<const bool*>(inl), static_cast<const float*>(K),
      static_cast<const float*>(dist), static_cast<float*>(R_o), static_cast<float*>(C_o),
      static_cast<float*>(lam_o), static_cast<float*>(nu_o), static_cast<float*>(g0_o),
      static_cast<bool*>(active_o), static_cast<int*>(iters_o), static_cast<int*>(it_o), D, L,
      n, max_iter, delta_sq, rel_tol);
  return cudaGetLastError();
}

// Covariance, rmse and inlier count of D lanes at (R, C).
extern "C" int coloc_pose_cov(const void* R, const void* C, const void* X, const void* uv,
                              const void* inl, const void* K, const void* dist, void* cov,
                              void* rmse, void* n_obs, int D, int L, float delta_sq,
                              int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (D < 0 || L < 0) return cudaErrorInvalidValue;
  if (D == 0) return cudaSuccess;
  pose_cov_kernel<<<D, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(C),
      static_cast<const float*>(X), static_cast<const float*>(uv),
      static_cast<const bool*>(inl), static_cast<const float*>(K),
      static_cast<const float*>(dist), static_cast<float*>(cov), static_cast<float*>(rmse),
      static_cast<int*>(n_obs), L, delta_sq);
  return cudaGetLastError();
}
