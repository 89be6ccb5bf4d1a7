// Batched Grunert P3P: four lanes a minimal sample, one a root -> 4 poses.
//
// Replaces coloc_tpu/geometry/p3p.py::_p3p_kernel (Pallas, launched by
// _p3p_flats_pallas for p3p_flats_batch). The TPU kernel runs one sample per
// vector lane with every intermediate in VMEM; here four adjacent lanes run
// one sample with every intermediate in registers. The arithmetic is the TPU
// kernel's, constant for constant and in the same evaluation order: the
// quartic coefficients, Ferrari's closed form with the polynomial acos
// (_acos_poly, not acosf) seeding the resolvent cubic, cbrt as
// sign(x)|x|^(1/3), the 1e-12 / 1e-20 / 1e-9 guards, 2 Newton steps on the
// cubic and 2 on the quartic, the realness tolerance 1e-3 (1 + s^2 + |half|
// + |qs|), and the triad Horn alignment with the world triad hoisted out of
// the root loop. Every value is computed by the same operations as in the
// one-thread-a-sample form this replaces (IEEE division and sqrtf, powf,
// cosf, -fmad=false), so the flats and valid flags are the same bits.
// The plain twin is geometry/p3p.py::p3p_flats_plain.
//
// Bound: ~1.5k flops and 72 bytes in, 200 bytes out a sample; at B=256 the
// launch is far from any throughput limit: its time is one sample's chain
// of dependent divisions, square roots and transcendentals plus the launch.
// Design, to shorten that chain:
//   - lane r of a sample's four takes Ferrari root r: its two quartic
//     Newton steps, u, s1, the camera-side triad, the rotation, the centre
//     and the valid flag, and writes its 12 floats as three 16-byte stores,
//     so a sample's 192 bytes leave from four adjacent lanes;
//   - the prefix up to the resolvent is one dependent chain that every lane
//     runs; of its long independent pieces, the two cbrt terms (the same
//     code on two arguments) are split over the lane pairs and exchanged
//     with __shfl_sync. The trigonometric branch and the world triad are
//     distinct code: on one lane of four they would cost the warp the same
//     issue slots as on all four, and serialise behind the cbrt branch, so
//     every lane computes them inside the converged stream, where the
//     compiler overlaps them with the divisions of the prefix;
//   - CTAs of one warp (8 samples), so B=256 runs on 32 SMs.
// Lanes past B compute sample B-1 and store nothing: every lane of the warp
// takes part in the shuffles.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using coloc::nan_clip;
using coloc::nan_max;
using coloc::nan_min;
using coloc::sign_of;

constexpr int kThreads = 32;  // a warp a CTA: 8 samples

struct V3 {
  float v[3];
};

__device__ __forceinline__ V3 sub(const V3& a, const V3& b) {
  return V3{{a.v[0] - b.v[0], a.v[1] - b.v[1], a.v[2] - b.v[2]}};
}
__device__ __forceinline__ float dot(const V3& a, const V3& b) {
  return a.v[0] * b.v[0] + a.v[1] * b.v[1] + a.v[2] * b.v[2];
}
__device__ __forceinline__ V3 cross(const V3& a, const V3& b) {
  return V3{{a.v[1] * b.v[2] - a.v[2] * b.v[1], a.v[2] * b.v[0] - a.v[0] * b.v[2],
             a.v[0] * b.v[1] - a.v[1] * b.v[0]}};
}
__device__ __forceinline__ V3 scale(const V3& a, float s) {
  return V3{{a.v[0] * s, a.v[1] * s, a.v[2] * s}};
}
__device__ __forceinline__ V3 unit(const V3& a) {
  const float n = sqrtf(dot(a, a)) + 1e-12f;
  return V3{{a.v[0] / n, a.v[1] / n, a.v[2] / n}};
}
// orthonormal frame (columns u1, u2, u3) of three points
__device__ __forceinline__ void triad(const V3& p1, const V3& p2, const V3& p3, V3& u1,
                                      V3& u2, V3& u3) {
  u1 = unit(sub(p2, p1));
  u2 = unit(cross(u1, sub(p3, p1)));
  u3 = cross(u1, u2);
}

// Abramowitz & Stegun 4.4.45, as coloc_tpu/geometry/p3p.py::_acos_poly
__device__ __forceinline__ float acos_poly(float x) {
  const float ax = fabsf(x);
  const float p = ((-0.0187293f * ax + 0.0742610f) * ax - 0.2121144f) * ax + 1.5707288f;
  const float r = sqrtf(nan_max(1.0f - ax, 0.0f)) * p;
  return x < 0.0f ? 3.14159265358979f - r : r;
}

// Division by a constant is multiplication by its float32 reciprocal, as
// the reference's compiled kernel evaluates it (XLA rewrites x / c into
// x * (1/c) and folds 2 x / 27 into x * (2/27)); the plain twin does the same.
constexpr float kThird = 0.333333343f;      // float32(1/3)
constexpr float kTwo27ths = 0.0740740746f;  // float32(2/27)

__device__ __forceinline__ float cbrt_signed(float x) {
  return sign_of(x) * powf(fabsf(x), 1.0f / 3.0f);
}

__global__ void __launch_bounds__(kThreads)
p3p_kernel(const float* __restrict__ xw, const float* __restrict__ br,
           float* __restrict__ flats, bool* __restrict__ valid, int B) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const int b = lane >> 2;       // the sample
  const int ridx = lane & 3;     // the root this lane takes
  const int first = threadIdx.x & ~3;  // the sample's lane 0 in the warp
  const int bs = min(b, B - 1);  // lanes past B recompute the last sample
  V3 P[3], F[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      P[i].v[j] = xw[bs * 9 + 3 * i + j];
      F[i].v[j] = br[bs * 9 + 3 * i + j];
    }

  const float a2 = dot(sub(P[1], P[2]), sub(P[1], P[2]));
  const float b2 = nan_max(dot(sub(P[0], P[2]), sub(P[0], P[2])), 1e-12f);
  const float c2 = dot(sub(P[0], P[1]), sub(P[0], P[1]));
  const float cos_a = dot(F[1], F[2]);
  const float cos_b = dot(F[0], F[2]);
  const float cos_g = dot(F[0], F[1]);
  const float ab = a2 / b2;
  const float cb = c2 / b2;

  const float N0 = -(1.0f + ab - cb), N1 = 2.0f * cos_b * (ab - cb), N2 = (1.0f - ab + cb);
  const float D0 = -2.0f * cos_g, D1 = 2.0f * cos_a;
  const float K0 = (1.0f - cb), K1c = 2.0f * cb * cos_b, K2 = -cb;

  const float NN[5] = {N0 * N0, 2.0f * N0 * N1, N1 * N1 + 2.0f * N0 * N2, 2.0f * N1 * N2,
                       N2 * N2};
  const float ND[4] = {N0 * D0, N0 * D1 + N1 * D0, N1 * D1 + N2 * D0, N2 * D1};
  const float DD[3] = {D0 * D0, 2.0f * D0 * D1, D1 * D1};
  const float KDD[5] = {K0 * DD[0], K0 * DD[1] + K1c * DD[0],
                        K0 * DD[2] + K1c * DD[1] + K2 * DD[0], K1c * DD[2] + K2 * DD[1],
                        K2 * DD[2]};
  float q[5];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = NN[k] - 2.0f * cos_g * ND[k] + KDD[k];
  q[4] = NN[4] + KDD[4];

  // Ferrari closed form
  float lead = q[4];
  lead = fabsf(lead) < 1e-20f ? 1e-20f : lead;
  float c[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) c[k] = q[k] / lead;
  const float a3q = c[3], a2q = c[2], a1q = c[1], a0q = c[0];
  const float a3q_2 = a3q * a3q;
  const float sh = a3q / 4.0f;
  const float p = a2q - 3.0f * a3q * a3q / 8.0f;
  const float qd = a1q - a3q * a2q / 2.0f + a3q * a3q_2 / 8.0f;
  const float r = a0q - a3q * a1q / 4.0f + a3q * a3q * a2q / 16.0f -
                  3.0f * (a3q_2 * a3q_2) / 256.0f;
  const float cbq = p;
  const float ccq = p * p / 4.0f - r;
  const float cdq = -qd * qd / 8.0f;
  const float Pq = ccq - cbq * cbq * kThird;
  const float Qq = cdq - cbq * ccq * kThird + (cbq * (cbq * cbq)) * kTwo27ths;
  const float Qh = Qq / 2.0f, P3 = Pq * kThird;
  const float disc = Qh * Qh + P3 * (P3 * P3);
  const float Pn = nan_min(Pq, -1e-20f);
  const float theta = acos_poly(nan_clip((3.0f * Qq) / (2.0f * Pn) * sqrtf(-3.0f / Pn), -1.0f, 1.0f));
  const float w_trig = 2.0f * sqrtf(-Pn * kThird) * cosf(theta * kThird);
  const float sq = sqrtf(nan_max(disc, 0.0f));
  // the two cbrt terms, cbrt(-Qq/2 + sq) on lanes 0 and 2 and cbrt(-Qq/2 -
  // sq) on lanes 1 and 3 (x - sq is x + (-sq) in IEEE arithmetic)
  float cbrt_term = 0.0f;
  if (disc > 0.0f) cbrt_term = cbrt_signed(-Qq / 2.0f + ((ridx & 1) ? -sq : sq));
  const float cbrt_plus = __shfl_sync(0xffffffffu, cbrt_term, first);
  const float cbrt_minus = __shfl_sync(0xffffffffu, cbrt_term, first + 1);
  const float w = disc > 0.0f ? cbrt_plus + cbrt_minus : w_trig;
  float m = w - cbq * kThird;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const float f_m = ((m + cbq) * m + ccq) * m + cdq;
    const float df_m = (3.0f * m + 2.0f * cbq) * m + ccq;
    m = m - f_m / (fabsf(df_m) < 1e-12f ? 1e-12f : df_m);
  }
  m = nan_max(m, 0.0f);
  const float s = sqrtf(2.0f * m + 1e-20f);
  const float half = (p + 2.0f * m) / 2.0f;
  const float qs = qd / (2.0f * s);
  // roots 0, 1 from A4 = half - qs, roots 2, 3 from B4 = half + qs:
  // y = (-s +- rA) / 2 and (s +- rB) / 2
  const float AB4 = ridx < 2 ? half - qs : half + qs;
  const float d = s * s - 4.0f * AB4;
  const float rd = sqrtf(nan_max(d, 0.0f));
  const float root_y = ((ridx < 2 ? -s : s) + ((ridx & 1) ? -rd : rd)) / 2.0f;
  const float tol = 1e-3f * (1.0f + s * s + fabsf(half) + fabsf(qs));
  const bool realness = d > -tol;

  // root-independent pieces of the Horn alignment
  V3 A1, A2, A3;
  triad(P[0], P[1], P[2], A1, A2, A3);
  V3 meanP;
#pragma unroll
  for (int k = 0; k < 3; ++k) meanP.v[k] = (P[0].v[k] + P[1].v[k] + P[2].v[k]) * kThird;

  float x = root_y - sh;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const float poly = ((((x + c[3]) * x + c[2]) * x + c[1]) * x) + c[0];
    const float dpoly = ((4.0f * x + 3.0f * c[3]) * x + 2.0f * c[2]) * x + c[1];
    x = x - poly / (dpoly + 1e-12f);
  }
  const bool is_real = realness && isfinite(x);
  const float v = x;
  const float Nv = (N2 * v + N1) * v + N0;
  const float Dv = D1 * v + D0;
  const float u = Nv / (fabsf(Dv) < 1e-9f ? 1e-9f : Dv);
  const float s1sq = b2 / nan_max(1.0f + v * v - 2.0f * v * cos_b, 1e-12f);
  const float s1 = sqrtf(s1sq);
  const float s2 = u * s1;
  const float s3 = v * s1;
  const V3 X1 = scale(F[0], s1), X2 = scale(F[1], s2), X3 = scale(F[2], s3);
  V3 B1, B2, B3;
  triad(X1, X2, X3, B1, B2, B3);
  float o[12];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = B1.v[i] * A1.v[j] + B2.v[i] * A2.v[j] + B3.v[i] * A3.v[j];
  V3 meanX;
#pragma unroll
  for (int k = 0; k < 3; ++k) meanX.v[k] = (X1.v[k] + X2.v[k] + X3.v[k]) * kThird;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    o[9 + j] = meanP.v[j] - (o[j] * meanX.v[0] + o[3 + j] * meanX.v[1] + o[6 + j] * meanX.v[2]);
  if (b < B) {
    // 48 floats a sample, 12 a root: 16-byte aligned for an aligned base
    float4* out = reinterpret_cast<float4*>(flats + static_cast<size_t>(b) * 48 + ridx * 12);
    out[0] = make_float4(o[0], o[1], o[2], o[3]);
    out[1] = make_float4(o[4], o[5], o[6], o[7]);
    out[2] = make_float4(o[8], o[9], o[10], o[11]);
    valid[b * 4 + ridx] = (v > 0.0f) && (u > 0.0f) && (s1 > 0.0f) && is_real;
  }
}

}  // namespace

// xw, br (B,3,3) float32 (row i = point / bearing i) -> flats (B,4,12)
// row-major R | C, valid (B,4) bool. flats is written 16 bytes at a time,
// so it must be 16-byte aligned (a PyTorch allocation is). Returns the
// launch's cudaError_t.
extern "C" int coloc_p3p(const void* xw, const void* br, void* flats, void* valid, int B,
                         int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(flats) % 16 != 0) return cudaErrorMisalignedAddress;
  const int lanes = 4 * B;
  p3p_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xw), static_cast<const float*>(br), static_cast<float*>(flats),
      static_cast<bool*>(valid), B);
  return cudaGetLastError();
}
