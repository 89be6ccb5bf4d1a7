// Durand-Kerner roots of the five-point solver's degree-10 polynomials.
//
// Replaces coloc_tpu/geometry/fivept.py::_dk_kernel (Pallas, launched by
// _dk_roots_batch). Input: B monic, rescaled ascending coefficient rows
// (the normalisation runs in PyTorch before the launch, as it runs in XLA
// before the Pallas call) and the rescale factor s. A lane a root: root k
// of polynomial b lives in lane k of a group of 10 lanes, three groups a
// warp (lanes 30-31 repeat 20-21). In explicit real/imaginary floats,
// each lane:
//   z_k = (0.4 + 0.9i)^(k+1);
//   24 times: read the group's old z_j by __shfl_sync (Jacobi: every read
//   before any write), then z_k -= p(z_k) / (prod_{j != k} (z_k - z_j)
//   + 1e-20 on |.|^2), the product over j = 0..9 in order with 1 + 0i at
//   j == k;
//   x = Re z, 3 real Newton steps x -= p(x) / (p'(x) + 1e-12);
//   real iff |Im z| < 0.5 (|Re z| + 1) and x finite; root = x * s.
// Every formula repeats geometry/fivept.py::dk_roots_plain operation for
// operation (-fmad=false), so kernel and twin agree bit for bit. The TPU
// kernel's six inert pad rows do not exist here.
//
// Bound: 24 iterations x 10 roots x ~100 flops = ~25 kFLOP a polynomial,
// 6.4 MFLOP at B = 256: 0.1 us at the fp32 peak; 12 KB of inputs and
// outputs. The time is one lane's chain, ~24 x (Horner's 10 complex steps
// beside the product's 10) plus the launch: a lane a root holds one root's
// work, and 86 warps share the card at B = 256.
#include "common.cuh"

namespace {

constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroups = 3;   // polynomials a warp, 10 lanes each
constexpr int kIters = 24;
constexpr int kNewton = 3;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
dk_kernel(const float* __restrict__ coef, const float* __restrict__ scale,
          float* __restrict__ roots, unsigned char* __restrict__ is_real, int B) {
  const int lane = threadIdx.x & 31;
  // lanes 30-31 repeat lanes 20-21 bit for bit and store nothing: as a
  // group of their own (lanes 30, 31, 0-7) they would hold equal seeds,
  // divide by 1e-20 into inf and NaN, and send the whole warp through the
  // division's slow path every iteration
  const int g = min(lane / 10, kGroups - 1), k = lane < 30 ? lane - 10 * g : lane - 30;
  const int base = 10 * g;
  const int b = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kGroups + g;
  // groups past B read polynomial 0 and store nothing; they stay for the
  // shuffles
  const bool live = lane < 30 && b < B;
  const int bl = live ? b : 0;
  float c[11];
#pragma unroll
  for (int i = 0; i < 11; ++i) c[i] = __ldg(coef + i * B + bl);

  // z_k = (0.4 + 0.9i)^(k+1), the twin's recurrence
  float zr = 0.4f, zi = 0.9f;
#pragma unroll
  for (int n = 1; n < 10; ++n) {
    const float tr = zr * 0.4f - zi * 0.9f;
    const float ti = zr * 0.9f + zi * 0.4f;
    if (n <= k) {
      zr = tr;
      zi = ti;
    }
  }

#pragma unroll 1
  for (int it = 0; it < kIters; ++it) {
    float ozr[10], ozi[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      ozr[j] = __shfl_sync(kFull, zr, base + j);
      ozi[j] = __shfl_sync(kFull, zi, base + j);
    }
    float pr = c[10], pi = 0.0f;
#pragma unroll
    for (int i = 9; i >= 0; --i) {
      const float tr = pr * zr - pi * zi + c[i];
      const float ti = pr * zi + pi * zr;
      pr = tr;
      pi = ti;
    }
    float dr = 1.0f, di = 0.0f;
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const float wr = j == k ? 1.0f : zr - ozr[j];
      const float wi = j == k ? 0.0f : zi - ozi[j];
      const float tr = dr * wr - di * wi;
      const float ti = dr * wi + di * wr;
      dr = tr;
      di = ti;
    }
    const float den = dr * dr + di * di + 1e-20f;
    const float nr = zr - (pr * dr + pi * di) / den;
    const float ni = zi - (pi * dr - pr * di) / den;
    zr = nr;
    zi = ni;
  }

  float x = zr;
#pragma unroll
  for (int n = 0; n < kNewton; ++n) {
    float pr = c[10], pi = 0.0f;
#pragma unroll
    for (int i = 9; i >= 0; --i) {
      const float tr = pr * x - pi * 0.0f + c[i];
      const float ti = pr * 0.0f + pi * x;
      pr = tr;
      pi = ti;
    }
    float dacc = 10.0f * c[10];
#pragma unroll
    for (int i = 9; i >= 1; --i) dacc = dacc * x + static_cast<float>(i) * c[i];
    x = x - pr / (dacc + 1e-12f);
  }
  if (!live) return;
  const bool finite = isfinite(x);
  is_real[k * B + b] = (fabsf(zi) < 0.5f * (fabsf(zr) + 1.0f)) && finite;
  roots[k * B + b] = x * scale[b];
}

}  // namespace

// coef (11, B), scale (B,) float32 -> roots (10, B) float32, is_real (10, B)
// bool. Returns the launch's cudaError_t.
extern "C" int coloc_fivept_dk(const void* coef, const void* scale, void* roots,
                               void* is_real, int B, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  constexpr int per_cta = kWarps * kGroups;
  dk_kernel<<<(B + per_cta - 1) / per_cta, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coef), static_cast<const float*>(scale),
      static_cast<float*>(roots), static_cast<unsigned char*>(is_real), B);
  return cudaGetLastError();
}
