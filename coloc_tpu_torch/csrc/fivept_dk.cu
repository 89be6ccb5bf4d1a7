// Durand-Kerner roots of the five-point solver's degree-10 polynomials.
//
// Replaces coloc_tpu/geometry/fivept.py::_dk_kernel (Pallas, launched by
// _dk_roots_batch). Input: B monic, rescaled ascending coefficient rows
// (the normalisation runs in PyTorch before the launch, as it runs in XLA
// before the Pallas call) and the rescale factor s. Per polynomial (one
// thread each), in explicit real/imaginary floats:
//   z_k = (0.4 + 0.9i)^(k+1), k = 0..9;
//   24 times, for all k at once: z_k -= p(z_k) / (prod_{j != k} (z_k - z_j)
//   + 1e-20 on |.|^2);
//   x = Re z, 3 real Newton steps x -= p(x) / (p'(x) + 1e-12);
//   real iff |Im z| < 0.5 (|Re z| + 1) and x finite; root = x * s.
// Every formula repeats geometry/fivept.py::dk_roots_plain operation for
// operation (-fmad=false), so kernel and twin agree bit for bit. The TPU
// kernel's six inert pad rows do not exist here.
//
// Bound: 24 iterations x 10 roots x ~100 flops (Horner 40, product of
// differences 60, the update 15) = ~25 kFLOP a polynomial, 6.4 MFLOP at
// B = 256: 0.1 us at the fp32 peak; 12 KB of inputs and outputs. B = 256
// threads are a fraction of one SM's issue width, so the time is one
// thread's chain of ~25 k dependent operations plus the launch. The design
// keeps all 10 roots of a polynomial in one thread's registers (no shuffles,
// no shared memory): latency is what a second design would attack, by
// spreading a polynomial's 10 roots over 10 lanes.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kIters = 24;
constexpr int kNewton = 3;

__global__ void __launch_bounds__(kThreads)
dk_kernel(const float* __restrict__ coef, const float* __restrict__ scale,
          float* __restrict__ roots, unsigned char* __restrict__ is_real, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float c[11];
  for (int i = 0; i < 11; ++i) c[i] = coef[i * B + b];

  float zr[10], zi[10];
  zr[0] = 0.4f;
  zi[0] = 0.9f;
  for (int k = 1; k < 10; ++k) {
    zr[k] = zr[k - 1] * 0.4f - zi[k - 1] * 0.9f;
    zi[k] = zr[k - 1] * 0.9f + zi[k - 1] * 0.4f;
  }

  for (int it = 0; it < kIters; ++it) {
    float nr[10], ni[10];
    for (int k = 0; k < 10; ++k) {
      float pr = c[10], pi = 0.0f;
      for (int i = 9; i >= 0; --i) {
        const float tr = pr * zr[k] - pi * zi[k] + c[i];
        const float ti = pr * zi[k] + pi * zr[k];
        pr = tr;
        pi = ti;
      }
      float dr = 1.0f, di = 0.0f;
      for (int j = 0; j < 10; ++j) {
        const float wr = j == k ? 1.0f : zr[k] - zr[j];
        const float wi = j == k ? 0.0f : zi[k] - zi[j];
        const float tr = dr * wr - di * wi;
        const float ti = dr * wi + di * wr;
        dr = tr;
        di = ti;
      }
      const float den = dr * dr + di * di + 1e-20f;
      nr[k] = zr[k] - (pr * dr + pi * di) / den;
      ni[k] = zi[k] - (pi * dr - pr * di) / den;
    }
    for (int k = 0; k < 10; ++k) {
      zr[k] = nr[k];
      zi[k] = ni[k];
    }
  }

  const float s = scale[b];
  for (int k = 0; k < 10; ++k) {
    float x = zr[k];
    for (int n = 0; n < kNewton; ++n) {
      float pr = c[10], pi = 0.0f;
      for (int i = 9; i >= 0; --i) {
        const float tr = pr * x - pi * 0.0f + c[i];
        const float ti = pr * 0.0f + pi * x;
        pr = tr;
        pi = ti;
      }
      float dacc = 10.0f * c[10];
      for (int i = 9; i >= 1; --i) dacc = dacc * x + static_cast<float>(i) * c[i];
      x = x - pr / (dacc + 1e-12f);
    }
    const bool finite = isfinite(x);
    is_real[k * B + b] = (fabsf(zi[k]) < 0.5f * (fabsf(zr[k]) + 1.0f)) && finite;
    roots[k * B + b] = x * s;
  }
}

}  // namespace

// coef (11, B), scale (B,) float32 -> roots (10, B) float32, is_real (10, B)
// bool. Returns the launch's cudaError_t.
extern "C" int coloc_fivept_dk(const void* coef, const void* scale, void* roots,
                               void* is_real, int B, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  dk_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coef), static_cast<const float*>(scale),
      static_cast<float*>(roots), static_cast<unsigned char*>(is_real), B);
  return cudaGetLastError();
}
