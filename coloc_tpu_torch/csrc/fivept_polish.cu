// Five-point solver polish: root seeds -> E candidates with a convergence
// certificate.
//
// Replaces coloc_tpu/geometry/fivept.py::_polish_kernel (Pallas, launched by
// _five_point_batch_pallas). Per seed z of a sample (30 a sample: each DK
// root and root +- 1%):
//   (x, y) from the three reduced equations by a 2x2 normal solve;
//   5 Gauss-Newton steps on the 10 cubic constraints, residual and Jacobian
//   from one (40 x 20) MD . monomials(x, y, z) contraction, a closed-form
//   adjugate 3x3 solve;
//   certificate: x, y, z finite and max |M . mono| < 1e-3 (1 + |xyz|^3);
//   E = x X + y Y + z Z + W, normalised; valid = seed valid & certificate.
// Every formula repeats geometry/fivept.py::polish_plain operation for
// operation (-fmad=false), so kernel and twin agree bit for bit.
//
// Design: one warp per sample, one lane per seed (lanes 30, 31 idle). The
// sample's MD (40 x 20, 3.2 KB), polynomial rows and null basis go to shared
// memory once per sample instead of once per seed; every lane then reads the
// same MD word at the same time (a shared-memory broadcast).
//
// Bound: per seed 6 contractions of 40 x 20 multiply-adds (~10 k flops) plus
// the solves: ~75 MFLOP at B = 256 (7680 seeds), 1.1 us at the fp32 peak;
// inputs 0.9 MB, outputs 0.3 MB, 0.36 us at 3.35 TB/s: compute-bound. 256
// blocks of one warp fill the 132 SMs about twice, with 1-2 warps an SM, so
// each warp's dependent chain (not the issue rate) sets the time.
#include "common.cuh"

namespace {

using coloc::nan_max;

constexpr int kSeeds = 30;
constexpr int kSteps = 5;

// the 20 monomials in Nistér's order, x^i y^j z^k: (i, j, k)
__constant__ int kMono[20][3] = {
    {3, 0, 0}, {0, 3, 0}, {2, 1, 0}, {1, 2, 0}, {2, 0, 1}, {2, 0, 0},
    {0, 2, 1}, {0, 2, 0}, {1, 1, 1}, {1, 1, 0},
    {1, 0, 2}, {1, 0, 1}, {1, 0, 0}, {0, 1, 2}, {0, 1, 1}, {0, 1, 0},
    {0, 0, 3}, {0, 0, 2}, {0, 0, 1}, {0, 0, 0}};

// product px[i] * py[j] * pz[k] in that order, constant factors skipped
// (a product with 1.0 is exact)
__device__ __forceinline__ void monomials(float x, float y, float z, float* mono) {
  const float px[4] = {1.0f, x, x * x, x * x * x};
  const float py[4] = {1.0f, y, y * y, y * y * y};
  const float pz[4] = {1.0f, z, z * z, z * z * z};
  for (int m = 0; m < 20; ++m) {
    const int i = kMono[m][0], j = kMono[m][1], k = kMono[m][2];
    float acc = 1.0f;
    bool first = true;
    if (i > 0) { acc = px[i]; first = false; }
    if (j > 0) { acc = first ? py[j] : acc * py[j]; first = false; }
    if (k > 0) { acc = first ? pz[k] : acc * pz[k]; }
    mono[m] = acc;
  }
}

__device__ __forceinline__ float contract(const float* md_row, const float* mono) {
  float acc = md_row[0] * mono[0];
  for (int k = 1; k < 20; ++k) acc = acc + md_row[k] * mono[k];
  return acc;
}

__global__ void __launch_bounds__(32)
polish_kernel(const float* __restrict__ md, const float* __restrict__ coef,
              const float* __restrict__ basis, const float* __restrict__ seeds,
              const unsigned char* __restrict__ svalid, float* __restrict__ Es,
              unsigned char* __restrict__ valid, int B) {
  __shared__ float s_md[800];
  __shared__ float s_coef[40];
  __shared__ float s_basis[36];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  for (int e = lane; e < 800; e += 32) s_md[e] = md[static_cast<size_t>(e) * B + b];
  for (int e = lane; e < 40; e += 32) s_coef[e] = coef[e * B + b];
  for (int e = lane; e < 36; e += 32) s_basis[e] = basis[e * B + b];
  __syncthreads();
  if (lane >= kSeeds) return;

  const float* c = s_coef;
  float z = seeds[lane * B + b];
  auto ev4 = [&](int o) { return ((c[o + 3] * z + c[o + 2]) * z + c[o + 1]) * z + c[o]; };
  auto ev5 = [&](int o) {
    return (((c[o + 4] * z + c[o + 3]) * z + c[o + 2]) * z + c[o + 1]) * z + c[o];
  };
  const float a00 = ev4(0), a01 = ev4(4);
  const float a10 = ev4(8), a11 = ev4(12);
  const float a20 = ev4(16), a21 = ev4(20);
  const float b0 = -ev5(24), b1 = -ev5(29), b2 = -ev5(34);
  const float AtA00 = a00 * a00 + a10 * a10 + a20 * a20 + 1e-12f;
  const float AtA01 = a00 * a01 + a10 * a11 + a20 * a21;
  const float AtA11 = a01 * a01 + a11 * a11 + a21 * a21 + 1e-12f;
  const float Atb0 = a00 * b0 + a10 * b1 + a20 * b2;
  const float Atb1 = a01 * b0 + a11 * b1 + a21 * b2;
  float det2 = AtA00 * AtA11 - AtA01 * AtA01;
  det2 = fabsf(det2) < 1e-20f ? 1e-20f : det2;
  float x = (AtA11 * Atb0 - AtA01 * Atb1) / det2;
  float y = (AtA00 * Atb1 - AtA01 * Atb0) / det2;

  float mono[20];
  for (int step = 0; step < kSteps; ++step) {
    monomials(x, y, z, mono);
    float r[10], Jx[10], Jy[10], Jz[10];
    for (int i = 0; i < 10; ++i) {
      r[i] = contract(s_md + i * 20, mono);
      Jx[i] = contract(s_md + (10 + i) * 20, mono);
      Jy[i] = contract(s_md + (20 + i) * 20, mono);
      Jz[i] = contract(s_md + (30 + i) * 20, mono);
    }
    float Axx = Jx[0] * Jx[0], Axy = Jx[0] * Jy[0], Axz = Jx[0] * Jz[0];
    float Ayy = Jy[0] * Jy[0], Ayz = Jy[0] * Jz[0], Azz = Jz[0] * Jz[0];
    float gx = Jx[0] * r[0], gy = Jy[0] * r[0], gz = Jz[0] * r[0];
    for (int i = 1; i < 10; ++i) {
      Axx = Axx + Jx[i] * Jx[i];
      Axy = Axy + Jx[i] * Jy[i];
      Axz = Axz + Jx[i] * Jz[i];
      Ayy = Ayy + Jy[i] * Jy[i];
      Ayz = Ayz + Jy[i] * Jz[i];
      Azz = Azz + Jz[i] * Jz[i];
      gx = gx + Jx[i] * r[i];
      gy = gy + Jy[i] * r[i];
      gz = gz + Jz[i] * r[i];
    }
    Axx = Axx + 1e-9f;
    Ayy = Ayy + 1e-9f;
    Azz = Azz + 1e-9f;
    const float c00 = Ayy * Azz - Ayz * Ayz;
    const float c01 = Ayz * Axz - Axy * Azz;
    const float c02 = Axy * Ayz - Ayy * Axz;
    float det = Axx * c00 + Axy * c01 + Axz * c02;
    det = fabsf(det) < 1e-20f ? 1e-20f : det;
    const float dx = (c00 * gx + c01 * gy + c02 * gz) / det;
    const float dy = (c01 * gx + (Axx * Azz - Axz * Axz) * gy
                      + (Axz * Axy - Axx * Ayz) * gz) / det;
    const float dz = (c02 * gx + (Axz * Axy - Axx * Ayz) * gy
                      + (Axx * Ayy - Axy * Axy) * gz) / det;
    x = x - dx;
    y = y - dy;
    z = z - dz;
  }

  monomials(x, y, z, mono);
  float maxr = fabsf(contract(s_md, mono));
  for (int i = 1; i < 10; ++i) maxr = nan_max(maxr, fabsf(contract(s_md + i * 20, mono)));
  const float t = x * x + y * y + z * z;
  const float scale = 1.0f + t * sqrtf(t);
  const bool finite = isfinite(x) && isfinite(y) && isfinite(z);
  const bool conv = finite && (maxr < 1e-3f * scale);

  float E[9];
  for (int k = 0; k < 9; ++k)
    E[k] = x * s_basis[k] + y * s_basis[9 + k] + z * s_basis[18 + k] + s_basis[27 + k];
  float nrm = E[0] * E[0];
  for (int k = 1; k < 9; ++k) nrm = nrm + E[k] * E[k];
  nrm = sqrtf(nrm);
  nrm = nrm < 1e-12f ? 1e-12f : nrm;
  float* out = Es + (static_cast<size_t>(b) * kSeeds + lane) * 9;
  for (int k = 0; k < 9; ++k) out[k] = E[k] / nrm;
  valid[b * kSeeds + lane] = svalid[lane * B + b] && conv;
}

}  // namespace

// md (40, 20, B), coef (40, B), basis (36, B), seeds (30, B) float32,
// svalid (30, B) bool -> Es (B, 30, 9) float32, valid (B, 30) bool. Returns
// the launch's cudaError_t.
extern "C" int coloc_fivept_polish(const void* md, const void* coef, const void* basis,
                                   const void* seeds, const void* svalid, void* Es,
                                   void* valid, int B, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  polish_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(md), static_cast<const float*>(coef),
      static_cast<const float*>(basis), static_cast<const float*>(seeds),
      static_cast<const unsigned char*>(svalid), static_cast<float*>(Es),
      static_cast<unsigned char*>(valid), B);
  return cudaGetLastError();
}
