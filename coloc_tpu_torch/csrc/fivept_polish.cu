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
// operation (-fmad=false), so kernel and twin agree bit for bit, on every
// seed, valid or not.
//
// Design: an octet of 8 lanes polishes two seeds, 16 octets a sample (the
// sample's 32 seed slots: slots 30-31 repeat seeds 28-29 and store
// nothing), one or two samples a CTA of 128 threads each. Lane h = 2G + H
// of an octet holds MD rows 5h..5h+4 in registers for all five steps
// (loaded once from the sample's MD staged in shared memory) and contracts
// them against both seeds' monomials, each row a sequential sum in k order:
// no shared-memory traffic in the steps, and each MD word serves two seeds.
// One shuffle of five values gives lane (G, H) vector G (r, Jx, Jy or Jz)
// of seed H in full; the four lanes of seed H then split the nine
// normal-equation sums, each formed whole by one lane in i order: lane G
// pairs its vector with its own and with those of lanes G+1 and G+2 (20
// shuffles), which covers JxJx, JyJy, JzJz, JxJy, JyJz, JxJz and Jx r, Jy r,
// Jz r (IEEE products commute); 9 shuffles give those lanes all nine, the
// adjugate solve runs on each of them, so seed H's x, y, z stay
// bit-identical across its four lanes, and one shuffle a coordinate hands
// them to the other seed's. The certificate's 10 rows are split 3-3-2-2
// over seed H's lanes (read from shared memory) and merged by nan_max (a
// maximum of |.| values is exact in any order). Each lane forms E and its
// norm in k order in registers and stores its share of the 9 entries. No
// lane returns early around the shuffles, and the spare seeds meet no odd
// values that would send the warp down the division's slow path; samples
// past B repeat sample B - 1 and store nothing.
//
// Bound: per seed 6 contractions of 40 x 20 multiply-adds (~10 k flops) plus
// the solves: ~75 MFLOP at B = 256 (7680 seeds), 1.1 us at the fp32 peak;
// inputs 0.9 MB, outputs 0.3 MB, 0.36 us at 3.35 TB/s: compute-bound. Without
// FMA a sample's step is 32 x 40 x 39 = 49,920 lane operations of
// contraction, 1560 warp instructions, and the octets add ~880 more (the
// shuffles, sums, solves and monomials): at B = 256, two samples an SM, a
// step issues for ~1220 cycles on each scheduler. Staging gathers a word a
// 32-byte sector (the inputs lie (rows, B)); two samples a CTA halve that.
#include "common.cuh"

namespace {

using coloc::nan_max;

constexpr int kSeeds = 30;
constexpr int kSlots = 32;                       // 30 seeds and 2 spares
constexpr int kOct = 8;                          // lanes a seed pair
constexpr int kSampleThreads = kSlots / 2 * kOct;
constexpr int kSteps = 5;
constexpr int kMD = 40 * 20, kCoef = 40, kBasis = 36;
// a sample's staged words: MD, its polynomial rows, its null basis
constexpr int kCoefWord = kMD, kBasisWord = kCoefWord + kCoef, kWords = kBasisWord + kBasis;
constexpr unsigned kFull = 0xffffffffu;

// the 20 monomials x^i y^j z^k in Nistér's order (the twin's _MONOMIALS),
// each the product px[i] * py[j] * pz[k] in that order with the constant
// factors skipped (a product with 1.0 is exact)
__device__ __forceinline__ void monomials(float x, float y, float z, float (&m)[20]) {
  const float x2 = x * x, y2 = y * y, z2 = z * z;
  m[0] = x2 * x;       // (3, 0, 0)
  m[1] = y2 * y;       // (0, 3, 0)
  m[2] = x2 * y;       // (2, 1, 0)
  m[3] = x * y2;       // (1, 2, 0)
  m[4] = x2 * z;       // (2, 0, 1)
  m[5] = x2;           // (2, 0, 0)
  m[6] = y2 * z;       // (0, 2, 1)
  m[7] = y2;           // (0, 2, 0)
  m[8] = x * y * z;    // (1, 1, 1)
  m[9] = x * y;        // (1, 1, 0)
  m[10] = x * z2;      // (1, 0, 2)
  m[11] = x * z;       // (1, 0, 1)
  m[12] = x;           // (1, 0, 0)
  m[13] = y * z2;      // (0, 1, 2)
  m[14] = y * z;       // (0, 1, 1)
  m[15] = y;           // (0, 1, 0)
  m[16] = z2 * z;      // (0, 0, 3)
  m[17] = z2;          // (0, 0, 2)
  m[18] = z;           // (0, 0, 1)
  m[19] = 1.0f;        // (0, 0, 0)
}

// one MD row from shared memory (20 floats, 16-byte aligned) into registers
__device__ __forceinline__ void load_row(const float* src, float (&row)[20]) {
  const float4* r4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const float4 v = r4[q];
    row[4 * q] = v.x;
    row[4 * q + 1] = v.y;
    row[4 * q + 2] = v.z;
    row[4 * q + 3] = v.w;
  }
}

// row . m, summed in k order from the first product
__device__ __forceinline__ float contract(const float (&row)[20], const float (&m)[20]) {
  float acc = row[0] * m[0];
#pragma unroll
  for (int k = 1; k < 20; ++k) acc = acc + row[k] * m[k];
  return acc;
}

// lane (G, H) of an octet holds v = vector G (r, Jx, Jy or Jz) of seed H;
// returns its sums with itself (s0), with lane (G+1, H)'s (s1) and lane
// (G+2, H)'s (s2), each in i order
__device__ __forceinline__ void quad_sums(const float (&v)[10], int G, int H, float& s0,
                                          float& s1, float& s2) {
  const int l1 = ((G + 1) & 3) * 2 + H, l2 = ((G + 2) & 3) * 2 + H;
  float w1 = __shfl_sync(kFull, v[0], l1, kOct);
  float w2 = __shfl_sync(kFull, v[0], l2, kOct);
  s0 = v[0] * v[0];
  s1 = v[0] * w1;
  s2 = v[0] * w2;
#pragma unroll
  for (int i = 1; i < 10; ++i) {
    w1 = __shfl_sync(kFull, v[i], l1, kOct);
    w2 = __shfl_sync(kFull, v[i], l2, kOct);
    s0 = s0 + v[i] * v[i];
    s1 = s1 + v[i] * w1;
    s2 = s2 + v[i] * w2;
  }
}

// the polish of an octet's two seeds on lane h = 2G + H, which returns seed
// H's x, y, z (z in: the seed) and certificate: the 2x2 start from the
// sample's polynomial rows c, 5 Gauss-Newton steps, the certificate on
// M = MD rows 0-9
__device__ __forceinline__ bool polish_pair(const float* s_md, const float* c, int G, int H,
                                            float& x, float& y, float& z) {
  // the lane's MD rows, read before the 2x2 start so their loads overlap it
  float md[5][20];
#pragma unroll
  for (int i = 0; i < 5; ++i) load_row(s_md + ((2 * G + H) * 5 + i) * 20, md[i]);
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
  x = (AtA11 * Atb0 - AtA01 * Atb1) / det2;
  y = (AtA00 * Atb1 - AtA01 * Atb0) / det2;

  float mono[20];
#pragma unroll 1
  for (int step = 0; step < kSteps; ++step) {
    // the other seed's point from the partner lane (G, 1 - H)
    const float xo = __shfl_xor_sync(kFull, x, 1, kOct);
    const float yo = __shfl_xor_sync(kFull, y, 1, kOct);
    const float zo = __shfl_xor_sync(kFull, z, 1, kOct);
    float own[2][5];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const bool mine = (s == 0) == (H == 0);
      monomials(mine ? x : xo, mine ? y : yo, mine ? z : zo, mono);
#pragma unroll
      for (int i = 0; i < 5; ++i) own[s][i] = contract(md[i], mono);
    }
    // vector G of seed H: rows 0-4 of it on lane (G, 0), rows 5-9 on (G, 1)
    float v[10];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float got = __shfl_xor_sync(kFull, H ? own[0][i] : own[1][i], 1, kOct);
      v[i] = H ? got : own[0][i];
      v[5 + i] = H ? own[1][i] : got;
    }
    float s0, s1, s2;
    quad_sums(v, G, H, s0, s1, s2);
    s0 = s0 + 1e-9f;
    const float Axx = __shfl_sync(kFull, s0, 2 + H, kOct);
    const float Ayy = __shfl_sync(kFull, s0, 4 + H, kOct);
    const float Azz = __shfl_sync(kFull, s0, 6 + H, kOct);
    const float gx = __shfl_sync(kFull, s1, H, kOct);
    const float Axy = __shfl_sync(kFull, s1, 2 + H, kOct);
    const float Ayz = __shfl_sync(kFull, s1, 4 + H, kOct);
    const float gz = __shfl_sync(kFull, s1, 6 + H, kOct);
    const float gy = __shfl_sync(kFull, s2, H, kOct);
    const float Axz = __shfl_sync(kFull, s2, 2 + H, kOct);
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

  // certificate: rows G, G + 4 and min(G + 8, 9) of M on lane (G, H)
  monomials(x, y, z, mono);
  float row[20];
  load_row(s_md + G * 20, row);
  float maxr = fabsf(contract(row, mono));
  load_row(s_md + (G + 4) * 20, row);
  maxr = nan_max(maxr, fabsf(contract(row, mono)));
  load_row(s_md + min(G + 8, 9) * 20, row);
  maxr = nan_max(maxr, fabsf(contract(row, mono)));
  maxr = nan_max(maxr, __shfl_xor_sync(kFull, maxr, 2, kOct));
  maxr = nan_max(maxr, __shfl_xor_sync(kFull, maxr, 4, kOct));
  const float t = x * x + y * y + z * z;
  const float scale = 1.0f + t * sqrtf(t);
  const bool finite = isfinite(x) && isfinite(y) && isfinite(z);
  return finite && (maxr < 1e-3f * scale);
}

// one of E[base..base+3] by a lane index g (0..3), without indexing a
// register array at run time
__device__ __forceinline__ float pick4(const float (&E)[9], int base, int g) {
  return g == 0 ? E[base] : g == 1 ? E[base + 1] : g == 2 ? E[base + 2] : E[base + 3];
}

// S samples a CTA of S * 128 threads
template <int S>
__global__ void __launch_bounds__(S * kSampleThreads)
polish_kernel(const float* __restrict__ md, const float* __restrict__ coef,
              const float* __restrict__ basis, const float* __restrict__ seeds,
              const unsigned char* __restrict__ svalid, float* __restrict__ Es,
              unsigned char* __restrict__ valid, int B) {
  constexpr int kThreads = S * kSampleThreads;
  constexpr int kStage = (S * kWords + kThreads - 1) / kThreads;   // loads a thread
  __shared__ __align__(16) float s_in[S][kWords];
  const int b0 = blockIdx.x * S;
  const int j = threadIdx.x / kSampleThreads;
  const int b = min(b0 + j, B - 1);              // samples past B repeat B - 1
  const int h = threadIdx.x % kOct, G = h >> 1, H = h & 1;
  const int slot = threadIdx.x % kSampleThreads / kOct * 2 + H;
  const int seed = slot < kSeeds ? slot : slot - 2;

  // staging, every load in flight before the first store: word e of the
  // CTA's samples, consecutive threads on consecutive samples of one row
  float w[kStage];
#pragma unroll
  for (int r = 0; r < kStage; ++r) {
    const int i = threadIdx.x + r * kThreads, e = i / S;
    const size_t row = e < kCoefWord ? e : e < kBasisWord ? e - kCoefWord : e - kBasisWord;
    const float* src = e < kCoefWord ? md : e < kBasisWord ? coef : basis;
    w[r] = e < kWords ? __ldg(src + row * B + min(b0 + i % S, B - 1)) : 0.0f;
  }
  float z = __ldg(seeds + seed * B + b);
  const bool seed_valid = svalid[seed * B + b];
#pragma unroll
  for (int r = 0; r < kStage; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (i / S < kWords) s_in[i % S][i / S] = w[r];
  }
  __syncthreads();

  float x, y;
  const bool conv = polish_pair(s_in[j], s_in[j] + kCoefWord, G, H, x, y, z);

  // E and its norm in k order on every lane; lane (G, H) stores seed H's
  // entries G and G + 4, lane (0, H) also entry 8 and the flag
  const float* bs = s_in[j] + kBasisWord;
  float E[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) E[k] = x * bs[k] + y * bs[9 + k] + z * bs[18 + k] + bs[27 + k];
  float nrm = E[0] * E[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) nrm = nrm + E[k] * E[k];
  nrm = sqrtf(nrm);
  nrm = nrm < 1e-12f ? 1e-12f : nrm;
  const float e0 = pick4(E, 0, G) / nrm, e1 = pick4(E, 4, G) / nrm, e2 = E[8] / nrm;
  if (slot < kSeeds && b0 + j < B) {
    const size_t at = static_cast<size_t>(b0 + j) * kSeeds + slot;
    Es[at * 9 + G] = e0;
    Es[at * 9 + 4 + G] = e1;
    if (G == 0) {
      Es[at * 9 + 8] = e2;
      valid[at] = seed_valid && conv;
    }
  }
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
  // two samples a CTA halve the 32-byte sectors staging reads for each 4
  // bytes it keeps (the inputs lie (rows, B)), but hold one CTA an SM: taken
  // where one sample a CTA would put two on some SM anyway and two a CTA
  // still fit one wave
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const auto* m = static_cast<const float*>(md);
  const auto* c = static_cast<const float*>(coef);
  const auto* bs = static_cast<const float*>(basis);
  const auto* sd = static_cast<const float*>(seeds);
  const auto* sv = static_cast<const unsigned char*>(svalid);
  auto* e = static_cast<float*>(Es);
  auto* v = static_cast<unsigned char*>(valid);
  const auto st = static_cast<cudaStream_t>(stream);
  if (B > sms && B <= 2 * sms)
    polish_kernel<2><<<(B + 1) / 2, 2 * kSampleThreads, 0, st>>>(m, c, bs, sd, sv, e, v, B);
  else
    polish_kernel<1><<<B, kSampleThreads, 0, st>>>(m, c, bs, sd, sv, e, v, B);
  return cudaGetLastError();
}
