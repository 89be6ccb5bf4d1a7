// Five-point solver front: minimal sample -> null basis, constraint matrix,
// MD, Gauss-Jordan and Nistér's polynomials.
//
// Replaces coloc_tpu/geometry/fivept.py::_front_kernel (Pallas, launched by
// _five_point_batch_pallas). Per sample (one thread each):
//   1. the 5x9 epipolar design matrix A; complete QR of A^T by 5 Householder
//      reflections; the 4 null vectors q_j = H1 ... H5 e_j, j = 5..8;
//   2. the 10x20 cubic-constraint matrix M (fivept_constraints.cuh, generated
//      from the plain twin's _constraint_rows: the same ~4000 operations in
//      the same order);
//   3. MD = [M; M D_x; M D_y; M D_z] (40x20), written for the polish;
//   4. Gauss-Jordan with partial pivoting on M + 1e-10 [I | 0] (first row on
//      ties, one-hot row swaps), then <k> = eq(4) - z eq(5), <l>, <m> and the
//      degree-10 polynomial det [<k> <l> <m>].
// Every formula repeats geometry/fivept.py::front_plain operation for
// operation (built with -fmad=false), so kernel and twin agree bit for bit.
//
// Layout (samples on the last axis, as the TPU kernel's lanes): xs (20, B),
// basis (36, B), md (40, 20, B), coef (40, B), npoly (11, B). With one thread
// per sample, neighbouring threads touch neighbouring addresses.
//
// Bound: ~10 kFLOP a sample (4000 for M, ~4500 for Gauss-Jordan's 10 steps
// over 10x20, the rest small): 2.6 MFLOP at B = 256, 40 ns at the fp32 peak;
// the 0.9 MB of outputs take 0.27 us at 3.35 TB/s. B = 256 threads fill two
// warps' worth of 8 blocks on 132 SMs, so the time is one thread's latency
// through ~10 k dependent operations plus the launch: the design keeps the
// whole sample in registers and local memory (no shared memory, no
// synchronisation), which is the simple form; speed is later work.
#include "common.cuh"
#include "fivept_constraints.cuh"

namespace {

using coloc::nan_max;

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
front_kernel(const float* __restrict__ xs, float* __restrict__ basis,
             float* __restrict__ md, float* __restrict__ coef,
             float* __restrict__ npoly, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float u1[5], v1[5], u2[5], v2[5];
  for (int i = 0; i < 5; ++i) {
    u1[i] = xs[i * B + b];
    v1[i] = xs[(5 + i) * B + b];
    u2[i] = xs[(10 + i) * B + b];
    v2[i] = xs[(15 + i) * B + b];
  }

  // ---- complete QR of A^T by Householder reflections ----
  float cols[5][9];
  for (int i = 0; i < 5; ++i) {
    cols[i][0] = u2[i] * u1[i];
    cols[i][1] = u2[i] * v1[i];
    cols[i][2] = u2[i];
    cols[i][3] = v2[i] * u1[i];
    cols[i][4] = v2[i] * v1[i];
    cols[i][5] = v2[i];
    cols[i][6] = u1[i];
    cols[i][7] = v1[i];
    cols[i][8] = 1.0f;
  }
  float rv[5][9], rbeta[5];
  for (int k = 0; k < 5; ++k) {
    const float* x = cols[k];
    float sigma = 0.0f;
    for (int i = k; i < 9; ++i) sigma = sigma + x[i] * x[i];
    const float sgn = x[k] >= 0.0f ? 1.0f : -1.0f;
    const float alpha = -sgn * sqrtf(sigma + 1e-30f);
    for (int i = 0; i < 9; ++i) rv[k][i] = i < k ? 0.0f : (i == k ? x[k] - alpha : x[i]);
    const float beta = 2.0f / (2.0f * (sigma - x[k] * alpha) + 1e-30f);
    rbeta[k] = beta;
    for (int j = k + 1; j < 5; ++j) {
      float c = 0.0f;
      for (int i = k; i < 9; ++i) c = c + rv[k][i] * cols[j][i];
      const float bc = beta * c;
      for (int i = 0; i < 9; ++i) cols[j][i] = cols[j][i] - bc * rv[k][i];
    }
  }
  float nb[4][9];
  for (int j = 5; j < 9; ++j) {
    float* q = nb[j - 5];
    for (int i = 0; i < 9; ++i) q[i] = i == j ? 1.0f : 0.0f;
    for (int k = 4; k >= 0; --k) {
      float c = 0.0f;
      for (int i = k; i < 9; ++i) c = c + rv[k][i] * q[i];
      const float bc = rbeta[k] * c;
      for (int i = 0; i < 9; ++i) q[i] = q[i] - bc * rv[k][i];
    }
  }
  for (int v = 0; v < 4; ++v)
    for (int i = 0; i < 9; ++i) basis[(v * 9 + i) * B + b] = nb[v][i];

  // ---- constraint matrix and MD ----
  float M[200];
  coloc_fivept::constraint_rows(nb[0], nb[1], nb[2], nb[3], M);
  for (int e = 0; e < 200; ++e) md[e * B + b] = M[e];
  for (int a = 0; a < 3; ++a)
    for (int j = 0; j < 20; ++j) {
      const int k = coloc_fivept::kDiffK[a][j];
      const float val = coloc_fivept::kDiffVal[a][j];
      for (int r = 0; r < 10; ++r) {
        float acc = 0.0f;
        if (k >= 0) acc = acc + val * M[r * 20 + k];
        md[((10 + 10 * a + r) * 20 + j) * B + b] = acc;
      }
    }

  // ---- Gauss-Jordan on M + 1e-10 [I | 0] ----
  float* Mw = M;  // reduced in place
  for (int r = 0; r < 10; ++r) Mw[r * 20 + r] = Mw[r * 20 + r] + 1e-10f;
  for (int r = 0; r < 10; ++r)
    for (int c = 0; c < 20; ++c)
      if (c != r) Mw[r * 20 + c] = Mw[r * 20 + c] + 0.0f;
  for (int k = 0; k < 10; ++k) {
    float cand[10];
    float mx = 0.0f;
    for (int r = 0; r < 10; ++r) {
      cand[r] = r >= k ? fabsf(Mw[r * 20 + k]) : -1.0f;
      mx = r == 0 ? cand[0] : nan_max(mx, cand[r]);
    }
    int p = 10;
    for (int r = 9; r >= 0; --r)
      if (cand[r] == mx) p = r;
    float onep[10], onek[10];
    for (int r = 0; r < 10; ++r) {
      onep[r] = r == p ? 1.0f : 0.0f;
      onek[r] = r == k ? 1.0f : 0.0f;
    }
    float rp[20], rk[20];
    for (int c = 0; c < 20; ++c) {
      float s = onep[0] * Mw[c];
      for (int r = 1; r < 10; ++r) s = s + onep[r] * Mw[r * 20 + c];
      rp[c] = s;
      rk[c] = Mw[k * 20 + c];
    }
    for (int r = 0; r < 10; ++r)
      for (int c = 0; c < 20; ++c)
        Mw[r * 20 + c] = (Mw[r * 20 + c] + onek[r] * (rp[c] - rk[c]))
                         + onep[r] * (rk[c] - rp[c]);
    float piv = rp[k] + onep[k] * (rk[k] - rp[k]);
    piv = fabsf(piv) < 1e-20f ? 1e-20f : piv;
    float rowk[20];
    for (int c = 0; c < 20; ++c) rowk[c] = Mw[k * 20 + c] / piv;
    for (int r = 0; r < 10; ++r) {
      const float f = Mw[r * 20 + k];
      for (int c = 0; c < 20; ++c) Mw[r * 20 + c] = Mw[r * 20 + c] - f * rowk[c];
    }
    for (int r = 0; r < 10; ++r)
      for (int c = 0; c < 20; ++c) Mw[r * 20 + c] = Mw[r * 20 + c] + onek[r] * rowk[c];
  }

  // ---- Nistér's reduced polynomials (ascending in z) ----
  // row i of the tail: P = (r2, r1, r0), Q = (r5, r4, r3), R = (r9, r8, r7, r6)
  // with r = Mw[i, 10:20]; <k> = eq(a) - z eq(b)
  float P[3][4], Q[3][4], R[3][5];
  for (int g = 0; g < 3; ++g) {
    const float* ra = Mw + (4 + 2 * g) * 20 + 10;
    const float* rb = Mw + (5 + 2 * g) * 20 + 10;
    P[g][0] = ra[2];
    P[g][1] = ra[1] - rb[2];
    P[g][2] = ra[0] - rb[1];
    P[g][3] = 0.0f - rb[0];
    Q[g][0] = ra[5];
    Q[g][1] = ra[4] - rb[5];
    Q[g][2] = ra[3] - rb[4];
    Q[g][3] = 0.0f - rb[3];
    R[g][0] = ra[9];
    R[g][1] = ra[8] - rb[9];
    R[g][2] = ra[7] - rb[8];
    R[g][3] = ra[6] - rb[7];
    R[g][4] = 0.0f - rb[6];
  }
  for (int g = 0; g < 3; ++g) {
    for (int i = 0; i < 4; ++i) coef[(8 * g + i) * B + b] = P[g][i];
    for (int i = 0; i < 4; ++i) coef[(8 * g + 4 + i) * B + b] = Q[g][i];
    for (int i = 0; i < 5; ++i) coef[(24 + 5 * g + i) * B + b] = R[g][i];
  }
  coef[39 * B + b] = 0.0f;

  // det = Pk (Ql Rm - Qm Rl) - Qk (Pl Rm - Pm Rl) + Rk (Pl Qm - Pm Ql)
  float a8[8], b8[8], m01[8], m11[8], m21[8];
  auto pmul = [](const float* x, int nx, const float* y, int ny, float* out) {
    for (int i = 0; i < nx + ny - 1; ++i) out[i] = 0.0f;
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < ny; ++j) out[i + j] = out[i + j] + x[i] * y[j];
  };
  pmul(Q[1], 4, R[2], 5, a8);
  pmul(Q[2], 4, R[1], 5, b8);
  for (int i = 0; i < 8; ++i) m01[i] = a8[i] - b8[i];
  pmul(P[1], 4, R[2], 5, a8);
  pmul(P[2], 4, R[1], 5, b8);
  for (int i = 0; i < 8; ++i) m11[i] = a8[i] - b8[i];
  pmul(P[1], 4, Q[2], 4, a8);
  pmul(P[2], 4, Q[1], 4, b8);
  for (int i = 0; i < 7; ++i) m21[i] = a8[i] - b8[i];
  float d1[11], d2[11], d3[11];
  pmul(P[0], 4, m01, 8, d1);
  pmul(Q[0], 4, m11, 8, d2);
  pmul(R[0], 5, m21, 7, d3);
  for (int i = 0; i < 11; ++i) npoly[i * B + b] = (d1[i] - d2[i]) + d3[i];
}

}  // namespace

// xs (20, B) float32 -> basis (36, B), md (40, 20, B), coef (40, B),
// npoly (11, B) float32. Returns the launch's cudaError_t.
extern "C" int coloc_fivept_front(const void* xs, void* basis, void* md, void* coef,
                                  void* npoly, int B, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  front_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<float*>(basis), static_cast<float*>(md),
      static_cast<float*>(coef), static_cast<float*>(npoly), B);
  return cudaGetLastError();
}
