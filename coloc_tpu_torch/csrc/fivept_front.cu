// Five-point solver front: minimal sample -> null basis, constraint matrix,
// MD, Gauss-Jordan and Nistér's polynomials.
//
// Replaces coloc_tpu/geometry/fivept.py::_front_kernel (Pallas, launched by
// _five_point_batch_pallas). A warp a sample, kWarps samples a CTA:
//   1. every lane runs the 5 Householder reflections of A^T (the 5x9
//      epipolar design matrix; uniform code costs a warp what it costs one
//      thread), then lane j < 4 applies them to e_{5+j}: null vector j;
//   2. the 10x20 cubic-constraint matrix M (fivept_constraints.cuh,
//      generated from the plain twin's polynomial arithmetic): lane
//      3 r + c < 9 forms (E E^T)[r][c], the lanes swap them through shared
//      memory, and each forms row 1 + 3 r + c; lanes 9-11 form a cofactor
//      term of det E each and lane 9 adds them up (row 0); each row's lane
//      also forms its three rows of M D_x, M D_y, M D_z (MD, written for
//      the polish);
//   3. Gauss-Jordan with partial pivoting on M + 1e-10 [I | 0] (first row
//      on ties, one-hot row swaps): lane c < 20 holds column c in
//      registers; each step every lane reads column k by __shfl_sync and
//      forms the pivot row, the swapped column k and the pivot itself, so
//      the only exchange a step is those 10 shuffles;
//   4. lane 0 forms <k> = eq(4) - z eq(5), <l>, <m> and the degree-10
//      polynomial det [<k> <l> <m>] from rows 4-9 of columns 10-19.
// Outputs are staged in shared memory and the CTA writes each output row as
// a run of kWarps consecutive samples. Every formula repeats
// geometry/fivept.py::front_plain operation for operation (built with
// -fmad=false; one-hot sums are exact in any order), so kernel and twin
// agree bit for bit.
//
// Layout (samples on the last axis, as the TPU kernel's lanes): xs (20, B),
// basis (36, B), md (40, 20, B), coef (40, B), npoly (11, B).
//
// Bound: ~10 kFLOP a sample and 3.6 KB of outputs: at B = 256 the bytes,
// 0.27 us at 3.35 TB/s. One sample's dependent chain (Gauss-Jordan's 10
// steps above all) sets the time at that size, so the design spreads a
// sample over a warp (256 warps on the card at B = 256) and keeps every
// array in registers at constant indices (no local memory).
#include "common.cuh"
#include "fivept_constraints.cuh"

namespace {

constexpr int kWarps = 4;   // samples a CTA, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// a sample's staged outputs: basis, md, coef, npoly
constexpr int kBasis = 0, kMd = 36, kCoef = 836, kNpoly = 876, kOut = 887;
// output e of sample w sits at stage[e * kStride + w]; an odd stride puts
// the consecutive rows a warp's lanes write on distinct banks
constexpr int kStride = kWarps + 1;

__device__ __forceinline__ float& at(float* st, int e) { return st[e * kStride]; }

// md_rows' out[20 a + j]: row 10 + 10 a + row of MD, column j, in the stage
struct MdRows {
  float* st;
  int row;
  __device__ __forceinline__ float& operator[](int i) const {
    return at(st, kMd + 20 * (10 + 10 * (i / 20) + row) + i % 20);
  }
};

// out = x * y, polynomials ascending, the twin's pmul order
template <int NX, int NY>
__device__ __forceinline__ void pmul(const float (&x)[NX], const float (&y)[NY],
                                     float (&out)[NX + NY - 1]) {
#pragma unroll
  for (int i = 0; i < NX + NY - 1; ++i) out[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NY; ++j) out[i + j] = out[i + j] + x[i] * y[j];
}

// sum_i w[i] x[i] for a one-hot (or all-zero) w, as a tree: the twin sums
// in row order, and both are exact in any order (x[p] itself, or a zero
// that is -0 only when every term is, or NaN when any term is), so the
// tree gives the twin's bits in a third of the chain
__device__ __forceinline__ float onehot_sum(const float (&w)[10], const float (&x)[10]) {
  float t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = w[i] * x[i];
  return (((t[0] + t[1]) + (t[2] + t[3])) + ((t[4] + t[5]) + (t[6] + t[7]))) + (t[8] + t[9]);
}

// One sample, the whole warp; its outputs into st (stage + warp).
__device__ __forceinline__ void sample_front(const float* __restrict__ xs, int B, int b,
                                             int lane, float* st, float (*eet)[10],
                                             float* xch) {
  float u1[5], v1[5], u2[5], v2[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    u1[i] = __ldg(xs + i * B + b);
    v1[i] = __ldg(xs + (5 + i) * B + b);
    u2[i] = __ldg(xs + (10 + i) * B + b);
    v2[i] = __ldg(xs + (15 + i) * B + b);
  }

  // ---- complete QR of A^T by Householder reflections (every lane) ----
  float cols[5][9];
#pragma unroll
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
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    float sigma = 0.0f;
#pragma unroll
    for (int i = k; i < 9; ++i) sigma = sigma + cols[k][i] * cols[k][i];
    const float xk = cols[k][k];
    const float sgn = xk >= 0.0f ? 1.0f : -1.0f;
    const float alpha = -sgn * sqrtf(sigma + 1e-30f);
#pragma unroll
    for (int i = 0; i < 9; ++i) rv[k][i] = i < k ? 0.0f : (i == k ? xk - alpha : cols[k][i]);
    const float beta = 2.0f / (2.0f * (sigma - xk * alpha) + 1e-30f);
    rbeta[k] = beta;
#pragma unroll
    for (int j = k + 1; j < 5; ++j) {
      float c = 0.0f;
#pragma unroll
      for (int i = k; i < 9; ++i) c = c + rv[k][i] * cols[j][i];
      const float bc = beta * c;
#pragma unroll
      for (int i = 0; i < 9; ++i) cols[j][i] = cols[j][i] - bc * rv[k][i];
    }
  }
  // null vector lane & 3: H1 ... H5 e_{5 + (lane & 3)}
  {
    const int jn = 5 + (lane & 3);
    float q[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) q[i] = i == jn ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 4; k >= 0; --k) {
      float c = 0.0f;
#pragma unroll
      for (int i = k; i < 9; ++i) c = c + rv[k][i] * q[i];
      const float bc = rbeta[k] * c;
#pragma unroll
      for (int i = 0; i < 9; ++i) q[i] = q[i] - bc * rv[k][i];
    }
    if (lane < 4) {
#pragma unroll
      for (int i = 0; i < 9; ++i) at(st, kBasis + 9 * lane + i) = q[i];
    }
  }
  __syncwarp();

  // ---- constraint matrix: lane 3 r + c -> row 1 + 3 r + c, lanes 9-11 -> row 0 ----
  // basis v at (r, k) is at(st, kBasis + 9 v + 3 r + k)
  float m[20];
  const int r = lane / 3, c = lane - 3 * (lane / 3);
  if (lane < 9) {
    float ea[4][3], ec[4][3], e10[10];
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ea[v][k] = at(st, kBasis + 9 * v + 3 * r + k);
        ec[v][k] = at(st, kBasis + 9 * v + 3 * c + k);
      }
    coloc_fivept::eet_entry(ea, ec, e10);
#pragma unroll
    for (int i = 0; i < 10; ++i) eet[lane][i] = e10[i];
  } else if (lane < 12) {
    // cofactor term j = lane - 9 of det E: E[0][j] (E[1][a] E[2][b] - E[1][b] E[2][a])
    const int j = lane - 9, a = j == 0 ? 1 : 0, b = j == 2 ? 1 : 2;
    const int rc[5] = {j, 3 + a, 6 + b, 3 + b, 6 + a};   // 3 row + column
    float d[5][4], t20[20];
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) d[i][v] = at(st, kBasis + 9 * v + rc[i]);
    coloc_fivept::det_term(d, t20);
#pragma unroll
    for (int i = 0; i < 20; ++i) xch[20 * j + i] = t20[i];
  }
  __syncwarp();
  if (lane < 9) {
    float er[3][10], dg[3][10], ec[4][3], e[4];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < 10; ++i) {
        er[k][i] = eet[3 * r + k][i];
        dg[k][i] = eet[4 * k][i];
      }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int k = 0; k < 3; ++k) ec[v][k] = at(st, kBasis + 9 * v + 3 * k + c);
      e[v] = at(st, kBasis + 9 * v + 3 * r + c);
    }
    coloc_fivept::row_entry(er, dg, ec, e, m);
  } else if (lane == 9) {
    float t[3][20];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 20; ++i) t[j][i] = xch[20 * j + i];
    coloc_fivept::det_combine(t, m);
  }
  if (lane < 10) {
    const int row = lane < 9 ? lane + 1 : 0;
#pragma unroll
    for (int j = 0; j < 20; ++j) at(st, kMd + 20 * row + j) = m[j];
    coloc_fivept::md_rows(m, MdRows{st, row});
  }
  __syncwarp();

  // ---- Gauss-Jordan on M + 1e-10 [I | 0]: lane cl holds column cl ----
  // (lanes 20-31 repeat column 19 and store nothing)
  const int cl = lane < 20 ? lane : 19;
  float col[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) col[i] = at(st, kMd + 20 * i + cl) + (i == cl ? 1e-10f : 0.0f);
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    float ck[10];   // column k before the step
#pragma unroll
    for (int i = 0; i < 10; ++i) ck[i] = __shfl_sync(kFull, col[i], k);
    // pivot row p: the first row >= k at the largest |column k|; 10 when a
    // candidate is NaN (torch's amax propagates it, and no row equals NaN).
    // The candidates are -1 or |x|, whose bit patterns order as integers
    // as the floats do, NaN above +inf: an integer maximum, by a tree,
    // gives the twin's value.
    float cand[10];
    int cb[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      cand[i] = i >= k ? fabsf(ck[i]) : -1.0f;
      cb[i] = __float_as_int(cand[i]);
    }
    const float mx = __int_as_float(max(max(max(cb[0], cb[1]), max(cb[2], cb[3])),
                                        max(max(max(cb[4], cb[5]), max(cb[6], cb[7])),
                                            max(cb[8], cb[9]))));
    unsigned hit = 0;
#pragma unroll
    for (int i = 0; i < 10; ++i) hit |= static_cast<unsigned>(cand[i] == mx) << i;
    const int p = hit ? __ffs(hit) - 1 : 10;
    float onep[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) onep[i] = i == p ? 1.0f : 0.0f;
    // column k after the row swap (f), and the pivot
    const float rpk = onehot_sum(onep, ck);
    const float rkk = ck[k];
    float f[10];
#pragma unroll
    for (int i = 0; i < 10; ++i)
      f[i] = (ck[i] + (i == k ? 1.0f : 0.0f) * (rpk - rkk)) + onep[i] * (rkk - rpk);
    float piv = rpk + onep[k] * (rkk - rpk);
    piv = fabsf(piv) < 1e-20f ? 1e-20f : piv;
    // this lane's column: the swap, then the elimination
    const float rp = onehot_sum(onep, col);
    const float rk = col[k];
#pragma unroll
    for (int i = 0; i < 10; ++i)
      col[i] = (col[i] + (i == k ? 1.0f : 0.0f) * (rp - rk)) + onep[i] * (rk - rp);
    const float rowk = col[k] / piv;
#pragma unroll
    for (int i = 0; i < 10; ++i) col[i] = col[i] - f[i] * rowk;
#pragma unroll
    for (int i = 0; i < 10; ++i) col[i] = col[i] + (i == k ? 1.0f : 0.0f) * rowk;
  }
  if (lane >= 10 && lane < 20) {
#pragma unroll
    for (int i = 4; i < 10; ++i) xch[10 * (i - 4) + lane - 10] = col[i];
  }
  __syncwarp();
  if (lane != 0) return;

  // ---- Nistér's reduced polynomials (ascending in z) ----
  // row i of the tail: P = (r2, r1, r0), Q = (r5, r4, r3), R = (r9, r8, r7, r6)
  // with r = Mw[i, 10:20]; <k> = eq(a) - z eq(b)
  float P[3][4], Q[3][4], R[3][5];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float* ra = xch + 20 * g;        // row 4 + 2 g, columns 10-19
    const float* rb = xch + 20 * g + 10;   // row 5 + 2 g
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
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) at(st, kCoef + 8 * g + i) = P[g][i];
#pragma unroll
    for (int i = 0; i < 4; ++i) at(st, kCoef + 8 * g + 4 + i) = Q[g][i];
#pragma unroll
    for (int i = 0; i < 5; ++i) at(st, kCoef + 24 + 5 * g + i) = R[g][i];
  }
  at(st, kCoef + 39) = 0.0f;

  // det = Pk (Ql Rm - Qm Rl) - Qk (Pl Rm - Pm Rl) + Rk (Pl Qm - Pm Ql)
  float a8[8], b8[8], m01[8], m11[8], a7[7], b7[7], m21[7];
  pmul(Q[1], R[2], a8);
  pmul(Q[2], R[1], b8);
#pragma unroll
  for (int i = 0; i < 8; ++i) m01[i] = a8[i] - b8[i];
  pmul(P[1], R[2], a8);
  pmul(P[2], R[1], b8);
#pragma unroll
  for (int i = 0; i < 8; ++i) m11[i] = a8[i] - b8[i];
  pmul(P[1], Q[2], a7);
  pmul(P[2], Q[1], b7);
#pragma unroll
  for (int i = 0; i < 7; ++i) m21[i] = a7[i] - b7[i];
  float d1[11], d2[11], d3[11];
  pmul(P[0], m01, d1);
  pmul(Q[0], m11, d2);
  pmul(R[0], m21, d3);
#pragma unroll
  for (int i = 0; i < 11; ++i) at(st, kNpoly + i) = (d1[i] - d2[i]) + d3[i];
}

__global__ void __launch_bounds__(kThreads)
front_kernel(const float* __restrict__ xs, float* __restrict__ basis,
             float* __restrict__ md, float* __restrict__ coef,
             float* __restrict__ npoly, int B) {
  __shared__ float stage[kOut * kStride];
  __shared__ float eet[kWarps][9][10];    // (E E^T)[r][c] at [3 r + c]
  // det E's three cofactor terms, later Gauss-Jordan's rows 4-9 of columns 10-19
  __shared__ float xch[kWarps][60];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kWarps;
  // a warp past B repeats sample B - 1 and stores nothing: every warp runs
  // the sample code, so the compiler sees its shuffles converged
  sample_front(xs, B, min(b0 + w, B - 1), lane, stage + w, eet[w], xch[w]);
  __syncthreads();
  // each output row as a run of the CTA's consecutive samples
  const int n = min(kWarps, B - b0);
  for (int i = threadIdx.x; i < kOut * kWarps; i += kThreads) {
    const int e = i / kWarps, s = i - kWarps * (i / kWarps);
    if (s >= n) continue;
    const float v = stage[e * kStride + s];
    const int b = b0 + s;
    if (e < kMd)
      basis[e * B + b] = v;
    else if (e < kCoef)
      md[(e - kMd) * B + b] = v;
    else if (e < kNpoly)
      coef[(e - kCoef) * B + b] = v;
    else
      npoly[(e - kNpoly) * B + b] = v;
  }
}

}  // namespace

// xs (20, B) float32 -> basis (36, B), md (40, 20, B), coef (40, B),
// npoly (11, B) float32. Returns the launch's cudaError_t.
extern "C" int coloc_fivept_front(const void* xs, void* basis, void* md, void* coef,
                                  void* npoly, int B, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  front_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<float*>(basis), static_cast<float*>(md),
      static_cast<float*>(coef), static_cast<float*>(npoly), B);
  return cudaGetLastError();
}
