// FAST-9 score + 3x3 non-max suppression over one float32 raster.
//
// Replaces coloc_tpu/ops/fast.py::_make_fast_nms_kernel (:182, Pallas,
// launched by fast_nms_pallas). Per pixel (y, x) of an (h, w) raster:
//   dev_k = I(y + dy_k, x + dx_k) - I(y, x), ring k of RING_OFFSETS, the
//           ring read at clamped indices (edge-replicate padding);
//   score = max over the 16 arcs of 9 consecutive ring pixels of
//           max(min dev, min -dev), kept if > threshold, else 0; a NaN
//           deviation anywhere on the ring gives 0;
//   raw   = score, 0 on the raster's 3-px border;
//   nms   = raw where raw >= its 8 neighbours and raw > its 4 earlier
//           (raster-order) neighbours (-1,-1) (-1,0) (-1,1) (0,-1), else 0;
//           neighbours outside the raster read 0.
// The border is the whole raster's (a stacked pyramid batch is one
// raster); per-level borders are the caller's mask. Only subtractions,
// negations, min, max and compares: exact in float32, so the kernel equals
// the plain twin ops/fast.py::fast_nms_plain bit for bit.
//
// Bound: per pixel 4 bytes in, 8 out (0.0123 ms for a D=2 raster at 3.35
// TB/s); the full score is ~180 ALU ops (16 deviations, two 16-arc min
// cascades, the maxima), so a form that runs both cascades on every pixel
// is bound by issue. Design:
//   - An exact early-out. score > t needs an arc of 9 with every deviation
//     > t (bright) or every -deviation > t (dark), and any 9 consecutive
//     ring pixels hold two cyclically adjacent compass points (k = 0, 4, 8,
//     12). So a pixel whose 4-bit compass mask of a side has no adjacent
//     pair (rotate-and-AND) scores <= t on that side, and a pixel with
//     neither side left writes 0 without a cascade. This is the 16-bit
//     run-of-9 test on the compass bits alone: 8 compares on 5 reads, and
//     it leaves 34% of the bench raster's pixels where the 16-bit test
//     leaves 12% (scripts/fast_early_out_rates.py). Gating the cascade on the 16-bit test as well, in a
//     second compaction, was slower on the card: the 32 compares and the
//     reload cost more than the cascades they save. A plateau at exactly t
//     fails the strict compare (0, as the twin); a NaN compare is false, so
//     a NaN ring pixel can pass a clean compass pair, and the cascade's NaN
//     flag still zeroes it.
//   - Compaction, one cascade an entry. Each warp queues its passing sides
//     in shared memory (ballot, no atomics) and runs the cascade over the
//     queue with every lane busy. With t >= 0 no pixel scores > t on both
//     sides (the two arcs would need 18 ring pixels), so each side is an
//     entry of its own and writes only a score > t; with t < 0 (both sides
//     may) a pixel is one entry that takes the max of both cascades.
//   - Register blocking. A thread scores a strip of 8 pixels down one
//     column, sliding the column's window in registers: ~4 shared-memory
//     reads a pixel for the early-out instead of 17, and a 3-column window
//     for the NMS.
//   - A 62x30 output tile, so its scores and their 1-px ring are 64x32, 8
//     warps x 32 lanes x 8 rows; the 70x38 input window is read as 16-byte
//     float4 from the aligned column at or below x0 - 4 wherever the window
//     lies inside a raster of 16-byte rows, and clamped floats elsewhere.
//   - Load, score and NMS stay phases of one block (two barriers); at ~28
//     KB of shared memory five blocks share an SM, so one block's loads
//     overlap another's scoring.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTileW = 62, kTileH = 30;      // output pixels a block
constexpr int kScW = kTileW + 2, kScH = kTileH + 2;  // scored: 64 x 32
constexpr int kHalo = 4;                     // ring radius 3 + NMS radius 1
constexpr int kInW = kTileW + 2 * kHalo;     // 70 input columns
constexpr int kInH = kTileH + 2 * kHalo;     // 38 input rows
constexpr int kInPitch = 76;                 // 19 float4: 70 columns at any 16-byte phase
constexpr int kStrip = 8;                    // score rows a thread
constexpr int kThreads = 256;                // 8 warps: 2 column halves x 4 strips
constexpr int kWarps = kThreads / 32;

__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// max over the 16 starts s of min(v[s], ..., v[s+8 mod 16])
__device__ __forceinline__ float best_arc(const float (&v)[16]) {
  float m2[16], m4[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) m2[s] = fminf(v[s], v[(s + 1) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) m4[s] = fminf(m2[s], m2[(s + 2) & 15]);
  float best = -INFINITY;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const float m8 = fminf(m4[s], m4[(s + 4) & 15]);
    best = fmaxf(best, fminf(m8, v[(s + 8) & 15]));
  }
  return best;
}

// bits 0..3 of m are compass points 0, 4, 8, 12: is some cyclically
// adjacent pair set (m & rot(m, 1) over 4 bits)?
__device__ __forceinline__ bool adjacent_pair(unsigned m) {
  return (m & (((m >> 1) | (m << 3)) & 15u)) != 0u;
}

__global__ void __launch_bounds__(kThreads)
fast_nms_tile_kernel(const float* __restrict__ img, float* __restrict__ raw,
                     float* __restrict__ nms, int h, int w, float threshold,
                     int rows16) {
  __shared__ __align__(16) float in[kInH][kInPitch];
  __shared__ float sc[kScH][kScW];
  __shared__ unsigned short queue[kWarps][2 * kStrip * 32];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // input cell (r, c), pixel (y0 - 4 + r, x0 - 4 + c), sits at in[r][c + off]:
  // interior tiles read whole float4 from the 16-byte boundary at or below
  // x0 - 4; edge tiles read clamped floats from x0 - 4 on (off = 0)
  const int xs = (x0 - kHalo) & ~3;
  const bool interior = rows16 && x0 >= kHalo && xs + kInPitch <= w && y0 >= kHalo &&
                        y0 + kTileH + kHalo <= h;
  const int off = interior ? x0 - kHalo - xs : 0;
  if (interior) {
    constexpr int kVecW = kInPitch / 4;
    for (int i = threadIdx.x; i < kInH * kVecW; i += kThreads) {
      const int r = i / kVecW, c4 = i % kVecW;
      *reinterpret_cast<float4*>(&in[r][4 * c4]) = *reinterpret_cast<const float4*>(
          img + static_cast<size_t>(y0 - kHalo + r) * w + xs + 4 * c4);
    }
  } else {
    for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
      const int r = i / kInW, c = i % kInW;
      const int gy = min(max(y0 - kHalo + r, 0), h - 1);
      const int gx = min(max(x0 - kHalo + c, 0), w - 1);
      in[r][c] = img[static_cast<size_t>(gy) * w + gx];
    }
  }
  __syncthreads();

  // this thread's strip: score column c, rows r0 .. r0 + 7; score cell
  // (r, c) is pixel (y0 - 1 + r, x0 - 1 + c) and input cell (r + 3, c + 3)
  const int c = (warp & 1) * 32 + lane;
  const int r0 = (warp >> 1) * kStrip;
  const int gx = x0 - 1 + c;
  const bool x_in = gx >= 3 && gx < w - 3;
  const int ic = c + 3 + off;                 // smem column of the centre

  // the early-out, one column window slid down the strip: a pixel reads
  // its centre and compass points N, S from the column and E, W beside it
  float col[kStrip + 6];
#pragma unroll
  for (int k = 0; k < kStrip + 6; ++k) col[k] = in[r0 + k][ic];
  int queued = 0;                             // warp-uniform
  const bool split = threshold >= 0.0f;
#pragma unroll
  for (int k = 0; k < kStrip; ++k) {
    const int r = r0 + k, gy = y0 - 1 + r;
    unsigned sides = 0u;
    if (x_in && gy >= 3 && gy < h - 3) {
      const float center = col[k + 3];
      const float d0 = col[k] - center;                  // ring 0:  (-3, 0)
      const float d4 = in[r + 3][ic + 3] - center;       // ring 4:  (0, 3)
      const float d8 = col[k + 6] - center;              // ring 8:  (3, 0)
      const float d12 = in[r + 3][ic - 3] - center;      // ring 12: (0, -3)
      const unsigned bright = (d0 > threshold) | (d4 > threshold) << 1 |
                              (d8 > threshold) << 2 | (d12 > threshold) << 3;
      const unsigned dark = (-d0 > threshold) | (-d4 > threshold) << 1 |
                            (-d8 > threshold) << 2 | (-d12 > threshold) << 3;
      sides = static_cast<unsigned>(adjacent_pair(bright)) |
              static_cast<unsigned>(adjacent_pair(dark)) << 1;
    }
    sc[r][c] = 0.0f;
    // with t >= 0 no pixel scores > t on both sides (the two arcs would
    // need 18 ring pixels), so each passing side is an entry of its own
    // and a warp runs one cascade an entry; with t < 0 a pixel whose two
    // sides pass is one entry that takes the max of both
    const unsigned lt = (1u << lane) - 1u;
    const unsigned first = split ? sides & 1u : sides;
    const unsigned b1 = __ballot_sync(0xffffffffu, first != 0u);
    const unsigned b2 = __ballot_sync(0xffffffffu, split && (sides & 2u));
    const int n1 = __popc(b1);
    const unsigned short cell = static_cast<unsigned short>(r << 8 | c << 2);
    if (first != 0u) queue[warp][queued + __popc(b1 & lt)] = cell | first;
    if (split && (sides & 2u)) queue[warp][queued + n1 + __popc(b2 & lt)] = cell | 2u;
    queued += n1 + __popc(b2);
  }
  __syncwarp();

  // the full score of this warp's queued pixels, for the sides that passed
  for (int k = lane; k < queued; k += 32) {
    const unsigned e = queue[warp][k];
    const int r = e >> 8, qc = (e >> 2) & 63;
    const unsigned sides = e & 3u;
    const float* p = &in[r + 3][qc + 3 + off];
    const float center = *p;
    float v[16];
    bool nan = false;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float d = p[kRingDy[j] * kInPitch + kRingDx[j]] - center;
      nan |= d != d;
      v[j] = (sides & 1u) ? d : -d;
    }
    // the twin's min/max propagate NaN, and NaN > threshold is false;
    // fminf/fmaxf drop it, so a NaN deviation zeroes the score here
    float best = best_arc(v);
    if (sides == 3u) {
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = -v[j];
      best = fmaxf(best, best_arc(v));
    }
    // pass 1 wrote 0; at most one entry of a cell scores above t
    if (!nan && best > threshold) sc[r][qc] = best;
  }
  __syncthreads();

  // NMS of the strip's pixels that are output pixels (score rows 1..30,
  // columns 1..62), from a 3-column window slid down the strip
  if (c < 1 || c > kTileW) return;
  float L[kStrip + 2], M[kStrip + 2], R[kStrip + 2];
#pragma unroll
  for (int k = 0; k < kStrip + 2; ++k) {
    const int rr = min(max(r0 - 1 + k, 0), kScH - 1);
    L[k] = sc[rr][c - 1];
    M[k] = sc[rr][c];
    R[k] = sc[rr][c + 1];
  }
#pragma unroll
  for (int k = 0; k < kStrip; ++k) {
    const int r = r0 + k;
    const int gy = y0 - 1 + r;
    if (r < 1 || r > kTileH || gy >= h || gx >= w) continue;
    const float s = M[k + 1];
    const float earlier = fmaxf(fmaxf(L[k], M[k]), fmaxf(R[k], L[k + 1]));
    const float later = fmaxf(fmaxf(R[k + 1], L[k + 2]), fmaxf(M[k + 2], R[k + 2]));
    const bool keep = s >= fmaxf(earlier, later) && earlier < s;
    const size_t o = static_cast<size_t>(gy) * w + gx;
    raw[o] = s;
    nms[o] = keep ? s : 0.0f;
  }
}

}  // namespace

// img, raw, nms: (h, w) float32. Returns the launch's cudaError_t.
extern "C" int coloc_fast_nms(const void* img, void* raw, void* nms, int h, int w,
                              float threshold, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (h <= 0 || w <= 0) return cudaSuccess;
  // every row starts on a 16-byte boundary: interior tiles read float4
  const int rows16 = w % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  fast_nms_tile_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(raw), static_cast<float*>(nms), h,
      w, threshold, rows16);
  return cudaGetLastError();
}
