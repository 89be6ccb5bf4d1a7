// One AKAZE octave in one launch: every FED cycle of the octave and each
// sublevel's L, Lx, Ly and sigma^4-normalised Hessian determinant.
//
// Replaces coloc_tpu/ops/diffusion.py::_make_fed_octave_kernel (Pallas,
// launched by fed_octave_pallas for build_scale_space_batch). Per cycle s:
// g = 1 / (1 + |Scharr L|^2 / k2[b]), held fixed over the cycle; n_s
// explicit steps L += tau_j * div(g grad L) with half-grid conductivities;
// then Scharr of the new L (the sublevel's Lx, Ly, and the next cycle's
// gradient) and sigma4_s * (Lxx Lyy - Lxy^2) from a second Scharr pass.
// Every neighbour read clamps at the image border (pad(mode="edge")). The
// plain twin is ops/diffusion.py::fed_octave_plain; with the same operation
// order and -fmad=false the two are bit-equal.
//
// Bound: bytes, the input plane read once and the 4 S output planes written
// once (~0.0097 ms for a 752x480 frame's four octaves); the work is ~20
// flops a pixel a pass. What costs is the dependence between passes: each
// explicit step reads its neighbours' results of the step before, so a
// whole-image pass per step needs a grid-wide barrier per step.
//
// Design: a cycle's chain is local. Within a cycle g is fixed and a step
// reads only its 4-neighbours, so a CTA owns an output tile, loads the
// cycle's input L over the tile plus a halo of n_s + 3 into shared memory,
// forms g there (Scharr of that L: the same values the previous cycle wrote
// as Lx, Ly) and from it the cycle's east and south half-grid
// conductivities (a pixel's west and north ones are its neighbours' east
// and south ones: the sum is the same either way round), runs the n_s steps
// in shared memory with __syncthreads() between them, the valid region
// shrinking by one a step, then computes the tile's Lx, Ly (halo 1) and
// response and writes its four planes. Halo pixels are recomputed with the
// same operations in the same order, so the result is exact. One grid
// barrier (cooperative launch, grid.sync()) remains a cycle, before the
// next cycle reads its neighbours' L: 3 an octave of 4 sublevels, against
// ~21 passes and barriers before. A cycle longer than kChunk steps is cut
// into chunks of at most kChunk, with L passed through two scratch planes
// and a barrier between chunks, so the halo stays bounded.
//
// A pass is a few hundred instructions a thread between two barriers, so
// its cost is its instruction count. The clamp at the image border is
// done once, when a value is stored: a pixel on the border also writes its
// value to the shared-memory cells just outside the image that clamp to it,
// so every stencil read is an unclamped neighbour. The tile shape and the
// planes' pitch are template constants, so all of a strip's reads are one
// register plus immediate offsets. A thread takes a strip of kRows pixels
// of one column in the stencil passes (vertical neighbours from registers);
// warps take rows of strips, lanes columns, so no pass divides; in a load
// pass all of a thread's device-memory loads precede its stores. The grid
// is sized to the octave: one of four tile shapes, 48x64 to 8x32, chosen
// from the image and the card (tile_shape); a CTA walks several tiles
// where they outnumber the co-resident CTAs. The schedule (step counts,
// float32 step sizes, sigma^4 scales) travels by value in the kernel's
// parameters and is copied to shared memory first; k2 is read on the
// device.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // pixels of one column a thread takes in a stencil pass
constexpr int kPlanes = 5;
constexpr int kMaxSublevels = 8;
constexpr int kMaxSteps = 128;
// most explicit steps a CTA runs on its tile between two grid barriers, and
// the halo of such a chunk: its steps, the Scharr of g, Lx/Ly, the response
constexpr int kChunk = 8;
constexpr int kHalo = kChunk + 3;

struct Plan {
  int S;
  int nsteps[kMaxSublevels];
  float sigma4[kMaxSublevels];
  float taus[kMaxSteps];
};

// A CTA's shared-memory planes for TH x TW tiles: the tile, the halo and
// the clamped cells outside the image, at pitch P, and kRows rows of slack
// that a strip at the region's last rows reads and never uses.
template <int TH, int TW>
struct Shape {
  static constexpr int P = TW + 2 * kHalo + 2;
  static constexpr int cap = P * (TH + 2 * kHalo + 2 + kRows);
  static constexpr size_t bytes = kPlanes * cap * sizeof(float);
};

// A tile, rows [y0, y1) and columns [x0, x1) of one image, and the plane
// index of image pixel (y, x): the planes start at (oy, ox), one row and one
// column before the tile's largest region.
template <int P>
struct Tile {
  int y0, y1, x0, x1, oy, ox;
  __device__ __forceinline__ int at(int y, int x) const { return (y - oy) * P + (x - ox); }
};

// The tile grown by h on each side and cut at the image border.
struct Region {
  int y0, y1, x0, x1;
  template <class T>
  __device__ __forceinline__ Region(const T& t, int h, int H, int W)
      : y0(max(t.y0 - h, 0)), y1(min(t.y1 + h, H)), x0(max(t.x0 - h, 0)), x1(min(t.x1 + h, W)) {}
};

// fn(y, x) for every pixel of the region: warps over rows, lanes over
// columns.
template <class F>
__device__ __forceinline__ void for_each(const Region& g, F fn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int y = g.y0 + warp; y < g.y1; y += kWarps)
    for (int x = g.x0 + lane; x < g.x1; x += 32) fn(y, x);
}

// fn(y, r, x) for every strip of the region: rows y .. y + r - 1 (r <=
// kRows) of column x.
template <class F>
__device__ __forceinline__ void for_strips(const Region& g, F fn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int y = g.y0 + warp * kRows; y < g.y1; y += kWarps * kRows) {
    const int r = min(kRows, g.y1 - y);
    for (int x = g.x0 + lane; x < g.x1; x += 32) fn(y, r, x);
  }
}

// st(y, x, ld(y, x)) for every pixel of the region, with a thread's loads
// of two rows and up to kChunks column blocks of 32 all made before its
// stores: ld reads device memory, so its latency is paid once a batch.
template <int kChunks, class Ld, class St>
__device__ __forceinline__ void copy_region(const Region& g, Ld ld, St st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int y = g.y0 + warp; y < g.y1; y += 2 * kWarps) {
    float v[2][kChunks];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int yy = y + r * kWarps, xx = g.x0 + lane + 32 * c;
        v[r][c] = yy < g.y1 && xx < g.x1 ? ld(yy, xx) : 0.0f;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int yy = y + r * kWarps, xx = g.x0 + lane + 32 * c;
        if (yy < g.y1 && xx < g.x1) st(yy, xx, v[r][c]);
      }
  }
}

// Store v at plane index i of image pixel (y, x) and, where the pixel is on
// the image border, at the cells outside the image that clamp to it.
template <int P>
__device__ __forceinline__ void put(float* pl, int i, int y, int x, float v, int H, int W) {
  pl[i] = v;
  const bool n = y == 0, s = y == H - 1, w = x == 0, e = x == W - 1;
  if (n | s | w | e) {
    if (n) pl[i - P] = v;
    if (s) pl[i + P] = v;
    if (w) pl[i - 1] = v;
    if (e) pl[i + 1] = v;
    if (n & w) pl[i - P - 1] = v;
    if (n & e) pl[i - P + 1] = v;
    if (s & w) pl[i + P - 1] = v;
    if (s & e) pl[i + P + 1] = v;
  }
}

// put() for row k of a strip, with the border test skipped for a strip
// that touches no image border (edge false).
template <int P>
__device__ __forceinline__ void put_k(float* pl, int i, int y, int x, float v, int H, int W,
                                      bool edge) {
  if (edge)
    put<P>(pl, i, y, x, v, H, W);
  else
    pl[i] = v;
}

// Whether a strip (rows y .. y + r - 1 of column x) touches the image border.
__device__ __forceinline__ bool strip_edge(int y, int r, int x, int H, int W) {
  return (x == 0) | (x == W - 1) | (y == 0) | (y + r == H);
}

// Scharr derivatives of the strip at plane index i, each summed as the TPU
// kernel streams them: from zero, w * v in (dy, dx) row order for each
// non-zero weight, then / 32.
template <int P>
__device__ __forceinline__ void scharr_strip(const float* p, int i, float (&gx)[kRows],
                                             float (&gy)[kRows]) {
  float m[kRows + 2], c[kRows + 2], q[kRows + 2];
#pragma unroll
  for (int k = 0; k < kRows + 2; ++k) {
    m[k] = p[i + (k - 1) * P - 1];
    c[k] = p[i + (k - 1) * P];
    q[k] = p[i + (k - 1) * P + 1];
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    float sx = 0.0f, sy = 0.0f;
    sx = sx + -3.0f * m[k]; sy = sy + -3.0f * m[k];
    sy = sy + -10.0f * c[k];
    sx = sx + 3.0f * q[k];  sy = sy + -3.0f * q[k];
    sx = sx + -10.0f * m[k + 1];
    sx = sx + 10.0f * q[k + 1];
    sx = sx + -3.0f * m[k + 2]; sy = sy + 3.0f * m[k + 2];
    sy = sy + 10.0f * c[k + 2];
    sx = sx + 3.0f * q[k + 2];  sy = sy + 3.0f * q[k + 2];
    gx[k] = sx / 32.0f;
    gy[k] = sy / 32.0f;
  }
}

__device__ __forceinline__ float conductivity(float gx, float gy, float k2) {
  return 1.0f / (1.0f + (gx * gx + gy * gy) / k2);
}

// L0 (B, H, W); k2 (B,); outputs (B, S, H, W); scratch (3, B, H, W), of which
// the first two planes carry L between the chunks of a long cycle.
template <int TH, int TW>
__global__ void __launch_bounds__(kThreads)
fed_octave_kernel(const float* __restrict__ L0, const float* __restrict__ k2,
                  float* __restrict__ out_l, float* __restrict__ out_lx,
                  float* __restrict__ out_ly, float* __restrict__ out_r,
                  float* __restrict__ scratch, int B, int H, int W, Plan plan) {
  using Sh = Shape<TH, TW>;
  constexpr int P = Sh::P;
  extern __shared__ float smem[];
  float* const GE = smem + 3 * Sh::cap;  // half-grid east conductivities
  float* const GS = smem + 4 * Sh::cap;  // half-grid south conductivities
  cg::grid_group grid = cg::this_grid();
  // the schedule in shared memory, read at a computed index each step
  __shared__ float taus[kMaxSteps], sigma4[kMaxSublevels];
  __shared__ int nsteps[kMaxSublevels];
  for (int j = threadIdx.x; j < kMaxSteps; j += kThreads) taus[j] = plan.taus[j];
  if (threadIdx.x < kMaxSublevels) {
    sigma4[threadIdx.x] = plan.sigma4[threadIdx.x];
    nsteps[threadIdx.x] = plan.nsteps[threadIdx.x];
  }
  __syncthreads();
  const int HW = H * W, S = plan.S;
  const int tiles_x = (W + TW - 1) / TW, per_image = ((H + TH - 1) / TH) * tiles_x;
  const int ntiles = B * per_image;
  int t_first = 0;  // the cycle's first step size in taus
  for (int s = 0; s < S; ++s) {
    const int n = nsteps[s];
    // the cycle's input: L0, or the last sublevel's L
    const float* prev = s == 0 ? L0 : out_l + (s - 1) * HW;
    const int prev_bs = s == 0 ? HW : S * HW;
    for (int c0 = 0, chunk = 0; c0 < n; c0 += kChunk, ++chunk) {
      const int nc = min(kChunk, n - c0);
      const bool last = c0 + nc == n;
      const int hc = nc + 3;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int b = t / per_image, rt = t - b * per_image;
        const int ty = rt / tiles_x, tx = rt - ty * tiles_x;
        const Tile<P> tile{ty * TH, min(ty * TH + TH, H), tx * TW, min(tx * TW + TW, W),
                           max(ty * TH - kHalo, 0) - 1, max(tx * TW - kHalo, 0) - 1};
        // plain loads: out_l and scratch are written by this launch, before
        // the grid barrier, so not through the read-only path
        const float* pb = prev + b * prev_bs;
        const float kb = __ldg(k2 + b);
        __syncthreads();  // the previous tile's reads of shared memory are done
        // the cycle's input over the halo (into plane 0 for the first chunk,
        // where it is also the steps' start; else into plane 1, and the
        // chunk's start, written by the chunk before, into plane 0)
        float* const in = c0 == 0 ? smem : smem + Sh::cap;
        constexpr int kChunks = (TW + 2 * kHalo + 31) / 32;
        copy_region<kChunks>(
            Region(tile, hc, H, W), [&](int y, int x) { return pb[y * W + x]; },
            [&](int y, int x, float v) { put<P>(in, tile.at(y, x), y, x, v, H, W); });
        if (c0 > 0) {
          const float* cur = scratch + ((chunk - 1) & 1) * B * HW + b * HW;
          copy_region<kChunks>(
              Region(tile, hc - 1, H, W), [&](int y, int x) { return cur[y * W + x]; },
              [&](int y, int x, float v) { put<P>(smem, tile.at(y, x), y, x, v, H, W); });
        }
        __syncthreads();
        float* const G = smem + 2 * Sh::cap;
        for_strips(Region(tile, hc - 1, H, W), [&](int y, int r, int x) {
          const int i = tile.at(y, x);
          const bool edge = strip_edge(y, r, x, H, W);
          float gx[kRows], gy[kRows];
          scharr_strip<P>(in, i, gx, gy);
#pragma unroll
          for (int k = 0; k < kRows; ++k)
            if (k < r)
              put_k<P>(G, i + k * P, y + k, x, conductivity(gx[k], gy[k], kb), H, W, edge);
        });
        __syncthreads();
        // the half-grid conductivities, from one row and column further
        // north and west, where the image border's cells hold the pixel's
        // own with itself
        Region gr(tile, hc - 1, H, W);
        --gr.y0;
        --gr.x0;
        for_each(gr, [&](int y, int x) {
          const int i = tile.at(y, x);
          const float gc = G[i];
          GE[i] = 0.5f * (gc + G[i + 1]);
          GS[i] = 0.5f * (gc + G[i + P]);
        });
        __syncthreads();
        float* src = smem;
        float* dst = smem + Sh::cap;
        for (int j = 0; j < nc; ++j) {
          const float tau = taus[t_first + c0 + j];
          for_strips(Region(tile, hc - 2 - j, H, W), [&](int y, int r, int x) {
            const int i = tile.at(y, x);
            const bool edge = strip_edge(y, r, x, H, W);
            float c[kRows + 2], e[kRows], w[kRows], ge[kRows], gw[kRows], gs[kRows + 1];
#pragma unroll
            for (int k = 0; k < kRows + 2; ++k) c[k] = src[i + (k - 1) * P];
            gs[0] = GS[i - P];
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              e[k] = src[i + k * P + 1];
              w[k] = src[i + k * P - 1];
              ge[k] = GE[i + k * P];
              gw[k] = GE[i + k * P - 1];
              gs[k + 1] = GS[i + k * P];
            }
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              if (k < r) {
                const float L = c[k + 1];
                float flux = ge[k] * (e[k] - L) + gw[k] * (w[k] - L);
                flux = flux + gs[k + 1] * (c[k + 2] - L);
                flux = flux + gs[k] * (c[k] - L);
                put_k<P>(dst, i + k * P, y + k, x, L + tau * flux, H, W, edge);
              }
            }
          });
          __syncthreads();
          float* const tmp = src;
          src = dst;
          dst = tmp;
        }
        if (!last) {
          float* nxt = scratch + (chunk & 1) * B * HW + b * HW;
          for_each(Region(tile, 0, H, W),
                   [&](int y, int x) { nxt[y * W + x] = src[tile.at(y, x)]; });
          continue;
        }
        // the sublevel's Lx (into G) and Ly (into dst) over halo 1, then the
        // tile's four planes
        for_strips(Region(tile, 1, H, W), [&](int y, int r, int x) {
          const int i = tile.at(y, x);
          const bool edge = strip_edge(y, r, x, H, W);
          float gx[kRows], gy[kRows];
          scharr_strip<P>(src, i, gx, gy);
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            if (k < r) {
              put_k<P>(G, i + k * P, y + k, x, gx[k], H, W, edge);
              put_k<P>(dst, i + k * P, y + k, x, gy[k], H, W, edge);
            }
          }
        });
        __syncthreads();
        const float s4 = sigma4[s];
        const int base = (b * S + s) * HW;
        for_strips(Region(tile, 0, H, W), [&](int y, int r, int x) {
          const int i = tile.at(y, x);
          float lxx[kRows], lxy[kRows], lyx[kRows], lyy[kRows];
          scharr_strip<P>(G, i, lxx, lxy);
          scharr_strip<P>(dst, i, lyx, lyy);
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            if (k < r) {
              const int o = base + (y + k) * W + x;
              out_l[o] = src[i + k * P];
              out_lx[o] = G[i + k * P];
              out_ly[o] = dst[i + k * P];
              out_r[o] = s4 * (lxx[k] * lyy[k] - lxy[k] * lxy[k]);
            }
          }
        });
      }
      // the next chunk or cycle reads its neighbours' L
      if (!last || s + 1 < S) grid.sync();
    }
    t_first += n;
  }
}

// One cooperative launch of the TH x TW instantiation: as many CTAs as
// there are tiles, at most as many as fit on the card at once.
template <int TH, int TW>
cudaError_t launch(int sms, cudaStream_t stream, void** args, int B, int H, int W) {
  using Sh = Shape<TH, TW>;
  auto* kernel = fed_octave_kernel<TH, TW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Sh::bytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           Sh::bytes)))
    return err;
  const int tiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int blocks = min(per_sm * sms, tiles);
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks),
                                     dim3(kThreads), args, Sh::bytes, stream);
}

// The tile shape of an octave: 48x64, 32x64, 16x32 or 8x32 (0-3). A pass
// costs an SM its tiles' strips one after another, and a CTA at least the
// latency of a pass over kThreads / 2 strips, so the shape with the least
// of ceil(tiles / SMs) x max(strips of a tile at the default preset's halo
// of 8, kThreads / 2) is taken, the smaller on a tie. (Fitted to the
// frame's octaves on an H100: chip_smoke.py times each.)
int tile_shape(int B, int H, int W, int sms) {
  constexpr int shapes[4][2] = {{48, 64}, {32, 64}, {16, 32}, {8, 32}};
  int best = 0;
  long long best_cost = -1;
  for (int k = 0; k < 4; ++k) {
    const int th = shapes[k][0], tw = shapes[k][1];
    const long long tiles = static_cast<long long>(B) * ((H + th - 1) / th) * ((W + tw - 1) / tw);
    const long long strips = static_cast<long long>((min(th, H) + 16 + kRows - 1) / kRows) *
                             (min(tw, W) + 16);
    const long long least = kThreads / 2;
    const long long cost = (tiles + sms - 1) / sms * max(strips, least);
    if (best_cost < 0 || cost <= best_cost) {
      best = k;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

// L0 (B, H, W) float32, k2 (B,) float32 on the device; out_* (B, S, H, W)
// float32; scratch (3, B, H, W) float32. nsteps (S,), taus (sum nsteps,),
// sigma4 (S,) are HOST arrays. One cooperative launch on `stream`; returns
// its cudaError_t.
extern "C" int coloc_fed_octave(const void* L0, const void* k2, void* out_l, void* out_lx,
                                void* out_ly, void* out_r, void* scratch, int B, int H, int W,
                                int S, const void* nsteps, const void* taus,
                                const void* sigma4, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (S < 1 || S > kMaxSublevels) return cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0) return cudaSuccess;
  Plan plan{};
  plan.S = S;
  int total = 0;
  for (int s = 0; s < S; ++s) {
    const int n = static_cast<const int*>(nsteps)[s];
    if (n < 1 || total + n > kMaxSteps) return cudaErrorInvalidValue;
    plan.nsteps[s] = n;
    plan.sigma4[s] = static_cast<const float*>(sigma4)[s];
    for (int j = 0; j < n; ++j) plan.taus[total + j] = static_cast<const float*>(taus)[total + j];
    total += n;
  }
  int coop = 0, sms = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device))) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) return err;
  const float* a_l0 = static_cast<const float*>(L0);
  const float* a_k2 = static_cast<const float*>(k2);
  float* a_l = static_cast<float*>(out_l);
  float* a_lx = static_cast<float*>(out_lx);
  float* a_ly = static_cast<float*>(out_ly);
  float* a_r = static_cast<float*>(out_r);
  float* a_s = static_cast<float*>(scratch);
  void* args[] = {&a_l0, &a_k2, &a_l, &a_lx, &a_ly, &a_r, &a_s, &B, &H, &W, &plan};
  auto st = static_cast<cudaStream_t>(stream);
  switch (tile_shape(B, H, W, sms)) {
    case 0: err = launch<48, 64>(sms, st, args, B, H, W); break;
    case 1: err = launch<32, 64>(sms, st, args, B, H, W); break;
    case 2: err = launch<16, 32>(sms, st, args, B, H, W); break;
    default: err = launch<8, 32>(sms, st, args, B, H, W); break;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
