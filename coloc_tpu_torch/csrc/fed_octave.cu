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
// Bound: each pass streams one to three planes (1.4 MB each at 480x752),
// about 25 passes an octave at the default preset, so ~0.1 GB of traffic an
// octave-0 launch that stays in the 50 MB L2; the work is ~20 flops a pixel
// a pass. What costs is the dependence between passes: each step reads its
// neighbours' results of the step before. Design: one cooperative launch
// (cudaLaunchCooperativeKernel) of as many blocks as fit on the card, a
// grid-stride loop of one thread per pixel, and grid.sync() between
// dependent passes; whole-image planes in device memory (ping-pong scratch
// for L inside a cycle, one plane for g), where L2 holds them. This keeps
// the TPU's one launch an octave (4 a frame) without the TPU's row bands:
// a band with a halo in shared memory would need a ~24-row halo for these
// cycles, so its tiles would be small and its recomputation large. The
// schedule (step counts, float32 step sizes, sigma^4 scales) travels by
// value in the kernel's parameters, and k2 is read on the device.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSublevels = 8;
constexpr int kMaxSteps = 128;

struct Plan {
  int S;
  int nsteps[kMaxSublevels];
  float sigma4[kMaxSublevels];
  float taus[kMaxSteps];
};

// Scharr derivatives at (y, x) of one H x W plane, summed as the TPU kernel
// streams them: from zero, w * v in (dy, dx) row order for each non-zero
// weight, then / 32.
__device__ __forceinline__ void scharr(const float* __restrict__ p, int y, int x, int H,
                                       int W, float& gx, float& gy) {
  const float* rm = p + max(y - 1, 0) * W;
  const float* r0 = p + y * W;
  const float* rp = p + min(y + 1, H - 1) * W;
  const int xm = max(x - 1, 0), xp = min(x + 1, W - 1);
  float sx = 0.0f, sy = 0.0f, v;
  v = rm[xm]; sx = sx + -3.0f * v; sy = sy + -3.0f * v;
  v = rm[x];  sy = sy + -10.0f * v;
  v = rm[xp]; sx = sx + 3.0f * v;  sy = sy + -3.0f * v;
  v = r0[xm]; sx = sx + -10.0f * v;
  v = r0[xp]; sx = sx + 10.0f * v;
  v = rp[xm]; sx = sx + -3.0f * v; sy = sy + 3.0f * v;
  v = rp[x];  sy = sy + 10.0f * v;
  v = rp[xp]; sx = sx + 3.0f * v;  sy = sy + 3.0f * v;
  gx = sx / 32.0f;
  gy = sy / 32.0f;
}

__device__ __forceinline__ float conductivity(float gx, float gy, float k2) {
  return 1.0f / (1.0f + (gx * gx + gy * gy) / k2);
}

// One explicit FED step at (y, x): src, g and dst are one image's planes.
__device__ __forceinline__ float fed_step(const float* __restrict__ src,
                                          const float* __restrict__ g, int y, int x,
                                          int H, int W, float tau) {
  const int i = y * W + x;
  const int ie = y * W + min(x + 1, W - 1), iw = y * W + max(x - 1, 0);
  const int is = min(y + 1, H - 1) * W + x, in = max(y - 1, 0) * W + x;
  const float L = src[i], gc = g[i];
  const float g_e = 0.5f * (gc + g[ie]);
  const float g_w = 0.5f * (gc + g[iw]);
  const float g_s = 0.5f * (gc + g[is]);
  const float g_n = 0.5f * (gc + g[in]);
  float flux = g_e * (src[ie] - L) + g_w * (src[iw] - L);
  flux = flux + g_s * (src[is] - L);
  flux = flux + g_n * (src[in] - L);
  return L + tau * flux;
}

// L0 (B, H, W); k2 (B,); outputs (B, S, H, W); scratch (3, B, H, W): two
// ping-pong L planes and g.
__global__ void __launch_bounds__(kThreads)
fed_octave_kernel(const float* __restrict__ L0, const float* __restrict__ k2,
                  float* __restrict__ out_l, float* __restrict__ out_lx,
                  float* __restrict__ out_ly, float* __restrict__ out_r,
                  float* __restrict__ scratch, int B, int H, int W, Plan plan) {
  cg::grid_group grid = cg::this_grid();
  const int HW = H * W, N = B * HW, S = plan.S;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;
  float* ping = scratch;
  float* pong = scratch + N;
  float* g = scratch + 2 * N;

  for (int p = first; p < N; p += step) {
    const int b = p / HW, r = p - b * HW, y = r / W, x = r - y * W;
    float gx, gy;
    scharr(L0 + b * HW, y, x, H, W, gx, gy);
    g[p] = conductivity(gx, gy, k2[b]);
  }
  grid.sync();

  // src planes of image b start at src + b * src_bs
  const float* src = L0;
  int src_bs = HW;
  int t = 0;
  for (int s = 0; s < S; ++s) {
    const int n = plan.nsteps[s];
    for (int j = 0; j < n; ++j) {
      const bool last = j == n - 1;
      float* dst = last ? out_l + s * HW : ((j & 1) ? pong : ping);
      const int dst_bs = last ? S * HW : HW;
      const float tau = plan.taus[t++];
      for (int p = first; p < N; p += step) {
        const int b = p / HW, r = p - b * HW, y = r / W, x = r - y * W;
        dst[b * dst_bs + r] = fed_step(src + b * src_bs, g + b * HW, y, x, H, W, tau);
      }
      grid.sync();
      src = dst;
      src_bs = dst_bs;
    }
    // the sublevel's Lx, Ly, and from them the next cycle's g
    for (int p = first; p < N; p += step) {
      const int b = p / HW, r = p - b * HW, y = r / W, x = r - y * W;
      const int o = (b * S + s) * HW + r;
      float gx, gy;
      scharr(out_l + (b * S + s) * HW, y, x, H, W, gx, gy);
      out_lx[o] = gx;
      out_ly[o] = gy;
      if (s + 1 < S) g[p] = conductivity(gx, gy, k2[b]);
    }
    grid.sync();
    // the response; the next cycle's first step reads only L and g, both
    // complete, so no sync is needed before it
    const float s4 = plan.sigma4[s];
    for (int p = first; p < N; p += step) {
      const int b = p / HW, r = p - b * HW, y = r / W, x = r - y * W;
      const int base = (b * S + s) * HW;
      float lxx, lxy, lyx, lyy;
      scharr(out_lx + base, y, x, H, W, lxx, lxy);
      scharr(out_ly + base, y, x, H, W, lyx, lyy);
      out_r[base + r] = s4 * (lxx * lyy - lxy * lxy);
    }
  }
}

}  // namespace

// L0 (B, H, W) float32, k2 (B,) float32 on the device; out_* (B, S, H, W)
// float32; scratch (3, B, H, W) float32. nsteps (S,), taus (sum nsteps,),
// sigma4 (S,) are HOST arrays. One cooperative launch on `stream`; returns
// its cudaError_t.
extern "C" int coloc_fed_octave(const void* L0, const void* k2, void* out_l, void* out_lx,
                                void* out_ly, void* out_r, void* scratch, int B, int H,
                                int W, int S, const void* nsteps, const void* taus,
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
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device))) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fed_octave_kernel,
                                                           kThreads, 0)))
    return err;
  const int N = B * H * W;
  const int blocks = min(per_sm * sms, (N + kThreads - 1) / kThreads);
  if (blocks < 1) return cudaErrorInvalidConfiguration;

  const float* a_l0 = static_cast<const float*>(L0);
  const float* a_k2 = static_cast<const float*>(k2);
  float* a_l = static_cast<float*>(out_l);
  float* a_lx = static_cast<float*>(out_lx);
  float* a_ly = static_cast<float*>(out_ly);
  float* a_r = static_cast<float*>(out_r);
  float* a_s = static_cast<float*>(scratch);
  void* args[] = {&a_l0, &a_k2, &a_l, &a_lx, &a_ly, &a_r, &a_s, &B, &H, &W, &plan};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fed_octave_kernel), dim3(blocks),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
