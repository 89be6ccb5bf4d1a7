// Group-local top-2 of a 128-bit prefilter: the first stage of the
// two-stage large-bank matcher.
//
// Replaces coloc_tpu/ops/hamming.py::_make_k2nn_group_kernel (Pallas,
// launched by _group_top2_pallas for hamming_2nn_twostage). For every query
// and every group of 2048 bank rows it returns the global rows of the two
// largest keys (dot << 16) + penrcol[row], where dot is the +-1 product of
// the 128 prefilter bits (every fourth descriptor bit) and penrcol packs
// the invalid-row penalty with the reversed in-group column, so keys are
// unique and the lower row wins an equal dot. The TPU kernel takes the dot
// on the MXU as an int8 matrix product; here, as in B1 (k2nn.cu), it is
// 128 - 2 popc(q ^ t) over four packed words. A padding row past the bank's
// end has a zero operand on the TPU, so its dot is 0 here too. The plain
// twin is ops/hamming.py::group_top2_plain; integer keys make it exact.
//
// Bound: at Q = 1024 against 262144 rows the work is 268M row-query pairs
// of 4 XOR + popc (int8 tensor-core ops counted as the TPU's 2 Q T 128),
// over a 4 MB prefilter bank that stays in L2: bound by instruction
// throughput, not bytes. Design: a block per (group, 64 queries); the
// group's 2048 prefilter rows (32 KB) and keys (8 KB) staged in shared
// memory once, read as 16-byte rows; each warp takes a query at a time,
// each lane a running top-2 over its 64 rows, merged by shuffles.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kGroup = 2048;
constexpr int kWarps = 8;
constexpr int kQueries = 64;   // queries a block

__global__ void __launch_bounds__(kWarps * 32)
k2nn_group_kernel(const uint4* __restrict__ q_pf, const uint4* __restrict__ pf,
                  const int* __restrict__ penrcol, int* __restrict__ idx1,
                  int* __restrict__ idx2, int Q, int T, int G) {
  __shared__ uint4 rows[kGroup];
  __shared__ int keys[kGroup];
  const int g = blockIdx.x;
  for (int r = threadIdx.x; r < kGroup; r += blockDim.x) {
    rows[r] = pf[static_cast<size_t>(g) * kGroup + r];
    keys[r] = penrcol[static_cast<size_t>(g) * kGroup + r];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int real = T - g * kGroup;   // rows from here on are padding
  for (int qq = warp; qq < kQueries; qq += kWarps) {
    const int qi = blockIdx.y * kQueries + qq;
    if (qi >= Q) break;
    const uint4 q = q_pf[qi];
    int k1 = INT_MIN, k2 = INT_MIN;
    for (int r = lane; r < kGroup; r += 32) {
      int dot = 0;
      if (r < real) {
        const uint4 t = rows[r];
        dot = 128 - 2 * (__popc(q.x ^ t.x) + __popc(q.y ^ t.y) + __popc(q.z ^ t.z) +
                         __popc(q.w ^ t.w));
      }
      const int key = dot * 65536 + keys[r];
      if (key > k1) {
        k2 = k1;
        k1 = key;
      } else if (key > k2) {
        k2 = key;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int o1 = __shfl_down_sync(0xffffffffu, k1, off);
      const int o2 = __shfl_down_sync(0xffffffffu, k2, off);
      const int n2 = max(min(k1, o1), max(k2, o2));
      k1 = max(k1, o1);
      k2 = n2;
    }
    if (lane == 0) {
      const size_t o = static_cast<size_t>(qi) * G + g;
      idx1[o] = (kGroup - 1) - (k1 & 65535) + g * kGroup;
      idx2[o] = (kGroup - 1) - (k2 & 65535) + g * kGroup;
    }
  }
}

}  // namespace

// q_pf (Q, 4) int32, pf (G * 2048, 4) int32, both 16-byte aligned;
// penrcol (G * 2048,) int32; T <= G * 2048 real rows -> idx1, idx2 (Q, G)
// int32. Returns the launch's cudaError_t.
extern "C" int coloc_k2nn_group(const void* q_pf, const void* pf, const void* penrcol,
                                void* idx1, void* idx2, int Q, int T, int G, int device,
                                void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (Q <= 0 || G <= 0) return cudaSuccess;
  const dim3 grid(G, (Q + kQueries - 1) / kQueries);
  k2nn_group_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(q_pf), static_cast<const uint4*>(pf),
      static_cast<const int*>(penrcol), static_cast<int*>(idx1), static_cast<int*>(idx2), Q,
      T, G);
  return cudaGetLastError();
}
