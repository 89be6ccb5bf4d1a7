// Brute-force 512-bit Hamming 2-NN of Q queries against a resident bank.
//
// Replaces coloc_tpu/ops/hamming.py::_k2nn_kernel (Pallas, launched by
// _k2nn_pallas_padded for hamming_2nn_bank). The TPU kernel turns Hamming
// distance into an int8 +-1 matmul on the MXU with a packed-key top-2
// epilogue. Here it is the reference CUDAK2NN form instead: XOR + __popc
// over the 16 packed words, no matmul.
//
// Bound: at Q=1024, T=4096 the work is 67M word XOR+popcounts (~0.13 GOP)
// over a 256 KB bank, so neither bandwidth nor arithmetic is large; the
// kernel is bound by issue rate and by how many warps are in flight. Design:
// one warp per query (8 per block, grid Q/8 = 128 blocks at Q=1024); each
// block stages 256 bank rows at a time in shared memory, padded to 17 words a
// row so the 32 lanes, each on its own row, read 32 different banks. Each
// lane keeps a running (best, second, idx) over its rows in ascending order,
// then the warp merges the 32 partial states with shuffles.
//
// Semantics (equal to the TPU kernel and the plain twin in ops/hamming.py):
// best = second = 2048 and idx = -1 to start; an invalid bank row costs
// hd + 2048; a strict d < best shifts best into second, else d < second sets
// second, so a duplicate of the best becomes second and the lowest index
// wins ties; an invalid query reports 2048/2048 (its idx is kept).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWords = 16;
constexpr int kInvalid = 2048;
constexpr int kWarps = 8;            // queries per block, one warp each
constexpr int kTile = 256;           // bank rows per shared-memory stage
constexpr int kStride = kWords + 1;  // padded row stride (bank-conflict free)

struct Top2 {
  int best, second, idx;
};

__device__ __forceinline__ void push(Top2& s, int d, int j) {
  if (d < s.best) {
    s.second = s.best;
    s.best = d;
    s.idx = j;
  } else if (d < s.second) {
    s.second = d;
  }
}

// The two smallest of the union of two partial states; equal bests go to the
// lower index. A state whose best is 2048 has idx -1 (no row ever beat it).
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool b_first = b.best < a.best || (b.best == a.best && b.idx < a.idx);
  const Top2 f = b_first ? b : a;
  const Top2 o = b_first ? a : b;
  return Top2{f.best, min(f.second, o.best), f.idx};
}

__global__ void __launch_bounds__(kWarps * 32)
k2nn_kernel(const int* __restrict__ q, const unsigned char* __restrict__ q_valid,
            const int* __restrict__ t, const int* __restrict__ t_pen,
            int* __restrict__ idx_out, int* __restrict__ best_out,
            int* __restrict__ second_out, int Q, int T) {
  __shared__ unsigned int tile[kTile * kStride];
  __shared__ int pen[kTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  const bool active = qi < Q;

  unsigned int qw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    qw[w] = active ? static_cast<unsigned int>(q[static_cast<size_t>(qi) * kWords + w]) : 0u;

  Top2 s{kInvalid, kInvalid, -1};
  for (int base = 0; base < T; base += kTile) {
    const int rows = min(kTile, T - base);
    __syncthreads();  // the previous stage is fully read
    for (int k = threadIdx.x; k < rows * kWords; k += blockDim.x) {
      const int r = k / kWords;
      tile[r * kStride + (k % kWords)] =
          static_cast<unsigned int>(t[static_cast<size_t>(base) * kWords + k]);
    }
    for (int r = threadIdx.x; r < rows; r += blockDim.x) pen[r] = t_pen[base + r];
    __syncthreads();
    for (int r = lane; r < rows; r += 32) {
      const unsigned int* row = tile + r * kStride;
      int d = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) d += __popc(qw[w] ^ row[w]);
      push(s, d + pen[r], base + r);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.best = __shfl_down_sync(0xffffffffu, s.best, off);
    o.second = __shfl_down_sync(0xffffffffu, s.second, off);
    o.idx = __shfl_down_sync(0xffffffffu, s.idx, off);
    s = merge(s, o);
  }
  if (active && lane == 0) {
    const bool valid = q_valid[qi] != 0;
    idx_out[qi] = s.idx;
    best_out[qi] = valid ? s.best : kInvalid;
    second_out[qi] = valid ? s.second : kInvalid;
  }
}

}  // namespace

// q (Q,16) int32, q_valid (Q,) bool, t (T,16) int32, t_pen (T,) int32 in
// {0, 2048}; outputs (Q,) int32 each. Launches on `stream`, returns the
// launch's cudaError_t.
extern "C" int coloc_k2nn(const void* q, const void* q_valid, const void* t,
                          const void* t_pen, void* idx, void* best, void* second,
                          int Q, int T, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (Q <= 0) return cudaSuccess;
  const dim3 grid((Q + kWarps - 1) / kWarps);
  k2nn_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<const unsigned char*>(q_valid),
      static_cast<const int*>(t), static_cast<const int*>(t_pen),
      static_cast<int*>(idx), static_cast<int*>(best), static_cast<int*>(second), Q, T);
  return cudaGetLastError();
}
