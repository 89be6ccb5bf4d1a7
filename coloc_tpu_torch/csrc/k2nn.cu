// Brute-force 512-bit Hamming 2-NN of Q queries against a resident bank.
//
// Replaces coloc_tpu/ops/hamming.py::_k2nn_kernel (:103, Pallas, launched by
// _k2nn_pallas_padded for hamming_2nn_bank). The TPU kernel turns Hamming
// distance into an int8 +-1 product on the MXU with a packed-key top-2
// epilogue; here the product is the tensor cores' 1-bit form, exact in
// integers:
//   acc = popc(q & t)   (mma.sync m16n8k256 .b1 .and.popc, two k-steps)
//   hd  = popc(q) + popc(t) - 2 acc
// on the packed words as they are stored. The SASS shows it as
// BMMA.168256.AND.POPC, native on sm_90a (chip_smoke.py phase 2 prints the
// MMA instructions `cuobjdump -sass` finds in this kernel).
//
// Bound: 2 Q T 512 operations (the TPU's int8 count) against Q*64 + T*68
// bytes: at every shape the main path uses, issue-bound. XOR + __popc
// costs 48 instructions a (query, row) pair, and a warp-a-query layout
// reads the whole bank again for every few queries and walks it serially
// in each block; the tensor cores take 256 bits of a 16 x 8 tile an
// instruction. Design:
//   - A CTA holds a tile of 64 queries in registers as mma A fragments (16
//     warps: 4 query groups of 16 rows x 4 column phases), so each staged
//     bank row serves 64 queries.
//   - Bank rows stream through a double-buffered ring of 256-row stages in
//     shared memory, filled by 16-byte cp.async copies (zero-filled past
//     the bank's end) while the previous stage is ranked. The thread that
//     copied a 16-byte piece popcounts it once its copy landed, and 4 lanes
//     sum a row: popc(t) + penalty is staged beside the rows, so Bank and
//     its callers stay as they are.
//   - The bank is split over a thread-block cluster of 8 CTAs, each
//     scanning 1/8 of the stages, so Q = 1024 fills 128 SMs in one wave at
//     any T and each CTA's walk is 1/8 as long. The CTAs merge their
//     per-query states through distributed shared memory in a fixed order
//     (no scratch, no atomics, one launch, deterministic). A last-block
//     counter would need a scratch buffer the wrapper does not allocate.
//   - The epilogue stays in registers: each thread keeps (best, second,
//     idx) for its 2 query rows over the columns its fragment holds, in
//     d - popc(q) form (one IMAD a distance), and skips a fragment when no
//     lane of the warp beats its second (a warp vote), exactly, since such
//     a push changes nothing.
//
// Semantics (equal to the TPU kernel and the plain twin in ops/hamming.py):
// best = second = 2048 and idx = -1 to start; an invalid bank row costs
// hd + 2048; a strict d < best shifts best into second, else d < second sets
// second, so a duplicate of the best becomes second and the lowest index
// wins ties; an invalid query reports 2048/2048 (its idx is kept).
// Ties: each thread visits its columns in ascending order, so its own state
// keeps the lowest index; every merge (lanes, column phases, cluster ranks)
// breaks equal bests on the index itself and sends the other best to
// second, so duplicates in another lane, phase or CTA become second too.
// An invalid row (d >= 2048) or a row past the bank's end (d >= 2^20) can
// never beat the starting 2048, so neither enters a state.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWords = 16;
constexpr int kInvalid = 2048;
constexpr int kFar = 1 << 20;                 // popc + penalty of a row past T
constexpr int kGroups = 4;                    // m16 query groups a CTA
constexpr int kPhases = 4;                    // column phases a query group
constexpr int kQueryTile = 16 * kGroups;      // 64 queries a CTA
constexpr int kThreads = 32 * kGroups * kPhases;  // 512
constexpr int kRows = 256;                    // bank rows a stage
constexpr int kChunks = kRows / 8;            // n8 fragments a stage
constexpr int kPieces = kRows * 4 / kThreads;  // 16-byte copies a thread a stage
constexpr int kSplit = 8;                     // CTAs a cluster, each 1/8 of the bank

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
// lower index. A state whose best is its start has idx -1 (no row beat it).
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool b_first = b.best < a.best || (b.best == a.best && b.idx < a.idx);
  const Top2 f = b_first ? b : a;
  const Top2 o = b_first ? a : b;
  return Top2{f.best, min(f.second, o.best), f.idx};
}

__device__ __forceinline__ Top2 shfl_xor(const Top2& s, int mask) {
  return Top2{__shfl_xor_sync(0xffffffffu, s.best, mask),
              __shfl_xor_sync(0xffffffffu, s.second, mask),
              __shfl_xor_sync(0xffffffffu, s.idx, mask)};
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// acc += popc(A & B) over one k-step of 256 bits: A is 16 query rows, B 8
// bank rows. Fragment layout (PTX ISA, mma.m16n8k256 .b1): lane (g, t) =
// (lane / 4, lane % 4) holds A rows g and g + 8 at k-ranges t and 4 + t,
// B column g at k-ranges t and 4 + t, and D rows g, g + 8 at columns 2t,
// 2t + 1. Which descriptor word sits at which k-range is free as long as A
// and B agree: here k-range t is word 4t + 2s and 4 + t is word 4t + 2s + 1
// in k-step s, so a lane's B operand is one 16-byte read of its bank row.
__device__ __forceinline__ void mma_and_popc(int (&acc)[4], unsigned a0, unsigned a1,
                                             unsigned a2, unsigned a3, unsigned b0,
                                             unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct Stage {
  uint4 rows[kRows * 4];  // 256 rows of 4 16-byte pieces
  int pen[kRows];
  int ptp[kRows];         // popc(row) + pen, or kFar past the bank's end
};

__global__ void __cluster_dims__(1, kSplit, 1) __launch_bounds__(kThreads)
k2nn_mma_kernel(const int* __restrict__ q, const unsigned char* __restrict__ q_valid,
                const int* __restrict__ t, const int* __restrict__ t_pen,
                int* __restrict__ idx_out, int* __restrict__ best_out,
                int* __restrict__ second_out, int Q, int T) {
  __shared__ Stage stage[2];
  __shared__ Top2 part[kPhases][kQueryTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp % kGroups, phase = warp / kGroups;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kQueryTile;

  // this lane's A fragments: words 4t..4t+3 of query rows g and g + 8
  uint4 qa = make_uint4(0u, 0u, 0u, 0u), qb = qa;
  const int ra = q0 + group * 16 + g, rb = ra + 8;
  if (ra < Q) {
    const unsigned* p = reinterpret_cast<const unsigned*>(q) + static_cast<size_t>(ra) * kWords + 4 * tq;
    qa = make_uint4(p[0], p[1], p[2], p[3]);
  }
  if (rb < Q) {
    const unsigned* p = reinterpret_cast<const unsigned*>(q) + static_cast<size_t>(rb) * kWords + 4 * tq;
    qb = make_uint4(p[0], p[1], p[2], p[3]);
  }
  int pqa = __popc(qa.x) + __popc(qa.y) + __popc(qa.z) + __popc(qa.w);
  int pqb = __popc(qb.x) + __popc(qb.y) + __popc(qb.z) + __popc(qb.w);
  pqa += __shfl_xor_sync(0xffffffffu, pqa, 1);
  pqa += __shfl_xor_sync(0xffffffffu, pqa, 2);
  pqb += __shfl_xor_sync(0xffffffffu, pqb, 1);
  pqb += __shfl_xor_sync(0xffffffffu, pqb, 2);
  // states hold d - popc(q): one IMAD a distance, undone at the end
  Top2 sa{kInvalid - pqa, kInvalid - pqa, -1};
  Top2 sb{kInvalid - pqb, kInvalid - pqb, -1};

  // this CTA's stages: a balanced 1/kSplit of the bank
  const int n_stages = (T + kRows - 1) / kRows;
  const int s_begin = static_cast<int>(static_cast<long long>(n_stages) * rank / kSplit);
  const int s_end = static_cast<int>(static_cast<long long>(n_stages) * (rank + 1) / kSplit);
  const uint4* tv = reinterpret_cast<const uint4*>(t);

  auto issue = [&](int s, int buf) {
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int c = threadIdx.x + k * kThreads;  // 16-byte piece of the stage
      const int row = s * kRows + (c >> 2);
      const bool in = row < T;
      cp_async16(&stage[buf].rows[c], in ? tv + static_cast<size_t>(row) * 4 + (c & 3) : tv,
                 in ? 16 : 0);
      if (in && (c & 3) == 0) cp_async4(&stage[buf].pen[c >> 2], t_pen + row);
    }
  };

  if (s_begin < s_end) issue(s_begin, 0);
  cp_async_commit();
  for (int s = s_begin; s < s_end; ++s) {
    const int buf = (s - s_begin) & 1;
    if (s + 1 < s_end) issue(s + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // this thread's copies of stage s have landed
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int c = threadIdx.x + k * kThreads;
      const uint4 w = stage[buf].rows[c];
      int pc = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
      pc += __shfl_xor_sync(0xffffffffu, pc, 1);
      pc += __shfl_xor_sync(0xffffffffu, pc, 2);
      const int row = s * kRows + (c >> 2);
      if ((c & 3) == 0) stage[buf].ptp[c >> 2] = row < T ? pc + stage[buf].pen[c >> 2] : kFar;
    }
    __syncthreads();  // the stage and its ptp are visible to every warp

    const int base = s * kRows;
#pragma unroll 2
    for (int ch = phase; ch < kChunks; ch += kPhases) {
      const int n0 = ch * 8;
      const uint4 bw = stage[buf].rows[(n0 + g) * 4 + tq];
      const int2 pt = *reinterpret_cast<const int2*>(&stage[buf].ptp[n0 + 2 * tq]);
      int acc[4] = {0, 0, 0, 0};
      mma_and_popc(acc, qa.x, qb.x, qa.y, qb.y, bw.x, bw.y);
      mma_and_popc(acc, qa.z, qb.z, qa.w, qb.w, bw.z, bw.w);
      const int d0 = pt.x - 2 * acc[0], d1 = pt.y - 2 * acc[1];
      const int d2 = pt.x - 2 * acc[2], d3 = pt.y - 2 * acc[3];
      const bool any = min(d0, d1) < sa.second || min(d2, d3) < sb.second;
      if (__any_sync(0xffffffffu, any)) {
        const int j = base + n0 + 2 * tq;
        push(sa, d0, j);
        push(sa, d1, j + 1);
        push(sb, d2, j);
        push(sb, d3, j + 1);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  // merge the 4 lanes of a row, then the column phases and the cluster's CTAs
  sa = merge(sa, shfl_xor(sa, 1));
  sa = merge(sa, shfl_xor(sa, 2));
  sb = merge(sb, shfl_xor(sb, 1));
  sb = merge(sb, shfl_xor(sb, 2));
  if (tq == 0) {
    part[phase][group * 16 + g] = sa;
    part[phase][group * 16 + g + 8] = sb;
  }
  cluster.sync();  // every CTA's partial states are written and visible

  // CTA `rank` finishes rows rank * 8 .. rank * 8 + 7 of the query tile
  constexpr int kRowsPerRank = kQueryTile / kSplit;
  if (threadIdx.x < kRowsPerRank) {
    const int r = rank * kRowsPerRank + threadIdx.x;
    const int qi = q0 + r;
    if (qi < Q) {
      Top2 s{0, 0, 0};
      for (int src = 0; src < kSplit; ++src) {
        const Top2* remote = cluster.map_shared_rank(&part[0][0], src);
        for (int p = 0; p < kPhases; ++p) {
          const Top2 o = remote[p * kQueryTile + r];
          s = (src == 0 && p == 0) ? o : merge(s, o);
        }
      }
      const unsigned* qw = reinterpret_cast<const unsigned*>(q) + static_cast<size_t>(qi) * kWords;
      int pq = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) pq += __popc(qw[w]);
      const bool valid = q_valid[qi] != 0;
      idx_out[qi] = s.idx;
      best_out[qi] = valid ? s.best + pq : kInvalid;
      second_out[qi] = valid ? s.second + pq : kInvalid;
    }
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

}  // namespace

// q (Q,16) int32, q_valid (Q,) bool, t (T,16) int32, t_pen (T,) int32 in
// {0, 2048}; outputs (Q,) int32 each. The bank's rows are copied 16 bytes
// at a time, so t must be 16-byte aligned (a PyTorch allocation is).
// Launches on `stream`, returns the launch's cudaError_t.
extern "C" int coloc_k2nn(const void* q, const void* q_valid, const void* t,
                          const void* t_pen, void* idx, void* best, void* second,
                          int Q, int T, int device, void* stream) {
  cudaError_t err = coloc::set_device(device);
  if (err != cudaSuccess) return err;
  if (Q <= 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(t) % 16 != 0) return cudaErrorMisalignedAddress;
  const dim3 grid((Q + kQueryTile - 1) / kQueryTile, kSplit);
  k2nn_mma_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<const unsigned char*>(q_valid),
      static_cast<const int*>(t), static_cast<const int*>(t_pen),
      static_cast<int*>(idx), static_cast<int*>(best), static_cast<int*>(second), Q, T);
  return cudaGetLastError();
}
