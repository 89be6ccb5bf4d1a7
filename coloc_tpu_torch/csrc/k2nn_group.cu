// Group-local top-2 of a 128-bit prefilter: the first stage of the
// two-stage large-bank matcher.
//
// Replaces coloc_tpu/ops/hamming.py::_make_k2nn_group_kernel (:360, Pallas,
// launched by _group_top2_pallas for hamming_2nn_twostage). For every query
// and every group of 2048 bank rows it returns the global rows of the two
// largest keys (dot << 16) + penrcol[row], where dot is the +-1 product of
// the 128 prefilter bits (every fourth descriptor bit) and penrcol packs
// the invalid-row penalty with the reversed in-group column, so keys are
// unique and the lower row wins an equal dot. A padding row past the bank's
// end has a zero operand on the TPU, so its dot is 0 here too, whatever
// its stored bits. The plain twin is ops/hamming.py::group_top2_plain;
// integer keys make it exact.
//
// The dot on the tensor cores, as a 1-bit product (as B1, k2nn.cu):
//   and = popc(q & t)   (mma.sync m16n8k128 .b1 .and.popc, one instruction
//                        a 16 x 8 tile of (query, row) pairs)
//   dot = 128 - 2 popc(q) - 2 popc(t) + 4 and
// Within one (query, group) the term (128 - 2 popc q) << 16 is shared by
// every real row, so the real rows are ranked on
//   key' = (and << 18) + rt,   rt = penrcol - (popc(t) << 17)
// which is the key less that shared term: the same order, and the same low
// 16 bits (rcol), so the same indices. A padding row's key' is penrcol less
// the shared term; only a group that holds rows past T takes that branch,
// warp-uniformly a fragment. Every magnitude stays below 2^29 in int32.
//
// Bound: at Q = 1024 against 262144 rows the work is 268M (query, row)
// pairs at 128 bits, counted as the TPU kernel's int8 product, 2 Q T 128 =
// 6.9e13 operations: 0.035 ms at 1979 TOP/s; the inputs are 5.3 MB. The
// former design (a warp a query, a lane 64 rows) issued 4 XOR + 4 POPC a
// pair and was bound by POPC's issue rate. Design:
//   - A CTA of 16 warps holds 128 queries in registers as mma A fragments
//     (4 query sets of 2 m16 tiles x 4 column phases), so each staged row
//     serves 128 queries and each B fragment two MMAs.
//   - A CTA walks a run of consecutive groups (as many as fill the card
//     about twice); each group's 2048 rows (32 KB) and their penrcol (8 KB)
//     come into a double buffer in shared memory by cp.async, the next
//     group's copies in flight while one is ranked (rows past T zero-
//     filled). The thread that copied 4 rows popcounts them once they
//     land and stores their rt in place of their penrcol.
//   - A lane keeps (k1, k2) for each query row of its C fragments over the
//     columns it holds: a key (one IMAD) and 3 integer min/max a pair.
//     Keys are unique, so every top-2 is a set and merges need no tie
//     rule: the 4 lanes of a row by shuffles, the 4 column phases through
//     shared memory.
//   - That epilogue sets the time: integer min/max issue at half rate, and
//     the MMAs, alone, take a little more than the bound and hide under it
//     (scripts/prof_torch_rank_split.py). No fragment is skipped: a warp
//     vote that skips one when no lane's key beats its second is exact,
//     but a lane's top-2 sees only 128 of a group's 2048 columns and a
//     fragment pair holds 128 lane-rows, so at the c-th fragment of a group
//     some lane must push with probability about 1 - exp(-256 / c), near 1
//     up to the group's last (the 64th): its compares are pure cost.
//   - The run's results stay in shared memory until its last group, then
//     every query's run of consecutive groups is written at once.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kGroup = 2048;
constexpr int kTiles = 2;                                // m16 query tiles a warp
constexpr int kSets = 4;                                 // warps along the queries
constexpr int kPhases = 4;                               // warps along a group's columns
constexpr int kThreads = 32 * kSets * kPhases;           // 512
constexpr int kQueryTile = 16 * kTiles * kSets;          // 128 queries a CTA
constexpr int kChunks = kGroup / 8;                      // n8 fragments a group
constexpr int kRowsPerThread = kGroup / kThreads;        // 4 rows staged a thread
constexpr int kMaxRun = 8;                               // groups a CTA at most

struct Stage {
  uint4 rows[kGroup];  // the group's prefilter rows, 16 bytes each
  int rt[kGroup];      // penrcol as copied, then penrcol - (popc(row) << 17)
};

struct Smem {
  Stage stage[2];
  int2 part[kPhases][kQueryTile];  // (k1, k2) of each column phase
  int2 out[kMaxRun][kQueryTile];   // (idx1, idx2) of the run's groups
};

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

// acc = popc(A & B) over 128 bits: A is 16 query rows, B 8 bank rows.
// Fragment layout (PTX ISA, mma.m16n8k128 .b1): lane (g, t) = (lane / 4,
// lane % 4) holds A rows g and g + 8 at k-range t (32 bits), B column g at
// k-range t, and D rows g, g + 8 at columns 2t, 2t + 1. Which prefilter
// word sits at which k-range is free as long as A and B agree: k-range t is
// word t, so a lane's B operand is word t of its bank row.
__device__ __forceinline__ void mma_and_popc(int (&acc)[4], unsigned a0, unsigned a1,
                                             unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=r"(acc[0]), "=r"(acc[1]), "=r"(acc[2]), "=r"(acc[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(0));
}

// (k1, k2) <- the two largest of {k1, k2, x, y} (all distinct)
__device__ __forceinline__ void push2(int& k1, int& k2, int x, int y) {
  const int hi = max(x, y), lo = min(x, y);
  k2 = max(max(k2, lo), min(k1, hi));
  k1 = max(k1, hi);
}

// the two largest of two disjoint top-2 sets
__device__ __forceinline__ int2 merge2(int2 a, int2 b) {
  return make_int2(max(a.x, b.x), max(min(a.x, b.x), max(a.y, b.y)));
}

__device__ __forceinline__ int2 shfl_xor2(int2 s, int mask) {
  return make_int2(__shfl_xor_sync(0xffffffffu, s.x, mask),
                   __shfl_xor_sync(0xffffffffu, s.y, mask));
}

__global__ void __launch_bounds__(kThreads, 2)
k2nn_group_kernel(const unsigned* __restrict__ q_pf, const uint4* __restrict__ pf,
                  const int* __restrict__ penrcol, int* __restrict__ idx1,
                  int* __restrict__ idx2, int Q, int T, int G, int run) {
  extern __shared__ uint4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int set = warp % kSets, phase = warp / kSets;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kQueryTile;
  const int g_begin = blockIdx.y * run;
  const int g_end = min(G, g_begin + run);

  // this lane's A fragments (word tq of query rows r and r + 8 of each
  // tile) and each row's shared key term (128 - 2 popc q) << 16
  unsigned a[kTiles][2];
  int cq[kTiles][2];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + (set * kTiles + i) * 16 + g + 8 * h;
      a[i][h] = row < Q ? q_pf[static_cast<size_t>(row) * 4 + tq] : 0u;
      int pc = __popc(a[i][h]);
      pc += __shfl_xor_sync(0xffffffffu, pc, 1);
      pc += __shfl_xor_sync(0xffffffffu, pc, 2);
      cq[i][h] = (128 - 2 * pc) * 65536;
    }
  }

  // thread x stages rows 4x .. 4x + 3 of a group and their penrcol
  const int r0 = threadIdx.x * kRowsPerThread;
  auto issue = [&](int grp, int buf) {
    const size_t base = static_cast<size_t>(grp) * kGroup;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const bool real = static_cast<long long>(base) + r0 + k < T;
      cp_async16(&sm.stage[buf].rows[r0 + k], real ? pf + base + r0 + k : pf, real ? 16 : 0);
      cp_async4(&sm.stage[buf].rt[r0 + k], penrcol + base + r0 + k);
    }
  };

  if (g_begin < g_end) issue(g_begin, 0);
  cp_async_commit();
  for (int grp = g_begin; grp < g_end; ++grp) {
    const int buf = (grp - g_begin) & 1;
    Stage& st = sm.stage[buf];
    if (grp + 1 < g_end) issue(grp + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // this thread's copies of group grp have landed
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const uint4 w = st.rows[r0 + k];
      const int pt = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
      st.rt[r0 + k] -= pt * 131072;
    }
    __syncthreads();  // the group's rows and rt are visible to every warp

    int k1[kTiles][2], k2[kTiles][2];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) k1[i][0] = k1[i][1] = k2[i][0] = k2[i][1] = INT_MIN;
    const int real = T - grp * kGroup;  // columns from here on are padding
    const unsigned* rows = reinterpret_cast<const unsigned*>(st.rows);
#pragma unroll 4
    for (int ch = phase; ch < kChunks; ch += kPhases) {
      const int n0 = ch * 8;
      const unsigned b = rows[(n0 + g) * 4 + tq];
      const int2 rt = *reinterpret_cast<const int2*>(&st.rt[n0 + 2 * tq]);
      int key[kTiles][4];
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        int acc[4];
        mma_and_popc(acc, a[i][0], a[i][1], b);
        key[i][0] = acc[0] * 262144 + rt.x;
        key[i][1] = acc[1] * 262144 + rt.y;
        key[i][2] = acc[2] * 262144 + rt.x;
        key[i][3] = acc[3] * 262144 + rt.y;
      }
      if (n0 + 8 > real) {  // warp-uniform: a fragment with padding columns
        const int c0 = n0 + 2 * tq;
#pragma unroll
        for (int i = 0; i < kTiles; ++i) {
          if (c0 >= real) {
            key[i][0] -= cq[i][0];
            key[i][2] -= cq[i][1];
          }
          if (c0 + 1 >= real) {
            key[i][1] -= cq[i][0];
            key[i][3] -= cq[i][1];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        push2(k1[i][0], k2[i][0], key[i][0], key[i][1]);
        push2(k1[i][1], k2[i][1], key[i][2], key[i][3]);
      }
    }

    // merge the 4 lanes of a row, then the column phases
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int2 s = make_int2(k1[i][h], k2[i][h]);
        s = merge2(s, shfl_xor2(s, 1));
        s = merge2(s, shfl_xor2(s, 2));
        if (tq == 0) sm.part[phase][(set * kTiles + i) * 16 + g + 8 * h] = s;
      }
    }
    __syncthreads();  // every phase's states are in; the stage is free
    if (threadIdx.x < kQueryTile) {
      int2 s = sm.part[0][threadIdx.x];
#pragma unroll
      for (int p = 1; p < kPhases; ++p) s = merge2(s, sm.part[p][threadIdx.x]);
      const int base = grp * kGroup + kGroup - 1;
      sm.out[grp - g_begin][threadIdx.x] = make_int2(base - (s.x & 65535), base - (s.y & 65535));
    }
  }
  __syncthreads();  // the run's results are in shared memory

  // each query's run of consecutive groups, written together
  const int n_run = g_end - g_begin;
  for (int e = threadIdx.x; e < kQueryTile * n_run; e += kThreads) {
    const int qq = e / n_run, j = e - qq * n_run;
    if (q0 + qq < Q) {
      const size_t o = static_cast<size_t>(q0 + qq) * G + g_begin + j;
      const int2 v = sm.out[j][qq];
      idx1[o] = v.x;
      idx2[o] = v.y;
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
  if (reinterpret_cast<uintptr_t>(pf) % 16 != 0) return cudaErrorMisalignedAddress;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // groups a CTA: enough CTAs for two on every SM, each staging its query
  // fragments once for a run of consecutive groups
  const int q_tiles = (Q + kQueryTile - 1) / kQueryTile;
  const long long want = 2LL * sms;
  int run = static_cast<int>((static_cast<long long>(q_tiles) * G + want - 1) / want);
  run = run < 1 ? 1 : (run > kMaxRun ? kMaxRun : run);
  const size_t smem = sizeof(Smem);
  err = cudaFuncSetAttribute(k2nn_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(q_tiles, (G + run - 1) / run);
  k2nn_group_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(q_pf), static_cast<const uint4*>(pf),
      static_cast<const int*>(penrcol), static_cast<int*>(idx1), static_cast<int*>(idx2), Q,
      T, G, run);
  return cudaGetLastError();
}
