// drain_writeback: masked scatter-merge of drained L1 blocks into the L2
// bank (the sFIFO drain / block writeback of the protocol engine).
//
// Replaces the Pallas TPU kernel `drain_writeback_pallas`
// (src/repro/kernels/selective_flush/kernel.py:93) in both of its bodies:
// `_writeback_kernel_packed` (:75, a packed int32 lane mask [m, L],
// L = ceil(W/32)) and `_writeback_kernel` (:63, a bool mask [m, W], one
// byte a word: the REPRO_NO_PACK=1 layout).  One template serves both
// (kBool); only how phase B reads a listed row's mask differs, and each has
// its own C entry.  That kernel sorts the index list and walks a
// sequential grid so duplicate destinations merge in list order.
// Blocks on Hopper run in no order; here one launch does the whole merge,
// with an owner map of priorities in shared memory:
//
//   * The grid tiles the bank by destination rows, one wave of CTAs: CTA
//     c owns rows [c*R, (c+1)*R), R = min(kOwnerWords / W, ceil(nb/132)),
//     so each CTA takes a small share of the atomics (R=1 at n=64, nb=128;
//     R=4 at n=256, nb=512) and its owner map (R*W int32) fits 48 KB of
//     static shared memory.  Every CTA reads the whole index list.
//   * Phase A: the tile's l2 words (at most 3 16-byte units or 12 words a
//     thread) and the first kBatch (entry, lane) pairs a thread are loaded
//     into registers, straight-line and predicated so all are in flight at
//     once and none is read before the barrier; the map is zeroed.
//   * Phase B, a warp at a time: the lanes whose pair lands in the tile
//     (pads, -1, and rows outside [0, nb) never do) are taken one after
//     another, and for each the 32 lanes test the 32 words of its packed
//     lane together (words 32*l + lane < W; the lane is read as uint32, so
//     bit 31 needs no care about arithmetic shifts), each offering the
//     priority i+1 with one atomicMax where its bit is set: distinct words,
//     no conflict inside the instruction; shared-memory atomics are native
//     on Hopper.  Max commutes: the last entry with the word dirty wins, as
//     in the reference, whatever order the atomics land in.  Under a bool
//     mask a pair is (entry, 32-word chunk) and no lane is loaded ahead:
//     lane w of the warp reads byte 32*l + w of the listed row's mask (one
//     coalesced 32-byte read, only for rows that land in the tile) and
//     tests it != 0.
//   * Phase C, after one barrier: out = owner ? rows[owner-1] : l2, in
//     16-byte units where W % 4 == 0 and l2, rows and out are 16-byte
//     aligned (one int4 load from rows when the unit's four owners agree),
//     else in 4-byte units; the loads are predicated, not branched.
//
// The output is a fresh bank (no aliasing with l2).  One call is one
// kernel launch: no memset, no scratch in device memory.
//
// Bound on the card: bytes.  The function must read each bank word once,
// from l2 or from the one row that owns it (nb*W*4 together), write the
// output bank (nb*W*4), and read the packed mask (m*L*4) and the index
// list (m*4): 4*(2*nb*W + m*L + m) bytes.  At n=64 (nb=128, W=16, L=1,
// m=1024) that is 24,576 B, 0.0073 us at 3.35 TB/s.  Under a bool mask the
// mask is m*W bytes: 4*(2*nb*W + m) + m*W = 36,864 B at n=64, 0.011 us.
// Neither rate sets the time at these sizes: the launch and the chain of
// two dependent memory trips (the index list and lanes, read by every CTA
// at once, then the owning rows) do, and on the CTAs that own the
// most-listed rows the atomics that land on one word one after another.
// The bool instance adds a third dependent trip, the listed row's mask
// bytes, on the rows that land in a CTA's tile.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWordsPerThread = 12;           // l2 words kept in registers
constexpr int kOwnerWords = kThreads * kWordsPerThread;  // 48 KB of map
constexpr int kBatch = 4;                     // pairs in flight a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWaveCtas = 132;                // the H100 SXM's SMs

// The raw loads of kBatch (entry, lane) pairs p = p0 + t + k*kThreads:
// each pair's destination idx[p / L] (-1 past the end) and, for a packed
// mask, its lane dirty[p].  Straight-line and predicated, so every load of
// the batch is in flight at once; nothing here waits for one.
struct Batch {
  int dst[kBatch];
  uint32_t lane[kBatch];
};

template <bool kBool>
__device__ __forceinline__ void load_batch(Batch& q,
                                           const void* __restrict__ dirty,
                                           const int32_t* __restrict__ idx,
                                           int p0, int pairs, int L) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int p = p0 + k * kThreads;
    const bool live = p < pairs;
    const int i = L == 1 ? p : p / L;
    q.dst[k] = live ? idx[i] : -1;
    if constexpr (!kBool) {
      q.lane[k] = live ? static_cast<uint32_t>(
                             static_cast<const int32_t*>(dirty)[p])
                       : 0u;
    }
  }
}

// Phase B for one batch, a warp at a time: each pair that lands in the
// tile's rows [row0, row0 + rows_here) in turn, its 32 words of chunk
// p % L tested by the 32 lanes together (see the note above): from the
// packed lane, or from the bool mask's bytes.
template <bool kBool>
__device__ __forceinline__ void apply_batch(const Batch& q, int32_t* owner,
                                            const void* __restrict__ dirty,
                                            int p0, int L, int W, int row0,
                                            int rows_here) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int row = q.dst[k] - row0;
    uint32_t todo = __ballot_sync(kFull, row >= 0 && row < rows_here);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int r = __shfl_sync(kFull, row, src);
      const int p = p0 - lane + src + k * kThreads;   // the pair of lane src
      const int i = L == 1 ? p : p / L;
      const int w = 32 * (p - i * L) + lane;
      bool on;
      if constexpr (kBool) {
        on = w < W && static_cast<const uint8_t*>(
                           dirty)[static_cast<long long>(i) * W + w] != 0;
      } else {
        const uint32_t bits = __shfl_sync(kFull, q.lane[k], src);
        on = w < W && ((bits >> lane) & 1u);
      }
      if (on) atomicMax(owner + r * W + w, i + 1);
    }
  }
}

// Offset of the row of owner o (priority o = entry + 1) in `rows`.
__device__ __forceinline__ long long row_of(int o, int W) {
  return static_cast<long long>(o - 1) * W;
}

template <bool kVec, bool kBool>
__global__ void __launch_bounds__(kThreads, 1)
drain_writeback_kernel(const int32_t* __restrict__ l2,
                       const int32_t* __restrict__ rows,
                       const void* __restrict__ dirty,
                       const int32_t* __restrict__ idx,
                       int32_t* __restrict__ out, int nb, int W, int m,
                       int L, int R) {
  using Unit = typename std::conditional<kVec, int4, int32_t>::type;
  constexpr int kU = kVec ? 4 : 1;                   // words per unit
  constexpr int kPer = kWordsPerThread / kU;         // units a thread
  __shared__ __align__(16) int32_t owner[kOwnerWords];

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int rows_here = min(R, nb - row0);
  const int units = rows_here * W / kU;
  const long long base = static_cast<long long>(row0) * W;
  const Unit* l2u = reinterpret_cast<const Unit*>(l2 + base);
  Unit* outu = reinterpret_cast<Unit*>(out + base);
  Unit* ownu = reinterpret_cast<Unit*>(owner);
  const int pairs = m * L;

  // Phase A: the tile's l2 words and the first pairs in flight (read only
  // after the barrier, so their latency overlaps it); zero the map
  Unit keep[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int u = t + k * kThreads;
    if (u < units) keep[k] = l2u[u];
  }
  Batch q;
  load_batch<kBool>(q, dirty, idx, t, pairs, L);
  const Unit zero{};
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int u = t + k * kThreads;
    if (u < units) ownu[u] = zero;
  }
  __syncthreads();

  // Phase B: priorities into the owner map, kBatch pairs at a time
  for (int p0 = t;;) {
    apply_batch<kBool>(q, owner, dirty, p0, L, W, row0, rows_here);
    p0 += kBatch * kThreads;
    if (p0 - t >= pairs) break;
    load_batch<kBool>(q, dirty, idx, p0, pairs, L);
  }
  __syncthreads();

  // Phase C: each word from its owning row, else from l2.  The loads are
  // predicated, not branched, so a unit's loads are in flight together.
  const int upr = W / kU;                             // units a row
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int u = t + k * kThreads;
    if (u >= units) continue;
    const int c = (u % upr) * kU;                     // first word's column
    Unit v = keep[k];
    if constexpr (kVec) {
      const int4 o = ownu[u];
      if (o.x == o.y && o.y == o.z && o.z == o.w) {
        if (o.x) {
          v = *reinterpret_cast<const int4*>(rows + row_of(o.x, W) + c);
        }
      } else {
        v.x = o.x ? rows[row_of(o.x, W) + c] : v.x;
        v.y = o.y ? rows[row_of(o.y, W) + c + 1] : v.y;
        v.z = o.z ? rows[row_of(o.z, W) + c + 2] : v.z;
        v.w = o.w ? rows[row_of(o.w, W) + c + 3] : v.w;
      }
    } else {
      const int o = ownu[u];
      v = o ? rows[row_of(o, W) + c] : v;
    }
    outu[u] = v;
  }
}

template <bool kBool>
int launch(const void* l2, const void* rows, const void* dirty,
           const void* idx, void* out, int nb, int W, int m, int L,
           cudaStream_t s) {
  if (W < 1 || W > kOwnerWords || nb < 1 || m < 0 || L != (W + 31) / 32
      || static_cast<long long>(m) * L > INT32_MAX - kBatch * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // rows a CTA: the bank spread over one wave of CTAs, so each CTA's
  // share of the atomics is small; at most what its owner map holds
  const int R = min(kOwnerWords / W, repro_cdiv(nb, kWaveCtas));
  const int grid = repro_cdiv(nb, R);
  const bool vec = W % 4 == 0
      && ((reinterpret_cast<uintptr_t>(l2) | reinterpret_cast<uintptr_t>(rows)
           | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  auto kernel = vec ? drain_writeback_kernel<true, kBool>
                    : drain_writeback_kernel<false, kBool>;
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(l2), static_cast<const int32_t*>(rows),
      dirty, static_cast<const int32_t*>(idx), static_cast<int32_t*>(out),
      nb, W, m, L, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// l2 [nb, W], rows [m, W], dirty [m, L] packed, idx [m], all int32 ->
// out [nb, W] int32.  W <= kOwnerWords (the wrapper raises above).
REPRO_EXPORT int drain_writeback_launch(const void* l2, const void* rows,
                                        const void* dirty, const void* idx,
                                        void* out, int nb, int W, int m,
                                        int L, void* stream) {
  return launch<false>(l2, rows, dirty, idx, out, nb, W, m, L,
                       static_cast<cudaStream_t>(stream));
}

// The same merge under a bool mask: dirty [m, W] bytes (0 or 1), the rest
// as above.
REPRO_EXPORT int drain_writeback_bool_launch(const void* l2,
                                             const void* rows,
                                             const void* dirty,
                                             const void* idx, void* out,
                                             int nb, int W, int m,
                                             void* stream) {
  return launch<true>(l2, rows, dirty, idx, out, nb, W, m, (W + 31) / 32,
                      static_cast<cudaStream_t>(stream));
}
