// drain_writeback: masked scatter-merge of drained L1 blocks into the L2
// bank (the sFIFO drain / block writeback of the protocol engine).
//
// Replaces the Pallas TPU kernel `drain_writeback_pallas`
// (src/repro/kernels/selective_flush/kernel.py:93) in both of its bodies:
// `_writeback_kernel_packed` (:75, a packed int32 lane mask [m, L],
// L = ceil(W/32)) and `_writeback_kernel` (:63, a bool mask [m, W], one
// byte a word: the REPRO_NO_PACK=1 layout).  One template serves both
// (kMask); only how a listed row's mask is loaded and turned into bits
// differs, and each has its own C entry.  That kernel sorts the index
// list and walks a sequential grid so duplicate destinations merge in list
// order.  Blocks on Hopper run in no order; here one launch does the whole
// merge, with an owner map of priorities in shared memory:
//
//   * The grid tiles the bank by destination rows, one wave of CTAs: CTA
//     c owns rows [c*R, (c+1)*R), R = min(kOwnerWords / W, ceil(nb/132)),
//     so each CTA takes a small share of the atomics (R=1 at n=64, nb=128;
//     R=4 at n=256, nb=512) and its owner map (R*W int32) fits 48 KB of
//     static shared memory.  Every CTA reads the whole index list.
//   * Phase A: the tile's l2 words (at most 3 16-byte units or 12 words a
//     thread) and the first kBatch (entry, chunk) pairs a thread (index and
//     mask chunk) are loaded into registers, straight-line and predicated
//     so all are in flight at once, and none is waited for before the
//     barrier; the map is zeroed.  A packed pair is (entry, 32-word lane).
//     A bool pair is (entry, 16-word chunk): the chunk's 16 mask bytes,
//     whose address depends on the list position only, are loaded in the
//     index's trip as one 16-byte unit (W % 16 == 0 and the mask 16-byte
//     aligned: W=16 is one uint4 an entry) and kept raw; otherwise they
//     are loaded byte by byte and turned into bits at once.
//   * Phase B, a warp at a time: the lanes whose pair lands in the tile
//     (pads, -1, and rows outside [0, nb) never do) are taken one after
//     another, and for each the warp's lanes test the chunk's words
//     together (words c*chunk + lane < W; the lane is read as uint32, so
//     bit 31 needs no care about arithmetic shifts), each offering the
//     priority i+1 with one atomicMax where its bit is set: distinct words,
//     no conflict inside the instruction; shared-memory atomics are native
//     on Hopper.  Max commutes: the last entry with the word dirty wins, as
//     in the reference, whatever order the atomics land in.  Raw mask
//     bytes become bits (one per nonzero byte) only in a warp that has a
//     pair in the tile: the others never wait for them.
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
// Under a bool mask every CTA reads the whole mask, m*W bytes (16 KB at
// n=64, 64 KB at n=256, mostly from L2), where the packed one reads m*L*4;
// that buys the same two trips in place of a third, dependent one (a
// landed row's mask read in phase B).  Turning the bytes into bits before
// the barrier made every warp wait for them and was slower than that
// dependent read at n=64 (PERF.md, the kernel table's findings).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWordsPerThread = 12;           // l2 words kept in registers
constexpr int kOwnerWords = kThreads * kWordsPerThread;  // 48 KB of map
constexpr int kBatch = 4;                     // pairs in flight a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWaveCtas = 132;                // the H100 SXM's SMs

// How a listed row's dirty mask is given, and so read: packed int32 lanes
// [m, ceil(W/32)]; or bool bytes [m, W], in 16-byte units (W % 16 == 0,
// the mask 16-byte aligned) or byte by byte.
enum Mask { kPacked, kBool16, kBoolBytes };

// Words of a pair's chunk: a packed lane's 32, or 16 mask bytes (one
// 16-byte unit).  An entry has L = ceil(W / chunk) pairs.
template <int kMask>
constexpr int kChunk = kMask == kPacked ? 32 : 16;

// The nonzero bytes of x as 4 bits, byte c at bit c (__vsetne4 gives 1 in
// each nonzero byte; the product moves bytes 0-3's bits 0, 8, 16, 24 to
// bits 21-24, with no carries).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return ((__vsetne4(x, 0u) * 0x00204081u) >> 21) & 0xfu;
}

// The loads of kBatch (entry, chunk) pairs p = p0 + t + k*kThreads: each
// pair's destination idx[p / L] (-1 past the end) and its chunk of the
// mask: the packed lane dirty[p], or 16 mask bytes.  The loads are
// straight-line and predicated, so every load of the batch is in flight
// at once, and none is waited for here: the bytes stay raw until
// `lane_of`, after the barrier, so each warp goes on as soon as its own
// loads are in.  (Only the byte path turns its bytes into bits as they
// arrive.)
struct Batch {
  int dst[kBatch];
  uint32_t lane[kBatch];   // the packed lane, or the byte path's bits
  uint4 raw[kBatch];       // kBool16: the chunk's 16 mask bytes
};

template <int kMask>
__device__ __forceinline__ void load_batch(Batch& q,
                                           const void* __restrict__ dirty,
                                           const int32_t* __restrict__ idx,
                                           int p0, int pairs, int L, int W) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int p = p0 + k * kThreads;
    const bool live = p < pairs;
    const int i = L == 1 ? p : p / L;
    q.dst[k] = live ? idx[i] : -1;
    if constexpr (kMask == kPacked) {
      q.lane[k] = live ? static_cast<uint32_t>(
                             static_cast<const int32_t*>(dirty)[p])
                       : 0u;
    } else {
      const int c0 = 16 * (p - i * L);            // the chunk's first word
      const uint8_t* row = static_cast<const uint8_t*>(dirty)
          + static_cast<long long>(i) * W + c0;
      if constexpr (kMask == kBool16) {
        q.raw[k] = live ? *reinterpret_cast<const uint4*>(row)
                        : make_uint4(0u, 0u, 0u, 0u);
      } else {
        uint32_t bits = 0u;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          bits |= live && c0 + c < W && row[c] != 0 ? 1u << c : 0u;
        }
        q.lane[k] = bits;
      }
    }
  }
}

// Pair k's chunk as bits, bit w for the chunk's word w.
template <int kMask>
__device__ __forceinline__ uint32_t lane_of(const Batch& q, int k) {
  if constexpr (kMask == kBool16) {
    return nonzero_bytes(q.raw[k].x) | nonzero_bytes(q.raw[k].y) << 4
        | nonzero_bytes(q.raw[k].z) << 8 | nonzero_bytes(q.raw[k].w) << 12;
  }
  return q.lane[k];
}

// Phase B for one batch, a warp at a time: each pair that lands in the
// tile's rows [row0, row0 + rows_here) in turn, its chunk's words tested
// by the warp's lanes together against the pair's bits (see the note
// above).
template <int kMask>
__device__ __forceinline__ void apply_batch(const Batch& q, int32_t* owner,
                                            int p0, int L, int W, int row0,
                                            int rows_here) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int row = q.dst[k] - row0;
    uint32_t todo = __ballot_sync(kFull, row >= 0 && row < rows_here);
    if (!todo) continue;                  // warp-uniform
    // only a warp with a pair in the tile waits for the mask bytes
    const uint32_t mine = lane_of<kMask>(q, k);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int r = __shfl_sync(kFull, row, src);
      const uint32_t bits = __shfl_sync(kFull, mine, src);
      const int p = p0 - lane + src + k * kThreads;   // the pair of lane src
      const int i = L == 1 ? p : p / L;
      const int w = kChunk<kMask> * (p - i * L) + lane;
      if (lane < kChunk<kMask> && w < W && ((bits >> lane) & 1u)) {
        atomicMax(owner + r * W + w, i + 1);
      }
    }
  }
}

// Offset of the row of owner o (priority o = entry + 1) in `rows`.
__device__ __forceinline__ long long row_of(int o, int W) {
  return static_cast<long long>(o - 1) * W;
}

template <bool kVec, int kMask>
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
  load_batch<kMask>(q, dirty, idx, t, pairs, L, W);
  const Unit zero{};
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int u = t + k * kThreads;
    if (u < units) ownu[u] = zero;
  }
  __syncthreads();

  // Phase B: priorities into the owner map, kBatch pairs at a time
  for (int p0 = t;;) {
    apply_batch<kMask>(q, owner, p0, L, W, row0, rows_here);
    p0 += kBatch * kThreads;
    if (p0 - t >= pairs) break;
    load_batch<kMask>(q, dirty, idx, p0, pairs, L, W);
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

using Kernel = decltype(&drain_writeback_kernel<true, kPacked>);

template <int kMask>
Kernel pick(bool vec) {
  return vec ? drain_writeback_kernel<true, kMask>
             : drain_writeback_kernel<false, kMask>;
}

// L: pairs an entry, ceil(W / kChunk) of the mask's kind
int launch(const void* l2, const void* rows, const void* dirty,
           const void* idx, void* out, int nb, int W, int m, int L,
           bool packed, cudaStream_t s) {
  if (W < 1 || W > kOwnerWords || nb < 1 || m < 0
      || L != (W + (packed ? 31 : 15)) / (packed ? 32 : 16)
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
  const bool mask16 = W % 16 == 0
      && (reinterpret_cast<uintptr_t>(dirty) & 15u) == 0;
  auto kernel = packed ? pick<kPacked>(vec)
      : mask16 ? pick<kBool16>(vec) : pick<kBoolBytes>(vec);
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
  return launch(l2, rows, dirty, idx, out, nb, W, m, L, true,
                static_cast<cudaStream_t>(stream));
}

// The same merge under a bool mask: dirty [m, W] bytes (nonzero: dirty),
// the rest as above.
REPRO_EXPORT int drain_writeback_bool_launch(const void* l2,
                                             const void* rows,
                                             const void* dirty,
                                             const void* idx, void* out,
                                             int nb, int W, int m,
                                             void* stream) {
  return launch(l2, rows, dirty, idx, out, nb, W, m, (W + 15) / 16, false,
                static_cast<cudaStream_t>(stream));
}
