// plane_commit: the packed wvalid/wdirty front end of every store.
//
// Replaces the Pallas TPU kernel `plane_commit_pallas`
// (src/repro/kernels/fused_turn/kernel.py:138, body `_commit_kernel`
// :116).  Per cache lane i: read the pre-op valid and dirty bits of word
// o[i] of block b[i] (b clamped into [0, nb), as the Pallas index map
// does; an offset outside the row's L words matches no word, as the
// kernel's iota compare does, so the lane's first word of the block takes
// an empty pattern), then OR in the set_valid / set_dirty bit.  The
// (lane, block) pairs never collide.
//
// The TPU kernel aliases both planes and touches one row per lane.  This
// port returns fresh planes (a Store is a value; an older Store may still
// hold the pre-op planes), so the kernel is a streaming copy of both
// planes with one bit ORed into one word of each lane, in one memory
// trip:
//
//   * One thread per word u of the n*nb*L words of a plane, 256 a CTA.
//     Its lane is i = u / S (S = nb*L words a lane; 32-bit arithmetic,
//     n*S < 2^31 is checked at launch), known from the thread index
//     alone, so word u of both planes and the lane's b, o, set_valid and
//     set_dirty are all loaded in one straight-line burst: no load waits
//     for another.  The OR is branch-free (the bit is 0 off the target
//     word), so every thread needs set_valid/set_dirty and none reads
//     them in a second trip; a warp's threads share a lane's operands,
//     one transaction each.  The thread holding lane i's target word
//     writes was_valid[i] / was_dirty[i] from the pre-op words; every
//     thread stores its two words.
//   * Measured against the alternatives on the card (PERF.md §6):
//     CTAs owning whole lanes with the operands staged in shared memory
//     behind a barrier, in 16-byte units, and one thread per 16-byte
//     unit without the barrier, were both slower at the n=64 shape.
//
// Bound on the card: bytes.  It reads and writes both planes
// (4 * n*nb*L*4 bytes) plus the per-lane operands (10n bytes) and the
// flags (2n); at n=64 (nb=128, L=1) that is ~132 KB, 0.04 us at
// 3.35 TB/s, far under the launch time; at n=256 (nb=512) 2.1 MB,
// 0.63 us.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
plane_commit_kernel(const int32_t* __restrict__ wv_in,
                    const int32_t* __restrict__ wd_in,
                    const int32_t* __restrict__ b,
                    const int32_t* __restrict__ o,
                    const unsigned char* __restrict__ sv,
                    const unsigned char* __restrict__ sd,
                    int32_t* __restrict__ wv_out,
                    int32_t* __restrict__ wd_out, bool* __restrict__ was_v,
                    bool* __restrict__ was_d, int n, int nb, int L) {
  const int S = nb * L;
  const int u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= n * S) return;
  const int i = u / S;
  // the burst: nothing below waits on another load
  const int bi_in = __ldg(b + i);
  const int oi = __ldg(o + i);
  const bool svi = __ldg(sv + i);
  const bool sdi = __ldg(sd + i);
  uint32_t v = static_cast<uint32_t>(__ldg(wv_in + u));
  uint32_t d = static_cast<uint32_t>(__ldg(wd_in + u));
  const int bi = min(max(bi_in, 0), nb - 1);
  const int w = oi >> 5;
  const bool in_row = w >= 0 && w < L;
  const bool hit = u == i * S + bi * L + (in_row ? w : 0);
  const uint32_t bit = hit && in_row ? 1u << (oi & 31) : 0u;
  if (hit) {
    was_v[i] = (v & bit) != 0;
    was_d[i] = (d & bit) != 0;
  }
  v |= svi ? bit : 0u;
  d |= sdi ? bit : 0u;
  wv_out[u] = static_cast<int32_t>(v);
  wd_out[u] = static_cast<int32_t>(d);
}

}  // namespace

// wvalid/wdirty [n, nb, L] int32 bit patterns; b, o [n] int32;
// set_valid, set_dirty [n] bool -> fresh planes, was_valid, was_dirty.
// The outputs must not overlap the inputs.
REPRO_EXPORT int plane_commit_launch(const void* wvalid, const void* wdirty,
                                     const void* b, const void* o,
                                     const void* set_valid,
                                     const void* set_dirty, void* wv_out,
                                     void* wd_out, void* was_valid,
                                     void* was_dirty, int n, int nb, int L,
                                     void* stream) {
  const long long words = static_cast<long long>(n) * nb * L;
  if (words <= 0) return static_cast<int>(cudaSuccess);
  if (words > INT32_MAX - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plane_commit_kernel<<<repro_cdiv(words, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wvalid),
      static_cast<const int32_t*>(wdirty), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(o),
      static_cast<const unsigned char*>(set_valid),
      static_cast<const unsigned char*>(set_dirty),
      static_cast<int32_t*>(wv_out), static_cast<int32_t*>(wd_out),
      static_cast<bool*>(was_valid), static_cast<bool*>(was_dirty), n, nb,
      L);
  return static_cast<int>(cudaGetLastError());
}
