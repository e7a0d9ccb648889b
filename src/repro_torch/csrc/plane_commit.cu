// plane_commit: the packed wvalid/wdirty front end of every store.
//
// Replaces the Pallas TPU kernel `plane_commit_pallas`
// (src/repro/kernels/fused_turn/kernel.py:138, body `_commit_kernel`
// :116).  Per cache lane i: read the pre-op valid and dirty bits of word
// o[i] of block b[i] (b clamped into range, as the Pallas index map
// does), then OR in the set_valid / set_dirty bit.  The (lane, block)
// pairs never collide.
//
// The TPU kernel aliases both planes and touches one row per lane.  This
// port returns fresh planes, so the kernel copies them too: one thread
// per plane word copies it, and the one thread whose word is lane i's
// target (word t of lane i's slice [i*nb*L, (i+1)*nb*L)) applies the OR
// and writes was_valid[i] / was_dirty[i].  Copy and commit are one launch.
//
// Bound on the card: bytes.  It reads and writes both planes
// (4 * n*nb*L*4 bytes) plus the per-lane operands; at n=64 (nb=128, L=1)
// that is ~130 KB, 0.04 us at 3.35 TB/s, far under the launch time.
#include "common.cuh"

namespace {

__global__ void plane_commit_kernel(const int32_t* __restrict__ wv_in,
                                    const int32_t* __restrict__ wd_in,
                                    const int32_t* __restrict__ b,
                                    const int32_t* __restrict__ o,
                                    const bool* __restrict__ sv,
                                    const bool* __restrict__ sd,
                                    int32_t* __restrict__ wv_out,
                                    int32_t* __restrict__ wd_out,
                                    bool* __restrict__ was_v,
                                    bool* __restrict__ was_d,
                                    int n, int nb, int L) {
  const long long slice = static_cast<long long>(nb) * L;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
      + threadIdx.x;
  if (t >= n * slice) return;
  const int i = static_cast<int>(t / slice);
  const int bi = min(max(b[i], 0), nb - 1);
  // an offset outside the row's L lanes matches no lane, as in the Pallas
  // kernel's iota compare: the lane's first word takes an empty pattern
  const int lane = o[i] >> 5;
  const bool in_row = lane >= 0 && lane < L;
  uint32_t v = static_cast<uint32_t>(wv_in[t]);
  uint32_t d = static_cast<uint32_t>(wd_in[t]);
  if (t == i * slice + static_cast<long long>(bi) * L + (in_row ? lane : 0)) {
    const uint32_t bit = in_row ? 1u << (o[i] & 31) : 0u;
    was_v[i] = (v & bit) != 0;
    was_d[i] = (d & bit) != 0;
    if (sv[i]) v |= bit;
    if (sd[i]) d |= bit;
  }
  wv_out[t] = static_cast<int32_t>(v);
  wd_out[t] = static_cast<int32_t>(d);
}

}  // namespace

// wvalid/wdirty [n, nb, L] int32 bit patterns; b, o [n] int32;
// set_valid, set_dirty [n] bool -> fresh planes, was_valid, was_dirty.
REPRO_EXPORT int plane_commit_launch(const void* wvalid, const void* wdirty,
                                     const void* b, const void* o,
                                     const void* set_valid,
                                     const void* set_dirty, void* wv_out,
                                     void* wd_out, void* was_valid,
                                     void* was_dirty, int n, int nb, int L,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long words = static_cast<long long>(n) * nb * L;
  if (words > 0) {
    plane_commit_kernel<<<repro_cdiv(words, threads), threads, 0, s>>>(
        static_cast<const int32_t*>(wvalid),
        static_cast<const int32_t*>(wdirty), static_cast<const int32_t*>(b),
        static_cast<const int32_t*>(o), static_cast<const bool*>(set_valid),
        static_cast<const bool*>(set_dirty), static_cast<int32_t*>(wv_out),
        static_cast<int32_t*>(wd_out), static_cast<bool*>(was_valid),
        static_cast<bool*>(was_dirty), n, nb, L);
  }
  return static_cast<int>(cudaGetLastError());
}
