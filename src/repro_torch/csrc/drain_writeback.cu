// drain_writeback: masked scatter-merge of drained L1 blocks into the L2
// bank (the sFIFO drain / block writeback of the protocol engine).
//
// Replaces the Pallas TPU kernel `drain_writeback_pallas`
// (src/repro/kernels/selective_flush/kernel.py:93, body
// `_writeback_kernel_packed` :75).  That kernel sorts the index list and
// walks a sequential grid so duplicate destinations merge in list order.
// Blocks on Hopper run in no order, so the merge is two passes instead:
//
//   1. owner pass, one thread per (entry i, word w): where entry i is a
//      real destination (0 <= idx[i] < nb) and word w is dirty, atomicMax
//      the priority i+1 into owner[idx[i], w] (zeroed first).  The dirty
//      bit is expanded in register from the packed int32 lane:
//      (lane >> (w & 31)) & 1, exact after the & 1 although >> is
//      arithmetic;
//   2. merge pass, one thread per bank word: out = rows[owner-1, w] where
//      an owner exists, else l2.
//
// Max commutes, so the result is deterministic: the last list entry with
// the word dirty wins, as in the reference.  The output is a fresh bank
// (no aliasing with l2).
//
// Bound on the card: bytes.  The function must read each bank word once,
// from l2 or from the one row that owns it (nb*W*4 together), write the
// output bank (nb*W*4), and read the packed mask (m*L*4) and the index
// list (m*4): 4*(2*nb*W + m*L + m) bytes.  At n=64 (nb=128, W=16, L=1,
// m=1024) that is 24,576 B, 0.0073 us at 3.35 TB/s.  It does one compare
// or move per word, so at these sizes it is bound by the launch, not by
// either rate.
#include "common.cuh"

namespace {

__global__ void owner_pass(const int32_t* __restrict__ dirty,
                           const int32_t* __restrict__ idx,
                           int32_t* __restrict__ owner,
                           int m, int nb, int W, int L) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
      + threadIdx.x;
  if (t >= static_cast<long long>(m) * W) return;
  const int i = static_cast<int>(t / W);
  const int w = static_cast<int>(t - static_cast<long long>(i) * W);
  const int b = idx[i];
  if (b < 0 || b >= nb) return;
  const int32_t lane = dirty[static_cast<long long>(i) * L + (w >> 5)];
  if ((lane >> (w & 31)) & 1) {
    atomicMax(&owner[static_cast<long long>(b) * W + w], i + 1);
  }
}

__global__ void merge_pass(const int32_t* __restrict__ l2,
                           const int32_t* __restrict__ rows,
                           const int32_t* __restrict__ owner,
                           int32_t* __restrict__ out, int nb, int W) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
      + threadIdx.x;
  if (t >= static_cast<long long>(nb) * W) return;
  const int o = owner[t];
  out[t] = o > 0 ? rows[static_cast<long long>(o - 1) * W + (t % W)]
                 : l2[t];
}

}  // namespace

// l2 [nb, W], rows [m, W], dirty [m, L] packed, idx [m], all int32;
// owner [nb, W] int32 scratch; out [nb, W] int32.
REPRO_EXPORT int drain_writeback_launch(const void* l2, const void* rows,
                                        const void* dirty, const void* idx,
                                        void* owner, void* out, int nb,
                                        int W, int m, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  cudaMemsetAsync(owner, 0, static_cast<size_t>(nb) * W * sizeof(int32_t),
                  s);
  if (m > 0) {
    owner_pass<<<repro_cdiv(static_cast<long long>(m) * W, threads),
                 threads, 0, s>>>(
        static_cast<const int32_t*>(dirty), static_cast<const int32_t*>(idx),
        static_cast<int32_t*>(owner), m, nb, W, L);
  }
  merge_pass<<<repro_cdiv(static_cast<long long>(nb) * W, threads), threads,
               0, s>>>(
      static_cast<const int32_t*>(l2), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(owner), static_cast<int32_t*>(out), nb, W);
  return static_cast<int>(cudaGetLastError());
}
