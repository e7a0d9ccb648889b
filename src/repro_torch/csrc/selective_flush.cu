// selective_flush: gather-compact of the dirty blocks a list names,
// out[i] = bank[idx[i]], with a zero row for a pad (idx[i] < 0).  This is
// the flush of the cross-pod delta sync (distributed/hier_sync.py): the
// compacted rows feed one small collective instead of a full-bank one.
//
// Replaces the Pallas TPU kernel `selective_flush_pallas`
// (src/repro/kernels/selective_flush/kernel.py:38, body `_flush_kernel`
// :24).  There the index list is scalar-prefetched and a BlockSpec
// index_map points one grid step's DMA at bank row max(idx[i], 0); the
// grid runs one row at a time.  Here a block loads its own index:
//
//   * grid (k, chunks): blockIdx.x is the output row, blockIdx.y a chunk
//     of it, so a list of 61-256 rows still spreads over the 132 SMs;
//     each thread strides over the row's units;
//   * the copy is typeless: the row is moved in units of U bytes, U the
//     widest of 16, 8, 4, 2 that divides the row's byte length and both
//     base pointers (the wrapper's bank and out come from PyTorch's
//     allocator, so float32 rows of a multiple of 4 elements move as
//     16-byte vector loads and stores; a ragged row falls back to
//     narrower units, down to one bf16 element).  Bits are copied, so
//     the result is bitwise the plain version's for every dtype;
//   * pads write a zero row and read nothing.  An index at or above nb
//     reads row nb-1, as the reference's clip does; the Pallas index_map
//     clamps only from below, so such an index is undefined on the TPU.
//
// Bound on the card: bytes.  It does no arithmetic.  Each valid row is
// read once and every row written once, with the list read once:
// (k + k_valid) * row_bytes + 4 * k bytes, which is 2*k*bs*esize + 4*k
// for a list without pads, over 3.35 TB/s.  At the granite-moe-1b-a400m
// embedding bank (4 pods x 49155 x 1024 float32, 4 x 983 dirty rows
// flushed into 4 x 7864-row lists) that is 64.4 MB per pod, ~19 us at
// most; the delta-sync bench's banks (61-1024-row lists of 4-8 KB rows)
// are 0.3-1.3 us, below a launch.
#include "common.cuh"

namespace {

template <typename U>
__device__ __forceinline__ U zero_unit();
template <>
__device__ __forceinline__ uint4 zero_unit<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <>
__device__ __forceinline__ uint2 zero_unit<uint2>() {
  return make_uint2(0u, 0u);
}
template <>
__device__ __forceinline__ uint32_t zero_unit<uint32_t>() { return 0u; }
template <>
__device__ __forceinline__ uint16_t zero_unit<uint16_t>() { return 0; }

template <typename U>
__global__ void flush_rows(const U* __restrict__ bank,
                           const int32_t* __restrict__ idx,
                           U* __restrict__ out, int nb, long long units) {
  const long long i = blockIdx.x;
  const int b = idx[i];
  U* dst = out + i * units;
  const long long stride = static_cast<long long>(gridDim.y) * blockDim.x;
  long long u = static_cast<long long>(blockIdx.y) * blockDim.x
      + threadIdx.x;
  if (b < 0) {
    const U z = zero_unit<U>();
    for (; u < units; u += stride) dst[u] = z;
    return;
  }
  const U* src = bank + static_cast<long long>(min(b, nb - 1)) * units;
  for (; u < units; u += stride) dst[u] = src[u];
}

template <typename U>
int launch_rows(const void* bank, const void* idx, void* out, int nb, int k,
                long long row_bytes, cudaStream_t s) {
  const int threads = 128;
  const long long units = row_bytes / static_cast<long long>(sizeof(U));
  const long long chunks = (units + threads - 1) / threads;
  dim3 grid(k, static_cast<unsigned>(chunks < 65535 ? chunks : 65535));
  flush_rows<U><<<grid, threads, 0, s>>>(
      static_cast<const U*>(bank), static_cast<const int32_t*>(idx),
      static_cast<U*>(out), nb, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bank [nb, row_bytes] of any element type, idx [k] int32, out
// [k, row_bytes]; k >= 1, nb >= 1, row_bytes a multiple of 2.
REPRO_EXPORT int selective_flush_launch(const void* bank, const void* idx,
                                        void* out, int nb, int k,
                                        long long row_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long align =
      static_cast<unsigned long long>(row_bytes)
      | reinterpret_cast<uintptr_t>(bank) | reinterpret_cast<uintptr_t>(out);
  if (align % 16 == 0)
    return launch_rows<uint4>(bank, idx, out, nb, k, row_bytes, s);
  if (align % 8 == 0)
    return launch_rows<uint2>(bank, idx, out, nb, k, row_bytes, s);
  if (align % 4 == 0)
    return launch_rows<uint32_t>(bank, idx, out, nb, k, row_bytes, s);
  if (align % 2 == 0)
    return launch_rows<uint16_t>(bank, idx, out, nb, k, row_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
