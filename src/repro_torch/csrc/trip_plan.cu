// trip_plan: one batched-trip scheduling decision of the fused engine.
//
// Replaces the Pallas TPU kernel `trip_plan_pallas`
// (src/repro/kernels/fused_turn/kernel.py:94, bodies `_plan_kernel` :55
// and `_first_min` :45).  Over n agent rows it computes:
//   * wg, the first argmin of the clocks of agents with any turn ready
//     (0 when none);
//   * the clock-lex local batch: can_l, clock-lex before the first
//     remote-ready agent, clock <= the fence min(clock + remote_bound)
//     over local-ready agents, and clock < horizon;
//   * lmask = batch, or the one-hot of wg when the batch is empty and wg
//     has a local turn;
//   * when remote_cap, rmask: remote-ready agents clock-lex before every
//     local-ready agent and under the horizon, minus any lane whose
//     address an earlier (clock, index) lane of that set also targets.
//
// Design: one CTA of round_up(n, 32) threads, one thread per agent
// (n <= 1024; the wrapper raises above).  Each first-argmin is a
// warp-shuffle reduction of (value, index) pairs under the lexicographic
// order, then one more across the warps' results in shared memory; a
// masked lane contributes (BIG, n), so an empty mask yields index n and
// the plan takes 0, as `_first_min` does.  The n x n address test for
// remote_cap reads the clocks, addresses and candidate flags from shared
// memory, one row per thread.
//
// Bound on the card: bytes and, with remote_cap, n*n compares; at the
// main path's n=64 both are nanoseconds and one launch of one CTA is the
// real cost.
#include "common.cuh"

namespace {

constexpr float kBig = 3e38f;  // fused_turn/ref.py BIG
constexpr int kMaxN = 1024;

struct MinIdx {
  float v;
  int i;
};

__device__ __forceinline__ MinIdx lexmin(MinIdx a, MinIdx b) {
  return (b.v < a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ MinIdx warp_min(MinIdx x) {
  for (int off = 16; off > 0; off >>= 1) {
    MinIdx y;
    y.v = __shfl_down_sync(0xffffffffu, x.v, off);
    y.i = __shfl_down_sync(0xffffffffu, x.i, off);
    x = lexmin(x, y);
  }
  return x;
}

// Lexicographic (value, index) min over the block; every thread gets it.
__device__ MinIdx block_min(MinIdx x, MinIdx* red, int n) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  x = warp_min(x);
  __syncthreads();  // the previous reduction's readers are done with red
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    MinIdx y = lane < n_warps ? red[lane] : MinIdx{kBig, n};
    y = warp_min(y);
    if (lane == 0) red[32] = y;
  }
  __syncthreads();
  return red[32];
}

__global__ void trip_plan_kernel(const float* __restrict__ clocks,
                                 const bool* __restrict__ can_l_in,
                                 const bool* __restrict__ can_r_in,
                                 const float* __restrict__ bound,
                                 const int32_t* __restrict__ raddr,
                                 float horizon, int remote_cap, int n,
                                 bool* __restrict__ lmask,
                                 bool* __restrict__ rmask,
                                 int32_t* __restrict__ wg_out) {
  __shared__ MinIdx red[33];
  __shared__ float s_clock[kMaxN];
  __shared__ int32_t s_addr[kMaxN];
  __shared__ bool s_r0[kMaxN];

  const int i = threadIdx.x;
  const bool in = i < n;
  const float c = in ? clocks[i] : kBig;
  const bool cl = in && can_l_in[i];
  const bool cr = in && can_r_in[i];
  const MinIdx none{kBig, n};
  const MinIdx mine{c, i};

  const MinIdx w = block_min(cl || cr ? mine : none, red, n);
  const int wg = w.i == n ? 0 : w.i;
  const MinIdx r = block_min(cr ? mine : none, red, n);
  const int js = r.i == n ? 0 : r.i;
  const float fence =
      block_min(cl ? MinIdx{c + bound[i], 0} : MinIdx{kBig, 0}, red, n).v;
  const bool lex = c < r.v || (c == r.v && i < js);
  const bool batch = cl && lex && c <= fence && c < horizon;
  const bool any_batch = __syncthreads_or(batch);
  const bool lm = batch || (!any_batch && i == wg && cl);

  bool rm = false;
  if (remote_cap) {
    const MinIdx l = block_min(cl ? mine : none, red, n);
    const int jl = l.i == n ? 0 : l.i;
    const bool lexr = c < l.v || (c == l.v && i < jl);
    const bool r0 = cr && lexr && c < horizon;
    s_clock[i] = c;
    s_addr[i] = in ? raddr[i] : 0;
    s_r0[i] = r0;
    __syncthreads();
    bool dropped = false;
    if (r0) {
      const int32_t a = s_addr[i];
      for (int j = 0; j < n && !dropped; ++j) {
        dropped = s_r0[j] && s_addr[j] == a
            && (s_clock[j] < c || (s_clock[j] == c && j < i));
      }
    }
    rm = r0 && !dropped;
  }
  if (in) {
    lmask[i] = lm;
    rmask[i] = rm;
  }
  if (i == 0) *wg_out = wg;
}

}  // namespace

// clocks, bound [n] f32; can_l, can_r [n] bool; raddr [n] int32 (read only
// when remote_cap) -> lmask, rmask [n] bool, wg [1] int32.  n <= 1024.
REPRO_EXPORT int trip_plan_launch(const void* clocks, const void* can_l,
                                  const void* can_r, const void* bound,
                                  const void* raddr, float horizon,
                                  int remote_cap, int n, void* lmask,
                                  void* rmask, void* wg, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = ((n + 31) / 32) * 32;
  trip_plan_kernel<<<1, threads, 0, s>>>(
      static_cast<const float*>(clocks), static_cast<const bool*>(can_l),
      static_cast<const bool*>(can_r), static_cast<const float*>(bound),
      static_cast<const int32_t*>(raddr), horizon, remote_cap, n,
      static_cast<bool*>(lmask), static_cast<bool*>(rmask),
      static_cast<int32_t*>(wg));
  return static_cast<int>(cudaGetLastError());
}
