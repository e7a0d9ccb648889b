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
// (n <= 1024; the wrapper raises above).  The bound is nanoseconds, so
// what sets the time is the chain of dependent steps inside one launch;
// the design keeps that chain short.
//   * Three reductions, independent of each other, run together: the
//     remote first-min (ms, js) over can_r, the local first-min (ml, jl)
//     over can_l and the fence's min over can_l.  wg is the lexicographic
//     min of the two first-mins, so it needs no pass of its own.
//   * Each first-min is two `redux.sync` (__reduce_min_sync): the min of
//     an order-preserving uint32 key of the clock, then the min index
//     among the lanes whose key equals it.  A masked-off lane offers
//     key(BIG) and index n, so an empty mask yields (BIG, n) and the plan
//     takes index 0, as `_first_min` does.  The key maps -0.0 to +0.0
//     first: the reference compares floats, -0.0 == +0.0, and a raw bit
//     key would order -0.0 first and break the first-index tie.
//   * Across warps: lane 0 of each warp stores its five results in
//     shared memory, one __syncthreads, and every warp reduces the
//     warps' results with the same redux pairs.  With n <= 32 the CTA is
//     one warp and there is no barrier at all.
//   * "Is the batch empty" needs no block-wide OR: if any lane is in the
//     batch, so is the local first-min lane jl (every condition is
//     monotone in the clock-lex order), so every thread evaluates the
//     batch rule at (ml, jl).
//   * remote_cap's n x n address test reads the clocks, addresses and
//     candidate flags from shared memory, one row per thread.  raddr is
//     read only when remote_cap: the wrapper passes a null pointer
//     otherwise.
//
// The replica instance (the Pallas kernel's batch grid axis under
// `jax.vmap`, the harness's `run_fused_many`): R plans in one launch, one
// CTA a replica (gridDim R), each reading row r of [R, n] inputs and
// writing row r of the [R, n] masks and wg[r].  The fence is a horizon
// per replica ([R], or none).  The solo entry launches the same kernel
// with one CTA and its scalar horizon.
//
// Bound on the card: bytes and, with remote_cap, n*n compares; at the
// main path's n=64 both are nanoseconds and one launch of one CTA is the
// real cost; R replicas move R times the bytes.
#include "common.cuh"

namespace {

constexpr float kBig = 3e38f;  // fused_turn/ref.py BIG
constexpr int kMaxN = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving uint32 key of a finite float, -0.0 taken as +0.0.
__device__ __forceinline__ uint32_t key_of(float x) {
  uint32_t u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The warp's (key min, first index holding it) of two first-mins and
// the fence's key min, reduced together so their latencies overlap.
struct Mins {
  uint32_t kr, kl, kf;  // keys: remote first-min, local first-min, fence
  uint32_t ir, il;      // indices (n where the mask is empty)
};

__device__ __forceinline__ Mins warp_mins(uint32_t kr, uint32_t kl,
                                          uint32_t kf, uint32_t ir,
                                          uint32_t il) {
  Mins w;
  w.kr = __reduce_min_sync(kFull, kr);
  w.kl = __reduce_min_sync(kFull, kl);
  w.kf = __reduce_min_sync(kFull, kf);
  w.ir = __reduce_min_sync(kFull, kr == w.kr ? ir : ~0u);
  w.il = __reduce_min_sync(kFull, kl == w.kl ? il : ~0u);
  return w;
}

__device__ __forceinline__ bool lex_before(float c, int i, float v, int j) {
  return c < v || (c == v && i < j);
}

__global__ void trip_plan_kernel(const float* __restrict__ clocks,
                                 const bool* __restrict__ can_l_in,
                                 const bool* __restrict__ can_r_in,
                                 const float* __restrict__ bound,
                                 const int32_t* __restrict__ raddr,
                                 const float* __restrict__ horizons,
                                 float horizon, int remote_cap, int n,
                                 bool* __restrict__ lmask,
                                 bool* __restrict__ rmask,
                                 int32_t* __restrict__ wg_out) {
  __shared__ Mins red[32];
  __shared__ float s_clock[kMaxN];
  __shared__ int32_t s_addr[kMaxN];
  __shared__ bool s_r0[kMaxN];

  // this CTA's replica: row r of every [R, n] operand
  const int r = blockIdx.x;
  const long long row = static_cast<long long>(r) * n;
  clocks += row;
  can_l_in += row;
  can_r_in += row;
  bound += row;
  if (remote_cap) raddr += row;
  lmask += row;
  rmask += row;
  wg_out += r;
  if (horizons != nullptr) horizon = horizons[r];

  const int i = threadIdx.x;
  const bool in = i < n;
  const float c = in ? clocks[i] : kBig;
  const bool cl = in && can_l_in[i];
  const bool cr = in && can_r_in[i];
  const float cb = in ? c + bound[i] : kBig;
  const uint32_t big = key_of(kBig);
  const uint32_t none = static_cast<uint32_t>(n);
  const uint32_t kc = key_of(c);

  Mins m = warp_mins(cr ? kc : big, cl ? kc : big, cl ? key_of(cb) : big,
                     cr ? i : none, cl ? i : none);
  const bool multi = blockDim.x > 32;  // uniform over the CTA
  if (multi) {
    const int lane = i & 31;
    if (lane == 0) red[i >> 5] = m;
    __syncthreads();
    const Mins x = lane < static_cast<int>(blockDim.x >> 5)
        ? red[lane] : Mins{big, big, big, none, none};
    m = warp_mins(x.kr, x.kl, x.kf, x.ir, x.il);
  }
  const float ms = float_of(m.kr);
  const float ml = float_of(m.kl);
  const float fence = float_of(m.kf);
  const int jr = static_cast<int>(m.ir);  // n: no remote-ready agent
  const int jl = static_cast<int>(m.il);  // n: no local-ready agent
  const int js = jr == n ? 0 : jr;
  const int wg_raw = lex_before(ml, jl, ms, jr) ? jl : jr;
  const int wg = wg_raw == n ? 0 : wg_raw;

  const bool batch = cl && lex_before(c, i, ms, js) && c <= fence
      && c < horizon;
  // the batch is nonempty iff it holds the local first-min lane jl
  const bool any_batch = jl < n && lex_before(ml, jl, ms, js)
      && ml <= fence && ml < horizon;
  const bool lm = batch || (!any_batch && i == wg && cl);

  bool rm = false;
  if (remote_cap) {
    const int jl0 = jl == n ? 0 : jl;
    const bool r0 = cr && lex_before(c, i, ml, jl0) && c < horizon;
    s_clock[i] = c;
    s_addr[i] = in ? raddr[i] : 0;
    s_r0[i] = r0;
    if (multi) {
      __syncthreads();
    } else {
      __syncwarp();
    }
    bool dropped = false;
    if (r0) {
      const int32_t a = s_addr[i];
      for (int j = 0; j < n && !dropped; ++j) {
        dropped = s_r0[j] && s_addr[j] == a
            && lex_before(s_clock[j], j, c, i);
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
// when remote_cap, else may be null) -> lmask, rmask [n] bool, wg [1]
// int32.  n <= 1024.
REPRO_EXPORT int trip_plan_launch(const void* clocks, const void* can_l,
                                  const void* can_r, const void* bound,
                                  const void* raddr, float horizon,
                                  int remote_cap, int n, void* lmask,
                                  void* rmask, void* wg, void* stream) {
  if (n < 1 || n > kMaxN || (remote_cap && raddr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = ((n + 31) / 32) * 32;
  trip_plan_kernel<<<1, threads, 0, s>>>(
      static_cast<const float*>(clocks), static_cast<const bool*>(can_l),
      static_cast<const bool*>(can_r), static_cast<const float*>(bound),
      static_cast<const int32_t*>(raddr), nullptr, horizon, remote_cap, n,
      static_cast<bool*>(lmask), static_cast<bool*>(rmask),
      static_cast<int32_t*>(wg));
  return static_cast<int>(cudaGetLastError());
}

// The replica instance: every operand with a leading [R] axis (clocks,
// bound [R, n] f32; can_l, can_r [R, n] bool; raddr [R, n] int32 or null
// without remote_cap; horizon [R] f32 or null: no fence) -> lmask, rmask
// [R, n] bool, wg [R] int32.  n <= 1024, 1 <= R <= 2^31 - 1.
REPRO_EXPORT int trip_plan_many_launch(const void* clocks, const void* can_l,
                                       const void* can_r, const void* bound,
                                       const void* raddr, const void* horizon,
                                       int remote_cap, int R, int n,
                                       void* lmask, void* rmask, void* wg,
                                       void* stream) {
  if (n < 1 || n > kMaxN || R < 1 || (remote_cap && raddr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = ((n + 31) / 32) * 32;
  trip_plan_kernel<<<R, threads, 0, s>>>(
      static_cast<const float*>(clocks), static_cast<const bool*>(can_l),
      static_cast<const bool*>(can_r), static_cast<const float*>(bound),
      static_cast<const int32_t*>(raddr),
      static_cast<const float*>(horizon), kBig, remote_cap, n,
      static_cast<bool*>(lmask), static_cast<bool*>(rmask),
      static_cast<int32_t*>(wg));
  return static_cast<int>(cudaGetLastError());
}
