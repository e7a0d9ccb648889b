// flash_decode: one-token attention over a KV cache with a per-row valid
// prefix kv_len[b], GQA (q-head h reads kv-head h / (Hq/Hkv)).
//
// Replaces the Pallas TPU kernel `flash_decode_pallas`
// (src/repro/kernels/flash_decode/kernel.py:62, body `_decode_kernel` :26),
// whose grid walks cache chunks per (batch, q-head) and skips chunks past
// kv_len.  The function on the serving path is the model's
// `layers.decode_attention` (src/repro/models/layers.py:139), and this
// kernel follows its rounding points, not `flash_decode_ref`'s:
//   q * scale is rounded to the cache's type; scores are float32 sums of
//   products of cache-typed values; the softmax is float32 and is
//   normalised before P.V; p is rounded to the cache's type; P.V sums in
//   float32; the output is cast to q's type.
// In float32 every rounding is the identity, so there it is also exactly
// the function of `flash_decode_ref` and the Pallas kernel.
//
// Bound on the card: bytes.  It reads the valid prefix of K and V once:
// 2 * sizeof(T) * D * Hkv * sum_b(kv_len[b]) bytes, plus q and the output
// (at qwen2.5-32b's serving shape, bf16 B=8 40/8 S=512 D=128: 16.8 MB,
// 5.06 us at 3.35 TB/s).  Its flops, 4 * Hq * D a position, are 2 * group
// a byte read: far below the card's 295 a byte.
//
// Two instances share the cluster split and the combine.  The wrapper
// (kernels/flash_decode/ops.py `_launch`) picks one by type and D:
//   * `mma_decode_kernel<D>`: bfloat16 at D 64 and 128, any GQA group, the
//     dot products on tensor cores (`mma.sync` m16n8k16, bf16 in, float32
//     sums; float32 has no such form and TF32 would change the function);
//   * `decode_kernel<T, G>`: every other call (float32, other D), on CUDA
//     cores, a GQA group above DEC_MAX_GROUP = 4 heads in sub-groups.
//
// The split (both): a cluster of 8 CTAs takes one batch row's cache of one
// kv-head; cluster rank r takes the fixed contiguous share [r*c, min(n,
// (r+1)*c)) of the valid prefix n = clamp(kv_len, 0, S), c = ceil(n / 8),
// so the split depends on kv_len alone.  Because p is normalised before
// it is rounded, every share needs the row's global max and sum before
// P.V; the cluster's distributed shared memory gives both in the one
// launch: each share's max m_r and l_r = sum exp(s - m_r) per head go into
// slot r of every rank's shared memory (remote stores), and one cluster
// barrier later every rank holds all 8 pairs: the row's max m = max m_r
// and sum = sum_r l_r * exp(m_r - m), added in rank order, so every rank
// holds the same bits; p = round(exp(s - m) / sum).  The shares' partial
// P.V, in float32, are added in rank order after a second barrier.  The
// first barrier phase is arrived on at the start and waited on only before
// the first remote store (it ensures every CTA of the cluster runs).
//
// mma_decode_kernel<D>: one cluster a (row, kv-head), whatever the group,
// so each K and V row is read from device memory once (at the serving
// shape 64 clusters at groups 5 and 12, 320 at group 1), 128 threads (4
// warps) a CTA, 96 registers, 38-46 KB of shared memory: 5 CTAs an SM,
// 77 clusters resident at groups 1, 5 and 12 (62 at 16), so that the 64
// clusters of groups 5 and 12 run in one wave.
//   1. At the start every thread copies its 16-byte pieces of the share's
//      first chunk of 64 rows, K then V, into shared memory (`cp.async`,
//      one commit group each; rows past the prefix in the last k-step read
//      as zeros); a share of up to 64 rows (kv_len 512) pays one memory
//      latency, and V lands while the scores are computed.  Then q * scale
//      of the M-tile's 16 heads, rounded to bf16 (rows past the group
//      zero), goes to a q tile in shared memory, 16-byte loads.  Rows of
//      K, V, q and p are unpadded, their 16-byte pieces XOR-swizzled by
//      the row's low 3 bits, so no ldmatrix phase reads a bank twice.
//   2. Scores (`mma.sync` m16n8k16, bf16 in, float32 sums): the M-tile's
//      heads against the warp's strip of 16 rows, A = q and B = K rows,
//      both through ldmatrix k-step by k-step; 2 n-tiles x D/16 k-steps.
//      The group sizes no per-thread array, so a group of 12 or 16 costs
//      the registers of 1; a group above 16 takes more M-tiles, one after
//      another.  Each thread keeps a running (max, sum) per head over its
//      scores, merged over the quad's 4 lanes, then the 4 warps in warp
//      order.
//   3. After the exchange, p = round(exp(s - m) * (1 / sum)) goes to the q
//      tile's place [16 heads, 64 rows] bf16, and warp w computes P.V of
//      columns [w*D/4, (w+1)*D/4) over the chunk: A = p through ldmatrix,
//      B = V through ldmatrix.trans.  No warp partials to add.  exp is
//      `__expf` (ex2.approx of x * log2 e), and 1 / sum one rounding: both
//      a few float32 ulps from expf and the division, far below p's bf16
//      rounding, and the same bits from run to run.
//   4. Warp w's columns go to the ranks that own them: rank j adds the 8
//      shares of columns [j*D/8, (j+1)*D/8) in rank order and stores them.
//   A share longer than a chunk (kv_len > 512) walks its chunks twice:
//   the statistics pass loads K alone chunk by chunk (V of the last one
//   too), and P.V walks them back from the last, which is still in shared
//   memory with its scores in registers; every earlier chunk's K and V,
//   and the q tile, are loaded again and its scores recomputed by the same
//   instructions, so they are the same bits.  No score row lives in shared
//   memory, so S has no shared-memory limit.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6; the A/B of
// `kernels/timing.py --trees`, medians of 20, bf16, B=8, S=512, every
// kv_len 512, D=128; device time a call, this instance against the
// CUDA-core one): group 5 (qwen2.5-32b) 8.95 us against 29.89, group 12
// (mistral-large-123b) 9.67 against 53.35, group 1 (qwen1.5-32b) 38.63
// against 48.39, SDPA ~13.7, ~13.7 and ~41 in the same runs; granite's
// decode at D=64 (4 slots, kv_len 272, 32, 54, 83) 5.76 against 6.55.
// Byte bounds 5.06, 5.13 and 25.09 us: what holds it back is latency
// (one wave, two cluster barriers), not bytes.  A share past a chunk
// pays a second pass: 32,768 positions at group 12, B=1, ~0.17 ms
// against SDPA's ~0.06.
//
// decode_kernel<T, G>: 256 threads, each cache row read as 16-byte loads,
// D*sizeof(T)/16 lanes per row, 256/lanes rows per pass; the first two
// passes' K and V slices are loaded together with q; later passes load K
// and prefetch V into L2; the group's dot products share each load and
// reduce over the row's lanes; the share's scores stay in shared memory
// ([group, ceil(S/8)] float32); each thread takes one 16-byte slice of V
// rows for P.V; the lanes of a warp that share a slice, then the 8 warps,
// are summed in a fixed order, and rank 0 adds the 8 ranks' partials.
// Register arrays are sized by the next power of two >= the heads a
// cluster computes (1, 2 or 4); a larger group splits into the fewest
// sub-groups of at most 4, as equal as they come, each a cluster of its
// own (4 was timed fastest of 2, 4, 8 and 16 on the card: PERF.md §6).
//
// Invariants (both): a row's output depends only on that row's (q, k, v,
// kv_len) (not on B, the other rows or the row's slot), and it is bitwise
// the same from run to run: every sum has a fixed order and no float
// atomics are used.  A share that is empty (n < 8) still arrives on every
// barrier phase; a row with kv_len 0 gets zeros (the serving path always
// has kv_len >= 1).  The sum over shares equals the one-pass sum of
// exp(s - m) up to float32 rounding (a few ulps), far inside the
// tolerances of kernels/cases.py.
#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

#define DEC_THREADS 256
#define DEC_WARPS (DEC_THREADS / 32)
#define DEC_MAX_GROUP 4      // heads a cluster computes; more split
#define DEC_CLUSTER 8
#define DEC_PRE 2            // passes whose K and V rows load up front

namespace cg = cooperative_groups;

namespace {

// the 16-byte slice `x` of a cache row as float32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& x, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& x, float* f) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& x,
                                                        float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// one pass of scores: the 16-byte slice `raw` of the K row at share
// position `pos` (zeros past the share) against the group's q slices,
// summed over the row's `lanes` lanes; the row's first lane stores them
template <typename T, int G>
__device__ __forceinline__ void score_pass(
    const uint4& raw, int pos, bool valid, int seg, int lanes, int group,
    int cap, const float (&qv)[G][16 / sizeof(T)], float* sc) {
  constexpr int VEC = 16 / sizeof(T);
  float kf[VEC];
  unpack16<T>(raw, kf);
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    acc[g] = 0.f;
    if (g < group) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g] += qv[g][j] * kf[j];
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
    }
  }
  if (valid && seg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) sc[g * cap + pos] = acc[g];
    }
  }
}

// acc[g][:] += p[g, pos] * (the 16-byte slice `raw` of V row pos)
template <typename T, int G>
__device__ __forceinline__ void pv_pass(
    const uint4& raw, int pos, int group, int cap, const float* sc,
    float (&acc)[G][16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  float vf[VEC];
  unpack16<T>(raw, vf);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < group) {
      const float p = sc[g * cap + pos];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] += p * vf[j];
    }
  }
}

template <typename T, int G>
__global__ void __cluster_dims__(DEC_CLUSTER, 1, 1)
__launch_bounds__(DEC_THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ kv_len,
              T* __restrict__ out, int Hq, int Hkv, int S, int D,
              int nsub, float scale) {
  constexpr int VEC = 16 / sizeof(T);     // elements in one 16-byte load
  extern __shared__ float smem[];
  static_assert(G <= DEC_WARPS, "one warp per head of the sub-group");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // cluster (row b, kv-head kvh, sub-group sub): the sub-group's heads
  // are the q-heads sub*gs .. of the kv-head's group, at most G of them
  const int cl = blockIdx.x / DEC_CLUSTER;
  const int pair = cl / nsub, sub = cl - (cl / nsub) * nsub;
  const int b = pair / Hkv, kvh = pair - (pair / Hkv) * Hkv;
  const int group_all = Hq / Hkv;
  const int gs = (group_all + nsub - 1) / nsub;
  const int group = min(gs, group_all - sub * gs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(max(kv_len[b], 0), S);
  const int chunk = (n + DEC_CLUSTER - 1) / DEC_CLUSTER;
  const int s0 = min(n, rank * chunk);
  const int cnt = min(n, s0 + chunk) - s0;
  const int cap = (S + DEC_CLUSTER - 1) / DEC_CLUSTER;
  float* part = smem;                      // [warps, group, D]
  float* recv = part + DEC_WARPS * group * D;  // [ranks, group, D] rank 0's
  float* sc = recv + DEC_CLUSTER * group * D;  // [group, cap] scores, p
  float* stat = sc + group * cap;          // [ranks, group, 2] (max, sum)
  // phase 1 of the cluster barrier: this CTA runs (its shared memory may
  // be written); waited on just before the first remote write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int lanes = D / VEC;               // lanes per cache row, 2^j <= 32
  const int per = DEC_THREADS / lanes;     // rows per pass of the CTA
  const int seg = threadIdx.x % lanes, slot = threadIdx.x / lanes;
  const long long base = (static_cast<long long>(b) * Hkv + kvh) * S * D
      + static_cast<long long>(s0) * D + seg * VEC;
  const uint4* kb = reinterpret_cast<const uint4*>(k + base);
  const uint4* vb = reinterpret_cast<const uint4*>(v + base);
  const int row_vecs = D / VEC;

  // the first DEC_PRE passes' K and V slices and q, loaded together: V
  // stays in registers until P.V
  uint4 kr[DEC_PRE], vr[DEC_PRE];
#pragma unroll
  for (int u = 0; u < DEC_PRE; ++u) {
    const int pos = u * per + slot;
    kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
    if (pos < cnt) {
      kr[u] = __ldg(kb + static_cast<long long>(pos) * row_vecs);
      vr[u] = __ldg(vb + static_cast<long long>(pos) * row_vecs);
    }
  }
  const long long head0 = static_cast<long long>(b) * Hq + kvh * group_all
      + sub * gs;
  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      qv[g][j] = g < group
          ? round_to<T>(to_f32(q[(head0 + g) * D + seg * VEC + j]) * scale)
          : 0.f;
    }
  }

  // 1. scores of the share
#pragma unroll
  for (int u = 0; u < DEC_PRE; ++u) {
    const int pos = u * per + slot;
    if (u * per < cnt) {
      score_pass<T, G>(kr[u], pos, pos < cnt, seg, lanes, group, cap, qv, sc);
    }
  }
  for (int p0 = DEC_PRE * per; p0 < cnt; p0 += per) {
    const int pos = p0 + slot;
    const bool valid = pos < cnt;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (valid) {
      raw = __ldg(kb + static_cast<long long>(pos) * row_vecs);
      asm volatile("prefetch.global.L2 [%0];"
                   :: "l"(vb + static_cast<long long>(pos) * row_vecs));
    }
    score_pass<T, G>(raw, pos, valid, seg, lanes, group, cap, qv, sc);
  }
  __syncthreads();
  // the share's max m_r and sum of exp(s - m_r), warp g for head g,
  // stored into slot `rank` of every rank's `stat`
  float m_r = -INFINITY, l_r = 0.f;
  if (warp < group) {
    const float* row = sc + warp * cap;
    for (int j = lane; j < cnt; j += 32) m_r = fmaxf(m_r, row[j]);
    m_r = warp_max(m_r);
    for (int j = lane; j < cnt; j += 32) l_r += expf(row[j] - m_r);
    l_r = warp_sum(l_r);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp < group && lane < DEC_CLUSTER) {
    float* dst = cluster.map_shared_rank(stat, lane)
        + (rank * group + warp) * 2;
    dst[0] = m_r;
    dst[1] = l_r;
  }
  // 2. every rank holds the 8 (max, sum) pairs: the row's max m and sum
  // sum_r l_r * exp(m_r - m), added in rank order (the same bits on every
  // rank); p = round(exp(s - m) / sum) in place
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (warp < group) {
    const float* st = stat + warp * 2;     // rank r's pair at r * group * 2
    float m = -INFINITY, sum = 0.f;
#pragma unroll
    for (int r = 0; r < DEC_CLUSTER; ++r) m = fmaxf(m, st[r * group * 2]);
#pragma unroll
    for (int r = 0; r < DEC_CLUSTER; ++r) {
      sum += st[r * group * 2 + 1] * expf(st[r * group * 2] - m);
    }
    float* row = sc + warp * cap;
    for (int i = lane; i < cnt; i += 32) {
      row[i] = round_to<T>(expf(row[i] - m) / sum);
    }
  }
  __syncthreads();

  // 3. the share's P.V, float32
  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < DEC_PRE; ++u) {
    const int pos = u * per + slot;
    if (pos < cnt) pv_pass<T, G>(vr[u], pos, group, cap, sc, acc);
  }
  for (int pos = DEC_PRE * per + slot; pos < cnt; pos += per) {
    pv_pass<T, G>(__ldg(vb + static_cast<long long>(pos) * row_vecs), pos,
                  group, cap, sc, acc);
  }
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], off);
        }
      }
    }
  }
  if (lane < lanes) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          part[(warp * group + g) * D + seg * VEC + j] = acc[g][j];
        }
      }
    }
  }
  __syncthreads();
  // 4. the share's P.V into slot `rank` of rank 0's `recv`; rank 0 adds
  // the 8 slots in rank order once every rank has arrived
  float* dst = cluster.map_shared_rank(recv, 0) + rank * group * D;
  for (int i = threadIdx.x; i < group * D; i += DEC_THREADS) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) x += part[w * group * D + i];
    dst[i] = x;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  for (int i = threadIdx.x; i < group * D; i += DEC_THREADS) {
    float x = 0.f;
#pragma unroll
    for (int r = 0; r < DEC_CLUSTER; ++r) x += recv[r * group * D + i];
    out[head0 * D + i] = to_store<T>(x);
  }
}

size_t smem_bytes(int group, int D, int S) {
  return sizeof(float) * group
      * (static_cast<size_t>(D) * (DEC_WARPS + DEC_CLUSTER)
         + static_cast<size_t>(repro_cdiv(S, DEC_CLUSTER)) + 2 * DEC_CLUSTER);
}

// clusters a (row, kv-head) pair: a group of more than DEC_MAX_GROUP heads
// splits into the fewest sub-groups of at most DEC_MAX_GROUP, as equal as
// they come (12 -> 4 + 4 + 4), each a cluster that reads the pair's cache
int n_sub(int group) { return (group + DEC_MAX_GROUP - 1) / DEC_MAX_GROUP; }
// heads of the largest sub-group: what the kernel instance and the
// shared memory are sized by
int sub_group(int group) {
  return (group + n_sub(group) - 1) / n_sub(group);
}

// f(std::integral_constant<int, G>) for the kernel instance of a
// (sub-)group: register arrays sized by the next power of two >= it
template <typename F>
int by_group(int group, F f) {
  if (group <= 1) return f(std::integral_constant<int, 1>());
  if (group <= 2) return f(std::integral_constant<int, 2>());
  return f(std::integral_constant<int, 4>());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* kv_len, void* out, int B, int Hq, int Hkv, int S,
                 int D, float scale, cudaStream_t s) {
  const int nsub = n_sub(Hq / Hkv), gs = sub_group(Hq / Hkv);
  return by_group(gs, [&](auto g) {
    constexpr int G = decltype(g)::value;
    const size_t smem = smem_bytes(gs, D, S);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          decode_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    decode_kernel<T, G>
        <<<B * Hkv * nsub * DEC_CLUSTER, DEC_THREADS, smem, s>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const int32_t*>(kv_len),
            static_cast<T*>(out), Hq, Hkv, S, D, nsub, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int resident_typed(int group, int D, int S) {
  group = sub_group(group);
  return by_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(DEC_CLUSTER);
    cfg.blockDim = dim3(DEC_THREADS);
    cfg.dynamicSmemBytes = smem_bytes(group, D, S);
    if (cfg.dynamicSmemBytes > 48 * 1024) {
      cudaFuncSetAttribute(decode_kernel<T, G>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(cfg.dynamicSmemBytes));
    }
    int n = 0;
    return cudaOccupancyMaxActiveClusters(&n, decode_kernel<T, G>, &cfg)
        == cudaSuccess ? n : -1;
  });
}

// ---------------------------------------------------------------------------
// the bfloat16 tensor-core instance (D 64 or 128, any group)
// ---------------------------------------------------------------------------

#define DMMA_THREADS 128
#define DMMA_WARPS (DMMA_THREADS / 32)
#define DMMA_ROWS 64        // cache rows of a chunk in shared memory, 16 a warp
#define DMMA_HEADS 16       // heads of an M-tile (the mma's 16 rows)

// one CTA's shared memory, in bytes: K and V rows of a chunk, the M-tile's
// q * scale [16 heads, D] bf16 (whose place p of the chunk [16 heads, 64
// rows] bf16 takes once the scores are computed), the warps' and the
// ranks' (max, sum) pairs, and the ranks' partial P.V of this rank's D/8
// columns for the M-tile's first hm heads.  K, V, q and p rows are
// unpadded, their 16-byte pieces swizzled (`swz`), so that the 8 rows an
// ldmatrix phase reads fall in 8 distinct bank groups.
template <int D>
struct MmaLayout {
  static constexpr int ROW = 2 * D;
  static constexpr int PROW = 2 * DMMA_ROWS;
  static constexpr int K = 0;
  static constexpr int V = K + DMMA_ROWS * ROW;
  static constexpr int Q = V + DMMA_ROWS * ROW;
  static constexpr int STW = Q + DMMA_HEADS * (ROW > PROW ? ROW : PROW);
  static constexpr int STAT = STW + DMMA_WARPS * DMMA_HEADS * 8;
  static constexpr int RECV = STAT + DEC_CLUSTER * DMMA_HEADS * 8;
  static size_t bytes(int hm) {
    return RECV + sizeof(float) * DEC_CLUSTER * hm * (D / 8);
  }
};

// byte offset of 16-byte piece c of row r in a tile of `row` bytes a row
__device__ __forceinline__ uint32_t swz(int r, int c, int row) {
  return r * row + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// d += A . B, m16n8k16, bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of global memory into shared memory (cp.async, through L2
// only); src_bytes 0 writes zeros
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// the A operand of a [16, 16 k] tile at k-step ks of a swizzled [16, .]
// bf16 tile of `row` bytes a row at `tile`: matrix mi = rows (mi % 2) * 8
// + lane % 8, piece 2 ks + mi / 2, giving a0a1, a2a3, a4a5, a6a7
__device__ __forceinline__ void a_frag(uint32_t tile, int row, int ks,
                                       int lane, uint32_t (&a)[4]) {
  const int mi = lane >> 3;
  ldsm4(tile + swz((mi & 1) * 8 + (lane & 7), 2 * ks + (mi >> 1), row), a);
}

// scores of a warp's strip of 16 cache rows (row `r0` of the K tile at
// `kb`) against the M-tile's heads (the q tile at `qb`, A fragments by
// ldmatrix k-step by k-step, so that no per-thread array holds q),
// masked: s[j] is the n-tile of rows
// 8j..8j+7, elements 0 and 1 head g (= lane / 4) at rows 8j + 2t and 8j +
// 2t + 1 (t = lane % 4), elements 2 and 3 head g + 8; `pos` is the share
// position of the strip's row 0, and positions at or past `cnt` score
// -inf
template <int D>
__device__ __forceinline__ void strip_scores(uint32_t qb, uint32_t kb,
                                             int r0, int lane,
                                             int pos, int cnt,
                                             float (&s)[2][4]) {
  const int mi = lane >> 3;
  // ldmatrix lane address: matrix mi = rows (mi / 2) * 8 + lane % 8 of
  // the strip, piece 2 ks + mi % 2: b0b1, b2b3 of n-tile 0, then of
  // n-tile 1
  const int r = r0 + (mi >> 1) * 8 + (lane & 7);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4], b[4];
    a_frag(qb, 2 * D, ks, lane, a);
    ldsm4(kb + swz(r, 2 * ks + (mi & 1), 2 * D), b);
    mma_bf16(s[0], a, b[0], b[1]);
    mma_bf16(s[1], a, b[2], b[3]);
  }
  const int p0 = pos + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (p0 + 8 * j + e >= cnt) s[j][e] = s[j][e + 2] = -INFINITY;
    }
  }
}

// (m, l) of two partial softmax sums merged: the larger max, and each sum
// rescaled to it (0 where both are empty)
__device__ __forceinline__ void merge_stats(float& m, float& l, float mo,
                                            float lo) {
  const float mn = fmaxf(m, mo);
  l = mn == -INFINITY ? 0.f : l * __expf(m - mn) + lo * __expf(mo - mn);
  m = mn;
}

template <int D>
__global__ void __cluster_dims__(DEC_CLUSTER, 1, 1)
__launch_bounds__(DMMA_THREADS, 5)
mma_decode_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int32_t* __restrict__ kv_len,
                  __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int S,
                  float scale) {
  using L = MmaLayout<D>;
  constexpr int NT = D / 32;      // P.V n-tiles of a warp's quarter of D
  constexpr int RT = D / 64;      // n-tiles of the D/8 columns a rank adds
  constexpr int CPR = D / 8;      // 16-byte pieces of a row of D bf16
  extern __shared__ __align__(128) unsigned char dsm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / DEC_CLUSTER;
  const int b = cl / Hkv, kvh = cl - (cl / Hkv) * Hkv;
  const int group = Hq / Hkv, hm = min(group, DMMA_HEADS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = min(max(kv_len[b], 0), S);
  const int chunk = (n + DEC_CLUSTER - 1) / DEC_CLUSTER;
  const int s0 = min(n, rank * chunk);
  const int cnt = min(n, s0 + chunk) - s0;
  const int nch = (cnt + DMMA_ROWS - 1) / DMMA_ROWS;
  const uint32_t sm = smem_u32(dsm);
  const uint32_t kbuf = sm + L::K, vbuf = sm + L::V, qbuf = sm + L::Q;
  float2* stw = reinterpret_cast<float2*>(dsm + L::STW);
  float2* stat = reinterpret_cast<float2*>(dsm + L::STAT);
  float* recv = reinterpret_cast<float*>(dsm + L::RECV);
  // phase 1 of the cluster barrier: this CTA runs (its shared memory may
  // be written); waited on just before the first remote write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const size_t first = ((static_cast<size_t>(b) * Hkv + kvh) * S + s0) * D;
  // the chunk whose K and whose V rows shared memory holds or will hold
  int k_at = -1, v_at = -1;
  // chunk ch's K and/or V rows into shared memory, 16 bytes a piece by
  // every thread, K then V each one cp.async group (empty where not
  // loaded); rows past the prefix in the chunk's last k-step read as
  // zeros (p is 0 there, and 0 * garbage could be NaN).  A reload waits
  // until every warp is done with the buffers.
  auto load = [&](int ch, bool with_k, bool with_v) {
    if (k_at >= 0) __syncthreads();
    const int rows = min(DMMA_ROWS, cnt - ch * DMMA_ROWS);
    const int rows16 = (rows + 15) & ~15;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      if (part == 0 ? with_k : with_v) {
        const uint32_t dst = part == 0 ? kbuf : vbuf;
        const __nv_bfloat16* src = (part == 0 ? k : v) + first
            + static_cast<size_t>(ch) * DMMA_ROWS * D;
        for (int i = threadIdx.x; i < rows16 * CPR; i += DMMA_THREADS) {
          const int r = i / CPR, c = i - (i / CPR) * CPR;
          cp16(dst + swz(r, c, 2 * D), src + (r < rows ? r : 0) * D + c * 8,
               r < rows ? 16 : 0);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (with_k) k_at = ch;
    if (with_v) v_at = ch;
  };
  // the latest load's K, or K and V, are in shared memory for every warp
  auto wait_k = [&]() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
  };
  auto wait_v = [&]() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  };
  // the M-tile's q * scale rounded to bf16 into the q tile, zero rows past
  // the group: 16-byte loads where q starts on 16 bytes
  const bool q_vec = (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  auto stage_q = [&](int mt, int heads) {
    const __nv_bfloat16* q0 = q + (static_cast<size_t>(b) * Hq + kvh * group
                                   + mt * DMMA_HEADS) * D;
    for (int i = threadIdx.x; i < DMMA_HEADS * CPR; i += DMMA_THREADS) {
      const int h = i / CPR, c = i - (i / CPR) * CPR;
      uint4 raw = make_uint4(0, 0, 0, 0), w = make_uint4(0, 0, 0, 0);
      if (h < heads) {
        const __nv_bfloat16* x = q0 + h * D + c * 8;
        uint32_t* rp = reinterpret_cast<uint32_t*>(&raw);
        if (q_vec) {
          raw = *reinterpret_cast<const uint4*>(x);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            rp[j] = __bfloat16_as_ushort(x[2 * j])
                | static_cast<uint32_t>(__bfloat16_as_ushort(x[2 * j + 1]))
                    << 16;
          }
        }
        const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&raw);
        uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(hp[j]);
          wp[j] = pack_bf16(f.x * scale, f.y * scale);
        }
      }
      *reinterpret_cast<uint4*>(dsm + L::Q + swz(h, c, 2 * D)) = w;
    }
  };

  // the first chunk's K (and V, when it is the last) are on their way
  // before q is read
  if (nch > 0) load(0, true, nch == 1);
  for (int mt = 0; mt * DMMA_HEADS < group; ++mt) {
    const int heads = min(DMMA_HEADS, group - mt * DMMA_HEADS);
    stage_q(mt, heads);
    // 1. the share's (max, sum of exp(s - max)) per head: this thread's
    // elements chunk by chunk, then the quad's 4 lanes, then the 4 warps
    float s[2][4];
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    for (int ch = 0; ch < nch; ++ch) {
      const bool last = ch == nch - 1;
      const bool lk = k_at != ch, lv = last && v_at != ch;
      if (lk || lv) load(ch, lk, lv);
      wait_k();
      if (16 * warp < cnt - ch * DMMA_ROWS) {
        strip_scores<D>(qbuf, kbuf, 16 * warp, lane,
                        ch * DMMA_ROWS + 16 * warp, cnt, s);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float mx = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                                 fmaxf(s[1][2 * i], s[1][2 * i + 1]));
          const float mn = fmaxf(m_run[i], mx);
          if (mn != -INFINITY) {
            float l = l_run[i] * __expf(m_run[i] - mn);
            l += __expf(s[0][2 * i] - mn);
            l += __expf(s[0][2 * i + 1] - mn);
            l += __expf(s[1][2 * i] - mn);
            l += __expf(s[1][2 * i + 1] - mn);
            l_run[i] = l;
            m_run[i] = mn;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        merge_stats(m_run[i], l_run[i],
                    __shfl_xor_sync(0xffffffffu, m_run[i], off),
                    __shfl_xor_sync(0xffffffffu, l_run[i], off));
      }
      if (t == 0) {
        stw[warp * DMMA_HEADS + g + 8 * i] = make_float2(m_run[i], l_run[i]);
      }
    }
    __syncthreads();
    // 2. the share's pair of head h (the warps' merged in warp order) into
    // slot `rank` of rank dst's `stat`; one cluster barrier later every
    // rank holds the 8 pairs of every head
    {
      const int h = threadIdx.x & (DMMA_HEADS - 1);
      const int dst = threadIdx.x / DMMA_HEADS;
      float m = -INFINITY, l = 0.f;
#pragma unroll
      for (int w = 0; w < DMMA_WARPS; ++w) {
        const float2 x = stw[w * DMMA_HEADS + h];
        merge_stats(m, l, x.x, x.y);
      }
      if (mt == 0) {
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      }
      cluster.map_shared_rank(stat, dst)[rank * DMMA_HEADS + h] =
          make_float2(m, l);
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    // the row's max and 1 / sum of heads g and g + 8, over the ranks in
    // rank order (the same bits on every rank)
    float mrow[2], rsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2* st = stat + g + 8 * i;
      float m = -INFINITY, sum = 0.f;
#pragma unroll
      for (int r = 0; r < DEC_CLUSTER; ++r) m = fmaxf(m, st[r * DMMA_HEADS].x);
#pragma unroll
      for (int r = 0; r < DEC_CLUSTER; ++r) {
        sum += st[r * DMMA_HEADS].y * __expf(st[r * DMMA_HEADS].x - m);
      }
      mrow[i] = m;
      rsum[i] = 1.f / sum;
    }

    // 3. the share's P.V, chunk by chunk from the last (still in shared
    // memory, its scores still in registers); earlier chunks are loaded
    // again and their scores recomputed by the same instructions
    float o[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
    }
    for (int ch = nch - 1; ch >= 0; --ch) {
      const int rows = min(DMMA_ROWS, cnt - ch * DMMA_ROWS);
      const bool mine = 16 * warp < rows;
      if (k_at != ch) {
        load(ch, true, true);
        stage_q(mt, heads);       // p of the chunk before took its place
        wait_k();
        if (mine) {
          strip_scores<D>(qbuf, kbuf, 16 * warp, lane,
                          ch * DMMA_ROWS + 16 * warp, cnt, s);
        }
      }
      __syncthreads();            // every warp has read the q tile
      // p = round(exp(s - m) / sum), normalised before it is rounded, into
      // the q tile's place; rows past the prefix score -inf, so p is 0
      if (mine) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t x = pack_bf16(
                __expf(s[j][2 * i] - mrow[i]) * rsum[i],
                __expf(s[j][2 * i + 1] - mrow[i]) * rsum[i]);
            asm volatile("st.shared.b32 [%0], %1;\n"
                         :: "r"(qbuf + swz(g + 8 * i, 2 * warp + j, L::PROW)
                                + 4 * t), "r"(x)
                         : "memory");
          }
        }
      }
      wait_v();
      // warp w: columns [w*D/4, (w+1)*D/4) over the chunk's rows; A = p
      // [16 heads, 16 rows] by ldmatrix, B = V [16 rows, 16 columns] by
      // ldmatrix.trans: matrix mi = rows (mi % 2) * 8 + lane % 8, piece
      // of columns (mi / 2) * 8
      const int mi = lane >> 3;
      const int vr = (mi & 1) * 8 + (lane & 7);
      const int vc = warp * (D / 32) + (mi >> 1);
      for (int kk = 0; kk < (rows + 15) / 16; ++kk) {
        uint32_t a[4];
        a_frag(qbuf, L::PROW, kk, lane, a);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bv[4];
          ldsm4_t(vbuf + swz(16 * kk + vr, vc + 2 * np, 2 * D), bv);
          mma_bf16(o[2 * np], a, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], a, bv[2], bv[3]);
        }
      }
    }

    // 4. the share's P.V of columns [j*D/8, (j+1)*D/8) into slot `rank` of
    // rank j's `recv`; one cluster barrier later rank j adds its columns'
    // 8 slots in rank order and stores them
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int gt = warp * NT + j;
      float* to = cluster.map_shared_rank(recv, gt / RT)
          + rank * hm * (D / 8) + (gt % RT) * 8 + 2 * t;
      if (g < heads) {
        *reinterpret_cast<float2*>(to + g * (D / 8)) =
            make_float2(o[j][0], o[j][1]);
      }
      if (g + 8 < heads) {
        *reinterpret_cast<float2*>(to + (g + 8) * (D / 8)) =
            make_float2(o[j][2], o[j][3]);
      }
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    for (int i = threadIdx.x; i < heads * (D / 8); i += DMMA_THREADS) {
      const int h = i / (D / 8), c = i - h * (D / 8);
      float x = 0.f;
#pragma unroll
      for (int r = 0; r < DEC_CLUSTER; ++r) x += recv[(r * hm + h) * (D / 8) + c];
      out[(static_cast<size_t>(b) * Hq + kvh * group + mt * DMMA_HEADS + h) * D
          + rank * (D / 8) + c] = __float2bfloat16(x);
    }
  }
}

template <int D>
size_t mma_smem(int Hq, int Hkv) {
  const int group = Hq / Hkv;
  return MmaLayout<D>::bytes(group < DMMA_HEADS ? group : DMMA_HEADS);
}

// the instance's carveout, set once: all of the SM's 228 KB as shared
// memory, so that 5 CTAs share an SM (a CTA takes 38,912-46,592 bytes at
// D=128, 44,544 at group 12: under the 48 KB that needs no opt-in)
template <int D>
int mma_prepare() {
  static bool carved = false;
  if (!carved) {
    const cudaError_t err = cudaFuncSetAttribute(
        mma_decode_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return static_cast<int>(err);
    carved = true;
  }
  return 0;
}

template <int D>
int mma_launch(const void* q, const void* k, const void* v,
               const void* kv_len, void* out, int B, int Hq, int Hkv, int S,
               float scale, cudaStream_t s) {
  const size_t smem = mma_smem<D>(Hq, Hkv);
  const int err = mma_prepare<D>();
  if (err != 0) return err;
  mma_decode_kernel<D><<<B * Hkv * DEC_CLUSTER, DMMA_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(kv_len), static_cast<__nv_bfloat16*>(out),
      Hq, Hkv, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int mma_resident(int Hq, int Hkv) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DEC_CLUSTER);
  cfg.blockDim = dim3(DMMA_THREADS);
  cfg.dynamicSmemBytes = mma_smem<D>(Hq, Hkv);
  if (mma_prepare<D>() != 0) return -1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, mma_decode_kernel<D>, &cfg)
      == cudaSuccess ? n : -1;
}

template <int D>
int mma_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mma_decode_kernel<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // namespace

// The CUDA-core instance (the wrapper sends bf16 at D 64 and 128 to
// flash_decode_mma_launch below): q [B, Hq, D], k/v [B, Hkv, S, D]
// (float32 or bfloat16 by `dtype`, all one type, k and v 16-byte
// aligned), kv_len [B] int32, out [B, Hq, D] of q's type; Hq % Hkv == 0
// (a group above DEC_MAX_GROUP in sub-groups);
// D * sizeof(T) / 16 a power of two <= 32; shared memory 4 * gs * (16 * D
// + ceil(S/8) + 16) bytes within the card's 227 KB, gs the sub-group.
REPRO_EXPORT int flash_decode_launch(const void* q, const void* k,
                                     const void* v, const void* kv_len,
                                     void* out, int B, int Hq, int Hkv,
                                     int S, int D, float scale, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = D * (dtype == 0 ? 4 : 2) / 16;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0
      || lanes * 16 != D * (dtype == 0 ? 4 : 2) || lanes > 32
      || (lanes & (lanes - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  if (B <= 0) return 0;
  return dtype == 0
      ? launch_typed<float>(q, k, v, kv_len, out, B, Hq, Hkv, S, D, scale, s)
      : launch_typed<__nv_bfloat16>(q, k, v, kv_len, out, B, Hq, Hkv, S, D,
                                    scale, s);
}

// how many clusters of the kernel instance that (dtype, Hq / Hkv) selects
// can be resident on the card at once at an S-position cache's shared
// memory (a launch of more clusters runs in waves); -1 on error
REPRO_EXPORT int flash_decode_resident_clusters(int Hq, int Hkv, int S, int D,
                                                int dtype) {
  if (Hkv <= 0 || Hq % Hkv != 0) return -1;
  return dtype == 0 ? resident_typed<float>(Hq / Hkv, D, S)
                    : resident_typed<__nv_bfloat16>(Hq / Hkv, D, S);
}

// q [B, Hq, D], k/v [B, Hkv, S, D] bfloat16 (k and v 16-byte aligned),
// kv_len [B] int32, out [B, Hq, D] bfloat16; Hq % Hkv == 0 (any group);
// D 64 or 128.  One cluster of 8 CTAs a (row, kv-head); shared memory
// does not depend on S.
REPRO_EXPORT int flash_decode_mma_launch(const void* q, const void* k,
                                         const void* v, const void* kv_len,
                                         void* out, int B, int Hq, int Hkv,
                                         int S, int D, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128) || S < 0) {
    return cudaErrorInvalidValue;
  }
  if (B <= 0) return 0;
  return D == 128
      ? mma_launch<128>(q, k, v, kv_len, out, B, Hq, Hkv, S, scale, s)
      : mma_launch<64>(q, k, v, kv_len, out, B, Hq, Hkv, S, scale, s);
}

// how many clusters of the tensor-core instance can be resident on the
// card at once for this group and D; -1 on error
REPRO_EXPORT int flash_decode_mma_resident_clusters(int Hq, int Hkv, int D) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128)) return -1;
  return D == 128 ? mma_resident<128>(Hq, Hkv) : mma_resident<64>(Hq, Hkv);
}

// one CTA's dynamic shared memory of the tensor-core instance, in bytes
// (the layout `mma_smem_bytes` in kernels/flash_decode/ops.py states)
REPRO_EXPORT long long flash_decode_mma_smem_bytes(int Hq, int Hkv, int D) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128)) return -1;
  return static_cast<long long>(D == 128 ? mma_smem<128>(Hq, Hkv)
                                         : mma_smem<64>(Hq, Hkv));
}

// the tensor-core instance's registers a thread and local memory a
// thread in bytes (spills), as the loaded module reports them
REPRO_EXPORT int flash_decode_mma_attributes(int D, int* regs,
                                             int* local_bytes) {
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  return D == 128 ? mma_attributes<128>(regs, local_bytes)
                  : mma_attributes<64>(regs, local_bytes);
}
