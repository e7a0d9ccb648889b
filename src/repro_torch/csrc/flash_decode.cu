// flash_decode: one-token attention over a KV cache with a per-row valid
// prefix kv_len[b], GQA (q-head h reads kv-head h / (Hq/Hkv)).
//
// Replaces the Pallas TPU kernel `flash_decode_pallas`
// (src/repro/kernels/flash_decode/kernel.py:62, body `_decode_kernel` :29),
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
// 2 * sizeof(T) * D * Hkv * sum_b(kv_len[b]) bytes, plus q and the output.
// Its flops (4 * Hq * D per position) are ~1 per byte read, far below the
// card's ratio, so it stays on CUDA cores; what the card offers here is
// parallelism and wide loads.
//
// Design: a cluster of 8 CTAs per (batch row, kv-head, sub-group), each
// computing the sub-group of q-heads that shares the kv-head (the whole
// group up to 4 heads, see below), so each K and V row is read once for
// the sub-group.  Cluster rank r takes the fixed contiguous share
// [r*c, min(n, (r+1)*c)) of the valid prefix n = clamp(kv_len, 0, S),
// c = ceil(n / 8).  Because p is normalised before it is rounded, every
// share needs the row's global max and sum before P.V; the cluster's
// distributed shared memory gives both in the one launch:
//   1. scores: each cache row is read as 16-byte loads, D*sizeof(T)/16
//      lanes per row (8 for bf16 at D 64), 256/lanes rows per pass; the
//      first two passes' K and V slices are loaded together with q, so
//      a share of up to 64 rows (kv_len 512 at the serving shape) pays
//      one memory latency before its scores and none before P.V (its V
//      stays in registers); later passes load K and prefetch V into L2;
//      the group's dot products share each load and reduce over the
//      row's lanes; the share's scores stay in shared memory ([group,
//      ceil(S/8)] float32);
//   2. each share's max m_r and l_r = sum exp(s - m_r) per head go into
//      slot r of every rank's shared memory (remote stores), and one
//      cluster barrier later every rank holds all 8 pairs: the row's max
//      m = max m_r and sum = sum_r l_r * exp(m_r - m), added in rank
//      order, so every rank holds the same bits; p = round(exp(s - m) /
//      sum) in place;
//   3. its partial P.V in float32: each thread takes one 16-byte slice of
//      V rows for every head of the group; the lanes of a warp that share
//      a slice, then the 8 warps, are summed in a fixed order;
//   4. each rank stores its partial into slot r of rank 0's shared memory
//      and arrives on the cluster barrier (release); rank 0 waits
//      (acquire), adds the 8 slots in rank order and stores the output.
// Cluster barrier phases: the first is arrived on at the start and
// waited on only before the first remote store (it ensures every CTA of
// the cluster runs), so its cost hides behind the loads; no CTA reads
// another's shared memory, so the others may exit while rank 0 adds.
// The sum over shares equals the one-pass sum of exp(s - m) up to float32
// rounding (a few ulps), far inside the tolerances of kernels/cases.py.
// Register arrays are sized by the next power of two >= the heads a
// cluster computes (1, 2 or 4).  A GQA group of more than DEC_MAX_GROUP =
// 4 heads is split into the fewest sub-groups of at most 4, as equal as
// they come (qwen2.5-32b's 5 as 3 + 2, mistral-large-123b's 12 as 4 + 4
// + 4), each a cluster of its own with the same 8-way split of the
// prefix: the cache is read once a sub-group (from L2 after the first),
// and a thread needs ~80 registers, where arrays for 8 heads take 128
// and let 30 clusters be resident, against 45.  The cap of 4 was chosen
// on an NVIDIA H100 80GB HBM3 at 700 W, bf16, B=8, S=512, D=128, from
// builds of this file with the cap at 2, 4, 8 and 16 (PERF.md §6, chip
// call 4 of the dense slice): clusters of at most 4 heads 30.8 us at
// group 5 and 54.4 at group 12; of at most 8 (6 + 6) 38.0 and 68.3; of
// at most 2 36.4 and 70.4; one cluster of up to 16 heads a kv-head (213
// registers, 15 resident) 37.9 and 109.3; group 1 takes 48.6-48.7 in
// all four.
// Invariants: a row's output depends only on that row's (q, k, v, kv_len)
// (not on B, the other rows or the row's slot), and it is bitwise the same
// from run to run: every sum has a fixed order and no float atomics are
// used.  A share that is empty (n < 8) still arrives on every barrier
// phase; a row with kv_len 0 gets zeros (the serving path always has
// kv_len >= 1).
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

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

}  // namespace

// q [B, Hq, D], k/v [B, Hkv, S, D] (float32 or bfloat16 by `dtype`, all
// one type, k and v 16-byte aligned), kv_len [B] int32, out [B, Hq, D] of
// q's type; Hq % Hkv == 0 (a group above DEC_MAX_GROUP in sub-groups);
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
