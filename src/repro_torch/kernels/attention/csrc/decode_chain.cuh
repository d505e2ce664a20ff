// The chain walk both flash decode kernels share (flash_decode.cu over a
// dense cache, paged_flash_decode.cu through a block table): one new query
// position of one (slot, query head) against the slot's valid keys.
//
// The unit of arithmetic is the chain: 16 lanes that walk keys c, c +
// CHAINS, ... (c < CHAINS) below the slot's length, each key's dot product
// over the 16 lanes with the xor-shuffle order 8, 4, 2, 1, and their own
// online softmax (m, l, acc).  The CHAINS states of one (slot, head) then
// merge in chain order with one fmaf sequence.  Both kernels run this code,
// so on a gathered view they agree bit for bit by construction.
//
// Where chains run: the CHAINS chains of one (slot, head) are split over
// S CTAs of CPS = CHAINS / S chains each (decode.py:launch_plan picks S from
// the shapes and the card, never from the lengths, which live on the
// device); grid (S, H, B), the S CTAs of a (slot, head) launched as one
// thread block cluster.  With one CTA holding keys it merges in place and
// the others return at once.  With more, every CTA of the cluster puts its
// chains' float32 (m, l, acc) into its own shared memory, and after a
// cluster barrier CTA 0 reads the others' through distributed shared
// memory and merges all CHAINS states in chain order; a second barrier
// keeps the others' shared memory alive until it has read them.  Neither
// a workspace in device memory, a device-wide fence nor an atomic sits on
// the path.  A split still puts an exchange between CTAs on the path of
// every call: short slots in a long cache, whose split comes from the
// cache's length, pay it on a walk of a few microseconds.
//
// How key rows arrive: each lane copies its own 16 bytes (32 for a float32
// cache; twice that at D 256) of every K and V row its chain needs into a
// ring of RING keys in
// shared memory with cp.async, RING - U keys ahead of the ones it works on,
// and waits for them with cp.async.wait_group.  A lane consumes only the
// bytes it copied itself, so neither an mbarrier nor a CTA barrier sits in
// the loop.  Where a row lies is the kernel's row policy (Rows): locate()
// gives this lane's address of the chain's next key, advance() steps to the
// key CHAINS further on.
//
// A chain takes U keys a step: their dot products and shuffles are
// independent and overlap; their softmax updates then run in key order.
// A step whose U keys are all valid runs its updates without a branch
// between them, so the compiler can overlap one key's exponentials with the
// next one's; only a chain's last step checks key by key.
//
// The merge reads every chain's state from shared memory: after the walk
// the ring is free and holds a table of the CHAINS rows of acc.
//
// Head dims: a lane keeps E = 8 elements (16 bytes of a bf16 row, 32 of a
// float32 one) up to D = 128, and 2E = 16 past it (D = 256: two 16-byte
// copies a row for bf16, four for float32); lane_elems<D>() says which.
// Lanes with lane * elems >= D read nothing: their copies have a source
// size of 0, which fills their ring slots with zeros, so the loop has no
// branch on the lane, their dot products are exactly 0 and the
// xor-shuffle order is the same at every D.  A lane sums its elements in
// order, then the 16 lanes' sums go through the shuffles 8, 4, 2, 1: one
// arithmetic order a D.  At 16 elements a lane the ring keeps the same
// keys a chain as at 8, so its bytes double (64 KB a CTA at most, beside
// the paged kernel's table row), and the merge's table (16 x 256 floats)
// still fits it.
#pragma once

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include "attn_common.cuh"

namespace chain {

constexpr int CHAINS = 16;                // chains a (slot, head)
constexpr int LANES = 16;                 // lanes a key row
constexpr int E = 8;                      // elements a lane, D <= 128
constexpr int RING_BYTES = 32768;         // a CTA's ring at E elements

// Elements a lane holds at head dim D: E up to LANES * E, else 2 E.
template <int D>
__host__ __device__ constexpr int lane_elems() {
  return D <= LANES * E ? E : 2 * E;
}

// Bytes a lane stages of one K or V row: 16 (bf16) or 32 (float32) a
// group of E elements.
template <typename TKV, int D>
__host__ __device__ constexpr int lane_bytes() {
  return (int)sizeof(TKV) * lane_elems<D>();
}

// Keys a chain keeps staged: RING_BYTES over the CTA's chains at E
// elements a lane, 2 to 16 (the same keys at every D).
template <typename TKV, int CPS>
__host__ __device__ constexpr int ring_keys() {
  constexpr int r = RING_BYTES / (CPS * LANES * 2 * (int)sizeof(TKV) * E);
  return r < 2 ? 2 : (r > 16 ? 16 : r);
}

// Keys a chain takes a step: at most half the ring.
template <typename TKV, int CPS>
__host__ __device__ constexpr int step_keys() {
  constexpr int u = ring_keys<TKV, CPS>() / 2;
  return u > 4 ? 4 : u;
}

// Bytes of a CTA's ring.
template <typename TKV, int CPS, int D>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)CPS * ring_keys<TKV, CPS>() * LANES * 2 *
         lane_bytes<TKV, D>();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// 16 bytes, of which the first ``bytes`` (16 or 0) are read and the rest
// zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Eight staged elements as float32, each first rounded to T:
// attn::load8's conversions, from shared memory.
template <typename T>
__device__ __forceinline__ void unpack8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = attn::as_f<T>(v[e]);
}

template <typename T>
__device__ __forceinline__ void unpack8(const __nv_bfloat16* p,
                                        float out[8]) {
  const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e)   // a bf16 value rounds to itself in bf16
    out[e] = std::is_same<T, __nv_bfloat16>::value ? attn::to_f(v[e])
                                                    : attn::as_f<T>(v[e]);
}

// A lane's N staged elements (N a multiple of 8), eight at a time.
template <typename T, int N, typename TKV>
__device__ __forceinline__ void unpack(const TKV* p, float (&out)[N]) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c) unpack8<T>(p + 8 * c, out + 8 * c);
}

// CTAs of a (slot, head) that hold keys of a slot of ``len`` keys: split j
// does iff j * CPS < len.
template <int CPS>
__device__ __forceinline__ int active_ctas(int len) {
  return min(CHAINS / CPS, (len + CPS - 1) / CPS);
}

// Whether this CTA takes part in its (slot, head) of ``len`` keys: with one
// CTA holding keys, that one (split 0); with more, the whole cluster (the
// merge's barriers wait for every CTA of it).  A slot with no key writes
// exact zeros, once (split 0).
template <typename TQ, int CPS, int D>
__device__ __forceinline__ bool cta_takes_part(int len, TQ* op) {
  if (len == 0) {
    if (blockIdx.x == 0)
      for (int d = threadIdx.x; d < D; d += CPS * LANES)
        op[d] = attn::from_f<TQ>(0.f);
    return false;
  }
  return blockIdx.x == 0 || active_ctas<CPS>(len) > 1;
}

// One CTA (split blockIdx.x, cluster rank blockIdx.x) of (slot, head) bh:
// its chains walk their keys through ``ring`` (the CTA's dynamic shared
// memory, ring_bytes<TKV, CPS>() from a 16-byte boundary) and ``rows``
// (placed at this lane's chain; a lane past D is placed at column 0), then
// the merge.  ``len`` >= 1, and cta_takes_part() holds.
template <typename TQ, typename TKV, int CPS, int D, class Rows>
__device__ __forceinline__ void walk(const TQ* __restrict__ q,
                                     TQ* __restrict__ o, int bh, int len,
                                     float scale, TKV* ring, Rows rows) {
  constexpr int THREADS = CPS * LANES;
  constexpr int S = CHAINS / CPS;         // CTAs a (slot, head)
  constexpr int RING = ring_keys<TKV, CPS>();
  constexpr int U = step_keys<TKV, CPS>();
  constexpr int EL = lane_elems<D>();     // elements a lane
  constexpr int NV = lane_bytes<TKV, D>() / 16;   // a lane's 16-byte copies
  static_assert(D % EL == 0 && D <= LANES * EL, "whole lanes");
  static_assert(ring_bytes<TKV, CPS, D>() >= sizeof(float) * CHAINS * D,
                "the merge's table fits the ring");
  __shared__ float tm[CHAINS], tl[CHAINS];

  const int lane = threadIdx.x % LANES;
  const int grp = threadIdx.x / LANES;
  const int c0 = blockIdx.x * CPS;        // the CTA's first chain
  const int chain = c0 + grp;
  const bool live = lane * EL < D;        // the lane holds EL of D elements
  const TQ* qp = q + (int64_t)bh * D + lane * EL;
  float qv[EL];
#pragma unroll
  for (int e = 0; e < EL; ++e) qv[e] = live ? attn::to_f(qp[e]) : 0.f;

  // the chain's keys t = chain + CHAINS * i, i < n, staged RING - U ahead
  const int n = chain < len ? (len - chain + CHAINS - 1) / CHAINS : 0;
  // the lane's slot of key i, tensor kv (0: K, 1: V)
  auto slot = [&](int i, int kv) {
    return ring + (((grp * RING + i % RING) * 2 + kv) * LANES + lane) * EL;
  };
  const int bytes = live ? 16 : 0;        // a lane past D reads nothing
  int staged = 0;                         // keys staged (or skipped) so far
  auto stage = [&]() {
    if (staged < n) {
      const TKV* kp;
      const TKV* vp;
      rows.locate(kp, vp);
      TKV* kd = slot(staged, 0);
      TKV* vd = slot(staged, 1);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        cp_async16(reinterpret_cast<char*>(kd) + 16 * v,
                   reinterpret_cast<const char*>(kp) + 16 * v, bytes);
        cp_async16(reinterpret_cast<char*>(vd) + 16 * v,
                   reinterpret_cast<const char*>(vp) + 16 * v, bytes);
      }
      rows.advance();
    }
    ++staged;
    cp_async_commit();                    // one group a key, even empty
  };
#pragma unroll
  for (int i = 0; i < RING - U; ++i) stage();

  // the two groups of a warp stop at different keys: each shuffles only
  // among its own 16 lanes
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  float m = attn::NEG_INF, l = 0.f, acc[EL];
#pragma unroll
  for (int e = 0; e < EL; ++e) acc[e] = 0.f;
  // the online softmax of one key
  auto update = [&](float dot, const float (&vv)[EL]) {
    const float s = dot * scale;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[e] = fmaf(p, vv[e], acc[e] * corr);
    m = m_new;
  };

  for (int i0 = 0; i0 < n; i0 += U) {
    // keys i0 + RING - U .. i0 + RING - 1, into the slots keys i0 - U ..
    // i0 - 1 left; then keys i0 .. i0 + U - 1 are in
#pragma unroll
    for (int u = 0; u < U; ++u) stage();
    cp_async_wait<RING - U>();
    // the U keys' dot products, independent of each other (a slot past
    // the chain's last key holds stale values, never used; a lane past D
    // reads its zero-filled slots)
    float dot[U], vv[U][EL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kv[EL];
      unpack<TQ>(slot(i0 + u, 0), kv);
      unpack<TQ>(slot(i0 + u, 1), vv[u]);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EL; ++e) d = fmaf(qv[e], kv[e], d);
      // xor 8, 4, 2, 1 stays inside the group's 16 adjacent lanes
      d += __shfl_xor_sync(half, d, 8);
      d += __shfl_xor_sync(half, d, 4);
      d += __shfl_xor_sync(half, d, 2);
      d += __shfl_xor_sync(half, d, 1);
      dot[u] = d;
    }
    // the online softmax, key by key in order
    if (i0 + U <= n) {
#pragma unroll
      for (int u = 0; u < U; ++u) update(dot[u], vv[u]);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u >= n) break;
        update(dot[u], vv[u]);
      }
    }
  }
  cp_async_wait<0>();                     // no copy outlives the CTA
  __syncthreads();                        // every chain is done with the ring

  // this CTA's chains' (m, l, acc) into its shared memory, acc in the ring
  float* tacc = reinterpret_cast<float*>(ring);   // [CHAINS][D]
  if (live) {
#pragma unroll
    for (int e = 0; e < EL; ++e) tacc[chain * D + lane * EL + e] = acc[e];
  }
  if (lane == 0) {
    tm[chain] = m;
    tl[chain] = l;
  }
  // the other chains: another CTA's where the slot is split (chains below
  // len hold keys), else the seed of a chain with none
  const bool split = S > 1 && active_ctas<CPS>(len) > 1;
  namespace cg = cooperative_groups;
  if (split) {
    cg::this_cluster().sync();            // every CTA's chains are in place
    if (blockIdx.x != 0) {
      cg::this_cluster().sync();          // until CTA 0 has read them
      return;
    }
  }
  // CTA 0 (the only CTA merging): the other chains' rows, GATHER float4s
  // a thread in flight at once
  constexpr int ROW4 = D / 4;             // float4s of a row
  constexpr int GATHER = 8;
  float4* tacc4 = reinterpret_cast<float4*>(tacc);
  for (int i0 = threadIdx.x; i0 < CHAINS * ROW4; i0 += GATHER * THREADS) {
    float4 a[GATHER];
#pragma unroll
    for (int j = 0; j < GATHER; ++j) {
      const int i = i0 + j * THREADS, c = i / ROW4;
      a[j] = split && c >= CPS && c < min(len, CHAINS)
                 ? *cg::this_cluster().map_shared_rank(tacc4 + i, c / CPS)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < GATHER; ++j) {
      const int i = i0 + j * THREADS;
      if (i < CHAINS * ROW4 && i / ROW4 >= CPS) tacc4[i] = a[j];
    }
  }
  for (int c = CPS + threadIdx.x; c < CHAINS; c += THREADS) {
    const bool held = split && c < len;
    tm[c] = held ? *cg::this_cluster().map_shared_rank(tm + c, c / CPS)
                 : attn::NEG_INF;
    tl[c] = held ? *cg::this_cluster().map_shared_rank(tl + c, c / CPS)
                 : 0.f;
  }
  if (split)
    cg::this_cluster().sync();            // the others may leave
  else
    __syncthreads();

  // the CHAINS states merged in chain order
  float mx = attn::NEG_INF;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) mx = fmaxf(mx, tm[c]);
  float den = 0.f, w[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    w[c] = expf(tm[c] - mx);              // 0 for a chain that saw no key
    den = fmaf(tl[c], w[c], den);
  }
  TQ* op = o + (int64_t)bh * D;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float num = 0.f;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) num = fmaf(tacc[c * D + d], w[c], num);
    // mx still at the seed <=> no valid key (length 0): exact zeros
    const float out = mx > 0.5f * attn::NEG_INF ? num / fmaxf(den, 1e-30f)
                                                : 0.f;
    op[d] = attn::from_f<TQ>(out);
  }
}

// The instance of (splits, dtypes, head dim): f.template operator()<TQ,
// TKV, CPS, D>() for CPS = CHAINS / splits; -1 where this build has none.
template <typename TQ, typename TKV, int D, class F>
int by_split(int splits, F f) {
  switch (splits) {
    case 1: return f.template operator()<TQ, TKV, 16, D>();
    case 2: return f.template operator()<TQ, TKV, 8, D>();
    case 4: return f.template operator()<TQ, TKV, 4, D>();
    case 8: return f.template operator()<TQ, TKV, 2, D>();
    case 16: return f.template operator()<TQ, TKV, 1, D>();
  }
  return -1;
}

// q_dtype / kv_dtype: 0 float32, 1 bfloat16 (a float32 query reads a
// float32 cache; a bf16 query either).
template <int D, class F>
int by_dtype(int splits, int q_dtype, int kv_dtype, F f) {
  if (q_dtype == 0 && kv_dtype == 0)
    return by_split<float, float, D>(splits, f);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_split<__nv_bfloat16, __nv_bfloat16, D>(splits, f);
  if (q_dtype == 1 && kv_dtype == 0)
    return by_split<__nv_bfloat16, float, D>(splits, f);
  return -1;
}

// D 64, 112, 128 or 256 (decode.py:HEAD_DIMS).
template <class F>
int by_head_dim(int D, int splits, int q_dtype, int kv_dtype, F f) {
  if (D == 128) return by_dtype<128>(splits, q_dtype, kv_dtype, f);
  if (D == 112) return by_dtype<112>(splits, q_dtype, kv_dtype, f);
  if (D == 64) return by_dtype<64>(splits, q_dtype, kv_dtype, f);
  if (D == 256) return by_dtype<256>(splits, q_dtype, kv_dtype, f);
  return -1;
}

// Sets ``kernel``'s attributes on the current device for ``smem`` bytes of
// dynamic shared memory and clusters of S CTAs: once per kernel and device,
// and again only where a call needs more shared memory than was set (never
// lowered).  A decode step launches a decode kernel a layer; setting them on
// every call was host time on every launch.
inline cudaError_t configure(const void* kernel, size_t smem, int S) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = allowed.find({kernel, dev});
  if (it != allowed.end() && it->second >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && S > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) allowed[{kernel, dev}] = smem;
  return e;
}

// Launches ``kernel`` (an instance of CPS chains a CTA) over ``grid`` (S,
// H, B) with ``smem`` bytes of dynamic shared memory, the S CTAs of a (slot,
// head) one thread block cluster (16 is past the portable 8, which the
// H100 allows on request).  One CTA a (slot, head) is a plain launch.
template <int CPS, class... P, class... A>
int launch_clusters(void (*kernel)(P...), dim3 grid, size_t smem,
                    cudaStream_t stream, A... args) {
  constexpr int S = CHAINS / CPS;
  cudaError_t e = configure(reinterpret_cast<const void*>(kernel), smem, S);
  if (e != cudaSuccess) return (int)e;
  if (S == 1) {
    kernel<<<grid, CPS * LANES, smem, stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = S;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(CPS * LANES);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// CTAs of ``kernel`` (an instance of CPS chains a CTA) that one SM holds at
// once with ``smem`` bytes of dynamic shared memory (the occupancy API's),
// or minus a cudaError_t.
template <int CPS, class K>
int ctas_per_sm(K kernel, size_t smem) {
  cudaError_t e = configure(reinterpret_cast<const void*>(kernel), smem,
                            CHAINS / CPS);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, CPS * LANES,
                                                    smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace chain
