// Paged flash decode: one new query position against a block-mapped KV
// pool, read through a per-slot block table and masked by per-slot lengths.
//
// Replaces repro/kernels/attention/decode.py:paged_flash_decode (the Pallas
// kernel).  The Pallas grid walks one pool block per step, routed by a
// scalar-prefetched table (its BlockSpec index maps gather
// pool[table[b, j]]), and carries the online-softmax state in VMEM
// scratch.
//
// The arithmetic is flash_decode.cu's, step for step, so on a gathered view
// the two kernels agree bit for bit.  The unit of arithmetic is the chain:
// 16 lanes that walk keys c, c + CHAINS, ... (c < CHAINS, flash_decode.cu's
// GROUPS) below the slot's length, each key's dot product over the 16 lanes
// with the xor-shuffle order 8, 4, 2, 1, and their own online softmax
// (m, l, acc).  The CHAINS states of one (slot, query head) then merge in
// chain order with flash_decode.cu's fmaf sequence.
//
// What differs is where chains run and how their key rows arrive:
//   * The CHAINS chains of one (slot, head) are split over S CTAs of
//     CPS = CHAINS / S chains each (decode.py:launch_plan picks S from the
//     batch, the heads, the longest length the table maps and the card,
//     never from the lengths, which live on the device).  Grid (S, H, B).
//     A CTA reads its slot's length and returns at once when its chains
//     have no key.  With more than one CTA holding keys, each writes its
//     chains' float32 (m, l, acc) to a workspace, and the last to arrive
//     (an atomic ticket after __threadfence) merges all CHAINS states in
//     chain order and resets the ticket for the next call; the merged bits
//     do not depend on which CTA is last.  Otherwise the one CTA with keys
//     merges in place.  One launch a call.
//   * Key rows are staged.  The slot's table row comes into shared memory
//     once (cp.async, 4 bytes an entry).  Each lane then copies its own 16
//     bytes of every K and V row its chain needs into a ring of RING keys
//     in shared memory with cp.async, RING - U keys ahead of the ones it
//     works on, and waits for them with cp.async.wait_group.  A lane
//     consumes only the bytes it copied itself, so neither an mbarrier nor
//     a CTA barrier sits in the loop.  A chain's block and row advance
//     without a division, and the table is read once a block: logical key
//     p of KV head g is read at
//       pool + ((tbl[p / bs] * G + g) * bs + p % bs) * D.
//     A pool block is bs * D contiguous elements of one KV head: the chains
//     of a CTA read consecutive rows of it.
//   * A chain takes U keys a step: their dot products and shuffles are
//     independent and overlap; their softmax updates then run in key
//     order, as the dense kernel's do.
//
// Semantics kept from the Pallas kernel: GQA maps query head h to KV head
// h / (H / G); table entries are clamped to [0, N-1] (a sentinel tail
// entry, or a freed slot's stale table, never reads out of the pool); q and
// every K / V element are rounded to the query's dtype, then widened to
// float32 (a float32 pool is staged as float32 and rounded on read); keys
// at logical positions >= min(lengths[b], MB * bs) are masked, and not read
// at all (each would add exp(-1e30 - m) = 0); a slot with length 0 writes
// exact zeros; o = acc / max(l, 1e-30), cast to the query's dtype.
//
// Bound on the H100: device-memory bytes, the valid keys' K and V rows read
// once (a few operations a byte).  A CTA that serves all the query heads
// of a KV head from one staged block is later work.
//
// Head dims: D is a template argument, as in flash_decode.cu, and so are
// the row address above, a pool block's stride and the workspace's rows.
// A lane keeps its 8 elements (16 bytes of a bf16 row, 32 of a float32
// one): lanes with lane * 8 >= D zero their own slots of the ring once,
// stage nothing and store nothing, and the loop reads their slots as it
// reads the others (no branch), so their dot products are exactly 0; the
// xor-shuffle order is unchanged, so the bits stay flash_decode.cu's.
// This file builds D = 112 and 128, each at the three dtype pairs and five
// splits.
#include <type_traits>

#include "attn_common.cuh"

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

constexpr int CHAINS = 16;                // chains a (slot, head): GROUPS
constexpr int LANES = 16;                 // lanes a key row
constexpr int E = 8;                      // elements a lane
constexpr int RING_BYTES = 32768;         // a CTA's ring of staged keys

// Bytes a lane stages of one K or V row: 16 (bf16) or 32 (float32).
template <typename TKV>
__host__ __device__ constexpr int lane_bytes() {
  return (int)sizeof(TKV) * E;
}

// Keys a chain keeps staged: RING_BYTES over the CTA's chains, 2 to 16.
template <typename TKV, int CPS>
__host__ __device__ constexpr int ring_keys() {
  constexpr int r = RING_BYTES / (CPS * LANES * 2 * lane_bytes<TKV>());
  return r < 2 ? 2 : (r > 16 ? 16 : r);
}

// Keys a chain takes a step: their loads and dot products overlap, their
// softmax updates then run in key order; at most half the ring.
template <typename TKV, int CPS>
__host__ __device__ constexpr int step_keys() {
  constexpr int u = ring_keys<TKV, CPS>() / 2;
  return u > 4 ? 4 : u;
}

__host__ __device__ constexpr size_t table_bytes(int MB) {
  return ((size_t)MB * sizeof(int) + 15) / 16 * 16;
}

// Dynamic shared memory: the table row, then the ring.
template <typename TKV, int CPS>
size_t smem_bytes(int MB) {
  return table_bytes(MB) + (size_t)CPS * ring_keys<TKV, CPS>() * LANES * 2 *
                               lane_bytes<TKV>();
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A lane's eight staged elements as float32, each first rounded to T:
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

template <typename TQ, typename TKV, int CPS, int D>
__global__ void __launch_bounds__(CPS * LANES)
    paged_flash_decode_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ k_pool,
                              const TKV* __restrict__ v_pool,
                              const int* __restrict__ table,
                              const int* __restrict__ lengths,
                              TQ* __restrict__ o, float* __restrict__ ws_acc,
                              float* __restrict__ ws_ml,
                              int* __restrict__ tickets, int H, int N, int G,
                              int bs, int MB, float scale) {
  constexpr int THREADS = CPS * LANES;
  constexpr int S = CHAINS / CPS;         // CTAs a (slot, head)
  constexpr int RING = ring_keys<TKV, CPS>();
  constexpr int U = step_keys<TKV, CPS>();
  constexpr int NV = lane_bytes<TKV>() / 16;   // a lane's 16-byte copies
  static_assert(D % E == 0 && D <= LANES * E, "whole 8-element lanes");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sm[CPS], sl[CPS];
  __shared__ float sacc[CPS][D];
  __shared__ int is_last;

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int lane = threadIdx.x % LANES;
  const int grp = threadIdx.x / LANES;
  const int c0 = split * CPS;             // the CTA's first chain
  const int chain = c0 + grp;
  const int len = min(max(lengths[b], 0), MB * bs);
  TQ* op = o + (int64_t)bh * D;
  if (len == 0) {                         // no key: exact zeros, once
    if (split == 0)
      for (int d = threadIdx.x; d < D; d += THREADS)
        op[d] = attn::from_f<TQ>(0.f);
    return;
  }
  if (c0 >= len) return;                  // these chains have no key
  // CTAs that hold keys: split j does iff j * CPS < len
  const int active = min(S, (len + CPS - 1) / CPS);

  int* tbl = reinterpret_cast<int*>(smem);
  TKV* ring = reinterpret_cast<TKV*>(smem + table_bytes(MB));
  {
    const int used = (len + bs - 1) / bs; // table entries the keys read
    const int* row = table + (int64_t)b * MB;
    for (int j = threadIdx.x; j < used; j += THREADS)
      cp_async4(tbl + j, row + j);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  const int g = h / (H / G);
  const bool live = lane * E < D;         // the lane holds 8 of D elements
  const TQ* qp = q + (int64_t)bh * D + lane * E;
  float qv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = live ? attn::to_f(qp[e]) : 0.f;

  // the chain's keys t = chain + CHAINS * i, i < n, staged RING - U ahead
  const int n = chain < len ? (len - chain + CHAINS - 1) / CHAINS : 0;
  const int64_t block_stride = (int64_t)G * bs * D;   // one pool block
  const int64_t head_off = (int64_t)g * bs * D + lane * E;
  const int dj = CHAINS / bs, dr = CHAINS % bs;       // a step in (j, r)
  int pj = chain / bs, pr = chain % bs;   // the next staged key's block, row
  int cur_j = -1;
  const TKV* kbase = k_pool;
  const TKV* vbase = v_pool;
  // the lane's slot of key i, tensor kv (0: K, 1: V)
  auto slot = [&](int i, int kv) {
    return ring + (((grp * RING + i % RING) * 2 + kv) * LANES + lane) * E;
  };
  int staged = 0;                         // keys staged (or skipped) so far
  auto stage = [&]() {
    if (staged < n) {
      if (pj != cur_j) {                  // a new block: its table entry
        cur_j = pj;
        const int64_t at = min(max(tbl[pj], 0), N - 1) * block_stride +
                           head_off;
        kbase = k_pool + at;
        vbase = v_pool + at;
      }
      const int64_t row = (int64_t)pr * D;
      TKV* kd = slot(staged, 0);
      TKV* vd = slot(staged, 1);
      if (live) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          cp_async16(reinterpret_cast<char*>(kd) + 16 * v,
                     reinterpret_cast<const char*>(kbase + row) + 16 * v);
          cp_async16(reinterpret_cast<char*>(vd) + 16 * v,
                     reinterpret_cast<const char*>(vbase + row) + 16 * v);
        }
      }
      pr += dr;
      pj += dj;
      if (pr >= bs) {
        pr -= bs;
        ++pj;
      }
    }
    ++staged;
    cp_async_commit();                    // one group a key, even empty
  };
  if (!live) {                            // the lane's slots hold zeros
    for (int i = 0; i < RING; ++i)
      for (int kv = 0; kv < 2; ++kv)
        for (int e = 0; e < E; ++e) slot(i, kv)[e] = attn::from_f<TKV>(0.f);
  }
#pragma unroll
  for (int i = 0; i < RING - U; ++i) stage();

  // the two groups of a warp stop at different keys: each shuffles only
  // among its own 16 lanes
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  float m = attn::NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int i0 = 0; i0 < n; i0 += U) {
    // keys i0 + RING - U .. i0 + RING - 1, into the slots keys i0 - U ..
    // i0 - 1 left; then keys i0 .. i0 + U - 1 are in
#pragma unroll
    for (int u = 0; u < U; ++u) stage();
    cp_async_wait<RING - U>();
    // the U keys' dot products, independent of each other (a slot past
    // the chain's last key holds stale values, never used; a lane past D
    // reads its zeros)
    float dot[U], vv[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kv[E];
      unpack8<TQ>(slot(i0 + u, 0), kv);
      unpack8<TQ>(slot(i0 + u, 1), vv[u]);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qv[e], kv[e], d);
      // xor 8, 4, 2, 1 stays inside the group's 16 adjacent lanes
      d += __shfl_xor_sync(half, d, 8);
      d += __shfl_xor_sync(half, d, 4);
      d += __shfl_xor_sync(half, d, 2);
      d += __shfl_xor_sync(half, d, 1);
      dot[u] = d;
    }
    // the online softmax, key by key in order
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u >= n) break;
      const float s = dot[u] * scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vv[u][e], acc[e] * corr);
      m = m_new;
    }
  }
  cp_async_wait<0>();                     // no copy outlives the CTA

  if (lane == 0) {
    sm[grp] = m;
    sl[grp] = l;
  }
  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e) sacc[grp][lane * E + e] = acc[e];
  }

  if (S > 1 && active > 1) {
    // publish the chains' states; the last CTA of the (slot, head) merges
    float* wa = ws_acc + ((int64_t)bh * CHAINS + chain) * D + lane * E;
    if (live) {
#pragma unroll
      for (int e = 0; e < E; ++e) wa[e] = acc[e];
    }
    if (lane == 0) {
      ws_ml[((int64_t)bh * CHAINS + chain) * 2] = m;
      ws_ml[((int64_t)bh * CHAINS + chain) * 2 + 1] = l;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      is_last = atomicAdd(tickets + bh, 1) == active - 1;
      if (is_last) atomicExch(tickets + bh, 0);   // ready for the next call
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
  } else {
    __syncthreads();
  }

  // chain c's state: this CTA's own, another CTA's (chains below len have
  // keys and sit in CTAs that hold keys), or the seed of a chain with none
  float mc[CHAINS], lc[CHAINS], w[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    if (c >= c0 && c < c0 + CPS) {
      mc[c] = sm[c - c0];
      lc[c] = sl[c - c0];
    } else if (S > 1 && active > 1 && c < len) {
      mc[c] = __ldcg(ws_ml + ((int64_t)bh * CHAINS + c) * 2);
      lc[c] = __ldcg(ws_ml + ((int64_t)bh * CHAINS + c) * 2 + 1);
    } else {
      mc[c] = attn::NEG_INF;
      lc[c] = 0.f;
    }
  }
  float mx = attn::NEG_INF;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) mx = fmaxf(mx, mc[c]);
  float den = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    w[c] = expf(mc[c] - mx);              // 0 for a chain that saw no key
    den = fmaf(lc[c], w[c], den);
  }
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float num = 0.f;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      float a = 0.f;
      if (c >= c0 && c < c0 + CPS)
        a = sacc[c - c0][d];
      else if (S > 1 && active > 1 && c < len)
        a = __ldcg(ws_acc + ((int64_t)bh * CHAINS + c) * D + d);
      num = fmaf(a, w[c], num);
    }
    // mx still at the seed <=> no valid key (length 0): exact zeros
    const float out = mx > 0.5f * attn::NEG_INF ? num / fmaxf(den, 1e-30f)
                                                : 0.f;
    op[d] = attn::from_f<TQ>(out);
  }
}

template <typename TQ, typename TKV, int CPS, int D>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* lengths, void* o, float* ws, int* tickets, int B, int H,
           int N, int G, int bs, int MB, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<TKV, CPS>(MB);
  auto kernel = paged_flash_decode_kernel<TQ, TKV, CPS, D>;
  // with the static shared memory, past 48 KB needs the opt-in
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(CHAINS / CPS, H, B);
  float* ws_ml = ws ? ws + (size_t)B * H * CHAINS * D : nullptr;
  kernel<<<grid, CPS * LANES, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), table, lengths, static_cast<TQ*>(o), ws,
      ws_ml, tickets, H, N, G, bs, MB, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int CPS, int D>
int ctas_per_sm(int MB) {
  const size_t smem = smem_bytes<TKV, CPS>(MB);
  auto kernel = paged_flash_decode_kernel<TQ, TKV, CPS, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, CPS * LANES,
                                                    smem);
  return e == cudaSuccess ? n : -(int)e;
}

// One of the instances by chains a CTA: F<CPS, D>() for CPS = 16 / splits.
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

// The instance of head dim D (112 or 128, decode.py:HEAD_DIMS).
template <class F>
int by_head_dim(int D, int splits, int q_dtype, int kv_dtype, F f) {
  if (D == 128) return by_dtype<128>(splits, q_dtype, kv_dtype, f);
  if (D == 112) return by_dtype<112>(splits, q_dtype, kv_dtype, f);
  return -1;
}

// The launch and the occupancy query as functors of an instance.
struct Launch {
  const void *q, *k, *v;
  const int *table, *lengths;
  void* o;
  float* ws;
  int* tickets;
  int B, H, N, G, bs, MB;
  float scale;
  cudaStream_t s;
  template <typename TQ, typename TKV, int CPS, int D>
  int operator()() const {
    return launch<TQ, TKV, CPS, D>(q, k, v, table, lengths, o, ws, tickets, B,
                                   H, N, G, bs, MB, scale, s);
  }
};

struct Occupancy {
  int MB;
  template <typename TQ, typename TKV, int CPS, int D>
  int operator()() const { return ctas_per_sm<TQ, TKV, CPS, D>(MB); }
};

}  // namespace

// q (B, H, 1, D); k_pool / v_pool (N, G, bs, D), 16-byte aligned; table
// (B, MB) int32; lengths (B,) int32; o (B, H, 1, D).  splits: CTAs a (slot,
// head), one of 1, 2, 4, 8, 16 (decode.py:launch_plan's).  ws: float32
// workspace of B * H * CHAINS * (D + 2) values, tickets: B * H int32, zero
// before the first call (each call leaves them zero); both unused (null)
// at splits 1.  q_dtype / kv_dtype: 0 float32, 1 bfloat16 (a float32 query
// reads a float32 pool; a bf16 query either).  D must be 112 or 128.
// Returns a cudaError_t, or -1 for a shape, dtype or split this build has
// no instance of.
extern "C" int paged_flash_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const int* table,
                                  const int* lengths, void* o, float* ws,
                                  int* tickets, int B, int H, int N, int G,
                                  int bs, int MB, int D, float scale,
                                  int q_dtype, int kv_dtype, int splits,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bs < 1 || MB < 1 || N < 1 || B < 1 || H < 1) return -1;
  if (splits > 1 && (ws == nullptr || tickets == nullptr)) return -1;
  return by_head_dim(D, splits, q_dtype, kv_dtype,
                     Launch{q, k_pool, v_pool, table, lengths, o, ws, tickets,
                            B, H, N, G, bs, MB, scale, s});
}

// CTAs of the instance for (splits, dtypes, D) that one SM holds at once
// with a table of MB entries (the occupancy API's), or minus a cudaError_t,
// or -1.
extern "C" int paged_flash_decode_ctas_per_sm(int splits, int q_dtype,
                                              int kv_dtype, int MB, int D) {
  return by_head_dim(D, splits, q_dtype, kv_dtype, Occupancy{MB});
}

extern "C" const char* paged_flash_decode_error(int code) {
  return code < 0 ? "no instance for this head dim, dtype, split or geometry"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
