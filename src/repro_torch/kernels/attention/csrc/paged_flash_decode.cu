// Paged flash decode: one new query position against a block-mapped KV
// pool, read through a per-slot block table and masked by per-slot lengths.
//
// Replaces repro/kernels/attention/decode.py:paged_flash_decode (the Pallas
// kernel).  The Pallas grid walks one pool block per step, routed by a
// scalar-prefetched table (its BlockSpec index maps gather
// pool[table[b, j]]), and carries the online-softmax state in VMEM
// scratch.  Here one CTA owns one (slot, query head) with flash_decode.cu's
// design: its 256 threads form 16 groups of 16 lanes, each group walks
// every 16th valid key with its own online softmax (m, l, acc), and the 16
// states are merged in shared memory.  The arithmetic is flash_decode.cu's
// step for step, so on a gathered view the two kernels agree bit for bit;
// only the row address differs:
//   * the CTA loads its slot's table row into shared memory once, each
//     entry clamped to [0, N-1] (the Pallas wrapper's clip): a sentinel
//     tail entry, or a freed slot's stale table, never reads out of the
//     pool;
//   * logical key p of KV head g is read at
//     pool + ((tbl[p / bs] * G + g) * bs + p % bs) * D.
// (The loop body is not shared with flash_decode.cu through a common
// device function: built that way, the dense kernel's bf16 instance got
// fewer registers and a spill, and ran 17% slower on an H100.)
// Semantics kept from the Pallas kernel: GQA maps query head h to KV head
// h / (H / G); q and every K / V element are rounded to the query's dtype,
// then widened to float32 (a float32 pool is read without a cast copy);
// keys at logical positions >= min(lengths[b], MB * bs) are masked, and not
// read at all (each would add exp(-1e30 - m) = 0); a slot with length 0
// writes exact zeros; o = acc / max(l, 1e-30), cast to the query's dtype.
//
// Bound on the H100: device-memory bytes, the valid keys' K and V rows read
// once (a few operations a byte), as for the dense kernel.  A pool block
// is bs * D contiguous elements of one KV head, so a group's reads stay 16
// bytes a lane on neighbouring addresses.  TMA or cp.async block prefetch,
// a CTA per KV head and splitting long slots over CTAs are later work.
#include "attn_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 16;                 // lanes a key row
constexpr int GROUPS = THREADS / LANES;   // partial softmax states a CTA

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
    paged_flash_decode_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ k_pool,
                              const TKV* __restrict__ v_pool,
                              const int* __restrict__ table,
                              const int* __restrict__ lengths,
                              TQ* __restrict__ o, int H, int N, int G,
                              int bs, int MB, float scale) {
  constexpr int E = D / LANES;            // elements a lane: 8 for D = 128
  static_assert(E == 8, "one 8-element load a lane");
  extern __shared__ int tbl[];            // the slot's MB table entries
  __shared__ float sm[GROUPS], sl[GROUPS];
  __shared__ float sacc[GROUPS][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int lane = threadIdx.x % LANES;
  const int grp = threadIdx.x / LANES;
  const int len = min(max(lengths[b], 0), MB * bs);
  const int used = (len + bs - 1) / bs;   // table entries the keys read
  const int* row = table + (int64_t)b * MB;
  for (int j = threadIdx.x; j < used; j += THREADS)
    tbl[j] = min(max(row[j], 0), N - 1);
  __syncthreads();

  const TQ* qp = q + ((int64_t)b * H + h) * D + lane * E;
  float qv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = attn::to_f(qp[e]);
  const TKV* kp = k_pool + (int64_t)g * bs * D + lane * E;
  const TKV* vp = v_pool + (int64_t)g * bs * D + lane * E;
  const int64_t block_stride = (int64_t)G * bs * D;   // one pool block

  // the two groups of a warp stop at different keys: each shuffles only
  // among its own 16 lanes
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  float m = attn::NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

#pragma unroll 4
  for (int t = grp; t < len; t += GROUPS) {
    const int64_t at = tbl[t / bs] * block_stride + (int64_t)(t % bs) * D;
    float kv[E], vv[E];
    attn::load8<TQ>(kp + at, kv);
    attn::load8<TQ>(vp + at, vv);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dot = fmaf(qv[e], kv[e], dot);
    // xor 8, 4, 2, 1 stays inside the group's 16 adjacent lanes
    dot += __shfl_xor_sync(half, dot, 8);
    dot += __shfl_xor_sync(half, dot, 4);
    dot += __shfl_xor_sync(half, dot, 2);
    dot += __shfl_xor_sync(half, dot, 1);
    const float s = dot * scale;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vv[e], acc[e] * corr);
    m = m_new;
  }

  if (lane == 0) {
    sm[grp] = m;
    sl[grp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sacc[grp][lane * E + e] = acc[e];
  __syncthreads();

  TQ* op = o + ((int64_t)b * H + h) * D;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float mx = attn::NEG_INF;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) mx = fmaxf(mx, sm[i]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) {
      const float w = expf(sm[i] - mx);   // 0 for a group that saw no key
      den = fmaf(sl[i], w, den);
      num = fmaf(sacc[i][d], w, num);
    }
    // mx still at the seed <=> no valid key (length 0): exact zeros
    const float out = mx > 0.5f * attn::NEG_INF ? num / fmaxf(den, 1e-30f)
                                                : 0.f;
    op[d] = attn::from_f<TQ>(out);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* lengths, void* o, int B, int H, int N, int G, int bs,
           int MB, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)MB * sizeof(int);
  auto kernel = paged_flash_decode_kernel<TQ, TKV, 128>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), table, lengths, static_cast<TQ*>(o), H, N,
      G, bs, MB, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, 1, D); k_pool / v_pool (N, G, bs, D); table (B, MB) int32;
// lengths (B,) int32; o (B, H, 1, D).  q_dtype / kv_dtype: 0 float32,
// 1 bfloat16 (a float32 query reads a float32 pool; a bf16 query either).
// D must be 128.  Returns a cudaError_t, or -1 for a shape or dtype this
// build has no instance of.
extern "C" int paged_flash_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const int* table,
                                  const int* lengths, void* o, int B, int H,
                                  int N, int G, int bs, int MB, int D,
                                  float scale, int q_dtype, int kv_dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128 || bs < 1 || MB < 1 || N < 1) return -1;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, table, lengths, o, B, H,
                                N, G, bs, MB, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, table,
                                                lengths, o, B, H, N, G, bs,
                                                MB, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k_pool, v_pool, table, lengths, o,
                                        B, H, N, G, bs, MB, scale, s);
  return -1;
}

extern "C" const char* paged_flash_decode_error(int code) {
  return code < 0 ? "no instance for this head dim, dtype or geometry"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
