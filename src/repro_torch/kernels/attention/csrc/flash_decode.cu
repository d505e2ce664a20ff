// Flash decode: one new query position against a dense KV cache, masked by
// per-slot lengths.
//
// Replaces repro/kernels/attention/decode.py:flash_decode (the Pallas
// kernel).  The Pallas grid walks (block_k, D) cache tiles in order,
// carrying the online-softmax state in VMEM scratch.  Here one CTA owns one
// (slot, query head); its 256 threads form 16 groups of 16 lanes, each
// group walks every 16th valid key and keeps its own (m, l, acc) state, and
// the 16 states are merged in shared memory at the end (the same
// rescaling the online softmax does between tiles).
//
// Semantics kept from the Pallas kernel:
//   * GQA: query head h reads KV head h / (H / G);
//   * q and every K / V element are rounded to the query's dtype, then
//     widened to float32 (the layer's ``cache.astype(q.dtype)``; the cache
//     may be float32 while q is bfloat16, and this reads it without a cast
//     copy); s = (q . k) * scale;
//   * keys at positions >= lengths[b] are masked.  They are not read at
//     all: each of them would add exp(-1e30 - m) = 0;
//   * a slot with lengths[b] == 0 (m never left its -1e30 seed) writes
//     exact zeros, never NaN;
//   * o = acc / max(l, 1e-30), cast to the query's dtype.
// lengths[b] is clamped to [0, S].
//
// Bound on the H100: device-memory bytes, the valid part of the K and V
// cache read once (a few operations a byte).  The design reads 16 bytes a
// lane for bf16 (32 for float32) with neighbouring lanes on neighbouring
// addresses, a key row per 16 lanes, and leaves the compiler free to keep
// several keys' loads in flight (restrict pointers, an unrolled loop).
// Query heads of one KV head re-read the same rows (through L2); a CTA per
// KV head, and splitting long caches over several CTAs, are later work.
//
// Head dims: a lane always holds 8 elements (one 16-byte load of bf16), so
// D / 8 lanes of the 16 hold data and the others hold exact zeros.  A dead
// lane loads the row's first 8 elements (a valid address, so the loop has
// no branch), its q is 0 and its K elements are selected to 0, so its dot
// product is exactly 0; its accumulator is never stored.  The xor-shuffle
// order 8, 4, 2, 1 is the same at every D, so paged_flash_decode.cu, whose
// dead lanes read zeroed slots, keeps its bits.  D must be a multiple of 8
// up to 128; this file builds D = 112 and 128.
#include "attn_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 16;                 // lanes a key row
constexpr int GROUPS = THREADS / LANES;   // partial softmax states a CTA
constexpr int E = 8;                      // elements a lane: 16 bf16 bytes

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int* __restrict__ lengths, TQ* __restrict__ o,
                        int H, int G, int S, float scale) {
  static_assert(D % E == 0 && D <= LANES * E, "whole 8-element lanes");
  __shared__ float sm[GROUPS], sl[GROUPS];
  __shared__ float sacc[GROUPS][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int lane = threadIdx.x % LANES;
  const int grp = threadIdx.x / LANES;
  const int len = min(max(lengths[b], 0), S);
  const bool live = lane * E < D;         // the lane holds 8 of D elements
  const int col = live ? lane * E : 0;    // a dead lane reads columns 0-7

  const TQ* qp = q + ((int64_t)b * H + h) * D + col;
  float qv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = live ? attn::to_f(qp[e]) : 0.f;
  const int64_t base = ((int64_t)b * G + g) * S * D + col;
  const TKV* kp = k + base;
  const TKV* vp = v + base;

  // the two groups of a warp stop at different keys: each shuffles only
  // among its own 16 lanes
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  float m = attn::NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

#pragma unroll 4
  for (int t = grp; t < len; t += GROUPS) {
    float kv[E], vv[E];
    attn::load8<TQ>(kp + (int64_t)t * D, kv);
    attn::load8<TQ>(vp + (int64_t)t * D, vv);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dot = fmaf(qv[e], live ? kv[e] : 0.f, dot);
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
  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e) sacc[grp][lane * E + e] = acc[e];
  }
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

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, int B, int H, int G, int S, float scale,
           cudaStream_t stream) {
  const dim3 grid(H, B);
  flash_decode_kernel<TQ, TKV, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), lengths, static_cast<TQ*>(o), H, G, S,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int by_dtype(const void* q, const void* k, const void* v, const int* lengths,
             void* o, int B, int H, int G, int S, float scale, int q_dtype,
             int kv_dtype, cudaStream_t s) {
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, D>(q, k, v, lengths, o, B, H, G, S, scale,
                                   s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, D>(q, k, v, lengths, o, B, H,
                                                   G, S, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float, D>(q, k, v, lengths, o, B, H, G, S,
                                           scale, s);
  return -1;
}

}  // namespace

// q_dtype / kv_dtype: 0 float32, 1 bfloat16 (a float32 query reads a
// float32 cache; a bf16 query either).  D must be 112 or 128
// (decode.py:HEAD_DIMS).  Returns a cudaError_t, or -1 for a shape or dtype
// this build has no instance of.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* lengths, void* o, int B, int H, int G,
                            int S, int D, float scale, int q_dtype,
                            int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return by_dtype<128>(q, k, v, lengths, o, B, H, G, S, scale, q_dtype,
                         kv_dtype, s);
  if (D == 112)
    return by_dtype<112>(q, k, v, lengths, o, B, H, G, S, scale, q_dtype,
                         kv_dtype, s);
  return -1;
}

extern "C" const char* flash_decode_error(int code) {
  return code < 0 ? "no instance for this head dim or dtype"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
