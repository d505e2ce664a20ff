// Flash decode: one new query position against a dense KV cache, masked by
// per-slot lengths.
//
// Replaces repro/kernels/attention/decode.py:flash_decode (the Pallas
// kernel).  The Pallas grid walks (block_k, D) cache tiles in order,
// carrying the online-softmax state in VMEM scratch.  Here the 16 chains of
// a (slot, query head) (16 lanes each, walking every 16th valid key with
// their own online softmax) are split over the CTAs of decode.launch_plan
// and merged in chain order: decode_chain.cuh, which paged_flash_decode.cu
// runs too, so the two kernels agree bit for bit on a gathered view.
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
// cache read once (a few operations a byte).  What held the kernel below
// half of it: one CTA a (slot, head), so a long slot among short ones ran
// on a few SMs while the short slots' CTAs finished at once; each lane's
// loads issued straight from device memory; at D 112 a branch on the dead
// lanes in the loop.  The design: the chains split over the CTAs of the
// plan (from the shapes, never the lengths); each lane's rows staged into
// the shared-memory ring by cp.async, dead lanes zero-filled without a
// branch.  The dense cache needs no table: logical key p of KV head g is at
//   k + ((b * G + g) * S + p) * D,
// so a chain's address advances by CHAINS * D a key, with no block cursor.
// The chains of a CTA read consecutive rows.  Offsets are 64-bit (a float32
// cache of a large batch passes 2^31 elements).  Query heads of one KV
// head re-read the same rows (through L2); a CTA per KV head is later work.
//
// This file builds D = 64, 112, 128 and 256, each at the three dtype pairs
// and five splits.
#include "decode_chain.cuh"

namespace {

using chain::CHAINS;
using chain::LANES;

// A chain's rows in the dense cache: this lane's elements of its next key.
template <typename TKV, int D>
struct DenseRows {
  const TKV* k;
  const TKV* v;

  __device__ __forceinline__ void locate(const TKV*& kp,
                                         const TKV*& vp) const {
    kp = k;
    vp = v;
  }
  __device__ __forceinline__ void advance() {
    k += CHAINS * D;
    v += CHAINS * D;
  }
};

template <typename TQ, typename TKV, int CPS, int D>
__global__ void __launch_bounds__(CPS * LANES)
    flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int* __restrict__ lengths, TQ* __restrict__ o,
                        int H, int G, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int len = min(max(lengths[b], 0), S);
  if (!chain::cta_takes_part<TQ, CPS, D>(len, o + (int64_t)bh * D)) return;

  const int g = h / (H / G);
  const int lane = threadIdx.x % LANES;
  const int c = blockIdx.x * CPS + threadIdx.x / LANES;   // the chain
  // a lane past D reads nothing; its address stays inside the row
  constexpr int EL = chain::lane_elems<D>();
  const int col = lane * EL < D ? lane * EL : 0;
  const int64_t at = (((int64_t)b * G + g) * S + c) * D + col;
  chain::walk<TQ, TKV, CPS, D>(q, o, bh, len, scale,
                               reinterpret_cast<TKV*>(smem),
                               DenseRows<TKV, D>{k + at, v + at});
}

// The launch and the occupancy query as functors of an instance.
struct Launch {
  const void *q, *k, *v;
  const int* lengths;
  void* o;
  int B, H, G, S;
  float scale;
  cudaStream_t s;
  template <typename TQ, typename TKV, int CPS, int D>
  int operator()() const {
    return chain::launch_clusters<CPS>(
        flash_decode_kernel<TQ, TKV, CPS, D>, dim3(CHAINS / CPS, H, B),
        chain::ring_bytes<TKV, CPS, D>(), s, static_cast<const TQ*>(q),
        static_cast<const TKV*>(k), static_cast<const TKV*>(v), lengths,
        static_cast<TQ*>(o), H, G, S, scale);
  }
};

struct Occupancy {
  template <typename TQ, typename TKV, int CPS, int D>
  int operator()() const {
    return chain::ctas_per_sm<CPS>(flash_decode_kernel<TQ, TKV, CPS, D>,
                                   chain::ring_bytes<TKV, CPS, D>());
  }
};

}  // namespace

// q (B, H, 1, D); k / v (B, G, S, D), contiguous and 16-byte aligned;
// lengths (B,) int32; o (B, H, 1, D).  splits: CTAs a (slot, head), one of
// 1, 2, 4, 8, 16 (decode.py:launch_plan's).  q_dtype / kv_dtype: 0
// float32, 1 bfloat16 (a float32 query reads a float32 cache; a bf16 query
// either).  D must be 64, 112, 128 or 256 (decode.py:HEAD_DIMS).  Returns a
// cudaError_t, or -1 for a shape, dtype or split this build has no
// instance of.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* lengths, void* o, int B, int H, int G,
                            int S, int D, float scale, int q_dtype,
                            int kv_dtype, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || G < 1 || S < 1) return -1;
  return chain::by_head_dim(D, splits, q_dtype, kv_dtype,
                            Launch{q, k, v, lengths, o, B, H, G, S, scale, s});
}

// CTAs of the instance for (splits, dtypes, D) that one SM holds at once
// (the occupancy API's), or minus a cudaError_t, or -1.
extern "C" int flash_decode_ctas_per_sm(int splits, int q_dtype,
                                        int kv_dtype, int D) {
  return chain::by_head_dim(D, splits, q_dtype, kv_dtype, Occupancy{});
}

extern "C" const char* flash_decode_error(int code) {
  return code < 0 ? "no instance for this head dim, dtype or split"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
