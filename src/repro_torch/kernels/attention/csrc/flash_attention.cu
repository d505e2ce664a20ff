// Flash attention forward (online softmax), float32 or bfloat16 in,
// float32 arithmetic.
//
// Replaces repro/kernels/attention/flash.py:flash_attention_fwd (the Pallas
// kernel).  The Pallas grid carries m / l / acc in VMEM scratch across a
// sequential k-block axis; CUDA blocks run in no order, so here one CTA owns
// one (batch, query head, 64-query block) and carries that state in
// registers through a loop over 64-key blocks.  The score tile never leaves
// the SM: no (Sq x Sk) matrix is written to device memory.
//
// Semantics kept from the Pallas kernel:
//   * GQA: query head h reads KV head h / (H / G);
//   * s = (q . k) * scale in float32; masked scores are the finite -1e30;
//   * causal keeps k_idx <= q_idx (the kernel's rule; the oracle's offset
//     rule agrees when Sq == Sk, which is all attention.apply produces);
//   * ragged tails of Q and K are masked in the kernel, nothing is padded;
//   * o = acc / max(l, 1e-30), cast to the input dtype.
// Key blocks wholly above the diagonal are skipped: for every query row
// the first key is valid, so there corr = 1 and p = 0, the same bits.
//
// Bound on the H100: at prefill lengths (S = 2048, D = 128) the work is
// 4 * S^2 * D / 2 operations per head against 4 * S * D elements of
// traffic, far above the card's ridge point, so the bound is operations.
// This first kernel runs them on the CUDA cores in float32 (no wgmma, no
// TMA): 128 threads, each a 4 x 8 block of scores and a 4 x 16 block of the
// output; Q, K, V and P tiles in padded shared memory (115,712 bytes for
// D = 128, so two CTAs an SM).  Tensor cores are later work.
#include "attn_common.cuh"

namespace {

constexpr int BQ = 64;        // query rows a CTA
constexpr int BK = 64;        // keys a step
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr int TR = BQ / 16;   // query rows a thread
constexpr int TC = BK / 8;    // score columns a thread

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) +
                                  BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H, int G,
                     int Sq, int Sk, float scale, int causal) {
  constexpr int LD = D + 1;   // padded tile row: no bank conflicts
  constexpr int LP = BK + 1;
  constexpr int TD = D / 8;   // output columns a thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][LD]
  float* ks = qs + BQ * LD;         // [BK][LD]
  float* vs = ks + BK * LD;         // [BK][LD]
  float* ps = vs + BK * LD;         // [BQ][LP]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid & 7;     // column group: lanes 8 apart share no bank
  const int ty = tid >> 3;    // row group
  const T* qp = q + ((int64_t)b * H + h) * Sq * D;
  const T* kp = k + ((int64_t)b * G + g) * Sk * D;
  const T* vp = v + ((int64_t)b * G + g) * Sk * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    qs[r * LD + c] =
        q0 + r < Sq ? attn::to_f(qp[(int64_t)(q0 + r) * D + c]) : 0.f;
  }

  float m[TR], l[TR], acc[TR][TD];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = attn::NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();            // the last step's reads of ks / vs / ps
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Sk;
      const int64_t at = (int64_t)(k0 + r) * D + c;
      ks[r * LD + c] = in ? attn::to_f(kp[at]) : 0.f;
      vs[r * LD + c] = in ? attn::to_f(vp[at]) : 0.f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = qs[(ty * TR + i) * LD + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) kv[j] = ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qi = q0 + ty * TR + i;
      float mx = attn::NEG_INF;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int ki = k0 + tx + 8 * j;
        const bool valid = ki < Sk && (!causal || ki <= qi);
        s[i][j] = valid ? s[i][j] * scale : attn::NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's 8 column groups are lanes tx = 0..7 of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * TR + i) * LP + tx + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();            // P complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[TR], vv[TD];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = ps[(ty * TR + i) * LP + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) vv[j] = vs[c * LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* op = o + ((int64_t)b * H + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + ty * TR + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j)
      op[(int64_t)qi * D + tx + 8 * j] = attn::from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int G, int Sq, int Sk, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, G, Sq, Sk, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  D must be 128.  Returns a cudaError_t,
// or -1 for a head dim or dtype this build has no instance of.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int G, int Sq, int Sk, int D, float scale,
                                   int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128) return -1;
  if (dtype == 0)
    return launch<float, 128>(q, k, v, o, B, H, G, Sq, Sk, scale, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, G, Sq, Sk, scale,
                                      causal, s);
  return -1;
}

extern "C" const char* flash_attention_error(int code) {
  return code < 0 ? "no instance for this head dim or dtype"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
