// Flash attention forward (online softmax): bfloat16 on the tensor cores
// (wgmma, TMA), float32 on the CUDA cores.
//
// Replaces repro/kernels/attention/flash.py:flash_attention_fwd (the Pallas
// kernel).  The Pallas grid carries m / l / acc in VMEM scratch across a
// sequential k-block axis; CUDA blocks run in no order, so here one CTA owns
// one (batch, query head, query block) and carries that state in registers
// through a loop over key blocks.  The score tile never leaves the SM: no
// (Sq x Sk) matrix is written to device memory.
//
// Semantics kept from the Pallas kernel (both instances):
//   * GQA: query head h reads KV head h / (H / G);
//   * s = (q . k) * scale in float32; masked scores are the finite -1e30;
//   * causal keeps k_idx <= q_idx (the kernel's rule; the oracle's offset
//     rule agrees when Sq == Sk, which is all attention.apply produces);
//   * ragged tails of Q and K are masked in the kernel, nothing is padded;
//   * l sums the float32 p; o = acc / max(l, 1e-30), cast to the input
//     dtype once.
// Key blocks wholly above the diagonal are skipped: for every query row
// the first key is valid, so there corr = 1 and p = 0, the same bits.
//
// Bound on the H100: at prefill lengths (S = 2048, D = 128) the work is
// 4 * S^2 * D / 2 operations per head against 4 * S * D elements of
// traffic, far above the card's ridge point, so the bound is operations at
// the bf16 tensor-core rate (989 TFLOP/s).
//
// bfloat16 (flash_fwd_kernel_bf16_wgmma<D>, D = 64, 80, 112, 128 or 256).
// A CTA of two warpgroups owns 128 query rows (64 each) and walks key
// blocks of 128 (64 at D 256, below):
//   * S = Q K^T and O += P V run as wgmma (m64n64k16, float32 accumulators
//     in registers): Q and K K-major from shared memory; P from registers
//     (the S accumulator's layout is the A operand's, as bf16 pairs); V
//     from shared memory MN-major (transposed B).  Q K^T is two
//     independent n64 accumulator chains (keys 0-63, 64-127), issued
//     interleaved (one chain for a 64-key block); P V is one n64 chain a
//     64-column half of the output;
//   * P enters the second product as two bf16 terms, hi = bf16(p) and lo =
//     bf16(p - hi) (the remainder is exact in float32), so the product
//     sees p to 2^-18 relative, and p is the accurate expf, not the
//     hardware's approximate exp2: chip_smoke.py holds the 8-layer bf16
//     training step to barrier's float32 attention within 2e-5 / 1e-4 /
//     1e-4 in the loss and 1e-3 in the grad norm, and on an H100 P in one
//     bf16 term read 2.9e-5 in the step-1 loss, the approximate exp 1.6e-3
//     in the step-3 grad norm.  Both cost time (a third more tensor-core
//     work, a longer exp);
//   * Q (once) and K / V (a ring of TC_STAGES stages) are loaded by TMA
//     into 128-byte-swizzled shared memory, each tile as NH = ceil(D / 64)
//     64-column halves (the swizzle spans 128 bytes), completing on
//     mbarriers; thread 0 keeps the next block's load in flight while both
//     warpgroups compute on this one, and every thread releases a stage
//     once its products have read it;
//   * a 3-D tensor map per operand ((D, S, batch x heads)) zero-fills rows
//     past Sq and Sk, which the mask then removes; diagonal and tail blocks
//     are masked, the others are not;
//   * head dims: a tile has NH = ceil(D / 64) 64-column halves: one for D
//     = 64, two for D in (64, 128], four for D = 256.  Where D is not a
//     multiple of 64 the tensor map's row is D elements, so TMA fills the
//     last half's columns past D with zeros.  Q K^T then sums exact zeros
//     there, and skips the k16 steps that hold only such columns (one of
//     eight at D = 112, three of eight at D = 80); P V's output columns
//     past D are computed as zeros and written nowhere.  With one half (D
//     = 64) the Q, K and V tiles are one swizzled half each, Q K^T takes
//     its four k16 steps, P V runs one n64 chain, and a stage is half the
//     bytes.  The global row pitch, D * 2 bytes, must be a multiple of 16
//     (TMA's stride rule).  This file builds D = 64 (granite-moe-3b's 1536
//     / 24), 80 (hubert-xlarge's 1280 / 16), 112 (zamba2-7b's 3584 / 32),
//     128 and 256 (paligemma-3b's 2048 / 8);
//   * D = 256 takes 64-key blocks (TC_BK_WIDE): four halves make Q 64 KB
//     and a K + V stage of 128 keys 128 KB, 320 KB in all with two stages,
//     past the SM's 227 KB; with 64 keys a stage is 64 KB and the CTA
//     holds 193 KB.  The registers a thread follow: the output of its
//     warpgroup's 64 rows x 256 columns is four n64 chains, 128 float32
//     registers, beside one S chain (32) and P's hi / lo terms of four k16
//     steps (32), where a 128-key block would add 64 more.  Q K^T is then
//     one chain of 16 k16 steps, P V four chains of 4 steps;
//   * the grid runs the heaviest (last) query blocks of every head first,
//     so the tail of a causal grid is short.
// Forms tried on an H100 and found slower: one n128 chain for Q K^T (with
// Q in shared memory or in registers); the next block's Q K^T issued
// beside this block's P V; the two warpgroups taking turns at the tensor
// cores (named barriers); the query blocks of a head side by side in the
// grid; a producer warp (it caps every thread at 168 registers: the
// register file is split among the SM's four schedulers).
// The one numerical change from the float32 instance: P reaches the second
// product as hi + lo in bf16, so each p_j moves by at most 2^-18 relative
// and |o - o_plain| <= 2^-18 max|v| plus one bf16 rounding of o (2^-9
// max|v| with hi alone).
//
// float32 (flash_fwd_kernel<float, D>, D = 64, 80, 112, 128 or 256): the
// CUDA cores in float32, exact against the plain version's arithmetic: 128
// threads, each a 4 x 8 block of scores and a 4 x D / 8 block of the
// output; Q, K, V and P tiles in padded shared memory (66,560 bytes for D
// = 64, 78,848 for 80, 103,424 for 112, 115,712 for 128, 214,016 for 256;
// at 256 a thread's 4 x 32 outputs are 128 registers).
#include "../../csrc/hopper.cuh"
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

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int TC_BQ = 128;       // query rows a CTA (two warpgroups of 64)
constexpr int TC_BK = 128;       // keys a step, D <= 128
constexpr int TC_BK_WIDE = 64;   // keys a step, D > 128
constexpr int TC_D = 256;        // columns of a tile (the largest head dim)
constexpr int TC_STAGES = 2;     // K / V ring depth
constexpr int TC_THREADS = 256;  // two warpgroups
constexpr int HALF = 64;         // columns of one 128-byte swizzled half
constexpr uint32_t Q_HALF = TC_BQ * HALF * 2;         // 16,384 bytes
constexpr uint32_t BAR_BYTES = 8 * (1 + 2 * TC_STAGES);

// The shared-memory layout of a tile of NH 64-column halves: BK keys a
// block, the 64-key chains of S (NK) and P V's k16 steps (KT) a block.
template <int NH>
struct Layout {
  static constexpr int BK = NH > 2 ? TC_BK_WIDE : TC_BK;
  static constexpr int NK = BK / 64;
  static constexpr int KT = BK / 16;
  static constexpr uint32_t KV_HALF = BK * HALF * 2;  // 16,384 or 8,192
  static constexpr uint32_t Q_BYTES = NH * Q_HALF;
  static constexpr uint32_t KV_BYTES = NH * KV_HALF;  // one K or V tile
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;  // K then V
  // 1 KB of slack aligns the swizzled tiles to 1024 bytes
  static constexpr size_t SMEM =
      1024 + Q_BYTES + TC_STAGES * STAGE_BYTES + BAR_BYTES;
  static_assert(SMEM <= 232448, "over the H100's shared memory a block");
};

using namespace hopper;   // mbarriers, TMA, descriptors, fences

#define TC_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define TC_OUT32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, float32) = A (64 x 16, K-major, shared) * B (16 x 64,
// K-major, shared), + d unless ``first``.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int first) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TC_OUT32(d)
      : "l"(a), "l"(b), "r"(first));
}

// d (64 x 64, float32) += A (64 x 16, bf16 pairs in registers) * B (16 x
// 64, MN-major in shared memory).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TC_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_fwd_kernel_bf16_wgmma(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                __nv_bfloat16* __restrict__ o, int H, int G,
                                int Sq, int Sk, float scale, int causal) {
  constexpr int NH = (D + HALF - 1) / HALF;     // 64-column halves a tile
  using L = Layout<NH>;
  constexpr int BK = L::BK, NK = L::NK, KT = L::KT;
  constexpr uint32_t KV_HALF = L::KV_HALF;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;                     // Q: its NH halves
  const uint32_t ring = qs + L::Q_BYTES;        // stage: K halves, V halves
  const uint32_t bars = ring + TC_STAGES * L::STAGE_BYTES;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + TC_STAGES + s); };

  const int bh = blockIdx.x;                    // b * H + h
  const int qb = gridDim.y - 1 - blockIdx.y;    // heaviest blocks first
  const int b = bh / H, h = bh - b * H;
  const int bg = b * G + h / (H / G);
  const int q0 = qb * TC_BQ;
  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + TC_BQ - 1) / BK + 1);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                      // consumer warpgroup
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), TC_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // Key block j into stage j % STAGES, once every thread has released the
  // block that used that stage before it.
  auto load_kv = [&](int j) {
    const int s = j % TC_STAGES;
    if (j >= TC_STAGES) mbar_wait(empty(s), ((j / TC_STAGES) - 1) & 1);
    const uint32_t dst = ring + s * L::STAGE_BYTES;
    mbar_expect_tx(full(s), L::STAGE_BYTES);
#pragma unroll
    for (int hf = 0; hf < NH; ++hf)
      tma_load(dst + hf * KV_HALF, &kmap, full(s), hf * HALF, j * BK, bg);
#pragma unroll
    for (int hf = 0; hf < NH; ++hf)
      tma_load(dst + L::KV_BYTES + hf * KV_HALF, &vmap, full(s), hf * HALF,
               j * BK, bg);
  };
  if (tid == 0) {
    mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
    for (int hf = 0; hf < NH; ++hf)
      tma_load(qs + hf * Q_HALF, &qmap, q_full, hf * HALF, q0, bh);
    for (int j = 0; j < TC_STAGES - 1 && j < nk; ++j) load_kv(j);
  }

  // This thread's two rows of the warpgroup's 64 (the accumulator layout:
  // element i is row r0 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) +
  // 2 * (lane & 3) + (i & 1) of its 64-column tile).
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const uint32_t qa = qs + wg * 64 * 128;       // the warpgroup's Q rows
  float oc[NH][32];           // output columns 64 hf .. 64 hf + 63
#pragma unroll
  for (int hf = 0; hf < NH; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) oc[hf][i] = 0.f;
  float m[2] = {attn::NEG_INF, attn::NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int kb = 0; kb < nk; ++kb) {
    if (tid == 0 && kb + TC_STAGES - 1 < nk) load_kv(kb + TC_STAGES - 1);
    const int s = kb % TC_STAGES;
    mbar_wait(full(s), (kb / TC_STAGES) & 1);
    const uint32_t kt = ring + s * L::STAGE_BYTES;
    const uint32_t vt = kt + L::KV_BYTES;

    // S = Q K^T: keys 64 c .. 64 c + 63 into sc[c]; k16 steps over the NH
    // 64-column halves of the tile, those past D (all zeros) skipped.
    float sc[NK][32];
#pragma unroll
    for (int c = 0; c < NK; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[c][i] = 0.f;          // overwritten
      hold(sc[c]);
    }
    wg_fence();
#pragma unroll
    for (int half = 0; half < NH; ++half) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (half * HALF + 16 * j >= D) continue;
        const uint64_t a = desc(qa + half * Q_HALF + 32 * j, 16, 1024);
        const uint32_t kh = kt + half * KV_HALF + 32 * j;
#pragma unroll
        for (int c = 0; c < NK; ++c)
          mma_ss(sc[c], a, desc(kh + c * 64 * 128, 16, 1024),
                 half + j == 0);
      }
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < NK; ++c) hold(sc[c]);

    // online softmax on the float32 scores; only diagonal and tail blocks
    // are masked
    const int k0 = kb * BK;
    const bool masked = k0 + BK > Sk ||
                        (causal && k0 + BK - 1 > q0 + wg * 64);
    float mx[2] = {attn::NEG_INF, attn::NEG_INF};
#pragma unroll
    for (int i = 0; i < 32 * NK; ++i) {
      float& x = sc[i >> 5][i & 31];
      const int row = r0 + 8 * ((i >> 1) & 1);
      const int key = k0 + 8 * (i >> 2) + c0 + (i & 1);
      float v = x * scale;
      if (masked && !(key < Sk && (!causal || key <= row))) v = attn::NEG_INF;
      x = v;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's column pairs sit in the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // P in the A operand's layout: k16 step t holds keys 16t..16t+15, the
    // accumulator's column tiles 2t and 2t + 1
    // (p = hi + lo, both bf16: hi is p rounded, lo its rounded remainder)
    uint32_t p_hi[KT][4], p_lo[KT][4];
#pragma unroll
    for (int t = 0; t < KT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * t + 2 * e;            // element of the BK columns
        const int r = e & 1;
        const float& x0 = sc[i >> 5][i & 31];
        const float& x1 = sc[(i + 1) >> 5][(i + 1) & 31];
        const float p0 = expf(x0 - m[r]);
        const float p1 = expf(x1 - m[r]);
        l[r] += p0 + p1;                        // the float32 p
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[t][e] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[t][e] = pack_bf16(p0 - hf.x, p1 - hf.y);   // exact remainders
      }
    }
#pragma unroll
    for (int hf = 0; hf < NH; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i) oc[hf][i] *= corr[(i >> 1) & 1];

    // O += P V: KT k16 steps over the block's keys, V MN-major; a chain a
    // 64-column half of the output
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) hold(oc[hf]);
    wg_fence();
#pragma unroll
    for (int t = 0; t < KT; ++t) {
#pragma unroll
      for (int hf = 0; hf < NH; ++hf)
        mma_rs(oc[hf], p_hi[t],
               desc(vt + t * 16 * 128 + hf * KV_HALF, KV_HALF, 1024));
#pragma unroll
      for (int hf = 0; hf < NH; ++hf)
        mma_rs(oc[hf], p_lo[t],
               desc(vt + t * 16 * 128 + hf * KV_HALF, KV_HALF, 1024));
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) hold(oc[hf]);
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* op = o + (int64_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const int col = 8 * (i >> 2) + c0;
    __nv_bfloat16* at = op + (int64_t)row * D + col;
#pragma unroll
    for (int hf = 0; hf < NH; ++hf)
      if (hf * HALF + col < D)   // D is even: the pair is in or past D
        *reinterpret_cast<__nv_bfloat162*>(at + hf * HALF) =
            __floats2bfloat162_rn(oc[hf][i] / l[r], oc[hf][i + 1] / l[r]);
  }
}

// A (D, S, planes) view of a contiguous (planes, S, D) bf16 tensor, boxes
// of 64 columns x ``rows`` rows, 128-byte swizzle, zero fill past D and S.
int tensor_map(CUtensorMap* map, const void* ptr, int d, int s, int planes,
               int rows) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || (d * 2) % 16) return 1;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                        static_cast<cuuint64_t>(s),
                        static_cast<cuuint64_t>(planes)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                           static_cast<cuuint64_t>(s) * d * 2};
  cuuint32_t box[3] = {HALF, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t step[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS;
}

constexpr int TMA_ERROR = -2;

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int G, int Sq, int Sk, float scale, int causal,
           cudaStream_t stream) {
  constexpr int NH = (D + HALF - 1) / HALF;
  static_assert(D % 8 == 0 && D <= TC_D && (NH > 1 || D == HALF),
                "a row pitch of 16-byte multiples; one whole half, or the "
                "last half starting inside the row");
  if (Sq == 0 || B * H == 0) return 0;
  if (Sk == 0)                  // no key: acc = 0, l = 0, o = 0
    return (int)cudaMemsetAsync(o, 0, (size_t)B * H * Sq * D * 2, stream);
  CUtensorMap qm, km, vm;
  if (tensor_map(&qm, q, D, Sq, B * H, TC_BQ) ||
      tensor_map(&km, k, D, Sk, B * G, Layout<NH>::BK) ||
      tensor_map(&vm, v, D, Sk, B * G, Layout<NH>::BK))
    return TMA_ERROR;
  constexpr size_t SMEM = Layout<NH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_bf16_wgmma<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + TC_BQ - 1) / TC_BQ);
  flash_fwd_kernel_bf16_wgmma<D><<<grid, TC_THREADS, SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), H, G, Sq, Sk, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores).  D must be
// 64, 80, 112, 128 or 256 (flash.py:HEAD_DIMS).  Returns a cudaError_t, -1
// for a head dim or dtype this build has no instance of, -2 for a tensor
// map cuTensorMapEncodeTiled refuses.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int G, int Sq, int Sk, int D, float scale,
                                   int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_HEAD_DIM(d)                                                    \
  if (D == d)                                                                \
    return dtype == 0                                                        \
               ? launch<float, d>(q, k, v, o, B, H, G, Sq, Sk, scale,       \
                                  causal, s)                                 \
               : tc::launch<d>(q, k, v, o, B, H, G, Sq, Sk, scale, causal, s);
  if (dtype != 0 && dtype != 1) return -1;
  FLASH_HEAD_DIM(128)
  FLASH_HEAD_DIM(112)
  FLASH_HEAD_DIM(64)
  FLASH_HEAD_DIM(80)
  FLASH_HEAD_DIM(256)
#undef FLASH_HEAD_DIM
  return -1;
}

extern "C" const char* flash_attention_error(int code) {
  if (code == tc::TMA_ERROR)
    return "cuTensorMapEncodeTiled refused a tensor map (a base address not "
           "16-byte aligned?)";
  return code < 0 ? "no instance for this head dim or dtype"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
