// Fused vocab cross-entropy forward: (logsumexp, gold logit) per row of
// h @ w, float32 arithmetic; the (T, V) logits are never written to device
// memory.  bfloat16 runs on the tensor cores (wgmma, TMA), float32 on the
// CUDA cores.
//
// Replaces repro/kernels/vocab_ce/ce.py:fused_ce_fwd (the Pallas kernel).
// The Pallas grid (row tiles, V chunks, D chunks) runs in order: it carries
// the running max m, sum l and gold g across the V axis and a logits tile
// across the D axis, in VMEM scratch.  CUDA blocks run in no order, so in
// both instances one CTA owns a tile of rows and one split of the vocab (a
// contiguous run of column tiles), carries (m, l, g) of its rows in
// registers across the split's tiles and writes one (m, l, g) partial per
// (split, row); ce_merge_kernel then merges the splits in split order (M =
// max m_s, L = sum l_s exp(m_s - M), G = sum g_s), one thread a row, so two
// runs give the same bits; no float atomics.
//
// Semantics kept from the Pallas kernel (both instances): products and sums
// in float32 (a bf16 x bf16 product is exact in float32); columns >= V are
// the finite -1e30; gold sums the logit at col == label, so a label below 0
// gives 0; lse = m + log(max(l, 1e-30)).  Ragged T, D and V are masked or
// zero-filled here; labels in [V, V_padded), an artefact of the TPU
// kernel's padding, are outside the contract.
//
// Bound on the H100: 2 T D V operations against (T D + D V) elements read,
// far above the card's ridge point, so operations, at the bf16 tensor-core
// rate: 3.47 ms at (4096, 4096, 102400).
//
// bfloat16 (ce_tc_kernel, TC_BN = 256 columns a tile).  A CTA of two
// warpgroups owns 128 rows (64 each) and walks its split's column tiles, D
// in 64-deep chunks:
//   * the logits tile is one wgmma chain a warpgroup (m64n256k16, bf16 in,
//     float32 accumulators in registers, 128 a thread): h as K-major A
//     tiles (128 rows x 64 depths), w as MN-major B tiles (64 depths x 256
//     columns, four 64-column blocks LBO = 8 KB apart, since w is (D, V)
//     row-major and V is its contiguous dimension), both 128-byte-swizzled;
//   * the chunks come through a ring of TC_STAGES stages loaded by TMA and
//     completing on mbarriers; thread 0 keeps the loads TC_STAGES - 1
//     chunks ahead (no producer warp: one caps every thread's registers, as
//     flash_attention.cu found); one chunk's products stay in flight while
//     the next is issued (wgmma.wait_group 1), and every thread releases a
//     stage once the products that read it are done;
//   * after a tile's last chunk the online update runs on the accumulators
//     in registers: mask, gold, the row max across the quad that holds a
//     row (shuffles), then (m, l, g), which stay in registers across the
//     split's tiles;
//   * tensor maps zero-fill rows past T, depths past D and columns past V;
//     a global stride must be a multiple of 16 bytes, so the wrapper stages
//     an operand whose rows are not (D or V not a multiple of 8) into a
//     buffer of padded pitch (ce.py:staged);
//   * blockIdx.x is the row tile, so the row tiles that read one split's
//     columns of w launch together: w (839 MB at the training shape, more
//     than the 50 MB L2) streams from device memory about once, h (32 MB)
//     stays in L2.
// The numerical change from the float32 instance: none in the products
// (exact); the float32 sums of a tile run in the tensor cores' order.
//
// float32 (ce_split_kernel): the CUDA cores, exact against the plain
// version's products: 256 threads, each an 8 x 8 float32 tile of logits
// accumulated 16 depths at a time from shared memory (BM x BN = 128 x 128);
// the split count comes from ce.py:split_plan.
#include "../../csrc/hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 128;       // rows a CTA
constexpr int BN = 128;       // vocab columns a tile
constexpr int BK = 16;        // D a step
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int TM = 8;         // rows a thread: two runs of 4, 64 apart
constexpr int TN = 8;         // columns a thread: two runs of 4, 64 apart
constexpr int LDS = BM + 4;   // padded shared row (float4-aligned)

// Row of a thread's i-th logit row / column of its j-th column in the tile.
__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i / 4) * 64 + ty * 4 + (i % 4);
}
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j / 4) * 64 + tx * 4 + (j % 4);
}

__global__ void __launch_bounds__(THREADS)
    ce_split_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const int* __restrict__ labels,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_g, int n_rows, int D, int V,
                    int n_vtiles, int n_split) {
  __shared__ __align__(16) float hs[BK][LDS];   // h chunk, transposed
  __shared__ __align__(16) float ws[BK][LDS];   // w chunk
  const int split = blockIdx.x;
  const int r0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int t_begin = (int)((int64_t)split * n_vtiles / n_split);
  const int t_end = (int)((int64_t)(split + 1) * n_vtiles / n_split);

  int lab[TM];
  float m[TM], l[TM], g[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + tile_row(ty, i);
    lab[i] = row < n_rows ? labels[row] : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
    g[i] = 0.f;
  }

  for (int vt = t_begin; vt < t_end; ++vt) {
    const int c0 = vt * BN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
      for (int q = 0; q < BM * BK / THREADS; ++q) {
        const int e = tid + q * THREADS;
        const int rr = e / BK, kk = e % BK;
        const int row = r0 + rr, k = k0 + kk;
        hs[kk][rr] = (row < n_rows && k < D)
                         ? h[(int64_t)row * D + k] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < BK * BN / THREADS; ++q) {
        const int e = tid + q * THREADS;
        const int kk = e / BN, cc = e % BN;
        const int k = k0 + kk, col = c0 + cc;
        ws[kk][cc] = (k < D && col < V)
                         ? w[(int64_t)k * V + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
        const float4 a0 = *reinterpret_cast<const float4*>(&hs[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&hs[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // The online update over this tile's columns.  The 16 threads of a row
    // group are one half-warp: xor shuffles of 8, 4, 2, 1 stay inside it
    // and leave every lane with the row's result.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tmax = NEG_INF, gsum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = c0 + tile_col(tx, j);
        const float x = col < V ? acc[i][j] : NEG_INF;
        acc[i][j] = x;
        tmax = fmaxf(tmax, x);
        if (col == lab[i]) gsum += x;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
      }
      const float m_new = fmaxf(m[i], tmax);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) s += expf(acc[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      l[i] = l[i] * expf(m[i] - m_new) + s;
      m[i] = m_new;
      g[i] += gsum;
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = r0 + tile_row(ty, i);
      if (row >= n_rows) continue;
      const int64_t idx = (int64_t)split * n_rows + row;
      part_m[idx] = m[i];
      part_l[idx] = l[i];
      part_g[idx] = g[i];
    }
  }
}

__global__ void ce_merge_kernel(const float* __restrict__ part_m,
                                const float* __restrict__ part_l,
                                const float* __restrict__ part_g,
                                float* __restrict__ lse,
                                float* __restrict__ gold, int n_rows,
                                int n_split) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  float mx = NEG_INF;
  for (int s = 0; s < n_split; ++s)
    mx = fmaxf(mx, part_m[(int64_t)s * n_rows + row]);
  float sum = 0.f, gs = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const int64_t idx = (int64_t)s * n_rows + row;
    sum += part_l[idx] * expf(part_m[idx] - mx);
    gs += part_g[idx];
  }
  lse[row] = mx + logf(fmaxf(sum, 1e-30f));
  gold[row] = gs;
}


int launch_f32(const float* h, const float* w, const int* labels,
               float* part_m, float* part_l, float* part_g, float* lse,
               float* gold, int n_rows, int D, int V, int n_split,
               cudaStream_t stream) {
  const int n_vtiles = (V + BN - 1) / BN;
  if (n_split < 1 || n_split > n_vtiles) return -2;
  const dim3 grid(n_split, (n_rows + BM - 1) / BM);
  ce_split_kernel<<<grid, THREADS, 0, stream>>>(
      h, w, labels, part_m, part_l, part_g, n_rows, D, V, n_vtiles, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_merge_kernel<<<(n_rows + 255) / 256, 256, 0, stream>>>(
      part_m, part_l, part_g, lse, gold, n_rows, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int TC_BM = 128;       // rows a CTA (two warpgroups of 64)
constexpr int TC_BN = 256;       // columns a tile (ce.py's TC_BLOCK_V)
constexpr int TC_STAGES = 4;     // depth of the TMA ring
constexpr int TC_BK = 64;        // depths a chunk: one 128-byte swizzle span
constexpr int TC_THREADS = 256;  // two warpgroups
constexpr int BLOCK_N = 64;      // columns of one 128-byte swizzled block
constexpr uint32_t A_BYTES = TC_BM * TC_BK * 2;       // 16,384
constexpr uint32_t B_BLOCK = TC_BK * BLOCK_N * 2;     // 8,192
constexpr int TMA_ERROR = -3;

constexpr uint32_t STAGE_BYTES = A_BYTES + (TC_BN / BLOCK_N) * B_BLOCK;
// 1 KB of slack aligns the swizzled tiles to 1024 bytes
constexpr size_t TC_SMEM = 1024 + TC_STAGES * STAGE_BYTES + 16 * TC_STAGES;
static_assert(TC_SMEM <= 232448, "over the H100's shared memory a block");

#define CE_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
    "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
    "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
    "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
    "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
    "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
    "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
    "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
    "%122, %123, %124, %125, %126, %127}"
#define CE_OUT128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), \
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), \
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), \
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), \
      "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), \
      "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), \
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), \
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
      "+f"(d[126]), "+f"(d[127])

// d (64 x 256, float32) = A (64 x 16, K-major, shared) * B (16 x 256,
// MN-major, shared), + d unless ``first``.
__device__ __forceinline__ void mma_n256(float (&d)[128], uint64_t a,
                                         uint64_t b, int first) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " CE_D128
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : CE_OUT128(d)
      : "l"(a), "l"(b), "r"(first));
}

__global__ void __launch_bounds__(TC_THREADS, 1)
    ce_tc_kernel(const __grid_constant__ CUtensorMap hmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const int* __restrict__ labels, float* __restrict__ part_m,
                 float* __restrict__ part_l, float* __restrict__ part_g,
                 int n_rows, int D, int V, int n_vtiles, int n_split) {
  constexpr int BN = TC_BN, STAGES = TC_STAGES;
  constexpr int NACC = BN / 2;                  // accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int r0 = blockIdx.x * TC_BM;            // the row tile
  const int split = blockIdx.y;
  const int t_begin = (int)((int64_t)split * n_vtiles / n_split);
  const int t_end = (int)((int64_t)(split + 1) * n_vtiles / n_split);
  const int n_k = (D + TC_BK - 1) / TC_BK;
  const int n_iter = (t_end - t_begin) * n_k;   // (column tile, chunk) pairs

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), TC_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // Chunk j of the walk (column tile t_begin + j / n_k, depths (j % n_k) *
  // 64 on) into stage j % STAGES, once every thread has released the chunk
  // that used that stage before it.
  auto load = [&](int j) {
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(empty(s), ((j / STAGES) - 1) & 1);
    const uint32_t dst = base + s * STAGE_BYTES;
    const int c0 = (t_begin + j / n_k) * BN;
    const int k0 = (j % n_k) * TC_BK;
    mbar_expect_tx(full(s), STAGE_BYTES);
    tma_load_2d(dst, &hmap, full(s), k0, r0);
#pragma unroll
    for (int b = 0; b < BN / BLOCK_N; ++b)
      tma_load_2d(dst + A_BYTES + b * B_BLOCK, &wmap, full(s),
                  c0 + b * BLOCK_N, k0);
  };
  if (tid == 0)
    for (int j = 0; j < STAGES - 1 && j < n_iter; ++j) load(j);

  // This thread's two rows (the accumulator layout: element i is row
  // row[(i >> 1) & 1], column 8 * (i >> 2) + 2 * (lane & 3) + (i & 1) of
  // the tile).
  int row[2], lab[2];
  row[0] = r0 + wg * 64 + warp * 16 + (lane >> 2);
  row[1] = row[0] + 8;
  float m[2], l[2], g[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lab[r] = row[r] < n_rows ? labels[row[r]] : -1;
    m[r] = NEG_INF;
    l[r] = 0.f;
    g[r] = 0.f;
  }
  const int cq = 2 * (lane & 3);

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;   // overwritten
  bool prev_released = true;
  for (int j = 0; j < n_iter; ++j) {
    const int s = j % STAGES;
    const int kc = j % n_k;
    mbar_wait(full(s), (j / STAGES) & 1);
    const uint32_t at = base + s * STAGE_BYTES;
    hold(acc);
    wg_fence();
#pragma unroll
    for (int t = 0; t < TC_BK / 16; ++t)
      mma_n256(acc, desc(at + wg * 64 * 128 + 32 * t, 16, 1024),
                   desc(at + A_BYTES + t * 16 * 128, B_BLOCK, 1024),
                   kc == 0 && t == 0);
    wg_commit();
    const bool last = kc == n_k - 1;
    if (last)
      wg_wait<0>();
    else
      wg_wait<1>();                             // chunk j - 1's products
    hold(acc);
    if (!prev_released) mbar_arrive(empty((j + STAGES - 1) % STAGES));
    prev_released = last;
    if (last) {
      mbar_arrive(empty(s));
      // the online update over this column tile
      const int c0 = (t_begin + j / n_k) * BN;
      const bool edge = c0 + BN > V;
      float mx[2] = {NEG_INF, NEG_INF}, gs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int r = (i >> 1) & 1;
        const int col = c0 + 8 * (i >> 2) + cq + (i & 1);
        const float x = edge && col >= V ? NEG_INF : acc[i];
        acc[i] = x;
        mx[r] = fmaxf(mx[r], x);
        if (col == lab[r]) gs[r] += x;
      }
      float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // a row's columns sit in the 4 lanes of a quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        gs[r] += __shfl_xor_sync(0xffffffffu, gs[r], 1);
        gs[r] += __shfl_xor_sync(0xffffffffu, gs[r], 2);
        m_new[r] = fmaxf(m[r], mx[r]);
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int r = (i >> 1) & 1;
        sum[r] += expf(acc[i] - m_new[r]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * expf(m[r] - m_new[r]) + sum[r];
        m[r] = m_new[r];
        g[r] += gs[r];
      }
    }
    if (tid == 0 && j + STAGES - 1 < n_iter) load(j + STAGES - 1);
  }

  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= n_rows) continue;
      const int64_t idx = (int64_t)split * n_rows + row[r];
      part_m[idx] = m[r];
      part_l[idx] = l[r];
      part_g[idx] = g[r];
    }
  }
}

// A 2-D tensor map of a row-major (rows, cols) bf16 matrix whose rows are
// ``pitch`` elements apart, boxes of 64 columns x ``box_rows`` rows,
// 128-byte swizzle, zero fill past ``rows`` and ``cols``.
int tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
               int pitch, int box_rows) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || pitch % 8) return 1;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * 2};
  cuuint32_t box[2] = {BLOCK_N, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t step[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS;
}

int launch(const void* h, const void* w, const int* labels, float* part_m,
           float* part_l, float* part_g, float* lse, float* gold, int n_rows,
           int D, int V, int ldh, int ldw, int n_split, cudaStream_t stream) {
  const int n_vtiles = (V + TC_BN - 1) / TC_BN;
  if (n_split < 1 || n_split > n_vtiles) return -2;
  CUtensorMap hm, wm;
  if (tensor_map(&hm, h, n_rows, D, ldh, TC_BM) ||
      tensor_map(&wm, w, D, V, ldw, TC_BK))
    return TMA_ERROR;
  cudaError_t err = cudaFuncSetAttribute(
      ce_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + TC_BM - 1) / TC_BM, n_split);
  ce_tc_kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(hm, wm, labels, part_m, part_l,
                                             part_g, n_rows, D, V, n_vtiles,
                                             n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_merge_kernel<<<(n_rows + 255) / 256, 256, 0, stream>>>(
      part_m, part_l, part_g, lse, gold, n_rows, n_split);
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores).  part_* hold
// n_split x n_rows floats each.  ldh and ldw are the row pitches of h and w
// in elements (D and V, or a staged buffer's padded pitch; bf16 only, a
// multiple of 8).  Returns a cudaError_t, -1 for a dtype this build has no
// instance of, -2 for a split count outside [1, column tiles], -3 for a
// tensor map the driver refuses.
extern "C" int fused_ce_fwd(const void* h, const void* w, const int* labels,
                            float* part_m, float* part_l, float* part_g,
                            float* lse, float* gold, int n_rows, int D, int V,
                            int ldh, int ldw, int n_split, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(h),
                      static_cast<const float*>(w), labels, part_m, part_l,
                      part_g, lse, gold, n_rows, D, V, n_split, s);
  if (dtype == 1)
    return tc::launch(h, w, labels, part_m, part_l, part_g, lse, gold,
                      n_rows, D, V, ldh, ldw, n_split, s);
  return -1;
}

extern "C" const char* fused_ce_error(int code) {
  if (code == -1) return "no instance for this dtype";
  if (code == -2) return "split count outside [1, column tiles]";
  if (code == tc::TMA_ERROR)
    return "cuTensorMapEncodeTiled refused a tensor map (a base address not "
           "16-byte aligned, or a pitch not a multiple of 8?)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
