// Fused vocab cross-entropy forward: (logsumexp, gold logit) per row of
// h @ w, float32 or bfloat16 in, float32 arithmetic; the (T, V) logits are
// never written to device memory.
//
// Replaces repro/kernels/vocab_ce/ce.py:fused_ce_fwd (the Pallas kernel).
// The Pallas grid (row tiles, V chunks, D chunks) runs in order: it carries
// the running max m, sum l and gold g across the V axis and a logits tile
// across the D axis, in VMEM scratch.  CUDA blocks run in no order, so:
//
//   * ce_split_kernel: one CTA owns a tile of BM rows and one split of the
//     vocab (a contiguous run of BN-column tiles).  For each of its column
//     tiles it loops over D in BK chunks with the h and w chunks staged in
//     shared memory and the BM x BN logits tile accumulated in float32
//     registers (8 x 8 a thread), then makes the online (m, l, g) update
//     over the tile's columns.  It writes one (m, l, g) partial per
//     (split, row).
//   * ce_merge_kernel: one thread a row merges the splits in split order
//     (M = max m_s, L = sum l_s exp(m_s - M), G = sum g_s), so two runs give
//     the same bits; no float atomics.
//
// Semantics kept from the Pallas kernel: products and sums in float32 (a
// bf16 x bf16 product is exact in float32); columns >= V are the finite
// -1e30; gold sums the logit at col == label, so a label below 0 gives 0;
// lse = m + log(max(l, 1e-30)).  Ragged T, D and V are masked here,
// nothing is padded.  Labels in [V, V_padded), an artefact of the TPU
// kernel's padding, are outside the contract.
//
// Bound on the H100: 2 T D V operations against (T D + D V) elements read,
// far above the ridge point, so operations, at the bf16 tensor-core rate:
// 3.47 ms at (4096, 4096, 102400).  This first kernel runs them as float32
// FMAs on the CUDA cores (no mma.sync, no wgmma): far from that bound;
// tensor-core tiles are later work.  A split count that gives several CTAs
// an SM comes from the wrapper (ce.py:split_plan).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 128;       // rows a CTA
constexpr int BN = 128;       // vocab columns a tile
constexpr int BK = 16;        // D a step
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int TM = 8;         // rows a thread: two runs of 4, 64 apart
constexpr int TN = 8;         // columns a thread: two runs of 4, 64 apart
constexpr int LDS = BM + 4;   // padded shared row (float4-aligned)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Row of a thread's i-th logit row / column of its j-th column in the tile.
__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i / 4) * 64 + ty * 4 + (i % 4);
}
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j / 4) * 64 + tx * 4 + (j % 4);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ce_split_kernel(const T* __restrict__ h, const T* __restrict__ w,
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
                         ? to_f(h[(int64_t)row * D + k]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < BK * BN / THREADS; ++q) {
        const int e = tid + q * THREADS;
        const int kk = e / BN, cc = e % BN;
        const int k = k0 + kk, col = c0 + cc;
        ws[kk][cc] = (k < D && col < V)
                         ? to_f(w[(int64_t)k * V + col]) : 0.f;
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

template <typename T>
int launch(const void* h, const void* w, const int* labels, float* part_m,
           float* part_l, float* part_g, float* lse, float* gold, int n_rows,
           int D, int V, int n_split, cudaStream_t stream) {
  const int n_vtiles = (V + BN - 1) / BN;
  if (n_split < 1 || n_split > n_vtiles) return -2;
  const dim3 grid(n_split, (n_rows + BM - 1) / BM);
  ce_split_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, part_m,
      part_l, part_g, n_rows, D, V, n_vtiles, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_merge_kernel<<<(n_rows + 255) / 256, 256, 0, stream>>>(
      part_m, part_l, part_g, lse, gold, n_rows, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (h and w alike).  part_* hold n_split x
// n_rows floats each.  Returns a cudaError_t, -1 for a dtype this build has
// no instance of, -2 for a split count outside [1, ceil(V / 128)].
extern "C" int fused_ce_fwd(const void* h, const void* w, const int* labels,
                            float* part_m, float* part_l, float* part_g,
                            float* lse, float* gold, int n_rows, int D, int V,
                            int n_split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(h, w, labels, part_m, part_l, part_g, lse, gold,
                         n_rows, D, V, n_split, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, w, labels, part_m, part_l, part_g, lse,
                                 gold, n_rows, D, V, n_split, s);
  return -1;
}

extern "C" const char* fused_ce_error(int code) {
  if (code == -1) return "no instance for this dtype";
  if (code == -2) return "split count outside [1, ceil(V / 128)]";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
