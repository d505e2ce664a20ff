// SSD intra-chunk block (Mamba2): per (batch, head, chunk) cell, float32
// in, float32 arithmetic, float32 out:
//
//   G = C B^T                                   (L, L)
//   M = G * exp(a_i - a_j)   for j <= i, else 0  decay-masked scores
//   Y = M dtx                                   (L, P)
//   S = (B * exp(a_{L-1} - a))^T dtx            (N, P) chunk state
//
// Replaces repro/kernels/ssd/ssd.py:ssd_intra_chunk (the Pallas kernel).
// Its grid cells are independent (no carried scratch, no grid sum), so one
// CTA per cell; the cells are ordered head-fastest, so the CTAs of one
// (batch, chunk) run together and the B/C chunk they all read is served by
// L2.  Per CTA, C and B (L x N, rows padded by one float against bank
// conflicts), dtx (L x P), a and the state decays (L each) and the L x L
// score tile are staged in shared memory: 99.6 KB at (L, N, P) =
// (64, 128, 64), so the launch opts in to dynamic shared memory above 48 KB.
// 256 threads as 16 x 16; each product is register-tiled (4 x 4 outputs a
// thread for G and Y, 8 x 4 for S), summed in a fixed order, so two runs
// give the same bits.
//
// The mask is a select, never a multiply: exp(a_i - a_j) is computed only
// for j <= i, where a_i - a_j <= 0 (a is the cumulative sum of dt * A <= 0).
// Above the diagonal it would overflow to inf at realistic decays, and
// 0 * inf is NaN.  The state decay exp(a_{L-1} - a_j) is always <= 1.
//
// Bound on the H100: the causal function needs G and Y over the lower
// triangle only (the rest of the tile is exactly 0), L (L + 1) / 2 (N + P)
// + N L P FMAs a cell (0.92 M at (64, 64, 128)), at the float32 rate
// outside the tensor cores (67 TFLOP/s), against dtx, a, B, C read once and
// Y, S written once at 3.35 TB/s: at mamba2-2.7b's prefill (1, 2048) 4.7
// GFLOP (0.071 ms) against 170 MB (0.051 ms), so operations.  This first kernel runs float32 FMAs on the CUDA cores, as the
// JAX kernel is float32 throughout; TF32 or wgmma tiles and TMA are later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int MAX_L = 64;      // the score tile is one 64 x 64 block
constexpr int TP = 64;         // P columns a pass: 16 threads x 4
constexpr int TN = 128;        // N rows a pass of the state product: 16 x 8
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ inline int smem_floats(int L, int N, int P) {
  return 2 * L * (N + 1) + L * P + L * (L + 1) + 2 * L;
}

__global__ void __launch_bounds__(THREADS)
    ssd_intra_chunk_kernel(const float* __restrict__ dtx,
                           const float* __restrict__ a,
                           const float* __restrict__ Bm,
                           const float* __restrict__ Cm,
                           float* __restrict__ y, float* __restrict__ S,
                           int H, int NC, int L, int N, int P) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  const int ldm = L + 1;
  float* cs = smem;               // L x ldn: C
  float* bs = cs + L * ldn;       // L x ldn: B
  float* xs = bs + L * ldn;       // L x P: dtx
  float* ms = xs + L * P;         // L x ldm: decay-masked scores
  float* as = ms + L * ldm;       // L: a
  float* ds = as + L;             // L: exp(a_{L-1} - a)

  const int h = blockIdx.x % H;
  const int bc = blockIdx.x / H;  // batch * NC + chunk
  const int c = bc % NC, b = bc / NC;
  const int64_t cell = ((int64_t)b * H + h) * NC + c;
  const float* dtx_c = dtx + cell * L * P;
  const float* a_c = a + cell * L;
  const float* b_c = Bm + (int64_t)bc * L * N;
  const float* c_c = Cm + (int64_t)bc * L * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int k = tid; k < L * N; k += THREADS) {
    const int l = k / N, n = k % N;
    cs[l * ldn + n] = c_c[k];
    bs[l * ldn + n] = b_c[k];
  }
  for (int k = tid; k < L * P; k += THREADS) xs[k] = dtx_c[k];
  for (int k = tid; k < L; k += THREADS) as[k] = a_c[k];
  __syncthreads();
  for (int k = tid; k < L; k += THREADS) ds[k] = expf(as[L - 1] - as[k]);

  // M: rows ty + 16 r, columns tx + 16 s
  {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        cv[r] = i < L ? cs[i * ldn + n] : 0.f;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int j = tx + 16 * s;
        bv[s] = j < L ? bs[j * ldn + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(cv[r], bv[s], acc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int j = tx + 16 * s;
        if (i < L && j < L)
          ms[i * ldm + j] = j <= i ? acc[r][s] * expf(as[i] - as[j]) : 0.f;
      }
    }
  }
  __syncthreads();

  // Y = M dtx: rows ty + 16 r, columns p0 + tx + 16 s
  float* y_c = y + cell * L * P;
  for (int p0 = 0; p0 < P; p0 += TP) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;
    for (int j = 0; j < L; ++j) {
      float mv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        mv[r] = i < L ? ms[i * ldm + j] : 0.f;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int p = p0 + tx + 16 * s;
        xv[s] = p < P ? xs[j * P + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(mv[r], xv[s], acc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int p = p0 + tx + 16 * s;
        if (i < L && p < P) y_c[i * P + p] = acc[r][s];
      }
    }
  }

  // S = (B * decay)^T dtx: rows n0 + ty + 16 r, columns p0 + tx + 16 s
  float* s_c = S + cell * N * P;
  for (int n0 = 0; n0 < N; n0 += TN) {
    for (int p0 = 0; p0 < P; p0 += TP) {
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;
      for (int l = 0; l < L; ++l) {
        const float d = ds[l];
        float bv[8], xv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int n = n0 + ty + 16 * r;
          bv[r] = n < N ? bs[l * ldn + n] * d : 0.f;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int p = p0 + tx + 16 * s;
          xv[s] = p < P ? xs[l * P + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            acc[r][s] = fmaf(bv[r], xv[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int n = n0 + ty + 16 * r;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int p = p0 + tx + 16 * s;
          if (n < N && p < P) s_c[n * P + p] = acc[r][s];
        }
      }
    }
  }
}

}  // namespace

// dtx (batch, H, NC, L, P), a (batch, H, NC, L), B and C (batch, NC, L, N),
// y (batch, H, NC, L, P), S (batch, H, NC, N, P), all float32 and
// contiguous.  Returns a cudaError_t, -2 for L outside [1, 64] or N, P
// below 1, -3 for a stage that needs more shared memory than a CTA has.
extern "C" int ssd_intra_chunk(const float* dtx, const float* a,
                               const float* B, const float* C, float* y,
                               float* S, int batch, int H, int NC, int L,
                               int N, int P, void* stream) {
  if (L < 1 || L > MAX_L || N < 1 || P < 1) return -2;
  const int64_t bytes = (int64_t)smem_floats(L, N, P) * sizeof(float);
  if (bytes > SMEM_LIMIT) return -3;
  const int64_t cells = (int64_t)batch * H * NC;
  if (cells == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_intra_chunk_kernel<<<(unsigned)cells, THREADS, (size_t)bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      dtx, a, B, C, y, S, H, NC, L, N, P);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_error(int code) {
  if (code == -2) return "chunk length outside [1, 64], or N or P below 1";
  if (code == -3) return "the stage needs more shared memory than a CTA has";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
