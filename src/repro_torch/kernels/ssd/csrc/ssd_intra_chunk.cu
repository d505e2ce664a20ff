// SSD intra-chunk block (Mamba2): per (batch, head, chunk) cell, float32
// in, float32 arithmetic, float32 out:
//
//   G = C B^T                                   (L, L)
//   M = G * exp(a_i - a_j)   for j <= i, else 0  decay-masked scores
//   Y = M dtx                                   (L, P)
//   S = (B * exp(a_{L-1} - a))^T dtx            (N, P) chunk state
//
// Replaces repro/kernels/ssd/ssd.py:ssd_intra_chunk (the Pallas kernel).
//
// Bound on the H100: dtx, a, B, C read once and Y, S written once at 3.35
// TB/s: 170.5 MB at mamba2-2.7b's prefill (1, 80, 32, 64, 64), N 128, 0.051
// ms.  The FMAs the causal function needs, with G once per (batch, chunk)
// (it does not depend on the head): L (L + 1) / 2 N a chunk and L (L + 1) /
// 2 P + N L P a cell, 3.4 GFLOP at that shape, 0.051 ms at the 67 TFLOP/s
// float32 rate of the CUDA cores.  Counting G per cell, as the kernel this
// one replaced computed it, 4.7 GFLOP and 0.071 ms.
//
// Every output is the plain version's (chunked.ssd_intra_chunk_ref) sum in
// the plain version's order: one float32 FMA after another along k, from
// 0 (G over n, Y over j, S over l), M rounded as G * exp(a_i - a_j) and the
// state's operand as B * exp(a_{L-1} - a) before the products.  So the
// kernel agrees with its plain version bit for bit, and a model run through
// it rounds exactly as through the plain path: on mamba2-2.7b's 64 random
// bf16 layers, a TF32 tensor-core version of this kernel, within 5e-7 of
// max of the plain version, moved the prefill logits 8.3e-2 of max from the
// plain path's, where chip_smoke.py phase 21a's limit is 5e-2 (an H100 80GB
// HBM3 at 700 W; PERF.md, section 6).
//
// Design:
// - One CTA per (batch, chunk, group of heads); ssd.launch_plan sets the
//   heads a group from the shape and the card.  The CTA stages the chunk's
//   C and B once, computes G once over the causal lower triangle, then
//   walks its heads; while one head computes, the next head's dtx and a
//   arrive by cp.async in the other of two buffers (C's shared memory, dead
//   once G is done, holds them).
// - Register tiles: S as 8 x 4 outputs a thread (two 16-byte loads of B's
//   row, one of dtx's, 32 FMAs a step), Y as 4 x 4 over M stored transposed
//   (two 16-byte loads, 16 FMAs a step); Y's k loop stops at its rows'
//   diagonal (the terms past it are exactly 0, adding nothing).
// - No atomics: two launches give the same bits.
// The mask is a select, never a multiply: exp(a_i - a_j) is computed only
// for j <= i, where a_i - a_j <= 0; above the diagonal it would overflow to
// inf at realistic decays, and 0 * inf is NaN.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_L = 64;      // the score tile is at most 64 x 64
constexpr int SMEM_LIMIT = 232448;

// Padded extents and pitches (floats) of one CTA's shared-memory tiles:
// L and P to 4, N to 8; rows read as float4 keep 16-byte aligned pitches.
struct Tiles {
  int Lp, Np, Pp;
  int ldc, ldb, ldg, ldm, ldx;
  int x_floats;   // one dtx buffer
  int region;     // C, later the two dtx buffers
  int total;
};

__host__ __device__ inline Tiles tiles(int L, int N, int P) {
  Tiles t;
  t.Lp = (L + 3) / 4 * 4;
  t.Np = (N + 7) / 8 * 8;
  t.Pp = (P + 3) / 4 * 4;
  t.ldc = t.Np + 1;
  t.ldb = t.Np + 4;
  t.ldg = t.Lp + 1;
  t.ldm = t.Lp + 4;
  t.ldx = t.Pp + 4;
  t.x_floats = t.Lp * t.ldx;
  const int c_floats = t.Lp * t.ldc;
  t.region = c_floats > 2 * t.x_floats ? c_floats : 2 * t.x_floats;
  t.total = t.region + t.Lp * t.ldb + t.Lp * t.ldg + t.Lp * t.ldm +
            3 * t.Lp;
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows x cols floats from a contiguous global block into a pitched tile:
// 16-byte copies where the rows and the pitch allow them, else 4-byte ones.
__device__ void copy_tile(float* dst, int ld, const float* src, int rows,
                          int cols) {
  if ((cols & 3) == 0 && (ld & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int q = cols / 4;
    for (int k = threadIdx.x; k < rows * q; k += THREADS) {
      const int r = k / q, c = (k % q) * 4;
      cp_async16(dst + r * ld + c, src + (int64_t)r * cols + c);
    }
  } else {
    for (int k = threadIdx.x; k < rows * cols; k += THREADS) {
      const int r = k / cols, c = k % cols;
      cp_async4(dst + r * ld + c, src + k);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four adjacent outputs (row, col .. col + 3), where they exist.
__device__ __forceinline__ void store4(float* out, int64_t off, int row,
                                       int col, int rows, int cols,
                                       const float (&v)[4]) {
  if (row >= rows) return;
  float* p = out + off + (int64_t)row * cols + col;
  if (col + 3 < cols && (cols & 3) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < cols) p[c] = v[c];
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    ssd_intra_chunk_kernel(const float* __restrict__ dtx,
                           const float* __restrict__ a,
                           const float* __restrict__ Bm,
                           const float* __restrict__ Cm,
                           float* __restrict__ y, float* __restrict__ S,
                           int H, int NC, int L, int N, int P,
                           int heads_per_cta, int groups) {
  extern __shared__ __align__(16) float smem[];
  const Tiles T = tiles(L, N, P);
  float* cs = smem;                       // C (L x N), until G is done
  float* xs0 = smem;                      // then dtx, two buffers
  float* bs = smem + T.region;            // B (L x N)
  float* gs = bs + T.Lp * T.ldb;          // G (L x L), lower triangle
  float* mt = gs + T.Lp * T.ldg;          // M transposed: mt[j][i]
  float* as0 = mt + T.Lp * T.ldm;         // a, two buffers of Lp
  float* ds = as0 + 2 * T.Lp;             // exp(a_{L-1} - a)

  const int grp = blockIdx.x % groups;
  const int bc = blockIdx.x / groups;     // batch * NC + chunk
  const int c = bc % NC, b = bc / NC;
  const int h0 = grp * heads_per_cta;
  const int nh = min(heads_per_cta, H - h0);

  copy_tile(cs, T.ldc, Cm + (int64_t)bc * L * N, L, N);
  copy_tile(bs, T.ldb, Bm + (int64_t)bc * L * N, L, N);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // G = C B^T over the lower triangle, 4 x 4 blocks (bi, bj <= bi) a thread
  {
    const int nb = T.Lp / 4;
    for (int u = threadIdx.x; u < nb * nb; u += THREADS) {
      const int bi = u / nb, bj = u % nb;
      if (bj > bi) continue;
      float acc[4][4] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          cv[r] = cs[(4 * bi + r) * T.ldc + n];
          bv[r] = bs[(4 * bj + r) * T.ldb + n];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(cv[r], bv[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          gs[(4 * bi + r) * T.ldg + 4 * bj + s] = acc[r][s];
    }
  }
  __syncthreads();                        // C is dead from here

  auto fetch = [&](int k) {               // head h0 + k into buffer k & 1
    const int64_t cell = ((int64_t)b * H + h0 + k) * NC + c;
    copy_tile(xs0 + (k & 1) * T.x_floats, T.ldx, dtx + cell * L * P, L, P);
    for (int i = threadIdx.x; i < L; i += THREADS)
      cp_async4(as0 + (k & 1) * T.Lp + i, a + cell * L + i);
    cp_commit();
  };
  fetch(0);

  const int yp = T.Pp / 4;                // Y units: (Lp/4) x (Pp/4)
  const int y_units = (T.Lp / 4) * yp;
  const int s_units = (T.Np / 8) * yp;    // S units: (Np/8) x (Pp/4)

  for (int k = 0; k < nh; ++k) {
    if (k + 1 < nh) {
      fetch(k + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* xs = xs0 + (k & 1) * T.x_floats;
    const float* as = as0 + (k & 1) * T.Lp;
    const int64_t cell = ((int64_t)b * H + h0 + k) * NC + c;

    // M, transposed, over the whole padded tile (zeros past the diagonal
    // and past L), and the state decays
    for (int e = threadIdx.x; e < T.Lp * T.Lp; e += THREADS) {
      const int j = e / T.Lp, i = e % T.Lp;
      mt[j * T.ldm + i] =
          (j <= i && i < L) ? gs[i * T.ldg + j] * expf(as[i] - as[j]) : 0.f;
    }
    for (int l = threadIdx.x; l < L; l += THREADS)
      ds[l] = expf(as[L - 1] - as[l]);
    __syncthreads();

    // Y = M dtx: rows 4 bi .. 4 bi + 3, columns 4 bp .. 4 bp + 3; j up to
    // the rows' diagonal
    for (int u = threadIdx.x; u < y_units; u += THREADS) {
      const int bi = u / yp, bp = u % yp;
      float acc[4][4] = {};
      const int j_end = min(4 * bi + 4, L);
#pragma unroll 4
      for (int j = 0; j < j_end; ++j) {
        const float4 m = ld4(mt + j * T.ldm + 4 * bi);
        const float4 xv = ld4(xs + j * T.ldx + 4 * bp);
        const float mr[4] = {m.x, m.y, m.z, m.w};
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(mr[r], xr[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        store4(y, cell * L * P, 4 * bi + r, 4 * bp, L, P, acc[r]);
    }

    // S = (B * d)^T dtx: rows 8 bn .. 8 bn + 7, columns 4 bp .. 4 bp + 3
    for (int u = threadIdx.x; u < s_units; u += THREADS) {
      const int bn = u / yp, bp = u % yp;
      float acc[8][4] = {};
#pragma unroll 4
      for (int l = 0; l < L; ++l) {
        const float d = ds[l];
        const float4 b0 = ld4(bs + l * T.ldb + 8 * bn);
        const float4 b1 = ld4(bs + l * T.ldb + 8 * bn + 4);
        const float4 xv = ld4(xs + l * T.ldx + 4 * bp);
        const float bd[8] = {b0.x * d, b0.y * d, b0.z * d, b0.w * d,
                             b1.x * d, b1.y * d, b1.z * d, b1.w * d};
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(bd[r], xr[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        store4(S, cell * N * P, 8 * bn + r, 4 * bp, N, P, acc[r]);
    }
    __syncthreads();                      // this buffer is free again
  }
}

// Shared memory one CTA takes, in bytes.
int smem_bytes(int L, int N, int P) {
  return (int)((int64_t)tiles(L, N, P).total * sizeof(float));
}

}  // namespace

// CTAs of the kernel that fit one SM at once at (L, N, P) (0 where the
// tiles need more shared memory than a CTA has), or minus a cudaError_t.
extern "C" int ssd_ctas_per_sm(int L, int N, int P) {
  const int bytes = smem_bytes(L, N, P);
  if (bytes > SMEM_LIMIT) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, ssd_intra_chunk_kernel, THREADS, bytes);
  if (err != cudaSuccess) return -(int)err;
  return n;
}

// dtx (batch, H, NC, L, P), a (batch, H, NC, L), B and C (batch, NC, L, N),
// y (batch, H, NC, L, P), S (batch, H, NC, N, P), all float32 and
// contiguous; one CTA per (batch, chunk, group of heads_per_cta heads).
// Returns a cudaError_t, -2 for L outside [1, 64], N, P or heads_per_cta
// below 1, -3 for tiles that need more shared memory than a CTA has.
extern "C" int ssd_intra_chunk(const float* dtx, const float* a,
                               const float* B, const float* C, float* y,
                               float* S, int batch, int H, int NC, int L,
                               int N, int P, int heads_per_cta,
                               void* stream) {
  if (L < 1 || L > MAX_L || N < 1 || P < 1 || heads_per_cta < 1) return -2;
  const int bytes = smem_bytes(L, N, P);
  if (bytes > SMEM_LIMIT) return -3;
  const int groups = (H + heads_per_cta - 1) / heads_per_cta;
  const int64_t ctas = (int64_t)batch * NC * groups;
  if (ctas == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_intra_chunk_kernel<<<(unsigned)ctas, THREADS, (size_t)bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      dtx, a, B, C, y, S, H, NC, L, N, P, heads_per_cta, groups);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_error(int code) {
  if (code == -3) return "the tiles need more shared memory than a CTA has";
  if (code == -2)
    return "chunk length outside [1, 64], or N, P or heads a CTA below 1";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
