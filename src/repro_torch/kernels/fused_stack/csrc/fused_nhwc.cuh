// Shared device code of the nhwc kernels, forward (fused_nhwc.cu) and
// backward (fused_nhwc_bwd.cu): the descriptor, the op semantics, the
// depth-first recompute of one tile, so the backward recomputes exactly
// what the forward computed, and the persistent kernels' float4 walk over
// an item's positions.
//
// Semantics held to the JAX kernel's run_tile: a pool masks its *own* input
// level by that level's image extent with a select to its neutral element
// (-FLT_MAX for max, 0 for avg), so garbage halo values (NaN, inf) never
// leak; max propagates NaN like jnp.maximum; avg divides by kh * kw.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

#define MAX_OPS 32
#define MAX_LEVELS 16
#define MAX_VECS 24
#define THREADS 256

// Window positions the fused paths (forward and backward) hold in
// registers: nhwc.FUSED_WIN.
constexpr int FUSED_WIN = 4;

enum { K_UNARY = 0, K_BINARY, K_AFFINE, K_POOL, K_NORM, K_SOFTMAX };
enum { SRC_SLOT = 0, SRC_VEC = 1 };
enum { U_RELU = 0, U_RELU6, U_SQUARED_RELU, U_GELU, U_GELU_EXACT, U_SILU,
       U_SIGMOID, U_TANH, U_EXP, U_ABS, U_SQUARE, U_IDENTITY, U_NEG,
       U_SOFTPLUS };
enum { B_ADD = 0, B_SUB, B_MUL, B_DIV, B_MAX, B_MIN };
enum { P_MAX = 0, P_AVG = 1 };
enum { N_RMS = 0, N_LAYER = 1 };

struct OpDesc {
  int kind, fn, out;
  int a_src, a_idx;   // first operand: slot or vector
  int b_src, b_idx;   // second operand / scale vector (-1: none)
  int c_idx;          // bias vector (-1: none)
  int kh, kw, sh, sw; // pool window and stride
  int norm;
  float eps;
};

struct LevelDesc {
  int eh, ew;          // tile extent at this level
  int ih, iw;          // image extent at this level
  int mul_h, off_h, mul_w, off_w;  // origin = tile * th * mul - off
};

struct NhwcDesc {
  const float* vecs[MAX_VECS];   // broadcast extras, then params
  int vec_stride[MAX_VECS];      // 1: indexed by channel, 0: one value
  int n_ops, n_levels, n_slots, in_slot, out_slot;
  int N, H, W, C, OH, OW, th, tw, tiles_h, tiles_w, cb, n_cb, slot_elems;
  int rowred;
  LevelDesc levels[MAX_LEVELS];
  OpDesc ops[MAX_OPS];
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ float unary(int fn, float x) {
  switch (fn) {
    case U_RELU: return nan_max(x, 0.f);
    case U_RELU6: return nan_min(nan_max(x, 0.f), 6.f);
    case U_SQUARED_RELU: { float r = nan_max(x, 0.f); return r * r; }
    case U_GELU: {       // tanh approximation, as jax.nn.gelu(approximate=True)
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      return x * (0.5f * (1.f + tanhf(k * (x + 0.044715f * (x * x * x)))));
    }
    case U_GELU_EXACT: return x * (erff(x / 1.4142135623730951f) + 1.f) / 2.f;
    case U_SILU: return x * sigmoid(x);
    case U_SIGMOID: return sigmoid(x);
    case U_TANH: return tanhf(x);
    case U_EXP: return expf(x);
    case U_ABS: return fabsf(x);
    case U_SQUARE: return x * x;
    case U_IDENTITY: return x;
    case U_NEG: return -x;
    case U_SOFTPLUS:     // logaddexp(x, 0)
      return (x != x) ? x : fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  }
  return x;
}

__device__ float binary(int fn, float a, float b) {
  switch (fn) {
    case B_ADD: return a + b;
    case B_SUB: return a - b;
    case B_MUL: return a * b;
    case B_DIV: return a / b;
    case B_MAX: return nan_max(a, b);
    case B_MIN: return nan_min(a, b);
  }
  return a;
}

__device__ __forceinline__ float vec(const NhwcDesc& d, int idx, int cg) {
  if (d.vec_stride[idx] == 0) return __ldg(d.vecs[idx]);
  return cg < d.C ? __ldg(d.vecs[idx] + cg) : 0.f;
}

__device__ __forceinline__ float operand(const NhwcDesc& d, const float* smem,
                                         int src, int idx, int e, int cg) {
  return src == SRC_SLOT ? smem[idx * d.slot_elems + e] : vec(d, idx, cg);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A run of element-wise ops [first, last) on the elements this thread owns.
__device__ void pointwise_pass(const NhwcDesc& d, float* smem, int first,
                               int last, int n_elems, int c0) {
  const int cb = d.cb;
  for (int e = threadIdx.x; e < n_elems; e += THREADS) {
    const int cg = c0 + e % cb;
    for (int k = first; k < last; ++k) {
      const OpDesc& op = d.ops[k];
      const float a = operand(d, smem, op.a_src, op.a_idx, e, cg);
      float r;
      if (op.kind == K_UNARY) {
        r = unary(op.fn, a);
      } else if (op.kind == K_BINARY) {
        r = binary(op.fn, a, operand(d, smem, op.b_src, op.b_idx, e, cg));
      } else {  // K_AFFINE, rounded after the multiply as x * s + o is
        //          in PyTorch (no fused multiply-add): the backward's
        //          max-pool routing then sees the plain version's values
        r = __fadd_rn(__fmul_rn(a, vec(d, op.b_idx, cg)),
                      vec(d, op.c_idx, cg));
      }
      smem[op.out * d.slot_elems + e] = r;
    }
  }
}

// POOL2D from level `li` (origin gh, gw) into level li + 1.
__device__ void pool_pass(const NhwcDesc& d, float* smem, const OpDesc& op,
                          const LevelDesc& in, const LevelDesc& out, int gh,
                          int gw) {
  const int cb = d.cb;
  const float* src = smem + op.a_idx * d.slot_elems;
  float* dst = smem + op.out * d.slot_elems;
  const bool is_max = op.fn == P_MAX;
  const float neutral = is_max ? -FLT_MAX : 0.f;
  const int n_elems = out.eh * out.ew * cb;
  for (int e = threadIdx.x; e < n_elems; e += THREADS) {
    const int c = e % cb;
    const int p = e / cb;
    const int oi = p / out.ew, oj = p % out.ew;
    float acc = 0.f;
    for (int di = 0; di < op.kh; ++di) {
      const int hi = oi * op.sh + di;
      const bool vh = gh + hi >= 0 && gh + hi < in.ih;
      for (int dj = 0; dj < op.kw; ++dj) {
        const int wj = oj * op.sw + dj;
        const bool valid = vh && gw + wj >= 0 && gw + wj < in.iw;
        const float v = valid ? src[(hi * in.ew + wj) * cb + c] : neutral;
        if (di == 0 && dj == 0) acc = v;
        else acc = is_max ? nan_max(acc, v) : acc + v;
      }
    }
    if (!is_max) acc = acc / (float)(op.kh * op.kw);
    dst[e] = acc;
  }
}

// ROW_NORM / ROW_SOFTMAX over the channels of each position (cb == C):
// one warp per position, lanes over channels.
__device__ void row_pass(const NhwcDesc& d, float* smem, const OpDesc& op,
                         int n_pos) {
  const int C = d.C, cb = d.cb;
  const float* src = smem + op.a_idx * d.slot_elems;
  float* dst = smem + op.out * d.slot_elems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < n_pos; p += THREADS / 32) {
    const float* x = src + p * cb;
    float* y = dst + p * cb;
    if (op.kind == K_SOFTMAX) {
      float m = -INFINITY;
      for (int c = lane; c < C; c += 32) m = nan_max(m, x[c]);
      m = warp_max(m);
      float s = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float ex = expf(x[c] - m);
        y[c] = ex;
        s += ex;
      }
      s = warp_sum(s);
      for (int c = lane; c < C; c += 32) y[c] = y[c] / s;
      continue;
    }
    float mu = 0.f, var;
    if (op.norm == N_RMS) {
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += x[c] * x[c];
      var = warp_sum(s) / (float)C;
    } else {
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += x[c];
      mu = warp_sum(s) / (float)C;
      float s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float t = x[c] - mu;
        s2 += t * t;
      }
      var = warp_sum(s2) / (float)C;
    }
    const float r = rsqrtf(var + op.eps);
    for (int c = lane; c < C; c += 32) {
      float v = (x[c] - mu) * r;
      if (op.b_idx >= 0) v = v * vec(d, op.b_idx, c);
      if (op.c_idx >= 0) v = v + vec(d, op.c_idx, c);
      y[c] = v;
    }
  }
}

// Level 0: the halo-grown input patch of tile (ti, tj) of image n, channels
// [c0, c0 + cb), by predicated loads from the unpadded input.  Out-of-image
// and channel-tail elements hold 0; every pool masks them again before it
// reads them.
__device__ void load_patch(const NhwcDesc& d, float* smem,
                           const float* __restrict__ x, long long n, int ti,
                           int tj, int c0) {
  const int cb = d.cb;
  const LevelDesc& L = d.levels[0];
  const int gh = ti * d.th * L.mul_h - L.off_h;
  const int gw = tj * d.tw * L.mul_w - L.off_w;
  float* dst = smem + d.in_slot * d.slot_elems;
  const int n_elems = L.eh * L.ew * cb;
  for (int e = threadIdx.x; e < n_elems; e += THREADS) {
    const int c = e % cb, p = e / cb;
    const int h = gh + p / L.ew, w = gw + p % L.ew, cg = c0 + c;
    float v = 0.f;
    if (h >= 0 && h < d.H && w >= 0 && w < d.W && cg < d.C)
      v = x[((n * d.H + h) * d.W + w) * d.C + cg];
    dst[e] = v;
  }
}

// The whole chain on the loaded patch, level by level.  Element-wise runs
// share the load's ownership (no barrier); pools and row ops sit between
// two barriers.
__device__ void run_chain(const NhwcDesc& d, float* smem, int ti, int tj,
                          int c0) {
  int level = 0;
  int k = 0;
  while (k < d.n_ops) {
    const OpDesc& op = d.ops[k];
    const LevelDesc& L = d.levels[level];
    if (op.kind == K_POOL) {
      const LevelDesc& Lo = d.levels[level + 1];
      const int gh = ti * d.th * L.mul_h - L.off_h;
      const int gw = tj * d.tw * L.mul_w - L.off_w;
      __syncthreads();
      pool_pass(d, smem, op, L, Lo, gh, gw);
      __syncthreads();
      ++level;
      ++k;
    } else if (op.kind == K_NORM || op.kind == K_SOFTMAX) {
      __syncthreads();
      row_pass(d, smem, op, L.eh * L.ew);
      __syncthreads();
      ++k;
    } else {
      int last = k;
      while (last < d.n_ops && d.ops[last].kind <= K_AFFINE) ++last;
      pointwise_pass(d, smem, k, last, L.eh * L.ew * d.cb, c0);
      k = last;
    }
  }
}

// ---------------------------------------------------------------------------
// The thread's share of an item, float4 arithmetic, the position walk.
// ---------------------------------------------------------------------------

struct Own {
  int q, nq;       // channel quad, quads a block (cb / 4)
  int pl, lanes;   // position lane (INT_MAX / 2 on an idle thread), lanes
  const float* vs; // the vector operands at the CTA's channel block
};

// Positions pl, pl + lanes, ... of an eh x ew level, with their row and
// column, stepped without a division.
struct Walk {
  int p, r, c, n, ew, step, dr, dc;
  __device__ __forceinline__ Walk(const Own& o, int eh, int ew_)
      : p(o.pl), r(o.pl / ew_), c(o.pl % ew_), n(eh * ew_), ew(ew_),
        step(o.lanes), dr(o.lanes / ew_), dc(o.lanes % ew_) {}
  __device__ __forceinline__ bool ok() const { return p < n; }
  __device__ __forceinline__ void next() {
    p += step;
    r += dr;
    c += dc;
    if (c >= ew) {
      c -= ew;
      ++r;
    }
  }
};

// The thread's positions of an eh x ew level: body(p, r, c) for each.
template <class Body>
__device__ __forceinline__ void walk(const Own& o, int eh, int ew,
                                     Body body) {
  for (Walk w(o, eh, ew); w.ok(); w.next()) body(w.p, w.r, w.c);
}

__device__ __forceinline__ float4 f4(float v) {
  return make_float4(v, v, v, v);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// An affine op rounded after the multiply, as x * s + o is in PyTorch (no
// fused multiply-add): the backward's max-pool routing then sees the plain
// version's values.
__device__ __forceinline__ float4 affine4(float4 a, float4 s, float4 t) {
  return make_float4(__fadd_rn(__fmul_rn(a.x, s.x), t.x),
                     __fadd_rn(__fmul_rn(a.y, s.y), t.y),
                     __fadd_rn(__fmul_rn(a.z, s.z), t.z),
                     __fadd_rn(__fmul_rn(a.w, s.w), t.w));
}

__device__ __forceinline__ float4* slot4(const NhwcDesc& d, float* smem,
                                         int s) {
  return reinterpret_cast<float4*>(smem + (size_t)s * d.slot_elems);
}

// A vector operand at the thread's four channels, from the CTA's copy of
// its channel block (``vs``, staged once: the block never changes).
__device__ __forceinline__ float4 vec4(const float* vs, const NhwcDesc& d,
                                       int idx, int q) {
  return reinterpret_cast<const float4*>(vs + (size_t)idx * d.cb)[q];
}

__device__ __forceinline__ void put4(float4* slot, int e, float4 v,
                                     int acc) {
  slot[e] = acc ? add4(slot[e], v) : v;
}

// Four channels from global memory (0 past C), one 16-byte load where the
// whole quad is in range and aligned.
__device__ __forceinline__ float4 load4(const float* src, int cg0, int C,
                                        bool full4) {
  if (full4) return __ldg(reinterpret_cast<const float4*>(src));
  return make_float4(cg0 < C ? __ldg(src) : 0.f,
                     cg0 + 1 < C ? __ldg(src + 1) : 0.f,
                     cg0 + 2 < C ? __ldg(src + 2) : 0.f,
                     cg0 + 3 < C ? __ldg(src + 3) : 0.f);
}

__device__ __forceinline__ void store4(float* dst, float4 v, int cg0, int C,
                                       bool full4) {
  if (full4) {
    *reinterpret_cast<float4*>(dst) = v;
    return;
  }
  if (cg0 < C) dst[0] = v.x;
  if (cg0 + 1 < C) dst[1] = v.y;
  if (cg0 + 2 < C) dst[2] = v.z;
  if (cg0 + 3 < C) dst[3] = v.w;
}

struct Origin {
  int h, w;
};

__device__ __forceinline__ Origin origin(const NhwcDesc& d,
                                         const LevelDesc& L, int ti, int tj) {
  return {ti * d.th * L.mul_h - L.off_h, tj * d.tw * L.mul_w - L.off_w};
}

__device__ __forceinline__ bool inside(const LevelDesc& L, Origin g, int r,
                                       int c) {
  const int h = g.h + r, w = g.w + c;
  return h >= 0 && h < L.ih && w >= 0 && w < L.iw;
}

// Item s: image n, tile (ti, tj); returns whether it lies inside the image
// at every level (then nothing is masked).
__device__ __forceinline__ bool decode_item(const NhwcDesc& d, int s,
                                            long long& n, int& ti, int& tj) {
  tj = s % d.tiles_w;
  ti = (s / d.tiles_w) % d.tiles_h;
  n = s / (d.tiles_w * d.tiles_h);
  bool interior = true;
  for (int l = 0; l < d.n_levels; ++l) {
    const LevelDesc& L = d.levels[l];
    const Origin g = origin(d, L, ti, tj);
    interior = interior && g.h >= 0 && g.h + L.eh <= L.ih && g.w >= 0 &&
               g.w + L.ew <= L.iw;
  }
  return interior;
}
