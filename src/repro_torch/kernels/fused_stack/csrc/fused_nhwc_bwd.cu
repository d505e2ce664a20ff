// Depth-first backward of nhwc-layout BrainSlug stacks, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/fused_stack/nhwc_bwd.py:
// fused_nhwc_bwd_call.  Three kernels:
//
// 1. fused_nhwc_bwd_kernel, persistent: a fixed number of CTAs (as many as
//    fit the card at once) each walk a strided set of work items (image,
//    tile, channel block).  Per item the CTA recomputes the forward on the
//    halo-grown patch with the forward's own code (fused_nhwc.cuh:
//    load_patch, run_chain), every value in its own shared-memory slot, then
//    runs the VJP rules of repro_torch/core/autodiff.py in reverse over the
//    same levels:
//    - each op's output cotangent is zeroed outside the image at its level;
//    - a max pool routes its cotangent to the first maximal window position
//      in row-major order, an avg pool spreads g / (kh * kw); both gather
//      per input element in a fixed order (no atomics), and the pool's input
//      cotangent is zeroed where the forward read the neutral element;
//    - parameter and broadcast-extra gradients are summed over the tile's
//      valid positions by one thread per channel, in position order, into a
//      per-CTA accumulator that lives across the CTA's work items.
//    The primary input's cotangent is written straight to dx where tiles'
//    input regions do not overlap (VGG's 2x2/s2 pools), else to a private
//    halo patch per tile.
// 2. nhwc_overlap_add_kernel: each dx element sums, tile by tile in row-major
//    tile order (the Pallas wrapper's fori_loop order), the patch entries
//    that cover it, and crops.  The patch path moves about twice the bytes
//    of the direct write.
// 3. nhwc_reduce_kernel: sums the per-CTA accumulators over the CTAs in a
//    fixed order.  No float atomics anywhere: two runs are bitwise equal.
//
// Bound: device-memory bytes (x and g read, dx written once).  What the
// simple design does about it: nothing beyond fusion yet.

#include "fused_nhwc.cuh"

struct BwdOpDesc {
  int g;          // cotangent slot of the op's output (-1: no cotangent)
  int da, db;     // cotangent slots of the operands (-1: a vector, or none)
  int da_acc, db_acc;   // 1: add into the slot, 0: first write
  int same;       // 1: both operands are one value (x op x), summed into da
  int level;      // level index of the op's input
};

struct NhwcBwdDesc {
  NhwcDesc f;
  BwdOpDesc bops[MAX_OPS];
  int g_slot;     // cotangent slot of the program output
  int dx_slot;    // cotangent slot of the primary input (-1: zero)
  int scratch;    // slot for the norm scale gradient terms (-1: none)
  int n_vecs;     // extras then params, as in f.vecs
  int work;       // N * tiles_h * tiles_w * n_cb
  int patches;    // 1: write halo patches for the overlap-add
};

__device__ float unary_deriv(int fn, float x) {
  switch (fn) {
    case U_RELU: return x > 0.f ? 1.f : 0.f;
    case U_RELU6: return (x > 0.f && x < 6.f) ? 1.f : 0.f;
    case U_SQUARED_RELU: return 2.f * nan_max(x, 0.f);
    case U_GELU: {
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      const float t = tanhf(k * (x + 0.044715f * x * x * x));
      const float du = k * (1.f + 0.134145f * x * x);
      return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * du;
    }
    case U_GELU_EXACT: {
      const float phi = expf(-0.5f * x * x) * 0.3989422804014327f;
      const float cdf = 0.5f * (1.f + erff(x / 1.4142135623730951f));
      return cdf + x * phi;
    }
    case U_SILU: {
      const float s = sigmoid(x);
      return s * (1.f + x * (1.f - s));
    }
    case U_SIGMOID: {
      const float y = sigmoid(x);
      return y * (1.f - y);
    }
    case U_TANH: {
      const float y = tanhf(x);
      return 1.f - y * y;
    }
    case U_EXP: return expf(x);
    case U_ABS: return x > 0.f ? 1.f : (x < 0.f ? -1.f : x * 0.f);
    case U_SQUARE: return 2.f * x;
    case U_IDENTITY: return 1.f;
    case U_NEG: return -1.f;
    case U_SOFTPLUS: return sigmoid(x);
  }
  return 0.f;
}

__device__ void binary_vjp(int fn, float a, float b, float g, float& da,
                           float& db) {
  switch (fn) {
    case B_ADD: da = g; db = g; return;
    case B_SUB: da = g; db = -g; return;
    case B_MUL: da = g * b; db = g * a; return;
    case B_DIV: da = g / b; db = -g * a / (b * b); return;
    case B_MAX:
    case B_MIN: {
      const bool win = fn == B_MAX ? a > b : a < b;
      const float m = win ? 1.f : (a == b ? 0.5f : 0.f);
      da = g * m;
      db = g * (1.f - m);
      return;
    }
  }
  da = db = 0.f;
}

__device__ __forceinline__ bool pos_valid(const LevelDesc& L, int gh, int gw,
                                          int p) {
  const int h = gh + p / L.ew, w = gw + p % L.ew;
  return h >= 0 && h < L.ih && w >= 0 && w < L.iw;
}

__device__ __forceinline__ void put(float* slot, int e, float v, int acc) {
  slot[e] = acc ? slot[e] + v : v;
}

// Element-wise op k: input cotangents of its slot operands.
__device__ void pointwise_bwd(const NhwcBwdDesc& b, float* smem,
                              const OpDesc& op, const BwdOpDesc& bo,
                              int n_elems, int c0) {
  const NhwcDesc& d = b.f;
  const int cb = d.cb;
  const float* G = smem + bo.g * d.slot_elems;
  for (int e = threadIdx.x; e < n_elems; e += THREADS) {
    const int cg = c0 + e % cb;
    const float g = G[e];
    const float a = operand(d, smem, op.a_src, op.a_idx, e, cg);
    float da, db = 0.f;
    if (op.kind == K_UNARY) {
      da = g * unary_deriv(op.fn, a);
    } else if (op.kind == K_BINARY) {
      binary_vjp(op.fn, a, operand(d, smem, op.b_src, op.b_idx, e, cg), g,
                 da, db);
    } else {  // K_AFFINE
      da = g * vec(d, op.b_idx, cg);
    }
    if (bo.da >= 0)
      put(smem + bo.da * d.slot_elems, e, bo.same ? da + db : da, bo.da_acc);
    if (bo.db >= 0) put(smem + bo.db * d.slot_elems, e, db, bo.db_acc);
  }
}

// Gradients of op k's vector operands (params, broadcast extras): one
// thread per channel sums the level's valid positions in order.  Either
// operand of an element-wise op may be a vector, both may (``e * e``).
__device__ void vector_bwd(const NhwcBwdDesc& b, float* smem, float* acc,
                           const OpDesc& op, const BwdOpDesc& bo,
                           const LevelDesc& L, int gh, int gw, int c0) {
  const NhwcDesc& d = b.f;
  const int cb = d.cb, n_pos = L.eh * L.ew;
  const float* G = smem + bo.g * d.slot_elems;
  const bool a_vec = op.a_src == SRC_VEC;
  for (int c = threadIdx.x; c < cb; c += THREADS) {
    const int cg = c0 + c;
    if (cg >= d.C) continue;
    if (op.kind == K_UNARY || op.kind == K_BINARY) {
      const bool b_vec = op.kind == K_BINARY && op.b_src == SRC_VEC;
      float sa = 0.f, sb = 0.f;
      for (int p = 0; p < n_pos; ++p) {
        if (!pos_valid(L, gh, gw, p)) continue;
        const int e = p * cb + c;
        const float a = operand(d, smem, op.a_src, op.a_idx, e, cg);
        float da, db = 0.f;
        if (op.kind == K_UNARY)
          da = G[e] * unary_deriv(op.fn, a);
        else
          binary_vjp(op.fn, a, operand(d, smem, op.b_src, op.b_idx, e, cg),
                     G[e], da, db);
        sa += da;
        sb += db;
      }
      if (a_vec) acc[op.a_idx * d.C + cg] += sa;
      if (b_vec) acc[op.b_idx * d.C + cg] += sb;
    } else if (op.kind == K_AFFINE || op.kind == K_NORM) {
      const float* S = op.kind == K_NORM && b.scratch >= 0
                           ? smem + b.scratch * d.slot_elems : nullptr;
      float s_scale = 0.f, s_bias = 0.f, s_a = 0.f;
      for (int p = 0; p < n_pos; ++p) {
        if (!pos_valid(L, gh, gw, p)) continue;
        const int e = p * cb + c;
        if (op.kind == K_AFFINE) {
          s_scale += G[e] * operand(d, smem, op.a_src, op.a_idx, e, cg);
          s_a += G[e] * vec(d, op.b_idx, cg);
        } else {
          s_scale += S ? S[e] : 0.f;
        }
        s_bias += G[e];
      }
      if (op.b_idx >= 0) acc[op.b_idx * d.C + cg] += s_scale;
      if (op.c_idx >= 0) acc[op.c_idx * d.C + cg] += s_bias;
      if (op.kind == K_AFFINE && a_vec) acc[op.a_idx * d.C + cg] += s_a;
    }
  }
}

// POOL2D from level Li (origin ghi, gwi) to level Lo: phase A marks, per
// output element, the first window offset holding the max (in the pool's
// own output slot, dead by now); phase B gathers per input element.
__device__ void pool_bwd(const NhwcBwdDesc& b, float* smem, const OpDesc& op,
                         const BwdOpDesc& bo, const LevelDesc& Li,
                         const LevelDesc& Lo, int ghi, int gwi) {
  const NhwcDesc& d = b.f;
  const int cb = d.cb;
  const bool is_max = op.fn == P_MAX;
  const float* src = smem + op.a_idx * d.slot_elems;
  float* Y = smem + op.out * d.slot_elems;
  const float* G = smem + bo.g * d.slot_elems;
  if (is_max) {
    const int n_out = Lo.eh * Lo.ew * cb;
    for (int e = threadIdx.x; e < n_out; e += THREADS) {
      const int c = e % cb, p = e / cb;
      const int oi = p / Lo.ew, oj = p % Lo.ew;
      const float y = Y[e];
      int code = -1;
      for (int di = 0; di < op.kh && code < 0; ++di) {
        const int hi = oi * op.sh + di;
        for (int dj = 0; dj < op.kw; ++dj) {
          const int wj = oj * op.sw + dj;
          const bool valid = ghi + hi >= 0 && ghi + hi < Li.ih &&
                             gwi + wj >= 0 && gwi + wj < Li.iw;
          const float v = valid ? src[(hi * Li.ew + wj) * cb + c] : -FLT_MAX;
          if (v == y) {
            code = di * op.kw + dj;
            break;
          }
        }
      }
      Y[e] = (float)code;
    }
    __syncthreads();
  }
  float* DA = smem + bo.da * d.slot_elems;
  const int n_in = Li.eh * Li.ew * cb;
  for (int e = threadIdx.x; e < n_in; e += THREADS) {
    const int c = e % cb, p = e / cb;
    const int hi = p / Li.ew, wj = p % Li.ew;
    float s = 0.f;
    for (int di = 0; di < op.kh; ++di) {
      const int th = hi - di;
      if (th < 0 || th % op.sh) continue;
      const int oi = th / op.sh;
      if (oi >= Lo.eh) continue;
      for (int dj = 0; dj < op.kw; ++dj) {
        const int tw = wj - dj;
        if (tw < 0 || tw % op.sw) continue;
        const int oj = tw / op.sw;
        if (oj >= Lo.ew) continue;
        const int o = (oi * Lo.ew + oj) * cb + c;
        if (is_max) {
          if (Y[o] == (float)(di * op.kw + dj)) s += G[o];
        } else {
          s += G[o] / (float)(op.kh * op.kw);
        }
      }
    }
    const bool valid = ghi + hi >= 0 && ghi + hi < Li.ih && gwi + wj >= 0 &&
                       gwi + wj < Li.iw;
    put(DA, e, valid ? s : 0.f, bo.da_acc);
  }
}

// ROW_NORM / ROW_SOFTMAX backward over the channels of each position
// (cb == C), one warp per position; statistics recomputed as row_pass does.
__device__ void row_bwd(const NhwcBwdDesc& b, float* smem, const OpDesc& op,
                        const BwdOpDesc& bo, const LevelDesc& L, int gh,
                        int gw) {
  const NhwcDesc& d = b.f;
  const int C = d.C, cb = d.cb, n_pos = L.eh * L.ew;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < n_pos; p += THREADS / 32) {
    const float* g = smem + bo.g * d.slot_elems + p * cb;
    float* dx = smem + bo.da * d.slot_elems + p * cb;
    if (op.kind == K_SOFTMAX) {
      const float* y = smem + op.out * d.slot_elems + p * cb;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += g[c] * y[c];
      const float dot = warp_sum(s);
      for (int c = lane; c < C; c += 32)
        put(dx, c, y[c] * (g[c] - dot), bo.da_acc);
      continue;
    }
    const float* x = smem + op.a_idx * d.slot_elems + p * cb;
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
    const bool valid = pos_valid(L, gh, gw, p);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xh = (x[c] - mu) * r;
      const float gy = op.b_idx >= 0 ? g[c] * vec(d, op.b_idx, c) : g[c];
      if (op.b_idx >= 0)
        smem[b.scratch * d.slot_elems + p * cb + c] = valid ? g[c] * xh : 0.f;
      if (op.norm == N_RMS) {
        s1 += gy * x[c];
      } else {
        s1 += gy;
        s2 += gy * xh;
      }
    }
    const float m1 = warp_sum(s1) / (float)C;
    const float m2 = warp_sum(s2) / (float)C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (x[c] - mu) * r;
      const float gy = op.b_idx >= 0 ? g[c] * vec(d, op.b_idx, c) : g[c];
      const float v = op.norm == N_RMS ? r * gy - x[c] * (r * r * r) * m1
                                       : r * (gy - m1 - xh * m2);
      put(dx, c, v, bo.da_acc);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
fused_nhwc_bwd_kernel(const __grid_constant__ NhwcBwdDesc b,
                      const float* __restrict__ x,
                      const float* __restrict__ gout, float* __restrict__ dx,
                      float* __restrict__ partials) {
  extern __shared__ float smem[];
  const NhwcDesc& d = b.f;
  const int cb = d.cb;
  float* acc = smem + d.n_slots * d.slot_elems;
  for (int i = threadIdx.x; i < b.n_vecs * d.C; i += THREADS) acc[i] = 0.f;

  for (int w = blockIdx.x; w < b.work; w += gridDim.x) {
    int t = w;
    const int cblk = t % d.n_cb;
    t /= d.n_cb;
    const int tj = t % d.tiles_w;
    t /= d.tiles_w;
    const int ti = t % d.tiles_h;
    const long long n = t / d.tiles_h;
    const int c0 = cblk * cb;

    __syncthreads();              // the previous item is done with smem
    load_patch(d, smem, x, n, ti, tj, c0);
    run_chain(d, smem, ti, tj, c0);
    {  // the output cotangent; zero past the output's edge
      float* G = smem + b.g_slot * d.slot_elems;
      const int n_elems = d.th * d.tw * cb;
      for (int e = threadIdx.x; e < n_elems; e += THREADS) {
        const int c = e % cb, p = e / cb;
        const int oh = ti * d.th + p / d.tw, ow = tj * d.tw + p % d.tw;
        const int cg = c0 + c;
        G[e] = (oh < d.OH && ow < d.OW && cg < d.C)
                   ? gout[((n * d.OH + oh) * d.OW + ow) * d.C + cg] : 0.f;
      }
    }
    __syncthreads();

    for (int k = d.n_ops - 1; k >= 0; --k) {
      const OpDesc& op = d.ops[k];
      const BwdOpDesc& bo = b.bops[k];
      if (bo.g < 0) continue;
      const bool pool = op.kind == K_POOL;
      const LevelDesc& Li = d.levels[bo.level];
      const LevelDesc& Lo = d.levels[bo.level + (pool ? 1 : 0)];
      const int ghi = ti * d.th * Li.mul_h - Li.off_h;
      const int gwi = tj * d.tw * Li.mul_w - Li.off_w;
      const int gho = ti * d.th * Lo.mul_h - Lo.off_h;
      const int gwo = tj * d.tw * Lo.mul_w - Lo.off_w;
      {  // the op's output cotangent is zero outside the image
        float* G = smem + bo.g * d.slot_elems;
        const int n_elems = Lo.eh * Lo.ew * cb;
        for (int e = threadIdx.x; e < n_elems; e += THREADS)
          if (!pos_valid(Lo, gho, gwo, e / cb)) G[e] = 0.f;
      }
      __syncthreads();
      if (pool) {
        pool_bwd(b, smem, op, bo, Li, Lo, ghi, gwi);
      } else if (op.kind == K_NORM || op.kind == K_SOFTMAX) {
        row_bwd(b, smem, op, bo, Li, ghi, gwi);
      } else {
        pointwise_bwd(b, smem, op, bo, Li.eh * Li.ew * cb, c0);
      }
      __syncthreads();
      if ((op.kind == K_UNARY && op.a_src == SRC_VEC) ||
          (op.kind == K_BINARY &&
           (op.a_src == SRC_VEC || op.b_src == SRC_VEC)) ||
          op.kind == K_AFFINE || (op.kind == K_NORM && op.b_idx >= 0)) {
        vector_bwd(b, smem, acc, op, bo, Lo, gho, gwo, c0);
        __syncthreads();
      }
    }

    {  // the primary input's cotangent: a private patch, or dx itself
      const LevelDesc& L = d.levels[0];
      const float* src = b.dx_slot >= 0 ? smem + b.dx_slot * d.slot_elems
                                        : nullptr;
      const int gh = ti * d.th * L.mul_h - L.off_h;
      const int gw = tj * d.tw * L.mul_w - L.off_w;
      const int n_elems = L.eh * L.ew * cb;
      const long long patch =
          ((n * d.tiles_h + ti) * d.tiles_w + tj) * (long long)(L.eh * L.ew);
      for (int e = threadIdx.x; e < n_elems; e += THREADS) {
        const int c = e % cb, p = e / cb, cg = c0 + c;
        if (cg >= d.C) continue;
        const float v = src ? src[e] : 0.f;
        if (b.patches) {
          dx[(patch + p) * d.C + cg] = v;
        } else {
          const int h = gh + p / L.ew, w2 = gw + p % L.ew;
          if (h >= 0 && h < d.H && w2 >= 0 && w2 < d.W)
            dx[((n * d.H + h) * d.W + w2) * d.C + cg] = v;
        }
      }
    }
  }
  __syncthreads();
  float* mine = partials + (long long)blockIdx.x * b.n_vecs * d.C;
  for (int i = threadIdx.x; i < b.n_vecs * d.C; i += THREADS) mine[i] = acc[i];
}

// dx[n, h, w, c] = sum over the tiles whose halo covers (h, w), in row-major
// tile order, of their patch entry at (h, w).
__global__ void nhwc_overlap_add_kernel(const __grid_constant__ NhwcBwdDesc b,
                                        const float* __restrict__ patches,
                                        float* __restrict__ dx) {
  const NhwcDesc& d = b.f;
  const LevelDesc& L = d.levels[0];
  const int sh = d.th * L.mul_h, sw = d.tw * L.mul_w;
  const long long total = (long long)d.N * d.H * d.W * d.C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = i % d.C;
    long long t = i / d.C;
    const int w = t % d.W;
    t /= d.W;
    const int h = t % d.H;
    const long long n = t / d.H;
    const int hh = h + L.off_h, ww = w + L.off_w;   // >= 0
    const int ti0 = hh - L.eh + 1 > 0 ? (hh - L.eh + 1 + sh - 1) / sh : 0;
    const int tj0 = ww - L.ew + 1 > 0 ? (ww - L.ew + 1 + sw - 1) / sw : 0;
    const int ti1 = min(d.tiles_h - 1, hh / sh);
    const int tj1 = min(d.tiles_w - 1, ww / sw);
    float s = 0.f;
    for (int ti = ti0; ti <= ti1; ++ti) {
      for (int tj = tj0; tj <= tj1; ++tj) {
        const int p = (hh - ti * sh) * L.ew + (ww - tj * sw);
        const long long patch = (n * d.tiles_h + ti) * d.tiles_w + tj;
        s += patches[(patch * L.eh * L.ew + p) * d.C + c];
      }
    }
    dx[i] = s;
  }
}

// out[v, c] = sum over CTAs of partials[cta, v, c]; a vector of one value
// (vec_stride 0) sums all its channels into out[v, 0].
__global__ void nhwc_reduce_kernel(const __grid_constant__ NhwcBwdDesc b,
                                   int programs,
                                   const float* __restrict__ partials,
                                   float* __restrict__ out) {
  const NhwcDesc& d = b.f;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b.n_vecs * d.C) return;
  const int v = i / d.C, c = i % d.C;
  const int stride = b.n_vecs * d.C;
  float s = 0.f;
  if (d.vec_stride[v]) {
    for (int p = 0; p < programs; ++p) s += partials[(long long)p * stride + i];
  } else if (c == 0) {
    for (int p = 0; p < programs; ++p)
      for (int cc = 0; cc < d.C; ++cc)
        s += partials[(long long)p * stride + v * d.C + cc];
  }
  out[i] = s;
}

extern "C" {

int fused_nhwc_bwd_desc_size() { return (int)sizeof(NhwcBwdDesc); }

const char* fused_nhwc_bwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

static size_t bwd_smem(const NhwcBwdDesc* b) {
  return ((size_t)b->f.n_slots * b->f.slot_elems + (size_t)b->n_vecs * b->f.C)
         * sizeof(float);
}

// The persistent grid: as many CTAs as fit the card at once, at most one
// per work item.  Returns the count, or minus a cudaError_t.
int fused_nhwc_bwd_programs(const NhwcBwdDesc* b) {
  const size_t smem = bwd_smem(b);
  cudaError_t e = cudaFuncSetAttribute(
      fused_nhwc_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0, dev = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_nhwc_bwd_kernel, THREADS, smem)) != cudaSuccess)
    return -(int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return -(int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const long long p = (long long)per_sm * sms;
  return (int)(p < b->work ? p : b->work);
}

// Launches the three kernels on `stream`; returns the first cudaError_t
// (0: all queued).  On the direct path the caller zeroes dx first where
// the tiles' input regions leave positions uncovered.
int fused_nhwc_bwd_launch(const NhwcBwdDesc* b, int programs, const float* x,
                          const float* g, float* dx, float* patches,
                          float* partials, float* dvecs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  fused_nhwc_bwd_kernel<<<programs, THREADS, bwd_smem(b), s>>>(
      *b, x, g, b->patches ? patches : dx, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (b->patches) {
    const long long total = (long long)b->f.N * b->f.H * b->f.W * b->f.C;
    long long blocks = (total + 255) / 256;
    if (blocks > 65536) blocks = 65536;
    nhwc_overlap_add_kernel<<<(int)blocks, 256, 0, s>>>(*b, patches, dx);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const int n = b->n_vecs * b->f.C;
  if (n > 0) {
    nhwc_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(*b, programs, partials,
                                                       dvecs);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
