// Depth-first backward of nhwc-layout BrainSlug stacks, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/fused_stack/nhwc_bwd.py:
// fused_nhwc_bwd_call.  Persistent kernels: CTA p keeps channel block
// p % n_cb for its whole life and walks the spatial items (image, tile)
// p / n_cb, p / n_cb + programs / n_cb, ...  Items come from
// nhwc_bwd.launch_plan (the chain, the shape and the card), not from the
// planner's tile.  Thread (lane, quad) holds channels 4 quad .. 4 quad + 3
// of the block (a float4: channels fastest across the threads, so global
// accesses are 16 bytes a thread and contiguous) and positions lane, lane
// + lanes, ... of a level, walked without a division per element.
// Parameter and broadcast-extra gradients sum in registers over the
// thread's valid positions, then into its own row of per-lane partials in
// shared memory; at the CTA's end the lanes are summed in order into the
// CTA's partials.  Items that lie inside the image at every level skip all
// masking.
//
// 1. fused_nhwc_bwd_kernel_fused: the chain AFFINE -> UNARY -> POOL2D with
//    window == stride (batch norm, an activation, VGG's 2x2/s2 max pool),
//    each output position in registers: its window's x, the affine and
//    unary values, the pooled value and its first maximum, g, and the
//    chain rule back to dx.  No slots, no barriers.  VGG stage 1 takes 8 x
//    8 output tiles of all 64 channels: 1.3x its byte bound on an H100
//    80GB HBM3 at 700 W (chip_smoke.py phase 10; PERF.md, row 4).
// 2. fused_nhwc_bwd_kernel: any other chain.  Per item the CTA recomputes
//    the forward on the halo-grown patch with the forward's op semantics
//    (fused_nhwc.cuh: unary, binary, the rounded affine, pool masking,
//    row_pass), every value in its own shared-memory slot, then runs the
//    VJP rules of repro_torch/core/autodiff.py in reverse over the same
//    levels.  Element-wise ops touch only the thread's own elements (no
//    barrier); a pool takes a barrier each way, a row op two.  A max pool
//    routes its cotangent to the first maximal window position in
//    row-major order, an avg pool spreads g / (kh * kw); the pool's input
//    cotangent is zeroed where the forward read the neutral element.  Where
//    windows do not overlap, the thread that owns a window writes it whole;
//    where they overlap, a mark pass and a gather pass (per input element,
//    fixed order).  Its cost is about 12 us an item a CTA on an H100 80GB
//    HBM3, most of it one-position passes that wait on their loads
//    (PERF.md, section 6).
//    The primary input's cotangent is written straight to dx where tiles'
//    input regions do not overlap (VGG's 2x2/s2 pools), else to a private
//    halo patch per tile.
// 3. nhwc_overlap_add_kernel: each dx element sums, tile by tile in row-major
//    tile order (the Pallas wrapper's fori_loop order), the patch entries
//    that cover it, and crops.  The patch path moves about twice the bytes
//    of the direct write.
// 4. nhwc_reduce_kernel: sums, per channel, the partials of the CTAs that
//    own its block, in CTA order.  No float atomics anywhere: two runs are
//    bitwise equal.
//
// Bound: device-memory bytes (x and g read, dx written once).

#include <limits.h>

#include "fused_nhwc.cuh"

struct BwdOpDesc {
  int g;          // cotangent slot of the op's output (-1: no cotangent)
  int da, db;     // cotangent slots of the operands (-1: a vector, or none)
  int da_acc, db_acc;   // 1: add into the slot, 0: first write
  int same;       // 1: both operands are one value (x op x), summed into da
  int level;      // level index of the op's input
};

struct NhwcBwdDesc {
  NhwcDesc f;     // th, tw, tiles, cb, n_cb, slot_elems: the launch plan's
  BwdOpDesc bops[MAX_OPS];
  int g_slot;     // cotangent slot of the program output
  int dx_slot;    // cotangent slot of the primary input (-1: zero)
  int scratch;    // slot for the norm scale gradient terms (-1: none)
  int n_vecs;     // extras then params, as in f.vecs
  int work;       // items: spatial * n_cb
  int patches;    // 1: write halo patches for the overlap-add
  int lanes;      // position lanes: THREADS / (cb / 4)
  int spatial;    // N * tiles_h * tiles_w
  int vec4;       // 1: C % 4 == 0 and x, g, dx 16-byte aligned
  int fused;      // 1: the AFFINE -> UNARY -> POOL2D path (fused_item)
};

__device__ __forceinline__ float unary_deriv(int fn, float x) {
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

__device__ __forceinline__ void binary_vjp(int fn, float a, float b, float g, float& da,
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

// The op functions as types, so a pass dispatches once per op.
template <int FN>
struct Unary {
  static constexpr bool kBinary = false;
  __device__ __forceinline__ float operator()(float a, float) const {
    return unary(FN, a);
  }
  __device__ __forceinline__ void vjp(float a, float, float g, float& da,
                                      float& db) const {
    da = g * unary_deriv(FN, a);
    db = 0.f;
  }
};

template <int FN>
struct Binary {
  static constexpr bool kBinary = true;
  __device__ __forceinline__ float operator()(float a, float b) const {
    return binary(FN, a, b);
  }
  __device__ __forceinline__ void vjp(float a, float b, float g, float& da,
                                      float& db) const {
    binary_vjp(FN, a, b, g, da, db);
  }
};

template <class Body>
__device__ __forceinline__ void with_fn(const OpDesc& op, Body body) {
  if (op.kind == K_UNARY) {
    switch (op.fn) {
      case U_RELU: body(Unary<U_RELU>()); return;
      case U_RELU6: body(Unary<U_RELU6>()); return;
      case U_SQUARED_RELU: body(Unary<U_SQUARED_RELU>()); return;
      case U_GELU: body(Unary<U_GELU>()); return;
      case U_GELU_EXACT: body(Unary<U_GELU_EXACT>()); return;
      case U_SILU: body(Unary<U_SILU>()); return;
      case U_SIGMOID: body(Unary<U_SIGMOID>()); return;
      case U_TANH: body(Unary<U_TANH>()); return;
      case U_EXP: body(Unary<U_EXP>()); return;
      case U_ABS: body(Unary<U_ABS>()); return;
      case U_SQUARE: body(Unary<U_SQUARE>()); return;
      case U_IDENTITY: body(Unary<U_IDENTITY>()); return;
      case U_NEG: body(Unary<U_NEG>()); return;
      case U_SOFTPLUS: body(Unary<U_SOFTPLUS>()); return;
    }
  } else {
    switch (op.fn) {
      case B_ADD: body(Binary<B_ADD>()); return;
      case B_SUB: body(Binary<B_SUB>()); return;
      case B_MUL: body(Binary<B_MUL>()); return;
      case B_DIV: body(Binary<B_DIV>()); return;
      case B_MAX: body(Binary<B_MAX>()); return;
      case B_MIN: body(Binary<B_MIN>()); return;
    }
  }
}

// ---------------------------------------------------------------------------
// The recompute: the forward chain on the item, every value kept.
// ---------------------------------------------------------------------------

// Level 0: the halo-grown input patch, 0 outside the image and past C.
__device__ void load_patch4(const NhwcDesc& d, float* smem,
                            const float* __restrict__ x, long long n, int ti,
                            int tj, const Own& o, int cg0, bool full4,
                            bool interior) {
  const LevelDesc& L = d.levels[0];
  const Origin g = origin(d, L, ti, tj);
  float4* dst = slot4(d, smem, d.in_slot);
  walk(o, L.eh, L.ew, [&](int p, int r, int c) {
    const int h = g.h + r, w = g.w + c;
    float4 v = f4(0.f);
    if (interior || (h >= 0 && h < d.H && w >= 0 && w < d.W))
      v = load4(x + ((n * d.H + h) * d.W + w) * (long long)d.C + cg0, cg0,
                d.C, full4);
    dst[p * o.nq + o.q] = v;
  });
}

// One element-wise op on the thread's elements of a level.
__device__ void pointwise_fwd4(const NhwcDesc& d, float* smem,
                               const OpDesc& op, int eh, int ew,
                               const Own& o) {
  float4* out = slot4(d, smem, op.out);
  const float4* A = op.a_src == SRC_SLOT ? slot4(d, smem, op.a_idx) : nullptr;
  const float4 av = A ? f4(0.f) : vec4(o.vs, d, op.a_idx, o.q);
  if (op.kind == K_AFFINE) {   // rounded after the multiply, as PyTorch's
    const float4 s = vec4(o.vs, d, op.b_idx, o.q);
    const float4 t = vec4(o.vs, d, op.c_idx, o.q);
    walk(o, eh, ew, [&](int p, int, int) {
      const int e = p * o.nq + o.q;
      out[e] = affine4(A ? A[e] : av, s, t);
    });
    return;
  }
  const bool bin = op.kind == K_BINARY;
  const float4* B =
      bin && op.b_src == SRC_SLOT ? slot4(d, smem, op.b_idx) : nullptr;
  const float4 bv = bin && !B ? vec4(o.vs, d, op.b_idx, o.q) : f4(0.f);
  with_fn(op, [&](auto f) {
    walk(o, eh, ew, [&](int p, int, int) {
      const int e = p * o.nq + o.q;
      const float4 a = A ? A[e] : av, b = B ? B[e] : bv;
      out[e] = make_float4(f(a.x, b.x), f(a.y, b.y), f(a.z, b.z),
                           f(a.w, b.w));
    });
  });
}

// POOL2D from level Li (origin g) into Lo, over the thread's outputs.
__device__ void pool_fwd4(const NhwcDesc& d, float* smem, const OpDesc& op,
                          const LevelDesc& Li, const LevelDesc& Lo, Origin g,
                          const Own& o, bool interior) {
  const float4* src = slot4(d, smem, op.a_idx);
  float4* dst = slot4(d, smem, op.out);
  const bool is_max = op.fn == P_MAX;
  const float4 neutral = f4(is_max ? -FLT_MAX : 0.f);
  walk(o, Lo.eh, Lo.ew, [&](int p, int r, int c) {
    float4 acc = neutral;
    for (int di = 0; di < op.kh; ++di) {
      const int hi = r * op.sh + di;
      const bool vh = interior || (g.h + hi >= 0 && g.h + hi < Li.ih);
      for (int dj = 0; dj < op.kw; ++dj) {
        const int wj = c * op.sw + dj;
        const bool valid =
            vh && (interior || (g.w + wj >= 0 && g.w + wj < Li.iw));
        const float4 v = valid ? src[(hi * Li.ew + wj) * o.nq + o.q]
                               : neutral;
        if (di == 0 && dj == 0) {
          acc = v;
        } else if (is_max) {
          acc = make_float4(nan_max(acc.x, v.x), nan_max(acc.y, v.y),
                            nan_max(acc.z, v.z), nan_max(acc.w, v.w));
        } else {
          acc = add4(acc, v);
        }
      }
    }
    if (!is_max) {
      const float k = (float)(op.kh * op.kw);
      acc = make_float4(acc.x / k, acc.y / k, acc.z / k, acc.w / k);
    }
    dst[p * o.nq + o.q] = acc;
  });
}

// The whole chain, level by level: element-wise ops on the thread's own
// elements (no barrier), a barrier before each pool (it reads
// neighbours), two around each row op (warp-per-position ownership).
__device__ void run_chain4(const NhwcDesc& d, float* smem, int ti, int tj,
                           const Own& o, bool interior) {
  int level = 0;
  for (int k = 0; k < d.n_ops; ++k) {
    const OpDesc& op = d.ops[k];
    const LevelDesc& L = d.levels[level];
    if (op.kind == K_POOL) {
      __syncthreads();
      pool_fwd4(d, smem, op, L, d.levels[level + 1], origin(d, L, ti, tj), o,
                interior);
      ++level;
    } else if (op.kind == K_NORM || op.kind == K_SOFTMAX) {
      __syncthreads();
      row_pass(d, smem, op, L.eh * L.ew);
      __syncthreads();
    } else {
      pointwise_fwd4(d, smem, op, L.eh, L.ew, o);
    }
  }
}

// ---------------------------------------------------------------------------
// The reverse sweep.
// ---------------------------------------------------------------------------

// The lane's partial of vector v, channels of quad q: += s.
__device__ __forceinline__ void acc_add(float* accs, const NhwcBwdDesc& b,
                                        const Own& o, int v, float4 s) {
  float4* row = reinterpret_cast<float4*>(
      accs + ((size_t)o.pl * b.n_vecs + v) * b.f.cb);
  row[o.q] = add4(row[o.q], s);
}

// Element-wise op: input cotangents of its slot operands and, on the valid
// positions, the sums of its vector operands' gradients.
__device__ void pointwise_bwd4(const NhwcBwdDesc& b, float* smem, float* accs,
                               const OpDesc& op, const BwdOpDesc& bo,
                               const LevelDesc& L, Origin g, const Own& o,
                               bool interior) {
  const NhwcDesc& d = b.f;
  const float4* G = slot4(d, smem, bo.g);
  const float4* A = op.a_src == SRC_SLOT ? slot4(d, smem, op.a_idx) : nullptr;
  const float4 av = A ? f4(0.f) : vec4(o.vs, d, op.a_idx, o.q);
  float4* DA = bo.da >= 0 ? slot4(d, smem, bo.da) : nullptr;
  float4* DB = bo.db >= 0 ? slot4(d, smem, bo.db) : nullptr;
  const bool a_vec = !A;
  const bool active = o.pl < o.lanes;
  if (op.kind == K_AFFINE) {
    const float4 s = vec4(o.vs, d, op.b_idx, o.q);
    float4 s_scale = f4(0.f), s_bias = f4(0.f), s_a = f4(0.f);
    walk(o, L.eh, L.ew, [&](int p, int r, int c) {
      const int e = p * o.nq + o.q;
      const float4 gv = G[e], a = A ? A[e] : av;
      const float4 da = mul4(gv, s);
      if (DA) put4(DA, e, da, bo.da_acc);
      if (interior || inside(L, g, r, c)) {
        s_scale = add4(s_scale, mul4(gv, a));
        s_bias = add4(s_bias, gv);
        s_a = add4(s_a, da);
      }
    });
    if (active) {
      if (op.b_idx >= 0) acc_add(accs, b, o, op.b_idx, s_scale);
      if (op.c_idx >= 0) acc_add(accs, b, o, op.c_idx, s_bias);
      if (a_vec) acc_add(accs, b, o, op.a_idx, s_a);
    }
    return;
  }
  const bool bin = op.kind == K_BINARY;
  const float4* B =
      bin && op.b_src == SRC_SLOT ? slot4(d, smem, op.b_idx) : nullptr;
  const float4 bv = bin && !B ? vec4(o.vs, d, op.b_idx, o.q) : f4(0.f);
  const bool b_vec = bin && !B;
  with_fn(op, [&](auto f) {
    float4 sa = f4(0.f), sb = f4(0.f);
    walk(o, L.eh, L.ew, [&](int p, int r, int c) {
      const int e = p * o.nq + o.q;
      const float4 gv = G[e], a = A ? A[e] : av, bb = B ? B[e] : bv;
      float4 da, db;
      f.vjp(a.x, bb.x, gv.x, da.x, db.x);
      f.vjp(a.y, bb.y, gv.y, da.y, db.y);
      f.vjp(a.z, bb.z, gv.z, da.z, db.z);
      f.vjp(a.w, bb.w, gv.w, da.w, db.w);
      if (DA) put4(DA, e, bo.same ? add4(da, db) : da, bo.da_acc);
      if (DB) put4(DB, e, db, bo.db_acc);
      if ((a_vec || b_vec) && (interior || inside(L, g, r, c))) {
        sa = add4(sa, da);
        sb = add4(sb, db);
      }
    });
    if (active) {
      if (a_vec) acc_add(accs, b, o, op.a_idx, sa);
      if (b_vec) acc_add(accs, b, o, op.b_idx, sb);
    }
  });
}

// The first window offset, in row-major order, holding the pooled value y
// (-1 where none does: a NaN), per channel.
__device__ __forceinline__ int4 first_max(const float4* src, float4 y,
                                          const OpDesc& op,
                                          const LevelDesc& Li, Origin g,
                                          int r, int c, const Own& o,
                                          bool interior) {
  int4 code = make_int4(-1, -1, -1, -1);
  for (int di = 0; di < op.kh; ++di) {
    const int hi = r * op.sh + di;
    for (int dj = 0; dj < op.kw; ++dj) {
      const int wj = c * op.sw + dj;
      const bool valid = interior || (g.h + hi >= 0 && g.h + hi < Li.ih &&
                                      g.w + wj >= 0 && g.w + wj < Li.iw);
      const float4 v = valid ? src[(hi * Li.ew + wj) * o.nq + o.q]
                             : f4(-FLT_MAX);
      const int k = di * op.kw + dj;
      if (code.x < 0 && v.x == y.x) code.x = k;
      if (code.y < 0 && v.y == y.y) code.y = k;
      if (code.z < 0 && v.z == y.z) code.z = k;
      if (code.w < 0 && v.w == y.w) code.w = k;
    }
  }
  return code;
}

// POOL2D whose windows do not overlap (window == stride): each thread takes
// its outputs' windows whole and writes every input position of them.
__device__ void pool_bwd_direct(const NhwcBwdDesc& b, float* smem,
                                const OpDesc& op, const BwdOpDesc& bo,
                                const LevelDesc& Li, const LevelDesc& Lo,
                                Origin g, const Own& o, bool interior) {
  const NhwcDesc& d = b.f;
  const float4* src = slot4(d, smem, op.a_idx);
  const float4* Y = slot4(d, smem, op.out);
  const float4* G = slot4(d, smem, bo.g);
  float4* DA = slot4(d, smem, bo.da);
  const bool is_max = op.fn == P_MAX;
  const float k_all = (float)(op.kh * op.kw);
  walk(o, Lo.eh, Lo.ew, [&](int p, int r, int c) {
    const int eo = p * o.nq + o.q;
    const float4 gv = G[eo];
    const int4 code = is_max ? first_max(src, Y[eo], op, Li, g, r, c, o,
                                         interior)
                             : make_int4(-1, -1, -1, -1);
    const float4 share = make_float4(gv.x / k_all, gv.y / k_all,
                                     gv.z / k_all, gv.w / k_all);
    for (int di = 0; di < op.kh; ++di) {
      const int hi = r * op.sh + di;
      for (int dj = 0; dj < op.kw; ++dj) {
        const int wj = c * op.sw + dj;
        const bool valid = interior || (g.h + hi >= 0 && g.h + hi < Li.ih &&
                                        g.w + wj >= 0 && g.w + wj < Li.iw);
        const int k = di * op.kw + dj;
        float4 s = share;
        if (is_max)
          s = make_float4(code.x == k ? gv.x : 0.f, code.y == k ? gv.y : 0.f,
                          code.z == k ? gv.z : 0.f, code.w == k ? gv.w : 0.f);
        put4(DA, (hi * Li.ew + wj) * o.nq + o.q, valid ? s : f4(0.f),
             bo.da_acc);
      }
    }
  });
}

// POOL2D whose windows overlap: the first maximum's offset is marked per
// output (in the pool's own output slot, dead by now), then each input
// position gathers, window offset by offset in row-major order.
__device__ void pool_bwd_gather(const NhwcBwdDesc& b, float* smem,
                                const OpDesc& op, const BwdOpDesc& bo,
                                const LevelDesc& Li, const LevelDesc& Lo,
                                Origin g, const Own& o, bool interior) {
  const NhwcDesc& d = b.f;
  const float4* src = slot4(d, smem, op.a_idx);
  float4* Y = slot4(d, smem, op.out);
  const float4* G = slot4(d, smem, bo.g);
  float4* DA = slot4(d, smem, bo.da);
  const bool is_max = op.fn == P_MAX;
  const float k_all = (float)(op.kh * op.kw);
  if (is_max) {
    walk(o, Lo.eh, Lo.ew, [&](int p, int r, int c) {
      const int eo = p * o.nq + o.q;
      const int4 code = first_max(src, Y[eo], op, Li, g, r, c, o, interior);
      Y[eo] = make_float4((float)code.x, (float)code.y, (float)code.z,
                          (float)code.w);
    });
    __syncthreads();
  }
  walk(o, Li.eh, Li.ew, [&](int p, int r, int c) {
    float4 s = f4(0.f);
    for (int di = 0; di < op.kh; ++di) {
      const int th = r - di;
      if (th < 0 || th % op.sh) continue;
      const int oi = th / op.sh;
      if (oi >= Lo.eh) continue;
      for (int dj = 0; dj < op.kw; ++dj) {
        const int tw = c - dj;
        if (tw < 0 || tw % op.sw) continue;
        const int oj = tw / op.sw;
        if (oj >= Lo.ew) continue;
        const int eo = (oi * Lo.ew + oj) * o.nq + o.q;
        const float4 gv = G[eo];
        if (is_max) {
          const float4 y = Y[eo];
          const float k = (float)(di * op.kw + dj);
          s = add4(s, make_float4(y.x == k ? gv.x : 0.f, y.y == k ? gv.y : 0.f,
                                  y.z == k ? gv.z : 0.f,
                                  y.w == k ? gv.w : 0.f));
        } else {
          s = add4(s, make_float4(gv.x / k_all, gv.y / k_all, gv.z / k_all,
                                  gv.w / k_all));
        }
      }
    }
    const bool valid = interior || inside(Li, g, r, c);
    put4(DA, p * o.nq + o.q, valid ? s : f4(0.f), bo.da_acc);
  });
}

// A norm's scale and bias gradients over the thread's valid positions (the
// scale terms row_bwd left in the scratch slot, zero where invalid).
__device__ void norm_vec_bwd4(const NhwcBwdDesc& b, float* smem, float* accs,
                              const OpDesc& op, const BwdOpDesc& bo,
                              const LevelDesc& L, Origin g, const Own& o,
                              bool interior) {
  const NhwcDesc& d = b.f;
  const float4* G = slot4(d, smem, bo.g);
  const float4* Sc = slot4(d, smem, b.scratch);
  float4 s_scale = f4(0.f), s_bias = f4(0.f);
  walk(o, L.eh, L.ew, [&](int p, int r, int c) {
    if (!(interior || inside(L, g, r, c))) return;
    const int e = p * o.nq + o.q;
    s_scale = add4(s_scale, Sc[e]);
    s_bias = add4(s_bias, G[e]);
  });
  if (o.pl < o.lanes) {
    acc_add(accs, b, o, op.b_idx, s_scale);
    if (op.c_idx >= 0) acc_add(accs, b, o, op.c_idx, s_bias);
  }
}

// ---------------------------------------------------------------------------
// The fused path: AFFINE -> UNARY -> POOL2D whose windows do not overlap
// (window == stride) and hold at most FUSED_WIN positions: batch norm, an
// activation and VGG's 2x2/s2 max pool.  Each output position runs in
// registers: its window's x, their affine and unary values, the pooled
// value and its first maximum, g, and the chain rule back to dx; the scale
// and bias gradients sum in registers over the CTA's items.  No slots, no
// barriers, no walk of the descriptor per op.
// ---------------------------------------------------------------------------

template <class U>
__device__ __forceinline__ void fused_item(
    const NhwcBwdDesc& b, const float* __restrict__ x,
    const float* __restrict__ gout, float* __restrict__ dx, long long n,
    int ti, int tj, const Own& o, int cg0, bool full4, bool interior, U u,
    float4& s_scale, float4& s_bias) {
  const NhwcDesc& d = b.f;
  const OpDesc& aff = d.ops[0];
  const OpDesc& pool = d.ops[2];
  const float4 sc = vec4(o.vs, d, aff.b_idx, o.q);
  const float4 of = vec4(o.vs, d, aff.c_idx, o.q);
  const LevelDesc& L1 = d.levels[1];
  const Origin g0 = origin(d, d.levels[0], ti, tj);
  const bool is_max = pool.fn == P_MAX;
  const int kw = pool.kw, nw = pool.kh * pool.kw;
  const float k_all = (float)nw;
  const float4 neutral = f4(is_max ? -FLT_MAX : 0.f);
  walk(o, L1.eh, L1.ew, [&](int, int r, int c) {
    const int oh = ti * d.th + r, ow = tj * d.tw + c;
    float4 gv = f4(0.f);                  // zero past the output's edge
    if (interior || (oh < d.OH && ow < d.OW))
      gv = load4(gout + ((n * d.OH + oh) * d.OW + ow) * (long long)d.C + cg0,
                 cg0, d.C, full4);
    float4 xv[FUSED_WIN], bv[FUSED_WIN], v[FUSED_WIN];
    bool ok[FUSED_WIN];
    long long off[FUSED_WIN];
#pragma unroll
    for (int k = 0; k < FUSED_WIN; ++k) {
      const int h = g0.h + r * pool.sh + k / kw;
      const int w = g0.w + c * pool.sw + k % kw;
      ok[k] = k < nw &&
              (interior || (h >= 0 && h < d.H && w >= 0 && w < d.W));
      off[k] = ((n * d.H + h) * d.W + w) * (long long)d.C + cg0;
      xv[k] = ok[k] ? load4(x + off[k], cg0, d.C, full4) : f4(0.f);
    }
    // the recompute: affine, unary, the pool (as pool_fwd4: a window
    // position outside the image reads the neutral element)
    float4 y = neutral;
#pragma unroll
    for (int k = 0; k < FUSED_WIN; ++k) {
      if (k >= nw) break;
      bv[k] = affine4(xv[k], sc, of);
      v[k] = ok[k] ? make_float4(u(bv[k].x, 0.f), u(bv[k].y, 0.f),
                                 u(bv[k].z, 0.f), u(bv[k].w, 0.f))
                   : neutral;
      if (k == 0)
        y = v[k];
      else if (is_max)
        y = make_float4(nan_max(y.x, v[k].x), nan_max(y.y, v[k].y),
                        nan_max(y.z, v[k].z), nan_max(y.w, v[k].w));
      else
        y = add4(y, v[k]);
    }
    int4 code = make_int4(-1, -1, -1, -1);   // the first maximum
#pragma unroll
    for (int k = 0; k < FUSED_WIN; ++k) {
      if (k >= nw || !is_max) break;
      if (code.x < 0 && v[k].x == y.x) code.x = k;
      if (code.y < 0 && v[k].y == y.y) code.y = k;
      if (code.z < 0 && v[k].z == y.z) code.z = k;
      if (code.w < 0 && v[k].w == y.w) code.w = k;
    }
    // the reverse: the pool's routing, the unary's derivative, the affine
#pragma unroll
    for (int k = 0; k < FUSED_WIN; ++k) {
      if (k >= nw) break;
      if (!ok[k]) continue;               // outside the image: zero
      const float4 du =
          is_max ? make_float4(code.x == k ? gv.x : 0.f,
                               code.y == k ? gv.y : 0.f,
                               code.z == k ? gv.z : 0.f,
                               code.w == k ? gv.w : 0.f)
                 : make_float4(gv.x / k_all, gv.y / k_all, gv.z / k_all,
                               gv.w / k_all);
      float4 db, unused;
      u.vjp(bv[k].x, 0.f, du.x, db.x, unused.x);
      u.vjp(bv[k].y, 0.f, du.y, db.y, unused.y);
      u.vjp(bv[k].z, 0.f, du.z, db.z, unused.z);
      u.vjp(bv[k].w, 0.f, du.w, db.w, unused.w);
      store4(dx + off[k], mul4(db, sc), cg0, d.C, full4);
      s_scale = add4(s_scale, mul4(db, xv[k]));
      s_bias = add4(s_bias, db);
    }
  });
}

// ---------------------------------------------------------------------------
// The two kernels.
// ---------------------------------------------------------------------------

// Floats of shared memory the CTA's copy of the descriptor takes (16-byte
// aligned): every op reads it, with run-time indices, and a run-time index
// into the kernel's parameter space misses the constant cache.
constexpr int DESC_FLOATS = ((int)sizeof(NhwcBwdDesc) + 15) / 16 * 4;

// What a CTA sets up: the descriptor copied into shared memory, the
// thread's share (its channel block: CTA p keeps block p % n_cb), the
// per-lane gradient partials (zeroed) and the vector operands at the
// channel block.  Shared memory: the descriptor, the slots, the partials,
// the vectors.
struct Cta {
  const NhwcBwdDesc* b;
  float* slots;
  float* accs;
  Own o;
  int cg0, stride;
  bool full4;
};

__device__ Cta cta_setup(const NhwcBwdDesc& desc, float* smem_all) {
  {
    const int* src = reinterpret_cast<const int*>(&desc);
    int* dst = reinterpret_cast<int*>(smem_all);
    for (int i = threadIdx.x; i < (int)(sizeof(NhwcBwdDesc) / 4);
         i += THREADS)
      dst[i] = src[i];
  }
  Cta t;
  t.b = reinterpret_cast<const NhwcBwdDesc*>(smem_all);
  const NhwcDesc& d = desc.f;
  t.slots = smem_all + DESC_FLOATS;
  t.accs = t.slots + (size_t)d.n_slots * d.slot_elems;
  const int n_acc = desc.lanes * desc.n_vecs * d.cb;
  for (int i = threadIdx.x; i < n_acc; i += THREADS) t.accs[i] = 0.f;
  const int cblk = blockIdx.x % d.n_cb;
  float* vs = t.accs + n_acc;             // [n_vecs][cb]
  for (int i = threadIdx.x; i < desc.n_vecs * d.cb; i += THREADS)
    vs[i] = vec(d, i / d.cb, cblk * d.cb + i % d.cb);
  t.o.nq = d.cb / 4;
  t.o.q = threadIdx.x % t.o.nq;
  t.o.lanes = desc.lanes;
  t.o.pl = (int)threadIdx.x / t.o.nq < desc.lanes
               ? (int)threadIdx.x / t.o.nq : INT_MAX / 2;
  t.o.vs = vs;
  t.cg0 = cblk * d.cb + 4 * t.o.q;
  t.full4 = desc.vec4 && t.cg0 + 3 < d.C;
  t.stride = gridDim.x / d.n_cb;
  __syncthreads();
  return t;
}

// The lanes' partials, summed in lane order, are the CTA's.
__device__ void cta_finish(const Cta& t, float* __restrict__ partials) {
  const NhwcBwdDesc& b = *t.b;
  __syncthreads();
  float* mine = partials + (size_t)blockIdx.x * b.n_vecs * b.f.cb;
  for (int i = threadIdx.x; i < b.n_vecs * b.f.cb; i += THREADS) {
    float s = 0.f;
    for (int l = 0; l < b.lanes; ++l)
      s += t.accs[(size_t)l * b.n_vecs * b.f.cb + i];
    mine[i] = s;
  }
}

// Any chain: the descriptor walked op by op over slots in shared memory.
__global__ void __launch_bounds__(THREADS, 2)
fused_nhwc_bwd_kernel(const __grid_constant__ NhwcBwdDesc desc,
                      const float* __restrict__ x,
                      const float* __restrict__ gout, float* __restrict__ dx,
                      float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem_all[];
  const Cta t = cta_setup(desc, smem_all);
  const NhwcBwdDesc& b = *t.b;
  const NhwcDesc& d = b.f;
  const Own& o = t.o;
  float* smem = t.slots;
  const int cg0 = t.cg0;
  const bool full4 = t.full4;
  const LevelDesc& L0 = d.levels[0];
  const LevelDesc& Lout = d.levels[d.n_levels - 1];

  for (int s = blockIdx.x / d.n_cb; s < b.spatial; s += t.stride) {
    long long n;
    int ti, tj;
    const bool interior = decode_item(d, s, n, ti, tj);

    __syncthreads();              // the previous item is done with smem
    load_patch4(d, smem, x, n, ti, tj, o, cg0, full4, interior);
    run_chain4(d, smem, ti, tj, o, interior);
    {  // the output cotangent; zero past the output's edge
      float4* G = slot4(d, smem, b.g_slot);
      walk(o, Lout.eh, Lout.ew, [&](int p, int r, int c) {
        const int oh = ti * d.th + r, ow = tj * d.tw + c;
        float4 v = f4(0.f);
        if (interior || (oh < d.OH && ow < d.OW))
          v = load4(gout + ((n * d.OH + oh) * d.OW + ow) * (long long)d.C +
                        cg0, cg0, d.C, full4);
        G[p * o.nq + o.q] = v;
      });
    }

    for (int k = d.n_ops - 1; k >= 0; --k) {
      const OpDesc& op = d.ops[k];
      const BwdOpDesc& bo = b.bops[k];
      if (bo.g < 0) continue;
      const bool pool = op.kind == K_POOL;
      const LevelDesc& Li = d.levels[bo.level];
      const LevelDesc& Lo = d.levels[bo.level + (pool ? 1 : 0)];
      const Origin gi = origin(d, Li, ti, tj);
      if (!interior) {  // the op's output cotangent is zero outside the image
        const Origin go = origin(d, Lo, ti, tj);
        float4* G = slot4(d, smem, bo.g);
        walk(o, Lo.eh, Lo.ew, [&](int p, int r, int c) {
          if (!inside(Lo, go, r, c)) G[p * o.nq + o.q] = f4(0.f);
        });
      }
      if (pool) {
        __syncthreads();
        if (op.kh == op.sh && op.kw == op.sw)
          pool_bwd_direct(b, smem, op, bo, Li, Lo, gi, o, interior);
        else
          pool_bwd_gather(b, smem, op, bo, Li, Lo, gi, o, interior);
        __syncthreads();
      } else if (op.kind == K_NORM || op.kind == K_SOFTMAX) {
        __syncthreads();
        row_bwd(b, smem, op, bo, Li, gi.h, gi.w);
        __syncthreads();
        if (op.kind == K_NORM && op.b_idx >= 0)
          norm_vec_bwd4(b, smem, t.accs, op, bo, Li, gi, o, interior);
      } else {
        pointwise_bwd4(b, smem, t.accs, op, bo, Li, gi, o, interior);
      }
    }

    {  // the primary input's cotangent: a private patch, or dx itself
      const float4* src = b.dx_slot >= 0 ? slot4(d, smem, b.dx_slot) : nullptr;
      const Origin g = origin(d, L0, ti, tj);
      const long long patch =
          ((n * d.tiles_h + ti) * d.tiles_w + tj) * (long long)(L0.eh * L0.ew);
      walk(o, L0.eh, L0.ew, [&](int p, int r, int c) {
        const float4 v = src ? src[p * o.nq + o.q] : f4(0.f);
        if (b.patches) {
          store4(dx + (patch + p) * d.C + cg0, v, cg0, d.C, full4);
        } else {
          const int h = g.h + r, w = g.w + c;
          if (interior || (h >= 0 && h < d.H && w >= 0 && w < d.W))
            store4(dx + ((n * d.H + h) * d.W + w) * (long long)d.C + cg0, v,
                   cg0, d.C, full4);
        }
      });
    }
  }
  cta_finish(t, partials);
}

// The fused path (desc.fused): AFFINE -> UNARY -> POOL2D, window == stride.
__global__ void __launch_bounds__(THREADS, 2)
fused_nhwc_bwd_kernel_fused(const __grid_constant__ NhwcBwdDesc desc,
                            const float* __restrict__ x,
                            const float* __restrict__ gout,
                            float* __restrict__ dx,
                            float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem_all[];
  const Cta t = cta_setup(desc, smem_all);
  const NhwcBwdDesc& b = *t.b;
  const NhwcDesc& d = b.f;
  with_fn(d.ops[1], [&](auto u) {
    float4 s_scale = f4(0.f), s_bias = f4(0.f);
    for (int s = blockIdx.x / d.n_cb; s < b.spatial; s += t.stride) {
      long long n;
      int ti, tj;
      const bool interior = decode_item(d, s, n, ti, tj);
      fused_item(b, x, gout, dx, n, ti, tj, t.o, t.cg0, t.full4, interior, u,
                 s_scale, s_bias);
    }
    if (t.o.pl < t.o.lanes) {
      acc_add(t.accs, b, t.o, d.ops[0].b_idx, s_scale);
      acc_add(t.accs, b, t.o, d.ops[0].c_idx, s_bias);
    }
  });
  cta_finish(t, partials);
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

// out[v, c] = the sum, over the CTAs that own c's channel block (c / cb,
// then every n_cb-th CTA), of their partials at c; a vector of one value
// (vec_stride 0) sums all its channels into out[v, 0].
__global__ void nhwc_reduce_kernel(const __grid_constant__ NhwcBwdDesc b,
                                   int programs,
                                   const float* __restrict__ partials,
                                   float* __restrict__ out) {
  const NhwcDesc& d = b.f;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b.n_vecs * d.C) return;
  const int v = i / d.C, c = i % d.C;
  auto owned = [&](int cc) {
    const int blk = cc / d.cb, cl = cc - blk * d.cb;
    float s = 0.f;
    for (int p = blk; p < programs; p += d.n_cb)
      s += partials[((long long)p * b.n_vecs + v) * d.cb + cl];
    return s;
  };
  float s = 0.f;
  if (d.vec_stride[v]) {
    s = owned(c);
  } else if (c == 0) {
    for (int cc = 0; cc < d.C; ++cc) s += owned(cc);
  }
  out[i] = s;
}

extern "C" {

int fused_nhwc_bwd_desc_size() { return (int)sizeof(NhwcBwdDesc); }

const char* fused_nhwc_bwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The kernel that runs descriptor b.
using BwdKernel = void (*)(NhwcBwdDesc, const float*, const float*, float*,
                           float*);

static BwdKernel bwd_kernel(const NhwcBwdDesc* b) {
  return b->fused ? fused_nhwc_bwd_kernel_fused : fused_nhwc_bwd_kernel;
}

// The descriptor's copy, slots, per-lane gradient partials, the vector
// operands' block.
static size_t bwd_smem(const NhwcBwdDesc* b) {
  return ((size_t)DESC_FLOATS + (size_t)b->f.n_slots * b->f.slot_elems +
          (size_t)(b->lanes + 1) * b->n_vecs * b->f.cb) * sizeof(float);
}

// CTAs of the backward kernel that fit one SM at once with this
// descriptor's shared memory, or minus a cudaError_t.
int fused_nhwc_bwd_ctas_per_sm(const NhwcBwdDesc* b) {
  const size_t smem = bwd_smem(b);
  const BwdKernel kernel = bwd_kernel(b);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return -(int)e;
  return per_sm;
}

// Launches the three kernels on `stream`; returns the first cudaError_t
// (0: all queued).  `programs` is a multiple of n_cb (the launch plan's).
// On the direct path the caller zeroes dx first where the tiles' input
// regions leave positions uncovered.
int fused_nhwc_bwd_launch(const NhwcBwdDesc* b, int programs, const float* x,
                          const float* g, float* dx, float* patches,
                          float* partials, float* dvecs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = bwd_smem(b);
  const BwdKernel kernel = bwd_kernel(b);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<programs, THREADS, smem, s>>>(*b, x, g,
                                         b->patches ? patches : dx, partials);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
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
