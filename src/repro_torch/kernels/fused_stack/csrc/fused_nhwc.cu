// Depth-first fused kernels for nhwc-layout BrainSlug stacks, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/fused_stack/nhwc.py:
// fused_nhwc_call.  Two kernels:
//
// 1. fused_nhwc_kernel_fused: the chain AFFINE -> UNARY -> POOL2D with
//    window == stride (batch norm, an activation, VGG's 2x2/s2 max pool;
//    nhwc.fused_chain).  Persistent: CTA p keeps channel block p % n_cb and
//    walks the spatial items (image, 8 x 8 output tile) of nhwc.fused_plan,
//    the plan the backward's fused path takes.  Thread (lane, quad) holds
//    channels 4 quad .. 4 quad + 3 of the block (a float4) and output
//    positions lane, lane + lanes, ...; for each it loads its window's <= 4
//    float4s straight from x (windows do not overlap: each input element
//    is read once), applies the affine (rounded after the multiply), the
//    unary op and the pool in registers, positions outside the image taking
//    the pool's neutral element as pool_pass masks them, and stores one
//    float4.  The CTA holds its block's scale and offset in registers.  No
//    slots, no barriers.  The arithmetic is the generic kernel's, element
//    for element.
// 2. fused_nhwc_kernel: any other chain.  One CTA produces one (th, tw, cb)
//    output patch of one image: it loads the halo-grown input patch into
//    shared memory and runs the whole chain of POOL2D / AFFINE / EW_UNARY /
//    EW_BINARY / ROW_NORM / ROW_SOFTMAX ops on it, level by level, then
//    writes the patch once.  Each item pays a fixed cost of descriptor reads
//    and passes over 1-4 positions a thread between barriers.
//
// The chain is data (NhwcDesc, passed by value as a __grid_constant__), so
// one build serves every stack.  Values live in shared-memory "slots" of
// slot_elems floats; the host assigns slots (nhwc.py:compile_chain).  The
// element of position p, channel c of a level is at p * cb + c.
//
// Passes and barriers.  Element-wise ops run in one pass per run of them, in
// which thread t owns elements t, t + THREADS, ...; the load, pool and store
// passes use the same ownership, so a run of element-wise ops needs no
// barrier against the pass before or after it.  A pool reads neighbours and
// a row op (ROW_NORM / ROW_SOFTMAX over C, one warp per position) reads a
// whole position, so both sit between two __syncthreads.
//
// Bound: device-memory bytes (see nhwc.py): x read once, the output
// written once.  Float32.
//
// The descriptor, the op semantics, the tile recompute and the position
// walk are in fused_nhwc.cuh, shared with the backward (fused_nhwc_bwd.cu).

#include "fused_nhwc.cuh"

__global__ void __launch_bounds__(THREADS)
fused_nhwc_kernel(const __grid_constant__ NhwcDesc d,
                  const float* __restrict__ x, float* __restrict__ out) {
  extern __shared__ float smem[];
  int b = blockIdx.x;
  const int cblk = b % d.n_cb;
  b /= d.n_cb;
  const int tj = b % d.tiles_w, ti = b / d.tiles_w;
  const long long n = blockIdx.y;
  const int cb = d.cb, c0 = cblk * cb;

  load_patch(d, smem, x, n, ti, tj, c0);
  run_chain(d, smem, ti, tj, c0);

  // The last level is the (th, tw) output patch; guard the image edge.
  {
    const float* src = smem + d.out_slot * d.slot_elems;
    const int n_elems = d.th * d.tw * cb;
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      const int c = e % cb, p = e / cb;
      const int oh = ti * d.th + p / d.tw, ow = tj * d.tw + p % d.tw;
      const int cg = c0 + c;
      if (oh < d.OH && ow < d.OW && cg < d.C)
        out[((n * d.OH + oh) * d.OW + ow) * d.C + cg] = src[e];
    }
  }
}

// The unary op as a type, so the fused kernel dispatches once.
template <int FN>
struct UnaryFn {
  __device__ __forceinline__ float operator()(float x) const {
    return unary(FN, x);
  }
};

template <class Body>
__device__ __forceinline__ void with_unary(int fn, Body body) {
  switch (fn) {
    case U_RELU: body(UnaryFn<U_RELU>()); return;
    case U_RELU6: body(UnaryFn<U_RELU6>()); return;
    case U_SQUARED_RELU: body(UnaryFn<U_SQUARED_RELU>()); return;
    case U_GELU: body(UnaryFn<U_GELU>()); return;
    case U_GELU_EXACT: body(UnaryFn<U_GELU_EXACT>()); return;
    case U_SILU: body(UnaryFn<U_SILU>()); return;
    case U_SIGMOID: body(UnaryFn<U_SIGMOID>()); return;
    case U_TANH: body(UnaryFn<U_TANH>()); return;
    case U_EXP: body(UnaryFn<U_EXP>()); return;
    case U_ABS: body(UnaryFn<U_ABS>()); return;
    case U_SQUARE: body(UnaryFn<U_SQUARE>()); return;
    case U_IDENTITY: body(UnaryFn<U_IDENTITY>()); return;
    case U_NEG: body(UnaryFn<U_NEG>()); return;
    case U_SOFTPLUS: body(UnaryFn<U_SOFTPLUS>()); return;
  }
}

template <class U>
__device__ __forceinline__ float4 unary4(U u, float4 b) {
  return make_float4(u(b.x), u(b.y), u(b.z), u(b.w));
}

// One item of the fused path: every output position of the tile that lies
// in the output, its window, the affine, the unary op and the pool.
template <class U>
__device__ __forceinline__ void fused_fwd_item(
    const NhwcDesc& d, const float* __restrict__ x, float* __restrict__ out,
    long long n, int ti, int tj, const Own& o, int cg0, bool full4,
    bool interior, U u, float4 sc, float4 of) {
  const OpDesc& pool = d.ops[2];
  const LevelDesc& L1 = d.levels[1];
  const Origin g0 = origin(d, d.levels[0], ti, tj);
  const bool is_max = pool.fn == P_MAX;
  const int kw = pool.kw, nw = pool.kh * pool.kw;
  const float4 neutral = f4(is_max ? -FLT_MAX : 0.f);
  walk(o, L1.eh, L1.ew, [&](int, int r, int c) {
    const int oh = ti * d.th + r, ow = tj * d.tw + c;
    if (!interior && (oh >= d.OH || ow >= d.OW)) return;  // past the edge
    float4 xv[FUSED_WIN];
    bool ok[FUSED_WIN];
#pragma unroll
    for (int k = 0; k < FUSED_WIN; ++k) {
      const int h = g0.h + r * pool.sh + k / kw;
      const int w = g0.w + c * pool.sw + k % kw;
      ok[k] = k < nw &&
              (interior || (h >= 0 && h < d.H && w >= 0 && w < d.W));
      xv[k] = ok[k] ? load4(x + ((n * d.H + h) * d.W + w) * (long long)d.C +
                                cg0, cg0, d.C, full4)
                    : f4(0.f);
    }
    // as pointwise_pass and pool_pass: a window position outside the
    // image reads the neutral element; max in row-major window order
    float4 y = neutral;
#pragma unroll
    for (int k = 0; k < FUSED_WIN; ++k) {
      if (k >= nw) break;
      const float4 v = ok[k] ? unary4(u, affine4(xv[k], sc, of)) : neutral;
      if (k == 0)
        y = v;
      else if (is_max)
        y = make_float4(nan_max(y.x, v.x), nan_max(y.y, v.y),
                        nan_max(y.z, v.z), nan_max(y.w, v.w));
      else
        y = add4(y, v);
    }
    if (!is_max) {
      const float k_all = (float)nw;
      y = make_float4(y.x / k_all, y.y / k_all, y.z / k_all, y.w / k_all);
    }
    store4(out + ((n * d.OH + oh) * d.OW + ow) * (long long)d.C + cg0, y,
           cg0, d.C, full4);
  });
}

// The fused path (nhwc.fused_chain): AFFINE -> UNARY -> POOL2D, window ==
// stride.  vec4: C % 4 == 0 and x, out 16-byte aligned.
__global__ void __launch_bounds__(THREADS)
fused_nhwc_kernel_fused(const __grid_constant__ NhwcDesc d,
                        const float* __restrict__ x,
                        float* __restrict__ out, int vec4) {
  const int cblk = blockIdx.x % d.n_cb;
  Own o;
  o.nq = d.cb / 4;
  o.q = threadIdx.x % o.nq;
  o.lanes = THREADS / o.nq;
  o.pl = (int)threadIdx.x / o.nq < o.lanes ? (int)threadIdx.x / o.nq
                                           : INT_MAX / 2;
  o.vs = nullptr;
  const int cg0 = cblk * d.cb + 4 * o.q;
  const bool full4 = vec4 && cg0 + 3 < d.C;
  const OpDesc& aff = d.ops[0];
  const float4 sc = make_float4(vec(d, aff.b_idx, cg0),
                                vec(d, aff.b_idx, cg0 + 1),
                                vec(d, aff.b_idx, cg0 + 2),
                                vec(d, aff.b_idx, cg0 + 3));
  const float4 of = make_float4(vec(d, aff.c_idx, cg0),
                                vec(d, aff.c_idx, cg0 + 1),
                                vec(d, aff.c_idx, cg0 + 2),
                                vec(d, aff.c_idx, cg0 + 3));
  const int spatial = d.N * d.tiles_h * d.tiles_w;
  const int stride = gridDim.x / d.n_cb;
  with_unary(d.ops[1].fn, [&](auto u) {
    for (int s = blockIdx.x / d.n_cb; s < spatial; s += stride) {
      long long n;
      int ti, tj;
      const bool interior = decode_item(d, s, n, ti, tj);
      fused_fwd_item(d, x, out, n, ti, tj, o, cg0, full4, interior, u, sc,
                     of);
    }
  });
}

extern "C" {

int fused_nhwc_desc_size() { return (int)sizeof(NhwcDesc); }

const char* fused_nhwc_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches on `stream`; returns the cudaError_t of the launch (0: queued).
int fused_nhwc_launch(const NhwcDesc* d, const float* x, float* out,
                      void* stream) {
  const size_t smem = (size_t)d->n_slots * d->slot_elems * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_nhwc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(d->tiles_h * d->tiles_w * d->n_cb, d->N);
  fused_nhwc_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(*d, x,
                                                                    out);
  return (int)cudaGetLastError();
}

// CTAs of the fused kernel one SM holds at once, or minus a cudaError_t.
int fused_nhwc_fused_ctas_per_sm() {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_nhwc_kernel_fused, THREADS, 0);
  return e == cudaSuccess ? per_sm : -(int)e;
}

// Launches the fused path on `stream` over `programs` persistent CTAs (a
// multiple of n_cb: nhwc.launch_programs); returns the cudaError_t of the
// launch (0: queued).
int fused_nhwc_fused_launch(const NhwcDesc* d, int programs, const float* x,
                            float* out, int vec4, void* stream) {
  fused_nhwc_kernel_fused<<<programs, THREADS, 0, (cudaStream_t)stream>>>(
      *d, x, out, vec4);
  return (int)cudaGetLastError();
}

}  // extern "C"
