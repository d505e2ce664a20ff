// Depth-first fused kernel for nhwc-layout BrainSlug stacks, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/fused_stack/nhwc.py:
// fused_nhwc_call.  One CTA produces one (th, tw, cb) output patch of one
// image: it loads the halo-grown input patch into shared memory and runs the
// whole chain of POOL2D / AFFINE / EW_UNARY / EW_BINARY / ROW_NORM /
// ROW_SOFTMAX ops on it, level by level, then writes the patch once.
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
// Bound: device-memory bytes (see nhwc.py).  Plain loads, float32.
//
// The descriptor, the op semantics and the tile recompute are in
// fused_nhwc.cuh, shared with the backward (fused_nhwc_bwd.cu).

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

}  // extern "C"
