// Paged flash decode: one new query position against a block-mapped KV
// pool, read through a per-slot block table and masked by per-slot lengths.
//
// Replaces repro/kernels/attention/decode.py:paged_flash_decode (the Pallas
// kernel).  The Pallas grid walks one pool block per step, routed by a
// scalar-prefetched table (its BlockSpec index maps gather
// pool[table[b, j]]), and carries the online-softmax state in VMEM
// scratch.
//
// The chains, the split over CTAs (a cluster a slot and head), the staging
// ring and the merge are decode_chain.cuh's, which flash_decode.cu runs
// too, so on a gathered view the two kernels agree bit for bit by
// construction.  What is this kernel's own is where a key row lies: the
// slot's table row comes into shared memory once (cp.async, 4 bytes an
// entry), and a chain keeps a block and row cursor that advances without
// a division, reading the table once a block: logical key p of KV head g
// is read at
//   pool + ((tbl[p / bs] * G + g) * bs + p % bs) * D.
// A pool block is bs * D contiguous elements of one KV head: the chains of
// a CTA read consecutive rows of it.
//
// Semantics kept from the Pallas kernel: GQA maps query head h to KV head
// h / (H / G); table entries are clamped to [0, N-1] (a sentinel tail
// entry, or a freed slot's stale table, never reads out of the pool); q and
// every K / V element are rounded to the query's dtype, then widened to
// float32 (a float32 pool is staged as float32 and rounded on read); keys
// at logical positions >= min(lengths[b], MB * bs) are masked, and not read
// at all (each would add exp(-1e30 - m) = 0); a slot with length 0 writes
// exact zeros; o = acc / max(l, 1e-30), cast to the query's dtype.
//
// Bound on the H100: device-memory bytes, the valid keys' K and V rows read
// once (a few operations a byte).  A CTA that serves all the query heads
// of a KV head from one staged block is later work.
//
// This file builds D = 64, 112, 128 and 256, each at the three dtype pairs
// and five splits.
#include "decode_chain.cuh"

namespace {

using chain::CHAINS;
using chain::LANES;

__host__ __device__ constexpr size_t table_bytes(int MB) {
  return ((size_t)MB * sizeof(int) + 15) / 16 * 16;
}

// Dynamic shared memory: the table row, then the ring.
template <typename TKV, int CPS, int D>
size_t smem_bytes(int MB) {
  return table_bytes(MB) + chain::ring_bytes<TKV, CPS, D>();
}

// A chain's rows through the staged table row: block pj, row pr of its next
// key, and the addresses of the block it is in.
template <typename TKV, int D>
struct PagedRows {
  const int* tbl;                         // the slot's table row (shared)
  const TKV* k_pool;
  const TKV* v_pool;
  int64_t block_stride;                   // one pool block: G * bs * D
  int64_t head_off;                       // g * bs * D + the lane's column
  int N, bs, dj, dr;                      // a step in (block, row)
  int pj, pr, cur_j;
  const TKV* kbase;
  const TKV* vbase;

  __device__ __forceinline__ void locate(const TKV*& kp, const TKV*& vp) {
    if (pj != cur_j) {                    // a new block: its table entry
      cur_j = pj;
      const int64_t at = min(max(tbl[pj], 0), N - 1) * block_stride +
                         head_off;
      kbase = k_pool + at;
      vbase = v_pool + at;
    }
    const int64_t row = (int64_t)pr * D;
    kp = kbase + row;
    vp = vbase + row;
  }
  __device__ __forceinline__ void advance() {
    pr += dr;
    pj += dj;
    if (pr >= bs) {
      pr -= bs;
      ++pj;
    }
  }
};

template <typename TQ, typename TKV, int CPS, int D>
__global__ void __launch_bounds__(CPS * LANES)
    paged_flash_decode_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ k_pool,
                              const TKV* __restrict__ v_pool,
                              const int* __restrict__ table,
                              const int* __restrict__ lengths,
                              TQ* __restrict__ o, int H, int N, int G,
                              int bs, int MB, float scale) {
  constexpr int THREADS = CPS * LANES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int len = min(max(lengths[b], 0), MB * bs);
  if (!chain::cta_takes_part<TQ, CPS, D>(len, o + (int64_t)bh * D)) return;

  int* tbl = reinterpret_cast<int*>(smem);
  TKV* ring = reinterpret_cast<TKV*>(smem + table_bytes(MB));
  {
    const int used = (len + bs - 1) / bs; // table entries the keys read
    const int* row = table + (int64_t)b * MB;
    for (int j = threadIdx.x; j < used; j += THREADS)
      chain::cp_async4(tbl + j, row + j);
    chain::cp_async_commit();
    chain::cp_async_wait<0>();
    __syncthreads();
  }

  const int g = h / (H / G);
  const int lane = threadIdx.x % LANES;
  const int c = blockIdx.x * CPS + threadIdx.x / LANES;   // the chain
  // a lane past D reads nothing; its address stays inside the row
  constexpr int EL = chain::lane_elems<D>();
  const int col = lane * EL < D ? lane * EL : 0;
  PagedRows<TKV, D> rows{tbl, k_pool, v_pool, (int64_t)G * bs * D,
                         (int64_t)g * bs * D + col, N, bs,
                         CHAINS / bs, CHAINS % bs, c / bs, c % bs, -1,
                         k_pool, v_pool};
  chain::walk<TQ, TKV, CPS, D>(q, o, bh, len, scale, ring, rows);
}

// The launch and the occupancy query as functors of an instance.
struct Launch {
  const void *q, *k, *v;
  const int *table, *lengths;
  void* o;
  int B, H, N, G, bs, MB;
  float scale;
  cudaStream_t s;
  template <typename TQ, typename TKV, int CPS, int D>
  int operator()() const {
    return chain::launch_clusters<CPS>(
        paged_flash_decode_kernel<TQ, TKV, CPS, D>, dim3(CHAINS / CPS, H, B),
        smem_bytes<TKV, CPS, D>(MB), s, static_cast<const TQ*>(q),
        static_cast<const TKV*>(k), static_cast<const TKV*>(v), table,
        lengths, static_cast<TQ*>(o), H, N, G, bs, MB, scale);
  }
};

struct Occupancy {
  int MB;
  template <typename TQ, typename TKV, int CPS, int D>
  int operator()() const {
    return chain::ctas_per_sm<CPS>(
        paged_flash_decode_kernel<TQ, TKV, CPS, D>,
        smem_bytes<TKV, CPS, D>(MB));
  }
};

}  // namespace

// q (B, H, 1, D); k_pool / v_pool (N, G, bs, D), 16-byte aligned; table
// (B, MB) int32; lengths (B,) int32; o (B, H, 1, D).  splits: CTAs a (slot,
// head), one of 1, 2, 4, 8, 16 (decode.py:launch_plan's).  q_dtype /
// kv_dtype: 0 float32, 1 bfloat16 (a float32 query reads a float32 pool; a
// bf16 query either).  D must be 64, 112, 128 or 256.  Returns a
// cudaError_t, or -1 for a shape, dtype, split or geometry this build has
// no instance of.
extern "C" int paged_flash_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const int* table,
                                  const int* lengths, void* o, int B, int H,
                                  int N, int G, int bs, int MB, int D,
                                  float scale, int q_dtype, int kv_dtype,
                                  int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bs < 1 || MB < 1 || N < 1 || B < 1 || H < 1) return -1;
  return chain::by_head_dim(
      D, splits, q_dtype, kv_dtype,
      Launch{q, k_pool, v_pool, table, lengths, o, B, H, N, G, bs, MB, scale,
             s});
}

// CTAs of the instance for (splits, dtypes, D) that one SM holds at once
// with a table of MB entries (the occupancy API's), or minus a cudaError_t,
// or -1.
extern "C" int paged_flash_decode_ctas_per_sm(int splits, int q_dtype,
                                              int kv_dtype, int MB, int D) {
  return chain::by_head_dim(D, splits, q_dtype, kv_dtype, Occupancy{MB});
}

extern "C" const char* paged_flash_decode_error(int code) {
  return code < 0 ? "no instance for this head dim, dtype, split or geometry"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
