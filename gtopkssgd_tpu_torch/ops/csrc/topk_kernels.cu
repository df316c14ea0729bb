// Top-k selection kernels for Hopper (sm_90a), bound to Python via ctypes
// (gtopkssgd_tpu_torch/ops/cuda_topk.py). Plain C interface: no PyTorch
// headers, so nvcc builds this file in seconds.
//
// Three kernels replace the three Pallas TPU kernels of
// gtopkssgd_tpu/ops/pallas_topk.py. The count kernel (1) and the
// multisection kernel (3) both serve `multi_threshold_count` and
// `fused_multi_threshold_count`: (1) is the one-for-one port of one count
// pass, (3) runs all four rounds of the tau search that calls it.
//
// 1. count_kernel -- replaces `multi_threshold_count` (_count_kernel,
//    pallas_topk.py:59-113) and `fused_multi_threshold_count`
//    (pallas_topk.py:279-331): counts[i] = #{j : v[j] >= thr[i]} for 8
//    thresholds in one pass, where v is x (MODE_RAW), |x| (MODE_ABS) or
//    |grad + residual| (MODE_RESIDUAL, acc never stored).
//    Bound: bytes. It reads 4 B (or 8 B with a residual) per element and
//    does 8-10 operations on it, far below the card's 67 TFLOP/s fp32 rate
//    per 3.35 TB/s; at N = 272,474 with a residual that is 2.2 MB = 0.65 us,
//    at N = 25.6M 205 MB = 61 us. Below a few us a launch costs more.
//    Design: a grid-stride loop with coalesced loads, thresholds in
//    registers, 8 per-thread counters reduced across the warp with
//    shuffles, then across the block in shared memory, then ONE integer
//    atomicAdd per threshold per block into counts[8] (zeroed by the
//    wrapper). The TPU kernel accumulated across its sequential grid in
//    SMEM; GPU blocks run in any order, and integer atomics keep the sum
//    exact and deterministic.
//
// 2. stage1_kernel -- replaces `fused_stage1_candidates`
//    (_make_stage1_kernel, pallas_topk.py:134-276): for every bucket
//    (tile, row-group, lane) of the 2048x128 tile layout, the max-|acc|
//    element (acc = grad [+ residual]) as a signed value and its global
//    flat index, first maximum row winning ties; optionally the same 8
//    counts in the same pass. NaN rule: a NaN |acc| counts as the largest
//    magnitude (as torch.argmax and jnp.argmax take it), the first NaN row
//    of a bucket wins and its NaN is the candidate value; a NaN is never
//    counted (NaN >= thr is false). Every index stays in [0, n) or marks
//    a padding bucket, whatever the data.
//    Bound: bytes, 8 B per element read (grad + residual) plus 8 B per
//    bucket written: 0.69 us at N = 272,474 and 62.95 us at N = 25,557,032
//    (groups 64) on 3.35 TB/s. At the small size a launch costs more.
//    Design: a bucket is rpg = 2048/groups elements 128 floats apart, and
//    the rpg*128 floats of one (tile, row-group) -- a slab -- are
//    contiguous. A block of 8 warps takes a span: one slab split into 8
//    contiguous row ranges, one a warp (rpg >= 8), or 8/rpg whole slabs,
//    one warp a row (rpg < 8). Within a row a warp's 32 threads read 4
//    lanes each as one 16-byte load of g and one of r, and a thread issues
//    the loads of 4 rows (STAGE1_BATCH) before it compares any: on the
//    main path (rpg = 32) each thread has 4 rows x 2 operands x 16 B in
//    flight, the block its whole 32 KB span in one trip to memory. Each
//    thread keeps, per lane, the largest |acc|, its signed value and its
//    row (strict '>', rows ascending: the first maximum); then the block's
//    threads, one (slab, lane) each, combine the warps in shared memory,
//    larger magnitude first and on equal magnitudes the smaller ROW, and
//    write. Index tile*262144 + (g*rpg + row)*128 + lane, as on the TPU. A
//    span wholly past n loads nothing and writes its sentinels (row 0:
//    index >= n, value 0); the span that holds n is read row by row,
//    element by element (magnitude -1, value 0, not counted). Where g or r
//    is not 16-byte aligned (a view such as x[1:]) the launcher takes the
//    same kernel with 4-byte loads. Grid: a block a span; with counts, at
//    most the blocks the card holds at once, walking the spans grid-stride,
//    so that the 8 integer atomics (as in (1)) come once a block and not
//    once a span (6,272 spans at N = 25.6M). The readings behind each
//    choice -- warps to a slab, rows a batch, the grid, and cp.async.bulk
//    into a shared-memory ring in place of the loads -- and what holds the
//    kernel back are in PERF.md, from gtopkssgd_tpu_torch/stage1_design.py.
//
// 3. multisection_kernel -- the whole tau bracket of the `pallas` method
//    (ops/topk.py, the loop in cuda_topk.multisection_rounds; the JAX
//    package's gtopkssgd_tpu/ops/topk.py:159-170 and :379-390) in ONE
//    launch: maxv = max|acc|, then 4 rounds of 8 geometric thresholds, the
//    8 counts of |acc| >= thr (MODE_ABS: |x|; MODE_RESIDUAL: |x + r|, the
//    sum never stored), and the narrowing of (lo, hi). On the TPU each
//    round is one Pallas call (`_count_kernel` or
//    `fused_multi_threshold_count`); on a GPU a bracket cannot pass from
//    one launch's blocks to the next without the host's queue, and at
//    ResNet-20 size four such launches plus ~60 small PyTorch ops cost far
//    more than the bytes.
//    Bound: bytes, one read of the operand (4N or 8N B): 0.33 / 0.65 us at
//    N = 272,474 and 30.5 / 61.0 us at N = 25,557,032. At the small size a
//    launch and five grid syncs dominate.
//    Design: a cooperative launch of one persistent block per SM (never
//    more than the occupancy API allows, or the launch is refused), with
//    cooperative_groups grid syncs between phases; 128 to 512 threads a
//    block, about 16 groups of 4 elements a thread (a small slice is bound
//    by each round's block reductions and syncs, cheaper with fewer
//    warps; a large one needs more loads in flight): 128 at N = 272,474,
//    512 at N = 25,557,032. Block b owns the contiguous slice
//    [b*S, (b+1)*S), S a multiple of 4, read with 16-byte loads where both
//    pointers are 16-byte aligned.
//    NaN rule: a NaN |acc| is ignored -- fmaxf drops it from maxv and
//    NaN >= thr is false, so it is never counted; the bracket is that of
//    the other elements (lo = 0 when every element is NaN).
//    Phase 0 reads the slice once, forms |acc|, keeps the first elements
//    of it in shared memory (all of it when it fits: 8.3 KB a block at
//    N = 272,474; 227 KB of a 774 KB slice at N = 25,557,032, where the
//    rest is re-read from x (+ r) every round), and writes the block's
//    maximum to scratch[b]; block 0 zeroes the 4x8 counters. After the
//    sync every block reduces the same partial maxima, so all agree on
//    maxv with nothing broadcast and nothing to zero beforehand. Each
//    round every block computes the same 8 thresholds in the float32
//    operations, and the order, of the PyTorch loop (no FMA contraction;
//    `powf`, as `torch.pow` lowers to it, with exponents hidden from the
//    compiler so that it cannot rewrite pow(r, 2) as r*r), counts its
//    slice, reduces per block (warp shuffles, shared memory) and adds one
//    integer atomic per threshold into that round's counters: exact and
//    independent of block order. After the sync every block reads the 8
//    counts and narrows (lo, hi) identically. Block 0 writes lo and the
//    round's thresholds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace cg = cooperative_groups;

#define NUM_THR 8
#define LANES 128
#define BLOCK_ROWS 2048
#define TILE (BLOCK_ROWS * LANES)
#define COUNT_THREADS 256
#define ROUNDS 4
// Most and fewest threads a multisection block has; set both to one width
// with -D to fix it (gtopkssgd_tpu_torch/multisection_threads.py does).
#ifndef MS_THREADS
#define MS_THREADS 512
#endif
#ifndef MS_MIN_THREADS
#define MS_MIN_THREADS 128
#endif
#define MS_MAX_BLOCKS 1024  // floats of scratch the caller provides
#define MAX_DEVICES 64

enum { MODE_RAW = 0, MODE_ABS = 1, MODE_RESIDUAL = 2 };

// Sum each thread's 8 counters over the block and add the block's totals
// into counts[8] with one atomic per threshold. blockDim.x must be a
// multiple of 32 and at most 1024.
__device__ __forceinline__ void block_add_counts(const int (&c)[NUM_THR],
                                                 int* counts) {
  __shared__ int part[32][NUM_THR];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < NUM_THR; ++t) {
    int v = c[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][t] = v;
  }
  __syncthreads();
  if (threadIdx.x < NUM_THR) {
    const int nwarps = blockDim.x >> 5;
    int s = 0;
    for (int w = 0; w < nwarps; ++w) s += part[w][threadIdx.x];
    if (s) atomicAdd(counts + threadIdx.x, s);
  }
}

template <int MODE>
__global__ void __launch_bounds__(COUNT_THREADS)
count_kernel(const float* __restrict__ x, const float* __restrict__ r,
             long long n, const float* __restrict__ thr,
             int* __restrict__ counts) {
  float t[NUM_THR];
  int c[NUM_THR];
#pragma unroll
  for (int i = 0; i < NUM_THR; ++i) {
    t[i] = thr[i];
    c[i] = 0;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    float v = x[j];
    if (MODE == MODE_RESIDUAL) v = fabsf(v + r[j]);
    if (MODE == MODE_ABS) v = fabsf(v);
#pragma unroll
    for (int i = 0; i < NUM_THR; ++i) c[i] += (v >= t[i]);
  }
  block_add_counts(c, counts);
}

// ---- Stage 1 (K2) ----------------------------------------------------------
// -DSTAGE1_WPS=k, -DSTAGE1_BATCH=b, -DSTAGE1_GRID=1|2 and -DSTAGE1_BULK=1
// build the variants that gtopkssgd_tpu_torch/stage1_design.py measures
// against the shipped design.
#define STAGE1_WARPS 8
#define STAGE1_THREADS (STAGE1_WARPS * 32)
#ifndef STAGE1_WPS
#define STAGE1_WPS STAGE1_WARPS  // warps to a slab, at most
#endif
#ifndef STAGE1_BATCH
#define STAGE1_BATCH 4  // rows a thread loads before it compares any
#endif
#ifndef STAGE1_GRID
#define STAGE1_GRID 0  // 0: stage1_launch's rule; 1: a block a span; 2: persistent
#endif
#ifndef STAGE1_BULK
#define STAGE1_BULK 0
#endif

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p) {
  return VEC ? *reinterpret_cast<const float4*>(p)
             : make_float4(p[0], p[1], p[2], p[3]);
}

// acc = g (+ r) at j..j+3 (j a multiple of 4; one 16-byte load an operand
// when VEC).
template <bool RESIDUAL, bool VEC>
__device__ __forceinline__ float4 load_acc4(const float* __restrict__ g,
                                            const float* __restrict__ r,
                                            long long j) {
  float4 a = load4<VEC>(g + j);
  if (RESIDUAL) {
    const float4 b = load4<VEC>(r + j);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  return a;
}

// How a block's warps cover a span (the rows it walks at once): spb whole
// slabs of rpg rows, wps warps to a slab (a power of two, at most rpg and
// STAGE1_WARPS), rpw consecutive rows to a warp. This warp reads rows
// [row0, row0 + rpw) of slab `slab` of the span.
struct Stage1Shape {
  int rpg, wps, spb, rpw, slab, row0;
  long long span;  // elements
  __device__ Stage1Shape(int rows_per_group, int warps_per_slab)
      : rpg(rows_per_group), wps(warps_per_slab) {
    spb = STAGE1_WARPS / wps;
    rpw = rpg / wps;
    const int warp = threadIdx.x >> 5;
    slab = warp / wps;
    row0 = (warp % wps) * rpw;
    span = (long long)spb * rpg * LANES;
  }
  // This thread's first element (row row0, lane 4*(threadIdx.x % 32)) in
  // the span.
  __device__ long long offset() const {
    return ((long long)slab * rpg + row0) * LANES + 4 * (threadIdx.x & 31);
  }
};

// The best element so far of each of a thread's 4 lanes: magnitude (-1
// before any real element), signed value, row in the slab.
struct Best4 {
  float mag[4];
  float val[4];
  int row[4];
  __device__ explicit Best4(int row0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mag[j] = -1.f;
      val[j] = 0.f;
      row[j] = row0;
    }
  }
};

// acc = a at row `row` of this thread's 4 lanes into the counts and each
// lane's best; lanes j >= real are padding (magnitude -1): never counted
// or chosen.
template <bool COUNTS>
__device__ __forceinline__ void take_row(float4 a, int row, int real,
                                         const float (&t)[NUM_THR],
                                         int (&c)[NUM_THR], Best4& b) {
  const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float m = j < real ? fabsf(v[j]) : -1.f;
    if (COUNTS && j < real) {
#pragma unroll
      for (int k = 0; k < NUM_THR; ++k) c[k] += (m >= t[k]);
    }
    // Rows arrive in ascending order: strict '>' keeps the first. A NaN
    // magnitude counts as the largest, and nothing replaces a NaN best:
    // the first NaN row wins.
    if (m > b.mag[j] || (isnan(m) && !isnan(b.mag[j]))) {
      b.mag[j] = m;
      b.val[j] = v[j];
      b.row[j] = row;
    }
  }
}

// Rows 0 .. rows - 1 of this thread's 4 lanes (row0 + q for row q), x and
// y at row 0 in g and r, rows LANES floats apart: STAGE1_BATCH rows of
// loads issued before any is compared. Elements at or past x + left are
// padding; where there are any, rows are read one at a time.
template <bool RESIDUAL, bool COUNTS, bool VEC>
__device__ __forceinline__ void scan_rows(const float* x, const float* y,
                                          int rows, int row0, long long left,
                                          const float (&t)[NUM_THR],
                                          int (&c)[NUM_THR], Best4& b) {
  if (left >= (long long)(rows - 1) * LANES + 4) {
    for (int q0 = 0; q0 < rows; q0 += STAGE1_BATCH) {
      float4 a[STAGE1_BATCH];
#pragma unroll
      for (int i = 0; i < STAGE1_BATCH; ++i)
        if (q0 + i < rows)
          a[i] = load_acc4<RESIDUAL, VEC>(x, y, (q0 + i) * LANES);
#pragma unroll
      for (int i = 0; i < STAGE1_BATCH; ++i)
        if (q0 + i < rows) take_row<COUNTS>(a[i], row0 + q0 + i, 4, t, c, b);
    }
    return;
  }
  for (int q = 0; q < rows && (long long)q * LANES < left; ++q) {
    const int o = q * LANES;
    const int real = left - o < 4 ? (int)(left - o) : 4;
    float a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[j] = j < real ? (RESIDUAL ? x[o + j] + y[o + j] : x[o + j]) : 0.f;
    take_row<COUNTS>(make_float4(a[0], a[1], a[2], a[3]), row0 + q, real, t,
                     c, b);
  }
}

// The slabs of span `s` (of `slabs` in all; the last span may reach past
// the last slab, and nothing is written there) wholly past n: row 0,
// value 0, nothing loaded.
__device__ __forceinline__ void write_padding(long long s,
                                              const Stage1Shape& sh,
                                              long long slabs,
                                              float* __restrict__ cand_val,
                                              int* __restrict__ cand_idx) {
  for (int o = threadIdx.x; o < sh.spb * LANES; o += STAGE1_THREADS) {
    const long long slab = s * sh.spb + o / LANES;
    if (slab >= slabs) break;
    cand_val[slab * LANES + o % LANES] = 0.f;
    cand_idx[slab * LANES + o % LANES] =
        (int)(slab * sh.rpg * LANES) + o % LANES;
  }
}

// Whether (wm, wr) comes before (m, row) in a bucket: a NaN magnitude is
// the largest, equal magnitudes (two NaNs included) go to the smaller row.
__device__ __forceinline__ bool stage1_beats(float wm, int wr, float m,
                                             int row) {
  if (isnan(wm)) return !isnan(m) || wr < row;
  return !isnan(m) && (wm > m || (wm == m && wr < row));
}

// Each slab of span `s` from its warps' Best4: the block's threads, one
// (slab, lane) each, combine the wps warps of that slab -- larger
// magnitude (NaN the largest), then the smaller ROW, so the first maximum
// wins whichever warp held it -- and write it.
__device__ __forceinline__ void write_span(const Best4& b, long long s,
                                           const Stage1Shape& sh,
                                           long long slabs,
                                           float* __restrict__ cand_val,
                                           int* __restrict__ cand_idx) {
  __shared__ float4 red_mag[STAGE1_WARPS][32];
  __shared__ float4 red_val[STAGE1_WARPS][32];
  __shared__ int4 red_row[STAGE1_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  red_mag[warp][lane] = make_float4(b.mag[0], b.mag[1], b.mag[2], b.mag[3]);
  red_val[warp][lane] = make_float4(b.val[0], b.val[1], b.val[2], b.val[3]);
  red_row[warp][lane] = make_int4(b.row[0], b.row[1], b.row[2], b.row[3]);
  __syncthreads();
  // red_*[w] read as [128]: entry l is lane l of warp w's rows.
  const float* rm = reinterpret_cast<const float*>(red_mag);
  const float* rv = reinterpret_cast<const float*>(red_val);
  const int* rr = reinterpret_cast<const int*>(red_row);
  for (int o = threadIdx.x; o < sh.spb * LANES; o += STAGE1_THREADS) {
    const long long slab = s * sh.spb + o / LANES;
    const int ln = o % LANES;
    if (slab >= slabs) break;
    int w = (o / LANES) * sh.wps;
    float m = rm[w * LANES + ln];
    float v = rv[w * LANES + ln];
    int row = rr[w * LANES + ln];
    for (const int end = w + sh.wps; ++w < end;) {
      const float wm = rm[w * LANES + ln];
      const int wr = rr[w * LANES + ln];
      if (stage1_beats(wm, wr, m, row)) {
        m = wm;
        v = rv[w * LANES + ln];
        row = wr;
      }
    }
    cand_val[slab * LANES + ln] = v;
    cand_idx[slab * LANES + ln] =
        (int)(slab * sh.rpg * LANES) + row * LANES + ln;
  }
  __syncthreads();  // red_* is free for the next span
}

template <bool COUNTS>
__device__ __forceinline__ void load_thresholds(const float* __restrict__ thr,
                                                float (&t)[NUM_THR],
                                                int (&c)[NUM_THR]) {
#pragma unroll
  for (int i = 0; i < NUM_THR; ++i) {
    t[i] = COUNTS ? thr[i] : 0.f;
    c[i] = 0;
  }
}

// Block b takes spans b, b + grid, ...: a span wholly before n is read
// without masks, the span that holds n element by element, and spans past
// it load nothing.
template <bool RESIDUAL, bool COUNTS, bool VEC>
__global__ void __launch_bounds__(STAGE1_THREADS)
stage1_kernel(const float* __restrict__ g, const float* __restrict__ r,
              long long n, int rpg, int wps, long long slabs,
              const float* __restrict__ thr, int* __restrict__ counts,
              float* __restrict__ cand_val, int* __restrict__ cand_idx) {
  const Stage1Shape sh(rpg, wps);
  float t[NUM_THR];
  int c[NUM_THR];
  load_thresholds<COUNTS>(thr, t, c);
  const long long spans = (slabs + sh.spb - 1) / sh.spb;
  for (long long s = blockIdx.x; s < spans; s += gridDim.x) {
    if (s * sh.span >= n) {
      write_padding(s, sh, slabs, cand_val, cand_idx);
      continue;
    }
    const long long e = s * sh.span + sh.offset();
    Best4 b(sh.row0);
    scan_rows<RESIDUAL, COUNTS, VEC>(g + e, r + (RESIDUAL ? e : 0), sh.rpw,
                                     sh.row0, n - e, t, c, b);
    write_span(b, s, sh, slabs, cand_val, cand_idx);
  }
  if (COUNTS) block_add_counts(c, counts);
}

#if STAGE1_BULK
// The variant that copies each span into a ring of shared memory with the
// copy engine (1-D cp.async.bulk, completion on an mbarrier) in place of
// the threads' own 16-byte loads. Spans of at most BULK_MAX_ROWS rows.
#define BULK_STAGES 4
#define BULK_MAX_ROWS 32

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <bool RESIDUAL>
__device__ __forceinline__ void bulk_fetch(float* dst, const float* g,
                                           const float* r, long long base,
                                           unsigned bytes,
                                           unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(RESIDUAL ? 2 * bytes : bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(g + base), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
  if (RESIDUAL)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst + bytes / 4)),
        "l"(r + base), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void bulk_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// Block b takes spans b, b + grid, ... that lie wholly before n through a
// ring of BULK_STAGES spans; the span that holds n and the padding after
// it are read directly.
template <bool RESIDUAL, bool COUNTS>
__global__ void __launch_bounds__(STAGE1_THREADS)
stage1_bulk_kernel(const float* __restrict__ g, const float* __restrict__ r,
                   long long n, int rpg, int wps, long long slabs,
                   const float* __restrict__ thr, int* __restrict__ counts,
                   float* __restrict__ cand_val, int* __restrict__ cand_idx) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) unsigned long long full[BULK_STAGES];
  const Stage1Shape sh(rpg, wps);
  float t[NUM_THR];
  int c[NUM_THR];
  load_thresholds<COUNTS>(thr, t, c);
  const long long spans = (slabs + sh.spb - 1) / sh.spb;
  const long long off = sh.offset();
  const long long whole = n / sh.span;
  const long long mine =
      blockIdx.x < whole ? (whole - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long stage = (RESIDUAL ? 2 : 1) * sh.span;  // floats
  const unsigned bytes = (unsigned)(sh.span * sizeof(float));
  if (threadIdx.x == 0) {
    for (int i = 0; i < BULK_STAGES; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(full + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long long i = 0; i < mine && i < BULK_STAGES; ++i)
      bulk_fetch<RESIDUAL>(ring + i * stage, g, r,
                           (blockIdx.x + i * gridDim.x) * sh.span, bytes,
                           full + i);
  }
  __syncthreads();
  for (long long i = 0; i < mine; ++i) {
    const int st = (int)(i % BULK_STAGES);
    bulk_wait(full + st, (unsigned)((i / BULK_STAGES) & 1));
    const float* x = ring + st * stage;
    Best4 b(sh.row0);
    scan_rows<RESIDUAL, COUNTS, true>(x + off, x + sh.span + off, sh.rpw,
                                      sh.row0, sh.rpw * LANES, t, c, b);
    __syncthreads();  // every read of stage st is done
    if (threadIdx.x == 0 && i + BULK_STAGES < mine)
      bulk_fetch<RESIDUAL>(ring + st * stage, g, r,
                           (blockIdx.x + (i + BULK_STAGES) * gridDim.x) *
                               sh.span,
                           bytes, full + st);
    write_span(b, blockIdx.x + i * gridDim.x, sh, slabs, cand_val, cand_idx);
  }
  for (long long s = whole + blockIdx.x; s < spans; s += gridDim.x) {
    const long long e = s * sh.span + off;
    if (s * sh.span >= n) {
      write_padding(s, sh, slabs, cand_val, cand_idx);
      continue;
    }
    Best4 b(sh.row0);
    scan_rows<RESIDUAL, COUNTS, true>(g + e, r + (RESIDUAL ? e : 0), sh.rpw,
                                      sh.row0, n - e, t, c, b);
    write_span(b, s, sh, slabs, cand_val, cand_idx);
  }
  if (COUNTS) block_add_counts(c, counts);
}
#endif

// At most the blocks of `kernel` (STAGE1_THREADS threads, `smem` dynamic
// bytes) that the card holds at once, and no more than `spans`; how many
// an SM holds is asked once per device and kernel (`cache`).
static cudaError_t persistent_grid(const void* kernel, size_t smem,
                                   std::atomic<int>* cache, long long spans,
                                   long long* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  int occ = cache[dev].load();
  if (occ < 1) {
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, kernel, STAGE1_THREADS, smem)) != cudaSuccess)
      return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    cache[dev].store(occ);
  }
  *grid = spans < (long long)sms * occ ? spans : (long long)sms * occ;
  return cudaSuccess;
}

template <bool RESIDUAL, bool COUNTS, bool VEC>
static cudaError_t stage1_launch(const float* g, const float* r, long long n,
                                 long long nblocks, int rpg,
                                 const float* thr, int* counts,
                                 float* cand_val, int* cand_idx,
                                 cudaStream_t s) {
  cudaError_t e;
  const long long slabs = nblocks * BLOCK_ROWS / rpg;
#if STAGE1_BULK
  const int span_rows = rpg > STAGE1_WARPS ? rpg : STAGE1_WARPS;
  if (VEC && span_rows <= BULK_MAX_ROWS) {
    static std::atomic<int> bulk_occ[MAX_DEVICES];
    const void* fn = (const void*)stage1_bulk_kernel<RESIDUAL, COUNTS>;
    const int wps = rpg < STAGE1_WARPS ? rpg : STAGE1_WARPS;
    const long long spans = nblocks * BLOCK_ROWS / span_rows;
    const size_t smem = (size_t)BULK_STAGES * (RESIDUAL ? 2 : 1) * span_rows *
                        LANES * sizeof(float);
    long long grid = 0;
    if ((e = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
            cudaSuccess ||
        (e = persistent_grid(fn, smem, bulk_occ, spans, &grid)) !=
            cudaSuccess)
      return e;
    stage1_bulk_kernel<RESIDUAL, COUNTS>
        <<<(unsigned)grid, STAGE1_THREADS, smem, s>>>(
            g, r, n, rpg, wps, slabs, thr, counts, cand_val, cand_idx);
    return cudaSuccess;
  }
#endif
  const int wps = rpg < STAGE1_WPS ? rpg : STAGE1_WPS;
  const int spb = STAGE1_WARPS / wps;
  long long grid = (slabs + spb - 1) / spb;  // spans
  // A block a span, unless the counts are asked for: then at most the
  // blocks the card holds at once, each adding its counts once.
  if (STAGE1_GRID == 2 || (STAGE1_GRID == 0 && COUNTS)) {
    static std::atomic<int> occ[MAX_DEVICES];
    if ((e = persistent_grid(
             (const void*)stage1_kernel<RESIDUAL, COUNTS, VEC>, 0, occ, grid,
             &grid)) != cudaSuccess)
      return e;
  }
  stage1_kernel<RESIDUAL, COUNTS, VEC><<<(unsigned)grid, STAGE1_THREADS, 0, s>>>(
      g, r, n, rpg, wps, slabs, thr, counts, cand_val, cand_idx);
  return cudaSuccess;
}

template <bool RESIDUAL, bool COUNTS>
static cudaError_t stage1_dispatch(bool vec, const float* g, const float* r,
                                   long long n, long long nblocks, int rpg,
                                   const float* thr, int* counts,
                                   float* cand_val, int* cand_idx,
                                   cudaStream_t s) {
  return vec ? stage1_launch<RESIDUAL, COUNTS, true>(
                   g, r, n, nblocks, rpg, thr, counts, cand_val, cand_idx, s)
             : stage1_launch<RESIDUAL, COUNTS, false>(
                   g, r, n, nblocks, rpg, thr, counts, cand_val, cand_idx, s);
}

__global__ void noop_kernel() {}

// The bytes of stage 1 moved with no selection: each thread reads one
// float4 of g and of r, and threads below l4 write one float4 and one
// int4. Every thread's sum decides whether it stores (a sum of -1e30, which
// the data never has, stores to slot 0), so the compiler drops no load.
__global__ void __launch_bounds__(256)
bytes_floor_kernel(const float4* __restrict__ g, const float4* __restrict__ r,
                   long long n4, float4* __restrict__ val,
                   int4* __restrict__ idx, long long l4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 a = g[i];
  const float4 b = r[i];
  const float4 s = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  const float t = s.x + s.y + s.z + s.w;
  if (i < l4 || t == -1e30f) {
    const long long j = i < l4 ? i : 0;
    val[j] = s;
    idx[j] = make_int4((int)i, __float_as_int(t), 0, 0);
  }
}

// v, unchanged, but unknown to the compiler from here on.
__device__ __forceinline__ float opaque(float v) {
  asm volatile("mov.f32 %0, %0;" : "+f"(v));
  return v;
}

// The 8 thresholds of a round from (lo, hi, maxv), as the PyTorch loop
// computes them (each operation rounded on its own, float32 constants):
//   lo_eff = max(lo, maxv * 1e-12 + 1e-30)
//   r      = (lo_eff / (hi + 1e-30)) ** (1/9)
//   thr[i] = hi * r ** (i + 1)
__device__ __forceinline__ void round_thresholds(float lo, float hi,
                                                 float maxv,
                                                 float (&t)[NUM_THR]) {
  const float lo_eff =
      fmaxf(lo, __fadd_rn(__fmul_rn(maxv, (float)1e-12), (float)1e-30));
  const float ratio = powf(__fdiv_rn(lo_eff, __fadd_rn(hi, (float)1e-30)),
                           opaque((float)(1.0 / 9.0)));
#pragma unroll
  for (int i = 0; i < NUM_THR; ++i)
    t[i] = __fmul_rn(hi, powf(ratio, opaque((float)(i + 1))));
}

// Block-wide maximum, returned to every thread. red: 32 floats of shared
// memory, free again on return.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

// |acc| at j..j+3 (j a multiple of 4).
template <int MODE, bool VEC>
__device__ __forceinline__ float4 load_mag4(const float* __restrict__ x,
                                            const float* __restrict__ r,
                                            long long j) {
  const float4 a = load_acc4<MODE == MODE_RESIDUAL, VEC>(x, r, j);
  return make_float4(fabsf(a.x), fabsf(a.y), fabsf(a.z), fabsf(a.w));
}

template <int MODE>
__device__ __forceinline__ float load_mag1(const float* __restrict__ x,
                                           const float* __restrict__ r,
                                           long long j) {
  float v = x[j];
  if (MODE == MODE_RESIDUAL) v += r[j];
  return fabsf(v);
}

__device__ __forceinline__ void count4(float4 a, const float (&t)[NUM_THR],
                                       int (&c)[NUM_THR]) {
#pragma unroll
  for (int i = 0; i < NUM_THR; ++i)
    c[i] += (a.x >= t[i]) + (a.y >= t[i]) + (a.z >= t[i]) + (a.w >= t[i]);
}

// The kernel's body for one load width. The block's slice is
// [base, base + len): nv whole groups of 4, of which the first nc live in
// shared memory after phase 0, then len % 4 single elements.
template <int MODE, bool VEC>
__device__ __forceinline__ void multisection_body(
    const float* __restrict__ x, const float* __restrict__ r, long long n,
    long long k, long long slice, long long cached, float* __restrict__ lo_out,
    float* __restrict__ thr_out, int* __restrict__ counts_out,
    float* __restrict__ partial, float4* cache, float* red) {
  cg::grid_group grid = cg::this_grid();
  const long long base = (long long)blockIdx.x * slice;
  const long long len = base < n ? min(slice, n - base) : 0;
  const long long nv = len >> 2;
  const long long nc = min(cached >> 2, nv);
  const int tail = (int)(len & 3);
  const long long tail0 = base + 4 * nv;

  // Phase 0: one read of the operand; the maximum; the counters zeroed.
  if (blockIdx.x == 0 && threadIdx.x < ROUNDS * NUM_THR)
    counts_out[threadIdx.x] = 0;
  float m = 0.f;
#pragma unroll 4
  for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
    const float4 a = load_mag4<MODE, VEC>(x, r, base + 4 * i);
    m = fmaxf(m, fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)));
    if (i < nc) cache[i] = a;
  }
  if (threadIdx.x < tail)
    m = fmaxf(m, load_mag1<MODE>(x, r, tail0 + threadIdx.x));
  m = block_max(m, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
  grid.sync();
  m = 0.f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x)
    m = fmaxf(m, __ldcg(partial + b));
  const float maxv = block_max(m, red);

  // Rounds 1-4.
  float lo = 0.f;
  float hi = maxv;
  for (int round = 0; round < ROUNDS; ++round) {
    float t[NUM_THR];
    int c[NUM_THR];
    round_thresholds(lo, hi, maxv, t);
#pragma unroll
    for (int i = 0; i < NUM_THR; ++i) c[i] = 0;
    for (long long i = threadIdx.x; i < nc; i += blockDim.x)
      count4(cache[i], t, c);
#pragma unroll 4
    for (long long i = nc + threadIdx.x; i < nv; i += blockDim.x)
      count4(load_mag4<MODE, VEC>(x, r, base + 4 * i), t, c);
    if (threadIdx.x < tail) {
      const float v = load_mag1<MODE>(x, r, tail0 + threadIdx.x);
#pragma unroll
      for (int i = 0; i < NUM_THR; ++i) c[i] += (v >= t[i]);
    }
    int* cr = counts_out + round * NUM_THR;
    block_add_counts(c, cr);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < NUM_THR; ++i) thr_out[round * NUM_THR + i] = t[i];
    }
    grid.sync();
    // lo = max(lo, thr[i] where counts >= k); hi = min(hi, thr[i] where not).
    float nlo = lo;
    float nhi = hi;
#pragma unroll
    for (int i = 0; i < NUM_THR; ++i) {
      if ((long long)__ldcg(cr + i) >= k)
        nlo = fmaxf(nlo, t[i]);
      else
        nhi = fminf(nhi, t[i]);
    }
    lo = nlo;
    hi = nhi;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *lo_out = lo;
}

template <int MODE>
__global__ void __launch_bounds__(MS_THREADS)
multisection_kernel(const float* __restrict__ x, const float* __restrict__ r,
                    long long n, long long k, long long slice,
                    long long cached, int vec, float* __restrict__ lo_out,
                    float* __restrict__ thr_out, int* __restrict__ counts_out,
                    float* __restrict__ partial) {
  extern __shared__ float4 cache[];
  __shared__ float red[32];
  if (vec)
    multisection_body<MODE, true>(x, r, n, k, slice, cached, lo_out, thr_out,
                                  counts_out, partial, cache, red);
  else
    multisection_body<MODE, false>(x, r, n, k, slice, cached, lo_out,
                                   thr_out, counts_out, partial, cache, red);
}

// Launch shape of the multisection kernel on one device: one block per SM,
// and the floats a block may keep in shared memory (a multiple of 4).
struct MsPlan {
  int blocks;
  long long cache_floats;
};

template <int MODE>
static cudaError_t multisection_plan(MsPlan* out) {
  static std::mutex mu;
  static MsPlan plans[MAX_DEVICES];
  static bool ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (!ready[dev]) {
    const void* fn = (const void*)multisection_kernel<MODE>;
    int coop = 0, sms = 0, optin = 0;
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess)
      return e;
    if (!coop) return cudaErrorNotSupported;
    if (sms > MS_MAX_BLOCKS) return cudaErrorInvalidConfiguration;
    cudaFuncAttributes fa;
    if ((e = cudaFuncGetAttributes(&fa, fn)) != cudaSuccess) return e;
    int dyn = (optin - (int)fa.sharedSizeBytes) & ~15;
    if ((e = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn)) !=
        cudaSuccess)
      return e;
    // The largest cache at which one block still fits on an SM.
    int occ = 0;
    for (;;) {
      if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &occ, fn, MS_THREADS, dyn)) != cudaSuccess)
        return e;
      if (occ >= 1 || dyn < 1024) break;
      dyn -= 1024;
    }
    if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
    plans[dev].blocks = sms;
    plans[dev].cache_floats = (long long)(dyn / 16) * 4;
    ready[dev] = true;
  }
  *out = plans[dev];
  return cudaSuccess;
}

template <int MODE>
static cudaError_t multisection_launch(const float* x, const float* r,
                                       long long n, long long k,
                                       float* lo_out, float* thr_out,
                                       int* counts_out, float* scratch,
                                       cudaStream_t s) {
  MsPlan p;
  cudaError_t e = multisection_plan<MODE>(&p);
  if (e != cudaSuccess) return e;
  long long slice = ((n + p.blocks - 1) / p.blocks + 3) & ~3LL;
  long long cached = slice < p.cache_floats ? slice : p.cache_floats;
  // About 16 groups of 4 elements a thread: a small slice is bound by each
  // round's block reductions and syncs, cheaper with fewer warps; a large
  // one needs more loads in flight.
  int threads = MS_MIN_THREADS;
  while (threads < MS_THREADS && (long long)threads * 64 < slice)
    threads *= 2;
  int vec = (((uintptr_t)x | (uintptr_t)r) & 15) == 0;
  void* args[] = {&x,   &r,      &n,      &k,       &slice,     &cached,
                  &vec, &lo_out, &thr_out, &counts_out, &scratch};
  return cudaLaunchCooperativeKernel((const void*)multisection_kernel<MODE>,
                                     dim3(p.blocks), dim3(threads), args,
                                     (size_t)cached * sizeof(float), s);
}

extern "C" {

// counts[i] += #{j < n : v[j] >= thr[i]}; v = x, |x|, or |x + r| when r is
// given. counts must be zeroed by the caller. Returns cudaGetLastError().
int gtopk_count(const float* x, const float* r, int take_abs, long long n,
                const float* thr, int* counts, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n + COUNT_THREADS - 1) / COUNT_THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, grid-stride
  const dim3 grid((unsigned)blocks);
  if (r != nullptr)
    count_kernel<MODE_RESIDUAL><<<grid, COUNT_THREADS, 0, s>>>(
        x, r, n, thr, counts);
  else if (take_abs)
    count_kernel<MODE_ABS><<<grid, COUNT_THREADS, 0, s>>>(
        x, r, n, thr, counts);
  else
    count_kernel<MODE_RAW><<<grid, COUNT_THREADS, 0, s>>>(
        x, r, n, thr, counts);
  return (int)cudaGetLastError();
}

// Per-bucket candidates over acc = g (+ r): cand_val/cand_idx hold
// nblocks*groups*128 entries, nblocks = max(1, ceil(n / 262144)); groups
// is a power of two up to 2048; cand_val and cand_idx are 16-byte aligned
// (g and r need not be). With thr given, counts (zeroed by the
// caller) also receives the 8 counts of |acc| >= thr[i]. Returns
// cudaGetLastError().
int gtopk_stage1(const float* g, const float* r, long long n, int groups,
                 const float* thr, int* counts, float* cand_val,
                 int* cand_idx, void* stream) {
  if (groups < 1 || groups > BLOCK_ROWS || BLOCK_ROWS % groups != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  long long nblocks = (n + TILE - 1) / TILE;
  if (nblocks < 1) nblocks = 1;
  const int rpg = BLOCK_ROWS / groups;
  const bool vec = (((uintptr_t)g | (uintptr_t)r) & 15) == 0;
  cudaError_t e;
  if (r != nullptr && thr != nullptr)
    e = stage1_dispatch<true, true>(vec, g, r, n, nblocks, rpg, thr, counts,
                                    cand_val, cand_idx, s);
  else if (r != nullptr)
    e = stage1_dispatch<true, false>(vec, g, r, n, nblocks, rpg, thr, counts,
                                     cand_val, cand_idx, s);
  else if (thr != nullptr)
    e = stage1_dispatch<false, true>(vec, g, r, n, nblocks, rpg, thr, counts,
                                     cand_val, cand_idx, s);
  else
    e = stage1_dispatch<false, false>(vec, g, r, n, nblocks, rpg, thr,
                                      counts, cand_val, cand_idx, s);
  const cudaError_t last = cudaGetLastError();  // also clears e
  return (int)(e != cudaSuccess ? e : last);
}

// The floor under stage 1's time at these shapes: n floats of g and of r
// read (n/4 float4s; g, r, cand_val, cand_idx 16-byte aligned), L floats
// and L ints written, as one float4 a thread. Returns cudaGetLastError().
int gtopk_bytes_floor(const float* g, const float* r, long long n,
                      float* cand_val, int* cand_idx, long long L,
                      void* stream) {
  const long long n4 = n / 4;
  if (n4 < 1 || L > n) return (int)cudaErrorInvalidValue;
  bytes_floor_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0,
                       (cudaStream_t)stream>>>(
      (const float4*)g, (const float4*)r, n4, (float4*)cand_val,
      (int4*)cand_idx, L / 4);
  return (int)cudaGetLastError();
}

// One launch of an empty kernel: the floor under every launch's time.
int gtopk_noop(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The multisection bracket over |x| (r null) or |x + r|:
// lo_out f32[1], thr_out f32[4*8] and counts_out i32[4*8] (round-major),
// scratch f32[MS_MAX_BLOCKS]; nothing needs zeroing. Returns the launch's
// error, e.g. cudaErrorCooperativeLaunchTooLarge, else cudaGetLastError().
int gtopk_multisection(const float* x, const float* r, long long n,
                       long long k, float* lo_out, float* thr_out,
                       int* counts_out, float* scratch, void* stream) {
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      r != nullptr
          ? multisection_launch<MODE_RESIDUAL>(x, r, n, k, lo_out, thr_out,
                                               counts_out, scratch, s)
          : multisection_launch<MODE_ABS>(x, r, n, k, lo_out, thr_out,
                                          counts_out, scratch, s);
  const cudaError_t last = cudaGetLastError();  // also clears e
  return (int)(e != cudaSuccess ? e : last);
}

}  // extern "C"
