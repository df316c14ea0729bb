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
//    once a span (6,272 spans at N = 25.6M). Fewer warps to a slab, 8 rows
//    a batch, one grid rule for both launches and cp.async.bulk into a
//    shared-memory ring each read slower on the card, or within 2%: the
//    readings are in CHANGES.md (fourth slice of the port) and in the
//    history of PERF.md.
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
//    512 at N = 25,557,032; the rule read within 1.7% of the best fixed
//    width at each size measured (CHANGES.md, third slice of the port).
//    Block b owns the contiguous slice
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
//
// 4. threshold_apply_kernel -- the P = 1 step after tau (cuda_topk.
//    threshold_apply). It replaces no TPU kernel: XLA fuses the same
//    elementwise expressions (gtopkssgd_tpu/compression.py:148-152 and the
//    update acc - residual) into the step; in PyTorch they were ten passes
//    over the vector, 71 B an element. Per element, in float32 and in the
//    order the plain twin computes them:
//      acc = g (+ r); keep = |acc| >= tau && |acc| > 0;
//      residual = keep ? 0 : acc; update = acc - residual (literally, so a
//      NaN or inf acc gives the NaN the twin's subtraction gives);
//    written as residual, update, keep (one byte) and, when asked, acc; and
//    kept_tau, the least kept |acc|, reduced in the same pass.
//    Bound: bytes, 8 B read and 13 B written an element (9 B without acc
//    written): 0.383 ms at N = 61,100,840 with acc, 0.310 without.
//    Design: a streaming pass. A grid of at most the blocks the card holds
//    at once walks groups of 4 elements grid-stride; each thread issues
//    APPLY_BATCH 16-byte loads of g and of r before it stores any, and
//    stores 16 bytes of each float output and 4 of keep (the outputs are
//    fresh and 16-byte aligned; where g or r is not, as a leaf's view, the
//    loads are 4-byte, as in (2)). The n % 4 last elements go to block 0.
//    tau is read through its pointer, never copied to the host, so the
//    launch can be captured in a CUDA graph. kept_tau: each thread's
//    minimum, then the warp's by shuffles, the block's in shared memory, and
//    one atomicMin a block on the bit pattern, which orders kept
//    magnitudes (positive, never NaN) as floats; the wrapper sets the word
//    to +inf on the stream before the launch.
//
// 5. sgd_apply_kernel -- SGD's step from the flat update (cuda_topk.
//    sgd_apply), in one launch over every leaf of the layout. It replaces
//    no TPU kernel: XLA fuses optax's add_decayed_weights + sgd into the
//    JAX step. In PyTorch the step was one strided copy a leaf of the flat
//    update into p.grad (FlatLayout.unravel_into) and torch.optim.SGD's
//    four foreach passes, 52 B an element and an N-float temporary. Per
//    element, in float32, with u the flat update at the element's place
//    in the reference's layout, p the parameter and b its momentum buffer:
//      g = u + wd*p                      (wd != 0; else g = u)
//      b = b*m, then b = b + g           (a fresh leaf: b = g, SGD's clone)
//      g = g + m*b under nesterov, else g = b   (momentum m != 0)
//      p = p + (-lr)*g
//    p and b written in place, nothing else. Rounding: each step rounds
//    where the foreach op rounds, the scalars rounded to float32 as those
//    ops round them (opmath float). An `alpha` op, a + alpha*b, is one
//    fused multiply-add on the card (ATen's foreach functor and its add
//    kernel, compiled by nvcc with contraction on; chip_smoke.py phase 2
//    tells that form from the two-rounding one on 2^20 random operands),
//    so the kernel spells each with __fmaf_rn and the plain products and
//    sums with __fmul_rn / __fadd_rn: no contraction of the compiler
//    decides. b + 1*g is b + g either way.
//    Bound: bytes, 12 B read (u, p, b) and 8 B written (p, b) an element,
//    20 B: 0.365 ms at N = 61,100,840, 0.153 ms at 25,557,032, 5.79 ms at
//    970,107,392; 12 B without momentum.
//    Design: the leaf table (int64, built by the wrapper while no graph
//    captures and reused while every address holds) gives each leaf its
//    offset in u, its p and b, its kind and shape, and the index of its
//    first work item; a block takes one item, found by a binary search
//    over those indices, so one launch covers any number of leaves. The
//    kind is read off the layout's permutation, axes that stay adjacent
//    merged and size-1 axes dropped:
//    - identity (1-D leaves, embeddings, every Moonlight leaf): p, b and
//      u's segment walked together, an item 4096 elements, 16-byte loads
//      of u and of p and b when their pointers allow (a segment's offset
//      need not be a multiple of 4), 4-byte loads otherwise;
//    - tiled, p = [A][I][S] laid out in u as [S][I][A] (dense weights
//      (1, 0): I = in, S = 1; convolutions (2, 3, 1, 0): A = out, I = in,
//      S = H*W): u's side has A contiguous, p's side j = i*S + s. An item
//      is a tile of 64 a by 32 j: each thread issues all its loads -- u's
//      32 rows of 64 a (row j at (j % S)*I + j / S, two 128-byte lines),
//      then p's and b's 64 rows of 32 j (one line each) -- before the
//      block's one barrier, then takes u from the tile in shared memory
//      transposed (rows padded to 65 floats: no bank conflicts). On an
//      H100 80GB HBM3 at 700 W (readings in CHANGES.md) the loads issued
//      before the barrier and the 64-row tile took AlexNet's layout from
//      64% of the bound to 88.5% and ResNet-50's from 59% to 80%; 32-row
//      tiles, more blocks an SM by a register cap and 2 groups a thread
//      read slower;
//    - strided, any other permutation (no model of the zoo has one): an
//      element at a time, its place in u from the permuted strides.

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
#define MS_THREADS 512      // most threads a multisection block has
#define MS_MIN_THREADS 128  // fewest
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
#define STAGE1_WARPS 8  // warps a block, and to a slab at most
#define STAGE1_THREADS (STAGE1_WARPS * 32)
#define STAGE1_BATCH 4  // rows a thread loads before it compares any

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

// At most the blocks of `kernel` (`threads` threads) that the card holds at
// once, and no more than `spans`; how many an SM holds is asked once per
// device and kernel (`cache`).
static cudaError_t persistent_grid(const void* kernel, int threads,
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
             &occ, kernel, threads, 0)) != cudaSuccess)
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
  const int wps = rpg < STAGE1_WARPS ? rpg : STAGE1_WARPS;
  const int spb = STAGE1_WARPS / wps;
  long long grid = (slabs + spb - 1) / spb;  // spans
  // A block a span, unless the counts are asked for: then at most the
  // blocks the card holds at once, each adding its counts once.
  if (COUNTS) {
    static std::atomic<int> occ[MAX_DEVICES];
    if ((e = persistent_grid(
             (const void*)stage1_kernel<RESIDUAL, COUNTS, VEC>,
             STAGE1_THREADS, occ, grid, &grid)) != cudaSuccess)
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

// ---- Threshold apply (4) ---------------------------------------------------
#define APPLY_THREADS 256
#define APPLY_BATCH 4  // groups of 4 a thread loads before it stores any
#define APPLY_INF __int_as_float(0x7f800000)

// One element of the step after tau: the residual and the update into res
// and upd, the smallest kept magnitude into m; returns keep.
__device__ __forceinline__ bool apply1(float a, float tau, float& res,
                                       float& upd, float& m) {
  const float mag = fabsf(a);
  const bool keep = mag >= tau && mag > 0.f;
  res = keep ? 0.f : a;
  upd = a - res;
  if (keep) m = fminf(m, mag);
  return keep;
}

// Block-wide minimum into *out with one atomicMin on the bit pattern, which
// orders positive floats; nothing is done for a block that kept nothing.
__device__ __forceinline__ void block_min_into(float m, float* out) {
  __shared__ float red[APPLY_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < APPLY_THREADS / 32; ++w) m = fminf(m, red[w]);
    if (m < APPLY_INF)
      atomicMin(reinterpret_cast<int*>(out), __float_as_int(m));
  }
}

// Groups of 4 (elements 4i .. 4i + 3) grid-stride, APPLY_BATCH a thread at
// a time, then the n % 4 last elements in block 0.
template <bool RESIDUAL, bool ACC, bool VEC>
__global__ void __launch_bounds__(APPLY_THREADS)
threshold_apply_kernel(const float* __restrict__ g,
                       const float* __restrict__ r, long long n,
                       const float* __restrict__ tau_ptr,
                       unsigned char* __restrict__ keep,
                       float* __restrict__ res, float* __restrict__ upd,
                       float* __restrict__ acc, float* __restrict__ kept_tau) {
  const float tau = *tau_ptr;
  float m = APPLY_INF;
  const long long nv = n >> 2;
  const long long batch = (long long)APPLY_BATCH * APPLY_THREADS;
  for (long long base = (long long)blockIdx.x * batch + threadIdx.x;
       base < nv; base += (long long)gridDim.x * batch) {
    float4 a[APPLY_BATCH];
#pragma unroll
    for (int b = 0; b < APPLY_BATCH; ++b) {
      const long long i = base + b * APPLY_THREADS;
      if (i < nv) a[b] = load_acc4<RESIDUAL, VEC>(g, r, 4 * i);
    }
#pragma unroll
    for (int b = 0; b < APPLY_BATCH; ++b) {
      const long long i = base + b * APPLY_THREADS;
      if (i >= nv) continue;
      float4 rs, up;
      uchar4 k;
      k.x = apply1(a[b].x, tau, rs.x, up.x, m);
      k.y = apply1(a[b].y, tau, rs.y, up.y, m);
      k.z = apply1(a[b].z, tau, rs.z, up.z, m);
      k.w = apply1(a[b].w, tau, rs.w, up.w, m);
      reinterpret_cast<float4*>(res)[i] = rs;
      reinterpret_cast<float4*>(upd)[i] = up;
      reinterpret_cast<uchar4*>(keep)[i] = k;
      if (ACC) reinterpret_cast<float4*>(acc)[i] = a[b];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const long long j = 4 * nv + threadIdx.x;
    float a = g[j];
    if (RESIDUAL) a += r[j];
    keep[j] = apply1(a, tau, res[j], upd[j], m);
    if (ACC) acc[j] = a;
  }
  block_min_into(m, kept_tau);
}

template <bool RESIDUAL, bool ACC, bool VEC>
static cudaError_t threshold_apply_launch(const float* g, const float* r,
                                          long long n, const float* tau,
                                          unsigned char* keep, float* res,
                                          float* upd, float* acc,
                                          float* kept_tau, cudaStream_t s) {
  static std::atomic<int> occ[MAX_DEVICES];
  const void* fn = (const void*)threshold_apply_kernel<RESIDUAL, ACC, VEC>;
  const long long batch = (long long)APPLY_BATCH * APPLY_THREADS;
  long long grid = ((n >> 2) + batch - 1) / batch;
  if (grid < 1) grid = 1;
  const cudaError_t e =
      persistent_grid(fn, APPLY_THREADS, occ, grid, &grid);
  if (e != cudaSuccess) return e;
  threshold_apply_kernel<RESIDUAL, ACC, VEC>
      <<<(unsigned)grid, APPLY_THREADS, 0, s>>>(g, r, n, tau, keep, res, upd,
                                                acc, kept_tau);
  return cudaSuccess;
}

template <bool RESIDUAL, bool ACC>
static cudaError_t threshold_apply_dispatch(bool vec, const float* g,
                                            const float* r, long long n,
                                            const float* tau,
                                            unsigned char* keep, float* res,
                                            float* upd, float* acc,
                                            float* kept_tau, cudaStream_t s) {
  return vec ? threshold_apply_launch<RESIDUAL, ACC, true>(
                   g, r, n, tau, keep, res, upd, acc, kept_tau, s)
             : threshold_apply_launch<RESIDUAL, ACC, false>(
                   g, r, n, tau, keep, res, upd, acc, kept_tau, s);
}

// ---- SGD apply (5) ---------------------------------------------------------
#define SGD_THREADS 256
#define SGD_TILE 32    // a tiled item: SGD_TILE_A a by SGD_TILE j
#define SGD_TILE_A 64
#define SGD_TILE_ROWS (SGD_THREADS / SGD_TILE)
#define SGD_BATCH 4    // groups of 4 a thread loads at once
#define SGD_ITEM (SGD_THREADS * 4 * SGD_BATCH)  // elements of an other item
#define SGD_MAX_RANK 8
// A leaf's record in the table: int64 words.
enum {
  SGD_OFF = 0,   // offset of the leaf's segment in u
  SGD_P,         // p's address
  SGD_B,         // b's address (0 without momentum)
  SGD_KIND,      // SGD_IDENTITY, SGD_TILED or SGD_STRIDED
  SGD_FRESH,     // 1: no buffer before this step (read when use_fresh)
  SGD_NUMEL,     // elements
  SGD_A,         // tiled: A, I, S; strided: the rank in SGD_A
  SGD_I,
  SGD_S,
  SGD_DIMS,      // strided: p's (merged) dims, then their strides in u
  SGD_STRIDES = SGD_DIMS + SGD_MAX_RANK,
  SGD_REC = SGD_STRIDES + SGD_MAX_RANK
};
enum { SGD_IDENTITY = 0, SGD_TILED = 1, SGD_STRIDED = 2 };

struct SgdArgs {
  float neg_lr, m, wd;
  int momentum, nesterov, has_wd, use_fresh;
};

// x + alpha*y as PyTorch's alpha ops (foreach and single-tensor add) round
// it on the card: one fused multiply-add.
__device__ __forceinline__ float alpha_add(float x, float alpha, float y) {
  return __fmaf_rn(alpha, y, x);
}

// One element: p and b updated in place from u.
__device__ __forceinline__ void sgd1(float u, float& p, float& b, bool fresh,
                                     const SgdArgs& a) {
  float g = a.has_wd ? alpha_add(u, a.wd, p) : u;
  if (a.momentum) {
    b = fresh ? g : __fadd_rn(__fmul_rn(b, a.m), g);
    g = a.nesterov ? alpha_add(g, a.m, b) : b;
  }
  p = alpha_add(p, a.neg_lr, g);
}

// Item `item` of an identity leaf of n elements: SGD_BATCH groups of 4 a
// thread, all loaded before any is stored; 16-byte loads where u, p and b
// allow (VU: u; VPB: p and b), else 4 single loads a group.
template <bool VU, bool VPB>
__device__ __forceinline__ void sgd_identity(const float* __restrict__ u,
                                             float* __restrict__ p,
                                             float* __restrict__ b,
                                             long long n, long long item,
                                             bool fresh, const SgdArgs& a) {
  const long long base = item * SGD_ITEM;
  float4 uu[SGD_BATCH], pp[SGD_BATCH], bb[SGD_BATCH];
#pragma unroll
  for (int k = 0; k < SGD_BATCH; ++k) {
    const long long j = base + 4LL * (threadIdx.x + k * SGD_THREADS);
    bb[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j + 4 <= n) {
      uu[k] = load4<VU>(u + j);
      pp[k] = load4<VPB>(p + j);
      if (a.momentum && !fresh) bb[k] = load4<VPB>(b + j);
    }
  }
#pragma unroll
  for (int k = 0; k < SGD_BATCH; ++k) {
    const long long j = base + 4LL * (threadIdx.x + k * SGD_THREADS);
    if (j + 4 <= n) {
      sgd1(uu[k].x, pp[k].x, bb[k].x, fresh, a);
      sgd1(uu[k].y, pp[k].y, bb[k].y, fresh, a);
      sgd1(uu[k].z, pp[k].z, bb[k].z, fresh, a);
      sgd1(uu[k].w, pp[k].w, bb[k].w, fresh, a);
      if (VPB) {
        *reinterpret_cast<float4*>(p + j) = pp[k];
        if (a.momentum) *reinterpret_cast<float4*>(b + j) = bb[k];
      } else {
        const float pv[4] = {pp[k].x, pp[k].y, pp[k].z, pp[k].w};
        const float bv[4] = {bb[k].x, bb[k].y, bb[k].z, bb[k].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j + e] = pv[e];
          if (a.momentum) b[j + e] = bv[e];
        }
      }
    } else {
      for (long long e = j; e < n; ++e) {  // the leaf's last n % 4
        float pe = p[e];
        float be = a.momentum && !fresh ? b[e] : 0.f;
        sgd1(u[e], pe, be, fresh, a);
        p[e] = pe;
        if (a.momentum) b[e] = be;
      }
    }
  }
}

// Tile `item` of a tiled leaf, p = [A][I][S] and u = [S][I][A]: j = i*S + s
// indexes p's rows of B = I*S; u's row for j is (j % S)*I + j / S. A tile
// is SGD_TILE_A a by SGD_TILE j; every load of the tile (u's rows, p's and
// b's) is issued before the block waits at its barrier.
__device__ __forceinline__ void sgd_tiled(const float* __restrict__ u,
                                          float* __restrict__ p,
                                          float* __restrict__ b, long long A,
                                          long long I, long long S,
                                          long long item, bool fresh,
                                          const SgdArgs& a) {
  constexpr int KU = SGD_TILE / SGD_TILE_ROWS;      // u rows a thread reads
  constexpr int HA = SGD_TILE_A / SGD_TILE;         // 32-float parts a row
  constexpr int KP = SGD_TILE_A / SGD_TILE_ROWS;    // p rows a thread takes
  __shared__ float tile[SGD_TILE][SGD_TILE_A + 1];
  const long long B = I * S;
  const long long tiles_j = (B + SGD_TILE - 1) / SGD_TILE;
  const long long a0 = item / tiles_j * SGD_TILE_A;
  const long long j0 = item % tiles_j * SGD_TILE;
  const int lane = threadIdx.x % SGD_TILE;
  const int row = threadIdx.x / SGD_TILE;
  // u's rows: a warp reads 32 consecutive a of one row j.
  float ut[KU][HA];
#pragma unroll
  for (int k = 0; k < KU; ++k) {
    const long long j = j0 + row + k * SGD_TILE_ROWS;
    const long long ur = j < B ? ((j % S) * I + j / S) * A : 0;
#pragma unroll
    for (int h = 0; h < HA; ++h) {
      const long long aa = a0 + lane + h * SGD_TILE;
      ut[k][h] = j < B && aa < A ? u[ur + aa] : 0.f;
    }
  }
  // p's and b's rows: a warp takes 32 consecutive j of one row a.
  float pv[KP], bv[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const long long aa = a0 + row + k * SGD_TILE_ROWS;
    const long long q = aa * B + j0 + lane;
    const bool in = aa < A && j0 + lane < B;
    pv[k] = in ? p[q] : 0.f;
    bv[k] = in && a.momentum && !fresh ? b[q] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < KU; ++k)
#pragma unroll
    for (int h = 0; h < HA; ++h)
      tile[row + k * SGD_TILE_ROWS][lane + h * SGD_TILE] = ut[k][h];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const long long aa = a0 + row + k * SGD_TILE_ROWS;
    const long long q = aa * B + j0 + lane;
    if (aa < A && j0 + lane < B) {
      sgd1(tile[lane][row + k * SGD_TILE_ROWS], pv[k], bv[k], fresh, a);
      p[q] = pv[k];
      if (a.momentum) b[q] = bv[k];
    }
  }
}

// Item `item` of a strided leaf: an element at a time, its place in u from
// p's dims (rank r) and their strides in u.
__device__ __forceinline__ void sgd_strided(const float* __restrict__ u,
                                            float* __restrict__ p,
                                            float* __restrict__ b,
                                            const long long* rec,
                                            long long item, bool fresh,
                                            const SgdArgs& a) {
  const long long n = rec[SGD_NUMEL];
  const int r = (int)rec[SGD_A];
  for (int k = 0; k < 4 * SGD_BATCH; ++k) {
    const long long q = item * SGD_ITEM + threadIdx.x + k * SGD_THREADS;
    if (q >= n) break;
    long long rest = q, f = 0;
    for (int d = r - 1; d >= 0; --d) {
      const long long dim = rec[SGD_DIMS + d];
      f += rest % dim * rec[SGD_STRIDES + d];
      rest /= dim;
    }
    float pe = p[q];
    float be = a.momentum && !fresh ? b[q] : 0.f;
    sgd1(u[f], pe, be, fresh, a);
    p[q] = pe;
    if (a.momentum) b[q] = be;
  }
}

// One block an item. table: starts[0..leaves] (the first item of each leaf,
// then the total), then one record of SGD_REC words a leaf.
__global__ void __launch_bounds__(SGD_THREADS)
sgd_apply_kernel(const float* __restrict__ u,
                 const long long* __restrict__ table, int leaves,
                 SgdArgs a) {
  const long long w = blockIdx.x;
  int lo = 0, hi = leaves;  // the leaf l with starts[l] <= w < starts[l + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (table[mid] <= w)
      lo = mid;
    else
      hi = mid;
  }
  const long long* rec = table + leaves + 1 + (long long)lo * SGD_REC;
  const long long item = w - table[lo];
  const float* ul = u + rec[SGD_OFF];
  float* p = reinterpret_cast<float*>(rec[SGD_P]);
  float* b = reinterpret_cast<float*>(rec[SGD_B]);
  const bool fresh = a.use_fresh && rec[SGD_FRESH];
  switch ((int)rec[SGD_KIND]) {
    case SGD_TILED:
      sgd_tiled(ul, p, b, rec[SGD_A], rec[SGD_I], rec[SGD_S], item, fresh,
                a);
      break;
    case SGD_IDENTITY: {
      const bool vu = ((uintptr_t)ul & 15) == 0;
      const bool vpb = (((uintptr_t)p | (uintptr_t)b) & 15) == 0;
      const long long n = rec[SGD_NUMEL];
      if (vu && vpb)
        sgd_identity<true, true>(ul, p, b, n, item, fresh, a);
      else if (vpb)
        sgd_identity<false, true>(ul, p, b, n, item, fresh, a);
      else
        sgd_identity<false, false>(ul, p, b, n, item, fresh, a);
      break;
    }
    default:
      sgd_strided(ul, p, b, rec, item, fresh, a);
  }
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

// The step after tau over acc = g (+ r), n >= 1 elements: keep u8[n] (0 or
// 1), res and upd f32[n], acc f32[n] when not null; kept_tau f32[1] holds
// +inf before the launch and the least kept |acc| after it (+inf if none
// was kept). tau f32[1] on the device. keep 4-byte and res, upd, acc
// 16-byte aligned (g and r need not be). Returns cudaGetLastError().
int gtopk_threshold_apply(const float* g, const float* r, long long n,
                          const float* tau, unsigned char* keep, float* res,
                          float* upd, float* acc, float* kept_tau,
                          void* stream) {
  if (n < 1 || ((uintptr_t)keep & 3) ||
      (((uintptr_t)res | (uintptr_t)upd | (uintptr_t)acc) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (((uintptr_t)g | (uintptr_t)r) & 15) == 0;
  cudaError_t e;
  if (r != nullptr && acc != nullptr)
    e = threshold_apply_dispatch<true, true>(vec, g, r, n, tau, keep, res,
                                             upd, acc, kept_tau, s);
  else if (r != nullptr)
    e = threshold_apply_dispatch<true, false>(vec, g, r, n, tau, keep, res,
                                              upd, acc, kept_tau, s);
  else if (acc != nullptr)
    e = threshold_apply_dispatch<false, true>(vec, g, r, n, tau, keep, res,
                                              upd, acc, kept_tau, s);
  else
    e = threshold_apply_dispatch<false, false>(vec, g, r, n, tau, keep, res,
                                               upd, acc, kept_tau, s);
  const cudaError_t last = cudaGetLastError();  // also clears e
  return (int)(e != cudaSuccess ? e : last);
}

// SGD's step from the flat update u over the `leaves` leaves of `table`
// (on the device; see sgd_apply_kernel), `items` work items in all (the
// table's last start), one block each. neg_lr, m and wd are the float32
// scalars; momentum, nesterov, has_wd (SGD's weight_decay != 0) and
// use_fresh (read the table's fresh flags) 0 or 1. Returns
// cudaGetLastError().
int gtopk_sgd_apply(const float* u, const long long* table, int leaves,
                    long long items, float neg_lr, float m, float wd,
                    int momentum, int nesterov, int has_wd, int use_fresh,
                    void* stream) {
  if (leaves < 1 || items < 1 || items > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const SgdArgs a = {neg_lr, m, wd, momentum, nesterov, has_wd, use_fresh};
  sgd_apply_kernel<<<(unsigned)items, SGD_THREADS, 0, (cudaStream_t)stream>>>(
      u, table, leaves, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
