// Top-k selection kernels for Hopper (sm_90a), bound to Python via ctypes
// (gtopkssgd_tpu_torch/ops/cuda_topk.py). Plain C interface: no PyTorch
// headers, so nvcc builds this file in seconds.
//
// Two kernels replace the three Pallas TPU kernels of
// gtopkssgd_tpu/ops/pallas_topk.py:
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
//    counts in the same pass.
//    Bound: bytes, 8 B per element read (grad + residual) plus 8 B per
//    bucket written: the same 0.65 us / 61 us as above.
//    Design: one 128-thread block per (tile, row-group), one thread per
//    lane. A thread walks its rpg = 2048/groups rows at stride 128, so a
//    warp reads 32 consecutive floats per row (coalesced), keeping its
//    running max, the first row that reached it, and the signed acc there
//    in registers. The global index is tile*262144 + (g*rpg + row)*128 +
//    lane, exactly the TPU layout. Elements at index >= n have magnitude
//    -1 and value 0, so a bucket made only of padding reports its first
//    slot (index >= n) with value 0, as on the TPU.

#include <cuda_runtime.h>

#define NUM_THR 8
#define LANES 128
#define BLOCK_ROWS 2048
#define TILE (BLOCK_ROWS * LANES)
#define COUNT_THREADS 256

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

template <bool RESIDUAL, bool COUNTS>
__global__ void __launch_bounds__(LANES)
stage1_kernel(const float* __restrict__ g, const float* __restrict__ r,
              long long n, int groups, const float* __restrict__ thr,
              int* __restrict__ counts, float* __restrict__ cand_val,
              int* __restrict__ cand_idx) {
  const int lane = threadIdx.x;
  const int rpg = BLOCK_ROWS / groups;
  const long long tile = blockIdx.x / groups;
  const int grp = blockIdx.x % groups;
  const long long base =
      tile * TILE + (long long)grp * rpg * LANES + lane;
  float t[NUM_THR];
  int c[NUM_THR];
#pragma unroll
  for (int i = 0; i < NUM_THR; ++i) {
    t[i] = COUNTS ? thr[i] : 0.f;
    c[i] = 0;
  }
  float best = -1.f;
  float best_val = 0.f;
  int win = 0;
#pragma unroll 8
  for (int w = 0; w < rpg; ++w) {
    const long long e = base + (long long)w * LANES;
    float a = 0.f;
    float m = -1.f;
    if (e < n) {
      a = g[e];
      if (RESIDUAL) a += r[e];
      m = fabsf(a);
      if (COUNTS) {
#pragma unroll
        for (int i = 0; i < NUM_THR; ++i) c[i] += (m >= t[i]);
      }
    }
    // Strict '>' keeps the FIRST row that reached the maximum; row 0
    // always sets it (w == 0 covers an all-padding bucket at m == -1).
    if (w == 0 || m > best) {
      best = m;
      best_val = a;
      win = w;
    }
  }
  const long long out = (long long)blockIdx.x * LANES + lane;
  cand_val[out] = best_val;
  cand_idx[out] = (int)(base + (long long)win * LANES);
  if (COUNTS) block_add_counts(c, counts);
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
// nblocks*groups*128 entries, nblocks = max(1, ceil(n / 262144)). With thr
// given, counts (zeroed by the caller) also receives the 8 counts of
// |acc| >= thr[i]. Returns cudaGetLastError().
int gtopk_stage1(const float* g, const float* r, long long n, int groups,
                 const float* thr, int* counts, float* cand_val,
                 int* cand_idx, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  long long nblocks = (n + TILE - 1) / TILE;
  if (nblocks < 1) nblocks = 1;
  const dim3 grid((unsigned)(nblocks * groups));
  const bool res = r != nullptr;
  const bool cnt = thr != nullptr;
  if (res && cnt)
    stage1_kernel<true, true><<<grid, LANES, 0, s>>>(
        g, r, n, groups, thr, counts, cand_val, cand_idx);
  else if (res)
    stage1_kernel<true, false><<<grid, LANES, 0, s>>>(
        g, r, n, groups, thr, counts, cand_val, cand_idx);
  else if (cnt)
    stage1_kernel<false, true><<<grid, LANES, 0, s>>>(
        g, r, n, groups, thr, counts, cand_val, cand_idx);
  else
    stage1_kernel<false, false><<<grid, LANES, 0, s>>>(
        g, r, n, groups, thr, counts, cand_val, cand_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
