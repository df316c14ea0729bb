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
  float4 a;
  if (VEC) {
    a = *reinterpret_cast<const float4*>(x + j);
  } else {
    a = make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
  }
  if (MODE == MODE_RESIDUAL) {
    float4 b;
    if (VEC) {
      b = *reinterpret_cast<const float4*>(r + j);
    } else {
      b = make_float4(r[j], r[j + 1], r[j + 2], r[j + 3]);
    }
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
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
