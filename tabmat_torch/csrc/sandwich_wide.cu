// Wide sandwich S = X^T diag(d) X for float32 X at k >= 177 on Hopper
// (sm_90a).
//
// Replaces tabmat_tpu/ops/pallas_kernels.py:_sandwich_kernel (f32,
// Precision.HIGHEST, one pass over X) past the widths of sandwich_tri.cu,
// and the XLA einsum the JAX package takes past its k <= 1023.  The
// product is plain FP32 FFMA, never TF32: (d * x) is rounded to f32 as the
// plain version rounds it, then multiplied and added.
//
// Bound by operations at every width it takes: at 400k x 200 the upper
// triangle's 16.1 GFLOP need 0.241 ms at 67 TFLOP/s against 0.097 ms for
// the 320 MB of X; at 200k x 1000 0.200 TFLOP, 2.99 ms.  The 64 x 64 tiles
// of sandwich.cu read 8 shared scalars for 16 FFMAs (an SM issues four FFMA
// warp-instructions a cycle but serves one shared wavefront), stage rows
// synchronously with a division, a modulo and a weight load an element, and
// pad k = 200 to 256 columns a side.  Here:
//
//   pass 1: grid (upper-triangular pairs of 128-column tiles) x (row
//           splits).  The host sizes the splits, pair by pair, and passes
//           each pair's rows a split as a table (pair_rows): the kernel
//           covers its rows only if gridDim.y * pair_rows[p] >= n, which
//           the host's plan makes so, and a split past a pair's rows writes
//           zeros.  (The wrapper sizes a pair's splits by its busiest
//           scheduler, ceil(active warps / 4) warps, see below, so that
//           each split keeps it about as long, and fills one wave of
//           resident blocks: two an SM, at most 128 registers a thread.)
//           A block of 256 threads owns one 128 x 128 tile pair in 8 x 8
//           micro-tiles, one a thread: warp tile q holds rows
//           64 (q / 4) .. + 63 and columns 32 (q % 4) .. + 31 of the
//           pair, a warp's lanes 8 x 4 micro-tiles, so
//           a row costs a thread four 16-byte shared loads for 64 FFMAs,
//           the a-side loads of a warp one wavefront (halves swapped for
//           lanes 4-7 of a column, eight distinct bank slots) and the
//           b-side ones four distinct slots.  A warp tile that starts past
//           the tile, or lies wholly below the diagonal of a diagonal pair,
//           is skipped; the others go to warps 0, 1, ... in order, so that
//           the active warps spread over the SM's four schedulers (6 warps
//           on a diagonal pair, 6 and 4 at k = 200's narrow last tile of
//           72 columns, whose column granularity is a warp's 32).
//           Both 128-column strips of BK = 32 rows and their weights are
//           copied with cp.async, three stages, 16-byte copies where
//           k % 4 == 0, else 8 or 4 bytes; a thread's copy slots are fixed
//           at the start, so a copy costs no division.  d * x is applied
//           once a stage to the staged a-strip (a diagonal pair stages one
//           strip and scales it into the other slot), so the row loop is
//           four loads and 64 FFMAs; a stage is scaled one stage ahead of
//           its products, so a stage costs one barrier.  The block writes
//           the upper entries of its tile to partial[split] (k x k).
//   pass 2: one thread per output entry sums the splits in a fixed order and
//           mirrors the upper triangle (sandwich_reduce.cuh); with
//           accumulate it adds to out.
//
// No atomics: the result is the same from run to run and exactly symmetric.
// The C functions launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "sandwich_reduce.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MT = 8;                   // micro-tile edge: a thread's 8 x 8 outputs
constexpr int TILE = 128;               // column tile: a block's tile pair is 128 x 128
constexpr int WARP_ROWS = 64;           // a warp's 8 x 4 micro-tiles: 64 rows ...
constexpr int WARP_COLS = 32;           // ... by 32 columns
constexpr int MIN_K = 177;              // narrower widths go to sandwich_tri.cu
constexpr int BK = 32;                  // rows of X a stage
constexpr int STRIP = BK * TILE;        // floats of one strip's stage
constexpr int STAGE_FLOATS = 2 * STRIP + BK;  // a-strip, b-strip, weights
constexpr int STAGES = 3;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);  // 98,688

static_assert((TILE / WARP_ROWS) * (TILE / WARP_COLS) * 32 == THREADS, "one micro-tile a thread");
static_assert(STRIP % (4 * THREADS) == 0, "the scaling pass takes whole float4 turns");

// VEC floats global -> shared, asynchronously
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(VEC * 4));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A thread's part of copying a strip: column c of rows r_first,
// r_first + passes, ... (r_first >= BK: no part)
struct Slot {
  int c, r_first, passes;
};

__device__ __forceinline__ Slot slot_of(int width, int vec) {
  const int per_row = width / vec;
  const int passes = THREADS / per_row;
  const int r_first = (int)threadIdx.x / per_row;
  return {((int)threadIdx.x - r_first * per_row) * vec, r_first < passes ? r_first : BK,
          passes};
}

// rows [r0, r0 + rows) of X's columns [c0, c0 + width), row r at buf + r * TILE
template <int VEC>
__device__ __forceinline__ void stage_strip(float* buf, const float* __restrict__ X, long long r0,
                                            int rows, int k, int c0, Slot s) {
  const float* src = X + (r0 + s.r_first) * k + c0 + s.c;
  float* dst = buf + s.r_first * TILE + s.c;
  for (int r = s.r_first; r < rows; r += s.passes) {
    copy_async<VEC>(dst, src);
    src += (long long)s.passes * k;
    dst += s.passes * TILE;
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// one row into a thread's micro-tile: its operands at off floats past the
// four pointers (the a-side already scaled by the row's weight)
__device__ __forceinline__ void fma_row(float (&acc)[MT][MT], const float* xa, const float* xa2,
                                        const float* xb, const float* xb2, int off) {
  const float4 a0 = load4(xa + off), a1 = load4(xa2 + off);
  const float4 b0 = load4(xb + off), b1 = load4(xb2 + off);
  const float a[MT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[MT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int v = 0; v < MT; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
}

// the rows of one stage into a thread's micro-tile
__device__ __forceinline__ void stage_products(float (&acc)[MT][MT], const float* buf_a,
                                               const float* buf_b, int rows,
                                               int a_first, int a_second, int b_first) {
  const float* xa = buf_a + a_first;
  const float* xa2 = buf_a + a_second;
  const float* xb = buf_b + b_first;
  const float* xb2 = buf_b + b_first + 4;
  int r = 0;
  for (; r + 1 < rows; r += 2) {
    fma_row(acc, xa, xa2, xb, xb2, 0);
    fma_row(acc, xa, xa2, xb, xb2, TILE);
    xa += 2 * TILE;
    xa2 += 2 * TILE;
    xb += 2 * TILE;
    xb2 += 2 * TILE;
  }
  if (r < rows) fma_row(acc, xa, xa2, xb, xb2, 0);
}

// dst = src * (the row's weight), every row and column of a stage's strip
__device__ __forceinline__ void scale_strip(float* dst, const float* src, const float* wbuf) {
#pragma unroll
  for (int i = 0; i < STRIP / (4 * THREADS); ++i) {
    const int e = (i * THREADS + (int)threadIdx.x) * 4;  // a warp covers one row
    const float w = wbuf[e / TILE];
    const float4 x = load4(src + e);
    *reinterpret_cast<float4*>(dst + e) = make_float4(x.x * w, x.y * w, x.z * w, x.w * w);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
wide_partial(const float* __restrict__ X, const float* __restrict__ d,
             float* __restrict__ partial, long long n, int k,
             const long long* __restrict__ pair_rows, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  // blockIdx.x enumerates the tile pairs ti <= tj row by row
  const int nt = (k + TILE - 1) / TILE;
  int p = blockIdx.x;
  int ti = 0;
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  const int tj = ti + p;
  const bool diag = ti == tj;
  const int ca = ti * TILE, cb = tj * TILE;
  const int wa = k - ca < TILE ? k - ca : TILE;  // valid columns of each tile
  const int wb = k - cb < TILE ? k - cb : TILE;

  // The tile's eight warp tiles, q = 0..7 at rows 64 (q / 4) and columns
  // 32 (q % 4); those that start inside the tile and reach the diagonal
  // are taken in order by warps 0, 1, ..., so that the active warps spread
  // over the SM's four schedulers (warp w issues on scheduler w % 4;
  // sandwich_kernel.wide_active_warps counts them the same way to balance
  // the row splits).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int active_warps = 0, q_of_warp = 0;
  for (int q = 0; q < THREADS / 32; ++q) {
    const int r = (q / 4) * WARP_ROWS, c = (q % 4) * WARP_COLS;
    if (r < wa && c < wb && (!diag || r < c + WARP_COLS)) {
      if (active_warps == warp) q_of_warp = q;
      ++active_warps;
    }
  }
  const bool active = warp < active_warps;
  const int i0 = (q_of_warp / 4) * WARP_ROWS + (lane / 4) * MT;  // the micro-tile, in the tile
  const int j0 = (q_of_warp % 4) * WARP_COLS + (lane % 4) * MT;
  // lanes 4-7 of a column load the second half of their rows first (bank
  // slots, see above): register u holds the tile's row i0 + (u ^ sa)
  const int sa = (lane / 4) & 4;
  const int a_first = i0 + sa, a_second = i0 + (sa ^ 4);

  const long long rows_per_split = pair_rows[blockIdx.x];
  const long long row_begin = (long long)blockIdx.y * rows_per_split;
  const long long row_end =
      row_begin + rows_per_split < n ? row_begin + rows_per_split : n;
  const long long span = row_end > row_begin ? row_end - row_begin : 0;
  const int stages = (int)((span + BK - 1) / BK);
  auto rows_of = [&](int st) {
    const long long left = span - (long long)st * BK;
    return (int)(left < BK ? left : BK);
  };
  // the slots: a-strip, b-strip, weights.  A diagonal pair stages its one
  // strip in the b-slot and scales it into the a-slot
  auto a_slot = [&](int st) { return smem + (st % STAGES) * STAGE_FLOATS; };
  auto b_slot = [&](int st) { return a_slot(st) + STRIP; };
  auto w_slot = [&](int st) { return a_slot(st) + 2 * STRIP; };
  const Slot slot_a = slot_of(wa, vec), slot_b = slot_of(wb, vec);
  auto issue = [&](int st) {
    const long long r0 = row_begin + (long long)st * BK;
    const int rows = rows_of(st);
    if (vec == 4) {
      if (!diag) stage_strip<4>(a_slot(st), X, r0, rows, k, ca, slot_a);
      stage_strip<4>(b_slot(st), X, r0, rows, k, cb, slot_b);
    } else if (vec == 2) {
      if (!diag) stage_strip<2>(a_slot(st), X, r0, rows, k, ca, slot_a);
      stage_strip<2>(b_slot(st), X, r0, rows, k, cb, slot_b);
    } else {
      if (!diag) stage_strip<1>(a_slot(st), X, r0, rows, k, ca, slot_a);
      stage_strip<1>(b_slot(st), X, r0, rows, k, cb, slot_b);
    }
    if ((int)threadIdx.x < rows) copy_async<1>(w_slot(st) + threadIdx.x, d + r0 + threadIdx.x);
  };
  auto scale = [&](int st) { scale_strip(a_slot(st), diag ? b_slot(st) : a_slot(st), w_slot(st)); };

  float acc[MT][MT];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int v = 0; v < MT; ++v) acc[u][v] = 0.f;

  // stage st is copy group st; empty groups keep the count uniform
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < stages) issue(st);
    commit();
  }
  wait_copies<STAGES - 2>();  // stage 0
  __syncthreads();
  if (stages > 0) scale(0);
  for (int st = 0; st < stages; ++st) {
    // stage st + 1 has landed (stage st was scaled one turn ago)
    wait_copies<0>();
    // every thread's copies are visible, stage st's scaling is done, and
    // every thread is done with stage st - 1, whose buffer the issue refills
    __syncthreads();
    if (st + STAGES - 1 < stages) issue(st + STAGES - 1);
    commit();
    if (st + 1 < stages) scale(st + 1);
    if (active) stage_products(acc, a_slot(st), b_slot(st), rows_of(st), a_first, a_second, j0);
  }
  wait_copies<0>();

  float* out = partial + (long long)blockIdx.y * k * k;
  if (!active) return;
#pragma unroll
  for (int u = 0; u < MT; ++u) {
    const int i = i0 + (u ^ sa);
    if (i >= wa) continue;
#pragma unroll
    for (int v = 0; v < MT; ++v) {
      const int j = j0 + v;
      if (j < wb && (!diag || i <= j)) out[(long long)(ca + i) * k + cb + j] = acc[u][v];
    }
  }
}

int allow_shared_memory() {
  return (int)cudaFuncSetAttribute(wide_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_BYTES);
}

}  // namespace

extern "C" {

// partial holds splits * k * k floats (the upper entries written; a split
// past a pair's rows writes zeros); out holds k * k (added to when
// accumulate is not 0).  pair_rows (on the device) holds one entry a tile
// pair ti <= tj, row by row: the rows of each of its splits, a multiple of
// 32, with splits * pair_rows[p] >= n.  k >= 177.
int tabmat_sandwich_wide_f32(const float* X, const float* d, float* out, float* partial,
                             long long n, int k, int splits, const long long* pair_rows,
                             int accumulate, void* stream) {
  if (k < MIN_K) return (int)cudaErrorInvalidValue;
  const int err_attr = allow_shared_memory();
  if (err_attr != 0) return err_attr;
  const uintptr_t base = reinterpret_cast<uintptr_t>(X);
  const int vec = (k % 4 == 0 && base % 16 == 0) ? 4 : (k % 2 == 0 && base % 8 == 0) ? 2 : 1;
  const int nt = (k + TILE - 1) / TILE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {(void*)&X, (void*)&d, (void*)&partial, (void*)&n, (void*)&k,
                  (void*)&pair_rows, (void*)&vec};
  cudaError_t err = cudaLaunchKernel((const void*)wide_partial, dim3(nt * (nt + 1) / 2, splits),
                                     dim3(THREADS), args, SMEM_BYTES, s);
  if (err != cudaSuccess) return (int)err;
  return launch_sandwich_reduce<float>(partial, out, k, splits, accumulate, s);
}

// Blocks of the first pass that one SM holds at once, for the wrapper's
// choice of row splits (float32 only: is_f64 must be 0).
int tabmat_sandwich_wide_blocks_per_sm(int is_f64, int* blocks) {
  if (is_f64) return (int)cudaErrorInvalidValue;
  const int err = allow_shared_memory();
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wide_partial, THREADS,
                                                            SMEM_BYTES);
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
