// Sandwich product S = X^T diag(d) X for Hopper (sm_90a), in f64 and f32,
// and the per-column range prepass max_i |X[i, j]| * |d[i]|.
//
// Replaces the TPU kernels on the dense main path:
//   - tabmat_tpu/ops/pallas_sandwich_v4.py:_v4_kernel (exact f64 through
//     int8 planes) and tabmat_tpu/ops/pallas_kernels.py:_sandwich_kernel
//     (full f32, HIGHEST) by sandwich_partial/sandwich_reduce.  Hopper has
//     native FP64, so one template computes the product directly in the
//     input type.  f32 uses plain FFMA (never TF32), as the Pallas kernel
//     used Precision.HIGHEST.  The wrapper's width dispatch sends it f32
//     k > 176 only; in f64 it is off the route, reached only through
//     sandwich_kernel.sandwich_tiled (the yardstick of the f64 triangle
//     kernel).  sandwich_narrow.cu takes k <= 32, sandwich_tri.cu f32
//     33 <= k <= 176, sandwich_mma_tri.cu f64 33 <= k <= 128 (and with it
//     the unpacked v5 and v3 kernels), sandwich_mma.cu f64 k > 128;
//   - tabmat_tpu/ops/pallas_sandwich_v4.py:_max_kernel by column_absmax.
//     On the TPU it picks the plane exponents that keep the scaled values in
//     range.  The port's narrow format is the f32 Hessian of the default
//     IRLS step, and the same maxima pick the power-of-two weight scale that
//     keeps that Hessian in f32 range (tabmat_torch/glm.py).
//
// Inputs: X (n, k) row-major contiguous, d (n,) of X's type.  d may be
// negative or zero; rows masked by an active set arrive as zeros in d.
//
// Bound at 1M x 50 f64: about 2.5 GFLOP for the upper triangle against
// 400 MB of X, ~6 FLOP/byte, just under the FP64 ridge (34 TFLOP/s without
// tensor cores over 3.35 TB/s, ~10 FLOP/byte).  So the design reads X once
// per column tile and folds d into the staged rows:
//
//   pass 1: grid (upper-triangular 64x64 output tile pairs) x (row splits).
//           Each block stages ROWS rows of its two column tiles in shared
//           memory (the ti side already scaled by d) and every thread keeps
//           a 4x4 register micro-tile over the block's row range.  For
//           k <= 64 there is one tile pair, so X is read exactly once.  The
//           block writes its tile to partial[split].
//   pass 2: one thread per output entry sums the splits in a fixed order and
//           reads the upper-triangular entry for both (i, j) and (j, i)
//           (sandwich_reduce.cuh); with accumulate it adds them to out.
//
// No atomics: the result is the same from run to run and exactly symmetric.
// The C functions launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include "sandwich_reduce.cuh"

namespace {

constexpr int TILE = 64;                 // output tile edge (columns of X)
constexpr int EDGE = 16;                 // threads along a tile edge
constexpr int MICRO = TILE / EDGE;       // outputs per thread along an edge
constexpr int THREADS = EDGE * EDGE;     // 256
constexpr int ROWS = 32;                 // rows of X staged per iteration

__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
sandwich_partial(const T* __restrict__ X, const T* __restrict__ d,
                 T* __restrict__ partial, long long n, int k,
                 long long rows_per_split) {
  __shared__ T As[ROWS][TILE];  // d-scaled rows of column tile ti
  __shared__ T Bs[ROWS][TILE];  // rows of column tile tj

  // blockIdx.x enumerates the tile pairs ti <= tj row by row
  const int nt = (k + TILE - 1) / TILE;
  int p = blockIdx.x;
  int ti = 0;
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int ci = ti * TILE;
  const int cj = tj * TILE;

  const long long row_begin = (long long)blockIdx.y * rows_per_split;
  const long long row_end =
      row_begin + rows_per_split < n ? row_begin + rows_per_split : n;

  const int tx = threadIdx.x % EDGE;
  const int ty = threadIdx.x / EDGE;
  T acc[MICRO][MICRO];
#pragma unroll
  for (int u = 0; u < MICRO; ++u)
#pragma unroll
    for (int v = 0; v < MICRO; ++v) acc[u][v] = T(0);

  for (long long r0 = row_begin; r0 < row_end; r0 += ROWS) {
    // a warp stages 32 neighbouring columns of one row: coalesced reads
    for (int e = threadIdx.x; e < ROWS * TILE; e += THREADS) {
      const int r = e / TILE;
      const int c = e % TILE;
      const long long row = r0 + r;
      T a = T(0);
      T b = T(0);
      if (row < row_end) {
        const T* xr = X + row * k;
        if (ci + c < k) a = d[row] * xr[ci + c];
        if (cj + c < k) b = xr[cj + c];
      }
      As[r][c] = a;
      Bs[r][c] = b;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < ROWS; ++r) {
      // strided micro-tile: a warp reads 2 broadcast As values and 16
      // neighbouring Bs values, so there are no bank conflicts
      T a[MICRO];
      T b[MICRO];
#pragma unroll
      for (int m = 0; m < MICRO; ++m) {
        a[m] = As[r][ty + EDGE * m];
        b[m] = Bs[r][tx + EDGE * m];
      }
#pragma unroll
      for (int u = 0; u < MICRO; ++u)
#pragma unroll
        for (int v = 0; v < MICRO; ++v) acc[u][v] = fma_t(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }

  T* out = partial + (long long)blockIdx.y * k * k;
#pragma unroll
  for (int u = 0; u < MICRO; ++u) {
    const int i = ci + ty + EDGE * u;
#pragma unroll
    for (int v = 0; v < MICRO; ++v) {
      const int j = cj + tx + EDGE * v;
      if (i < k && j < k) out[(long long)i * k + j] = acc[u][v];
    }
  }
}

template <typename T>
int launch(const T* X, const T* d, T* out, T* partial, long long n, int k,
           int splits, long long rows_per_split, int accumulate, void* stream) {
  const int nt = (k + TILE - 1) / TILE;
  const dim3 grid(nt * (nt + 1) / 2, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sandwich_partial<T><<<grid, THREADS, 0, s>>>(X, d, partial, n, k, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sandwich_reduce<T>(partial, out, k, splits, accumulate, s);
}

// ---------------------------------------------------------------------------
// Per-column maxima m[j] = max_i |X[i, j]| * |d[i]| of an f32 X (the f32 copy
// of the design) and f64 weights, in f64, so that weights beyond the f32
// range still give a finite maximum.  NaN propagates, as jnp.maximum does.
//
//   pass 1: grid (column blocks of AM_COLS) x (row splits).  A warp reads
//           AM_COLS neighbouring columns of one row; the AM_ROWS warps of a
//           block take every AM_ROWS-th row of its split.  The block writes
//           its maxima to partial[split].
//   pass 2: one thread per column takes the maximum over the splits.

constexpr int AM_COLS = 32;
constexpr int AM_ROWS = 8;

__device__ __forceinline__ double nan_max(double a, double b) {
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(AM_COLS * AM_ROWS)
column_absmax_partial(const float* __restrict__ X, const double* __restrict__ d,
                      double* __restrict__ partial, long long n, int k,
                      long long rows_per_split) {
  __shared__ double red[AM_ROWS][AM_COLS];
  const int c = blockIdx.x * AM_COLS + threadIdx.x;
  const long long row_begin = (long long)blockIdx.y * rows_per_split;
  const long long row_end =
      row_begin + rows_per_split < n ? row_begin + rows_per_split : n;
  double m = 0.0;
  if (c < k) {
    for (long long r = row_begin + threadIdx.y; r < row_end; r += AM_ROWS)
      m = nan_max(fabs((double)X[r * k + c]) * fabs(d[r]), m);
  }
  red[threadIdx.y][threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.y == 0 && c < k) {
#pragma unroll
    for (int t = 1; t < AM_ROWS; ++t) m = nan_max(red[t][threadIdx.x], m);
    partial[(long long)blockIdx.y * k + c] = m;
  }
}

__global__ void column_absmax_reduce(const double* __restrict__ partial,
                                     double* __restrict__ out, int k, int splits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= k) return;
  double m = 0.0;
  for (int s = 0; s < splits; ++s) m = nan_max(partial[(long long)s * k + c], m);
  out[c] = m;
}

}  // namespace

extern "C" {

// partial holds splits * k doubles; out holds k.
int tabmat_column_absmax(const float* X, const double* d, double* out, double* partial,
                         long long n, int k, int splits, long long rows_per_split,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((k + AM_COLS - 1) / AM_COLS, splits);
  column_absmax_partial<<<grid, dim3(AM_COLS, AM_ROWS), 0, s>>>(X, d, partial, n, k,
                                                                 rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  column_absmax_reduce<<<(k + threads - 1) / threads, threads, 0, s>>>(partial, out, k,
                                                                       splits);
  return (int)cudaGetLastError();
}

// partial holds splits * k * k elements; out holds k * k (added to when
// accumulate is not 0).
int tabmat_sandwich_f64(const double* X, const double* d, double* out, double* partial,
                        long long n, int k, int splits, long long rows_per_split,
                        int accumulate, void* stream) {
  return launch<double>(X, d, out, partial, n, k, splits, rows_per_split, accumulate, stream);
}

int tabmat_sandwich_f32(const float* X, const float* d, float* out, float* partial,
                        long long n, int k, int splits, long long rows_per_split,
                        int accumulate, void* stream) {
  return launch<float>(X, d, out, partial, n, k, splits, rows_per_split, accumulate, stream);
}

// Blocks of the first pass that one SM holds at once, for the wrapper's
// choice of row splits.
int tabmat_sandwich_blocks_per_sm(int is_f64, int* blocks) {
  cudaError_t err =
      is_f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, sandwich_partial<double>, THREADS, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, sandwich_partial<float>, THREADS, 0);
  return (int)err;
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
