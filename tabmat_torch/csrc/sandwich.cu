// The per-column range prepass of the sandwich for Hopper (sm_90a):
// m[j] = max_i |X[i, j]| * |d[i]|.
//
// Replaces tabmat_tpu/ops/pallas_sandwich_v4.py:_max_kernel.  On the TPU it
// picks the plane exponents that keep the scaled values in range.  The
// port's narrow format is the f32 Hessian of the default IRLS step, and the
// same maxima pick the power-of-two weight scale that keeps that Hessian in
// f32 range (tabmat_torch/glm.py).  The sandwiches themselves are the
// width dispatch's (ops/sandwich_kernel.py:route): sandwich_narrow.cu takes
// k <= 32, sandwich_tri.cu f32 33 <= k <= 176, sandwich_wide.cu f32
// k > 176, sandwich_mma_tri.cu f64 33 <= k <= 128, sandwich_mma.cu f64
// k > 128.
//
// Inputs: X (n, k) row-major contiguous f32, d (n,) f64.  The C functions
// launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

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

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
