// Second pass of the sandwiches over tile pairs (sandwich_wide.cu,
// sandwich_mma.cu): sum the first pass's per-split partials of
// S = X^T diag(d) X in a fixed order and mirror the upper triangle.
//
// partial holds splits blocks of k * k; the block of the output tile pair
// (tile(lo), tile(hi)) wrote the entry (lo, hi), lo <= hi.  One thread per
// output entry reads (lo, hi) for both (i, j) and (j, i), so S is exactly
// symmetric and repeats bit for bit.  With accumulate the sum is added to
// out (row panels of one product add up in order in one k x k buffer).

#pragma once

#include <cuda_runtime.h>

template <typename T>
__global__ void sandwich_reduce(const T* __restrict__ partial, T* __restrict__ out, int k,
                                int splits, int accumulate) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long kk = (long long)k * k;
  if (idx >= kk) return;
  const int i = (int)(idx / k);
  const int j = (int)(idx % k);
  const int lo = i < j ? i : j;
  const int hi = i < j ? j : i;
  const T* src = partial + (long long)lo * k + hi;
  T s = T(0);
  for (int r = 0; r < splits; ++r) s += src[r * kk];
  out[idx] = accumulate ? out[idx] + s : s;
}

// Launch the reduction on stream s; returns cudaGetLastError().
template <typename T>
int launch_sandwich_reduce(const T* partial, T* out, int k, int splits, int accumulate,
                           cudaStream_t s) {
  const long long kk = (long long)k * k;
  const int threads = 256;
  const unsigned blocks = (unsigned)((kk + threads - 1) / threads);
  sandwich_reduce<T><<<blocks, threads, 0, s>>>(partial, out, k, splits, accumulate);
  return (int)cudaGetLastError();
}
