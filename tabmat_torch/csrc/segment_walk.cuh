// The deterministic two-pass walk over a sorted segment layout, shared by
// segsum.cu and spmv.cu (Hopper, sm_90a):
//
//   out[s, j] = sum_{bounds[s] <= t < bounds[s+1]} term(t, j)
//
// for bounds (W + 1,) int32 with bounds[0] = 0 and bounds[W] = E, and an
// output of W rows of m values.  A Term says what element t adds to the m
// columns: segsum.cu gathers values[perm[t], j], spmv.cu scales
// values[idx[t], j] by a[t] (and scale[idx[t]]).
//
// Segment lengths range from 0 to E (a CSR matvec of 3M rows and 90k
// nonzeros leaves most segments empty; a CSC tmv of 3 columns puts 30k
// elements in each), so the work is balanced over the sorted ELEMENTS, never
// one thread or warp per segment:
//
//   pass 1: thread c walks the CHUNK elements [c*CHUNK, (c+1)*CHUNK) in
//           order, summing each run of one segment.  A segment that lies
//           inside the chunk is complete: the thread writes out[s].  The run
//           of a segment that began before the chunk goes to part_lo[c], the
//           run of one that continues past it to part_hi[c] (both, when the
//           chunk lies inside one segment).  The thread also writes 0 for the
//           empty segments that sit at its elements (an empty segment at
//           position p belongs to the chunk holding element p - 1, or to
//           chunk 0 when p = 0).
//   pass 2: one warp per segment that spans chunks c0 < c1 (the caller lists
//           them): lane l sums chunks c0 + l, c0 + l + 32, ... in order
//           (part_hi of c0, part_lo of the rest), then a butterfly over the
//           lanes.  Every lane holds the same sum; lane 0 writes it.
//
// No atomics and a fixed order: a result repeats bit for bit.  Columns go in
// groups of MAXM (grid y).  launch_walk launches on the given stream, does
// not synchronise and returns cudaGetLastError().

#pragma once

#include <cuda_runtime.h>

namespace tabmat {

constexpr int CHUNK = 16;    // sorted elements per thread in pass 1
constexpr int MAXM = 8;      // output columns per thread
constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ void flush(T (&acc)[MAXM], int nj, int s, long long start,
                                      long long end, long long a, long long b,
                                      long long c, int m, int j0, T* __restrict__ out,
                                      T* __restrict__ part_lo, T* __restrict__ part_hi) {
  // constant indices into acc after unrolling, so it stays in registers
  if (start >= a && end <= b) {
    T* o = out + (long long)s * m + j0;
#pragma unroll
    for (int j = 0; j < MAXM; ++j)
      if (j < nj) o[j] = acc[j];
  } else {
    if (start < a) {
      T* o = part_lo + c * m + j0;
#pragma unroll
      for (int j = 0; j < MAXM; ++j)
        if (j < nj) o[j] = acc[j];
    }
    if (end > b) {
      T* o = part_hi + c * m + j0;
#pragma unroll
      for (int j = 0; j < MAXM; ++j)
        if (j < nj) o[j] = acc[j];
    }
  }
#pragma unroll
  for (int j = 0; j < MAXM; ++j) acc[j] = T(0);
}

template <typename T, typename Term>
__global__ void __launch_bounds__(THREADS)
walk_chunks(Term term, const int* __restrict__ bounds, int W, long long E, int m,
            T* __restrict__ out, T* __restrict__ part_lo, T* __restrict__ part_hi) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long a = c * CHUNK;
  if (a >= E) return;
  const long long b = a + CHUNK < E ? a + CHUNK : E;
  const int j0 = blockIdx.y * MAXM;
  const int nj = m - j0 < MAXM ? m - j0 : MAXM;

  // the segment holding element a: the last s with bounds[s] <= a
  int lo = 0;
  int hi = W;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bounds[mid] <= a) lo = mid; else hi = mid - 1;
  }
  int s = lo;
  if (a == 0) {
    // empty segments at position 0
    for (int e = 0; e < s; ++e)
      for (int j = 0; j < nj; ++j) out[(long long)e * m + j0 + j] = T(0);
  }

  T acc[MAXM];
#pragma unroll
  for (int j = 0; j < MAXM; ++j) acc[j] = T(0);
  long long end = bounds[s + 1];
  for (long long t = a; t < b; ++t) {
    while (end <= t) {  // segment s ends before t (later ones may be empty)
      flush(acc, nj, s, (long long)bounds[s], end, a, b, c, m, j0, out, part_lo, part_hi);
      ++s;
      end = bounds[s + 1];
    }
    term.add(acc, t, nj, j0);
  }
  flush(acc, nj, s, (long long)bounds[s], end, a, b, c, m, j0, out, part_lo, part_hi);
  // empty segments at position b
  for (++s; s < W && bounds[s + 1] == b; ++s)
    for (int j = 0; j < nj; ++j) out[(long long)s * m + j0 + j] = T(0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
walk_join(const int* __restrict__ bounds, const int* __restrict__ spanning, int n_span,
          int m, const T* __restrict__ part_lo, const T* __restrict__ part_hi,
          T* __restrict__ out) {
  const int warp = (int)(((long long)blockIdx.x * THREADS + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_span) return;
  const int s = spanning[warp];
  const long long c0 = bounds[s] / CHUNK;
  const long long c1 = (bounds[s + 1] - 1LL) / CHUNK;
  const int j0 = blockIdx.y * MAXM;
  const int nj = m - j0 < MAXM ? m - j0 : MAXM;
  for (int j = j0; j < j0 + nj; ++j) {
    T x = T(0);
    for (long long cc = c0 + lane; cc <= c1; cc += 32)
      x += cc == c0 ? part_hi[cc * m + j] : part_lo[cc * m + j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) out[(long long)s * m + j] = x;
  }
}

// out holds W * m values; part_lo and part_hi hold ceil(E / CHUNK) * m each.
// E >= 1: with no element every segment is empty, and the wrappers return
// zeros without a launch.
template <typename T, typename Term>
int launch_walk(Term term, const int* bounds, const int* spanning, int W, long long E, int m,
                int n_span, T* out, T* part_lo, T* part_hi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned groups = (unsigned)((m + MAXM - 1) / MAXM);
  const long long chunks = (E + CHUNK - 1) / CHUNK;
  const dim3 grid1((unsigned)((chunks + THREADS - 1) / THREADS), groups);
  walk_chunks<T, Term><<<grid1, THREADS, 0, st>>>(term, bounds, W, E, m, out, part_lo, part_hi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_span == 0) return (int)err;
  const int warps_per_block = THREADS / 32;
  const dim3 grid2((unsigned)((n_span + warps_per_block - 1) / warps_per_block), groups);
  walk_join<T><<<grid2, THREADS, 0, st>>>(bounds, spanning, n_span, m, part_lo, part_hi, out);
  return (int)cudaGetLastError();
}

}  // namespace tabmat
