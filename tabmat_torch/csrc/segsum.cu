// Deterministic segment sum over a sorted plan, for Hopper (sm_90a), in f64
// and f32:
//
//   out[s, j] = sum_{bounds[s] <= t < bounds[s+1]} values[perm[t], j]
//
// for values (n, m) row-major (m = 1 for a vector), perm (E,) int32 rows
// sorted by segment, bounds (W + 1,) int32 with bounds[0] = 0 and
// bounds[W] = E.  Rows with a sentinel code (missing, drop_first) are not in
// perm, so they fall in no segment.
//
// Replaces tabmat_tpu/ops/pallas_segsum.py:_segsum_kernel (one-hot MXU
// contraction of exact bf16 slices, W <= 2^14) and
// tabmat_tpu/ops/pallas_segsum_bucketed.py:_segsum_bucketed_kernel (the
// same, factorised through the code's high and low bits, W <= 2^17).  The
// TPU formed the sums as matrix products because its gathers are slow and
// it has no f64; Hopper gathers natively, so the kernel reads the plan.
//
// Bound: the bytes.  At 1M rows and m = 1 it reads perm (4 MB), one value
// per element (8 MB in f64) and bounds, and writes W values; the values are
// gathered through perm, so each 8-byte read costs a 32-byte sector.
//
// Segment lengths range from 1 to E (W = 1 puts every element in one
// segment; a 1000 x 1000 cross has ~1 element in most of 10^6 segments and
// many empty ones), so the work is balanced over the sorted ELEMENTS, never
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
//   pass 2: one warp per segment that spans chunks c0 < c1 (the plan lists
//           them): lane l sums chunks c0 + l, c0 + l + 32, ... in order
//           (part_hi of c0, part_lo of the rest), then a butterfly over the
//           lanes.  Every lane holds the same sum; lane 0 writes it.
//
// No atomics and a fixed order: a result repeats bit for bit.  Columns go in
// groups of MAXM (grid y).  The C functions launch on the given stream, do
// not synchronise and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 16;    // sorted elements per thread in pass 1
constexpr int MAXM = 8;      // value columns per thread
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
segsum_chunks(const T* __restrict__ values, const int* __restrict__ perm,
              const int* __restrict__ bounds, int W, long long E, int m,
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
    const T* row = values + (long long)perm[t] * m + j0;
#pragma unroll
    for (int j = 0; j < MAXM; ++j)
      if (j < nj) acc[j] += row[j];
  }
  flush(acc, nj, s, (long long)bounds[s], end, a, b, c, m, j0, out, part_lo, part_hi);
  // empty segments at position b
  for (++s; s < W && bounds[s + 1] == b; ++s)
    for (int j = 0; j < nj; ++j) out[(long long)s * m + j0 + j] = T(0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
segsum_join(const int* __restrict__ bounds, const int* __restrict__ spanning,
            int n_span, int m, const T* __restrict__ part_lo,
            const T* __restrict__ part_hi, T* __restrict__ out) {
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

template <typename T>
int launch(const T* values, const int* perm, const int* bounds, const int* spanning,
           int W, long long E, int m, int n_span, T* out, T* part_lo, T* part_hi,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned groups = (unsigned)((m + MAXM - 1) / MAXM);
  const long long chunks = (E + CHUNK - 1) / CHUNK;
  const dim3 grid1((unsigned)((chunks + THREADS - 1) / THREADS), groups);
  segsum_chunks<T><<<grid1, THREADS, 0, st>>>(values, perm, bounds, W, E, m, out,
                                               part_lo, part_hi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_span == 0) return (int)err;
  const int warps_per_block = THREADS / 32;
  const dim3 grid2((unsigned)((n_span + warps_per_block - 1) / warps_per_block), groups);
  segsum_join<T><<<grid2, THREADS, 0, st>>>(bounds, spanning, n_span, m, part_lo,
                                             part_hi, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out holds W * m values; part_lo and part_hi hold ceil(E / CHUNK) * m each.
// E >= 1: with no element every segment is empty, and the wrapper returns
// zeros without a launch.
int tabmat_segsum_f64(const double* values, const int* perm, const int* bounds,
                      const int* spanning, int W, long long E, int m, int n_span,
                      double* out, double* part_lo, double* part_hi, void* stream) {
  return launch<double>(values, perm, bounds, spanning, W, E, m, n_span, out, part_lo,
                        part_hi, stream);
}

int tabmat_segsum_f32(const float* values, const int* perm, const int* bounds,
                      const int* spanning, int W, long long E, int m, int n_span,
                      float* out, float* part_lo, float* part_hi, void* stream) {
  return launch<float>(values, perm, bounds, spanning, W, E, m, n_span, out, part_lo,
                       part_hi, stream);
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
