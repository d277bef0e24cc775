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
// The walk (two passes balanced over the sorted elements, no atomics, a
// fixed order) is segment_walk.cuh's; this file gives it the gathered term.
// The C functions launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include "segment_walk.cuh"

namespace {

template <typename T>
struct GatherTerm {
  const T* values;
  const int* perm;
  int m;

  __device__ __forceinline__ void add(T (&acc)[tabmat::MAXM], long long t, int nj,
                                      int j0) const {
    const T* row = values + (long long)perm[t] * m + j0;
#pragma unroll
    for (int j = 0; j < tabmat::MAXM; ++j)
      if (j < nj) acc[j] += row[j];
  }
};

template <typename T>
int launch(const T* values, const int* perm, const int* bounds, const int* spanning,
           int W, long long E, int m, int n_span, T* out, T* part_lo, T* part_hi,
           void* stream) {
  return tabmat::launch_walk<T>(GatherTerm<T>{values, perm, m}, bounds, spanning, W, E, m,
                                n_span, out, part_lo, part_hi, stream);
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
