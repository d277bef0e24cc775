// Sparse segment products for Hopper (sm_90a), in f64 and f32:
//
//   out[s, j] = sum_{bounds[s] <= t < bounds[s+1]} a[t] * scale[idx[t]] * values[idx[t], j]
//
// for a (E,) per element, idx (E,) int32 source rows sorted by segment,
// bounds (W + 1,) int32 with bounds[0] = 0 and bounds[W] = E, scale (n_src,)
// optional (null: 1), and values (n_src, m) row-major with m >= 1.  Every
// sparse reduction of a SparseMatrix and of a DeviceDesign's sparse block is
// one launch of it:
//
//   CSR X @ v        a = CSR data, idx = CSR columns, bounds = CSR indptr
//   CSC X.T @ r      a = CSC data, idx = CSC rows,    bounds = CSC indptr
//   (2-D V: the same with m columns)
//   column stds      a = CSC data^2, values = weights
//   X.T diag(w) B    CSC, scale = w, values = B (n, kd)
//   X.T diag(w) X    the pair plan: a = sorted pair products, idx = their rows
//   cat.T diag(w) X  the (code, column) plan: a = sorted data, idx = rows
//
// Replaces tabmat_tpu/ops/pallas_tmv_fused.py:_kernel, the one-pass CSR X.T v
// (windowed gather, exact two-product of hi/lo f32 planes, one-hot MXU
// reduction over the column codes), and at the sparse callers the gather and
// window-take kernels plus the one-hot segment sums (pallas_gather.py,
// pallas_window_take.py, pallas_segsum*.py) that the TPU chained with a
// cumsum over all nonzeros.  Hopper has f64 and gathers natively, and the
// CSR and CSC layouts are already sorted segment layouts, so the kernel walks
// them directly and sums each segment on its own: no cumsum, so no error
// that grows with the prefix.
//
// Bound: the bytes.  At 400k nonzeros (the reference's 400k x 100 at 1%) a
// CSC tmv reads a (3.2 MB), idx (1.6 MB), bounds and one gathered value per
// element, about 8 MB: 2.4 us at 3.35 TB/s.  Each gathered 8-byte value costs
// a 32-byte sector unless neighbouring elements share it.
//
// The walk (two passes balanced over the sorted elements, no atomics, a
// fixed order, so a result repeats bit for bit) is segment_walk.cuh's.  The
// C functions launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include "segment_walk.cuh"

namespace {

template <typename T>
struct ProductTerm {
  const T* a;
  const int* idx;
  const T* scale;  // null: no per-row scale
  const T* values;
  int m;

  __device__ __forceinline__ void add(T (&acc)[tabmat::MAXM], long long t, int nj,
                                      int j0) const {
    const int i = idx[t];
    T f = a[t];
    if (scale != nullptr) f *= scale[i];
    const T* row = values + (long long)i * m + j0;
#pragma unroll
    for (int j = 0; j < tabmat::MAXM; ++j)
      if (j < nj) acc[j] += f * row[j];
  }
};

template <typename T>
int launch(const T* a, const int* idx, const int* bounds, const T* scale, const T* values,
           const int* spanning, int W, long long E, int m, int n_span, T* out, T* part_lo,
           T* part_hi, void* stream) {
  return tabmat::launch_walk<T>(ProductTerm<T>{a, idx, scale, values, m}, bounds, spanning,
                                W, E, m, n_span, out, part_lo, part_hi, stream);
}

}  // namespace

extern "C" {

// out holds W * m values; part_lo and part_hi hold ceil(E / CHUNK) * m each.
// E >= 1: with no element every segment is empty, and the wrapper returns
// zeros without a launch.
int tabmat_spmv_f64(const double* a, const int* idx, const int* bounds, const double* scale,
                    const double* values, const int* spanning, int W, long long E, int m,
                    int n_span, double* out, double* part_lo, double* part_hi, void* stream) {
  return launch<double>(a, idx, bounds, scale, values, spanning, W, E, m, n_span, out,
                        part_lo, part_hi, stream);
}

int tabmat_spmv_f32(const float* a, const int* idx, const int* bounds, const float* scale,
                    const float* values, const int* spanning, int W, long long E, int m,
                    int n_span, float* out, float* part_lo, float* part_hi, void* stream) {
  return launch<float>(a, idx, bounds, scale, values, spanning, W, E, m, n_span, out,
                       part_lo, part_hi, stream);
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
