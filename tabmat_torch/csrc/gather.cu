// Table gather with sentinels for Hopper (sm_90a), in f64 and f32:
//
//   out[i] = sum_{c < C} table[codes[c * n + i]]
//
// where a code outside [0, len(table)) contributes exactly 0: the negative
// drop_first and missing sentinels, and the pad code of a stack of
// categoricals.  C = 1 is the categorical matvec, C > 1 the matvec of C
// stacked categoricals in one launch, and a sorted code vector is the
// window take.
//
// Replaces tabmat_tpu/ops/pallas_gather.py:_gather_kernel_1plane and
// _gather_kernel_2plane (a select-accumulate over the table's 128-wide rows,
// f64 as two f32 planes) and tabmat_tpu/ops/pallas_window_take.py:
// _window_kernel_1plane and _window_kernel_2plane (the same over a window
// of rows, for sorted codes).  The TPU built a gather out of lane shuffles
// because its own gather is element-serial and it has no f64; Hopper
// gathers natively in either type.
//
// Bound: the bytes.  It reads C int32 codes and writes one value per row
// (16 MB at 1M rows, C = 2, f64); the table (at most a few hundred KB on the
// categorical path) stays in L2.  One thread per row, a grid-stride loop,
// the C terms summed in order c = 0, 1, ...: the plain version sums the same
// values in the same order, so the two agree exactly.  The C functions
// launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_sum(const T* __restrict__ table, int table_len, const int* __restrict__ codes,
           long long n, int C, T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    int code = __ldg(codes + i);
    T acc = (unsigned)code < (unsigned)table_len ? __ldg(table + code) : T(0);
    for (int c = 1; c < C; ++c) {
      code = __ldg(codes + (long long)c * n + i);
      acc += (unsigned)code < (unsigned)table_len ? __ldg(table + code) : T(0);
    }
    out[i] = acc;
  }
}

template <typename T>
int launch(const T* table, int table_len, const int* codes, long long n, int C, T* out,
           void* stream) {
  const long long want = (n + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 65535LL * 16 ? want : 65535LL * 16);
  gather_sum<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, table_len, codes, n, C, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// codes holds C * n int32 values; out holds n.  n >= 1.
int tabmat_gather_f64(const double* table, int table_len, const int* codes, long long n,
                      int C, double* out, void* stream) {
  return launch<double>(table, table_len, codes, n, C, out, stream);
}

int tabmat_gather_f32(const float* table, int table_len, const int* codes, long long n,
                      int C, float* out, void* stream) {
  return launch<float>(table, table_len, codes, n, C, out, stream);
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
