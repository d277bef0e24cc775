// The standardized sandwich's expansion for Hopper (sm_90a), in f64 and f32,
// in place on the inner sandwich T (k x k, row-major):
//
//   R[i, j] = T[i, j] (m_i m_j) + a_i s_j + s_i a_j + (s_i s_j) sigma
//
// with a = m * t, t = mat.transpose_matvec(d) (k,), s the shift (k,), m the
// multiplier (k,; absent for a view that only centres: then a = t and T is
// added as it is) and sigma = sum d[rows], one value read from the device.
// The vectors are the ones a rows/cols restriction limits.
//
// It serves StandardizedMatrix.sandwich (models/standardized.py, _expand)
// for a CUDA tensor whose inner sandwich is not diagonal, on every inner
// format: there PyTorch's eager expansion made nine (k, k) passes (four
// outer products, M o T and four sums; 14.4 GB of traffic at k = 10,000 in
// f64), where this kernel reads and writes T once.  It replaces no kernel of
// the JAX package: StandardizedMatrix._sandwich_device there is jnp, which
// XLA fuses into one pass on the TPU.
//
// Rounding.  Each entry is rounded as the eager expansion rounds it, in its
// order, with no contraction into an FMA (__dmul_rn / __dadd_rn and the f32
// forms, which nvcc never fuses):
//
//   ((a_i s_j + s_i a_j) + (s_i s_j) sigma) + T (m_i m_j),   a_i = t_i m_i
//
// so the result is bit for bit PyTorch's (IEEE sums and products commute).
//
// Design.  T is one stream of 16-byte vectors (2 values in f64, 4 in f32;
// single values where T does not start 16-byte aligned), so every k takes
// full-width loads: a vector may run on into the next row.  A thread takes
// U vectors a grid stride apart, loads all U (streaming: T is read once and
// written once, evict first) before it stores any, and steps by U strides;
// each vector's (row, column) is carried along by that step's rows and
// columns, so the loop divides nothing.  a_i, s_i, m_i of the row and a_j,
// s_j, m_j of the column are read for each value from L1 and L2 (three
// k-vectors, 80 KB each at k = 10,000 in f64).  The grid is WAVES times the
// blocks resident on the card at once.  On an H100 (700 W) at k = 10,000
// in f64 it takes 0.568-0.572 ms (2.8 TB/s of T moved), where a
// column-tile design (a thread's columns' a_j, s_j, m_j in registers, runs
// of rows a block) took 0.574-0.598 and 0.92 at an odd k.  A pass over the
// upper triangle's tiles that writes each tile and its mirror moves 1.2 GB
// there (0.439 ms), but holds only where T is exactly symmetric, which this
// kernel cannot see.
//
// Bound.  T read once and written once, 2 k^2 values: 1.6 GB at k = 10,000
// in f64, 0.48 ms at 3.35 TB/s; 9 operations an entry, 9e8 there, 13 us at
// 67 TFLOP/s.
//
// The C functions launch on the given stream, do not synchronise and return
// cudaGetLastError().  m may be null.  T must not overlap t, s, m or sigma.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 4;      // vectors a thread loads before it stores
constexpr int WAVES = 4;  // blocks a launch: WAVES times those resident at once

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// V values of T as one streaming load or store: 16 bytes for V > 1
template <typename T, int V>
struct Pack {
  T v[V];
};
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  Pack<T, V> r;
  if constexpr (V == 1) {
    r.v[0] = __ldcs(p);
  } else if constexpr (sizeof(T) == 8) {
    const double2 x = __ldcs(reinterpret_cast<const double2*>(p));
    r.v[0] = x.x;
    r.v[1] = x.y;
  } else {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
    r.v[0] = x.x;
    r.v[1] = x.y;
    r.v[2] = x.z;
    r.v[3] = x.w;
  }
  return r;
}
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& r) {
  if constexpr (V == 1) {
    __stcs(p, r.v[0]);
  } else if constexpr (sizeof(T) == 8) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(r.v[0], r.v[1]));
  } else {
    __stcs(reinterpret_cast<float4*>(p), make_float4(r.v[0], r.v[1], r.v[2], r.v[3]));
  }
}

// a_r = t_r m_r, s_r and m_r of one row or column (m_r = 1 unscaled)
template <typename T, bool SCALED>
struct Side {
  T a, s, m;
  __device__ __forceinline__ Side(const T* t, const T* s_, const T* m_, int r)
      : a(__ldg(t + r)), s(__ldg(s_ + r)), m(T(1)) {
    if constexpr (SCALED) {
      m = __ldg(m_ + r);
      a = mul_rn(a, m);
    }
  }
};

// ((a_i s_j + s_i a_j) + (s_i s_j) sigma) + x (m_i m_j), as the eager
// expansion rounds it
template <typename T, bool SCALED>
__device__ __forceinline__ T entry(T x, const Side<T, SCALED>& row, const Side<T, SCALED>& col,
                                   T sigma) {
  T e = add_rn(mul_rn(row.a, col.s), mul_rn(row.s, col.a));
  e = add_rn(e, mul_rn(mul_rn(row.s, col.s), sigma));
  if constexpr (SCALED) x = mul_rn(x, mul_rn(row.m, col.m));
  return add_rn(e, x);
}

// S as n_vec vectors of V values (then the last k^2 - V n_vec values one
// by one): a thread takes U streams of vectors q, q + stride, ..., each
// stepping U * stride vectors, and walks each stream's (row, column) by
// that step's rows and columns, with no division in the loop.
template <typename T, int V, bool SCALED>
__global__ void __launch_bounds__(THREADS)
    std_expand(T* __restrict__ S, const T* __restrict__ t, const T* __restrict__ s,
               const T* __restrict__ m, const T* __restrict__ sigma_p, int k,
               long long n_vec, int di, int dj) {
  const T sigma = __ldg(sigma_p);
  const long long stride = (long long)gridDim.x * THREADS;
  // where each stream starts: a 32-bit division where k^2 fits in 32 bits
  const bool narrow = (unsigned long long)k * k <= 0xffffffffull;
  long long q[U];
  int i[U], j[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    q[u] = (long long)blockIdx.x * THREADS + threadIdx.x + u * stride;
    const long long e = q[u] * V;
    i[u] = narrow ? (int)((unsigned)e / (unsigned)k) : (int)(e / k);
    j[u] = (int)(e - (long long)i[u] * k);
  }
  while (q[0] < n_vec) {
    Pack<T, V> x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (q[u] < n_vec) x[u] = load<T, V>(S + q[u] * V);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (q[u] < n_vec) {
        int r = i[u], c = j[u];
        Side<T, SCALED> row(t, s, m, r);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (v > 0 && ++c == k) {  // the vector runs on into the next row
            c = 0;
            row = Side<T, SCALED>(t, s, m, ++r);
          }
          x[u].v[v] = entry(x[u].v[v], row, Side<T, SCALED>(t, s, m, c), sigma);
        }
        store<T, V>(S + q[u] * V, x[u]);
      }
      q[u] += U * stride;
      i[u] += di;
      j[u] += dj;
      if (j[u] >= k) {
        j[u] -= k;
        ++i[u];
      }
    }
  }
  const long long tail = (long long)k * k - n_vec * V;  // < V values
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const long long e = n_vec * V + threadIdx.x;
    const int r = (int)(e / k), c = (int)(e % k);
    S[e] = entry(S[e], Side<T, SCALED>(t, s, m, r), Side<T, SCALED>(t, s, m, c), sigma);
  }
}

template <typename T, int V, bool SCALED>
int launch_v(T* S, const T* t, const T* s, const T* m, const T* sigma, int k,
             cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, std_expand<T, V, SCALED>,
                                                        THREADS, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const long long n_vec = (long long)k * k / V;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1) * WAVES;
  const long long needed = (n_vec + THREADS * U - 1) / (THREADS * U);  // U vectors a thread
  if (blocks > needed) blocks = needed;
  if (blocks < 1) blocks = 1;
  // the values a stream steps an iteration, as rows and columns
  const long long step = blocks * THREADS * U * V;
  std_expand<T, V, SCALED><<<(unsigned)blocks, THREADS, 0, stream>>>(
      S, t, s, m, sigma, k, n_vec, (int)(step / k), (int)(step % k));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(T* S, const T* t, const T* s, const T* m, const T* sigma, int k, void* stream) {
  if (k < 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const bool packed = (reinterpret_cast<uintptr_t>(S) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m != nullptr) {
    return packed ? launch_v<T, V, true>(S, t, s, m, sigma, k, st)
                  : launch_v<T, 1, true>(S, t, s, m, sigma, k, st);
  }
  return packed ? launch_v<T, V, false>(S, t, s, m, sigma, k, st)
                : launch_v<T, 1, false>(S, t, s, m, sigma, k, st);
}

}  // namespace

extern "C" {

// S (k * k) is read and written in place; t, s, m (k each; m may be null)
// and sigma (one value) are read.
int tabmat_std_expand_f64(double* S, const double* t, const double* s, const double* m,
                          const double* sigma, int k, void* stream) {
  return launch<double>(S, t, s, m, sigma, k, stream);
}

int tabmat_std_expand_f32(float* S, const float* t, const float* s, const float* m,
                          const float* sigma, int k, void* stream) {
  return launch<float>(S, t, s, m, sigma, k, stream);
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
