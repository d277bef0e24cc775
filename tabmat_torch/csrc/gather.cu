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
// (16 MB at 1M rows, C = 2, f64); the table (6 to 100,000 entries on the
// categorical paths) is read once from device memory and then from L1 and
// L2.  Such a stream is held back by how many bytes are in flight, not by
// its instructions: at 3.35 TB/s and about a microsecond from load to use,
// each of the 132 SMs needs some 25 KB of loads outstanding.  So:
//
//   - a thread takes a run of V rows, the values of one 16-byte store (4
//     in f32, 2 in f64); a warp's runs lie side by side, so a warp takes a
//     tile of 32 V rows and each of its load and store instructions covers
//     consecutive addresses;
//   - it loads every plane's codes of its run, one load of V codes (16 or
//     8 bytes) that skips L1 (read once; L1 keeps the table), before any
//     table load;
//   - then it issues all C x V table loads of the run, independent of one
//     another, before it sums any of them, so one row does not wait on
//     another's trip to memory;
//   - it stores the run's V sums as one 16-byte store;
//   - the grid is one wave of resident blocks (SMs x blocks an SM, asked
//     once per device), each warp walking tiles with a stride of the wave
//     and loading the next tile's codes before this tile's table loads.
//
// What the timings chose (tools/time_gather.py, PERF.md): a run of 2 rows
// in f64 beats 4 and 8 (at 1M rows, C = 2, more warps a wave and the next
// tile's codes in flight), 4 rows in f32 matches 8 and 16; a copy of the
// table in each block's shared memory (1 to 4 blocks an SM) did not beat
// L1, and 128 or 512 threads a block did not beat 256.  Where the
// codes sit in L2 (a step's 1M-row gather) the time is about 3 us of
// launch, ramp and one round trip for the bytes; past L2 (16M rows) the
// kernel streams at about 0.8 of the memory's rate.
//
// Edges.  Plane c starts at codes + c * n: when n is odd or not a multiple
// of V, or codes is a view at an offset, a plane is not aligned to V codes,
// and each plane may be off by another amount.  A run's alignment in a
// plane is its plane's (a run starts at a multiple of V rows), so the test
// is warp-uniform: an unaligned plane is loaded with V scalar loads, still
// all before the table loads.  The last n % (32 V) rows go a
// row a thread to the grid's last threads.  out must be 16-byte aligned (the
// wrapper allocates it; the C functions refuse another).  No load reaches
// past the C * n codes.  Offsets are 64-bit.  C = 1 to 3, the timed shapes,
// are fixed at compile time; any other C is taken a plane at a time.
//
// Exactness.  Each row sums its terms in the order c = 0, 1, ..., starting
// from the c = 0 term (not from 0, which would turn a -0.0 into +0.0), and
// a code out of range is skipped by a select, never by a multiply by 0, so
// an inf or NaN in the table cannot leak through a sentinel.  The plain
// version sums the same values in the same order: the two agree bit for
// bit.  The C functions launch on the given stream, do not synchronise and
// return a CUDA error code (cudaGetLastError() after the launch).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;

// V codes (16 or 8 bytes), and one code, through the non-coherent path
// without allocating in L1.
__device__ __forceinline__ void load_codes(const int* p, int (&q)[4]) {
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3])
      : "l"(p));
}

__device__ __forceinline__ void load_codes(const int* p, int (&q)[2]) {
  asm("ld.global.nc.L1::no_allocate.v2.s32 {%0, %1}, [%2];" : "=r"(q[0]), "=r"(q[1]) : "l"(p));
}

__device__ __forceinline__ int load_code(const int* p) {
  int q;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(q) : "l"(p));
  return q;
}

// The codes of V consecutive rows of one plane: one load where the plane
// is aligned to it, else V scalar loads.
template <int V>
__device__ __forceinline__ void load_run(const int* p, int (&code)[V]) {
  if ((reinterpret_cast<uintptr_t>(p) & (4 * V - 1)) == 0) {
    load_codes(p, code);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) code[k] = load_code(p + k);
  }
}

// table[code], or exactly 0 for a code outside [0, len): a select.
template <typename T>
__device__ __forceinline__ T term(const T* __restrict__ table, unsigned len, int code) {
  return (unsigned)code < len ? __ldg(table + code) : T(0);
}

// Rows a thread's run: the values of one 16-byte store.
template <typename T>
constexpr int RUN = 16 / sizeof(T);

// The codes of planes [c0, c0 + K) of the run of rows [i0, i0 + V).
template <int V, int K>
__device__ __forceinline__ void load_planes(const int* __restrict__ codes, long long n, int c0,
                                            long long i0, int (&code)[K][V]) {
#pragma unroll
  for (int j = 0; j < K; ++j) load_run<V>(codes + (long long)(c0 + j) * n + i0, code[j]);
}

// Adds the terms of K planes' codes into acc, in plane order; FIRST: the
// first plane starts the sums.  Every table load before any sum.
template <typename T, int K, bool FIRST>
__device__ __forceinline__ void add_terms(const T* __restrict__ table, unsigned len,
                                          const int (&code)[K][RUN<T>], T (&acc)[RUN<T>]) {
  constexpr int V = RUN<T>;
  T val[K][V];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) val[j][v] = term(table, len, code[j][v]);
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = (FIRST && j == 0) ? val[j][v] : acc[v] + val[j][v];
}

// Plane c of the run at i0 into acc: its codes, then its terms; FIRST:
// the plane starts the sums.
template <typename T, bool FIRST>
__device__ __forceinline__ void add_plane(const T* __restrict__ table, unsigned len,
                                          const int* __restrict__ codes, long long n, int c,
                                          long long i0, T (&acc)[RUN<T>]) {
  int code[1][RUN<T>];
  load_run<RUN<T>>(codes + (long long)c * n + i0, code[0]);
  add_terms<T, 1, FIRST>(table, len, code, acc);
}

// The run's sums as one 16-byte store (p is 16-byte aligned).
__device__ __forceinline__ void store_run(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void store_run(double* p, const double (&a)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(a[0], a[1]);
}

// One row's sum, all its code loads before its table loads (CT = 0: any C,
// one plane at a time).
template <typename T, int CT>
__device__ __forceinline__ T row_sum(const T* __restrict__ table, unsigned len,
                                     const int* __restrict__ codes, long long n, int C,
                                     long long i) {
  if constexpr (CT > 0) {
    int code[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) code[c] = load_code(codes + (long long)c * n + i);
    T a = term(table, len, code[0]);
#pragma unroll
    for (int c = 1; c < CT; ++c) a += term(table, len, code[c]);
    return a;
  } else {
    T a = term(table, len, load_code(codes + i));
    for (int c = 1; c < C; ++c)
      a += term(table, len, load_code(codes + (long long)c * n + i));
    return a;
  }
}

// CT: the planes C where 1 to 3, fixed at compile time; 0: any other C, a
// plane at a time.  A warp takes tiles of 32 V rows, a grid-stride walk over
// them, the next tile's codes loaded before this one's terms (CT > 0); the
// last n % (32 V) rows go a row a thread to the grid's last threads (they
// have the fewest tiles).
template <typename T, int CT>
__global__ void __launch_bounds__(THREADS)
gather_runs(const T* __restrict__ table, int table_len, const int* __restrict__ codes,
            long long n, int C, T* __restrict__ out) {
  constexpr int V = RUN<T>, TILE = 32 * V;
  const unsigned len = (unsigned)table_len;
  const long long tiles = n / TILE;
  const long long thread = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long threads = (long long)gridDim.x * THREADS, stride = threads >> 5;
  const long long lane_row = (threadIdx.x & 31) * V;
  long long w = thread >> 5;
  int code[CT > 0 ? CT : 1][V];
  if constexpr (CT > 0)
    if (w < tiles) load_planes<V, CT>(codes, n, 0, w * TILE + lane_row, code);
  // the tail rows, from the grid's last thread down
  for (long long k = threads - 1 - thread; k < n - tiles * TILE; k += threads)
    out[tiles * TILE + k] = row_sum<T, CT>(table, len, codes, n, C, tiles * TILE + k);
  for (; w < tiles; w += stride) {
    const long long i0 = w * TILE + lane_row;
    T acc[V];
    if constexpr (CT > 0) {
      int ahead[CT][V];
      const bool more = w + stride < tiles;
      if (more) load_planes<V, CT>(codes, n, 0, i0 + stride * TILE, ahead);
      add_terms<T, CT, true>(table, len, code, acc);
      if (more) {
#pragma unroll
        for (int j = 0; j < CT; ++j)
#pragma unroll
          for (int v = 0; v < V; ++v) code[j][v] = ahead[j][v];
      }
    } else {
      add_plane<T, true>(table, len, codes, n, 0, i0, acc);
      for (int c = 1; c < C; ++c) add_plane<T, false>(table, len, codes, n, c, i0, acc);
    }
    store_run(out + i0, acc);
  }
}

// One wave of resident blocks, no more than the tiles need (a warp a tile;
// the tail rows need one block).  The wave's size is asked once per device
// (the queries cost microseconds of host time).
template <typename T, int CT>
int launch_planes(const T* table, int table_len, const int* codes, long long n, int C, T* out,
                  cudaStream_t st) {
  static int resident[MAX_DEVICES] = {};  // by device: SMs x resident blocks
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device >= MAX_DEVICES) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && resident[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_runs<T, CT>, THREADS,
                                                          0);
    if (err == cudaSuccess) resident[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  if (err != cudaSuccess) return (int)err;
  constexpr int WARPS = THREADS / 32;
  long long blocks = (n / (32 * RUN<T>) + WARPS - 1) / WARPS;
  blocks = blocks < 1 ? 1 : blocks < resident[device] ? blocks : resident[device];
  gather_runs<T, CT><<<(unsigned)blocks, THREADS, 0, st>>>(table, table_len, codes, n, C, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* table, int table_len, const int* codes, long long n, int C, T* out,
           void* stream) {
  if (n < 1 || C < 1 || table_len < 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_planes<T, 1>(table, table_len, codes, n, C, out, st);
    case 2: return launch_planes<T, 2>(table, table_len, codes, n, C, out, st);
    case 3: return launch_planes<T, 3>(table, table_len, codes, n, C, out, st);
    default: return launch_planes<T, 0>(table, table_len, codes, n, C, out, st);
  }
}

}  // namespace

extern "C" {

// codes holds C * n int32 values; out holds n and is 16-byte aligned.
// n >= 1, C >= 1.
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
