// Narrow sandwich S = X^T diag(d) X for k <= 32 on Hopper (sm_90a), in f64
// and f32.
//
// Replaces tabmat_tpu/ops/pallas_sandwich_v3.py:_v3p_kernel, which packs
// G = floor(100 / k) row groups into the TPU's 128 lanes when k is narrow,
// and the packed mode (G > 1) of pallas_sandwich_v4.py:_v4_kernel and
// pallas_sandwich_v5.py:_v5_kernel (G = floor(128 / k)), and, in f32,
// pallas_kernels.py:_sandwich_kernel at these widths.  Hopper has native
// FP64, so the product is computed in the input type: f64 FFMA, and f32
// FFMA (never TF32).
//
// Bound: bytes.  At 4M x 10 f64 the upper triangle is 0.44 GFLOP against
// 352 MB of X and d, about 1 FLOP/byte, far under the ridge, so the kernel
// must read X once at the memory rate.  The tiled kernel (sandwich.cu)
// spends a 64 x 64 tile on every k, so at k = 5 it does 160 times the
// useful work and takes as long as at k = 50.  Here instead:
//
//   pass 1: a 1-D grid of row splits that fills one wave of resident
//           blocks.  A block owns all k(k+1)/2 upper-triangle entries: the
//           k x k output is cut into 4 x 4 micro-tiles, each thread keeps
//           one upper micro-tile (ti <= tj) in registers, and the
//           THREADS / tiles row groups of a block take every
//           groups-th row.  The block copies a run of rows of X as it lies
//           in memory (rows * k contiguous elements, coalesced) and their
//           weights into shared memory with cp.async, two stages in flight,
//           so the next run arrives while this one is summed; a thread
//           scales its row slice by d as it reads it (d * x rounds as in the
//           plain version).  A micro-tile that passes column k reads the
//           next row's values into entries that are never written.  At the
//           end the row groups' sums are added in group order and the block
//           writes its entries to partial[split].
//   pass 2: one warp per upper-triangle entry sums the splits (lane l takes
//           the splits l, l + 32, ..., then a shuffle tree) and writes
//           (i, j) and (j, i); with accumulate it adds them to out.
//
// No atomics: the result is the same from run to run and exactly symmetric.
// The C functions launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MT = 4;            // micro-tile edge: a thread's 4 x 4 outputs
constexpr int MAX_K = 32;
constexpr int STAGE = 2048;      // elements of X per stage (rows * k <= STAGE)
constexpr int STAGES = 2;        // stages in flight
// a stage: the run of rows (with MT of slack for the last row's micro-tile
// reads past column k) and one weight per row
constexpr int STAGE_ELEMS = STAGE + MT + STAGE;
// the row groups' micro-tiles fit in the staging memory for the final sum
static_assert(THREADS * MT * MT <= STAGES * STAGE_ELEMS, "group sums must fit the staging memory");
static_assert(STAGE >= MAX_K, "a stage holds at least one row");

template <typename T>
constexpr int smem_bytes() {
  return STAGES * STAGE_ELEMS * (int)sizeof(T);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }

// the p-th upper-triangular pair (a, a + q) of an nt x nt grid, row by row
__device__ __forceinline__ void upper_pair(int p, int nt, int& a, int& b) {
  a = 0;
  while (p >= nt - a) {
    p -= nt - a;
    ++a;
  }
  b = a + p;
}

// one element global -> shared, asynchronously
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"((int)sizeof(T)));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + rows) of X (rows * k contiguous elements) and their weights
template <typename T>
__device__ __forceinline__ void stage_rows(T* buf, const T* __restrict__ X,
                                           const T* __restrict__ d, long long r0, int rows,
                                           int k) {
  const T* src = X + r0 * k;
  const int count = rows * k;
  for (int e = threadIdx.x; e < count; e += THREADS) copy_async(buf + e, src + e);
  for (int r = threadIdx.x; r < rows; r += THREADS) copy_async(buf + STAGE + MT + r, d + r0 + r);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
narrow_partial(const T* __restrict__ X, const T* __restrict__ d, T* __restrict__ partial,
               long long n, int k, long long rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nt = (k + MT - 1) / MT;
  const int tiles = nt * (nt + 1) / 2;
  const int groups = THREADS / tiles;
  const int stage_rows_n = STAGE / k;
  const int g = threadIdx.x / tiles;
  const int p = threadIdx.x - g * tiles;
  int ti, tj;
  upper_pair(p, nt, ti, tj);

  const long long row_begin = (long long)blockIdx.x * rows_per_split;
  const long long row_end =
      row_begin + rows_per_split < n ? row_begin + rows_per_split : n;
  const long long stages = (row_end - row_begin + stage_rows_n - 1) / stage_rows_n;

  T acc[MT][MT];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int v = 0; v < MT; ++v) acc[u][v] = T(0);

  auto rows_of = [&](long long st) {
    const long long left = row_end - row_begin - st * stage_rows_n;
    return (int)(left < stage_rows_n ? left : stage_rows_n);
  };
  if (stages > 0) stage_rows(smem, X, d, row_begin, rows_of(0), k);
  commit();
  for (long long st = 0; st < stages; ++st) {
    const T* buf = smem + (st % STAGES) * STAGE_ELEMS;
    if (st + 1 < stages) {
      stage_rows(smem + ((st + 1) % STAGES) * STAGE_ELEMS, X, d,
                 row_begin + (st + 1) * stage_rows_n, rows_of(st + 1), k);
      commit();
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const int rows = rows_of(st);
    if (g < groups) {
      for (int r = g; r < rows; r += groups) {
        const T* xr = buf + r * k;
        const T w = buf[STAGE + MT + r];
        T a[MT];
        T b[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          a[m] = xr[ti * MT + m] * w;
          b[m] = xr[tj * MT + m];
        }
#pragma unroll
        for (int u = 0; u < MT; ++u)
#pragma unroll
          for (int v = 0; v < MT; ++v) acc[u][v] = fma_t(a[u], b[v], acc[u][v]);
      }
    }
    __syncthreads();
  }

  // the row groups' sums, added in group order through shared memory
  T* red = smem;
  if (g < groups) {
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int v = 0; v < MT; ++v) red[(g * tiles + p) * (MT * MT) + u * MT + v] = acc[u][v];
  }
  __syncthreads();
  T* out = partial + (long long)blockIdx.x * k * k;
  for (int e = threadIdx.x; e < tiles * MT * MT; e += THREADS) {
    const int tp = e / (MT * MT);
    const int uv = e % (MT * MT);
    T s = T(0);
    for (int gg = 0; gg < groups; ++gg) s += red[(gg * tiles + tp) * (MT * MT) + uv];
    int a, b;
    upper_pair(tp, nt, a, b);
    const int i = a * MT + uv / MT;
    const int j = b * MT + uv % MT;
    if (i <= j && j < k) out[i * k + j] = s;
  }
}

template <typename T>
__global__ void narrow_reduce(const T* __restrict__ partial, T* __restrict__ out, int k,
                              int splits, int accumulate) {
  const int entry = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (entry >= k * (k + 1) / 2) return;  // whole warps leave together
  int i, j;
  upper_pair(entry, k, i, j);
  const long long kk = (long long)k * k;
  const T* src = partial + i * k + j;
  T s = T(0);
  for (int r = lane; r < splits; r += 32) s += src[r * kk];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) {
    out[i * k + j] = accumulate ? out[i * k + j] + s : s;
    if (i != j) out[j * k + i] = accumulate ? out[j * k + i] + s : s;
  }
}

template <typename T>
int allow_shared_memory() {
  return (int)cudaFuncSetAttribute(narrow_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes<T>());
}

template <typename T>
int launch(const T* X, const T* d, T* out, T* partial, long long n, int k, int splits,
           long long rows_per_split, int accumulate, void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const int err_attr = allow_shared_memory<T>();
  if (err_attr != 0) return err_attr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  narrow_partial<T><<<splits, THREADS, smem_bytes<T>(), s>>>(X, d, partial, n, k, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int blocks = (k * (k + 1) / 2 * 32 + threads - 1) / threads;
  narrow_reduce<T><<<blocks, threads, 0, s>>>(partial, out, k, splits, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// partial holds splits * k * k elements; out holds k * k (added to when
// accumulate is not 0).  1 <= k <= 32.
int tabmat_sandwich_narrow_f64(const double* X, const double* d, double* out, double* partial,
                               long long n, int k, int splits, long long rows_per_split,
                               int accumulate, void* stream) {
  return launch<double>(X, d, out, partial, n, k, splits, rows_per_split, accumulate, stream);
}

int tabmat_sandwich_narrow_f32(const float* X, const float* d, float* out, float* partial,
                               long long n, int k, int splits, long long rows_per_split,
                               int accumulate, void* stream) {
  return launch<float>(X, d, out, partial, n, k, splits, rows_per_split, accumulate, stream);
}

// Blocks of the first pass that one SM holds at once, for the wrapper's
// choice of row splits.
int tabmat_sandwich_narrow_blocks_per_sm(int is_f64, int* blocks) {
  const int err = is_f64 ? allow_shared_memory<double>() : allow_shared_memory<float>();
  if (err != 0) return err;
  return (int)(is_f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            blocks, narrow_partial<double>, THREADS, smem_bytes<double>())
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            blocks, narrow_partial<float>, THREADS, smem_bytes<float>()));
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
