// Wide sandwich S = X^T diag(d) X in f64 on Hopper's FP64 tensor cores
// (sm_90a), for k > 128.
//
// Replaces tabmat_tpu/ops/pallas_pairs.py:_pairs_kernel and
// :_sliced_pairs_kernel, the slice-pair contractions whose f64-weighted
// combination (ozaki.py:_sandwich_cached_mixed_jit) is the exact A^T B with
// A = d * X and B = X, the TPU's default exact-f64 sandwich for
// 128 < k <= 160; and the v3 / v5 kernels beyond one 128-lane tile.  The
// TPU sliced f64 into bf16 integer planes for its matrix unit.  Hopper has
// FP64 tensor cores, so the product runs in f64 directly through
// mma.sync.m16n8k8 (wgmma has no f64 form).
//
// Bound: at 400,000 x 160 the upper triangle is 1.03e10 operations (0.154 ms
// at 67 TFLOP/s) against 512 MB of X (0.153 ms at 3.35 TB/s): balanced; at
// the reference's sparse_wide (40,000 x 10,000 densified) 4.0e12 operations:
// the tensor cores bound it.  The FP64 FFMA pipe alone peaks near 34 TFLOP/s,
// so the FFMA kernel (sandwich.cu) cannot reach either bound.  So:
//
//   pass 1: grid (upper-triangular 64 x 64 output tile pairs ti <= tj) x
//           (row splits).  A block of four warps copies ROWS rows of its two
//           column tiles and their weights into shared memory with cp.async,
//           two stages in flight, so the next rows arrive while the tensor
//           cores work on these (each staged row padded by PAD so that the
//           fragment reads hit distinct banks).  Each warp owns a 32 x 32
//           quarter of the tile as MMA accumulators and walks the staged rows
//           a k-step at a time, scaling its A fragments by d (the product
//           d * x rounds as in the plain version).  The block writes its tile
//           to partial[split].  The splits fill one wave of resident blocks;
//           once the tile pairs alone fill it there is one split, so the
//           scratch stays near k * k.
//   pass 2: sandwich_reduce.cuh: the splits summed in a fixed order, the
//           upper triangle mirrored, added to out with accumulate (row
//           panels of one product sum in order in one k x k buffer).
//
// No atomics: the result is the same from run to run and exactly symmetric.
// No wgmma, TMA or warp specialisation yet.  The C functions launch on the
// given stream, do not synchronise and return cudaGetLastError().

#include <cuda_runtime.h>

#include "sandwich_reduce.cuh"

namespace {

constexpr int TILE = 64;      // output tile edge (columns of X)
constexpr int THREADS = 128;  // four warps, each a 32 x 32 quarter of the tile
constexpr int ROWS = 32;      // rows of X staged per stage
constexpr int STAGES = 2;     // stages in flight
constexpr int PAD = 4;        // a staged row's padding: conflict-free fragment reads
constexpr int LD = TILE + PAD;
constexpr int WARP_TILE = 32;
constexpr int STAGE_DOUBLES = 2 * ROWS * LD + ROWS;  // the two column tiles and d
constexpr int SMEM_BYTES = STAGES * STAGE_DOUBLES * (int)sizeof(double);
constexpr int COPIES = ROWS * TILE / THREADS;  // 8-byte copies per thread per tile

// D (16 x 8) += A (16 x 8) * B (8 x 8), f64: Hopper's FP64 tensor-core
// shape.  The m8n8k4 shape runs at half its rate on the H100 (33 against
// 66 TFLOP/s, PERF.md).  Lane l (g = l / 4, t = l % 4) holds A[g][t],
// A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; B[t][g], B[t + 4][g];
// D[g][2t + {0, 1}], D[g + 8][2t + {0, 1}].
constexpr int KSTEP = 8;
constexpr int FRAG_M = 16;
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
constexpr int A_REGS = 4;  // A values per lane per fragment
constexpr int B_REGS = 2;  // B values per lane per fragment
constexpr int FM = WARP_TILE / FRAG_M;  // fragments along a warp tile's rows
constexpr int FN = WARP_TILE / 8;       // and columns

// 8 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void copy8(double* dst, const double* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + ROWS) of column tiles ci and cj, and their weights
__device__ __forceinline__ void stage_rows(double* buf, const double* __restrict__ X,
                                           const double* __restrict__ d, long long r0,
                                           long long row_end, int k, int ci, int cj) {
  double* As = buf;
  double* Bs = buf + ROWS * LD;
  double* Ds = buf + 2 * ROWS * LD;
#pragma unroll
  for (int s = 0; s < COPIES; ++s) {
    const int e = threadIdx.x + s * THREADS;
    const int r = e / TILE;
    const int c = e % TILE;
    const long long row = r0 + r;
    const bool live = row < row_end;
    const double* xr = X + (live ? row : 0) * k;
    const bool a_ok = live && ci + c < k;
    const bool b_ok = live && cj + c < k;
    copy8(As + r * LD + c, xr + (a_ok ? ci + c : 0), a_ok);
    copy8(Bs + r * LD + c, xr + (b_ok ? cj + c : 0), b_ok);
  }
  if (threadIdx.x < ROWS) {
    const long long row = r0 + threadIdx.x;
    copy8(Ds + threadIdx.x, d + (row < row_end ? row : 0), row < row_end);
  }
}

__global__ void __launch_bounds__(THREADS)
mma_partial(const double* __restrict__ X, const double* __restrict__ d,
            double* __restrict__ partial, long long n, int k, long long rows_per_split) {
  extern __shared__ double smem[];

  // blockIdx.x enumerates the tile pairs ti <= tj row by row
  const int nt = (k + TILE - 1) / TILE;
  int p = blockIdx.x;
  int ti = 0;
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int ci = ti * TILE;
  const int cj = tj * TILE;

  const long long row_begin = (long long)blockIdx.y * rows_per_split;
  const long long row_end =
      row_begin + rows_per_split < n ? row_begin + rows_per_split : n;
  const long long stages = (row_end - row_begin + ROWS - 1) / ROWS;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 2) * WARP_TILE;  // the warp's quarter: rows of S
  const int wn = (warp % 2) * WARP_TILE;  // and columns of S within the tile
  const int g = lane / 4;
  const int t = lane % 4;

  double acc[FM][FN][4];
#pragma unroll
  for (int u = 0; u < FM; ++u)
#pragma unroll
    for (int v = 0; v < FN; ++v)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][v][c] = 0.0;

  if (stages > 0) stage_rows(smem, X, d, row_begin, row_end, k, ci, cj);
  commit();
  for (long long st = 0; st < stages; ++st) {
    const double* buf = smem + (st % STAGES) * STAGE_DOUBLES;
    if (st + 1 < stages) {
      stage_rows(smem + ((st + 1) % STAGES) * STAGE_DOUBLES, X, d, row_begin + (st + 1) * ROWS,
                 row_end, k, ci, cj);
      commit();
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const double* As = buf;
    const double* Bs = buf + ROWS * LD;
    const double* Ds = buf + 2 * ROWS * LD;
#pragma unroll
    for (int kk = 0; kk < ROWS; kk += KSTEP) {
      double fa[FM][A_REGS];
      double fb[FN][B_REGS];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows kk + t and kk + t + 4
        const int r = kk + t + 4 * h;
        const double w = Ds[r];
#pragma unroll
        for (int u = 0; u < FM; ++u) {
          fa[u][2 * h] = As[r * LD + wm + u * FRAG_M + g] * w;
          fa[u][2 * h + 1] = As[r * LD + wm + u * FRAG_M + g + 8] * w;
        }
#pragma unroll
        for (int v = 0; v < FN; ++v) fb[v][h] = Bs[r * LD + wn + v * 8 + g];
      }
#pragma unroll
      for (int u = 0; u < FM; ++u)
#pragma unroll
        for (int v = 0; v < FN; ++v) mma(acc[u][v], fa[u], fb[v]);
    }
    __syncthreads();
  }

  double* out = partial + (long long)blockIdx.y * k * k;
#pragma unroll
  for (int u = 0; u < FM; ++u) {
#pragma unroll
    for (int v = 0; v < FN; ++v) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ci + wm + u * FRAG_M + g + (c / 2) * 8;
        const int j = cj + wn + v * 8 + 2 * t + c % 2;
        if (i < k && j < k) out[(long long)i * k + j] = acc[u][v][c];
      }
    }
  }
}

int allow_shared_memory() {
  return (int)cudaFuncSetAttribute(mma_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_BYTES);
}

}  // namespace

extern "C" {

// partial holds splits * k * k doubles; out holds k * k (added to when
// accumulate is not 0).
int tabmat_sandwich_mma_f64(const double* X, const double* d, double* out, double* partial,
                            long long n, int k, int splits, long long rows_per_split,
                            int accumulate, void* stream) {
  int err = allow_shared_memory();
  if (err != 0) return err;
  const int nt = (k + TILE - 1) / TILE;
  const dim3 grid(nt * (nt + 1) / 2, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mma_partial<<<grid, THREADS, SMEM_BYTES, s>>>(X, d, partial, n, k, rows_per_split);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_sandwich_reduce<double>(partial, out, k, splits, accumulate, s);
}

// Blocks of the first pass that one SM holds at once, for the wrapper's
// choice of row splits.
int tabmat_sandwich_mma_blocks_per_sm(int is_f64, int* blocks) {
  if (!is_f64) return (int)cudaErrorInvalidValue;
  const int err = allow_shared_memory();
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mma_partial, THREADS,
                                                            SMEM_BYTES);
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
