// The sparse Gram matrix for Hopper (sm_90a), in f64 and f32:
//
//   S = X.T diag(d) X   (k x k),   S[i, c] = sum_r x_ri * d_r * x_rc
//
// from the two layouts a SparseMatrix keeps on the card, both with int32
// indices and int32 bounds:
//
//   CSC  csc_bounds (k + 1), csc_rows (E), csc_vals (E): column i is the
//        run csc_bounds[i] .. csc_bounds[i + 1], its rows in any order
//   CSR  csr_cols (E), csr_vals (E), its columns sorted within each row;
//        the row bounds are not read, the tables below stand for them
//
// d (n,) with the row mask already applied, and two tables built on the card
// at the layouts' first call (ops/sparse_gram_kernel.py, gram_tables):
//
//   tab   (n, tab_stride) int32, tab_stride >= n_chunks + 1: tab[r, j] is
//         the first CSR entry of row r whose column is >= j * chunk, j = 0 ..
//         n_chunks; tab[r, n_chunks] is the row's end.  (The stride is a
//         parameter: read from the grid it cost 10% at sparse_wide.)
//   first (E,) int32, one per CSC entry (r, i): the first CSR entry of row r
//         whose column is >= i
//
// It takes over the sandwich of a SparseMatrix past the pair plan's and the
// densified matrix's budgets (tabmat's sparse_wide, 40,000 x 10,000 at 1%):
// the route of kernel-table row 8, where row panels of the CSR layout were
// densified and summed through the FP64 tensor cores (sandwich_mma<double>
// on panels that are 99% zeros; the JAX package's _sliced_pairs_kernel,
// tabmat_tpu/ops/pallas_pairs.py:103, and its int8 planes).  Here the work
// is the within-row pairs alone, sum_r nnz_r^2, about 10^4 times fewer
// multiply-adds than the panels' n k^2 at sparse_wide.
//
// Gustavson by output row, upper triangle, mirrored as it is written:
//
//   - A warp owns one unit: an output row i and a chunk of `chunk` columns
//     c0 .. c1 at or right of the chunk holding i.  Its accumulator is the
//     chunk's row S[i, c0:c1] in shared memory, zeroed first.  The wrapper
//     takes 1024 columns (8 KB in f64; six blocks of four warps an SM): at
//     sparse_wide 864, 1536 and 2048 took 1.94-2.12 ms against 1.85.
//   - For each entry (r, i) of CSC column i (a step), in the column's order,
//     the row r's entries in the chunk (from `first` in i's own chunk, so
//     that only columns c >= i are summed, else from `tab`, up to `tab`'s
//     next chunk edge) are gathered and S[i, c] += (x_ri d_r) x_rc.  A warp
//     takes 32 steps at a time: their runs, one after the other, are one
//     list; a lane finds the run of a list position by a binary search over
//     the runs' inclusive scan (warp shuffles), and each lane takes ITEMS
//     positions 32 apart, so that ITEMS gathers are in flight.
//   - Two lanes of one batch may name the same column (runs of two steps,
//     or a duplicate stored in a row).  Each lane writes its lane number
//     into a byte a column (`mark`, beside the accumulator) and reads it
//     back: where every lane reads its own, the columns are distinct and
//     the lanes add at once; else __match_any_sync groups the lanes of each
//     column and they add in turn, in list order.  So every entry sums its
//     terms in the list's order, with no atomics: a result repeats bit for
//     bit.  (Grouping every batch cost 0.9 of 2.6 ms at sparse_wide.)
//   - A block is ROWS warps on ROWS consecutive output rows and one chunk.
//     Each warp writes its row's entries c >= i; then the block writes the
//     mirror S[c, i0 .. i0 + ROWS) for c > i from the same accumulators,
//     ROWS values side by side (two 16-byte stores in f64, one in f32).
//     Every entry of S is written exactly once, and S is exactly symmetric.
//     The wrapper allocates S with torch.empty.
//   - The grid is (row groups, chunks): blocks run chunk after chunk, so the
//     rows' runs in one chunk (a tenth of the CSR at sparse_wide) stay in
//     L2.  A block whose rows lie right of its chunk exits at once: those
//     entries are the lower triangle, mirrored by another block.
//
// Stored duplicates add up: every pair of entries of a row is a term once.
//
// Bound.  Counting the inputs once and S once, the least time is S's 800 MB
// at sparse_wide (0.25 ms at 3.35 TB/s; the multiply-adds, n mu (mu + 1) =
// 4.04e8 at mu = 100 nonzeros a row, need 6 us).  The kernel gathers about
// sum_r nnz_r^2 / 2 CSR entries for the upper triangle, 12 bytes each (a
// column and a value): 2.4 GB at sparse_wide, mostly from L2, beside the
// 0.8 GB of S written.  On an H100 it takes 1.81-1.85 ms there, 7.2-7.3
// times the least time; without the gathers (a cut) it took 1.41 ms, so the
// set-up of each (step, chunk), the search and the shared columns cost more
// than the gathered bytes.
//
// The C functions launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 4;            // output rows a block, a warp each
constexpr int THREADS = 32 * ROWS;
constexpr int ITEMS = 3;           // list positions a lane takes per batch

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// S[c, i0 .. i0 + ROWS) = v[0 .. ROWS): 16-byte stores where aligned
__device__ __forceinline__ void store_side(double* p, const double* v) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
    __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]));
  } else {
#pragma unroll
    for (int q = 0; q < ROWS; ++q) __stcs(p + q, v[q]);
  }
}
__device__ __forceinline__ void store_side(float* p, const float* v) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int q = 0; q < ROWS; ++q) __stcs(p + q, v[q]);
  }
}
static_assert(ROWS == 4, "store_side writes four values");

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gram_rows(const int* __restrict__ csc_bounds, const int* __restrict__ csc_rows,
              const T* __restrict__ csc_vals, const int* __restrict__ first,
              const int* __restrict__ csr_cols, const T* __restrict__ csr_vals,
              const int* __restrict__ tab, int tab_stride, const T* __restrict__ d, int k,
              int chunk, T* __restrict__ S) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const accs = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.y;
  const int c0 = j * chunk;
  const int c1 = min(k, c0 + chunk);
  const int i0 = blockIdx.x * ROWS;
  if (i0 >= c1) return;  // right of the chunk: the mirror of another block's rows

  T* const acc = accs + warp * chunk;
  unsigned char* const mark =
      reinterpret_cast<unsigned char*>(accs + ROWS * chunk) + warp * chunk;
  for (int t = lane; t < chunk; t += 32) acc[t] = T(0);
  __syncwarp();
  const int i = i0 + warp;
  if (i < k) {
    const bool own = i >= c0;  // i's own chunk: runs start at column i
    const int s_end = csc_bounds[i + 1];
    for (int s0 = csc_bounds[i]; s0 < s_end; s0 += 32) {
      // a lane a step: its run of CSR entries and its factor x_ri d_r
      const int s = s0 + lane;
      int start = 0, len = 0;
      T w = T(0);
      if (s < s_end) {
        const int r = csc_rows[s];
        w = csc_vals[s] * d[r];
        const int* row_tab = tab + (size_t)r * tab_stride + j;
        start = own ? first[s] : row_tab[0];
        len = row_tab[1] - start;
      }
      int incl = len;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      const int total = __shfl_sync(FULL, incl, 31);
      const int shift = start - (incl - len);  // list position q of my run is entry shift + q
      for (int base = 0; base < total; base += 32 * ITEMS) {
        int col[ITEMS];
        T val[ITEMS], fac[ITEMS];
#pragma unroll
        for (int u = 0; u < ITEMS; ++u) {
          const int q = base + 32 * u + lane;
          int g = 0;  // the runs ending at or before q: q's run
#pragma unroll
          for (int step = 16; step > 0; step >>= 1)
            if (__shfl_sync(FULL, incl, g + step - 1) <= q) g += step;
          const int e = __shfl_sync(FULL, shift, g) + q;
          fac[u] = __shfl_sync(FULL, w, g);
          if (q < total) {
            col[u] = __ldg(csr_cols + e) - c0;
            val[u] = __ldg(csr_vals + e);
          } else {
            col[u] = -1 - lane;  // no lane shares it
            val[u] = T(0);
          }
        }
#pragma unroll
        for (int u = 0; u < ITEMS; ++u) {
          // each lane marks its column; a lane that reads back another's
          // mark shares it (about one batch in four at sparse_wide)
          const bool live = col[u] >= 0;
          if (live) mark[col[u]] = (unsigned char)lane;
          __syncwarp();
          if (!__any_sync(FULL, live && mark[col[u]] != lane)) {
            if (live) acc[col[u]] = fma_t(fac[u], val[u], acc[col[u]]);
          } else {
            const unsigned same = __match_any_sync(FULL, col[u]);
            const int turn = __popc(same & ((1u << lane) - 1u));
            const int turns = __reduce_max_sync(FULL, (unsigned)turn);
            for (int t = 0; t <= turns; ++t) {
              if (t == turn && live) acc[col[u]] = fma_t(fac[u], val[u], acc[col[u]]);
              __syncwarp();
            }
          }
          __syncwarp();
        }
      }
    }
    // the row: S[i, c] for c >= i in the chunk
    T* const row = S + (size_t)i * k;
    for (int c = max(i, c0) + lane; c < c1; c += 32) __stcs(row + c, acc[c - c0]);
  }
  __syncthreads();
  // the mirror: S[c, i0 + q] = S[i0 + q, c] for c > i0 + q in the chunk
  const int rows_here = min(ROWS, k - i0);
  for (int c = max(c0, i0 + 1) + (int)threadIdx.x; c < c1; c += THREADS) {
    T* const side = S + (size_t)c * k + i0;
    const int cl = c - c0;
    const int nq = min(rows_here, c - i0);
    if (nq == ROWS) {
      T v[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS; ++q) v[q] = accs[q * chunk + cl];
      store_side(side, v);
    } else {
      for (int q = 0; q < nq; ++q) __stcs(side + q, accs[q * chunk + cl]);
    }
  }
}

template <typename T>
int launch(const int* csc_bounds, const int* csc_rows, const T* csc_vals, const int* first,
           const int* csr_cols, const T* csr_vals, const int* tab, int tab_stride, const T* d,
           int k, int chunk, T* S, void* stream) {
  if (k <= 0) return 0;
  if (chunk <= 0 || chunk % ROWS != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ROWS * chunk * (sizeof(T) + 1);
  cudaError_t err = cudaFuncSetAttribute(gram_rows<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned groups = (unsigned)((k + ROWS - 1) / ROWS);
  const unsigned chunks = (unsigned)((k + chunk - 1) / chunk);
  gram_rows<T><<<dim3(groups, chunks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      csc_bounds, csc_rows, csc_vals, first, csr_cols, csr_vals, tab, tab_stride, d, k, chunk, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S holds k * k values, every one written.  chunk is a multiple of 4; the
// shared memory a block takes is 4 * chunk values and 4 * chunk bytes.
int tabmat_sparse_gram_f64(const int* csc_bounds, const int* csc_rows, const double* csc_vals,
                           const int* first, const int* csr_cols, const double* csr_vals,
                           const int* tab, int tab_stride, const double* d, int k, int chunk,
                           double* S, void* stream) {
  return launch<double>(csc_bounds, csc_rows, csc_vals, first, csr_cols, csr_vals, tab,
                        tab_stride, d, k, chunk, S, stream);
}

int tabmat_sparse_gram_f32(const int* csc_bounds, const int* csc_rows, const float* csc_vals,
                           const int* first, const int* csr_cols, const float* csr_vals,
                           const int* tab, int tab_stride, const float* d, int k, int chunk,
                           float* S, void* stream) {
  return launch<float>(csc_bounds, csc_rows, csc_vals, first, csr_cols, csr_vals, tab,
                       tab_stride, d, k, chunk, S, stream);
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
