// Sparse segment products for Hopper (sm_90a), in f64 and f32:
//
//   out[s, j] = sum_{bounds[s] <= t < bounds[s+1]} a[t] * scale[idx[t]] * values[idx[t], j]
//
// for a (E,) per element, idx (E,) int32 source rows sorted by segment,
// bounds (W + 1,) int32 or int64 with bounds[0] = 0 and bounds[W] = E, scale
// (n_src,) optional (null: 1), and values (n_src, m) row-major with m >= 1.
// Every sparse reduction of a SparseMatrix and of a DeviceDesign's sparse
// block is one call of it:
//
//   CSR X @ v        a = CSR data, idx = CSR columns, bounds = CSR indptr
//   CSC X.T @ r      a = CSC data, idx = CSC rows,    bounds = CSC indptr
//   (2-D V: the same with m columns)
//   column stds      a = CSC data^2, values = weights
//   X.T diag(w) B    CSC, scale = w, values = B (n, kd)
//   X.T diag(w) X    the pair plan: a = sorted pair products, idx = their rows
//   cat.T diag(w) X  the (code, column) plan: a = sorted data, idx = rows
//
// Replaces tabmat_tpu/ops/pallas_tmv_fused.py:_kernel (:179, called at
// :274), the one-pass CSR X.T v (windowed gather, exact two-product of
// hi/lo f32 planes, one-hot MXU reduction over the column codes), and at
// the sparse callers the gather and window-take kernels plus the one-hot
// segment sums (pallas_gather.py, pallas_window_take.py, pallas_segsum*.py,
// rows 9-14 of the port's kernel table) that the TPU chained with a cumsum
// over all nonzeros.  Hopper has f64 and gathers natively, and the CSR and
// CSC layouts are already sorted segment layouts, so the kernel sums each
// segment directly: no cumsum, so no error that grows with the prefix.
//
// Bound: the bytes.  a, idx and the bounds are read once, one gathered
// value row (and scale) per element, and W * m outputs written once: a CSR
// matvec of sparse_narrow (3M x 3, 90k nonzeros) moves 12 MB of bounds and
// 24 MB of output in f64 (11 us at 3.35 TB/s); a CSC tmv of the reference's
// 400k x 100 about 8 MB plus the gathered sectors (each 8-byte value costs
// a 32-byte sector unless neighbouring elements share it).
//
// The walk is a merge path (Merrill & Garland, SC'16), deterministic:
//
//   - The work list is the merge of the W segment ends with the E elements:
//     W + E items, item r + bounds[r + 1] being segment r's end.  A tile
//     is TILE consecutive items, a thread's share ITEMS of them, so an
//     empty segment costs one item and no thread walks a chain of bounds.
//   - Where each tile starts on the merge diagonal depends on the layout
//     alone: spmv_starts finds it once per plan, a warp per tile doing a
//     32-ary search (about log32 W dependent loads), and the wrapper keeps
//     the table on the plan.
//   - About one wave of persistent blocks takes the tiles in turn.  A block
//     copies a tile's slice of the bounds and its elements' products
//     a * scale * values into shared memory with coalesced loads (the value
//     rows are read-only gathers, all in flight at once); while it sums that
//     tile, the loads of its next tile's slice are already in flight.  Each
//     thread finds its own start in shared memory.
//   - A thread adds its elements and, at each segment end, writes the sum
//     to a shared output stage (0 for an empty segment); the block stores
//     the stage to out in one coalesced pass.  The products and the stage
//     share one buffer: a tile's elements and segment ends number TILE.
//   - A segment that spans threads is joined by a segmented scan of the
//     threads' open sums (warp shuffles, then the warps in order); one that
//     spans tiles by a second small launch, a warp per run of tiles that
//     adds the tiles' open sums in tile order.
//   No atomics and a fixed order: a result repeats bit for bit.  m = 1 takes
//   tiles of 128 threads x 7 items.  m > 1 takes groups of columns (grid y)
//   that fill one 32-byte sector of a value row, 4 in f64 and 8 in f32, in
//   tiles of 256 threads x 3 items, so that the staged products leave room
//   for enough blocks (shapes chosen on the card among 4-5 candidates each;
//   the odd item counts keep the threads' strided reads of the stage off
//   one bank).  This answers the three costs of the chunk walk it replaces
//   (segsum.cu's walk before it took row tiles): a thread's serial chain of
//   bound loads and zero stores over empty segments, the 16-element stride
//   between the lanes' loads, and a log2 W binary search in every thread.
//
// Element offsets.  The bounds are int32 (Off = int) up to 2^31 - 1
// elements and int64 (Off = long long) past it; the indices stay int32, as
// they index at most n_src rows.  Every element position (the tile's first
// element y0, the loads of a and idx) is 64-bit in both instantiations.  A
// tile stages its segment ends as int: the int32 layout as they are, the
// int64 layout relative to y0 and clamped to the tile (the segment still
// open at the tile's end may end 2^31 elements later), so its shared stage
// does not grow.  The int32 instantiation keeps the absolute ends, whose
// staging costs no subtract and clamp: those cost 4-6% on an H100 at the
// reference's sparse_narrow CSR matvec (3M segments, 90k elements: bound
// loads are the work; tools/time_spmv.py).
// Both sum in the same order, so they agree bit for bit on one layout.
//
// ptxas (-O3, sm_90a, CUDA 12.8, as tools/time_spmv.py prints it; the int
// and long long bounds' instantiations alike):
//   spmv_tiles<double, 1> 72 registers, 10,808 bytes shared
//   spmv_tiles<float, 1>  72 registers,  7,204 bytes shared
//   spmv_tiles<double, 4> 48 registers, 27,944 bytes shared
//   spmv_tiles<float, 8>  58 registers, 27,940 bytes shared
//   spmv_carries 32 registers and spmv_starts 22, no shared memory
//
// The C functions launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// Output columns per block for m > 1: one 32-byte sector of a value row,
// so that no two column groups gather the same sector.
constexpr int group_columns(int value_bytes) { return 32 / value_bytes; }

// Threads and merge items per thread for MC columns per block: a column
// group stages MC products per element, so it takes shorter tiles.
template <int MC>
struct Shape {
  static constexpr int THREADS = MC == 1 ? 128 : 256;
  static constexpr int ITEMS = MC == 1 ? 7 : 3;
};

template <int MC>
constexpr int tile_items() {
  return Shape<MC>::THREADS * Shape<MC>::ITEMS;
}
// every column group, f64 or f32, takes the same tile
static_assert(tile_items<group_columns(8)>() == tile_items<group_columns(4)>(), "");

// The merge coordinate of diagonal d: how many segment ends come before
// item d, i.e. the number of r < W with r + bounds[r + 1] < d.  The 32 lanes
// of a warp probe 32 points of the open interval at once.
template <typename Off>
__device__ __forceinline__ long long diagonal_rows(const Off* __restrict__ bounds, int W,
                                                   long long E, long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = d - E > 0 ? d - E : 0;  // every r < d - E ends before d
  long long hi = d < W ? d : W;          // no r >= d does
  while (lo < hi) {
    const long long r = lo + ((hi - lo) * lane) / 32;
    const bool before = r + (long long)__ldg(bounds + r + 1) < d;
    const int c = __popc(__ballot_sync(FULL, before));
    if (c == 0) break;  // r = lo does not end before d
    const long long last = __shfl_sync(FULL, r, c - 1);
    if (c < 32) hi = __shfl_sync(FULL, r, c);
    lo = last + 1;
  }
  return lo;
}

// starts[g] = diagonal_rows(g * TILE) for g = 0 .. tiles: where each tile's
// span of the merge begins.  It depends on the layout alone, so the wrapper
// builds it once per plan; one warp per entry.
template <int TILE, typename Off>
__global__ void __launch_bounds__(256)
spmv_starts(const Off* __restrict__ bounds, int W, long long E, int tiles,
            int* __restrict__ starts) {
  const int g = (int)(((long long)blockIdx.x * 256 + threadIdx.x) >> 5);
  if (g > tiles) return;
  const long long d = (long long)g * TILE < W + E ? (long long)g * TILE : W + E;
  const long long x = diagonal_rows(bounds, W, E, d);
  if ((threadIdx.x & 31) == 0) starts[g] = (int)x;
}

// Whether a layout's segment ends are staged relative to its tile's first
// element (int64 bounds) or as they are (int32).
template <typename Off>
constexpr bool RELATIVE_ENDS = sizeof(Off) > sizeof(int);

// Loads tile g's slice of the layout into registers: the ends of its
// segments (bounds[r + 1], E past the last segment; for int64 bounds
// relative to the tile's first element y0 and clamped to its nnz elements)
// and its elements' indices and data, strided by THREADS so that the loads
// coalesce.
template <typename T, int THREADS, int ITEMS, typename Off>
__device__ __forceinline__ void load_tile(const T* __restrict__ a, const int* __restrict__ idx,
                                          const Off* __restrict__ bounds, int W, long long E,
                                          long long g, int x0, int x1, int (&ee)[ITEMS + 1],
                                          int (&ii)[ITEMS], T (&ff)[ITEMS]) {
  constexpr int TILE = THREADS * ITEMS;
  const long long y0 = g * TILE - x0;
  const long long d1 = (g + 1) * TILE < W + E ? (g + 1) * TILE : W + E;
  const int rows = x1 - x0;
  const int nnz = (int)(d1 - g * TILE) - rows;
#pragma unroll
  for (int it = 0; it <= ITEMS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if constexpr (RELATIVE_ENDS<Off>) {
      const long long end =
          i <= rows && x0 + i < W ? (long long)__ldg(bounds + x0 + i + 1) - y0 : nnz;
      ee[it] = end < nnz ? (int)end : nnz;
    } else {
      ee[it] = i <= rows && x0 + i < W ? __ldg(bounds + x0 + i + 1) : (int)E;
    }
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int k = threadIdx.x + it * THREADS;
    ii[it] = k < nnz ? __ldg(idx + y0 + k) : 0;
    ff[it] = k < nnz ? __ldg(a + y0 + k) : T(0);
  }
}

// Each block takes tiles blockIdx.x, blockIdx.x + gridDim.x, ... (about one
// wave of blocks).  While it sums one tile, the loads of its next tile's
// slice are in flight, so a tile waits only on its gathers.
template <typename T, int MC, typename Off>
__global__ void __launch_bounds__(Shape<MC>::THREADS)
spmv_tiles(const T* __restrict__ a, const int* __restrict__ idx, const Off* __restrict__ bounds,
           const int* __restrict__ starts, const T* __restrict__ scale,
           const T* __restrict__ values, int W, long long E, int m, int tiles,
           T* __restrict__ out, T* __restrict__ carry_val) {
  constexpr int THREADS = Shape<MC>::THREADS;
  constexpr int ITEMS = Shape<MC>::ITEMS;
  constexpr int TILE = THREADS * ITEMS;
  constexpr int WARPS = THREADS / 32;
  __shared__ int s_ends[TILE + 1];  // bounds[r + 1] of the tile's segments (- y0, clamped)
  __shared__ T s_buf[MC * TILE];    // products [0, nnz), then segment sums
  __shared__ int s_wkey[WARPS];
  __shared__ T s_wval[WARPS][MC];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = blockIdx.y * MC;
  const int nj = m - j0 < MC ? m - j0 : MC;
  const int step = gridDim.x;

  int g = blockIdx.x;
  int cx0 = __ldg(starts + g);  // this tile's first segment and one past its last end
  int cx1 = __ldg(starts + g + 1);
  int ee[ITEMS + 1];
  int ii[ITEMS];
  T ff[ITEMS];
  load_tile<T, THREADS, ITEMS, Off>(a, idx, bounds, W, E, g, cx0, cx1, ee, ii, ff);
  int nx0 = 0;  // the same for tile g + step
  int nx1 = 0;
  if (g + step < tiles) {
    nx0 = __ldg(starts + g + step);
    nx1 = __ldg(starts + g + step + 1);
  }

  for (; g < tiles; g += step) {
    const long long d0 = (long long)g * TILE;
    const int items = (int)((d0 + TILE < W + E ? d0 + TILE : W + E) - d0);
    const long long x0 = cx0;
    // the staged ends less this are relative to the tile's first element
    const long long shift = RELATIVE_ENDS<Off> ? 0 : d0 - x0;
    const int rows = cx1 - cx0;  // segment ends in the tile
    const int nnz = items - rows;  // elements in the tile

    // stage the segment ends and the products; the gathers all in flight
#pragma unroll
    for (int it = 0; it <= ITEMS; ++it)
      if (tid + it * THREADS <= rows) s_ends[tid + it * THREADS] = ee[it];
    if (scale != nullptr) {
#pragma unroll
      for (int it = 0; it < ITEMS; ++it)
        if (tid + it * THREADS < nnz) ff[it] *= __ldg(scale + ii[it]);
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int k = tid + it * THREADS;
      if (k < nnz) {
        const T* row = values + (long long)ii[it] * m + j0;
#pragma unroll
        for (int j = 0; j < MC; ++j)
          if (j < nj) s_buf[j * TILE + k] = ff[it] * __ldg(row + j);
      }
    }
    __syncthreads();

    // the next tile's slice, and where the one after it starts
    if (g + step < tiles) {
      cx0 = nx0;
      cx1 = nx1;
      load_tile<T, THREADS, ITEMS, Off>(a, idx, bounds, W, E, g + step, cx0, cx1, ee, ii, ff);
      if (g + 2 * step < tiles) {
        nx0 = __ldg(starts + g + 2 * step);
        nx1 = __ldg(starts + g + 2 * step + 1);
      }
    }

    // this thread's start: the tile's segments r that end before item dt
    const int dt = tid * ITEMS < items ? tid * ITEMS : items;
    int lo = dt - nnz > 0 ? dt - nnz : 0;
    int hi = dt < rows ? dt : rows;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (mid + (long long)s_ends[mid] - shift < dt) lo = mid + 1; else hi = mid;
    }
    const int xs = lo;  // tile-relative segment
    int x = xs;
    int y = dt - xs;    // tile-relative element

    T acc[MC];
#pragma unroll
    for (int j = 0; j < MC; ++j) acc[j] = T(0);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      if (dt + it < items) {
        if (shift + y < s_ends[x]) {
#pragma unroll
          for (int j = 0; j < MC; ++j)
            if (j < nj) acc[j] += s_buf[j * TILE + y];
          ++y;
        } else {
#pragma unroll
          for (int j = 0; j < MC; ++j) {
            if (j < nj) s_buf[j * TILE + nnz + x] = acc[j];
            acc[j] = T(0);
          }
          ++x;
        }
      }
    }

    // segmented inclusive scan of the open sums, keyed by segment: in the
    // warp by shuffles, then across the warps in order
    const int key = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int k2 = __shfl_up_sync(FULL, key, off);
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        const T v2 = __shfl_up_sync(FULL, acc[j], off);
        if (lane >= off && k2 == key) acc[j] += v2;
      }
    }
    if (lane == 31) {
      s_wkey[warp] = key;
#pragma unroll
      for (int j = 0; j < MC; ++j) s_wval[warp][j] = acc[j];
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < WARPS; ++w) {
        if (s_wkey[w] == s_wkey[w - 1]) {
#pragma unroll
          for (int j = 0; j < MC; ++j) s_wval[w][j] += s_wval[w - 1][j];
        }
      }
    }
    __syncthreads();
    if (warp > 0 && s_wkey[warp - 1] == key) {
#pragma unroll
      for (int j = 0; j < MC; ++j) acc[j] += s_wval[warp - 1][j];
    }

    // the open sum before this thread belongs to its first segment (xs); if
    // the thread ends that segment, the sum joins it here
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      T before = __shfl_up_sync(FULL, acc[j], 1);
      if (lane == 0) before = warp > 0 ? s_wval[warp - 1][j] : T(0);
      if (x > xs && tid > 0 && j < nj) s_buf[j * TILE + nnz + xs] += before;
    }
    if (tid == THREADS - 1) {  // the open sum of segment starts[g + 1], for the carry pass
#pragma unroll
      for (int j = 0; j < MC; ++j)
        if (j < nj) carry_val[(long long)g * m + j0 + j] = acc[j];
    }
    __syncthreads();

    if (MC == 1) {
      for (int i = tid; i < rows; i += THREADS) out[x0 + i] = s_buf[nnz + i];
    } else {
      for (int e = tid; e < rows * nj; e += THREADS) {
        const int i = e / nj;
        const int j = e - i * nj;
        out[(x0 + i) * m + j0 + j] = s_buf[j * TILE + nnz + i];
      }
    }
    __syncthreads();  // the next tile overwrites the stage
  }
}

// Adds the open sums of tiles g .. g1 - 1 to the segment r = starts[g + 1]
// they all end in, which ends in tile g1: one warp per run, lane-strided
// over the tiles in order, then a fixed shuffle tree.
template <typename T, int TILE, typename Off>
__global__ void __launch_bounds__(256)
spmv_carries(const Off* __restrict__ bounds, const int* __restrict__ starts, int W, int tiles,
             int m, const T* __restrict__ carry_val, T* __restrict__ out) {
  const int g = (int)(((long long)blockIdx.x * 256 + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= tiles) return;
  const int r = starts[g + 1];
  if (r >= W || (g > 0 && starts[g] == r)) return;  // none, or not the run's first
  const int g1 = (int)(((long long)r + (long long)bounds[r + 1]) / TILE);
  for (int j = 0; j < m; ++j) {
    T s = T(0);
    for (int b = g + lane; b < g1; b += 32) s += carry_val[(long long)b * m + j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) out[(long long)r * m + j] += s;
  }
}

template <int MC>
int tiles(int W, long long E) {
  return (int)(((long long)W + E + tile_items<MC>() - 1) / tile_items<MC>());
}

template <int MC, typename Off>
int make_starts(const Off* bounds, int W, long long E, int* starts, cudaStream_t st) {
  const int n = tiles<MC>(W, E);
  spmv_starts<tile_items<MC>(), Off><<<(unsigned)(((n + 1) * 32LL + 255) / 256), 256, 0, st>>>(
      bounds, W, E, n, starts);
  return (int)cudaGetLastError();
}

template <typename T, int MC, typename Off>
int launch_shape(const T* a, const int* idx, const Off* bounds, const int* starts,
                 const T* scale, const T* values, int W, long long E, int m, T* out,
                 T* carry_val, cudaStream_t st) {
  const int n = tiles<MC>(W, E);
  const int groups = (m + MC - 1) / MC;
  // one wave of resident blocks, each taking every step-th tile; the wave's
  // size is asked once per device (the query costs microseconds of host time)
  static int resident[64] = {};  // by device: SMs x resident blocks
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device >= 64) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && resident[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spmv_tiles<T, MC, Off>,
                                                          Shape<MC>::THREADS, 0);
    if (err == cudaSuccess) resident[device] = sms * per_sm;
  }
  if (err != cudaSuccess) return (int)err;
  const long long wave = (long long)resident[device] / groups;
  const int step = (int)(wave < 1 ? 1 : wave < n ? wave : n);
  spmv_tiles<T, MC, Off><<<dim3((unsigned)step, (unsigned)groups), Shape<MC>::THREADS, 0, st>>>(
      a, idx, bounds, starts, scale, values, W, E, m, n, out, carry_val);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 1) return (int)err;
  spmv_carries<T, tile_items<MC>(), Off><<<(unsigned)((n * 32LL + 255) / 256), 256, 0, st>>>(
      bounds, starts, W, n, m, carry_val, out);
  return (int)cudaGetLastError();
}

template <typename T, typename Off>
int launch(const T* a, const int* idx, const Off* bounds, const int* starts, const T* scale,
           const T* values, int W, long long E, int m, T* out, T* carry_val, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 1)
    return launch_shape<T, 1, Off>(a, idx, bounds, starts, scale, values, W, E, m, out,
                                   carry_val, st);
  return launch_shape<T, group_columns(sizeof(T)), Off>(a, idx, bounds, starts, scale, values,
                                                        W, E, m, out, carry_val, st);
}

template <typename Off>
int starts_for(const Off* bounds, int W, long long E, int m, int* starts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return m == 1 ? make_starts<1>(bounds, W, E, starts, st)
                : make_starts<group_columns(8)>(bounds, W, E, starts, st);
}

}  // namespace

extern "C" {

// The number of merge tiles of a call for m columns.
int tabmat_spmv_tiles(int W, long long E, int m) {
  return m == 1 ? tiles<1>(W, E) : tiles<group_columns(8)>(W, E);
}

// starts (tiles + 1 int32: segment indices, W < 2^31) for a layout and m,
// from int32 or int64 bounds: built once per plan.
int tabmat_spmv_starts(const int* bounds, int W, long long E, int m, int* starts,
                       void* stream) {
  return starts_for<int>(bounds, W, E, m, starts, stream);
}

int tabmat_spmv_starts_i64(const long long* bounds, int W, long long E, int m, int* starts,
                           void* stream) {
  return starts_for<long long>(bounds, W, E, m, starts, stream);
}

// out holds W * m values, carry_val tiles * m.  E >= 1: with no element
// every segment is empty, and the wrapper returns zeros without a launch.
// The _i64 functions take int64 bounds.
int tabmat_spmv_f64(const double* a, const int* idx, const int* bounds, const int* starts,
                    const double* scale, const double* values, int W, long long E, int m,
                    double* out, double* carry_val, void* stream) {
  return launch<double, int>(a, idx, bounds, starts, scale, values, W, E, m, out, carry_val,
                             stream);
}

int tabmat_spmv_f32(const float* a, const int* idx, const int* bounds, const int* starts,
                    const float* scale, const float* values, int W, long long E, int m,
                    float* out, float* carry_val, void* stream) {
  return launch<float, int>(a, idx, bounds, starts, scale, values, W, E, m, out, carry_val,
                            stream);
}

int tabmat_spmv_f64_i64(const double* a, const int* idx, const long long* bounds,
                        const int* starts, const double* scale, const double* values, int W,
                        long long E, int m, double* out, double* carry_val, void* stream) {
  return launch<double, long long>(a, idx, bounds, starts, scale, values, W, E, m, out,
                                   carry_val, stream);
}

int tabmat_spmv_f32_i64(const float* a, const int* idx, const long long* bounds,
                        const int* starts, const float* scale, const float* values, int W,
                        long long E, int m, float* out, float* carry_val, void* stream) {
  return launch<float, long long>(a, idx, bounds, starts, scale, values, W, E, m, out,
                                  carry_val, stream);
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
