// Triangle sandwich S = X^T diag(d) X for float64 X at 33 <= k <= 128 on
// Hopper's FP64 tensor cores (sm_90a).
//
// Replaces, at these widths, tabmat_tpu/ops/pallas_sandwich_v4.py:_v4_kernel
// (exact f64 through int8 anti-diagonal plane dots), the unpacked
// pallas_sandwich_v5.py:_v5_kernel and pallas_sandwich_v3.py:_v3_kernel.
// The TPU sliced f64 into integer planes for its matrix unit; Hopper
// multiplies f64 directly in mma.sync.aligned.m16n8k8.row.col.f64, the one
// f64 MMA shape that runs at the full 67 TFLOP/s (m8n8k4 runs at half;
// wgmma has no f64 form).  d * x is rounded in f64 before the product, as
// the plain version rounds it.
//
// Bound: at 1M x 50, 408 MB of X and d (0.122 ms at 3.35 TB/s) against the
// 16 m16n8k8 tiles of the upper triangle, 4.1 GFLOP padded (0.061 ms): bytes.
// At 1M x 128, 1.03 GB (0.308 ms) against 72 tiles, 18.4 GFLOP (0.275 ms):
// nearly level.  The FP64 FFMA pipe alone (34 TFLOP/s) needs 0.49 ms for the
// upper triangle at k = 128, so only the tensor cores fit under the bytes.
// sandwich.cu's 64 x 64 FFMA tiles compute the full square (3.2x the useful
// products at k = 50) from scalar, synchronous copies.  So:
//
//   pass 1: a 1-D grid of row splits that fills one wave of resident
//           blocks (two per SM).  S is cut into m16n8k8 accumulator tiles of
//           16 rows (row block r) by 8 columns (column block c); a block
//           keeps tile (r, c) where 8c + 7 >= 16r, i.e. c >= 2r: 9 tiles at
//           k = 33, 16 at k = 50, 20 at 64, 49 at 100, 72 at 128.  The warps
//           of a triangle group share these tiles: warp w owns row blocks w
//           and R - 1 - w (R = ceil(k / 16); the middle one alone where R is
//           odd), so its tiles are two bands that read the column blocks
//           2w .. 2R - 1, and the bands even out (k = 128: four warps of 18
//           tiles; k = 50: two of 8).  The rest
//           of the block's warps form further groups: three groups of two
//           warps for k <= 64 and two of three for k <= 88 (192 threads);
//           one group past that, of three warps for k <= 96 (96 threads)
//           and of four for k >= 97 (128 threads), where a warp's 14 to 18
//           tiles take 112 to 144 registers of accumulators.  Group q takes
//           the k-steps q, q + groups, ... of every stage, and at the end
//           the groups' sums are added in group order.  The kernel is built
//           once for each C = ceil(k / 8) from 5 to 16, so the pitch, the
//           tiles and the stage are constants.  ptxas: 114 to 218 registers
//           (130 at k = 50, 218 at k = 128), no spills; two blocks an SM at
//           every width.
//   fragments: lane (g, t) holds B of column block c as {X[kk+t][8c+g],
//           X[kk+t+4][8c+g]}, and A of row block r is B of column blocks 2r
//           and 2r + 1 times the weights d[kk+t], d[kk+t+4] (4 DMUL).  So X
//           is staged once, with no scaled copy, and each staged value is
//           read once per fragment.  Shared memory serves 128 bytes a clock
//           and the SM's tensor cores one m16n8k8 in 8 clocks; a B fragment
//           is 512 bytes (4 clocks).  A warp per k-step at k = 50 reads 8
//           (warp 0) or 5 (warp 1) fragments for 8 MMAs, 32 or 20 clocks of
//           shared memory against 64 of tensor core; at k = 128 16 to 10
//           fragments for 18 MMAs (64 to 40 against 144).
//   staging: rows and their weights are copied with cp.async, three stages
//           (two in flight while one is summed), one barrier a stage.  Copies
//           are 16 bytes where k is even (every row then starts on 16 bytes),
//           else 8; a thread copies one column slot of every passes-th row,
//           with no division.  Rows are staged at a pitch of 16R + 4 doubles
//           (= 4 mod 16): each half-warp's fragment reads then fall on 16
//           distinct 8-byte bank pairs.  The columns past k, up to 16R, are
//           zeroed once and never copied; rows past the split's end are
//           zero-filled by the copies.  A zero adds nothing.
//   what holds it back (PERF.md): at 1M x 50 the staging itself, about
//           2.7 TB/s with no MMA at all against 3.0 for a plain read of X; at
//           1M x 128 copies and MMAs each take about 0.35 ms alone and
//           overlap only in part, and together they reach the card's power
//           limit, which lowers the SM clock.
//   pass 2: a block of 32 x 16 threads takes 32 neighbouring partial entries;
//           row y of it sums the splits y, y + 16, ... in order, then the 16
//           rows are added in order.  An upper entry (i <= j < k) is written
//           to (i, j) and (j, i); with accumulate it is added to out.
//
// No atomics: the result is the same from run to run and exactly symmetric.
// The C functions launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MIN_K = 33;            // narrower widths go to sandwich_narrow.cu
constexpr int MAX_K = 128;           // wider ones to sandwich_mma.cu
constexpr int MIN_C = (MIN_K + 7) / 8;
constexpr int MAX_C = MAX_K / 8;
constexpr int KSTEP = 8;             // rows of X a k-step: the MMA's k
constexpr int PAD = 4;               // pitch = 4 (mod 16) doubles: conflict-free fragments
constexpr int STAGE_TARGET = 4608;   // doubles of X a stage, at most (36 KB)
constexpr int STAGES = 3;
constexpr int RED_COLS = 32;         // pass 2: entries a block
constexpr int RED_ROWS = 16;         // pass 2: split strides a block
constexpr int FRAG = 128;            // doubles of one tile: 32 lanes x 4

// The constants of the instantiation for C = ceil(k / 8) column blocks.
template <int C>
struct Shape {
  static constexpr int R = (C + 1) / 2;                // row blocks of 16
  static constexpr int P = 16 * R;                     // staged columns
  static constexpr int LD = P + PAD;                   // the pitch
  static constexpr int TILES = R * C - R * (R - 1);    // sum over r of C - 2r
  static constexpr int TW = (R + 1) / 2;               // warps of a triangle group
  static constexpr int MAXT = 2 * C - 2 * R + 2;       // warp 0's tiles, the most
  // row groups: three of two warps, two of three; one where a thread's
  // accumulators (8 registers a tile) would not leave room under the 168
  // registers of two 192-thread blocks an SM (k > 88)
  static constexpr int GROUPS = MAXT > 12 ? 1 : 5 - TW;
  static constexpr int THREADS = 32 * TW * GROUPS;
  static constexpr int KS_FIT = STAGE_TARGET / (KSTEP * LD) / GROUPS * GROUPS;
  static constexpr int KS = KS_FIT > GROUPS ? KS_FIT : GROUPS;  // k-steps a stage
  static constexpr int ROWS = KSTEP * KS;
  static constexpr int STAGE = ROWS * LD + ROWS;       // X rows, then their weights
  static constexpr int SMEM_BYTES = STAGES * STAGE * (int)sizeof(double);
  static_assert(THREADS <= 192, "two blocks an SM, up to 170 registers a thread");
  static_assert((GROUPS - 1) * TILES * FRAG <= STAGES * STAGE,
                "the groups' sums must fit the staging memory");
  static_assert(2 * SMEM_BYTES <= 227 * 1024, "two blocks an SM");
  static_assert(THREADS >= 8 * C, "one copy slot a thread per row");
};

// D (16 x 8) += A (16 x 8) * B (8 x 8), f64.  Lane l (g = l / 4, t = l % 4)
// holds A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; B[t][g],
// B[t + 4][g]; D[g][2t + {0, 1}], D[g + 8][2t + {0, 1}].
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// VEC doubles global -> shared, asynchronously; zero-filled when !valid
template <int VEC>
__device__ __forceinline__ void copy_async(double* dst, const double* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 2) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 8 : 0));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + ROWS) of X into buf at the pitch LD, in VEC-double copies
// (zeros past row_end): thread i copies column slot i % per_row of the rows
// i / per_row + m * passes
template <int VEC, int THREADS, int ROWS, int LD>
__device__ __forceinline__ void stage_x(double* buf, const double* __restrict__ X, long long r0,
                                        long long row_end, int k) {
  const int per_row = k / VEC;
  const int passes = THREADS / per_row;
  const int r_first = threadIdx.x / per_row;
  if (r_first >= passes) return;
  const int c = (threadIdx.x - r_first * per_row) * VEC;
  const double* src = X + (r0 + r_first) * k + c;
  double* dst = buf + r_first * LD + c;
  for (int r = r_first; r < ROWS; r += passes) {
    const bool valid = r0 + r < row_end;
    copy_async<VEC>(dst, valid ? src : X, valid);
    src += (long long)passes * k;
    dst += passes * LD;
  }
}

// The k-steps ks_begin, ks_begin + GROUPS, ... < ks_end of one stage for
// warp W of a triangle group: row blocks W and R - 1 - W, the first's tiles
// in acc[0, C - 2W), the second's after them.
template <int C, int W>
__device__ __forceinline__ void ksteps(double (&acc)[Shape<C>::MAXT][4], const double* buf,
                                       int ks_begin, int ks_end, int g, int t) {
  using S = Shape<C>;
  constexpr int R_LO = W;
  constexpr int R_HI = S::R - 1 - W;
  constexpr bool TWO = R_HI > R_LO;
  constexpr int N_LO = C - 2 * R_LO;
  const double* x0 = buf + t * S::LD + g;  // row kk + t, column 8c + g at 8c
  const double* x1 = x0 + 4 * S::LD;      // row kk + t + 4
  const double* w = buf + S::ROWS * S::LD + t;
  for (int ks = ks_begin; ks < ks_end; ks += S::GROUPS) {
    const int o = ks * KSTEP * S::LD;
    const double d0 = w[ks * KSTEP];
    const double d1 = w[ks * KSTEP + 4];
    double b[2 * S::R][2];
#pragma unroll
    for (int c = 2 * R_LO; c < 2 * S::R; ++c) {
      b[c][0] = x0[o + 8 * c];
      b[c][1] = x1[o + 8 * c];
    }
    const double a_lo[4] = {d0 * b[2 * R_LO][0], d0 * b[2 * R_LO + 1][0],
                            d1 * b[2 * R_LO][1], d1 * b[2 * R_LO + 1][1]};
#pragma unroll
    for (int c = 2 * R_LO; c < C; ++c) mma(acc[c - 2 * R_LO], a_lo, b[c]);
    if constexpr (TWO) {
      const double a_hi[4] = {d0 * b[2 * R_HI][0], d0 * b[2 * R_HI + 1][0],
                              d1 * b[2 * R_HI][1], d1 * b[2 * R_HI + 1][1]};
#pragma unroll
      for (int c = 2 * R_HI; c < C; ++c) mma(acc[N_LO + c - 2 * R_HI], a_hi, b[c]);
    }
  }
}

// ksteps<C, W> for the warp's place w in its triangle group
template <int C, int W = 0>
__device__ __forceinline__ void ksteps_for(int w, double (&acc)[Shape<C>::MAXT][4],
                                           const double* buf, int ks_begin, int ks_end, int g,
                                           int t) {
  if (w == W) {
    ksteps<C, W>(acc, buf, ks_begin, ks_end, g, t);
  } else if constexpr (W + 1 < Shape<C>::TW) {
    ksteps_for<C, W + 1>(w, acc, buf, ks_begin, ks_end, g, t);
  }
}

// the first tile of row block r: tiles are numbered row block by row block
__host__ __device__ __forceinline__ int row_offset(int r, int c_blocks) {
  return r * c_blocks - r * (r - 1);
}

template <int C>
__global__ void __launch_bounds__(Shape<C>::THREADS, 2)
mma_tri_partial(const double* __restrict__ X, const double* __restrict__ d,
                double* __restrict__ partial, long long n, int k, long long rows_per_split,
                int vec) {
  using S = Shape<C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = warp / S::TW;
  const int w = warp - grp * S::TW;
  const int g = lane / 4;
  const int t = lane % 4;

  const long long row_begin = (long long)blockIdx.x * rows_per_split;
  const long long row_end =
      row_begin + rows_per_split < n ? row_begin + rows_per_split : n;
  const long long span = row_end > row_begin ? row_end - row_begin : 0;
  const int stages = (int)((span + S::ROWS - 1) / S::ROWS);
  auto rows_of = [&](int st) {
    const long long left = span - (long long)st * S::ROWS;
    return (int)(left < S::ROWS ? left : S::ROWS);
  };
  auto issue = [&](int st) {
    double* buf = smem + (st % STAGES) * S::STAGE;
    const long long r0 = row_begin + (long long)st * S::ROWS;
    if (vec == 2) {
      stage_x<2, S::THREADS, S::ROWS, S::LD>(buf, X, r0, row_end, k);
    } else {
      stage_x<1, S::THREADS, S::ROWS, S::LD>(buf, X, r0, row_end, k);
    }
    for (int r = threadIdx.x; r < S::ROWS; r += S::THREADS) {
      const bool valid = r0 + r < row_end;
      copy_async<1>(buf + S::ROWS * S::LD + r, valid ? d + r0 + r : d, valid);
    }
  };

  // the columns past k are never copied: zero them (and all else) once,
  // before any copy lands
  for (int e = threadIdx.x; e < STAGES * S::STAGE; e += S::THREADS) smem[e] = 0.0;
  __syncthreads();

  double acc[S::MAXT][4];
#pragma unroll
  for (int s = 0; s < S::MAXT; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[s][c] = 0.0;

  // stage st is copy group st; empty groups keep the count uniform
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < stages) issue(st);
    commit();
  }
  for (int st = 0; st < stages; ++st) {
    wait_copies<STAGES - 2>();  // this thread's copies of stage st have landed
    // every thread's copies of stage st are visible, and every thread is
    // done with stage st - 1, whose buffer the next issue refills
    __syncthreads();
    if (st + STAGES - 1 < stages) issue(st + STAGES - 1);
    commit();
    const double* buf = smem + (st % STAGES) * S::STAGE;
    ksteps_for<C>(w, acc, buf, grp, (rows_of(st) + KSTEP - 1) / KSTEP, g, t);
  }
  wait_copies<0>();
  __syncthreads();

  // the warp's tiles: row block w's from row_offset(w), then row block
  // R - 1 - w's; groups 1.. leave their sums in shared memory (group q at
  // red[(q - 1) * TILES * FRAG + tile * FRAG + c * 32 + lane]) and group 0
  // adds them in group order and writes partial[split][tile][c][lane]
  const int r_hi = S::R - 1 - w;
  const int n_lo = C - 2 * w;
  const int count = n_lo + (r_hi > w ? C - 2 * r_hi : 0);
  const int lo_first = row_offset(w, C);
  const int hi_first = row_offset(r_hi, C) - n_lo;
  double* red = smem;
  if (grp > 0) {
#pragma unroll
    for (int s = 0; s < S::MAXT; ++s) {
      if (s < count) {
        const int tile = s < n_lo ? lo_first + s : hi_first + s;
        double* dst = red + ((grp - 1) * S::TILES + tile) * FRAG + lane;
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c * 32] = acc[s][c];
      }
    }
  }
  __syncthreads();
  if (grp == 0) {
    double* out = partial + (long long)blockIdx.x * S::TILES * FRAG;
#pragma unroll
    for (int s = 0; s < S::MAXT; ++s) {
      if (s < count) {
        const int tile = s < n_lo ? lo_first + s : hi_first + s;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          double v = acc[s][c];
          const double* src = red + tile * FRAG + c * 32 + lane;
#pragma unroll
          for (int q = 1; q < S::GROUPS; ++q) v += src[(q - 1) * S::TILES * FRAG];
          out[tile * FRAG + c * 32 + lane] = v;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(RED_COLS * RED_ROWS)
mma_tri_reduce(const double* __restrict__ partial, double* __restrict__ out, int k, int splits,
               int accumulate) {
  __shared__ double red[RED_ROWS][RED_COLS];
  const int c_blocks = (k + 7) / 8;
  const int r_blocks = (c_blocks + 1) / 2;
  const int size = row_offset(r_blocks, c_blocks) * FRAG;
  const int e = blockIdx.x * RED_COLS + threadIdx.x;
  double s = 0.0;
  if (e < size) {
#pragma unroll 4
    for (int sp = threadIdx.y; sp < splits; sp += RED_ROWS) s += partial[(long long)sp * size + e];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || e >= size) return;
  double v = red[0][threadIdx.x];
#pragma unroll
  for (int y = 1; y < RED_ROWS; ++y) v += red[y][threadIdx.x];
  int tile = e / FRAG;
  const int c = (e / 32) % 4;
  const int lane = e % 32;
  int r = 0;
  while (tile >= c_blocks - 2 * r) {
    tile -= c_blocks - 2 * r;
    ++r;
  }
  const int cb = 2 * r + tile;
  const int i = 16 * r + lane / 4 + 8 * (c / 2);
  const int j = 8 * cb + 2 * (lane % 4) + c % 2;
  if (i > j || j >= k) return;  // the lower half of a tile, or padding
  out[i * k + j] = accumulate ? out[i * k + j] + v : v;
  if (i != j) out[j * k + i] = accumulate ? out[j * k + i] + v : v;
}

// the first pass for C column blocks, with its block size and shared memory
struct Partial {
  void (*fn)(const double*, const double*, double*, long long, int, long long, int);
  int threads;
  int smem;
};

template <int C>
Partial partial_for(int c_blocks) {
  if constexpr (C > MAX_C) {
    return {nullptr, 0, 0};
  } else {
    if (c_blocks == C) return {mma_tri_partial<C>, Shape<C>::THREADS, Shape<C>::SMEM_BYTES};
    return partial_for<C + 1>(c_blocks);
  }
}

Partial partial_kernel(int k) { return partial_for<MIN_C>((k + 7) / 8); }

int allow_shared_memory(const Partial& p) {
  return (int)cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
}

}  // namespace

extern "C" {

// partial holds splits * 128 * tiles doubles (tiles = R C - R (R - 1), C =
// ceil(k / 8), R = ceil(C / 2)); out holds k * k (added to when accumulate
// is not 0).  33 <= k <= 128.
int tabmat_sandwich_mma_tri_f64(const double* X, const double* d, double* out, double* partial,
                                long long n, int k, int splits, long long rows_per_split,
                                int accumulate, void* stream) {
  if (k < MIN_K || k > MAX_K) return (int)cudaErrorInvalidValue;
  const Partial first = partial_kernel(k);
  const int err_attr = allow_shared_memory(first);
  if (err_attr != 0) return err_attr;
  const uintptr_t base = reinterpret_cast<uintptr_t>(X);
  const int vec = (k % 2 == 0 && base % 16 == 0) ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {(void*)&X, (void*)&d, (void*)&partial, (void*)&n, (void*)&k,
                  (void*)&rows_per_split, (void*)&vec};
  cudaError_t err = cudaLaunchKernel((const void*)first.fn, dim3(splits), dim3(first.threads),
                                     args, first.smem, s);
  if (err != cudaSuccess) return (int)err;
  const int c_blocks = (k + 7) / 8;
  const int size = row_offset((c_blocks + 1) / 2, c_blocks) * FRAG;
  mma_tri_reduce<<<(size + RED_COLS - 1) / RED_COLS, dim3(RED_COLS, RED_ROWS), 0, s>>>(
      partial, out, k, splits, accumulate);
  return (int)cudaGetLastError();
}

// Blocks of the first pass that one SM holds at once at every width, for
// the wrapper's choice of row splits (float64 only: is_f64 must be 1).
int tabmat_sandwich_mma_tri_blocks_per_sm(int is_f64, int* blocks) {
  if (!is_f64) return (int)cudaErrorInvalidValue;
  int least = 1 << 30;
  for (int k = MIN_K; k <= MAX_K; k += 8) {
    const Partial p = partial_kernel(k);
    int err = allow_shared_memory(p);
    int here = 0;
    if (err == 0) {
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&here, p.fn, p.threads, p.smem);
    }
    if (err != 0) return err;
    least = here < least ? here : least;
  }
  *blocks = least;
  return 0;
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
