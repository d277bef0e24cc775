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
// mma.sync.m16n8k8, the one f64 shape at the full 67 TFLOP/s (m8n8k4 runs
// at half; wgmma has no f64 form).
//
// Bound: at 400,000 x 160 the upper triangle is 1.03e10 operations (0.154 ms
// at 67 TFLOP/s) against 512 MB of X (0.153 ms at 3.35 TB/s): balanced; at
// 400,000 x 200 0.241 ms of operations; at the reference's sparse_wide
// (40,000 x 10,000 densified) 4.0e12 operations: the tensor cores bound it.
// The FP64 FFMA pipe alone peaks near 34 TFLOP/s, so only the tensor cores
// fit under these bounds.  Square 64 x 64 output tiles pad k = 160 to 192
// a side (1.75x the useful MMAs) and stage every column of X once per tile
// pair it lies in.  So:
//
//   pass 1: one block for each split of each upper-triangular pair ti <= tj
//           of 128-column tiles (the last tile the remainder), from a
//           device table in launch order (sandwich_kernel.mma_blocks): the
//           host gives each pair as many splits as its work asks, so that
//           the splits fill one wave of resident blocks (one an SM) and end
//           together.  Split s of S takes the 32-row stages s, s + S, ...,
//           so that all blocks walk down X together and the pairs that
//           share a strip read it from L2 but the first; the pairs are in
//           row order within pairs of bands of 8 tiles, so that at
//           sparse_wide's 79 tiles the 132 blocks resident at once read
//           about 24 strips, not 133.  A pair's last split also writes
//           zeros into the scratch of the splits past its own.
//           Where the last tile is 32 columns or fewer (129 <= k <= 160,
//           257 <= k <= 288, ...), its pair with tile ti (ti < tj) holds
//           two busy warp tiles at most: the same block then also takes
//           the diagonal pair (ti, ti), whose six busy warp tiles read both
//           operands from the a-strip.  Its eight warps are then all busy,
//           and strip ti is staged once for both pairs (at k = 160 the
//           staged columns fall from 2.0x X to 1.2x X).
//           S's part of a pair is cut into m16n8k8 accumulator tiles of 16
//           rows (row block r, in tile ti) by 8 columns (column block c, in
//           tile tj); a block computes only those that start inside both
//           tiles and, on a diagonal pair, lie on or above its diagonal
//           (c >= 2r): 72 on a full diagonal pair, 128 off it; at k = 160
//           the three pairs hold 72, 32 and 6.  Eight warp tiles of 64 x 32
//           (q = 0..7 at rows 64 (q / 4) and columns 32 (q % 4)), 16
//           accumulator tiles each, 128 registers a thread; a warp tile
//           with no such accumulator tile is idle.  A busy warp computes
//           one of 18 fixed patterns of its 16 tiles, a template constant:
//           all 16, the 6 or 14 tiles on or above the diagonal where the
//           warp tile starts on it or 32 columns past it, or the U x V
//           corner that holds its tiles where the pair's edge cuts it.  So
//           no mma.sync sits behind a branch: a branch there made the
//           compiler resynchronise the warp before each MMA, and a
//           diagonal pair's stage took as long as a full pair's (PERF.md).
//           The warp tiles go to warps by their tiles, most first: the
//           first four in ascending order to warps 0-3, the rest to warps
//           4, 5, ..., so that a diagonal pair's two light warp tiles (6
//           tiles each) share a scheduler (warp w issues on scheduler
//           w % 4) with its lighter heavy ones (14): 20 tiles on the
//           busiest scheduler, against 32 off the diagonal.  A warp's
//           k-step reads up to 4 A and 4 B fragments for up to 16 MMAs.
//           (A column block counts as inside the tile where its first
//           column, below, is.)
//   fragments: an accumulator tile's 16 rows are a 16-row block of S, its
//           row g and g + 8 (in the MMA's own numbering) the block's rows 2g
//           and 2g + 1; its 8 columns are the even (or odd) columns of a
//           16-column group, the MMA's column n the group's 2n (or 2n + 1).
//           So lane (g = lane / 4, t = lane % 4) finds both its A values of
//           a staged row, and its B values of both column blocks of a
//           group, side by side: one 16-byte shared load each, 12 a k-step
//           for 16 MMAs.  d * x rounds in f64 before the product, as the
//           plain version rounds it, on the B side (8 DMUL a k-step): the
//           upper entry (i, j) sums x_i (d x_j), the very terms of the plain
//           version's (j, i), which the second pass mirrors from it.  A
//           diagonal pair stages one strip and reads both operands from it.
//   staging: the rows of both 128-column strips and their weights, 32 rows
//           a stage, by cp.async in three stages (two in flight while one
//           is multiplied), one barrier a stage; 16-byte copies where k is
//           even (every row then starts on 16 bytes), else 8; a thread's
//           copy slots are fixed at the start, so a copy costs no division.
//           Rows are staged at a pitch of 132 doubles (= 4 mod 16): each
//           half-warp's fragment reads fall on 16 distinct 8-byte bank
//           pairs.  Rows past the split's end are zero-filled by the copies
//           (a zero weight and zero x add nothing); the columns past a
//           narrow tile are zeroed once and never copied.  Three stages of
//           67,840 bytes: one block an SM.
//   pass 2: sandwich_reduce.cuh: the splits summed in a fixed order, the
//           upper triangle mirrored, added to out with accumulate (row
//           panels of one product sum in order in one k x k buffer).
//
// No atomics: the result is the same from run to run and exactly symmetric.
// No wgmma (no f64 form), TMA or warp specialisation.  The C functions
// launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "sandwich_reduce.cuh"

namespace {

constexpr int THREADS = 256;           // eight warps, one warp tile each
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;              // column tile: a block's pair is 128 x 128
constexpr int WARP_ROWS = 64;          // a warp tile: 4 x 4 accumulator tiles
constexpr int WARP_COLS = 32;
constexpr int FRAG_M = 16;             // an accumulator tile: 16 rows ...
constexpr int FRAG_N = 8;              // ... by 8 columns
constexpr int KSTEP = 8;               // rows of X a k-step: the MMA's k
constexpr int FM = WARP_ROWS / FRAG_M; // row blocks of a warp tile
constexpr int FN = WARP_COLS / FRAG_N; // column blocks of a warp tile
constexpr int ROWS = 32;               // rows of X a stage
constexpr int STAGES = 3;
constexpr int PAD = 4;                 // pitch = 4 (mod 16) doubles: conflict-free fragments
constexpr int LD = TILE + PAD;
constexpr int STRIP = ROWS * LD;       // doubles of one strip's stage
constexpr int STAGE = 2 * STRIP + ROWS;  // a-strip, b-strip, weights
constexpr int SMEM_BYTES = STAGES * STAGE * (int)sizeof(double);  // 203,520

static_assert((TILE / WARP_ROWS) * (TILE / WARP_COLS) == WARPS, "one warp tile a warp");
static_assert(FM * FN == 16, "a warp tile's mask has 16 bits");
static_assert(LD % 16 == 4, "fragment reads on distinct banks");
static_assert(SMEM_BYTES <= 232448, "the stages fit one block an SM");

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

__device__ __forceinline__ double2 load2(const double* p) {
  return *reinterpret_cast<const double2*>(p);
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

// A thread's part of copying a strip: column c of rows r_first,
// r_first + passes, ... (r_first >= ROWS: no part)
struct Slot {
  int c, r_first, passes;
};

__device__ __forceinline__ Slot slot_of(int width, int vec) {
  const int per_row = (width + vec - 1) / vec;
  const int passes = THREADS / per_row;
  const int r_first = (int)threadIdx.x / per_row;
  return {((int)threadIdx.x - r_first * per_row) * vec, r_first < passes ? r_first : ROWS,
          passes};
}

// rows [r0, r0 + ROWS) of X's columns [c0, c0 + width) into buf at the
// pitch LD, zeros past the first `rows`
template <int VEC>
__device__ __forceinline__ void stage_strip(double* buf, const double* __restrict__ X, long long r0,
                                            int rows, int k, int c0, Slot s) {
  const double* src = X + (r0 + s.r_first) * k + c0 + s.c;
  double* dst = buf + s.r_first * LD + s.c;
  for (int r = s.r_first; r < ROWS; r += s.passes) {
    const bool valid = r < rows;
    copy_async<VEC>(dst, valid ? src : X, valid);
    src += (long long)s.passes * k;
    dst += s.passes * LD;
  }
}

// The accumulator tiles of warp tile q of a pair with wa rows and wb columns
// (diag: a diagonal pair): bit FN u + v for tile (u, v) of the warp tile
// where it starts inside both tiles and, on a diagonal pair, its first
// column is at or past its first row (c >= 2r).
__device__ __forceinline__ unsigned live_tiles(int q, int wa, int wb, bool diag) {
  const int r0 = (q / 4) * WARP_ROWS, c0 = (q % 4) * WARP_COLS;
  unsigned live = 0;
#pragma unroll
  for (int u = 0; u < FM; ++u)
#pragma unroll
    for (int v = 0; v < FN; ++v) {
      const int r = r0 + u * FRAG_M, c = c0 + (v / 2) * 2 * FRAG_N;  // c + v % 2: its first
      if (r < wa && c + v % 2 < wb && (!diag || c >= r)) live |= 1u << (FN * u + v);
    }
  return live;
}

// The patterns of accumulator tiles a warp computes, bit FN u + v for tile
// (u, v) of its warp tile: all 16; those on or above a diagonal pair's
// diagonal where the warp tile starts on it (c0 = r0: 6 tiles) or 32
// columns past it (14 tiles); and the U x V tiles at the corner of a warp
// tile cut by the pair's edge.
constexpr unsigned FULL_TILES = 0xFFFFu;

__host__ __device__ constexpr unsigned diag_tiles(int offset) {
  unsigned m = 0;
  for (int u = 0; u < FM; ++u)
    for (int v = 0; v < FN; ++v)
      if (offset + v * FRAG_N >= u * FRAG_M) m |= 1u << (FN * u + v);
  return m;
}

__host__ __device__ constexpr unsigned rect_tiles(int rows, int cols) {
  unsigned m = 0;
  for (int u = 0; u < rows; ++u)
    for (int v = 0; v < cols; ++v) m |= 1u << (FN * u + v);
  return m;
}

constexpr unsigned DIAG0 = diag_tiles(0);
constexpr unsigned DIAG32 = diag_tiles(WARP_COLS);

// The pattern that a warp computes for its live tiles: the live tiles where
// they are one of the patterns above, else the smallest U x V corner that
// holds them (its extra tiles lie past the pair's edge or below its
// diagonal and are never written).
__device__ __forceinline__ unsigned pattern_of(unsigned live) {
  if (live == FULL_TILES || live == DIAG0 || live == DIAG32 || live == 0u) return live;
  int rows = 0, cols = 0;
#pragma unroll
  for (int u = 0; u < FM; ++u)
#pragma unroll
    for (int v = 0; v < FN; ++v)
      if ((live >> (FN * u + v)) & 1u) {
        rows = u + 1 > rows ? u + 1 : rows;
        cols = v + 1 > cols ? v + 1 : cols;
      }
  return rect_tiles(rows, cols);
}

// The k-steps of one stage for a warp that computes the tiles of PATTERN:
// xa and xb at the lane's first A and B element of row t, w at the weight
// of row t.  The pattern is a constant, so the warp reads only the
// fragments it needs and never branches around an mma.sync (a branch there
// makes the compiler resynchronise the warp before each one, which costs
// the MMAs their overlap).
template <unsigned PATTERN>
__device__ __forceinline__ void stage_products(double (&acc)[FM][FN][4], const double* xa,
                                               const double* xb, const double* w) {
#pragma unroll
  for (int ks = 0; ks < ROWS / KSTEP; ++ks) {
    const double* a = xa + ks * KSTEP * LD;
    const double* b = xb + ks * KSTEP * LD;
    const double w0 = w[ks * KSTEP];
    const double w1 = w[ks * KSTEP + 4];
    double fa[FM][4];
    double fb[FN][2];
#pragma unroll
    for (int u = 0; u < FM; ++u) {
      if ((PATTERN >> (FN * u)) & 0xFu) {
        const double2 lo = load2(a + u * FRAG_M), hi = load2(a + 4 * LD + u * FRAG_M);
        fa[u][0] = lo.x;
        fa[u][1] = lo.y;
        fa[u][2] = hi.x;
        fa[u][3] = hi.y;
      }
    }
#pragma unroll
    for (int m = 0; m < FN / 2; ++m) {
      if (PATTERN & (0x3333u << (2 * m))) {
        const double2 lo = load2(b + m * 2 * FRAG_N), hi = load2(b + 4 * LD + m * 2 * FRAG_N);
        fb[2 * m][0] = lo.x * w0;
        fb[2 * m + 1][0] = lo.y * w0;
        fb[2 * m][1] = hi.x * w1;
        fb[2 * m + 1][1] = hi.y * w1;
      }
    }
#pragma unroll
    for (int u = 0; u < FM; ++u)
#pragma unroll
      for (int v = 0; v < FN; ++v)
        if ((PATTERN >> (FN * u + v)) & 1u) mma(acc[u][v], fa[u], fb[v]);
  }
}

// stage_products for the warp's pattern (one of the 18 that pattern_of gives)
__device__ __forceinline__ void stage_products_for(unsigned pattern, double (&acc)[FM][FN][4],
                                                   const double* xa, const double* xb,
                                                   const double* w) {
#define TABMAT_PATTERN(P) \
  case P:                 \
    stage_products<P>(acc, xa, xb, w); \
    break;
#define TABMAT_RECT_ROW(U) \
  TABMAT_PATTERN(rect_tiles(U, 1)) \
  TABMAT_PATTERN(rect_tiles(U, 2)) \
  TABMAT_PATTERN(rect_tiles(U, 3))
  switch (pattern) {
    TABMAT_PATTERN(FULL_TILES)
    TABMAT_PATTERN(DIAG0)
    TABMAT_PATTERN(DIAG32)
    TABMAT_RECT_ROW(1)
    TABMAT_RECT_ROW(2)
    TABMAT_RECT_ROW(3)
    TABMAT_RECT_ROW(4)
    TABMAT_PATTERN(rect_tiles(1, 4))
    TABMAT_PATTERN(rect_tiles(2, 4))
    TABMAT_PATTERN(rect_tiles(3, 4))
    default:
      break;
  }
#undef TABMAT_RECT_ROW
#undef TABMAT_PATTERN
}

__global__ void __launch_bounds__(THREADS, 1)
mma_partial(const double* __restrict__ X, const double* __restrict__ d,
            double* __restrict__ partial, long long n, int k,
            const long long* __restrict__ blocks, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);

  // the block's tile pair and split: entry L of the host's table, L the
  // block's place in launch order; the launches past the table's end
  // (the grid is pairs x most splits) end here
  const long long L = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  if (L >= blocks[0]) return;
  const long long entry = blocks[1 + L];
  const int ti = (int)(entry >> 48), tj = (int)((entry >> 32) & 0x7FFF);
  const bool with_diag = (entry >> 47) & 1;  // the diagonal pair (ti, ti) too
  const int split = (int)((entry >> 16) & 0xFFFF), splits_of_pair = (int)(entry & 0xFFFF);
  const bool diag = ti == tj;
  const int ca = ti * TILE, cb = tj * TILE;
  const int wa = k - ca < TILE ? k - ca : TILE;  // valid columns of each tile
  const int wb = k - cb < TILE ? k - cb : TILE;

  // The warp tiles with live accumulator tiles, of the block's pair (j < 8)
  // and with_diag of the diagonal pair (ti, ti) (j >= 8), ranked by the
  // tiles of their pattern (most first, then by j): ranks 0..3 go to warps
  // 3..0 (or fewer), the rest to warps 4, 5, ... (sandwich_kernel.
  // mma_warp_tiles counts them the same way to balance the row splits)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned patterns[2 * WARPS];
  int active = 0;
#pragma unroll
  for (int j = 0; j < 2 * WARPS; ++j) {
    patterns[j] = j < WARPS   ? pattern_of(live_tiles(j, wa, wb, diag))
                  : with_diag ? pattern_of(live_tiles(j - WARPS, wa, wa, true))
                              : 0u;
    active += patterns[j] != 0u;
  }
  const int head = active < 4 ? active : 4;
  const int want = warp < head ? head - 1 - warp : warp < active ? warp : -1;
  unsigned pattern = 0;
  int mine = 0;
#pragma unroll
  for (int j = 0; j < 2 * WARPS; ++j) {
    int rank = 0;
#pragma unroll
    for (int j2 = 0; j2 < 2 * WARPS; ++j2) {
      const int c = __popc(patterns[j]), c2 = __popc(patterns[j2]);
      rank += patterns[j2] != 0u && (c2 > c || (c2 == c && j2 < j));
    }
    if (patterns[j] != 0u && rank == want) {
      pattern = patterns[j];
      mine = j;
    }
  }
  // the warp's pair: the block's, or the diagonal one, whose A and B both
  // come from the a-strip
  const bool on_diag_pair = mine >= WARPS;
  const int q = mine % WARPS;
  const bool my_diag = diag || on_diag_pair;
  const int my_cb = on_diag_pair ? ca : cb, my_wb = on_diag_pair ? wa : wb;
  const unsigned live = pattern == 0u ? 0u : live_tiles(q, wa, my_wb, my_diag);
  const int g = lane / 4, t = lane % 4;
  const int r0 = (q / 4) * WARP_ROWS;  // the warp tile, in its pair
  const int c0 = (q % 4) * WARP_COLS;

  // split s of a pair of S splits takes the stages s, s + S, s + 2S, ... of
  // ROWS rows: every block, whatever its pair's S, walks down X at the same
  // pace, so the pairs that share a strip read it at about the same time
  // and L2 serves all but the first
  const long long first_stage = split;
  const long long n_stages = (n + ROWS - 1) / ROWS;
  const int stages = first_stage < splits_of_pair && first_stage < n_stages
                         ? (int)((n_stages - first_stage + splits_of_pair - 1) / splits_of_pair)
                         : 0;
  auto row_of = [&](int st) { return (first_stage + (long long)st * splits_of_pair) * ROWS; };

  auto rows_of = [&](int st) {
    const long long left = n - row_of(st);
    return (int)(left < ROWS ? left : ROWS);
  };
  // the slots: a-strip, b-strip, weights.  A diagonal pair stages its one
  // strip in the b-slot and reads A from it too
  auto b_slot = [&](int st) { return smem + (st % STAGES) * STAGE + STRIP; };
  auto a_slot = [&](int st) { return diag ? b_slot(st) : smem + (st % STAGES) * STAGE; };
  auto w_slot = [&](int st) { return smem + (st % STAGES) * STAGE + 2 * STRIP; };
  const Slot slot_a = slot_of(wa, vec), slot_b = slot_of(wb, vec);
  auto issue = [&](int st) {
    const long long r0_rows = row_of(st);
    const int rows = rows_of(st);
    if (vec == 2) {
      if (!diag) stage_strip<2>(a_slot(st), X, r0_rows, rows, k, ca, slot_a);
      stage_strip<2>(b_slot(st), X, r0_rows, rows, k, cb, slot_b);
    } else {
      if (!diag) stage_strip<1>(a_slot(st), X, r0_rows, rows, k, ca, slot_a);
      stage_strip<1>(b_slot(st), X, r0_rows, rows, k, cb, slot_b);
    }
    if ((int)threadIdx.x < ROWS) {
      const bool valid = (int)threadIdx.x < rows;
      copy_async<1>(w_slot(st) + threadIdx.x, valid ? d + r0_rows + threadIdx.x : d, valid);
    }
  };

  // the columns past a narrow tile are never copied: zero them (and all
  // else) once, before any copy lands
  for (int e = threadIdx.x; e < STAGES * STAGE; e += THREADS) smem[e] = 0.0;
  __syncthreads();

  double acc[FM][FN][4];
#pragma unroll
  for (int u = 0; u < FM; ++u)
#pragma unroll
    for (int v = 0; v < FN; ++v)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][v][c] = 0.0;

  // stage st is copy group st; empty groups keep the count uniform
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < stages) issue(st);
    commit();
  }
  const int a_off = t * LD + r0 + 2 * g, b_off = t * LD + c0 + 2 * g;
  for (int st = 0; st < stages; ++st) {
    wait_copies<STAGES - 2>();  // this thread's copies of stage st have landed
    // every thread's copies of stage st are visible, and every thread is
    // done with stage st - 1, whose buffer the next issue refills
    __syncthreads();
    stage_products_for(pattern, acc, a_slot(st) + a_off,
                       (on_diag_pair ? a_slot(st) : b_slot(st)) + b_off, w_slot(st) + t);
    // the refill after the products, so that they start on the stage first
    if (st + STAGES - 1 < stages) issue(st + STAGES - 1);
    commit();
  }
  wait_copies<0>();

  // the upper entries of the pair's live tiles into partial[split]; the
  // pair's last split also writes zeros into the splits past its own
  if (live == 0u) return;
  const int last = split == splits_of_pair - 1 ? (int)gridDim.y - 1 : split;
  for (int s = split; s <= last; ++s) {
    double* out = partial + (long long)s * k * k;
#pragma unroll
    for (int u = 0; u < FM; ++u) {
#pragma unroll
      for (int v = 0; v < FN; ++v) {
        if (!((live >> (FN * u + v)) & 1u)) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = r0 + u * FRAG_M + 2 * g + c / 2;
          const int j = c0 + (v / 2) * 2 * FRAG_N + 2 * (2 * t + c % 2) + v % 2;
          if (i < wa && j < my_wb && (!my_diag || i <= j)) {
            out[(long long)(ca + i) * k + my_cb + j] = s == split ? acc[u][v][c] : 0.0;
          }
        }
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

// partial holds splits * k * k doubles (the upper entries written, zeros
// in a pair's splits past its own); out holds k * k (added to when
// accumulate is not 0).  blocks (on the device, sandwich_kernel.mma_blocks)
// holds the count of blocks, then one entry a block in launch order: its
// tile pair (ti << 48 | tj << 32, and 1 << 47 where the block also takes
// the diagonal pair (ti, ti)), its split s << 16 and its pair's splits S,
// 1 <= S <= splits; split s takes the 32-row stages s, s + S, ...  The grid
// is pairs x splits, at least the count.  Any k >= 1.
int tabmat_sandwich_mma_f64(const double* X, const double* d, double* out, double* partial,
                            long long n, int k, int splits, const long long* blocks,
                            int accumulate, void* stream) {
  const int err_attr = allow_shared_memory();
  if (err_attr != 0) return err_attr;
  const uintptr_t base = reinterpret_cast<uintptr_t>(X);
  const int vec = (k % 2 == 0 && base % 16 == 0) ? 2 : 1;
  const int nt = (k + TILE - 1) / TILE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {(void*)&X, (void*)&d, (void*)&partial, (void*)&n, (void*)&k,
                  (void*)&blocks, (void*)&vec};
  cudaError_t err = cudaLaunchKernel((const void*)mma_partial, dim3(nt * (nt + 1) / 2, splits),
                                     dim3(THREADS), args, SMEM_BYTES, s);
  if (err != cudaSuccess) return (int)err;
  return launch_sandwich_reduce<double>(partial, out, k, splits, accumulate, s);
}

// Blocks of the first pass that one SM holds at once, for the wrapper's
// choice of row splits (float64 only: is_f64 must be 1).
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
