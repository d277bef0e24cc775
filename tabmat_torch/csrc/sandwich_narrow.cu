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
// 352 MB of X and d, about 1 FLOP/byte, far under the ridge; at k = 32,
// 1.1 GFLOP against 264 MB a million rows is still under it.  So the kernel
// must read X once at the memory rate, with enough bytes in flight on every
// SM to cover the memory's latency:
//
//   - One block an SM (the grid is one wave of row splits, each a multiple
//     of 4 rows).  A split is cut into stages of at most STAGE_BYTES of X
//     and d: a stage's rows are rows * k contiguous elements of X and rows
//     contiguous weights, so thread 0 starts one 1-D TMA bulk copy of each
//     (cp.async.bulk on the stage's mbarrier).  Stage rows are a multiple of
//     4, so both ends of both copies are 16-byte aligned wherever X and d
//     are.  A stage that is not (an unaligned X or d, or the matrix's last
//     rows) is copied by the threads with cp.async instead, into the same
//     slots, and summed by the same code.  NS stages rotate, NS - 1 in
//     flight while one is summed: about 170 KB of X an SM.
//   - Sums without wasted products, one instantiation per shape of work.
//     At k <= ROW_K a thread takes whole rows and keeps all k(k+1)/2 upper
//     entries in registers (15 FFMAs a row at k = 5), one instantiation per
//     k.  Past ROW_K, in f64, the FP64 tensor cores: the upper triangle in
//     m16n8k8 tiles (2, 4 or 6, one instantiation per ceil(k / 8)), every
//     warp taking 8-row k-steps; FFMA micro-tiles there were bound by their
//     shared loads (9 for 16 FFMAs).  In f32, which has no exact tensor-core
//     product, one 4 x 4 micro-tile of the upper triangle a thread (3 to 8
//     a side), 16 warps a block, the row groups taking every groups-th row.
//     d * x rounds before the product, as in the plain version.
//   - One launch.  Each block sums its threads' entries in a fixed order,
//     writes them to partial[split] and, past the block's barrier, thread 0
//     takes a ticket: an acq_rel atomic add on a counter, which publishes
//     the block's partial to whoever takes a later ticket.  The block that
//     takes the last ticket sums the splits' partials in split order, writes
//     S and its mirror (adding to out with accumulate) and sets the counter
//     back to 0.  Where the splits' partials are too many for one block to
//     load in two rounds (on 132 splits k >= 16 in f64, k >= 22 in f32),
//     the last fold_blocks() blocks share the entries: each waits until the
//     counter reaches the splits (the blocks still without a ticket are
//     running, since every earlier one has left its SM), sums its share, and
//     takes a second ticket; the last of those sets the counter back to 0.
//     The tickets only decide which block sums
//     an entry, not the order, so S is the same bit for bit from launch to
//     launch and exactly symmetric; no atomic touches a sum.  The counter
//     must be 0 at each launch and never shared by two launches that can
//     overlap: the wrapper keeps one for each device and stream (launches on
//     one stream run one after another), and every launch leaves it at 0.
//
// The C functions launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int ROW_THREADS = 256;   // k <= ROW_K: at most 55 f64 sums a thread
constexpr int TILE_THREADS = 512;  // f32 past it: 16 warps of 4 x 4 micro-tiles
constexpr int MMA_THREADS = 256;   // f64 past it: 8 warps of m16n8k8 tiles
constexpr int MAX_K = 32;
constexpr int ROW_K = 10;            // k <= ROW_K: a thread sums whole rows
constexpr int MT = 4;                // f32 past ROW_K: a thread's 4 x 4 micro-tile
constexpr int SLACK = 8;             // elements a tile reads past a stage's last row
constexpr int NS = 8;                // stages of a block
constexpr int STAGE_BYTES = 24576;   // X and d of one stage, at most
constexpr int ROW_ALIGN = 4;         // stage rows and splits: 16-byte copy ends
constexpr int FOLD_PARTS = 16;       // the last block's parts of one entry's splits
constexpr int FOLD_BATCH = 32;       // and its loads in flight a thread
constexpr int FOLD_MAX_BLOCKS = 16;  // blocks that share the sum of the splits, at most

// rows a stage: the most whose X and d fit STAGE_BYTES, a multiple of
// ROW_ALIGN
__host__ __device__ constexpr int stage_rows(int k, int size) {
  return STAGE_BYTES / ((k + 1) * size) / ROW_ALIGN * ROW_ALIGN;
}

// elements of a stage's X slot (its run, SLACK elements that a tile reads
// past the last row's column k, 16-byte rounded) and of the stage
template <typename T>
__host__ __device__ constexpr int x_slot(int k) {
  constexpr int V = 16 / (int)sizeof(T);
  return (stage_rows(k, sizeof(T)) * k + SLACK + V - 1) / V * V;
}
template <typename T>
__host__ __device__ constexpr int stage_elems(int k) {
  return x_slot<T>(k) + stage_rows(k, sizeof(T));
}
template <typename T>
constexpr int smem_bytes(int k) {
  return NS * stage_elems<T>(k) * (int)sizeof(T);
}
template <typename T>
constexpr int max_smem_bytes() {
  int most = 0;
  for (int k = 1; k <= MAX_K; ++k) most = smem_bytes<T>(k) > most ? smem_bytes<T>(k) : most;
  return most;
}
static_assert(stage_rows(MAX_K, 8) >= ROW_ALIGN, "a stage holds rows at k = 32");
static_assert(stage_rows(1, 8) % 2 == 0 && stage_rows(1, 4) % 4 == 0, "16-byte weight runs");

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

// the packed index of upper entry (i, j), i <= j < k
__device__ __forceinline__ int packed(int i, int j, int k) { return i * k - i * (i - 1) / 2 + j - i; }

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(N));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A ticket: the counter's value before this add.  Release: the block's
// partials, written before the block's barrier, are seen by whoever takes a
// later ticket; acquire: the last block sees every earlier block's.
__device__ __forceinline__ unsigned take_ticket(unsigned* counter) {
  unsigned before;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
               : "=r"(before)
               : "l"(counter)
               : "memory");
  return before;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* counter) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
  return v;
}

// Blocks that sum the splits: enough that each loads at most two batches a
// thread, at most FOLD_MAX_BLOCKS, the splits and the entries.
__device__ __forceinline__ int fold_blocks(int E, int S, int threads) {
  const long long per_block = 2LL * threads * FOLD_BATCH;
  int folds = (int)(((long long)E * S + per_block - 1) / per_block);
  folds = folds > FOLD_MAX_BLOCKS ? FOLD_MAX_BLOCKS : folds;
  return folds > S ? S : folds > E ? E : folds;
}

// v[0] + ... + v[N - 1] as a balanced tree, the same order every time
template <typename T, int N>
__device__ __forceinline__ T tree_sum(const T (&v)[N]) {
  T w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = v[i];
#pragma unroll
  for (int width = 1; width < N; width *= 2)
#pragma unroll
    for (int i = 0; i + width < N; i += 2 * width) w[i] += w[i + width];
  return w[0];
}

// One thread's 1-D bulk copy (TMA) of bytes (a multiple of 16, both ends
// 16-byte aligned), completing on the mbarrier bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void arrive_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void unpack(double* x, const double2 q) {
  x[0] = q.x;
  x[1] = q.y;
}
__device__ __forceinline__ void unpack(float* x, const float4 q) {
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}

// x[0, K) of a row at a 16-byte-aligned stage's offset r * K: 16-byte loads
// where the row is whole 16-byte words, 8-byte ones where it is 8-byte words
template <typename T, int K>
__device__ __forceinline__ void load_row(const T* p, T (&x)[K]) {
  if constexpr (K * sizeof(T) % 16 == 0) {
    using V = typename std::conditional<sizeof(T) == 8, double2, float4>::type;
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int v = 0; v < K / PER; ++v) unpack(x + v * PER, reinterpret_cast<const V*>(p)[v]);
  } else if constexpr (sizeof(T) == 4 && K % 2 == 0) {
#pragma unroll
    for (int v = 0; v < K / 2; ++v) {
      const float2 q = reinterpret_cast<const float2*>(p)[v];
      x[2 * v] = q.x;
      x[2 * v + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int m = 0; m < K; ++m) x[m] = p[m];
  }
}

// k = K <= ROW_K: a thread sums whole rows into all K(K+1)/2 upper entries.
template <typename T, int K>
struct RowSums {
  static constexpr int THREADS = ROW_THREADS;
  static constexpr int E = K * (K + 1) / 2;
  T acc[E];

  __device__ __forceinline__ RowSums() {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = T(0);
  }

  __device__ __forceinline__ void sum(const T* xs, const T* ws, int rows, int) {
    for (int r = threadIdx.x; r < rows; r += THREADS) {
      T x[K];
      load_row<T, K>(xs + r * K, x);
      const T w = ws[r];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const T a = x[i] * w;
#pragma unroll
        for (int j = i; j < K; ++j) {
          const int e = i * K - i * (i - 1) / 2 + j - i;
          acc[e] = fma_t(a, x[j], acc[e]);
        }
      }
    }
  }

  // The block's sums of the E entries into part[0, E): thread t's values
  // summed over t = c, c + 16, ... for each c of 16, then over c, each as a
  // fixed tree.
  __device__ __forceinline__ void finish(T* red, T* part, int) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int e = 0; e < E; ++e) red[e * THREADS + tid] = acc[e];
    __syncthreads();
    T* lanes = red + E * THREADS;
#pragma unroll
    for (int t = 0; t < (E * 16 + THREADS - 1) / THREADS; ++t) {
      const int task = tid + t * THREADS;
      if (task < E * 16) {
        const T* v = red + (task >> 4) * THREADS + (task & 15);
        T w[THREADS / 16];
#pragma unroll
        for (int q = 0; q < THREADS / 16; ++q) w[q] = v[16 * q];
        lanes[task] = tree_sum<T, THREADS / 16>(w);
      }
    }
    __syncthreads();
    for (int e = tid; e < E; e += THREADS) {
      T w[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) w[c] = lanes[e * 16 + c];
      part[e] = tree_sum<T, 16>(w);
    }
  }
};

// f32, ROW_K < k <= 4 NT: the upper micro-tiles of an NT x NT grid, one a thread;
// the block's GROUPS row groups take every GROUPS-th row.  A micro-tile that
// passes column k reads the next row's values (or the slack) into entries
// that are never written.
template <typename T, int NT>
struct TileSums {
  static constexpr int THREADS = TILE_THREADS;
  static constexpr int TILES = NT * (NT + 1) / 2;
  static constexpr int GROUPS = THREADS / TILES;
  T acc[MT][MT];
  int g, p, ti, tj;

  __device__ __forceinline__ TileSums() {
    g = threadIdx.x / TILES;
    p = threadIdx.x - g * TILES;
    upper_pair(p, NT, ti, tj);
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int v = 0; v < MT; ++v) acc[u][v] = T(0);
  }

  __device__ __forceinline__ void sum(const T* xs, const T* ws, int rows, int k) {
    if (g >= GROUPS) return;
    for (int r = g; r < rows; r += GROUPS) {
      const T* xr = xs + r * k;
      const T w = ws[r];
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

  // The block's sums of its entries into part: the row groups' micro-tiles
  // added in group order.
  __device__ __forceinline__ void finish(T* red, T* part, int k) {
    if (g < GROUPS) {
#pragma unroll
      for (int u = 0; u < MT; ++u)
#pragma unroll
        for (int v = 0; v < MT; ++v) red[(g * TILES + p) * (MT * MT) + u * MT + v] = acc[u][v];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TILES * MT * MT; e += THREADS) {
      const int tp = e / (MT * MT);
      const int uv = e % (MT * MT);
      T s = T(0);
      for (int gg = 0; gg < GROUPS; ++gg) s += red[(gg * TILES + tp) * (MT * MT) + uv];
      int a, b;
      upper_pair(tp, NT, a, b);
      const int i = a * MT + uv / MT;
      const int j = b * MT + uv % MT;
      if (i <= j && j < k) part[packed(i, j, k)] = s;
    }
  }
};

// D += A B in one m16n8k8 FP64 tensor-core tile; lane (g, t) = (lane / 4,
// lane % 4) holds A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4];
// B[t][g], B[t + 4][g]; D[g][2t + {0, 1}], D[g + 8][2t + {0, 1}].
__device__ __forceinline__ void mma(double (&c)[4], double a0, double a1, double a2, double a3,
                                    double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// f64 past ROW_K: the upper triangle in m16n8k8 tiles of 16 rows of S (row
// block r) by 8 columns (column block c), NC = ceil(k / 8) column blocks,
// tile (r, c) kept where c >= 2r (2, 4 or 6 tiles).  Every warp keeps all
// of them and takes the 8-row k-steps w, w + WARPS, ... of a stage: B of
// column block c is {x[kk + t][8c + g], x[kk + t + 4][8c + g]}, A of row
// block r is B of blocks 2r and 2r + 1 times the weights d[kk + t],
// d[kk + t + 4] (d * x rounds as in the plain version).  A row past the
// stage's end reads as zero; a column past k reads the next row's values
// into entries that are never written.
template <int NC>
struct MmaSums {
  static constexpr int THREADS = MMA_THREADS;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int RB = (NC + 1) / 2;
  static constexpr int TILES = RB * NC - RB * (RB - 1);
  double acc[TILES][4];

  __device__ __forceinline__ MmaSums() {
#pragma unroll
    for (int p = 0; p < TILES; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0.0;
  }

  __device__ __forceinline__ void sum(const double* xs, const double* ws, int rows, int k) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    for (int kk = 8 * (threadIdx.x >> 5); kk < rows; kk += 8 * WARPS) {
      const bool in0 = kk + t < rows;
      const bool in1 = kk + t + 4 < rows;
      const double* x0 = xs + (kk + t) * k + g;
      const double* x1 = x0 + 4 * k;
      double b[NC][2];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        b[c][0] = in0 ? x0[8 * c] : 0.0;
        b[c][1] = in1 ? x1[8 * c] : 0.0;
      }
      const double w0 = in0 ? ws[kk + t] : 0.0;
      const double w1 = in1 ? ws[kk + t + 4] : 0.0;
      int p = 0;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const double a0 = b[2 * r][0] * w0;
        const double a2 = b[2 * r][1] * w1;
        const double a1 = 2 * r + 1 < NC ? b[2 * r + 1 < NC ? 2 * r + 1 : 0][0] * w0 : 0.0;
        const double a3 = 2 * r + 1 < NC ? b[2 * r + 1 < NC ? 2 * r + 1 : 0][1] * w1 : 0.0;
#pragma unroll
        for (int c = 2 * r; c < NC; ++c) mma(acc[p++], a0, a1, a2, a3, b[c][0], b[c][1]);
      }
    }
  }

  // The block's sums of its entries into part: the warps' tiles added in
  // warp order.
  __device__ __forceinline__ void finish(double* red, double* part, int k) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int p = 0; p < TILES; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) red[((tid >> 5) * TILES + p) * 128 + (tid & 31) * 4 + q] = acc[p][q];
    __syncthreads();
    for (int e = tid; e < TILES * 128; e += THREADS) {
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w * TILES * 128 + e];
      int p = e >> 7;
      int r = 0;
      while (p >= NC - 2 * r) {
        p -= NC - 2 * r;
        ++r;
      }
      const int c = 2 * r + p;
      const int lane = (e >> 2) & 31;
      const int q = e & 3;
      const int i = 16 * r + (lane >> 2) + (q >= 2 ? 8 : 0);
      const int j = 8 * c + 2 * (lane & 3) + (q & 1);
      if (i <= j && j < k) part[packed(i, j, k)] = s;
    }
  }
};

// One block: split blockIdx.x of the rows through the stages into its
// partial, then the last blocks' sum of the partials into out.
template <typename T, class Sums>
__device__ __forceinline__ void narrow_block(Sums& sums, const T* __restrict__ X,
                                             const T* __restrict__ d, T* __restrict__ out,
                                             T* __restrict__ partial, unsigned* __restrict__ ticket,
                                             long long n, int k, long long rows_per_split,
                                             int accumulate) {
  constexpr int THREADS = Sums::THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long s_bar[NS];
  __shared__ int s_ticket;
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int R = stage_rows(k, sizeof(T));
  const int xe = x_slot<T>(k);
  const int se = stage_elems<T>(k);
  const long long row0 = (long long)blockIdx.x * rows_per_split;
  const long long row1 = row0 + rows_per_split < n ? row0 + rows_per_split : n;
  const int stages = (int)((row1 - row0 + R - 1) / R);
  auto bar = [&](int s) { return (unsigned)__cvta_generic_to_shared(&s_bar[s]); };
  auto rows_of = [&](int st) {
    const long long left = row1 - row0 - (long long)st * R;
    return (int)(left < R ? left : R);
  };
  // a stage goes by bulk copies where both runs start and end on 16 bytes
  auto bulk = [&](int st) {
    const long long a = row0 + (long long)st * R;
    const int rows = rows_of(st);
    return ((reinterpret_cast<uintptr_t>(X + a * k) | reinterpret_cast<uintptr_t>(d + a) |
             (uintptr_t)(rows * k * (int)sizeof(T)) | (uintptr_t)(rows * (int)sizeof(T))) & 15) == 0;
  };
  // stage st's copies into its slots (st % NS), completing on its mbarrier
  auto issue = [&](int st) {
    const long long a = row0 + (long long)st * R;
    const int rows = rows_of(st);
    T* xs = smem + (st % NS) * se;
    T* ws = xs + xe;
    const bool by_bulk = bulk(st);
    if (!by_bulk) {
      for (int e = tid; e < rows * k; e += THREADS) cp_async<(int)sizeof(T)>(xs + e, X + a * k + e);
      for (int e = tid; e < rows; e += THREADS) cp_async<(int)sizeof(T)>(ws + e, d + a + e);
    }
    if (tid == 0) {
      // the slots' last readers are past the block's barrier; order their
      // reads before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const int xbytes = rows * k * (int)sizeof(T);
      const int wbytes = rows * (int)sizeof(T);
      arrive_expect(bar(st % NS), by_bulk ? xbytes + wbytes : 0);
      if (by_bulk) {
        bulk_copy(xs, X + a * k, xbytes, bar(st % NS));
        bulk_copy(ws, d + a, wbytes, bar(st % NS));
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar(s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int st = 0; st < NS - 1; ++st) {
    if (st < stages) issue(st);
    commit();
  }
  for (int st = 0; st < stages; ++st) {
    if (st + NS - 1 < stages) issue(st + NS - 1);
    commit();
    wait_copies<NS - 1>();
    if (!bulk(st)) __syncthreads();  // the threads' copies, seen by all
    mbar_wait(bar(st % NS), (unsigned)((st / NS) & 1));
    const T* xs = smem + (st % NS) * se;
    sums.sum(xs, xs + xe, rows_of(st), k);
    __syncthreads();
  }
  wait_copies<0>();

  // the block's entries, then a ticket; the last `folds` blocks to take one
  // sum the splits, each a share of the entries
  const int E = k * (k + 1) / 2;
  const int S = gridDim.x;
  const int folds = fold_blocks(E, S, THREADS);
  sums.finish(smem, partial + (long long)blockIdx.x * E, k);
  __syncthreads();
  if (tid == 0) s_ticket = (int)take_ticket(ticket);
  __syncthreads();
  const int share = s_ticket - (S - folds);
  if (share < 0) return;
  if (folds > 1) {  // the blocks that have not yet taken a ticket are running
    if (tid == 0)
      while ((int)load_acquire(ticket) < S) __nanosleep(32);
    __syncthreads();
  }
  // entry e's splits in up to FOLD_PARTS contiguous parts (as many as the
  // threads allow), each summed in split order, FOLD_BATCH loads in flight
  // at once, then the parts in order
  const int e0 = E * share / folds;
  const int En = E * (share + 1) / folds - e0;
  int parts = THREADS / En;
  parts = parts < 1 ? 1 : parts > FOLD_PARTS ? FOLD_PARTS : parts;
  for (int task = tid; task < En * parts; task += THREADS) {
    const int e = e0 + task % En;
    const int q = task / En;
    const int s1 = S * (q + 1) / parts;
    T s = T(0);
    for (int sp = S * q / parts; sp < s1; sp += FOLD_BATCH) {
      T v[FOLD_BATCH];
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u)
        v[u] = sp + u < s1 ? __ldcg(partial + (long long)(sp + u) * E + e) : T(0);
      s += tree_sum<T, FOLD_BATCH>(v);
    }
    smem[task] = s;
  }
  __syncthreads();
  for (int t = tid; t < En; t += THREADS) {
    T s = T(0);
    for (int q = 0; q < parts; ++q) s += smem[q * En + t];
    const int e = e0 + t;
    int i = 0;
    while (packed(i + 1, i + 1, k) <= e && i + 1 < k) ++i;
    const int j = i + e - packed(i, i, k);
    out[i * k + j] = accumulate ? out[i * k + j] + s : s;
    if (i != j) out[j * k + i] = accumulate ? out[j * k + i] + s : s;
  }
  // the counter back to 0 once every block has taken its ticket and every
  // folding block is past its wait: by the last block, or by the folding
  // block that takes the last of a second round of tickets
  if (tid == 0 && (folds == 1 || (int)take_ticket(ticket) == S + folds - 1)) *ticket = 0;
}

template <typename T, int K>
__global__ void __launch_bounds__(ROW_THREADS, 1)
narrow_rows(const T* __restrict__ X, const T* __restrict__ d, T* __restrict__ out,
            T* __restrict__ partial, unsigned* __restrict__ ticket, long long n, int k,
            long long rows_per_split, int accumulate) {
  RowSums<T, K> sums;
  narrow_block<T>(sums, X, d, out, partial, ticket, n, k, rows_per_split, accumulate);
}

template <typename T, int NT>
__global__ void __launch_bounds__(TILE_THREADS, 1)
narrow_tiles(const T* __restrict__ X, const T* __restrict__ d, T* __restrict__ out,
             T* __restrict__ partial, unsigned* __restrict__ ticket, long long n, int k,
             long long rows_per_split, int accumulate) {
  TileSums<T, NT> sums;
  narrow_block<T>(sums, X, d, out, partial, ticket, n, k, rows_per_split, accumulate);
}

template <int NC>
__global__ void __launch_bounds__(MMA_THREADS, 1)
narrow_mma(const double* __restrict__ X, const double* __restrict__ d, double* __restrict__ out,
           double* __restrict__ partial, unsigned* __restrict__ ticket, long long n, int k,
           long long rows_per_split, int accumulate) {
  MmaSums<NC> sums;
  narrow_block<double>(sums, X, d, out, partial, ticket, n, k, rows_per_split, accumulate);
}

template <typename T>
using Kernel = void (*)(const T*, const T*, T*, T*, unsigned*, long long, int, long long, int);

// the instantiation for width k and its threads: whole rows for k <= ROW_K;
// past it FP64 tensor-core tiles (f64) or FFMA micro-tiles (f32)
template <typename T>
Kernel<T> kernel_for(int k, int* threads) {
  static const Kernel<T> rows[ROW_K] = {
      narrow_rows<T, 1>, narrow_rows<T, 2>, narrow_rows<T, 3>, narrow_rows<T, 4>,
      narrow_rows<T, 5>, narrow_rows<T, 6>, narrow_rows<T, 7>, narrow_rows<T, 8>,
      narrow_rows<T, 9>, narrow_rows<T, 10>};
  static_assert(ROW_K > 8 && ROW_K <= 16 && ROW_K > 2 * MT && ROW_K <= 3 * MT,
                "past ROW_K: 2 to 4 column blocks of 8, 3 to 8 micro-tiles of 4");
  if (k <= ROW_K) {
    *threads = ROW_THREADS;
    return rows[k - 1];
  }
  if constexpr (std::is_same<T, double>::value) {
    static const Kernel<double> mmas[MAX_K / 8 - 1] = {narrow_mma<2>, narrow_mma<3>,
                                                       narrow_mma<4>};
    *threads = MMA_THREADS;
    return mmas[(k + 7) / 8 - 2];
  } else {
    static const Kernel<T> tiles[MAX_K / MT - 2] = {
        narrow_tiles<T, 3>, narrow_tiles<T, 4>, narrow_tiles<T, 5>,
        narrow_tiles<T, 6>, narrow_tiles<T, 7>, narrow_tiles<T, 8>};
    *threads = TILE_THREADS;
    return tiles[(k + MT - 1) / MT - 3];
  }
}

template <typename T>
int launch(const T* X, const T* d, T* out, T* partial, unsigned* ticket, long long n, int k,
           int splits, long long rows_per_split, int accumulate, void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  int threads = 0;
  const Kernel<T> kernel = kernel_for<T>(k, &threads);
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            smem_bytes<T>(k));
  if (err != 0) return err;
  kernel<<<splits, threads, smem_bytes<T>(k), static_cast<cudaStream_t>(stream)>>>(
      X, d, out, partial, ticket, n, k, rows_per_split, accumulate);
  return (int)cudaGetLastError();
}

// The fewest resident blocks an SM of any instantiation at its most shared
// memory.
template <typename T>
int blocks_per_sm(int* blocks) {
  int least = 1 << 30;
  for (int k = 1; k <= MAX_K; ++k) {
    int threads = 0;
    const Kernel<T> kernel = kernel_for<T>(k, &threads);
    int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        max_smem_bytes<T>());
    if (err != 0) return err;
    int count = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel, threads,
                                                             max_smem_bytes<T>());
    if (err != 0) return err;
    least = count < least ? count : least;
  }
  *blocks = least;
  return 0;
}

}  // namespace

extern "C" {

// partial holds splits * k(k+1)/2 elements; ticket is a counter that is 0
// and used by no launch that can overlap this one (the last block sets it
// back to 0); out holds k * k (added to when accumulate is not 0).
// 1 <= k <= 32; rows_per_split a multiple of 4 for bulk copies.
int tabmat_sandwich_narrow_f64(const double* X, const double* d, double* out, double* partial,
                               unsigned* ticket, long long n, int k, int splits,
                               long long rows_per_split, int accumulate, void* stream) {
  return launch<double>(X, d, out, partial, ticket, n, k, splits, rows_per_split, accumulate,
                        stream);
}

int tabmat_sandwich_narrow_f32(const float* X, const float* d, float* out, float* partial,
                               unsigned* ticket, long long n, int k, int splits,
                               long long rows_per_split, int accumulate, void* stream) {
  return launch<float>(X, d, out, partial, ticket, n, k, splits, rows_per_split, accumulate,
                       stream);
}

// Blocks of the kernel that one SM holds at once, for the wrapper's choice
// of row splits.
int tabmat_sandwich_narrow_blocks_per_sm(int is_f64, int* blocks) {
  return is_f64 ? blocks_per_sm<double>(blocks) : blocks_per_sm<float>(blocks);
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
