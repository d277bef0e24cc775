// Deterministic segment sum over a plan, for Hopper (sm_90a), in f64 and f32:
//
//   out[s, j] = sum_{bounds[s] <= t < bounds[s+1]} values[perm[t], j]
//
// for values (n, m) row-major (m = 1 for a vector) and a SegmentPlan's
// perm (E,) rows sorted by segment and bounds (W + 1,).  Rows with a
// sentinel code (missing, drop_first) are not in perm, so they fall in no
// segment.
//
// Replaces tabmat_tpu/ops/pallas_segsum.py:_segsum_kernel (one-hot MXU
// contraction of exact bf16 slices, W <= 2^14) and
// tabmat_tpu/ops/pallas_segsum_bucketed.py:_segsum_bucketed_kernel (the
// same, factorised through the code's high and low bits, W <= 2^17).  Those
// kernels walk ROWS in order: a tile of rows and its codes against a one-hot
// of the codes, with per-tile partials summed afterwards.  The one-hot
// product is TPU machinery and is not carried; the row-tile order is what
// Hopper needs too: values are read once, coalesced, and the gather through
// perm becomes a read of shared memory.
//
// Bound: the bytes.  At 1M rows the stacked plan of two categoricals (W =
// 2000, E = 2M) moves values once (8 MB in f64 at m = 1) and its layout
// (4 bytes an element); the gather the sorted order would need costs a
// 32-byte sector per 8-byte value, which the row tiles avoid.
//
// The layout (built once per plan and R on the card, kept in plan.tables;
// ops/segsum_kernel.py): the plan's elements sorted stably by row tile
// perm // R, so inside a tile they stay in (segment, row) order.  Each tile's
// elements start at tile_off[g], padded to a multiple of ITEMS with
// elements that read the tile's zero row R and join its last run.  An
// element holds its local row (< R <= 16384) and its key:
//
//   tiles route (segsum<T>)       words[e] = local row << 16 | segment,
//                                 for W small enough that a dense (W, G)
//                                 accumulator fits in shared memory;
//   slots route (segsum_slots<T>) rows[e] (int16) and slots[e]: the slot of
//                                 the element's (tile, segment) run, slots
//                                 ordered by segment, then tile, so a
//                                 segment's slots lie together from
//                                 slot_bounds[s] (any W: the cat x cat cell).
//
// Pass 1 (segsum_tiles): about one wave of persistent blocks, each owning a
// contiguous range of tiles (grid y: groups of G columns, one instantiation
// per G = 1 .. 8).  For each tile:
//
//   - one thread starts 1-D bulk copies (TMA, cp.async.bulk on an
//     mbarrier) of the tile's values (the group's columns, where they are
//     all m columns and 16-byte aligned; else cp.async by every thread) and
//     of its elements into one of NS shared stages, the next tile's copies
//     in flight while this one is summed;
//   - the tile's elements go in chunks of THREADS x ITEMS, ITEMS consecutive
//     elements a thread, each thread summing its runs of one key from the
//     staged values;
//   - a run split over threads is joined by a segmented scan (warp
//     shuffles, then each warp over the warps' totals; a run that crosses a
//     chunk is carried to the next), and the thread that holds a run's end
//     adds its total to the block's accumulator (tiles) or writes it to its
//     slot (slots).  Within a tile a segment has one run, so no two threads
//     touch one accumulator slot, and the tiles go in order.
//
// Pass 2: tiles: out[s, j] = sum over the blocks' partials in block order
// (32 lanes over the blocks, then the lanes in order); slots: out[s, j] =
// the segment's slots in order.  An empty segment comes out 0.
//
// What holds it back (tools/time_segsum.py, PERF.md): the walk issues about
// 300 instructions a thread for its 8 elements (the run logic, the scans,
// two barriers a chunk), so a chunk of 2048 elements takes about 1.4 us on
// two blocks an SM; in the slots route the scattered stores of the runs'
// totals (about one an element at W = 10^6) cost as much again.
//
// No atomics and a fixed order: a result repeats bit for bit on one card
// (the wave's size sets the tile ranges).  The C functions launch on the
// given stream, do not synchronise and return cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int ITEMS = 8;  // consecutive elements a thread; tiles pad to a multiple
constexpr int CHUNK = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int NONE = INT_MAX;  // the key of a thread with no element
constexpr int NS = 2;  // stages: the copies of the next NS - 1 tiles in flight
constexpr int JOIN_LANES = 32;  // pass 2 of the tiles route: lanes over the blocks

// One plan's row-tile layout on the card.
struct Layout {
  const int* tile_off;    // tiles + 1 element offsets, multiples of ITEMS
  const int* words;       // tiles route: local row << 16 | segment
  const short* rows;      // slots route: local row
  const int* slots;       // slots route: slot of the element's run
};

// Stage elements of one buffer for R rows and G columns, and the zero row,
// rounded to 16 bytes.
template <typename T>
__host__ __device__ constexpr int stage_elems(int R, int G) {
  return ((R + 1) * G + (int)(16 / sizeof(T)) - 1) / (int)(16 / sizeof(T)) *
         (int)(16 / sizeof(T));
}

// Bytes of a stage's elements: words (tiles) or rows and slots (slots),
// for at most max_tile elements a tile (a multiple of ITEMS).
template <bool SLOTS>
__host__ __device__ constexpr int word_bytes(int max_tile) {
  return max_tile * (SLOTS ? 6 : 4);
}

// NS stages (values, then the tile's elements), the tiles route's (W, G)
// accumulator and a block's tile_off.
template <typename T, bool SLOTS>
__host__ __device__ constexpr long long smem_bytes(int R, int G, int W, int tpb, int max_tile) {
  return (long long)NS * (stage_elems<T>(R, G) * (long long)sizeof(T) + word_bytes<SLOTS>(max_tile)) +
         (SLOTS ? 0LL : (long long)W * G * (long long)sizeof(T)) + 4LL * (tpb + 1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One thread's 1-D bulk copy (TMA) of bytes (a multiple of 16, both ends
// 16-byte aligned), completing on the mbarrier bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// Copies rows [row0, row0 + rows) of the group's nj columns into dst as
// (rows, nj): one contiguous span when the group is all m columns (16-byte
// copies where the span is aligned), else one copy an element.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ values, long long row0,
                                           int rows, int m, int j0, int nj) {
  if (nj == m) {
    const T* src = values + row0 * m;
    const int count = rows * m;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      constexpr int PER = 16 / sizeof(T);
      const int vec = count / PER;
      for (int i = threadIdx.x; i < vec; i += THREADS) cp_async16(dst + i * PER, src + i * PER);
      done = vec * PER;
    }
    for (int i = done + threadIdx.x; i < count; i += THREADS)
      cp_async_ca<(int)sizeof(T)>(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < rows * nj; i += THREADS) {
      const int r = i / nj;
      const int j = i - r * nj;
      cp_async_ca<(int)sizeof(T)>(dst + i, values + (row0 + r) * m + j0 + j);
    }
  }
}

// A thread's ITEMS elements as loaded: 32 bytes of words (tiles) or 16 of
// rows and 32 of slots (slots).
template <bool SLOTS>
struct Raw {
  int4 a, b, c;
};

// A thread's ITEMS elements from e on in a stage's elements sw (rows, then
// slots at max_tile * 2 bytes, in the slots route).
template <bool SLOTS>
__device__ __forceinline__ Raw<SLOTS> load_raw(const unsigned char* sw, int max_tile, int e,
                                               bool active) {
  Raw<SLOTS> r;
  r.a = r.b = r.c = make_int4(0, 0, 0, 0);
  if (active) {
    if (SLOTS) {
      r.a = *reinterpret_cast<const int4*>(sw + 2 * e);
      const int4* k = reinterpret_cast<const int4*>(sw + 2 * max_tile + 4 * e);
      r.b = k[0];
      r.c = k[1];
    } else {
      const int4* w = reinterpret_cast<const int4*>(sw + 4 * e);
      r.a = w[0];
      r.b = w[1];
    }
  }
  return r;
}

template <bool SLOTS>
__device__ __forceinline__ void decode(const Raw<SLOTS>& r, int (&key)[ITEMS], int (&row)[ITEMS]) {
  if (SLOTS) {
    const int h[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
    const int s[8] = {r.b.x, r.b.y, r.b.z, r.b.w, r.c.x, r.c.y, r.c.z, r.c.w};
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      row[i] = (h[i >> 1] >> (16 * (i & 1))) & 0xffff;
      key[i] = s[i];
    }
  } else {
    const int w[8] = {r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      row[i] = w[i] >> 16;
      key[i] = w[i] & 0xffff;
    }
  }
}

// The end of a run: the tiles route adds its total to the block's
// accumulator row, the slots route writes it to its slot.
template <typename T, int MG, bool SLOTS>
__device__ __forceinline__ void write_run(int key, const T (&v)[MG], T* acc, T* __restrict__ sums,
                                          int nj, int m, int j0) {
  if (SLOTS) {
    T* o = sums + (long long)key * m + j0;
#pragma unroll
    for (int j = 0; j < MG; ++j)
      if (j < nj) o[j] = v[j];
  } else {
    T* o = acc + key * nj;
#pragma unroll
    for (int j = 0; j < MG; ++j)
      if (j < nj) o[j] += v[j];
  }
}

// One chunk of a tile: walk, segmented scan, run ends.  s_key[0] / s_val[0]
// hold the open run carried from the tile's previous chunk (key -1: none).
template <typename T, int MG, bool SLOTS>
__device__ __forceinline__ void sum_chunk(const Raw<SLOTS>& cur, bool active, const T* st, T* acc,
                                          T* __restrict__ sums, int nj, int m, int j0,
                                          int* s_key, int* s_first, T (*s_val)[MG]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int key[ITEMS], row[ITEMS];
  decode<SLOTS>(cur, key, row);

  // m = 1: every value is loaded before any run is written (the stores to
  // the accumulator would otherwise hold back the loads after them), and
  // the runs that end inside the thread are written after the walk
  T x[ITEMS];
  int end_key[ITEMS];
  T end_val[ITEMS];
  bool ended[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    ended[i] = false;
    if (MG == 1) x[i] = st[row[i]];
  }
  T run[MG], head[MG];
#pragma unroll
  for (int j = 0; j < MG; ++j) run[j] = head[j] = T(0);
  const int kf = active ? key[0] : NONE;  // the thread's first and last keys
  int kc = kf;
  bool changed = false;
  if (active) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (key[i] != kc) {  // the run of kc ends before element i
        if (changed) {  // inside this thread
          if (MG == 1) {
            ended[i] = true;
            end_key[i] = kc;
            end_val[i] = run[0];
          } else {
            write_run<T, MG, SLOTS>(kc, run, acc, sums, nj, m, j0);
          }
        } else {
#pragma unroll
          for (int j = 0; j < MG; ++j) head[j] = run[j];  // may continue from before
          changed = true;
        }
#pragma unroll
        for (int j = 0; j < MG; ++j) run[j] = T(0);
        kc = key[i];
      }
      if (MG == 1) {
        run[0] += x[i];
      } else {
        const T* v = st + row[i] * nj;
#pragma unroll
        for (int j = 0; j < MG; ++j)
          if (j < nj) run[j] += v[j];
      }
    }
    if (MG == 1) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if (ended[i]) {
          const T v[MG] = {end_val[i]};
          write_run<T, MG, SLOTS>(end_key[i], v, acc, sums, nj, m, j0);
        }
      }
    }
  }

  // segmented inclusive scan of the open runs, keyed by the last key: in
  // the warp by shuffles, then over the warps' totals from the carry
  T incl[MG];
#pragma unroll
  for (int j = 0; j < MG; ++j) incl[j] = run[j];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int k2 = __shfl_up_sync(FULL, kc, off);
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      const T v2 = __shfl_up_sync(FULL, incl[j], off);
      if (lane >= off && k2 == kc) incl[j] += v2;
    }
  }
  if (lane == 31) {
    s_key[warp + 1] = kc;
#pragma unroll
    for (int j = 0; j < MG; ++j) s_val[warp + 1][j] = incl[j];
  }
  if (lane == 0) s_first[warp] = kf;
  __syncthreads();
  // each warp scans the carry (entry 0) and the warps' totals (entry w + 1)
  // itself: lane e holds entry e, and entry w is the open run before warp w
  int ek = lane <= WARPS ? s_key[lane] : NONE;
  T ev[MG];
#pragma unroll
  for (int j = 0; j < MG; ++j) ev[j] = lane <= WARPS ? s_val[lane][j] : T(0);
#pragma unroll
  for (int off = 1; off <= WARPS; off <<= 1) {
    const int k2 = __shfl_up_sync(FULL, ek, off);
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      const T v2 = __shfl_up_sync(FULL, ev[j], off);
      if (lane >= off && k2 == ek) ev[j] += v2;
    }
  }
  const int pk = __shfl_sync(FULL, ek, warp);
  T pv[MG];
#pragma unroll
  for (int j = 0; j < MG; ++j) {
    pv[j] = __shfl_sync(FULL, ev[j], warp);
    if (pk == kc) incl[j] += pv[j];
  }
  // the open run before this thread, and the first key after it
  int bk = __shfl_up_sync(FULL, kc, 1);
  T bv[MG];
#pragma unroll
  for (int j = 0; j < MG; ++j) bv[j] = __shfl_up_sync(FULL, incl[j], 1);
  if (lane == 0) {
    bk = pk;
#pragma unroll
    for (int j = 0; j < MG; ++j) bv[j] = pv[j];
  }
  int nk = __shfl_down_sync(FULL, kf, 1);
  if (lane == 31) nk = warp + 1 < WARPS ? s_first[warp + 1] : NONE;

  if (tid == 0 && s_key[0] >= 0 && s_key[0] != kf) {
    // the carried run ended with the previous chunk
    T c[MG];
#pragma unroll
    for (int j = 0; j < MG; ++j) c[j] = s_val[0][j];
    write_run<T, MG, SLOTS>(s_key[0], c, acc, sums, nj, m, j0);
  }
  if (changed) {  // the thread's first run ends inside it
    if (bk == kf) {
#pragma unroll
      for (int j = 0; j < MG; ++j) head[j] += bv[j];
    }
    write_run<T, MG, SLOTS>(kf, head, acc, sums, nj, m, j0);
  }
  const bool carry = kc != NONE && nk == NONE;  // the chunk's last run may go on
  if (kc != NONE && nk != NONE && nk != kc) write_run<T, MG, SLOTS>(kc, incl, acc, sums, nj, m, j0);
  __syncthreads();
  if (carry) {
    s_key[0] = kc;
#pragma unroll
    for (int j = 0; j < MG; ++j) s_val[0][j] = incl[j];
  }
}

// Starts tile g's copies into stage st (values) and sw (elements): one
// thread's bulk copies where the group is all m columns and the span is
// 16-byte aligned, else cp.async copies by every thread for the values.
template <typename T, bool SLOTS>
__device__ __forceinline__ void issue_tile(const T* __restrict__ values, const Layout& L, int g,
                                           int e0, int e1, int n, int R, int m, int j0, int nj,
                                           int max_tile, T* st, unsigned char* sw,
                                           unsigned bar) {
  const int rows = n - g * R < R ? n - g * R : R;
  const T* src = values + (long long)g * R * m;
  const int value_bytes = rows * m * (int)sizeof(T);
  const bool bulk = nj == m && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                    (value_bytes & 15) == 0;
  if (!bulk) stage_tile(st, values, (long long)g * R, rows, m, j0, nj);
  if (threadIdx.x == 0) {
    const int count = e1 - e0;
    // the stage's last readers are done (the block's barrier); order their
    // reads before the copies' writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int bytes = (bulk ? value_bytes : 0) + word_bytes<SLOTS>(count);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
    if (bulk && value_bytes > 0) bulk_copy(st, src, value_bytes, bar);
    if (count > 0) {
      if (SLOTS) {
        bulk_copy(sw, L.rows + e0, 2 * count, bar);
        bulk_copy(sw + 2 * max_tile, L.slots + e0, 4 * count, bar);
      } else {
        bulk_copy(sw, L.words + e0, 4 * count, bar);
      }
    }
  }
}

// Pass 1.  sums: the tiles route's partials, (groups, blocks, W, nj) with
// a group's block stride W * nj, or the slots route's slot values (slots, m).
// tpb: at least the tiles of any block; max_tile: at least the elements of
// any tile (a multiple of ITEMS).
template <typename T, int MG, bool SLOTS>
__global__ void __launch_bounds__(THREADS, 1)  // (THREADS) alone spills 16 bytes at <double, 1>
segsum_tiles(const T* __restrict__ values, Layout L, int n, int R, int tiles, int m, int G,
             int W, int tpb, int max_tile, T* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_key[WARPS + 1];
  __shared__ int s_first[WARPS];
  __shared__ T s_val[WARPS + 1][MG];
  __shared__ __align__(8) unsigned long long s_bar[NS];

  const int tid = threadIdx.x;
  const int j0 = blockIdx.y * G;
  const int nj = m - j0 < MG ? m - j0 : MG;
  const int se = stage_elems<T>(R, G);
  const int stage_bytes = se * (int)sizeof(T) + word_bytes<SLOTS>(max_tile);
  T* acc = reinterpret_cast<T*>(smem + NS * stage_bytes);  // the tiles route's (W, nj)
  int* s_off = reinterpret_cast<int*>(acc + (SLOTS ? 0 : W * G));  // the block's tile_off
  const int B = gridDim.x;
  const int g0 = (int)((long long)tiles * blockIdx.x / B);
  const int g1 = (int)((long long)tiles * (blockIdx.x + 1) / B);
  auto stage_values = [&](int s) { return reinterpret_cast<T*>(smem + s * stage_bytes); };
  auto stage_words = [&](int s) { return smem + s * stage_bytes + se * (int)sizeof(T); };
  auto bar = [&](int s) { return (unsigned)__cvta_generic_to_shared(&s_bar[s]); };

  for (int i = tid; i <= g1 - g0; i += THREADS) s_off[i] = __ldg(L.tile_off + g0 + i);
  for (int i = tid; i < NS * nj; i += THREADS) {
    const int s = i / nj;
    stage_values(s)[R * nj + i - s * nj] = T(0);  // the zero row that padding reads
  }
  if (!SLOTS)
    for (int i = tid; i < W * nj; i += THREADS) acc[i] = T(0);
  if (tid == 0) {
    s_key[0] = -1;
    for (int s = 0; s < NS; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar(s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first NS - 1 tiles in flight
  for (int k = 0; k < NS - 1 && g0 + k < g1; ++k)
    issue_tile<T, SLOTS>(values, L, g0 + k, s_off[k], s_off[k + 1], n, R, m, j0, nj, max_tile,
                         stage_values(k), stage_words(k), bar(k));
  cp_async_commit();

  for (int g = g0; g < g1; ++g) {
    const int i = g - g0;
    const int ga = g + NS - 1;  // the tile whose copies start now
    const int sa = (i + NS - 1) % NS;
    if (ga < g1)
      issue_tile<T, SLOTS>(values, L, ga, s_off[ga - g0], s_off[ga - g0 + 1], n, R, m, j0, nj,
                           max_tile, stage_values(sa), stage_words(sa), bar(sa));
    cp_async_commit();
    cp_async_wait<1>();
    mbar_wait(bar(i % NS), (unsigned)((i / NS) & 1));
    __syncthreads();
    const T* st = stage_values(i % NS);
    const unsigned char* sw = stage_words(i % NS);
    const int e0 = s_off[i];
    const int te = s_off[i + 1];
    for (int ce = e0; ce < te; ce += CHUNK) {
      const int e = ce - e0 + tid * ITEMS;
      const bool active = ce + tid * ITEMS < te;
      sum_chunk<T, MG, SLOTS>(load_raw<SLOTS>(sw, max_tile, e, active), active, st, acc, sums,
                              nj, m, j0, s_key, s_first, s_val);
    }
    __syncthreads();
    if (tid == 0 && s_key[0] >= 0) {  // the tile's last run
      T c[MG];
#pragma unroll
      for (int j = 0; j < MG; ++j) c[j] = s_val[0][j];
      write_run<T, MG, SLOTS>(s_key[0], c, acc, sums, nj, m, j0);
      s_key[0] = -1;
    }
  }
  cp_async_wait<0>();
  if (!SLOTS) {
    __syncthreads();
    T* out = sums + (long long)blockIdx.y * B * W * G + (long long)blockIdx.x * W * nj;
    for (int i = tid; i < W * nj; i += THREADS) out[i] = acc[i];
  }
}

// Pass 2 of the tiles route: out[s * m + col] = the blocks' partials of
// (s, col) in block order.  A block takes 32 outputs; lane l of the 32
// sums blocks l, l + 32, ... in order, then lane 0 the lanes in order.
template <typename T>
__global__ void __launch_bounds__(32 * JOIN_LANES)
segsum_join_blocks(const T* __restrict__ partial, int B, int W, int m, int G,
                   T* __restrict__ out) {
  __shared__ T s_red[JOIN_LANES][33];
  const int x = threadIdx.x & 31;
  const int lb = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * 32 + x;
  const long long total = (long long)W * m;
  T sum = T(0);
  if (i < total) {
    const long long s = i / m;
    const int col = (int)(i - s * m);
    const int y = col / G;
    const int j = col - y * G;
    const int nj = m - y * G < G ? m - y * G : G;
    const T* p = partial + (long long)y * B * W * G + s * nj + j;
    const long long stride = (long long)W * nj;
#pragma unroll 4
    for (int b = lb; b < B; b += JOIN_LANES) sum += __ldg(p + b * stride);
  }
  s_red[lb][x] = sum;
  __syncthreads();
  if (lb == 0 && i < total) {
    T t = s_red[0][x];
#pragma unroll
    for (int l = 1; l < JOIN_LANES; ++l) t += s_red[l][x];
    out[i] = t;
  }
}

// Pass 2 of the slots route: out[s * m + col] = the segment's slots in order.
template <typename T>
__global__ void __launch_bounds__(256)
segsum_join_slots(const T* __restrict__ slot_val, const int* __restrict__ slot_bounds, int W,
                  int m, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)W * m) return;
  const long long s = i / m;
  const int col = (int)(i - s * m);
  const int a = __ldg(slot_bounds + s);
  const int b = __ldg(slot_bounds + s + 1);
  T sum = T(0);
  for (int t = a; t < b; ++t) sum += __ldg(slot_val + (long long)t * m + col);
  out[i] = sum;
}

template <typename T, int MG, bool SLOTS>
cudaError_t allow_smem(int device) {
  static bool done[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, segsum_tiles<T, MG, SLOTS>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(segsum_tiles<T, MG, SLOTS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

// Blocks of pass 1 resident on one SM, or 0 when the shared memory does not fit.
template <typename T, int MG, bool SLOTS>
int resident(int R, int G, int W, int tpb, int max_tile, int* per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = allow_smem<T, MG, SLOTS>(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, segsum_tiles<T, MG, SLOTS>, THREADS,
      (size_t)smem_bytes<T, SLOTS>(R, G, W, tpb, max_tile));
}

template <typename T, int MG, bool SLOTS>
int launch(const T* values, const Layout& L, int n, int R, int tiles, int m, int G, int W,
           int blocks, int tpb, int max_tile, const int* slot_bounds, T* sums, T* out,
           cudaStream_t st) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = allow_smem<T, MG, SLOTS>(device);
  if (err != cudaSuccess) return (int)err;
  const int groups = (m + G - 1) / G;
  segsum_tiles<T, MG, SLOTS>
      <<<dim3((unsigned)blocks, (unsigned)groups), THREADS,
         (size_t)smem_bytes<T, SLOTS>(R, G, W, tpb, max_tile), st>>>(values, L, n, R, tiles, m, G,
                                                                      W, tpb, max_tile, sums);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)W * m;
  if (SLOTS) {
    segsum_join_slots<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(sums, slot_bounds, W,
                                                                           m, out);
  } else {
    segsum_join_blocks<T><<<(unsigned)((total + 31) / 32), 32 * JOIN_LANES, 0, st>>>(
        sums, blocks, W, m, G, out);
  }
  return (int)cudaGetLastError();
}

// One instantiation per group width G = 1 .. MAX_GROUP, so that no register
// or shuffle is spent on an absent column (a call's last group may be
// narrower; its loads and stores skip the columns past m).
template <typename T, bool SLOTS>
int launch_cols(const T* values, const Layout& L, int n, int R, int tiles, int m, int G, int W,
                int blocks, int tpb, int max_tile, const int* slot_bounds, T* sums, T* out,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
#define SEGSUM_CASE(MG)                                                                      \
  case MG:                                                                                   \
    return launch<T, MG, SLOTS>(values, L, n, R, tiles, m, G, W, blocks, tpb, max_tile,   \
                                slot_bounds, sums, out, st);
    SEGSUM_CASE(1) SEGSUM_CASE(2) SEGSUM_CASE(3) SEGSUM_CASE(4)
    SEGSUM_CASE(5) SEGSUM_CASE(6) SEGSUM_CASE(7) SEGSUM_CASE(8)
#undef SEGSUM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool SLOTS>
int resident_cols(int R, int G, int W, int tpb, int max_tile, int* per_sm) {
  switch (G) {
#define SEGSUM_CASE(MG) \
  case MG:              \
    return resident<T, MG, SLOTS>(R, G, W, tpb, max_tile, per_sm);
    SEGSUM_CASE(1) SEGSUM_CASE(2) SEGSUM_CASE(3) SEGSUM_CASE(4)
    SEGSUM_CASE(5) SEGSUM_CASE(6) SEGSUM_CASE(7) SEGSUM_CASE(8)
#undef SEGSUM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Pass-1 blocks resident on one SM of the current device, into *per_sm
// (G = 1 .. 8).
int tabmat_segsum_resident(int f64, int slots, int R, int G, int W, int tpb, int max_tile,
                           int* per_sm) {
  if (f64)
    return slots ? resident_cols<double, true>(R, G, W, tpb, max_tile, per_sm)
                 : resident_cols<double, false>(R, G, W, tpb, max_tile, per_sm);
  return slots ? resident_cols<float, true>(R, G, W, tpb, max_tile, per_sm)
               : resident_cols<float, false>(R, G, W, tpb, max_tile, per_sm);
}

// The tiles route: partial holds groups * blocks * W * G values, out W * m;
// tpb is at least ceil(tiles / blocks), max_tile at least any tile's
// elements.
int tabmat_segsum_f64(const double* values, const int* tile_off, const int* words, int n, int R,
                      int tiles, int m, int G, int W, int blocks, int tpb, int max_tile,
                      double* partial, double* out, void* stream) {
  const Layout L{tile_off, words, nullptr, nullptr};
  return launch_cols<double, false>(values, L, n, R, tiles, m, G, W, blocks, tpb, max_tile,
                                    nullptr, partial, out, stream);
}

int tabmat_segsum_f32(const float* values, const int* tile_off, const int* words, int n, int R,
                      int tiles, int m, int G, int W, int blocks, int tpb, int max_tile,
                      float* partial, float* out, void* stream) {
  const Layout L{tile_off, words, nullptr, nullptr};
  return launch_cols<float, false>(values, L, n, R, tiles, m, G, W, blocks, tpb, max_tile,
                                   nullptr, partial, out, stream);
}

// The slots route: slot_val holds n_slots * m values, out W * m.
int tabmat_segsum_slots_f64(const double* values, const int* tile_off, const short* rows,
                            const int* slots, const int* slot_bounds, int n, int R, int tiles,
                            int m, int G, int W, int blocks, int tpb, int max_tile,
                            double* slot_val, double* out, void* stream) {
  const Layout L{tile_off, nullptr, rows, slots};
  return launch_cols<double, true>(values, L, n, R, tiles, m, G, W, blocks, tpb, max_tile,
                                   slot_bounds, slot_val, out, stream);
}

int tabmat_segsum_slots_f32(const float* values, const int* tile_off, const short* rows,
                            const int* slots, const int* slot_bounds, int n, int R, int tiles,
                            int m, int G, int W, int blocks, int tpb, int max_tile,
                            float* slot_val, float* out, void* stream) {
  const Layout L{tile_off, nullptr, rows, slots};
  return launch_cols<float, true>(values, L, n, R, tiles, m, G, W, blocks, tpb, max_tile,
                                  slot_bounds, slot_val, out, stream);
}

const char* tabmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
