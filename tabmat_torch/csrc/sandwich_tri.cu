// Triangle sandwich S = X^T diag(d) X for float32 X at 33 <= k <= 176 on
// Hopper (sm_90a).
//
// Replaces tabmat_tpu/ops/pallas_kernels.py:_sandwich_kernel (f32,
// Precision.HIGHEST, one pass over X) at these widths.  The product is plain
// FP32 FFMA, never TF32: (d * x) is rounded to f32 as the plain version
// rounds it, then multiplied and added.
//
// Bound: at 1M x 50 bytes (200 MB of X: 0.061 ms at 3.35 TB/s, against
// 0.039 ms for the upper triangle's 2.6 GFLOP at 67 TFLOP/s); at 400k x 160
// operations (10.4 GFLOP: 0.155 ms, against 0.077 ms for 256 MB of X).  The
// 64 x 64 tiles of the tiled kernel this one replaced did 3.2x the useful
// products at k = 50 and 1.9x at k = 160, and their 4 x 4 micro-tiles read
// 8 shared values for 16 FFMAs: an SM issues four FFMA warp-instructions a
// cycle but serves one shared wavefront.  Here, as in sandwich_narrow.cu, a
// block owns the whole upper triangle:
//
//   pass 1: a 1-D grid of row splits that fills one wave of resident
//           blocks (two per SM, 121-123 registers a thread).  The k x k
//           output is cut into 8 x 8 micro-tiles; each thread keeps one
//           upper micro-tile (ti <= tj) in 64 registers: 28 tiles at
//           k = 50, 210 at k = 160, at most 253 at k = 176.  The
//           THREADS / tiles row groups of a block take every groups-th
//           staged row (9 groups at k = 50, 1 at k = 160).  The kernel is
//           built once for each nt = ceil(k / 8) from 5 to 22, so the pitch,
//           the groups and the stage's rows are constants and a thread's
//           loop over its rows, two rows a turn, reads at fixed offsets
//           from four pointers.
//           Runs of rows and their weights are copied with cp.async, three
//           stages (two in flight while one is summed), one barrier a
//           stage; a thread copies one column slot of every passes-th row,
//           so a copy costs no division.  Rows are staged at a pitch of
//           8 * nt floats, so that every micro-tile's 8 values start on 32
//           bytes: a row costs a thread four 16-byte shared loads for 64
//           FFMAs at any k.  The copies are 16 bytes where k % 4 == 0
//           (k = 160), else 8 (k even: k = 50) or 4 bytes; they are a few
//           per cent of a stage's instructions, the shared loads of the
//           inner loop are not, so the pitch is padded rather than the
//           loads narrowed to 8 bytes.  The halves of a micro-tile are
//           loaded in swapped order in every other run of four tiles, so
//           that a warp's loads of eight neighbouring tiles fall on eight
//           distinct 16-byte bank slots.  Columns past k read the padding
//           and land in entries that are never written.  At the end the
//           row groups' sums are added in group order and the block writes
//           its tiles to partial[split] (tiles * 64 floats, coalesced).
//           What is left at 400k x 160: 46 of 256 threads hold no tile, and
//           d * x costs 8 FMULs a row beside the 64 FFMAs (scaling the
//           staged rows once instead was slower: it needs a second buffer
//           and halves the stage).
//   pass 2: a block of 32 x 16 threads takes 32 neighbouring partial
//           entries; row y of it sums the splits y, y + 16, ... in order,
//           then the 16 rows are added in order.  The entry's upper element
//           (i, j) is written to (i, j) and (j, i); with accumulate it is
//           added to out.
//
// No atomics: the result is the same from run to run and exactly symmetric.
// The C functions launch on the given stream, do not synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MT = 8;                  // micro-tile edge: a thread's 8 x 8 outputs
constexpr int MIN_K = 33;              // narrower widths go to sandwich_narrow.cu
constexpr int MAX_K = 176;             // 22 tiles a side: 253 upper micro-tiles
constexpr int STAGE = 8192;            // floats of X per stage (rows * pitch <= STAGE)
constexpr int MAX_STAGE_ROWS = 204;    // STAGE / 40, the pitch at k <= 40
constexpr int W_SLOTS = 208;           // a stage's weights, padded to 16 bytes
constexpr int STAGE_FLOATS = STAGE + W_SLOTS;
constexpr int STAGES = 3;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);  // 100,800
constexpr int RED_COLS = 32;           // pass 2: entries a block
constexpr int RED_ROWS = 16;           // pass 2: split strides a block

static_assert((MAX_K / MT) * (MAX_K / MT + 1) / 2 <= THREADS, "one upper tile a thread");
static_assert(THREADS * MT * MT <= STAGES * STAGE_FLOATS, "group sums must fit the staging memory");
static_assert(MAX_STAGE_ROWS <= W_SLOTS && W_SLOTS % 4 == 0, "weights must fit their slots");

// the p-th upper-triangular pair (a, a + q) of an nt x nt grid, row by row
__device__ __forceinline__ void upper_pair(int p, int nt, int& a, int& b) {
  a = 0;
  while (p >= nt - a) {
    p -= nt - a;
    ++a;
  }
  b = a + p;
}

// VEC floats global -> shared, asynchronously
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(VEC * 4));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + rows) of X, row r at buf + r * pitch, in VEC-float copies:
// thread t copies column slot t % per_row of rows t / per_row + i * passes
template <int VEC>
__device__ __forceinline__ void stage_x(float* buf, const float* __restrict__ X, long long r0,
                                        int rows, int k, int pitch) {
  const int per_row = k / VEC;
  const int passes = THREADS / per_row;
  const int r_first = threadIdx.x / per_row;
  if (r_first >= passes) return;
  const int c = (threadIdx.x - r_first * per_row) * VEC;
  const float* src = X + (r0 + r_first) * k + c;
  float* dst = buf + r_first * pitch + c;
  for (int r = r_first; r < rows; r += passes) {
    copy_async<VEC>(dst, src);
    src += (long long)passes * k;
    dst += passes * pitch;
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// one row into a thread's micro-tile: its operands at off floats past the
// four pointers, its weight at woff past xw
__device__ __forceinline__ void fma_row(float (&acc)[MT][MT], const float* xa, const float* xa2,
                                        const float* xb, const float* xb2, const float* xw,
                                        int off, int woff) {
  const float w = xw[woff];
  const float4 a0 = load4(xa + off), a1 = load4(xa2 + off);
  const float4 b0 = load4(xb + off), b1 = load4(xb2 + off);
  const float a[MT] = {a0.x * w, a0.y * w, a0.z * w, a0.w * w,
                       a1.x * w, a1.y * w, a1.z * w, a1.w * w};
  const float b[MT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int v = 0; v < MT; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
tri_partial(const float* __restrict__ X, const float* __restrict__ d,
            float* __restrict__ partial, long long n, int k, long long rows_per_split,
            int vec) {
  constexpr int PITCH = NT * MT;
  constexpr int TILES = NT * (NT + 1) / 2;
  constexpr int GROUPS = THREADS / TILES;
  constexpr int STAGE_ROWS = STAGE / PITCH < MAX_STAGE_ROWS ? STAGE / PITCH : MAX_STAGE_ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int g = threadIdx.x / TILES;
  const int p = threadIdx.x - g * TILES;
  int ti, tj;
  upper_pair(p, NT, ti, tj);
  // which half of each micro-tile is loaded first (bank slots, see above);
  // register u holds the tile's column u ^ sa, register v column v ^ sb
  const int sa = ti & 4;
  const int sb = tj & 4;
  const int a_first = ti * MT + sa, a_second = ti * MT + (sa ^ 4);
  const int b_first = tj * MT + sb, b_second = tj * MT + (sb ^ 4);

  const long long row_begin = (long long)blockIdx.x * rows_per_split;
  const long long row_end =
      row_begin + rows_per_split < n ? row_begin + rows_per_split : n;
  const long long span = row_end > row_begin ? row_end - row_begin : 0;
  const int stages = (int)((span + STAGE_ROWS - 1) / STAGE_ROWS);
  auto rows_of = [&](int st) {
    const long long left = span - (long long)st * STAGE_ROWS;
    return (int)(left < STAGE_ROWS ? left : STAGE_ROWS);
  };
  auto issue = [&](int st) {
    float* buf = smem + (st % STAGES) * STAGE_FLOATS;
    const long long r0 = row_begin + (long long)st * STAGE_ROWS;
    const int rows = rows_of(st);
    if (vec == 4) {
      stage_x<4>(buf, X, r0, rows, k, PITCH);
    } else if (vec == 2) {
      stage_x<2>(buf, X, r0, rows, k, PITCH);
    } else {
      stage_x<1>(buf, X, r0, rows, k, PITCH);
    }
    for (int r = threadIdx.x; r < rows; r += THREADS) copy_async<1>(buf + STAGE + r, d + r0 + r);
  };

  float acc[MT][MT];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int v = 0; v < MT; ++v) acc[u][v] = 0.f;

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
    const float* buf = smem + (st % STAGES) * STAGE_FLOATS;
    const int rows = rows_of(st);
    if (g < GROUPS) {
      const float* xa = buf + g * PITCH + a_first;
      const float* xa2 = buf + g * PITCH + a_second;
      const float* xb = buf + g * PITCH + b_first;
      const float* xb2 = buf + g * PITCH + b_second;
      const float* xw = buf + STAGE + g;
      int r = g;
      for (; r + GROUPS < rows; r += 2 * GROUPS) {
        fma_row(acc, xa, xa2, xb, xb2, xw, 0, 0);
        fma_row(acc, xa, xa2, xb, xb2, xw, GROUPS * PITCH, GROUPS);
        xa += 2 * GROUPS * PITCH;
        xa2 += 2 * GROUPS * PITCH;
        xb += 2 * GROUPS * PITCH;
        xb2 += 2 * GROUPS * PITCH;
        xw += 2 * GROUPS;
      }
      if (r < rows) fma_row(acc, xa, xa2, xb, xb2, xw, 0, 0);
    }
  }
  wait_copies<0>();
  __syncthreads();

  // the row groups' sums, at red[uv * GROUPS * TILES + g * TILES + p] for
  // the tile's element (u, v), then added in group order
  float* red = smem;
  constexpr int GT = GROUPS * TILES;
  if (g < GROUPS) {
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int v = 0; v < MT; ++v) red[((u ^ sa) * MT + (v ^ sb)) * GT + g * TILES + p] = acc[u][v];
  }
  __syncthreads();
  constexpr int SIZE = TILES * MT * MT;
  float* out = partial + (long long)blockIdx.x * SIZE;
  for (int e = threadIdx.x; e < SIZE; e += THREADS) {
    const int uv = e / TILES;
    const float* src = red + uv * GT + (e - uv * TILES);
    float s = src[0];
#pragma unroll
    for (int gg = 1; gg < GROUPS; ++gg) s += src[gg * TILES];
    out[e] = s;  // partial[split][uv][tile]
  }
}

__global__ void __launch_bounds__(RED_COLS * RED_ROWS)
tri_reduce(const float* __restrict__ partial, float* __restrict__ out, int k, int splits,
           int accumulate) {
  __shared__ float red[RED_ROWS][RED_COLS];
  const int nt = (k + MT - 1) / MT;
  const int tiles = nt * (nt + 1) / 2;
  const int size = tiles * MT * MT;
  const int e = blockIdx.x * RED_COLS + threadIdx.x;
  float s = 0.f;
  if (e < size) {
#pragma unroll 4
    for (int sp = threadIdx.y; sp < splits; sp += RED_ROWS) s += partial[(long long)sp * size + e];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || e >= size) return;
  float t = red[0][threadIdx.x];
#pragma unroll
  for (int y = 1; y < RED_ROWS; ++y) t += red[y][threadIdx.x];
  const int uv = e / tiles;
  int a, b;
  upper_pair(e - uv * tiles, nt, a, b);
  const int u = uv / MT, v = uv % MT;
  const int i = a * MT + u, j = b * MT + v;
  if (j >= k || (a == b && u > v)) return;  // padding, or the lower half of a diagonal tile
  out[i * k + j] = accumulate ? out[i * k + j] + t : t;
  if (i != j) out[j * k + i] = accumulate ? out[j * k + i] + t : t;
}

// the first pass for nt = ceil(k / 8) micro-tiles a side, 5 <= nt <= 22
using PartialFn = void (*)(const float*, const float*, float*, long long, int, long long, int);

template <int NT>
PartialFn partial_for(int nt) {
  if constexpr (NT > MAX_K / MT) {
    return nullptr;
  } else {
    return nt == NT ? tri_partial<NT> : partial_for<NT + 1>(nt);
  }
}

PartialFn partial_kernel(int k) { return partial_for<MIN_K / MT + 1>((k + MT - 1) / MT); }

int allow_shared_memory(PartialFn fn) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace

extern "C" {

// partial holds splits * 64 * tiles floats, tiles = nt (nt + 1) / 2 with
// nt = ceil(k / 8); out holds k * k (added to when accumulate is not 0).
// 33 <= k <= 176.
int tabmat_sandwich_tri_f32(const float* X, const float* d, float* out, float* partial,
                            long long n, int k, int splits, long long rows_per_split,
                            int accumulate, void* stream) {
  if (k < MIN_K || k > MAX_K) return (int)cudaErrorInvalidValue;
  const PartialFn first = partial_kernel(k);
  const int err_attr = allow_shared_memory(first);
  if (err_attr != 0) return err_attr;
  const uintptr_t base = reinterpret_cast<uintptr_t>(X);
  const int vec = (k % 4 == 0 && base % 16 == 0) ? 4 : (k % 2 == 0 && base % 8 == 0) ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {(void*)&X, (void*)&d, (void*)&partial, (void*)&n, (void*)&k,
                  (void*)&rows_per_split, (void*)&vec};
  cudaError_t err = cudaLaunchKernel((const void*)first, dim3(splits), dim3(THREADS), args,
                                     SMEM_BYTES, s);
  if (err != cudaSuccess) return (int)err;
  const int nt = (k + MT - 1) / MT;
  const int size = nt * (nt + 1) / 2 * MT * MT;
  tri_reduce<<<(size + RED_COLS - 1) / RED_COLS, dim3(RED_COLS, RED_ROWS), 0, s>>>(
      partial, out, k, splits, accumulate);
  return (int)cudaGetLastError();
}

// Blocks of the first pass that one SM holds at once at every width, for
// the wrapper's choice of row splits (float32 only: is_f64 must be 0).
int tabmat_sandwich_tri_blocks_per_sm(int is_f64, int* blocks) {
  if (is_f64) return (int)cudaErrorInvalidValue;
  int least = 1 << 30;
  for (int k = MIN_K; k <= MAX_K; k += MT) {
    const PartialFn fn = partial_kernel(k);
    int err = allow_shared_memory(fn);
    int here = 0;
    if (err == 0) {
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&here, fn, THREADS, SMEM_BYTES);
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
