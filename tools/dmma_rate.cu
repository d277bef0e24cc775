// Throughput of the FP64 tensor-core MMA shapes on one CUDA card.
//
// Build and run from the repository root on a machine with a Hopper card:
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/dmma_rate tools/dmma_rate.cu
//     build/dmma_rate
//
// Each warp issues ITERS rounds of ACC independent mma.sync of one shape
// (m8n8k4, m16n8k4, m16n8k8, m16n8k16, all f64) on registers, with 4 and 8
// warps per block and 4 blocks per SM of a 132-SM card; one line per shape
// gives the CUDA-event time and the rate in TFLOP/s.  It decided the shape
// of tabmat_torch/csrc/sandwich_mma.cu (PERF.md).

#include <cstdio>
#include <cuda_runtime.h>
constexpr int ITERS = 4096;
constexpr int ACC = 8;

__global__ void k884(double* out) {
  double c[ACC][2] = {};
  double a = threadIdx.x * 1e-3, b = 1.0 + threadIdx.x * 1e-4;
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < ACC; ++i)
      asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                   : "+d"(c[i][0]), "+d"(c[i][1]) : "d"(a), "d"(b));
  }
  double s = 0; for (int i = 0; i < ACC; ++i) s += c[i][0] + c[i][1];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k1684(double* out) {
  double c[ACC][4] = {};
  double a0 = threadIdx.x * 1e-3, a1 = a0 + 1, b = 1.0 + threadIdx.x * 1e-4;
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < ACC; ++i)
      asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                   : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3]) : "d"(a0), "d"(a1), "d"(b));
  }
  double s = 0; for (int i = 0; i < ACC; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k1688(double* out) {
  double c[ACC][4] = {};
  double a0 = threadIdx.x * 1e-3, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3, b0 = 1.0 + threadIdx.x * 1e-4, b1 = b0 + 1;
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < ACC; ++i)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3])
                   : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
  }
  double s = 0; for (int i = 0; i < ACC; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k16816(double* out) {
  double c[ACC][4] = {};
  double a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 1e-3 + i;
  for (int i = 0; i < 4; ++i) b[i] = 1.0 + threadIdx.x * 1e-4 + i;
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < ACC; ++i)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
                   : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3])
                   : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                     "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
  double s = 0; for (int i = 0; i < ACC; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename K>
void run(const char* name, K kern, double fma_per_mma, double* out, int warps_per_block) {
  int blocks = 132 * 4;
  int threads = 32 * warps_per_block;
  kern<<<blocks, threads>>>(out);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  kern<<<blocks, threads>>>(out);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  double flop = 2.0 * fma_per_mma * ITERS * ACC * blocks * warps_per_block;
  printf("%s warps/block %d: %.3f ms, %.1f TFLOP/s (%s)\n", name, warps_per_block, ms, flop / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  double* out; cudaMalloc(&out, 132 * 4 * 1024 * sizeof(double));
  for (int w : {4, 8}) {
    run("m8n8k4", k884, 8 * 8 * 4, out, w);
    run("m16n8k4", k1684, 16 * 8 * 4, out, w);
    run("m16n8k8", k1688, 16 * 8 * 8, out, w);
    run("m16n8k16", k16816, 16 * 8 * 16, out, w);
  }
  return 0;
}
