// What the forward convolutions of ucdir_tpu_torch can reach on the card,
// measured apart from the kernels:
//   1. a loop of independent mma.sync m16n8k8 TF32 operations on registers
//      (16 accumulators a thread, 8 warps a block, 1 or 2 blocks per SM): the
//      rate of the tensor-core operation itself, of which a 3xTF32 product
//      would get a third (the form of K2 and K3 that PERF.md reports beside
//      the fp32 FMA one that ships);
//   2. the consumers' loop of csrc/igemm_pc.cuh (consume<Tile>) alone, on a
//      shared memory filled once, the producer warps only keeping the
//      per-slice barrier: what the multiplying side reaches when the staging
//      costs nothing, in TFLOP/s of counted work (2 * BM * BN * BK a slice).
//
// From the root of the checkout (ucdir_tpu_torch/_build/ is where the
// package builds its kernels too, and git ignores it):
//
//   mkdir -p ucdir_tpu_torch/_build && \
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -I ucdir_tpu_torch/csrc -o ucdir_tpu_torch/_build/torch_mma_bench \
//        tools/torch_mma_bench.cu && ucdir_tpu_torch/_build/torch_mma_bench
//
// Prints one line per case. Needs an sm_90a card.
#include <cstdio>

#include "igemm_pc.cuh"

namespace pc = ucdir::pc;

__global__ void __launch_bounds__(256) independent_mma(float* out, int iters,
                                                       float seed) {
  float acc[16][4];
  for (int i = 0; i < 16; ++i) {
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  // small integers: TF32 numbers as they stand
  const float a0 = seed + threadIdx.x % 8, a1 = a0 + 1.f;
  const float b0 = a0 + 2.f, b1 = a0 + 3.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // volatile: identical asm statements must not be merged
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
          : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
            "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)),
            "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
    }
  }
  float s = 0.f;
  for (int i = 0; i < 16; ++i) {
    for (int c = 0; c < 4; ++c) s += acc[i][c];
  }
  if (s == 12345.f) out[0] = s;  // keeps the loop alive
}

template <class T>
__global__ void __launch_bounds__(T::NT) consumers_alone(float* out, int nk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < T::ORG; i += T::NT)  // values in [1, 2)
    smem[i] = __uint_as_float(0x3f800000u + ((i * 2654435761u) & 0x7fe000u));
  pc::block_sync<T::NT>();
  if (threadIdx.x >= T::NC) {
    for (int i = 0; i < nk + 1; ++i) pc::block_sync<T::NT>();
    return;
  }
  float acc[T::TM][T::TN];
  pc::consume<T>(acc, smem, nk);
  float s = 0.f;
  for (int i = 0; i < T::TM; ++i) {
    for (int j = 0; j < T::TN; ++j) s += acc[i][j];
  }
  if (s == 12345.f) out[0] = s;
}

float timed(void (*launch)(float*, int), float* out, int n) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  launch(out, 10);
  cudaEventRecord(e0);
  launch(out, n);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

int g_sms = 0;

template <int BLOCKS_PER_SM>
void launch_independent(float* out, int iters) {
  independent_mma<<<g_sms * BLOCKS_PER_SM, 256>>>(out, iters, 1.f);
}

template <class T>
void launch_consumers(float* out, int nk) {
  consumers_alone<T><<<g_sms, T::NT, T::SMEM_BYTES>>>(out, nk);
}

template <class T>
void report_consumers(const char* name, float* out) {
  const int nk = 2000;
  const float ms = timed(launch_consumers<T>, out, nk);
  printf("consumers of the %s tile alone, 1 block per SM: %.3f ms, %.1f "
         "TFLOP/s of counted work (%s)\n", name, ms,
         2.0 * T::BM * T::BN * T::BK * nk * g_sms / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "torch_mma_bench: no CUDA card\n");
    return 2;
  }
  g_sms = prop.multiProcessorCount;
  printf("%s, %d SMs\n", prop.name, g_sms);
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float));
  const int iters = 4000;
  const float ms1 = timed(launch_independent<1>, out, iters);
  const float ms2 = timed(launch_independent<2>, out, iters);
  const double mmas = 8.0 * 16 * iters * g_sms;  // per launch at 1 block per SM
  printf("independent mma.sync m16n8k8 TF32, 1 block per SM: %.3f ms, %.1f "
         "TFLOP/s TF32, a third of it %.1f (%s)\n", ms1,
         mmas * 2048 / ms1 / 1e9, mmas * 2048 / 3 / ms1 / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  printf("independent mma.sync m16n8k8 TF32, 2 blocks per SM: %.3f ms, %.1f "
         "TFLOP/s TF32, a third of it %.1f\n", ms2,
         2 * mmas * 2048 / ms2 / 1e9, 2 * mmas * 2048 / 3 / ms2 / 1e9);
  report_consumers<pc::Wide>("128 x 128", out);
  report_consumers<pc::Mid>("256 x 64", out);
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 1;
}
