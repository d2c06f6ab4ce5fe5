// K4: one-pass per-(batch, channel) sum and sum of squares of an NHWC tensor,
// the statistics of GroupNorm(1).
//
// Replaces the TPU kernel B7 (ucdir_tpu/ops/stats_pallas.py _stats_forward).
// The TPU kernel walked the rows of one image in order and carried the sums
// in its output block; here blocks run in any order, so each block reduces a
// 256-pixel by 32-channel slab in registers and shared memory and adds its
// 32 partial sums into the zeroed (B, C) outputs with atomics.
// Bound: device-memory bandwidth (2 FLOP per 4-byte read). Each warp reads
// 32 consecutive channels of one pixel, 128 contiguous bytes.
// The _bf16 entry point reads a bf16 tensor (the TPU kernel's bf16
// instantiation: the float sums of bf16 values), half the bytes, 64
// contiguous bytes a warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPixelsPerBlock = 256;

__device__ __forceinline__ float value(float v) { return v; }
__device__ __forceinline__ float value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class E>
__global__ void __launch_bounds__(kWarps * 32)
    gn1_stats_kernel(const E* __restrict__ x, float* __restrict__ ssum,
                     float* __restrict__ ssq, int P, int C) {
  __shared__ float rs[kWarps][32];
  __shared__ float rq[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z;
  const int c = blockIdx.y * 32 + lane;
  const int p0 = blockIdx.x * kPixelsPerBlock;
  const int p1 = min(p0 + kPixelsPerBlock, P);
  float s = 0.f, q = 0.f;
  if (c < C) {
    const E* xb = x + (int64_t)b * P * C + c;
    for (int p = p0 + warp; p < p1; p += kWarps) {
      const float v = value(xb[(int64_t)p * C]);
      s += v;
      q += v * v;
    }
  }
  rs[warp][lane] = s;
  rq[warp][lane] = q;
  __syncthreads();
  if (warp == 0 && c < C) {
    for (int i = 1; i < kWarps; ++i) {
      s += rs[i][lane];
      q += rq[i][lane];
    }
    atomicAdd(&ssum[(int64_t)b * C + c], s);
    atomicAdd(&ssq[(int64_t)b * C + c], q);
  }
}

template <class E>
int launch(const E* x, float* ssum, float* ssq, int B, int P, int C,
           void* stream) {
  dim3 grid((P + kPixelsPerBlock - 1) / kPixelsPerBlock, (C + 31) / 32, B);
  gn1_stats_kernel<E><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      x, ssum, ssq, P, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, P, C) with P = H * W; ssum, ssq zeroed (B, C). Returns the launch's
// cudaError_t.
extern "C" int ucdir_gn1_stats(const float* x, float* ssum, float* ssq, int B,
                               int P, int C, void* stream) {
  return launch(x, ssum, ssq, B, P, C, stream);
}

// K4 on a bf16 x; ssum, ssq float as above.
extern "C" int ucdir_gn1_stats_bf16(const __nv_bfloat16* x, float* ssum,
                                    float* ssq, int B, int P, int C,
                                    void* stream) {
  return launch(x, ssum, ssq, B, P, C, stream);
}
