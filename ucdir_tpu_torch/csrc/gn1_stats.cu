// K4: one-pass per-(batch, channel) sum and sum of squares of an NHWC tensor,
// the statistics of GroupNorm(1).
//
// Replaces the TPU kernel B7 (ucdir_tpu/ops/stats_pallas.py _stats_forward).
// The TPU kernel walked the rows of one image in order and carried the sums
// in its output block; here blocks run in any order, so each block reduces a
// 256-pixel by 32-channel slab in registers and shared memory (its warps'
// sums added in warp order) and stores its 32 partial sums into a (B,
// slabs, 2, C) workspace, which stats_reduce_kernel (tile_sums.cuh) adds in
// a fixed order: no atomics, the same bits from call to call.
// Bound: device-memory bandwidth (2 FLOP per 4-byte read). Each warp reads
// 32 consecutive channels of one pixel, 128 contiguous bytes.
//
// The _bf16 entry point (the TPU kernel's bf16 instantiation: the float sums
// of bf16 values) adds in a fixed order too:
// - A block of 256 threads takes a slab of pixels by up to 256 channels:
//   thread t holds chunk t % nk of 8 channels (nk = min(ceil(C / 8), 32)
//   chunks a block) and pixel row t / nk of R = 256 / nk rows; it reads 16
//   bytes, one pixel's 8 channels, a load, and adds rows r, r + R, ... of
//   the slab (kRows of them: slab = R * kRows pixels) in ascending order in
//   registers. A warp reads 512 contiguous bytes a load.
// - The rows' sums go to shared memory and are added in row order (the
//   threads' order, so warp order), then stored plainly into a (B, slabs,
//   2, C) workspace; stats_reduce_kernel (tile_sums.cuh) adds the slabs in
//   a fixed order.
// - C % 8 != 0, or x not 16-byte aligned: the same order with a value a
//   load.
// Bound: the bytes, 2 a value, at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_sums.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kPixelsPerBlock = 256;

__global__ void __launch_bounds__(kWarps * 32)
    gn1_stats_kernel(const float* __restrict__ x, float* __restrict__ ws,
                     int P, int C) {
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
    const float* xb = x + (int64_t)b * P * C + c;
    for (int p = p0 + warp; p < p1; p += kWarps) {
      const float v = xb[(int64_t)p * C];
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
    float* r = ws + ((int64_t)b * gridDim.x + blockIdx.x) * 2 * C + c;
    r[0] = s;
    r[C] = q;
  }
}

// ---- bf16, fixed order
constexpr int kThreads = 256;
constexpr int kChunks = 32;  // 8-channel chunks a block, at most
constexpr int kRows = 32;    // pixel rows a thread adds

using bf16 = __nv_bfloat16;

// A block's chunks; and pixels a slab (ops/stats.py gn1_slab).
inline int slab_chunks(int C) { return min((C + 7) / 8, kChunks); }
inline int slab_pixels(int C) { return kThreads / slab_chunks(C) * kRows; }

__device__ __forceinline__ float lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Block (slab blockIdx.x, chunks blockIdx.y * nk .., image blockIdx.z).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    gn1_slab_kernel(const bf16* __restrict__ x, float* __restrict__ ws,
                    int P, int C, int nk, int slabs) {
  __shared__ __align__(16) float red[2][kThreads * 8];
  const int t = threadIdx.x;
  const int R = kThreads / nk;
  const int k = t % nk, r = t / nk;
  const int b = blockIdx.z;
  const int c0 = 8 * (blockIdx.y * nk + k);
  const int p0 = blockIdx.x * R * kRows;
  const int p1 = min(p0 + R * kRows, P);
  float s[8], q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.f;
  if (r < R && c0 < C) {
    const bf16* xb = x + (int64_t)b * P * C + c0;
#pragma unroll 4
    for (int p = p0 + r; p < p1; p += R) {
      const bf16* px = xb + (int64_t)p * C;
      float v[8];
      if constexpr (VEC) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(px));
        v[0] = lo(u.x); v[1] = hi(u.x); v[2] = lo(u.y); v[3] = hi(u.y);
        v[4] = lo(u.z); v[5] = hi(u.z); v[6] = lo(u.w); v[7] = hi(u.w);
      } else {
        const unsigned short* h = reinterpret_cast<const unsigned short*>(px);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = c0 + e < C ? lo(__ldg(h + e)) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[e] += v[e];
        q[e] += v[e] * v[e];
      }
    }
  }
  // row r's sums of chunk k at red[.][r * 8 nk + 8 k + e] = red[.][8 t + e]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    reinterpret_cast<float4*>(red[0])[2 * t + h] =
        make_float4(s[4 * h], s[4 * h + 1], s[4 * h + 2], s[4 * h + 3]);
    reinterpret_cast<float4*>(red[1])[2 * t + h] =
        make_float4(q[4 * h], q[4 * h + 1], q[4 * h + 2], q[4 * h + 3]);
  }
  __syncthreads();
  const int W = 8 * nk;
  // channel u of the block's W, its rows in ascending order
  for (int u = t; u < 2 * W; u += kThreads) {
    const int which = u / W, cu = u % W;
    const int c = 8 * blockIdx.y * nk + cu;
    if (c >= C) continue;
    float v = 0.f;
    for (int i = 0; i < R; ++i) v += red[which][i * W + cu];
    ws[(((int64_t)b * slabs + blockIdx.x) * 2 + which) * C + c] = v;
  }
}

}  // namespace

// x (B, P, C) with P = H * W; ssum, ssq (B, C), written whole (no zeroing);
// ws a float (B, ceil(P / 256), 2, C) workspace, ws_slabs its slabs as the
// caller allocated it (another count launches nothing and returns
// cudaErrorInvalidValue). Returns the first launch error.
extern "C" int ucdir_gn1_stats(const float* x, float* ssum, float* ssq,
                               float* ws, int B, int P, int C, int ws_slabs,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int slabs = (P + kPixelsPerBlock - 1) / kPixelsPerBlock;
  if (ws_slabs != slabs) return (int)cudaErrorInvalidValue;
  gn1_stats_kernel<<<dim3(slabs, (C + 31) / 32, B), kWarps * 32, 0, st>>>(
      x, ws, P, C);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  ucdir::stats_reduce_kernel<<<dim3((C + 31) / 32, B), 1024, 0, st>>>(
      ws, ssum, ssq, slabs, C);
  return (int)cudaGetLastError();
}

// K4 on a bf16 x: ssum, ssq float (B, C), written whole (no zeroing), and
// ws a float (B, slabs, 2, C) workspace, slabs = ceil(P / slab) with slab =
// 256 / min(ceil(C / 8), 32) * 32 pixels, ws_slabs as for ucdir_gn1_stats.
// Returns the first launch error.
extern "C" int ucdir_gn1_stats_bf16(const bf16* x, float* ssum, float* ssq,
                                    float* ws, int B, int P, int C,
                                    int ws_slabs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = slab_chunks(C), slab = slab_pixels(C);
  const int slabs = (P + slab - 1) / slab;
  if (ws_slabs != slabs) return (int)cudaErrorInvalidValue;
  const dim3 grid(slabs, ((C + 7) / 8 + nk - 1) / nk, B);
  if (C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    gn1_slab_kernel<true><<<grid, kThreads, 0, st>>>(x, ws, P, C, nk, slabs);
  else
    gn1_slab_kernel<false><<<grid, kThreads, 0, st>>>(x, ws, P, C, nk, slabs);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  ucdir::stats_reduce_kernel<<<dim3((C + 31) / 32, B), 1024, 0, st>>>(
      ws, ssum, ssq, slabs, C);
  return (int)cudaGetLastError();
}
