// The fixed-order second pass of the per-(image, channel) sums and sums of
// squares that K1 (akgm_tail.cu, both cores) and K4 in bf16 (gn1_stats.cu)
// store per tile of pixels into a (B, tiles, 2, C) float workspace: no
// atomics, so the sums have the same bits from call to call. An instance
// per source that includes this header.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ucdir {

// ssum, ssq (B, C) from the (B, ntp, 2, C) per-tile sums: warp w of block
// (channels 32 * blockIdx.x .., image blockIdx.y) adds the tiles
// [w * run, (w + 1) * run) in ascending order, run = ceil(ntp / 32), then
// the 32 runs are added in ascending order.
static __global__ void __launch_bounds__(1024)
    stats_reduce_kernel(const float* __restrict__ ws, float* __restrict__ ssum,
                        float* __restrict__ ssq, int ntp, int C) {
  __shared__ float part[32][2][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int ch = blockIdx.x * 32 + lane;
  const int run = (ntp + 31) / 32;
  const int t1 = min(ntp, (w + 1) * run);
  float s = 0.f, q = 0.f;
  if (ch < C) {
    for (int tile = w * run; tile < t1; ++tile) {
      const float* r = ws + ((int64_t)b * ntp + tile) * 2 * C + ch;
      s += __ldg(r);
      q += __ldg(r + C);
    }
  }
  part[w][0][lane] = s;
  part[w][1][lane] = q;
  __syncthreads();
  if (w != 0 || ch >= C) return;
  float S = 0.f, Q = 0.f;
  for (int k = 0; k < 32; ++k) {
    S += part[k][0][lane];
    Q += part[k][1][lane];
  }
  ssum[(int64_t)b * C + ch] = S;
  ssq[(int64_t)b * C + ch] = Q;
}

}  // namespace ucdir
