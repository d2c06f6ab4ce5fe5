// Implicit-GEMM core of the AKGM forward kernels K1, K8 and K9 (fp32, CUDA
// cores). The convolutions K2, K3 and K7 and the backward kernels K5 and K6
// run on igemm_pc.cuh.
//
// A convolution is the product A (P x K) * Wt (K x N): row p of A is output
// pixel p's receptive field, column k = tap * cin + ci of it is input channel
// ci at tap (ty, tx) = (tap / 3, tap % 3), read at input pixel
// (oy * stride - 1 + ty, ox * stride - 1 + tx) for a 3x3 window (the 1x1 window
// reads (oy, ox)). An optional per-(batch, channel) affine x * a + t (a folded
// GroupNorm(1)) is applied as A is staged; taps outside the image read 0 AFTER
// the affine, which is the SAME padding of the normalized tensor.
//
// One block computes a BM x BN output tile: it stages BK-deep slices of A and
// Wt through shared memory and each thread keeps a TM x TN register tile.
// What bounds it: at the main path's widths the convolutions do about 100
// FLOP or more per byte they must move, far above the card's fp32 balance of
// about 20 (67 TFLOP/s over 3.35 TB/s), so fp32 FMA issue bounds them; the
// register tile gives 8 + 8 shared-memory loads per 64 FMAs. Tensor cores
// (wgmma, bf16) and asynchronous staging are later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ucdir {

constexpr int BM = 128;                      // output pixels per block
constexpr int BN = 64;                       // output columns per block
constexpr int BK = 16;                       // reduction depth per stage
constexpr int TM = 8;                        // pixels per thread
constexpr int TN = 8;                        // columns per thread
constexpr int NT = (BM / TM) * (BN / TN);    // 128 threads per block
constexpr int APAD = 4;                      // keeps As rows 16-byte aligned
constexpr int OUTSIDE = -(1 << 28);          // origin for rows past the end

struct Geom {
  int H, W, C;     // input height, width and channel stride
  int Ho, Wo;      // output height and width
  int ks, stride;  // 3 (padding 1) or 1
  int cin;         // input channels in this product (a group's width)
  int K;           // ks * ks * cin
};

struct Smem {
  float As[BK][BM + APAD];
  float Bs[BK][BN];
  float red[2 * BN];  // per-column sum and sum of squares of the block
  int iy0[BM];
  int ix0[BM];
};

__device__ __forceinline__ float swishf(float v) {
  return v * (1.f / (1.f + expf(-v)));
}

// d swish(v) / dv = sig * (1 + v * (1 - sig)).
__device__ __forceinline__ float dswishf(float v) {
  const float sig = 1.f / (1.f + expf(-v));
  return sig * (1.f + v * (1.f - sig));
}

// Zeroes the statistics scratch; igemm's first barrier publishes it.
__device__ __forceinline__ void zero_red(Smem& sm) {
  for (int i = threadIdx.x; i < 2 * BN; i += NT) sm.red[i] = 0.f;
}

// A-operand loader of one image: channel cin0 + ci of x * a + t (a, t null:
// x itself). `col` fixes a k column's channel, `at` reads one input pixel.
struct AffineLoader {
  const float* xb;  // image b's (H, W, C) input
  const float* ab;  // image b's (C) scale or null
  const float* tb;  // image b's (C) shift or null
  int W, C, cin0;
  struct Col {
    int c;
    float sa, st;
  };
  __device__ __forceinline__ Col col(int ci) const {
    Col s;
    s.c = cin0 + ci;
    s.sa = ab ? ab[s.c] : 1.f;
    s.st = tb ? tb[s.c] : 0.f;
    return s;
  }
  __device__ __forceinline__ float at(const Col& s, int iy, int ix) const {
    return xb[((int64_t)iy * W + ix) * C + s.c] * s.sa + s.st;
  }
};

// Scales A per (block row, k column) as it is staged; the default scales
// nothing.
struct NoRowScale {
  template <class Col>
  __device__ __forceinline__ float apply(float v, const Col&, int) const {
    return v;
  }
};

template <class Loader = AffineLoader>
__device__ __forceinline__ Loader affine_loader(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ t, const Geom& g, int b, int cin0) {
  Loader al;
  al.xb = x + (int64_t)b * g.H * g.W * g.C;
  al.ab = a ? a + (int64_t)b * g.C : nullptr;
  al.tb = t ? t + (int64_t)b * g.C : nullptr;
  al.W = g.W;
  al.C = g.C;
  al.cin0 = cin0;
  return al;
}

__device__ __forceinline__ void zero_acc(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
}

// One staged slice: acc[i][j] += As[kk][tm * TM + i] * Bs[kk][tn * TN + j]
// over the BK rows of the slice.
__device__ __forceinline__ void mma_stage(float (&acc)[TM][TN],
                                          const Smem& sm, int tm, int tn) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float ar[TM], br[TN];
    const float4 a0 = *reinterpret_cast<const float4*>(&sm.As[kk][tm * TM]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&sm.As[kk][tm * TM + 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&sm.Bs[kk][tn * TN]);
    const float4 b1 =
        *reinterpret_cast<const float4*>(&sm.Bs[kk][tn * TN + 4]);
    ar[0] = a0.x; ar[1] = a0.y; ar[2] = a0.z; ar[3] = a0.w;
    ar[4] = a1.x; ar[5] = a1.y; ar[6] = a1.z; ar[7] = a1.w;
    br[0] = b0.x; br[1] = b0.y; br[2] = b0.z; br[3] = b0.w;
    br[4] = b1.x; br[5] = b1.y; br[6] = b1.z; br[7] = b1.w;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

// acc[i][j] = sum_k A[m0 + tm * TM + i][k] * Wt[k][n0 + tn * TN + j], where
// tm = threadIdx.x / (BN / TN) and tn = threadIdx.x % (BN / TN).
// Column k = tap * g.cin + ci of A is al.at(al.col(ci), iy, ix) at the tap's
// input pixel, 0 outside the image, then rs.apply(value, column, block row).
// w is (K, ldw) row-major and ncols its live width.
template <class ALoader, class RowScale = NoRowScale>
__device__ __forceinline__ void igemm_core(float (&acc)[TM][TN], Smem& sm,
                                           const ALoader& al,
                                           const float* __restrict__ w,
                                           int ldw, int ncols, const Geom& g,
                                           int m0, int n0,
                                           const RowScale& rs = RowScale()) {
  const int tid = threadIdx.x;
  const int P = g.Ho * g.Wo;
  const int off = g.ks == 3 ? 1 : 0;
  for (int m = tid; m < BM; m += NT) {
    const int p = m0 + m;
    if (p < P) {
      const int oy = p / g.Wo;
      const int ox = p - oy * g.Wo;
      sm.iy0[m] = oy * g.stride - off;
      sm.ix0[m] = ox * g.stride - off;
    } else {
      sm.iy0[m] = OUTSIDE;
      sm.ix0[m] = OUTSIDE;
    }
  }
  zero_acc(acc);

  const int a_k = tid % BK;           // A staging: this thread's k column
  const int a_m = tid / BK;           // ... and first pixel row
  const int b_n = tid % BN;           // Wt staging: this thread's column
  const int b_k = tid / BN;           // ... and first k row
  const int tm = tid / (BN / TN);
  const int tn = tid % (BN / TN);
  __syncthreads();

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    const int k = k0 + a_k;
    const bool kv = k < g.K;
    const int tap = kv ? k / g.cin : 0;
    const int ci = kv ? k - tap * g.cin : 0;
    const int ty = tap / 3;
    const int tx = tap - ty * 3;
    const typename ALoader::Col cs = al.col(ci);
    for (int m = a_m; m < BM; m += NT / BK) {
      const int iy = sm.iy0[m] + ty;
      const int ix = sm.ix0[m] + tx;
      float v = 0.f;
      if (kv && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
        v = rs.apply(al.at(cs, iy, ix), cs, m);
      sm.As[a_k][m] = v;
    }
    for (int kk = b_k; kk < BK; kk += NT / BN) {
      const int kr = k0 + kk;
      const int n = n0 + b_n;
      sm.Bs[kk][b_n] =
          (kr < g.K && n < ncols) ? w[(int64_t)kr * ldw + n] : 0.f;
    }
    __syncthreads();
    mma_stage(acc, sm, tm, tn);
    __syncthreads();
  }
}

// igemm_core on x * a + t: x is the (B, H, W, g.C) input and A reads
// channels [cin0, cin0 + g.cin) of image b; a and t are (B, g.C) or null.
__device__ __forceinline__ void igemm(float (&acc)[TM][TN], Smem& sm,
                                      const float* __restrict__ x,
                                      const float* __restrict__ a,
                                      const float* __restrict__ t,
                                      const float* __restrict__ w, int ldw,
                                      int ncols, const Geom& g, int b,
                                      int cin0, int m0, int n0) {
  igemm_core(acc, sm, affine_loader(x, a, t, g, b, cin0), w, ldw, ncols, g,
             m0, n0);
}

}  // namespace ucdir
