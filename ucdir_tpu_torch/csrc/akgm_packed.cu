// K9: the group-packed AKGM block tail,
//   A[p][j] = att[p][j] * attw[j]
//   out[p][i] = swish(sum_{tap, c} (h * a + t)[p + tap][c] * A[p][c / (C/G)]
//                                  * Wp[tap * C + c][i]
//                     + sum_j A[p][j] * bias[i * G + j]) + res[p][i],
// with Wp (9 * C, C) the grouped kernel repacked: row tap * C + j * (C/G) + cg,
// column i, value kernel[tap][cg][i * G + j]. The attention of the OUTPUT
// pixel scales the input channels by their group before a dense 9C -> C
// product. This pairs candidate j of every output channel with input group
// j; the reference network pairs all candidates of channel i with input group
// i / (C/G) (akgm_tail.cu). The two are different networks; this form is kept
// so that the packing study stays answerable on both packages.
//
// Replaces the TPU kernel B1p (ucdir_tpu/ops/akgm_pallas.py
// _akgm_block_forward_packed). The TPU kernel scaled an im2col scratch row by
// the expanded attention and got the folded shift from a ring of -t / a and
// a correction matrix; here the implicit GEMM (igemm.cuh) scales each value
// of A as it is staged, the shift rides the staged value h * a + t, and the
// border is masked after the affine, so it is the affine's exact 0.
// Bound: fp32 FMA issue (see igemm.cuh): 2 * 9 * C * C FLOP per pixel against
// 4 * (3 * C + 8) bytes, the same count as K1's per-group product (the TPU
// kernel saved 8x only against its own densified weights).
#include "igemm.cuh"

namespace {

constexpr int G = 8;  // candidates per channel

// Scales column c of A in block row m by that pixel's A[m][c / cg].
struct AttScale {
  const float* att;  // shared (BM, G): att * attw of the block's pixels
  int cg;            // channels per group
  __device__ __forceinline__ float apply(float v,
                                         const ucdir::AffineLoader::Col& s,
                                         int m) const {
    return v * att[m * G + s.c / cg];
  }
};

__global__ void __launch_bounds__(ucdir::NT)
    akgm_packed_kernel(const float* __restrict__ h,
                       const float* __restrict__ att,
                       const float* __restrict__ attw,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ res,
                       const float* __restrict__ a, const float* __restrict__ t,
                       float* __restrict__ out, ucdir::Geom g) {
  __shared__ __align__(16) ucdir::Smem sm;
  __shared__ float satt[ucdir::BM * G];
  float acc[ucdir::TM][ucdir::TN];
  const int C = g.C;
  const int P = g.Ho * g.Wo;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * ucdir::BM;
  const int n0 = blockIdx.y * ucdir::BN;
  const int tid = threadIdx.x;
  for (int i = tid; i < ucdir::BM * G; i += ucdir::NT) {
    const int p = m0 + i / G;
    const int j = i % G;
    satt[i] = p < P ? att[((int64_t)b * P + p) * G + j] *
                          (attw ? attw[b * G + j] : 1.f)
                    : 0.f;
  }
  // igemm_core's first barrier publishes satt
  AttScale rs;
  rs.att = satt;
  rs.cg = C / G;
  ucdir::igemm_core(acc, sm, ucdir::affine_loader(h, a, t, g, b, 0), w, C, C,
                    g, m0, n0, rs);

  const int tm = tid / (ucdir::BN / ucdir::TN);
  const int tn = tid % (ucdir::BN / ucdir::TN);
#pragma unroll
  for (int j = 0; j < ucdir::TN; ++j) {
    const int n = n0 + tn * ucdir::TN + j;
    if (n >= C) continue;
    float bj[G];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) bj[jj] = bias[n * G + jj];
#pragma unroll
    for (int i = 0; i < ucdir::TM; ++i) {
      const int m = tm * ucdir::TM + i;
      if (m0 + m >= P) continue;
      float v = acc[i][j];
#pragma unroll
      for (int jj = 0; jj < G; ++jj) v = fmaf(satt[m * G + jj], bj[jj], v);
      const int64_t o = ((int64_t)b * P + m0 + m) * C + n;
      out[o] = ucdir::swishf(v) + res[o];
    }
  }
}

}  // namespace

// h, res, out (B, H, W, C) NHWC; att (B, H, W, 8); attw (B, 8) or null;
// w (9 * C, C) packed as above; bias (8 * C); a, t (B, C) or null. C must be
// a multiple of 8 (the wrapper takes multiples of 64, as for K1). Returns
// the launch's cudaError_t.
extern "C" int ucdir_akgm_packed(const float* h, const float* att,
                                 const float* attw, const float* w,
                                 const float* bias, const float* res,
                                 const float* a, const float* t, float* out,
                                 int B, int H, int W, int C, void* stream) {
  ucdir::Geom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.Ho = H;
  g.Wo = W;
  g.ks = 3;
  g.stride = 1;
  g.cin = C;
  g.K = 9 * C;
  dim3 grid((H * W + ucdir::BM - 1) / ucdir::BM,
            (C + ucdir::BN - 1) / ucdir::BN, B);
  akgm_packed_kernel<<<grid, ucdir::NT, 0, (cudaStream_t)stream>>>(
      h, att, attw, w, bias, res, a, t, out, g);
  return (int)cudaGetLastError();
}
