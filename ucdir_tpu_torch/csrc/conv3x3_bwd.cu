// K6: every gradient of the stride-1 3x3 convolution K2 computes,
//   out = act(conv3x3(x * a + t) + bias),
// from x, the output cotangent go and the weights:
//   dz    = go * swish'(conv3x3(x * a + t) + bias)     (act: swish; else go)
//   dxh   = conv3x3(dz, flip(W)^T)      the gradient of x * a + t, 0 border
//   dW    = im2col(x * a + t)^T @ dz    the border of x * a + t is 0, not t
//   dbias = sum over batch and pixels of dz
// The caller turns dxh into dx, dnorm_scale and dnorm_shift with plain tensor
// ops, as the TPU code does outside its kernel.
//
// Replaces the TPU kernel B9 (ucdir_tpu/ops/conv_pallas.py _conv3x3_backward,
// kernel _conv_bwd_kernel). The TPU kernel walked row blocks of one image in
// order, recomputed z in VMEM with a 2-row halo and carried dW and dbias
// across the ordered grid. Blocks here run in any order, so one entry point
// makes up to three launches of the shared implicit-GEMM tile (igemm.cuh):
// with swish, z is recomputed once and dz written to a scratch tensor of the
// output's size (the TPU kernel recomputed it per row block instead); the
// input gradient is K2's product on dz with flipped, transposed weights; the
// weight gradient reduces over pixels, each block adding its tile of one
// image's pixel chunk into the zeroed dW and dbias with float32 atomics.
// Bound: the fp32 FMA rate, at two or three times K2's operations.
#include "igemm.cuh"

namespace {

using ucdir::BM;
using ucdir::BN;
using ucdir::NT;
using ucdir::TM;
using ucdir::TN;

// dz = go * swish'(conv3x3(x * a + t) + bias)
__global__ void __launch_bounds__(NT)
    conv3x3_bwd_dz_kernel(const float* __restrict__ x,
                          const float* __restrict__ go,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ a,
                          const float* __restrict__ t, float* __restrict__ dz,
                          ucdir::Geom g, int cout) {
  __shared__ __align__(16) ucdir::Smem sm;
  float acc[TM][TN];
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  ucdir::igemm(acc, sm, x, a, t, w, cout, cout, g, b, 0, m0, n0);
  const int tm = threadIdx.x / (BN / TN);
  const int tn = threadIdx.x % (BN / TN);
  const int P = g.Ho * g.Wo;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + tm * TM + i;
    if (p >= P) continue;
    const int64_t row = ((int64_t)b * P + p) * cout;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n < cout)
        dz[row + n] = go[row + n] * ucdir::dswishf(acc[i][j] + bias[n]);
    }
  }
}

// dxh = conv3x3(dz, wf), wf the flipped, transposed weights (9 * cout, cin)
__global__ void __launch_bounds__(NT)
    conv3x3_bwd_dx_kernel(const float* __restrict__ dz,
                          const float* __restrict__ wf,
                          float* __restrict__ dxh, ucdir::Geom g, int cin) {
  __shared__ __align__(16) ucdir::Smem sm;
  float acc[TM][TN];
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  ucdir::igemm(acc, sm, dz, nullptr, nullptr, wf, cin, cin, g, b, 0, m0, n0);
  ucdir::conv_epilogue(acc, sm, nullptr, dxh, nullptr, nullptr, 0,
                       g.Ho * g.Wo, cin, b, m0, n0);
}

struct PlainD {  // D[p][n] of one image's (P, cout) cotangent
  const float* db;
  int cout;
  __device__ __forceinline__ float at(int p, int n) const {
    return db[(int64_t)p * cout + n];
  }
};

// dW += im2col(x * a + t)^T @ dz and dbias += sum dz over one pixel chunk
__global__ void __launch_bounds__(NT)
    conv3x3_bwd_dw_kernel(const float* __restrict__ x,
                          const float* __restrict__ dz,
                          const float* __restrict__ a,
                          const float* __restrict__ t, float* __restrict__ dw,
                          float* __restrict__ dbias, ucdir::Geom g, int cout,
                          int splits, int chunk) {
  __shared__ __align__(16) ucdir::Smem sm;
  float acc[TM][TN];
  float bsum;
  const int b = blockIdx.x / splits;
  const int P = g.H * g.W;
  const int p0 = (blockIdx.x % splits) * chunk;
  const int p1 = min(p0 + chunk, P);
  const int n0 = blockIdx.y * BN;
  const int m0 = blockIdx.z * BM;
  PlainD dl;
  dl.db = dz + (int64_t)b * P * cout;
  dl.cout = cout;
  ucdir::wgrad_core(acc, bsum, sm, ucdir::affine_loader(x, a, t, g, b, 0), dl,
                    cout, g, p0, p1, m0, n0);
  ucdir::wgrad_store(acc, dw, cout, g.K, cout, m0, n0, 0);
  if (blockIdx.z == 0 && threadIdx.x < BN && n0 + threadIdx.x < cout)
    atomicAdd(&dbias[n0 + threadIdx.x], bsum);
}

}  // namespace

// x (B, H, W, cin) and go (B, H, W, cout) NHWC; w (9 * cin, cout) with row
// tap * cin + ci; wf (9 * cout, cin), row tap * cout + o holding w's tap
// 8 - tap transposed; bias (cout); a, t (B, cin) or null; dz a (B, H, W, cout)
// scratch, used only with act; dxh (B, H, W, cin); dw (9 * cin, cout) and
// dbias (cout) zeroed. Returns the first launch error as a cudaError_t.
extern "C" int ucdir_conv3x3_bwd(const float* x, const float* go,
                                 const float* w, const float* wf,
                                 const float* bias, const float* a,
                                 const float* t, float* dz, float* dxh,
                                 float* dw, float* dbias, int B, int H, int W,
                                 int cin, int cout, int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = H * W;
  ucdir::Geom g;
  g.H = H;
  g.W = W;
  g.C = cin;
  g.Ho = H;
  g.Wo = W;
  g.ks = 3;
  g.stride = 1;
  g.cin = cin;
  g.K = 9 * cin;
  const int ptiles = (P + BM - 1) / BM;
  const int ntiles = (cout + BN - 1) / BN;
  const float* d = go;
  if (act) {
    conv3x3_bwd_dz_kernel<<<dim3(ptiles, ntiles, B), NT, 0, st>>>(
        x, go, w, bias, a, t, dz, g, cout);
    d = dz;
  }
  const int mtiles = (g.K + BM - 1) / BM;
  const int splits = ucdir::wgrad_splits(mtiles * ntiles, B, P);
  int chunk = (P + splits - 1) / splits;
  chunk = (chunk + ucdir::BK - 1) / ucdir::BK * ucdir::BK;
  conv3x3_bwd_dw_kernel<<<dim3(B * splits, ntiles, mtiles), NT, 0, st>>>(
      x, d, a, t, dw, dbias, g, cout, splits, chunk);
  ucdir::Geom gt = g;  // the transposed convolution reads dz
  gt.C = cout;
  gt.cin = cout;
  gt.K = 9 * cout;
  conv3x3_bwd_dx_kernel<<<dim3(ptiles, (cin + BN - 1) / BN, B), NT, 0, st>>>(
      d, wf, dxh, gt, cin);
  return (int)cudaGetLastError();
}
