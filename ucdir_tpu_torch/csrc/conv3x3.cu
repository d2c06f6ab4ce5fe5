// K2: 3x3 SAME convolution of x * a + t, stride 1 or 2, + bias, optional
// swish, optional per-(batch, channel) sum and sum of squares of the output.
// K7: the same product on swish(x * a + t), the pre-activated head.
//
// K2 replaces the TPU kernels B2 (ucdir_tpu/ops/conv_pallas.py
// _conv3x3_forward_padfree, the folded-GroupNorm conv), B4
// (_downconv_forward, the stride-2 Downsample) and B5 (upconv2x: B2 run on
// phase-packed (3, 3, Cin, 4 * Cout) weights; the caller depth-to-spaces).
// The TPU staged a zero ring into VMEM and split even and odd columns outside
// the kernel for stride 2; here the implicit GEMM (igemm.cuh) reads the
// strided receptive field directly and masks the border, so neither the
// padded nor the deinterleaved tensor exists in device memory.
// K7 replaces B3 (conv_pallas.py conv3x3_preact_pallas, the GroupNorm ->
// swish -> conv head as one kernel): the activation is applied as A is
// staged, so neither the normalized nor the activated tensor is written; the
// border is masked after it and stays 0 = swish(0).
// Bound: fp32 FMA issue (see igemm.cuh). The statistics cost two shared-memory
// atomics per thread and column and two global atomics per block and column.
// K7 at the head (64 -> 3) fills 3 of the tile's 64 columns and evaluates one
// expf per staged element, nine per input value: the staging bounds it.
#include "igemm.cuh"

namespace {

template <class Loader>
__global__ void __launch_bounds__(ucdir::NT)
    conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ a,
                   const float* __restrict__ t, float* __restrict__ out,
                   float* __restrict__ ssum, float* __restrict__ ssq,
                   ucdir::Geom g, int cout, int act) {
  __shared__ __align__(16) ucdir::Smem sm;
  float acc[ucdir::TM][ucdir::TN];
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * ucdir::BM;
  const int n0 = blockIdx.y * ucdir::BN;
  ucdir::zero_red(sm);
  ucdir::igemm_core(acc, sm, ucdir::affine_loader<Loader>(x, a, t, g, b, 0), w,
                    cout, cout, g, m0, n0);
  ucdir::conv_epilogue(acc, sm, bias, out, ssum, ssq, act, g.Ho * g.Wo, cout,
                       b, m0, n0);
}

ucdir::Geom conv_geom(int H, int W, int cin, int stride) {
  ucdir::Geom g;
  g.H = H;
  g.W = W;
  g.C = cin;
  g.Ho = (H - 1) / stride + 1;
  g.Wo = (W - 1) / stride + 1;
  g.ks = 3;
  g.stride = stride;
  g.cin = cin;
  g.K = 9 * cin;
  return g;
}

dim3 conv_grid(const ucdir::Geom& g, int cout, int B) {
  return dim3((g.Ho * g.Wo + ucdir::BM - 1) / ucdir::BM,
              (cout + ucdir::BN - 1) / ucdir::BN, B);
}

}  // namespace

// x (B, H, W, cin) NHWC; w (9 * cin, cout) with row tap * cin + ci; bias
// (cout); a, t (B, cin) or null; out (B, Ho, Wo, cout); ssum, ssq zeroed
// (B, cout) or null. Returns the launch's cudaError_t.
extern "C" int ucdir_conv3x3(const float* x, const float* w, const float* bias,
                             const float* a, const float* t, float* out,
                             float* ssum, float* ssq, int B, int H, int W,
                             int cin, int cout, int stride, int act,
                             void* stream) {
  const ucdir::Geom g = conv_geom(H, W, cin, stride);
  conv3x3_kernel<ucdir::AffineLoader>
      <<<conv_grid(g, cout, B), ucdir::NT, 0, (cudaStream_t)stream>>>(
          x, w, bias, a, t, out, ssum, ssq, g, cout, act);
  return (int)cudaGetLastError();
}

// K7: out = conv3x3(swish(x * a + t)) + bias, stride 1, no activation after
// it and no statistics. Operands as above.
extern "C" int ucdir_conv3x3_preact(const float* x, const float* w,
                                    const float* bias, const float* a,
                                    const float* t, float* out, int B, int H,
                                    int W, int cin, int cout, void* stream) {
  const ucdir::Geom g = conv_geom(H, W, cin, 1);
  conv3x3_kernel<ucdir::PreactLoader>
      <<<conv_grid(g, cout, B), ucdir::NT, 0, (cudaStream_t)stream>>>(
          x, w, bias, a, t, out, nullptr, nullptr, g, cout, 0);
  return (int)cudaGetLastError();
}
