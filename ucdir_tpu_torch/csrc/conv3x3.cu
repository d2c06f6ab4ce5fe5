// K2: 3x3 SAME convolution of x * a + t, stride 1 or 2, + bias, optional
// swish, optional per-(batch, channel) sum and sum of squares of the output.
// K7: the same product on swish(x * a + t), the pre-activated head.
//
// K2 replaces the TPU kernels B2 (ucdir_tpu/ops/conv_pallas.py
// _conv3x3_forward_padfree, the folded-GroupNorm conv), B4
// (_downconv_forward, the stride-2 Downsample) and B5 (upconv2x: B2 run on
// phase-packed (3, 3, Cin, 4 * Cout) weights; the caller depth-to-spaces).
// The TPU staged a zero ring into VMEM and split even and odd columns outside
// the kernel for stride 2; here the implicit GEMM reads the strided receptive
// field directly and masks the border, so neither the padded nor the
// deinterleaved tensor exists in device memory.
// K7 replaces B3 (conv_pallas.py conv3x3_preact_pallas, the GroupNorm ->
// swish -> conv head as one kernel): the activation is applied as A is
// staged, so neither the normalized nor the activated tensor is written; the
// border is masked after it and stays 0 = swish(0).
//
// Bound: at the main path's widths (18 * cin * cout FLOP per pixel, 100 or
// more per byte moved) the fp32 FMA rate: counted FLOP / 67 TFLOP/s. What the
// design (igemm_pc.cuh) does about it: warps that only multiply, fed by warps
// that only stage, two slices ahead and 16 bytes along the channels at a
// time; a column tile that follows cout (128, 64 or 8 wide), so that wide
// layers stage each input value once per 128 columns; 16-byte stores, and the
// statistics through warp shuffles. K7 at the head (64 -> 3) takes the 8-wide
// tile; it still evaluates one expf per staged element, nine per input value,
// so the staging bounds it.
#include "igemm_pc.cuh"

namespace {

ucdir::pc::ConvArgs conv_args(const float* x, const float* w,
                              const float* bias, const float* a,
                              const float* t, float* out, float* ssum,
                              float* ssq, int H, int W, int cin, int cout,
                              int stride, int act) {
  ucdir::pc::ConvArgs c = {};
  c.x = x;
  c.w = w;
  c.bias = bias;
  c.a = a;
  c.t = t;
  c.out = out;
  c.ssum = ssum;
  c.ssq = ssq;
  c.g.H = H;
  c.g.W = W;
  c.g.C = cin;
  c.g.Ho = (H - 1) / stride + 1;
  c.g.Wo = (W - 1) / stride + 1;
  c.g.ks = 3;
  c.g.stride = stride;
  c.g.cin = cin;
  c.g.K = 9 * cin;
  c.cout = cout;
  c.act = act;
  return c;
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
  return ucdir::pc::launch_conv<ucdir::pc::Affine>(
      conv_args(x, w, bias, a, t, out, ssum, ssq, H, W, cin, cout, stride,
                act),
      B, (cudaStream_t)stream);
}

// K7: out = conv3x3(swish(x * a + t)) + bias, stride 1, no activation after
// it and no statistics. Operands as above.
extern "C" int ucdir_conv3x3_preact(const float* x, const float* w,
                                    const float* bias, const float* a,
                                    const float* t, float* out, int B, int H,
                                    int W, int cin, int cout, void* stream) {
  return ucdir::pc::launch_conv<ucdir::pc::Preact>(
      conv_args(x, w, bias, a, t, out, nullptr, nullptr, H, W, cin, cout, 1,
                0),
      B, (cudaStream_t)stream);
}
