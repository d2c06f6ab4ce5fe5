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
// The _bf16 entry points (the TPU kernels' bf16 instantiation) run on the
// tensor-core core of igemm_tc.cuh: a bf16 wgmma product with fp32
// accumulation, the staging rounded where the TPU kernels' bf16 arithmetic
// rounds, the statistics per pixel tile into a workspace the caller
// allocates, added in a fixed order. Bound, in counted FLOP at 989 TFLOP/s
// (bf16 on the tensor cores) or counted bytes at 2 a value over 3.35 TB/s:
// the product at the main path's widths (conv1 1024 -> 512 at 196 x 284:
// 0.531 ms), the bytes at downs_0 and the 64 -> 3 heads. What the design
// does about it: the product at the tensor cores' rate from a 4-stage
// mbarrier ring, the weights by TMA, and producer warps that stage each
// 64-channel chunk of a tile's halo once (fold and swish applied once) and
// copy each tap's rows from it; the product side and that staging, which
// share shared memory's bandwidth, bound it now (PERF.md §7).
#include "igemm_tc.cuh"

namespace {

using ucdir::bf16;

template <class E>
ucdir::pc::ConvArgsT<E> conv_args(const E* x, const E* w, const E* bias,
                                  const E* a, const E* t, E* out, float* ssum,
                                  float* ssq, int H, int W, int cin, int cout,
                                  int stride, int act) {
  ucdir::pc::ConvArgsT<E> c = {};
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

ucdir::tc::TcArgs tc_args(const bf16* x, const bf16* w, const bf16* bias,
                          const bf16* a, const bf16* t, bf16* out, float* ws,
                          int H, int W, int cin, int cout, int stride,
                          int act) {
  const ucdir::pc::ConvArgsT<bf16> c = conv_args(
      x, w, bias, a, t, out, nullptr, nullptr, H, W, cin, cout, stride, act);
  ucdir::tc::TcArgs p = {};
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.a = a;
  p.t = t;
  p.out = out;
  p.ws = ws;
  p.g = c.g;
  p.cout = cout;
  p.act = act;
  return p;
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

// K2 and K7 in bf16 on the tensor cores: x, w, bias, a, t and out bf16;
// ssum, ssq (B, cout) float, written whole from ws, a float (B, 2, cout,
// ceil(Ho * Wo / 128)) workspace, or all three null.
extern "C" int ucdir_conv3x3_bf16(const bf16* x, const bf16* w,
                                  const bf16* bias, const bf16* a,
                                  const bf16* t, bf16* out, float* ssum,
                                  float* ssq, float* ws, int B, int H, int W,
                                  int cin, int cout, int stride, int act,
                                  void* stream) {
  return ucdir::tc::launch_conv<ucdir::pc::Affine>(
      tc_args(x, w, bias, a, t, out, ws, H, W, cin, cout, stride, act), ssum,
      ssq, B, (cudaStream_t)stream, ucdir::tc::TC_CONV3X3);
}

extern "C" int ucdir_conv3x3_preact_bf16(const bf16* x, const bf16* w,
                                         const bf16* bias, const bf16* a,
                                         const bf16* t, bf16* out, int B,
                                         int H, int W, int cin, int cout,
                                         void* stream) {
  return ucdir::tc::launch_conv<ucdir::pc::Preact>(
      tc_args(x, w, bias, a, t, out, nullptr, H, W, cin, cout, 1, 0),
      nullptr, nullptr, B, (cudaStream_t)stream, ucdir::tc::TC_PREACT);
}

// Launches of the tensor-core core since the library was loaded, of entry
// point `entry`: 0 ucdir_conv3x3_bf16 (K2), 1 ucdir_conv3x3_preact_bf16
// (K7), 2 ucdir_conv1x1_bf16 (K3); -1 for any other.
extern "C" long long ucdir_tc_launches(int entry) {
  if (entry < 0 || entry >= ucdir::tc::TC_ENTRIES) return -1;
  return ucdir::tc::launch_count(entry);
}
