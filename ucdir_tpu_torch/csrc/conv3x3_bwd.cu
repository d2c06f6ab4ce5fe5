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
// makes up to four launches on the producer/consumer core of the forward
// convolutions (igemm_pc.cuh):
//   1. with swish, K2's product with an epilogue that writes dz = go *
//      swish'(z + bias) instead of z (go read 16 bytes at a time), on the tile
//      that cout selects;
//   2. the weight gradient, wgrad_pc_kernel: the pixels of the batch cut into
//      `splits` chunks, each block's partial tile and partial bias stored
//      plainly into the workspace;
//   3. wgrad_reduce_kernel: the partials added in ascending chunk order, so
//      dW and dbias have the same bits from run to run;
//   4. the input gradient, K2's product on dz with the flipped, transposed
//      weights, on the tile that cin selects.
// Bound: the fp32 FMA rate, at two or three times K2's operations.
//
// ucdir_conv3x3_bwd_bf16 (the TPU kernel's bf16 instantiation, training
// under --compute_dtype bf16) makes the same launches on the tensor cores
// of the H100 (igemm_tc.cuh: wgmma bf16, fp32 accumulators): the dz
// recompute, gconv_tc_kernel with K2's staging and an epilogue that reads go
// 16 bytes a lane and writes dz = go * swish'(z + bias) in float32, rounded
// to bf16 once (the weight and the input gradient both read that dz); the
// weight gradient, wgrad_tc_kernel: the NHWC rows of x * a + t (staged as
// K2's bf16 form stages them) and of dz (by TMA) read MN-major, the bias a
// column of ones in the im2col operand, partial tiles per pixel chunk in
// the workspace added in a fixed order and rounded once; the input
// gradient, gconv_tc_kernel on dz with wf, dxh rounded once. Bound: counted
// FLOP at 989 TFLOP/s bf16 (the 64 -> 3 head and downs_0 by their bytes).
// A call counts in ucdir_tc_launches once all its launches have gone out.
#include "igemm_tc.cuh"

namespace {

using ucdir::bf16;

// x (B, H, W, cin) and go (B, H, W, cout) NHWC; w (9 * cin, cout) with row
// tap * cin + ci; wf (9 * cout, cin), row tap * cout + o holding w's tap
// 8 - tap transposed; bias (cout); a, t (B, cin) or null; dz a (B, H, W, cout)
// scratch, used only with act; dxh (B, H, W, cin); dw (9 * cin, cout) and
// dbias (cout), written whole; ws a (splits, 9 * cin + 1, cout) float
// workspace. Returns the first launch error as a cudaError_t.
int conv3x3_bwd(const float* x, const float* go, const float* w,
                const float* wf, const float* bias, const float* a,
                const float* t, float* dz, float* dxh, float* dw,
                float* dbias, float* ws, int B, int H, int W, int cin,
                int cout, int act, int splits, void* stream) {
  namespace pc = ucdir::pc;
  cudaStream_t st = (cudaStream_t)stream;
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
  const float* d = go;
  if (act) {
    pc::ConvArgsT<float> c = {};
    c.x = x;
    c.w = w;
    c.bias = bias;
    c.a = a;
    c.t = t;
    c.out = dz;
    c.go = go;
    c.g = g;
    c.cout = cout;
    const int err = pc::launch_conv<pc::Affine, true>(c, B, st);
    if (err) return err;
    d = dz;
  }
  pc::WgradArgsT<float> wa = {};
  wa.x = x;
  wa.a = a;
  wa.t = t;
  wa.d = d;
  wa.ws = ws;
  wa.g = g;
  wa.N = cout;
  wa.gw = cout;
  wa.npix = B * H * W;
  wa.vec_d = cout % 4 == 0 && pc::aligned(d, 16);
  int err = pc::launch_wgrad<pc::PlainD>(wa, splits, dw, dbias, st);
  if (err) return err;
  pc::ConvArgsT<float> c = {};  // the transposed convolution reads d
  c.x = d;
  c.w = wf;
  c.out = dxh;
  c.g = g;
  c.g.C = cout;
  c.g.cin = cout;
  c.g.K = 9 * cout;
  c.cout = cin;
  return pc::launch_conv<pc::Dgrad>(c, B, st);
}

// K6 in bf16 on the tensor cores: the same operands, every one bf16 but the
// float workspace.
int conv3x3_bwd_tc(const bf16* x, const bf16* go, const bf16* w,
                   const bf16* wf, const bf16* bias, const bf16* a,
                   const bf16* t, bf16* dz, bf16* dxh, bf16* dw, bf16* dbias,
                   float* ws, int B, int H, int W, int cin, int cout, int act,
                   int splits, cudaStream_t st) {
  namespace tc = ucdir::tc;
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
  const bf16* d = go;
  if (act) {
    tc::TcArgs p = {};
    p.x = x;
    p.w = w;
    p.bias = bias;
    p.a = a;
    p.t = t;
    p.out = dz;
    p.go = go;
    p.g = g;
    p.cout = p.gw = p.wld = cout;
    p.wrows = g.K;
    const int err = tc::launch_grouped<ucdir::pc::Affine, tc::OutEpi<true>>(
        p, tc::NoArgs{}, B, false, st);
    if (err) return err;
    d = dz;
  }
  tc::WArgs wa = {};
  wa.x = x;
  wa.a = a;
  wa.t = t;
  wa.d = d;
  wa.ws = ws;
  wa.g = g;
  wa.N = wa.gw = cout;
  wa.npix = B * H * W;
  wa.krows = g.K + 1;  // the bias: a column of ones in x's im2col
  wa.kd = g.K;
  int err = tc::launch_wgrad_tc<false>(wa, splits, dw, dbias, st);
  if (err) return err;
  tc::TcArgs p = {};  // the transposed convolution reads d
  p.x = d;
  p.w = wf;
  p.out = dxh;
  p.g = g;
  p.g.C = p.g.cin = cout;
  p.g.K = 9 * cout;
  p.cout = p.gw = p.wld = cin;
  p.wrows = 9 * cout;
  err = tc::launch_grouped<ucdir::pc::Dgrad, tc::OutEpi<false>>(
      p, tc::NoArgs{}, B, false, st);
  if (err) return err;
  ++tc::launch_count(tc::TC_CONV3X3_BWD);
  return 0;
}

}  // namespace

extern "C" int ucdir_conv3x3_bwd(const float* x, const float* go,
                                 const float* w, const float* wf,
                                 const float* bias, const float* a,
                                 const float* t, float* dz, float* dxh,
                                 float* dw, float* dbias, float* ws, int B,
                                 int H, int W, int cin, int cout, int act,
                                 int splits, void* stream) {
  return conv3x3_bwd(x, go, w, wf, bias, a, t, dz, dxh, dw, dbias, ws, B, H,
                     W, cin, cout, act, splits, stream);
}

extern "C" int ucdir_conv3x3_bwd_bf16(const bf16* x, const bf16* go,
                                      const bf16* w, const bf16* wf,
                                      const bf16* bias, const bf16* a,
                                      const bf16* t, bf16* dz, bf16* dxh,
                                      bf16* dw, bf16* dbias, float* ws, int B,
                                      int H, int W, int cin, int cout,
                                      int act, int splits, void* stream) {
  return conv3x3_bwd_tc(x, go, w, wf, bias, a, t, dz, dxh, dw, dbias, ws, B,
                        H, W, cin, cout, act, splits, (cudaStream_t)stream);
}
