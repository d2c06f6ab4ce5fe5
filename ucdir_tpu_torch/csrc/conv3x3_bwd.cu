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
// ucdir_conv3x3_bwd_bf16 is the same four launches on bf16 operands and
// outputs (the TPU kernel's bf16 instantiation, training under
// --compute_dtype bf16): x * a + t staged in bf16 arithmetic as K2's bf16
// form stages it, dz = go * swish'(z) computed in float32 and rounded to
// bf16 once (the weight and the input gradient both read that dz), dxh
// rounded once, dW and dbias added in float32 in the same workspace and
// rounded once after the whole reduction; the product fp32 FMA.
#include "igemm_pc.cuh"

namespace {

// x (B, H, W, cin) and go (B, H, W, cout) NHWC; w (9 * cin, cout) with row
// tap * cin + ci; wf (9 * cout, cin), row tap * cout + o holding w's tap
// 8 - tap transposed; bias (cout); a, t (B, cin) or null; dz a (B, H, W, cout)
// scratch, used only with act; dxh (B, H, W, cin); dw (9 * cin, cout) and
// dbias (cout), written whole; ws a (splits, 9 * cin + 1, cout) float
// workspace. Returns the first launch error as a cudaError_t.
template <class E>
int conv3x3_bwd(const E* x, const E* go, const E* w, const E* wf,
                const E* bias, const E* a, const E* t, E* dz, E* dxh, E* dw,
                E* dbias, float* ws, int B, int H, int W, int cin, int cout,
                int act, int splits, void* stream) {
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
  const E* d = go;
  if (act) {
    pc::ConvArgsT<E> c = {};
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
  pc::WgradArgsT<E> wa = {};
  wa.x = x;
  wa.a = a;
  wa.t = t;
  wa.d = d;
  wa.ws = ws;
  wa.g = g;
  wa.N = cout;
  wa.gw = cout;
  wa.npix = B * H * W;
  wa.vec_d = cout % 4 == 0 && pc::aligned(d, 4 * sizeof(E));
  int err = pc::launch_wgrad<pc::PlainD>(wa, splits, dw, dbias, st);
  if (err) return err;
  pc::ConvArgsT<E> c = {};  // the transposed convolution reads d
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

// The same in bf16: every operand and output bf16 but the float workspace.
extern "C" int ucdir_conv3x3_bwd_bf16(
    const ucdir::bf16* x, const ucdir::bf16* go, const ucdir::bf16* w,
    const ucdir::bf16* wf, const ucdir::bf16* bias, const ucdir::bf16* a,
    const ucdir::bf16* t, ucdir::bf16* dz, ucdir::bf16* dxh, ucdir::bf16* dw,
    ucdir::bf16* dbias, float* ws, int B, int H, int W, int cin, int cout,
    int act, int splits, void* stream) {
  return conv3x3_bwd(x, go, w, wf, bias, a, t, dz, dxh, dw, dbias, ws, B, H,
                     W, cin, cout, act, splits, stream);
}
