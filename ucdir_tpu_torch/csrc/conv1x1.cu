// K3: 1x1 convolution, a per-pixel (Cin -> Cout) product, + bias, optional
// swish.
//
// Replaces the TPU kernel B6 (ucdir_tpu/ops/conv_pallas.py _conv1x1_forward),
// the res_conv of every ResnetBlockDY3h whose width changes. The TPU kernel
// ran one (W, Cin) @ (Cin, Cout) dot per image row; here the implicit GEMM of
// igemm_pc.cuh runs with a 1x1 window, so a block's 128 pixels by 128
// channels, or 256 by 64, reuse every staged input value across the tile's
// columns.
// Bound: 2 * Cin * Cout FLOP per 4 * (Cin + Cout) bytes against the card's
// fp32 balance of 20 FLOP per byte (67 TFLOP/s over 3.35 TB/s): the wide,
// shallow sites sit at it (192 -> 64 at 1568 x 2272: 1.31 ms of operations,
// 1.09 ms of bytes), the deep ones (1024 -> 512) are bound by the fp32 FMA rate.
// What the design does about it: every input value is read once, 16 bytes a
// thread, the next slices' loads are in flight while the current one is
// multiplied, and the warps that multiply do nothing else.
#include "igemm_pc.cuh"

// x (B, H, W, cin) NHWC; w (cin, cout); bias (cout); out (B, H, W, cout).
// Returns the launch's cudaError_t.
extern "C" int ucdir_conv1x1(const float* x, const float* w, const float* bias,
                             float* out, int B, int H, int W, int cin,
                             int cout, int act, void* stream) {
  ucdir::pc::ConvArgs c = {};
  c.x = x;
  c.w = w;
  c.bias = bias;
  c.out = out;
  c.g.H = H;
  c.g.W = W;
  c.g.C = cin;
  c.g.Ho = H;
  c.g.Wo = W;
  c.g.ks = 1;
  c.g.stride = 1;
  c.g.cin = cin;
  c.g.K = cin;
  c.cout = cout;
  c.act = act;
  return ucdir::pc::launch_conv<ucdir::pc::Raw>(c, B, (cudaStream_t)stream);
}
