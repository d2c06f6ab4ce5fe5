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
// The _bf16 entry point (the TPU kernel's bf16 instantiation) runs on the
// tensor-core core of igemm_tc.cuh as a plain Hopper GEMM: the B * H * W
// pixels are the rows of one matrix, both operands come by TMA (the ragged
// last tile zero-filled by the hardware), a bf16 wgmma product with fp32
// accumulation, the output rounded once. Bound: 2 * Cin * Cout FLOP per
// 2 * (Cin + Cout) bytes against the bf16 balance of 295 FLOP per byte (989
// TFLOP/s over 3.35 TB/s): the bytes at 192 -> 64 (0.544 ms at 1568 x 2272),
// the product at 1024 -> 512 (0.059 ms at 196 x 284). What the design does
// about it: every value read once by TMA, four slices in flight, and the
// consumers' warpgroups do nothing but the product and the epilogue.
#include "igemm_tc.cuh"

// x (B, H, W, cin) NHWC; w (cin, cout); bias (cout); out (B, H, W, cout).
// Returns the launch's cudaError_t.
extern "C" int ucdir_conv1x1(const float* x, const float* w, const float* bias,
                             float* out, int B, int H, int W, int cin,
                             int cout, int act, void* stream) {
  ucdir::pc::ConvArgsT<float> c = {};
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

// K3 in bf16 on the tensor cores: x, w, bias and out bf16.
extern "C" int ucdir_conv1x1_bf16(const ucdir::bf16* x, const ucdir::bf16* w,
                                  const ucdir::bf16* bias, ucdir::bf16* out,
                                  int B, int H, int W, int cin, int cout,
                                  int act, void* stream) {
  // the pixels of every image as one row of one image
  ucdir::tc::TcArgs p = {};
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.out = out;
  p.g.H = 1;
  p.g.W = B * H * W;
  p.g.C = cin;
  p.g.Ho = 1;
  p.g.Wo = B * H * W;
  p.g.ks = 1;
  p.g.stride = 1;
  p.g.cin = cin;
  p.g.K = cin;
  p.cout = cout;
  p.act = act;
  return ucdir::tc::launch_conv<ucdir::pc::Raw>(
      p, nullptr, nullptr, 1, (cudaStream_t)stream, ucdir::tc::TC_CONV1X1);
}
