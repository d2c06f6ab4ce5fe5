// K1: the fused AKGM block tail,
//   out[c] = swish(sum_j (gconv3x3(h * a + t) + bias)[c * G + j]
//                  * att[j] * attw[j]) + res[c],
// optionally with the per-(batch, channel) sum and sum of squares of out.
//
// Replaces the TPU kernel B1 (ucdir_tpu/ops/akgm_pallas.py
// _akgm_block_forward_padfree and its staging variants) and follows the
// per-group formulation of _akgm_block_forward_grouped: conv output
// o = c * G + j is candidate j of mix channel c and belongs to conv group
// g = o / C, so every candidate of channel c reads input group c / (C / G).
// A block's 64 output columns are the 8 candidates of 8 consecutive mix
// channels inside one group; it runs the group's true (9 * C/G) x 64 product
// (no 8x densified weights) and each thread's TN = 8 columns are exactly one
// channel's candidates, so the mix, swish, residual and statistics happen in
// registers and the (B, H, W, C * G) candidate tensor never exists.
// Bound: fp32 FMA issue (see igemm.cuh); at C = 64 the reduction is only
// 9 * 8 = 72 deep, so staging and the epilogue weigh more there.
//
// K8: the mix alone,
//   out[c] = sum_j (gconv3x3(h) + bias)[c * G + j] * att[j],
// the same per-group product with a plain epilogue: the register sum over a
// channel's candidates, then the store. No fold, no attw, no swish, no
// residual, no statistics. Replaces the TPU kernel B10
// (ucdir_tpu/ops/akgm_pallas.py _akgm_forward, which densified the grouped
// weights 8x and summed the candidates with a selection matmul).
#include "igemm.cuh"

namespace {

constexpr int G = 8;  // candidates per channel; equals TN by construction
static_assert(G == ucdir::TN, "one thread holds one channel's candidates");

// TAIL: K1's epilogue (attw, swish, residual, statistics); else K8's.
template <bool TAIL>
__global__ void __launch_bounds__(ucdir::NT)
    akgm_kernel(const float* __restrict__ h, const float* __restrict__ att,
                const float* __restrict__ attw, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ res,
                const float* __restrict__ a, const float* __restrict__ t,
                float* __restrict__ out, float* __restrict__ ssum,
                float* __restrict__ ssq, ucdir::Geom g) {
  __shared__ __align__(16) ucdir::Smem sm;
  float acc[ucdir::TM][ucdir::TN];
  const int C = g.C;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * ucdir::BM;
  const int n0 = blockIdx.y * ucdir::BN;
  const int group = n0 / C;
  ucdir::zero_red(sm);
  ucdir::igemm(acc, sm, h, a, t, w, C * G, C * G, g, b, group * g.cin, m0, n0);

  const int tid = threadIdx.x;
  const int tm = tid / (ucdir::BN / ucdir::TN);
  const int tn = tid % (ucdir::BN / ucdir::TN);
  const int c = (n0 + tn * ucdir::TN) / G;
  const int P = g.Ho * g.Wo;
  float bj[G], awj[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    bj[j] = bias[c * G + j];
    awj[j] = (TAIL && attw) ? attw[b * G + j] : 1.f;
  }
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < ucdir::TM; ++i) {
    const int p = m0 + tm * ucdir::TM + i;
    if (p >= P) continue;
    const int64_t pix = (int64_t)b * P + p;
    const float* ap = att + pix * G;
    float mix = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) mix += (acc[i][j] + bj[j]) * (ap[j] * awj[j]);
    if (!TAIL) {
      out[pix * C + c] = mix;
      continue;
    }
    const float v = ucdir::swishf(mix) + res[pix * C + c];
    out[pix * C + c] = v;
    s += v;
    q += v * v;
  }
  if (!TAIL || ssum == nullptr) return;
  atomicAdd(&sm.red[tn], s);
  atomicAdd(&sm.red[ucdir::BN + tn], q);
  __syncthreads();
  if (tid < ucdir::BN / G) {
    atomicAdd(&ssum[(int64_t)b * C + n0 / G + tid], sm.red[tid]);
    atomicAdd(&ssq[(int64_t)b * C + n0 / G + tid], sm.red[ucdir::BN + tid]);
  }
}

ucdir::Geom akgm_geom(int H, int W, int C) {
  ucdir::Geom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.Ho = H;
  g.Wo = W;
  g.ks = 3;
  g.stride = 1;
  g.cin = C / G;
  g.K = 9 * (C / G);
  return g;
}

dim3 akgm_grid(int B, int H, int W, int C) {
  return dim3((H * W + ucdir::BM - 1) / ucdir::BM, (C * G) / ucdir::BN, B);
}

}  // namespace

// h, res, out (B, H, W, C) NHWC; att (B, H, W, 8); attw (B, 8) or null;
// w (9 * C/8, 8 * C) with row tap * (C/8) + ci and column c * 8 + j (the
// grouped HWIO kernel reshaped); bias (8 * C); a, t (B, C) or null; ssum, ssq
// zeroed (B, C) or null. C must be a multiple of 64. Returns the launch's
// cudaError_t.
extern "C" int ucdir_akgm_tail(const float* h, const float* att,
                               const float* attw, const float* w,
                               const float* bias, const float* res,
                               const float* a, const float* t, float* out,
                               float* ssum, float* ssq, int B, int H, int W,
                               int C, void* stream) {
  akgm_kernel<true>
      <<<akgm_grid(B, H, W, C), ucdir::NT, 0, (cudaStream_t)stream>>>(
          h, att, attw, w, bias, res, a, t, out, ssum, ssq,
          akgm_geom(H, W, C));
  return (int)cudaGetLastError();
}

// K8: out (B, H, W, C) = the mix of h's candidates under att; operands as
// above.
extern "C" int ucdir_akgm_mix(const float* h, const float* att, const float* w,
                              const float* bias, float* out, int B, int H,
                              int W, int C, void* stream) {
  akgm_kernel<false>
      <<<akgm_grid(B, H, W, C), ucdir::NT, 0, (cudaStream_t)stream>>>(
          h, att, nullptr, w, bias, nullptr, nullptr, nullptr, out, nullptr,
          nullptr, akgm_geom(H, W, C));
  return (int)cudaGetLastError();
}
