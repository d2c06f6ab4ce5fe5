// K5: every gradient of the fused AKGM block tail K1 computes,
//   out[c] = swish(o[c]) + res[c],
//   o[c]   = sum_j z[c * G + j] * A[j],   A[j] = att[j] * attw[j],
//   z      = gconv3x3(h * a + t) + bias                  (groups = G),
// from h, the output cotangent go, att, attw and the grouped weights:
//   do[c]         = go[c] * swish'(o[c])
//   dz[c * G + j] = do[c] * A[j]
//   dhh   = transposed grouped conv of dz   the gradient of h * a + t
//   dW    = im2col(h * a + t)^T @ dz per group, dbias = sum dz
//   datt[j]  = attw[j] * sum_c do[c] * z[c * G + j]
//   dattw[j] = sum over pixels of att[j] * sum_c do[c] * z[c * G + j]
// (dres = go is the caller's; it also turns dhh into dh, dnorm_scale and
// dnorm_shift with plain tensor ops, as the TPU code does outside its kernel).
//
// Replaces the TPU kernel B8 (ucdir_tpu/ops/akgm_pallas.py
// _akgm_block_backward, kernel _akgm_block_bwd_kernel). The TPU kernel built
// the 8x densified weights and their gradient, summed on the matrix unit with
// selection matrices, staged a 2-row halo to recompute z and dz per row block
// and carried dW, dbias and dattw across its ordered grid. Here everything
// stays in K1's per-group form: a block's 64 columns are the 8 candidates of
// 8 channels of one group and a thread's 8 accumulator columns one channel's
// candidates, so o, do and the datt terms are register sums. Neither z nor dz
// (both (B, H, W, C * G)) is ever written: the first launch recomputes z and
// writes only do, a tensor of the output's size, and the other two rebuild
// dz = do * att * attw as they stage it (one multiply per element), the
// weight gradient as its pixel-major operand and the input gradient as the
// input of K1's product with flipped, transposed per-group weights. dW,
// dbias, datt and dattw are float32 atomics into zeroed buffers, in an order
// that changes from run to run.
// Bound: the fp32 FMA rate, at three times K1's operations. The input
// gradient of a group has only C / G columns: below C = 512 its 64-column
// tile is partly idle (C = 64: 8 of 64 columns live).
#include "igemm.cuh"

namespace {

using ucdir::BM;
using ucdir::BN;
using ucdir::NT;
using ucdir::TM;
using ucdir::TN;

constexpr int G = 8;  // candidates per channel; equals TN by construction
static_assert(G == TN, "one thread holds one channel's candidates");
static_assert(ucdir::BK * (BM + ucdir::APAD) >= BM * G,
              "the A stage doubles as the (pixel, candidate) scratch");

// do = go * swish'(o), datt and dattw; z recomputed in registers
__global__ void __launch_bounds__(NT)
    akgm_bwd_do_kernel(const float* __restrict__ h,
                       const float* __restrict__ go,
                       const float* __restrict__ att,
                       const float* __restrict__ attw,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ a, const float* __restrict__ t,
                       float* __restrict__ dout, float* __restrict__ datt,
                       float* __restrict__ dattw, ucdir::Geom g) {
  __shared__ __align__(16) ucdir::Smem sm;
  float acc[TM][TN];
  const int C = g.C;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int group = n0 / C;
  ucdir::igemm(acc, sm, h, a, t, w, C * G, C * G, g, b, group * g.cin, m0, n0);

  const int tid = threadIdx.x;
  const int tm = tid / (BN / TN);
  const int tn = tid % (BN / TN);
  const int c = (n0 + tn * TN) / G;
  const int P = g.Ho * g.Wo;
  // q[pixel][j] = sum over this block's 8 channels of do[c] * z[c * G + j]
  float* q = &sm.As[0][0];
  for (int i = tid; i < BM * G; i += NT) q[i] = 0.f;
  if (tid < G) sm.red[tid] = 0.f;
  float bj[G], awj[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    bj[j] = bias[c * G + j];
    awj[j] = attw ? attw[b * G + j] : 1.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + tm * TM + i;
    if (p >= P) continue;
    const int64_t pix = (int64_t)b * P + p;
    const float* ap = att + pix * G;
    float z[G];
    float o = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      z[j] = acc[i][j] + bj[j];
      o += z[j] * (ap[j] * awj[j]);
    }
    const float d = go[pix * C + c] * ucdir::dswishf(o);
    dout[pix * C + c] = d;
#pragma unroll
    for (int j = 0; j < G; ++j) atomicAdd(&q[(tm * TM + i) * G + j], d * z[j]);
  }
  __syncthreads();
  const int p = m0 + tid;  // one thread per pixel of the tile (NT == BM)
  if (p < P) {
    const int64_t pix = (int64_t)b * P + p;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float v = q[tid * G + j];
      atomicAdd(&datt[pix * G + j], v * (attw ? attw[b * G + j] : 1.f));
      if (dattw) atomicAdd(&sm.red[j], v * att[pix * G + j]);
    }
  }
  if (dattw == nullptr) return;
  __syncthreads();
  if (tid < G) atomicAdd(&dattw[b * G + tid], sm.red[tid]);
}

// dz[c * G + j] = do[c] * att[j] * attw[j] of one image, rebuilt on the fly
struct DzLoader {
  const float* dob;   // image b's (H, W, C) do
  const float* attb;  // image b's (H, W, G) att
  const float* awb;   // image b's (G) attw or null
  int W, C, n_first;  // n_first: the first dz column of this group
  struct Col {
    int c, j;
    float aw;
  };
  __device__ __forceinline__ Col col(int nl) const {
    Col s;
    s.c = (n_first + nl) / G;
    s.j = (n_first + nl) % G;
    s.aw = awb ? awb[s.j] : 1.f;
    return s;
  }
  __device__ __forceinline__ float at(const Col& s, int iy, int ix) const {
    const int64_t pix = (int64_t)iy * W + ix;
    return dob[pix * C + s.c] * attb[pix * G + s.j] * s.aw;
  }
  // pixel-major access for the weight gradient: column n of all C * G
  __device__ __forceinline__ float at(int p, int n) const {
    const int j = n % G;
    return dob[(int64_t)p * C + n / G] * attb[(int64_t)p * G + j] *
           (awb ? awb[j] : 1.f);
  }
};

__device__ __forceinline__ DzLoader dz_loader(const float* dout,
                                              const float* att,
                                              const float* attw,
                                              const ucdir::Geom& g, int C,
                                              int b, int n_first) {
  const int64_t P = (int64_t)g.H * g.W;
  DzLoader dl;
  dl.dob = dout + b * P * C;
  dl.attb = att + b * P * G;
  dl.awb = attw ? attw + b * G : nullptr;
  dl.W = g.W;
  dl.C = C;
  dl.n_first = n_first;
  return dl;
}

// dW += im2col(h * a + t)^T @ dz per group, dbias += sum dz, one pixel chunk
__global__ void __launch_bounds__(NT)
    akgm_bwd_dw_kernel(const float* __restrict__ h,
                       const float* __restrict__ dout,
                       const float* __restrict__ att,
                       const float* __restrict__ attw,
                       const float* __restrict__ a, const float* __restrict__ t,
                       float* __restrict__ dw, float* __restrict__ dbias,
                       ucdir::Geom g, int splits, int chunk) {
  __shared__ __align__(16) ucdir::Smem sm;
  float acc[TM][TN];
  float bsum;
  const int C = g.C;
  const int b = blockIdx.x / splits;
  const int P = g.H * g.W;
  const int p0 = (blockIdx.x % splits) * chunk;
  const int p1 = min(p0 + chunk, P);
  const int n0 = blockIdx.y * BN;
  const int m0 = blockIdx.z * BM;
  const int group = n0 / C;
  ucdir::wgrad_core(acc, bsum, sm,
                    ucdir::affine_loader(h, a, t, g, b, group * g.cin),
                    dz_loader(dout, att, attw, g, C, b, 0), C * G, g, p0, p1,
                    m0, n0);
  ucdir::wgrad_store(acc, dw, C * G, g.K, C * G, m0, n0, 0);
  if (blockIdx.z == 0 && threadIdx.x < BN)
    atomicAdd(&dbias[n0 + threadIdx.x], bsum);
}

// dhh = transposed grouped conv of dz: per group, K1's product on dz with
// the flipped, transposed weights wf (G, 9 * C, C / G)
__global__ void __launch_bounds__(NT)
    akgm_bwd_dh_kernel(const float* __restrict__ dout,
                       const float* __restrict__ att,
                       const float* __restrict__ attw,
                       const float* __restrict__ wf, float* __restrict__ dhh,
                       ucdir::Geom g, int C, int ctiles) {
  __shared__ __align__(16) ucdir::Smem sm;
  float acc[TM][TN];
  const int cg = C / G;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int group = blockIdx.y / ctiles;
  const int n0 = (blockIdx.y % ctiles) * BN;
  ucdir::igemm_core(acc, sm, dz_loader(dout, att, attw, g, C, b, group * C),
                    wf + (int64_t)group * g.K * cg, cg, cg, g, m0, n0);
  const int tm = threadIdx.x / (BN / TN);
  const int tn = threadIdx.x % (BN / TN);
  const int P = g.Ho * g.Wo;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + tm * TM + i;
    if (p >= P) continue;
    float* row = dhh + ((int64_t)b * P + p) * C + group * cg;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n < cg) row[n] = acc[i][j];
    }
  }
}

}  // namespace

// h, go, dout, dhh (B, H, W, C) NHWC; att, datt (B, H, W, 8); attw, dattw
// (B, 8) or both null; w, dw (9 * C/8, 8 * C) as in ucdir_akgm_tail; wf
// (8, 9 * C, C/8) with wf[g][tap * C + nl][ci] = w[(8 - tap) * C/8 + ci]
// [g * C + nl]; bias, dbias (8 * C); a, t (B, C) or null. dout is scratch;
// datt, dw, dbias and dattw must be zeroed. C must be a multiple of 64.
// Returns the first launch error as a cudaError_t.
extern "C" int ucdir_akgm_tail_bwd(const float* h, const float* go,
                                   const float* att, const float* attw,
                                   const float* w, const float* wf,
                                   const float* bias, const float* a,
                                   const float* t, float* dout, float* dhh,
                                   float* datt, float* dw, float* dbias,
                                   float* dattw, int B, int H, int W, int C,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = H * W;
  const int cg = C / G;
  ucdir::Geom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.Ho = H;
  g.Wo = W;
  g.ks = 3;
  g.stride = 1;
  g.cin = cg;
  g.K = 9 * cg;
  const int ptiles = (P + BM - 1) / BM;
  const int ntiles = (C * G) / BN;
  akgm_bwd_do_kernel<<<dim3(ptiles, ntiles, B), NT, 0, st>>>(
      h, go, att, attw, w, bias, a, t, dout, datt, dattw, g);
  const int mtiles = (g.K + BM - 1) / BM;
  const int splits = ucdir::wgrad_splits(mtiles * ntiles, B, P);
  int chunk = (P + splits - 1) / splits;
  chunk = (chunk + ucdir::BK - 1) / ucdir::BK * ucdir::BK;
  akgm_bwd_dw_kernel<<<dim3(B * splits, ntiles, mtiles), NT, 0, st>>>(
      h, dout, att, attw, a, t, dw, dbias, g, splits, chunk);
  ucdir::Geom gt = g;  // a group's transposed conv: C dz columns per tap
  gt.cin = C;
  gt.K = 9 * C;
  const int ctiles = (cg + BN - 1) / BN;
  akgm_bwd_dh_kernel<<<dim3(ptiles, G * ctiles, B), NT, 0, st>>>(
      dout, att, attw, wf, dhh, gt, C, ctiles);
  return (int)cudaGetLastError();
}
