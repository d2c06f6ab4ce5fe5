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
// stays in K1's per-group form and runs on the producer/consumer core of the
// forward convolutions (igemm_pc.cuh). Neither z nor dz (both (B, H, W,
// C * G)) is ever written:
//   1. akgm_do_kernel recomputes z with the per-group product and writes do,
//      a tensor of the output's size, and A = att * attw, (B, H, W, G). A
//      consumer thread's 8 columns are two groups of 4 half a tile apart
//      (igemm_pc.cuh); the wrapper permutes the weights' and the bias's
//      columns within each tile so that they are one channel's candidates
//      0..7, and o, do and the datt terms stay register sums. The terms
//      q[p][j] = sum_c do[c] z[c * G + j] of a row of threads are added with
//      a butterfly of warp shuffles that halves the values a lane holds at
//      every step. A block walks all column tiles of its pixels, so it ends
//      with the whole sum and stores datt once, in a fixed order, with no
//      atomics (a block per column tile added 64 float atomics per pixel at
//      C = 64). dattw adds one float atomic per block and candidate.
//   2. the weight gradient, wgrad_pc_kernel with the group's channels of
//      h * a + t as A and dz rebuilt as D (do[c] times 16 bytes of A), the
//      pixels cut into chunks whose partial tiles wgrad_reduce_kernel adds
//      in a fixed order: dW and dbias have the same bits from run to run.
//   3. akgm_dh_kernel, the input gradient: per group K2's product on dz,
//      rebuilt as it is staged, with the flipped, transposed per-group
//      weights, on a tile as wide as the group's C / G output columns (8,
//      16, 32 or 64), so that no column of the tile idles.
// Bound: the fp32 FMA rate, at three times K1's operations.
#include "igemm_pc.cuh"

namespace {

namespace pc = ucdir::pc;
constexpr int G = 8;  // candidates per channel

struct DoArgs {
  const float* h;     // (B, H, W, C)
  const float* go;    // (B, H, W, C)
  const float* att;   // (B, H, W, G)
  const float* attw;  // (B, G) or null
  const float* w;     // (9 * C / G, C * G), columns permuted in each tile
  const float* bias;  // (C * G), permuted alike
  const float* a;     // (B, C) or null
  const float* t;
  float* dout;        // (B, H, W, C) do
  float* aa;          // (B, H, W, G) att * attw, written when attw
  float* datt;        // (B, H, W, G), written whole
  float* dattw;       // zeroed (B, G) or null
  ucdir::Geom g;      // g.C = C, g.cin = C / G
  int ntn;            // column tiles of C * G, all walked by each block
  bool vec_a;
};

// Adds CNT values over the M lanes of a row of consumer threads (M a power of
// two, the lanes' low bits): every step a lane keeps half of its values and
// adds the partner's copy of them, so each lane ends with CNT / M sums, those
// of the indices from butterfly_offset().
template <int CNT, int M>
__device__ __forceinline__ void butterfly(float* v, int lane) {
  if constexpr (M > 1) {
    constexpr int H = CNT / 2;
    const bool up = (lane & (M / 2)) != 0;
#pragma unroll
    for (int e = 0; e < H; ++e) {
      const float send = up ? v[e] : v[e + H];
      const float keep = up ? v[e + H] : v[e];
      v[e] = keep + pc::shfl_xor(send, M / 2);
    }
    butterfly<H, M / 2>(v, lane);
  }
}

template <int CNT, int M>
__device__ __forceinline__ int butterfly_offset(int lane) {
  int off = 0, h = CNT;
#pragma unroll
  for (int m = M / 2; m >= 1; m >>= 1) {
    h >>= 1;
    if (lane & m) off += h;
  }
  return off;
}

// The consumers' epilogue of one column tile of akgm_do_kernel: a thread's
// TM rows of its channel's 8 candidates; adds the tile's datt terms of the
// lane's row and candidates (see butterfly) to qs. The terms take the
// accumulators' registers.
template <class T>
__device__ __forceinline__ void do_epilogue(float (&acc)[T::TM][T::TN],
                                            const DoArgs& c, int b, int m0,
                                            int n0, float* qs) {
  static_assert(T::TN == G && T::GW == 4 && T::NG == 2, "a channel a thread");
  constexpr int NV = T::TM * G;
  const int tn = threadIdx.x % T::NCX;
  const int tm = threadIdx.x / T::NCX;
  const int C = c.g.C;
  const int P = c.g.H * c.g.W;
  const int ch = n0 / G + tn;
  float bj[G], awj[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    bj[j] = c.bias[n0 + pc::tile_col<T>(tn, j)];
    awj[j] = c.attw ? c.attw[b * G + j] : 1.f;
  }
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int p = m0 + pc::tile_row<T>(tm, i);
    if (p >= P) {
#pragma unroll
      for (int j = 0; j < G; ++j) acc[i][j] = 0.f;
      continue;
    }
    const int64_t pix = (int64_t)b * P + p;
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(c.att + pix * G));
    const float4 a1 =
        __ldg(reinterpret_cast<const float4*>(c.att + pix * G + 4));
    const float at[G] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float A[G], z[G];
    float o = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      A[j] = at[j] * awj[j];
      z[j] = acc[i][j] + bj[j];
      o += z[j] * A[j];
    }
    const float d = __ldg(c.go + pix * C + ch) * ucdir::dswishf(o);
    c.dout[pix * C + ch] = d;
#pragma unroll
    for (int j = 0; j < G; ++j) acc[i][j] = d * z[j];
    if (c.attw != nullptr && n0 == 0 && tn == 0) {
      float4* ap = reinterpret_cast<float4*>(c.aa + pix * G);
      ap[0] = make_float4(A[0], A[1], A[2], A[3]);
      ap[1] = make_float4(A[4], A[5], A[6], A[7]);
    }
  }
  float* q = &acc[0][0];  // q[i * G + j]
  butterfly<NV, T::NCX>(q, threadIdx.x & 31);
#pragma unroll
  for (int e = 0; e < NV / T::NCX; ++e) qs[e] += q[e];
}

// do, A and the datt terms of one BM-pixel tile: the block walks every
// column tile of z (all groups), so that it holds the whole sum over
// channels of its pixels' datt terms, which it stores once (no atomics: datt
// has the same bits from run to run). dattw adds one float atomic per block
// and candidate.
template <class T>
__global__ void __launch_bounds__(T::NT) akgm_do_kernel(DoArgs c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * T::BM;
  const int nk = pc::igemm_setup<T>(smem, c.g, m0);
  if (threadIdx.x >= T::NC) {
    pc::grouped_produce<T>(smem, c.h, c.a, c.t, c.w, c.g, b, 0, c.ntn, nk,
                           c.vec_a);
  } else {
    constexpr int CNT = T::TM * G / T::NCX;  // sums a lane ends with
    static_assert(CNT <= G && G % CNT == 0, "a lane's sums share a row");
    float qs[CNT];
#pragma unroll
    for (int e = 0; e < CNT; ++e) qs[e] = 0.f;
    for (int nt = 0; nt < c.ntn; ++nt) {
      float acc[T::TM][T::TN];
      pc::consume<T>(acc, smem, nk);
      do_epilogue<T>(acc, c, b, m0, nt * T::BN, qs);
    }
    const int lane = threadIdx.x & 31;
    const int off = butterfly_offset<T::TM * G, T::NCX>(lane);
    const int P = c.g.H * c.g.W;
    const int p = m0 + pc::tile_row<T>(threadIdx.x / T::NCX, off / G);
    const int j0 = off % G;
    if (p < P) {
      const int64_t pix = (int64_t)b * P + p;
#pragma unroll
      for (int e = 0; e < CNT; ++e) {
        const int j = j0 + e;
        const float aw = c.attw ? __ldg(c.attw + b * G + j) : 1.f;
        c.datt[pix * G + j] = qs[e] * aw;
        if (c.dattw)
          atomicAdd(smem + T::RED + j, qs[e] * __ldg(c.att + pix * G + j));
      }
    }
  }
  if (c.dattw == nullptr) return;
  pc::block_sync<T::NT>();
  if (threadIdx.x < G) atomicAdd(c.dattw + b * G + threadIdx.x,
                                 smem[T::RED + threadIdx.x]);
}

struct DhArgs {
  const float* dout;  // (B, H, W, C) do
  const float* aa;    // (B, H, W, G) att * attw
  const float* wf;    // (G, 9 * C, C / G)
  float* dhh;         // (B, H, W, C)
  ucdir::Geom g;      // g.C = C, g.cin = C (a group's dz columns), g.K = 9 C
  int ntn;
};

// dhh of one group: the group's dz (C columns) convolved with its flipped,
// transposed weights (9 * C, C / G); blockIdx.y is the group
template <class T>
__global__ void __launch_bounds__(T::NT) akgm_dh_kernel(DhArgs c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int group = blockIdx.y;
  const int mt = blockIdx.x / c.ntn;
  const int m0 = mt * T::BM;
  const int n0 = (blockIdx.x - mt * c.ntn) * T::BN;
  const int C = c.g.C;
  const int cg = C / G;
  const int64_t P = (int64_t)c.g.H * c.g.W;
  pc::Operands op;
  op.xb = c.dout + b * P * C + group * cg;
  op.ab = op.tb = nullptr;
  op.att = c.aa + b * P * G;
  op.w = c.wf + (int64_t)group * c.g.K * cg;
  op.ncols = cg;
  op.vec_a = true;
  op.vec_w = true;
  const int nk = pc::igemm_setup<T>(smem, c.g, m0);
  if (threadIdx.x >= T::NC) {
    pc::produce<T, pc::Dz>(smem, op, c.g, n0, nk);
    return;
  }
  float acc[T::TM][T::TN];
  pc::consume<T>(acc, smem, nk);
  const int tn = threadIdx.x % T::NCX;
  const int tm = threadIdx.x / T::NCX;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int p = m0 + pc::tile_row<T>(tm, i);
    if (p >= P) continue;
    float* row = c.dhh + (b * P + p) * C + group * cg;
#pragma unroll
    for (int g = 0; g < T::NG; ++g) {
      const int n = n0 + pc::tile_col<T>(tn, T::GW * g);
      const float* v = &acc[i][T::GW * g];
      if constexpr (T::GW == 4) {
        if (n + 4 <= cg)
          *reinterpret_cast<float4*>(row + n) =
              make_float4(v[0], v[1], v[2], v[3]);
      } else {
        if (n + 2 <= cg)
          *reinterpret_cast<float2*>(row + n) = make_float2(v[0], v[1]);
      }
    }
  }
}

template <class T>
int launch_do(DoArgs c, int B, cudaStream_t st) {
  const int P = c.g.H * c.g.W;
  c.ntn = c.g.C * G / T::BN;
  akgm_do_kernel<T><<<dim3((P + T::BM - 1) / T::BM, 1, B), T::NT,
                      T::SMEM_BYTES, st>>>(c);
  return (int)cudaGetLastError();
}

template <class T>
int launch_dh(DhArgs c, int B, cudaStream_t st) {
  const int P = c.g.H * c.g.W;
  const int cg = c.g.C / G;
  c.ntn = (cg + T::BN - 1) / T::BN;
  akgm_dh_kernel<T><<<dim3(((P + T::BM - 1) / T::BM) * c.ntn, G, B), T::NT,
                      T::SMEM_BYTES, st>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

// h, go, dout, dhh (B, H, W, C) NHWC; att, datt (B, H, W, 8); attw, dattw
// (B, 8) or both null; w (9 * C/8, 8 * C) as in ucdir_akgm_tail and bias
// (8 * C), both with the columns of every tile of 128 (C >= 128) or 64
// (C = 64) permuted so that physical column h * BN / 2 + 4 * i + r holds
// logical column 8 * i + 4 * h + r; wf (8, 9 * C, C/8) with wf[g][tap * C +
// nl][ci] = w[(8 - tap) * C/8 + ci][g * C + nl] (unpermuted); a, t (B, C) or
// null. dout is scratch, aa a (B, H, W, 8) scratch used with attw; dattw
// must be zeroed; datt, dw (9 * C/8, 8 * C) and dbias (8 * C), unpermuted,
// are written whole; ws is a (splits, 9 * C/8 + 1, 8 * C) workspace. C must
// be a multiple of 64. Returns the first launch error as a cudaError_t.
extern "C" int ucdir_akgm_tail_bwd(const float* h, const float* go,
                                   const float* att, const float* attw,
                                   const float* w, const float* wf,
                                   const float* bias, const float* a,
                                   const float* t, float* dout, float* aa,
                                   float* dhh, float* datt, float* dw,
                                   float* dbias, float* dattw, float* ws,
                                   int B, int H, int W, int C, int splits,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
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
  DoArgs d = {};
  d.h = h;
  d.go = go;
  d.att = att;
  d.attw = attw;
  d.w = w;
  d.bias = bias;
  d.a = a;
  d.t = t;
  d.dout = dout;
  d.aa = aa;
  d.datt = datt;
  d.dattw = dattw;
  d.g = g;
  d.vec_a = pc::aligned(h, 16) &&
            (a == nullptr || (pc::aligned(a, 16) && pc::aligned(t, 16)));
  int err = C >= 128 ? launch_do<pc::Wide>(d, B, st)
                     : launch_do<pc::Mid>(d, B, st);
  if (err) return err;
  const float* A = attw ? aa : att;
  pc::WgradArgs wa = {};
  wa.x = h;
  wa.a = a;
  wa.t = t;
  wa.d = dout;
  wa.att = A;
  wa.ws = ws;
  wa.g = g;
  wa.N = C * G;
  wa.gw = C;
  wa.npix = B * H * W;
  wa.vec_d = true;
  err = pc::launch_wgrad<pc::DzD>(wa, splits, dw, dbias, st);
  if (err) return err;
  DhArgs dh = {};
  dh.dout = dout;
  dh.aa = A;
  dh.wf = wf;
  dh.dhh = dhh;
  dh.g = g;  // a group's transposed conv: C dz columns per tap
  dh.g.cin = C;
  dh.g.K = 9 * C;
  switch (cg) {
    case 8: return launch_dh<pc::Narrow>(dh, B, st);
    case 16: return launch_dh<pc::N16>(dh, B, st);
    case 32: return launch_dh<pc::N32>(dh, B, st);
    default: return launch_dh<pc::Mid>(dh, B, st);
  }
}
