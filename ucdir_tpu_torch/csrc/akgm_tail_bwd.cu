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
//      C = 64). The tile is K1's for that C (128 x 128, 256 x 64, or 128
//      pixels by 32, 16 or 8 columns: ops/akgm.py tail_tile), so a tile lies
//      in one group. dattw: the block's pixel terms go to shared memory and
//      are added in ascending pixel order into a (B, pixel tiles, G)
//      workspace, whose tiles dattw_reduce_kernel adds in ascending order,
//      as K1's statistics: dattw has the same bits from run to run.
//   2. the weight gradient, wgrad_pc_kernel with the group's channels of
//      h * a + t as A and dz rebuilt as D (do[c] times 16 bytes of A), the
//      pixels cut into chunks whose partial tiles wgrad_reduce_kernel adds
//      in a fixed order: dW and dbias have the same bits from run to run.
//      Its tile's columns divide the group's C columns (launch_wgrad).
//   3. akgm_dh_kernel, the input gradient: per group K2's product on dz,
//      rebuilt as it is staged, with the flipped, transposed per-group
//      weights, on the narrowest tile of 8, 16, 32 or 64 columns that holds
//      the group's C / G output columns, so that few columns of it idle.
// Bound: the fp32 FMA rate, at three times K1's operations.
//
// ucdir_akgm_tail_bwd_bf16 runs the same launches on bf16 operands and
// outputs, rounding where the TPU kernel's bf16 instantiation rounds: the
// recomputed z and A each rounded and their product m = z * A rounded before
// the G terms are added (the float32 kernel has no such rounding); do from
// the bf16 cotangent in float32, rounded once, and then dz = do * A (A =
// att * attw, exact in float32, kept in the float32 scratch aa) rounded
// where it enters the weight and the input gradient; the datt terms do * z
// rounded before they are added, datt times attw rounded once; dW and dattw
// added in float32 in their workspaces and rounded once; dbias the float32
// sum of the unrounded dz, rounded once; dhh rounded once.
#include "igemm_pc.cuh"

namespace {

namespace pc = ucdir::pc;
using ucdir::bf16;
using ucdir::Elem;
constexpr int G = 8;  // candidates per channel

template <class E>
struct DoArgs {
  const E* h;         // (B, H, W, C)
  const E* go;        // (B, H, W, C)
  const E* att;       // (B, H, W, G)
  const E* attw;      // (B, G) or null
  const E* w;         // (9 * C / G, C * G), columns permuted in each tile
  const E* bias;      // (C * G), permuted alike
  const E* a;         // (B, C) or null
  const E* t;
  E* dout;            // (B, H, W, C) do
  float* aa;          // (B, H, W, G) att * attw, written when attw (bf16:
                      // always)
  E* datt;            // (B, H, W, G), written whole
  float* dattw_ws;    // (B, ntp, G) per-tile sums of dattw, or null
  ucdir::Geom g;      // g.C = C, g.cin = C / G
  int ntn;            // column tiles of C * G, all walked by each block
  int ntp;            // pixel tiles of an image
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
template <class T, class E>
__device__ __forceinline__ void do_epilogue(float (&acc)[T::TM][T::TN],
                                            const DoArgs<E>& c, int b, int m0,
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
    bj[j] = Elem<E>::ld(c.bias + n0 + pc::tile_col<T>(tn, j));
    awj[j] = c.attw ? Elem<E>::ld(c.attw + b * G + j) : 1.f;
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
    float at[G];
    Elem<E>::ld4(*reinterpret_cast<float(*)[4]>(at), c.att + pix * G);
    Elem<E>::ld4(*reinterpret_cast<float(*)[4]>(at + 4), c.att + pix * G + 4);
    float A[G], z[G];
    float o = 0.f;
    float d;
    if constexpr (Elem<E>::kLow) {
      // m = z * A in bf16: both rounded, their (exact) product rounded;
      // two candidates at a time (one conversion, one bf16x2 product)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        A[j] = at[j] * awj[j];
        z[j] = acc[i][j] + bj[j];
      }
#pragma unroll
      for (int j = 0; j < G; j += 2) {
        const float m = Elem<E>::mul2(Elem<E>::pack2(z[j], z[j + 1]),
                                      Elem<E>::pack2(A[j], A[j + 1]));
        o += Elem<E>::lof(m);
        o += Elem<E>::hif(m);
      }
      d = Elem<E>::rnd(Elem<E>::ldg(c.go + pix * C + ch) * ucdir::dswishf(o));
      Elem<E>::st(c.dout + pix * C + ch, d);
      // the datt terms d * z, each rounded
#pragma unroll
      for (int j = 0; j < G; j += 2) {
        const float q = Elem<E>::pack2(__fmul_rn(d, z[j]),
                                       __fmul_rn(d, z[j + 1]));
        acc[i][j] = Elem<E>::lof(q);
        acc[i][j + 1] = Elem<E>::hif(q);
      }
    } else {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        A[j] = at[j] * awj[j];
        z[j] = acc[i][j] + bj[j];
        o += z[j] * A[j];
      }
      d = __ldg(c.go + pix * C + ch) * ucdir::dswishf(o);
      c.dout[pix * C + ch] = d;
#pragma unroll
      for (int j = 0; j < G; ++j) acc[i][j] = d * z[j];
    }
    if ((Elem<E>::kLow || c.attw != nullptr) && n0 == 0 && tn == 0) {
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
// has the same bits from run to run), and its pixels' dattw terms, which it
// adds in ascending pixel order into its row of the dattw workspace.
template <class T, class E>
__global__ void __launch_bounds__(T::NT) akgm_do_kernel(DoArgs<E> c) {
  static_assert(2 * T::A_WORDS >= T::BM * G, "dattw terms fit the stages");
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
    static_assert(CNT % G == 0 || G % CNT == 0, "a lane's sums are rows");
    float qs[CNT];
#pragma unroll
    for (int e = 0; e < CNT; ++e) qs[e] = 0.f;
    for (int nt = 0; nt < c.ntn; ++nt) {
      float acc[T::TM][T::TN];
      pc::consume<T>(acc, smem, nk);
      do_epilogue<T, E>(acc, c, b, m0, nt * T::BN, qs);
    }
    // lane's sums: flat indices off .. off + CNT - 1 of its row of
    // threads' (TM, G) terms, whole rows where CNT >= G
    const int off = butterfly_offset<T::TM * G, T::NCX>(threadIdx.x & 31);
    const int tm = threadIdx.x / T::NCX;
    const int P = c.g.H * c.g.W;
    float* terms = smem;  // (BM, G); the stages are free after the product
#pragma unroll
    for (int e = 0; e < CNT; ++e) {
      const int i = (off + e) / G;
      const int j = (off + e) % G;
      const int m = pc::tile_row<T>(tm, i);
      float term = 0.f;
      if (m0 + m < P) {
        const int64_t pix = (int64_t)b * P + m0 + m;
        const float aw = c.attw ? Elem<E>::ldg(c.attw + b * G + j) : 1.f;
        Elem<E>::st(c.datt + pix * G + j, qs[e] * aw);
        term = qs[e] * Elem<E>::ldg(c.att + pix * G + j);
      }
      terms[m * G + j] = term;
    }
  }
  if (c.dattw_ws == nullptr) return;
  pc::block_sync<T::NT>();
  if (threadIdx.x < G) {
    float v = 0.f;
    for (int m = 0; m < T::BM; ++m) v += smem[m * G + threadIdx.x];
    c.dattw_ws[((int64_t)b * c.ntp + blockIdx.x) * G + threadIdx.x] = v;
  }
}

// dattw (B, G) from the (B, ntp, G) per-tile terms: lane l of warp j adds
// the tiles [l * run, (l + 1) * run) of candidate j in ascending order, run =
// ceil(ntp / 32), then lane 0 adds the 32 runs in ascending order and rounds
// the sum to E once; one block per image.
template <class E>
__global__ void __launch_bounds__(32 * G)
    dattw_reduce_kernel(const float* __restrict__ ws, E* __restrict__ dattw,
                        int ntp) {
  __shared__ float part[G][32];
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int run = (ntp + 31) / 32;
  const int t1 = min(ntp, (lane + 1) * run);
  float s = 0.f;
  for (int tile = lane * run; tile < t1; ++tile)
    s += __ldg(ws + ((int64_t)b * ntp + tile) * G + j);
  part[j][lane] = s;
  __syncthreads();
  if (lane != 0) return;
  float S = 0.f;
  for (int k = 0; k < 32; ++k) S += part[j][k];
  Elem<E>::st(dattw + b * G + j, S);
}

template <class E>
struct DhArgs {
  const E* dout;      // (B, H, W, C) do
  const float* aa;    // (B, H, W, G) att * attw
  const E* wf;        // (G, 9 * C, C / G)
  E* dhh;             // (B, H, W, C)
  ucdir::Geom g;      // g.C = C, g.cin = C (a group's dz columns), g.K = 9 C
  int ntn;
};

// dhh of one group: the group's dz (C columns) convolved with its flipped,
// transposed weights (9 * C, C / G); blockIdx.y is the group
template <class T, class E>
__global__ void __launch_bounds__(T::NT) akgm_dh_kernel(DhArgs<E> c) {
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
  pc::OperandsT<E> op;
  op.xb = c.dout + b * P * C + group * cg;
  op.ab = op.tb = nullptr;
  op.att = c.aa + b * P * G;
  op.w = c.wf + (int64_t)group * c.g.K * cg;
  op.ncols = cg;
  op.vec_a = true;
  op.vec_w = cg % 4 == 0;
  const int nk = pc::igemm_setup<T>(smem, c.g, m0);
  if (threadIdx.x >= T::NC) {
    pc::produce<T, pc::Dz, E>(smem, op, c.g, n0, nk);
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
    E* row = c.dhh + (b * P + p) * C + group * cg;
#pragma unroll
    for (int g = 0; g < T::NG; ++g) {
      const int n = n0 + pc::tile_col<T>(tn, T::GW * g);
      const float* v = &acc[i][T::GW * g];
      if (cg % T::GW == 0 && n + T::GW <= cg) {
        if constexpr (T::GW == 4)
          Elem<E>::st4(row + n, *reinterpret_cast<const float(*)[4]>(v));
        else
          Elem<E>::st2(row + n, v[0], v[1]);
      } else {
#pragma unroll
        for (int j = 0; j < T::GW; ++j)
          if (n + j < cg) Elem<E>::st(row + n + j, v[j]);
      }
    }
  }
}

template <class T, class E>
int launch_do(DoArgs<E> c, E* dattw, int B, cudaStream_t st) {
  const int P = c.g.H * c.g.W;
  c.ntn = c.g.C * G / T::BN;  // T::BN divides C
  c.ntp = (P + T::BM - 1) / T::BM;
  akgm_do_kernel<T, E><<<dim3(c.ntp, 1, B), T::NT, T::SMEM_BYTES, st>>>(c);
  if (c.dattw_ws != nullptr) {
    const int err = (int)cudaGetLastError();
    if (err) return err;
    dattw_reduce_kernel<E><<<B, 32 * G, 0, st>>>(c.dattw_ws, dattw, c.ntp);
  }
  return (int)cudaGetLastError();
}

// z recompute and do on K1's tile for C (akgm_tail.cu launch)
template <class E>
int launch_do_for(DoArgs<E> c, E* dattw, int B, cudaStream_t st) {
  const int C = c.g.C;
  if (C % 128 == 0) return launch_do<pc::Wide>(c, dattw, B, st);
  if (C % 64 == 0) return launch_do<pc::Mid>(c, dattw, B, st);
  if (C % 32 == 0) return launch_do<pc::Thin<32>>(c, dattw, B, st);
  if (C % 16 == 0) return launch_do<pc::Thin<16>>(c, dattw, B, st);
  return launch_do<pc::Thin<8>>(c, dattw, B, st);
}

template <class T, class E>
int launch_dh(DhArgs<E> c, int B, cudaStream_t st) {
  const int P = c.g.H * c.g.W;
  const int cg = c.g.C / G;
  c.ntn = (cg + T::BN - 1) / T::BN;
  akgm_dh_kernel<T, E><<<dim3(((P + T::BM - 1) / T::BM) * c.ntn, G, B), T::NT,
                      T::SMEM_BYTES, st>>>(c);
  return (int)cudaGetLastError();
}

// h, go, dout, dhh (B, H, W, C) NHWC; att, datt (B, H, W, 8); attw, dattw
// (B, 8) or both null; w (9 * C/8, 8 * C) as in ucdir_akgm_tail and bias
// (8 * C), both with the columns of every tile of the width ops/akgm.py
// tail_tile gives (128, 64, 32, 16 or 8) permuted so that physical column
// h * bn / 2 + 4 * i + r holds logical column 8 * i + 4 * h + r; wf (8, 9 *
// C, C/8) with wf[g][tap * C + nl][ci] = w[(8 - tap) * C/8 + ci][g * C + nl]
// (unpermuted); a, t (B, C) or null. dout is scratch, aa a float (B, H, W, 8)
// scratch used with attw (bf16: always); datt, dattw, dw (9 * C/8, 8 * C)
// and dbias (8 * C), unpermuted, are written whole; ws is a float (splits,
// 9 * C/8 + 1, 8 * C) workspace and wsa, with attw, a float (B, ceil(H * W /
// bm), 8) one, bm the tile's pixels (128, or 256 at 64 columns). C must be a
// multiple of 8. Returns the first launch error as a cudaError_t.
template <class E>
int akgm_tail_bwd(const E* h, const E* go, const E* att, const E* attw,
                  const E* w, const E* wf, const E* bias, const E* a,
                  const E* t, E* dout, float* aa, E* dhh, E* datt, E* dw,
                  E* dbias, E* dattw, float* ws, float* wsa, int B, int H,
                  int W, int C, int splits, void* stream) {
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
  DoArgs<E> d = {};
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
  d.dattw_ws = dattw ? wsa : nullptr;
  d.g = g;
  constexpr uintptr_t run = 4 * sizeof(E);  // a 4-wide load
  d.vec_a = cg % 4 == 0 && pc::aligned(h, run) &&
            (a == nullptr || (pc::aligned(a, run) && pc::aligned(t, run)));
  int err = launch_do_for(d, dattw, B, st);
  if (err) return err;
  // A: the float32 att * attw (bf16: always the scratch; float32 without
  // attw: att itself)
  const float* A;
  if constexpr (Elem<E>::kLow) {
    A = aa;
  } else {
    A = attw ? aa : att;
  }
  pc::WgradArgsT<E> wa = {};
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
  DhArgs<E> dh = {};
  dh.dout = dout;
  dh.aa = A;
  dh.wf = wf;
  dh.dhh = dhh;
  dh.g = g;  // a group's transposed conv: C dz columns per tap
  dh.g.cin = C;
  dh.g.K = 9 * C;
  if (cg <= 8) return launch_dh<pc::Narrow>(dh, B, st);
  if (cg <= 16) return launch_dh<pc::N16>(dh, B, st);
  if (cg <= 32) return launch_dh<pc::N32>(dh, B, st);
  return launch_dh<pc::Mid>(dh, B, st);
}

}  // namespace

extern "C" int ucdir_akgm_tail_bwd(const float* h, const float* go,
                                   const float* att, const float* attw,
                                   const float* w, const float* wf,
                                   const float* bias, const float* a,
                                   const float* t, float* dout, float* aa,
                                   float* dhh, float* datt, float* dw,
                                   float* dbias, float* dattw, float* ws,
                                   float* wsa, int B, int H, int W, int C,
                                   int splits, void* stream) {
  return akgm_tail_bwd(h, go, att, attw, w, wf, bias, a, t, dout, aa, dhh,
                       datt, dw, dbias, dattw, ws, wsa, B, H, W, C, splits,
                       stream);
}

// The same in bf16: every operand and output bf16 but the float scratch aa
// (always given) and the float workspaces ws and wsa.
extern "C" int ucdir_akgm_tail_bwd_bf16(
    const bf16* h, const bf16* go, const bf16* att, const bf16* attw,
    const bf16* w, const bf16* wf, const bf16* bias, const bf16* a,
    const bf16* t, bf16* dout, float* aa, bf16* dhh, bf16* datt, bf16* dw,
    bf16* dbias, bf16* dattw, float* ws, float* wsa, int B, int H, int W,
    int C, int splits, void* stream) {
  return akgm_tail_bwd(h, go, att, attw, w, wf, bias, a, t, dout, aa, dhh,
                       datt, dw, dbias, dattw, ws, wsa, B, H, W, C, splits,
                       stream);
}
