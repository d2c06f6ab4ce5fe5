// K9: the group-packed AKGM block tail,
//   A[p][j] = att[p][j] * attw[j]
//   out[p][i] = swish(sum_{tap, c} (h * a + t)[p + tap][c] * A[p][c / (C/G)]
//                                  * Wp[tap * C + c][i]
//                     + sum_j A[p][j] * bias[i * G + j]) + res[p][i],
// with Wp (9 * C, C) the grouped kernel repacked: row tap * C + j * (C/G) + cg,
// column i, value kernel[tap][cg][i * G + j]. The attention of the OUTPUT
// pixel scales the input channels by their group before a dense 9C -> C
// product. This pairs candidate j of every output channel with input group
// j; the reference network pairs all candidates of channel i with input group
// i / (C/G) (akgm_tail.cu). The two are different networks; this form is kept
// so that the packing study stays answerable on both packages.
//
// Replaces the TPU kernel B1p (ucdir_tpu/ops/akgm_pallas.py
// _akgm_block_forward_packed). The TPU kernel scaled an im2col scratch row by
// the expanded attention and got the folded shift from a ring of -t / a and
// a correction matrix. Here it is K2's dense implicit GEMM on the
// producer/consumer core (igemm_pc.cuh), with:
// - the staging pc::AttScaled: the producers apply the affine, mask the
//   border (so it is the affine's exact 0), then multiply by the pixel's A
//   of the column's input group. A thread's 4 columns are a 16-byte run of
//   channels whose groups are carried by additions as the tap and the
//   channel advance (a run crosses a group where C / G is not a multiple of
//   4); A of the block's pixels sits in shared memory, staged by the whole
//   block before the product;
// - the epilogue's other operands in shared memory: the producers copy the
//   tile's (BN, G) bias slice and its residual with cp.async in the first
//   iteration of the product and wait for them in the last, so the copies
//   ride under the product;
// - the expression order of the kernel this one replaced: (affine -> mask) *
//   A staged, one fmaf chain in ascending k, then v = fmaf(A[j], bias[n * G +
//   j], v) for j = 0..7, swish, + residual, 16-byte stores: the same bits.
// The tile follows C as K2's follows cout: 128 x 128 (with 8 producer warps)
// from C = 128, 256 x 64 from 64, 128 pixels by 32, 16 or 8 columns below.
// Bound: fp32 FMA issue: 2 * 9 * C * C FLOP per pixel against 4 * (3 * C +
// 8) bytes, the same count as K1's per-group product (the TPU kernel saved
// 8x only against its own densified weights).
//
// K9 in bf16 (ucdir_akgm_packed_bf16) replaces B1p's bf16 instantiation and
// runs on the tensor cores of igemm_tc.cuh: K2's bf16 3x3 product (one
// group, 9C -> C, the weights by TMA from C = 16, tiles of 8 x 16 output
// pixels by 128 or 64 columns, 8 below), with
// - the staging tc::AttMul: the producers stage each 64-channel chunk's halo
//   as it is, the ring bf16(-t / a) outside the image under the fold (the
//   wrapper's ops/akgm.py packed_ring; 0 without it), and multiply each
//   tap's run of 8 channels, as they copy it out of the halo, by the output
//   pixel's mult = att * attw * a of the channels' groups, rounded once, the
//   product rounded (mul.rn.bf16x2): B1p's staged scratch row;
// - the epilogue packed_epilogue on the accumulator fragments: + the
//   attention's bias term sum_j bf16(att * attw)[j] * bm[n][j] in float32,
//   bm the wrapper's (B, C, 8) bias matrix under the fold's shift
//   (ops/akgm.py packed_bias, B1p's bm), swish, + the residual, rounded
//   once, stored a pair of columns a lane.
// Bound: bf16 FLOP at 989 TFLOP/s on the tensor cores (2 * 9 * C * C + 16 C
// a pixel), or at C = 64 the bytes at 3.35 TB/s (h, att, res, out: 6 C + 16
// bytes a pixel). What it does about that bound: the product on the tensor
// cores, every input value loaded once a tile and chunk (the halo), the
// scale applied in the copy that K2 makes anyway.
#include "igemm_tc.cuh"

namespace {

namespace pc = ucdir::pc;
constexpr int G = 8;  // candidates per channel, input groups

// 128 x 128 with 8 producer warps: the staging scales every value, and with
// pc::Wide's 4 the producers bound the product (12% slower at C >= 128).
using Wide = pc::Tile<128, 128, 8, 8, 16, 8>;

struct PackedArgs {
  const float* h;     // (B, H, W, C)
  const float* att;   // (B, H, W, G)
  const float* attw;  // (B, G) or null
  const float* w;     // (9 * C, C)
  const float* bias;  // (C * G)
  const float* res;   // (B, H, W, C)
  const float* a;     // (B, C) or null
  const float* t;
  float* out;         // (B, H, W, C)
  ucdir::Geom g;      // g.C = g.cin = C, g.K = 9 * C
  int ntn;            // column tiles; blockIdx.x = pixel tile * ntn + column
  bool vec_a;
};

// Shared memory past the tile's own, in words: the block's (BM, G) A, the
// tile's (BN, G) bias slice and its (BM, BN) residual in rows of RS words.
template <class T>
struct Layout {
  static constexpr int RS = T::BN + 4;
  static constexpr int ATT = T::ORG + 2 * T::BM;
  static constexpr int BIAS = ATT + T::BM * G;
  static constexpr int RES = BIAS + T::BN * G;
  static constexpr int BYTES = 4 * (RES + T::BM * RS);
  static_assert(ATT % 4 == 0 && BIAS % 4 == 0 && RES % 4 == 0 && RS % 4 == 0,
                "16-byte rows");
  static_assert(BYTES <= 227 * 1024, "shared memory of a block");
};

// The producers' copies of the tile's bias slice and residual (zeros past
// the image's pixels and past C), issued in iteration 0 of the product and
// awaited in its last.
template <class T>
struct CopyOperands {
  const PackedArgs* c;
  float* smem;
  int b, m0, n0, nk;

  __device__ __forceinline__ void operator()(int i) const {
    using L = Layout<T>;
    if (i == 0) {
      const int tid = threadIdx.x - T::NC;
      const int C = c->g.C;
      const int P = c->g.H * c->g.W;
      for (int u = tid; u < T::BN * G / 4; u += T::NP) {
        const int e = n0 * G + 4 * u;  // C * G % 4 == 0: whole runs
        pc::cp_async16(smem + L::BIAS + 4 * u, c->bias + (e < C * G ? e : 0),
                       e < C * G);
      }
      constexpr int Q = T::BN / 4;  // 16-byte runs of a row
      for (int u = tid; u < T::BM * Q; u += T::NP) {
        const int m = u / Q, n = n0 + 4 * (u % Q);
        const bool in = m0 + m < P && n < C;  // C % 4 == 0
        pc::cp_async16(smem + L::RES + m * L::RS + 4 * (u % Q),
                       in ? c->res + ((int64_t)b * P + m0 + m) * C + n
                          : c->res,
                       in);
      }
    }
    if (i == nk - 1) pc::cp_async_wait_all();
  }
};

// The consumers' epilogue: a thread's TM rows and TN columns, from shared
// memory only.
template <class T>
__device__ __forceinline__ void packed_epilogue(
    const float (&acc)[T::TM][T::TN], const PackedArgs& c, const float* smem,
    int b, int m0, int n0) {
  static_assert(T::GW == 4, "16-byte groups of columns");
  using L = Layout<T>;
  const int tn = threadIdx.x % T::NCX;
  const int tm = threadIdx.x / T::NCX;
  const int C = c.g.C;
  const int P = c.g.H * c.g.W;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = pc::tile_row<T>(tm, i);
    if (m0 + m >= P) continue;
    const float4 a0 = *reinterpret_cast<const float4*>(smem + L::ATT + m * G);
    const float4 a1 =
        *reinterpret_cast<const float4*>(smem + L::ATT + m * G + 4);
    const float ap[G] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float* orow = c.out + ((int64_t)b * P + m0 + m) * C + n0;
#pragma unroll
    for (int g = 0; g < T::NG; ++g) {
      const int nl = pc::tile_col<T>(tn, 4 * g);
      if (n0 + nl >= C) continue;  // C % 4 == 0: the group is in or out
      const float4 r =
          *reinterpret_cast<const float4*>(smem + L::RES + m * L::RS + nl);
      const float rv[4] = {r.x, r.y, r.z, r.w};
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* bp = smem + L::BIAS + (nl + q) * G;
        const float4 b0 = *reinterpret_cast<const float4*>(bp);
        const float4 b1 = *reinterpret_cast<const float4*>(bp + 4);
        const float bj[G] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float x = acc[i][4 * g + q];
#pragma unroll
        for (int j = 0; j < G; ++j) x = fmaf(ap[j], bj[j], x);
        v[q] = ucdir::swishf(x) + rv[q];
      }
      *reinterpret_cast<float4*>(orow + nl) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
    }
  }
}

// One BM x BN tile of image blockIdx.z.
template <class T>
__global__ void __launch_bounds__(T::NT) akgm_packed_kernel(PackedArgs c) {
  using L = Layout<T>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int mt = blockIdx.x / c.ntn;
  const int m0 = mt * T::BM;
  const int n0 = (blockIdx.x - mt * c.ntn) * T::BN;
  const int C = c.g.C;
  const int P = c.g.H * c.g.W;
  // A of the block's pixels, by the whole block: igemm_setup's barrier
  // publishes it
  for (int e = threadIdx.x; e < T::BM * G; e += T::NT) {
    const int p = m0 + e / G;
    const int j = e % G;
    smem[L::ATT + e] = p < P ? c.att[((int64_t)b * P + p) * G + j] *
                                   (c.attw ? c.attw[b * G + j] : 1.f)
                             : 0.f;
  }
  const int nk = pc::igemm_setup<T>(smem, c.g, m0);
  if (threadIdx.x >= T::NC) {
    pc::Operands op;
    op.xb = c.h + (int64_t)b * P * C;
    op.ab = c.a ? c.a + (int64_t)b * C : nullptr;
    op.tb = c.t ? c.t + (int64_t)b * C : nullptr;
    op.att = nullptr;
    op.ascale = smem + L::ATT;
    op.w = c.w;
    op.ncols = C;
    op.cg = C / G;
    op.vec_a = c.vec_a;
    op.vec_w = true;
    pc::produce<T, pc::AttScaled>(smem, op, c.g, n0, nk,
                                  CopyOperands<T>{&c, smem, b, m0, n0, nk});
  } else {
    float acc[T::TM][T::TN];
    pc::consume<T>(acc, smem, nk);
    packed_epilogue<T>(acc, c, smem, b, m0, n0);
  }
}

template <class T>
int launch_tile(PackedArgs c, int B, cudaStream_t st) {
  constexpr int bytes = Layout<T>::BYTES;
  if (bytes > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        akgm_packed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err) return err;
  }
  const int P = c.g.H * c.g.W;
  c.ntn = (c.g.C + T::BN - 1) / T::BN;
  akgm_packed_kernel<T><<<dim3((unsigned)((P + T::BM - 1) / T::BM) * c.ntn,
                               1, B),
                          T::NT, bytes, st>>>(c);
  return (int)cudaGetLastError();
}

namespace tc = ucdir::tc;
using ucdir::bf16;

// K9 bf16's epilogue operands: att, attw as the staging reads them; bm the
// (B, C, 8) bias matrix, a column's 8 values one 16-byte run; res (B, H, W,
// C).
struct PackedTcArgs {
  const bf16* att;
  const bf16* attw;
  const bf16* bm;
  const bf16* res;
};

// The epilogue on the fragments: thread (warp w, lane l) holds rows 16 w +
// l / 4 and + 8 of the tile and columns 8 j + 2 (l % 4) and + 1. C % 8 ==
// 0: a pair of columns is in or out.
template <class T>
__device__ __forceinline__ void packed_epilogue(const float (&acc)[T::BN / 2],
                                                const tc::TcArgs& p,
                                                const PackedTcArgs& e,
                                                const tc::TilePos& q) {
  using EB = ucdir::Elem<bf16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = p.g.Ho, W = p.g.Wo, C = p.cout;
  float aw[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    aw[j] = e.attw != nullptr ? EB::ldg(e.attw + q.b * G + j) : 1.f;
  int64_t pix[2];
  bool in[2];
  float A[2][G];  // att * attw rounded, as the bias term takes it
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + (lane >> 2) + 8 * r;
    const int y = q.oy0 + row / p.tw, x = q.ox0 + row % p.tw;
    in[r] = y < H && x < W;
    pix[r] = ((int64_t)q.b * H + y) * W + x;
    const uint4 u = tc::load16(in[r] ? e.att + pix[r] * G : e.att);
    const uint32_t uw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < G; ++j)
      A[r][j] = EB::rnd(((j & 1) ? EB::hi(uw[j / 2]) : EB::lo(uw[j / 2])) *
                        aw[j]);
  }
#pragma unroll
  for (int j = 0; j < T::BN / 8; ++j) {
    const int n = q.n0 + 8 * j + 2 * (lane & 3);
    if (n >= C) continue;
    const uint4 u0 = tc::load16(e.bm + ((int64_t)q.b * C + n) * G);
    const uint4 u1 = tc::load16(e.bm + ((int64_t)q.b * C + n + 1) * G);
    const uint32_t w0[4] = {u0.x, u0.y, u0.z, u0.w};
    const uint32_t w1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!in[r]) continue;
      float t0 = 0.f, t1 = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        t0 = fmaf(A[r][g], (g & 1) ? EB::hi(w0[g / 2]) : EB::lo(w0[g / 2]),
                  t0);
        t1 = fmaf(A[r][g], (g & 1) ? EB::hi(w1[g / 2]) : EB::lo(w1[g / 2]),
                  t1);
      }
      const uint32_t rw = __ldg(reinterpret_cast<const unsigned int*>(
          e.res + pix[r] * C + n));
      const float v0 = ucdir::swishf(acc[4 * j + 2 * r] + t0) + EB::lo(rw);
      const float v1 =
          ucdir::swishf(acc[4 * j + 2 * r + 1] + t1) + EB::hi(rw);
      *reinterpret_cast<float*>(p.out + pix[r] * C + n) = EB::pack2(v0, v1);
    }
  }
}

// A persistent block walks tiles blockIdx.x, + gridDim.x, ... of the
// (B, ntp, ntn) grid, as conv_tc_kernel, with AttMul's producers and
// packed_epilogue.
template <class T, bool BT>
__global__ void __launch_bounds__(T::NT, 1)
    packed_tc_kernel(const tc::TcArgs p, const PackedTcArgs e,
                     const __grid_constant__ CUtensorMap mb) {
  extern __shared__ uint8_t smem_raw[];
  const tc::Ring<T> ring(smem_raw);
  if (threadIdx.x == 0) ring.init(T::PW + (BT ? 1 : 0));
  __syncthreads();
  if (threadIdx.x >= T::NC) {
    if constexpr (T::PREG != 128) tc::setmaxnreg_inc<T::PREG>();
    tc::produce<T, tc::AttMul, BT, false, false>(p, &mb, &mb, ring);
    return;
  }
  if constexpr (T::CREG != 128) tc::setmaxnreg_dec<T::CREG>();
  int s = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, s += p.nk) {
    float acc[T::BN / 2];
    tc::consume<T, BT>(acc, ring, s, p.nk);
    packed_epilogue<T>(acc, p, e, tc::tile_pos<false>(p, t));
  }
}

template <class T, bool BT>
int launch_packed_tc(tc::TcArgs c, const PackedTcArgs& e, int B,
                     cudaStream_t st) {
  CUtensorMap ma, mb;
  int blocks = 0;
  int err = tc::tile_grid<T, BT, false>(c, B, &ma, &mb);
  if (!err) err = tc::grid_blocks(c.tiles, &blocks);
  if (!err) err = tc::set_smem<packed_tc_kernel<T, BT>>(T::SMEM);
  if (err) return err;
  packed_tc_kernel<T, BT><<<blocks, T::NT, T::SMEM, st>>>(c, e, mb);
  err = (int)cudaGetLastError();
  if (err) return err;
  ++tc::launch_count(tc::TC_AKGM_PACKED);
  return 0;
}

int packed_tc(const bf16* h, const bf16* att, const bf16* attw,
              const bf16* w, const bf16* bm, const bf16* res, const bf16* a,
              const bf16* ring, bf16* out, int B, int H, int W, int C,
              cudaStream_t st) {
  tc::TcArgs c = {};
  c.x = h;
  c.w = w;
  c.a = a;
  c.t = ring;
  c.out = out;
  c.g.H = c.g.Ho = H;
  c.g.W = c.g.Wo = W;
  c.g.C = C;
  c.g.ks = 3;
  c.g.stride = 1;
  c.g.cin = C;
  c.g.K = 9 * C;
  c.cout = C;
  c.patt = att;
  c.pattw = attw;
  const tc::Route r = tc::plan(c, B, false);
  // AttMul runs on the halo's vector path: 16-byte runs of every operand
  if (!c.halo || !pc::aligned(att, 16) || !pc::aligned(bm, 16) ||
      !pc::aligned(res, 4) || !pc::aligned(out, 4))
    return (int)cudaErrorMisalignedAddress;
  const PackedTcArgs e = {att, attw, bm, res};
  if (r.bn == 8) return launch_packed_tc<tc::Tile<8>, false>(c, e, B, st);
  if (r.bn == 128) return launch_packed_tc<tc::Tile<128>, true>(c, e, B, st);
  return launch_packed_tc<tc::Tile<64>, true>(c, e, B, st);
}

}  // namespace

// h, res, out (B, H, W, C) NHWC; att (B, H, W, 8); attw (B, 8) or null;
// w (9 * C, C) packed as above; bias (8 * C); a, t (B, C) or null. C must be
// a multiple of 8; w, bias and res 16-byte aligned (cudaErrorMisalignedAddress
// otherwise). Returns the launch's cudaError_t.
extern "C" int ucdir_akgm_packed(const float* h, const float* att,
                                 const float* attw, const float* w,
                                 const float* bias, const float* res,
                                 const float* a, const float* t, float* out,
                                 int B, int H, int W, int C, void* stream) {
  if (!pc::aligned(w, 16) || !pc::aligned(bias, 16) || !pc::aligned(res, 16) ||
      !pc::aligned(out, 16))
    return (int)cudaErrorMisalignedAddress;
  PackedArgs c = {};
  c.h = h;
  c.att = att;
  c.attw = attw;
  c.w = w;
  c.bias = bias;
  c.res = res;
  c.a = a;
  c.t = t;
  c.out = out;
  c.g.H = H;
  c.g.W = W;
  c.g.C = C;
  c.g.Ho = H;
  c.g.Wo = W;
  c.g.ks = 3;
  c.g.stride = 1;
  c.g.cin = C;
  c.g.K = 9 * C;
  c.vec_a = pc::aligned(h, 16) &&
            (a == nullptr || (pc::aligned(a, 16) && pc::aligned(t, 16)));
  cudaStream_t st = (cudaStream_t)stream;
  if (C >= 128) return launch_tile<Wide>(c, B, st);
  if (C >= 64) return launch_tile<pc::Mid>(c, B, st);
  if (C >= 32) return launch_tile<pc::Thin<32>>(c, B, st);
  if (C >= 16) return launch_tile<pc::Thin<16>>(c, B, st);
  return launch_tile<pc::Thin<8>>(c, B, st);
}

// K9 in bf16 on the tensor cores: every operand and out bf16; w (9 * C, C)
// packed as above; bm (B, C, 8) the bias matrix (ops/akgm.py packed_bias,
// transposed); a (B, C) the fold's scale and ring (B, C) its border value
// bf16(-t / a), or both null. C must be a multiple of 8; h, a, ring, att and
// bm 16-byte aligned (cudaErrorMisalignedAddress otherwise).
extern "C" int ucdir_akgm_packed_bf16(const bf16* h, const bf16* att,
                                      const bf16* attw, const bf16* w,
                                      const bf16* bm, const bf16* res,
                                      const bf16* a, const bf16* ring,
                                      bf16* out, int B, int H, int W, int C,
                                      void* stream) {
  return packed_tc(h, att, attw, w, bm, res, a, ring, out, B, H, W, C,
                   (cudaStream_t)stream);
}
