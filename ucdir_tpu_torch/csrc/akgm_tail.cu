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
// It runs the group's true (9 * C/G) x (C) product (no 8x densified
// weights), and each consumer thread's 8 columns are one channel's
// candidates, so the mix, swish, residual and statistics happen in registers
// and the (B, H, W, C * G) candidate tensor never exists.
//
// K8: the mix alone,
//   out[c] = sum_j (gconv3x3(h) + bias)[c * G + j] * att[j],
// the same product with a plain epilogue: no fold, no attw, no swish, no
// residual, no statistics. Replaces the TPU kernel B10
// (ucdir_tpu/ops/akgm_pallas.py _akgm_forward, which densified the grouped
// weights 8x and summed the candidates with a selection matmul).
//
// In float32 both run on the producer/consumer core of igemm_pc.cuh, K5's
// z recompute's product (akgm_tail_bwd.cu):
// - The wrapper permutes the weights' columns within each column tile
//   (ops/akgm.py tile_columns), so that a consumer thread's two groups of 4
//   columns, half a tile apart, are one channel's candidates 0..7. The bias
//   is read in its own order.
// - Every output is one accumulator over ascending k with fmaf, and the
//   epilogue adds mix += (acc + b_j) * (att_j * attw_j) for j = 0..7, then
//   swish, then the residual: the bits of the single-role fp32 kernel that
//   this one replaced.
// - The tile follows the group's width C: 128 x 128 where C % 128 == 0, 256
//   x 64 where C % 64 == 0, else 128 pixels by the widest of 32, 16 and 8
//   columns that divides C, with one channel per consumer thread. A tile
//   lies in one group.
// - A block walks up to 8 column tiles of its pixel tile
//   (pc::grouped_produce): the producers load and store the next tile's
//   first two slices while the consumers run the epilogue. At C = 64 the
//   product is only 9 * 8 = 72 deep (5 slices), so a block per tile would
//   fill and drain its pipeline about as long as it multiplies. (One
//   pipeline across the tiles, the next tile's loads in flight during the
//   last slices of this one, measured slower: PERF.md §6.)
// - The epilogue reads shared memory only: the producers stage att * attw
//   of the block's pixels once, and the bias and the residual of the next
//   column tile (double-buffered) while the consumers multiply this one, so
//   no global load's latency falls between two products.
// - Statistics in a fixed order, no atomics: per column tile the lanes that
//   hold one channel add their rows with shuffles, each warp's sums go to
//   shared memory, and at the end of the block they are added in warp order
//   and stored plainly into a (B, pixel tiles, 2, C) workspace;
//   stats_reduce_kernel adds the tiles in a fixed order. The sums have the
//   same bits from call to call.
// Bound: fp32 FMA issue at 2 * 9 * C/G * C * G FLOP per pixel.
//
// K1 in bf16 (ucdir_akgm_tail_bf16) replaces B1's bf16 instantiation
// (validation and training under --compute_dtype bf16) and runs on the
// tensor cores of igemm_tc.cuh instead: K5's bf16 z recompute
// (akgm_tail_bwd.cu) run forward, gconv_tc_kernel's grouped 3x3 product
// over the folded input, h * a then + t each rounded to bf16 as the
// producers stage it (pc::Affine), with tc::TailEpi as its epilogue.
// - The weights in natural column order (c * 8 + j): a channel's 8
//   candidates are one 8-column slab of wgmma's accumulator, 2 on each lane
//   of a quad, so no permutation; groups below 8 channels (C < 64) merged
//   m at a time into groups of a multiple of 8 channels with block-diagonal
//   weights (ops/akgm.py tc_merged_weights), so that every C % 8 == 0 takes
//   the vector staging (flat slices below 64 channels a group).
// - The epilogue rounds where B1 rounds in bf16: att * attw; each candidate
//   z = acc + b_j, then z * A; the mix of the 8 rounded terms ((m0 + m1) +
//   (m2 + m3)) + ((m4 + m5) + (m6 + m7)) by two quad shuffles, swish and the
//   residual in float, the output rounded once and stored 16 bytes a run.
//   The residual and the bias are loaded before the tile's product.
// - Statistics in a fixed order, no atomics: per channel over the tile's
//   128 rows (a lane's 2, the warp's 8 quads by shuffles, the 8 warps in
//   warp order), stored plainly into a (B, 8 x 16 pixel tiles, 2, C)
//   workspace, then stats_reduce_kernel (tile_sums.cuh) over the tiles.
// - z is the tensor core's own sum over all of K, on 128-column tiles: K5's
//   per-slice sum (consume_promoted), which caps the tile at 64 columns,
//   measured 1.2x to 1.3x slower at C >= 128 (PERF.md §6).
// Bound: bf16 FLOP at 989 TFLOP/s on the tensor cores (2 * 9 * C/G * C * G
// a pixel), or at C = 64 the bytes at 3.35 TB/s (h, att, res, out: 6 C + 16
// bytes a pixel). What it does about that bound: no candidate tensor, every
// operand read once per tile, the product on the tensor cores, and at C =
// 64 (K = 72, two flat slices a tile) the epilogue's shuffles shared by a
// quad's 4 slabs.
//
// K8 in bf16 (ucdir_akgm_mix_bf16) replaces B10's bf16 instantiation and is
// K1 bf16's product (the same merged groups and tiles, the input staged as
// it is: pc::Raw) with MixOutEpi as its epilogue, which rounds where B10
// rounds: nowhere but the output. Per slab and row each candidate z = acc +
// b_j in float32, times att_j (a bf16 value) in float32, the 8 terms over
// the quad by two shuffles, and lane k of the quad stores its run of the
// tile's channels, each rounded once. No fold, attw, swish, residual or
// statistics. Bound as K1 bf16's, its bytes without the residual.
#include "igemm_tc.cuh"
#include "tile_sums.cuh"

namespace {

namespace pc = ucdir::pc;
using ucdir::Elem;
using ucdir::bf16;
constexpr int G = 8;       // candidates per channel; a consumer thread's TN
constexpr int MAX_CW = 8;  // column tiles a block walks, at most

// K1's and K8's operands on the FMA core (float32).
struct TailArgs {
  const float* h;     // (B, H, W, C)
  const float* att;   // (B, H, W, G)
  const float* attw;  // (B, G) or null
  const float* w;     // (9 * C / G, C * G), columns permuted in each tile
  const float* bias;  // (C * G), in its own order
  const float* res;   // (B, H, W, C); K8: null
  const float* a;     // (B, C) or null
  const float* t;
  float* out;         // (B, H, W, C)
  float* ws;          // (B, ntp, 2, C) per-tile sums, or null
  ucdir::Geom g;      // g.C = C, g.cin = C / G, g.K = 9 * C / G
  int ncw;            // column tiles per block; blockIdx.y * ncw is the first
  int ntp;            // pixel tiles of an image
  bool vec_a;
  bool vec_res;       // 4-wide loads of the residual's channels
};

// Shared memory past the tile's own, in words: red, the (MAX_CW, warps,
// channels, 2) per-warp sums; att, the block's (BM, G) att * attw; then two
// buffers of a column tile's residual (BM rows of RS words, padded so that
// the 4 rows a warp reads in one go fall in other banks) and its BN biases.
template <class T>
struct Layout {
  static constexpr int NW = T::NC / 32;
  static constexpr int RS = T::NCX == 16 ? 20 : T::NCX == 8 ? 10
                            : T::NCX == 4 ? 9 : T::NCX + 1;
  static constexpr int RED = T::ORG + 2 * T::BM;
  static constexpr int ATT = RED + MAX_CW * NW * T::NCX * 2;
  static constexpr int BUF = ATT + T::BM * G;
  static constexpr int BUF_WORDS = T::BM * RS + T::BN;
  static constexpr int BYTES = 4 * (BUF + 2 * BUF_WORDS);
  static_assert(RED % 4 == 0 && ATT % 4 == 0 && BUF % 4 == 0 &&
                    BUF_WORDS % 4 == 0 && (T::BM * RS) % 4 == 0,
                "16-byte rows");
  static_assert(BYTES <= 227 * 1024, "shared memory of a block");
};

// The producers' staging for the epilogues (pc::grouped_produce's Stage):
// att * attw of the block's pixels, and a column tile's bias and residual.
// (Loading the residual in one iteration of the product and storing it in
// the next measured no faster: PERF.md §6.)
template <class T, bool TAIL>
struct TailStage {
  using L = Layout<T>;
  const TailArgs* c;
  float* smem;
  int b, m0, nt0, P;

  __device__ __forceinline__ void block(int nt) const {
    const int tid = threadIdx.x - T::NC;
    const float* att = c->att + ((int64_t)b * P + m0) * G;
    float* as = smem + L::ATT;
    float aw[2][4] = {{1.f, 1.f, 1.f, 1.f}, {1.f, 1.f, 1.f, 1.f}};
    if (TAIL && c->attw) {
      Elem<float>::ld4(aw[0], c->attw + b * G);
      Elem<float>::ld4(aw[1], c->attw + b * G + 4);
    }
    for (int u = tid; u < 2 * T::BM; u += T::NP) {
      const int m = u / 2;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (m0 + m < P) {
        Elem<float>::ld4(v, att + 4 * u);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = __fmul_rn(v[j], aw[u % 2][j]);
      }
      *reinterpret_cast<float4*>(as + 4 * u) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    tile(nt);
  }

  __device__ __forceinline__ void tile(int nt) const {
    const int tid = threadIdx.x - T::NC;
    float* buf = smem + L::BUF + ((nt - nt0) & 1) * L::BUF_WORDS;
    for (int u = tid; u < T::BN / 4; u += T::NP) {
      float v[4];
      Elem<float>::ld4(v, c->bias + nt * T::BN + 4 * u);
      reinterpret_cast<float4*>(buf + T::BM * L::RS)[u] =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    if (!TAIL) return;
    const int C = c->g.C;
    const float* res = c->res + ((int64_t)b * P + m0) * C + nt * T::NCX;
    if (T::NCX % 4 == 0 && c->vec_res) {
      constexpr int Q = T::NCX / 4;  // 4-wide loads a pixel
      for (int u = tid; u < T::BM * Q; u += T::NP) {
        const int m = u / Q, q = u % Q;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (m0 + m < P) Elem<float>::ld4(v, res + (int64_t)m * C + 4 * q);
        float* r = buf + m * L::RS + 4 * q;
        r[0] = v[0]; r[1] = v[1]; r[2] = v[2]; r[3] = v[3];
      }
    } else {
      for (int e = tid; e < T::BM * T::NCX; e += T::NP) {
        const int m = e / T::NCX, l = e % T::NCX;
        buf[m * L::RS + l] =
            m0 + m < P ? Elem<float>::ld(res + (int64_t)m * C + l) : 0.f;
      }
    }
  }
};

// The consumers' epilogue of column tile n0 / BN, the block's it-th: a
// thread's TM rows of channel n0 / G + tn. TAIL: K1's (swish, residual, and
// with red the warp's per-channel sums into red (warps, NCX, 2)); else K8's.
template <class T, bool TAIL>
__device__ __forceinline__ void tail_epilogue(const float (&acc)[T::TM][T::TN],
                                              const TailArgs& c,
                                              const float* smem, int it,
                                              int b, int m0, int n0,
                                              float* red) {
  static_assert(T::TN == G && T::GW == 4 && T::NG == 2, "a channel a thread");
  using L = Layout<T>;
  const int tn = threadIdx.x % T::NCX;
  const int tm = threadIdx.x / T::NCX;
  const int C = c.g.C;
  const int P = c.g.H * c.g.W;
  const int ch = n0 / G + tn;
  const float* as = smem + L::ATT;
  const float* buf = smem + L::BUF + (it & 1) * L::BUF_WORDS;
  float bj[G];
  {
    const float4 b0 =
        *reinterpret_cast<const float4*>(buf + T::BM * L::RS + tn * G);
    const float4 b1 =
        *reinterpret_cast<const float4*>(buf + T::BM * L::RS + tn * G + 4);
    bj[0] = b0.x; bj[1] = b0.y; bj[2] = b0.z; bj[3] = b0.w;
    bj[4] = b1.x; bj[5] = b1.y; bj[6] = b1.z; bj[7] = b1.w;
  }
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = pc::tile_row<T>(tm, i);
    if (m0 + m >= P) continue;
    const int64_t pix = (int64_t)b * P + m0 + m;
    const float4 a0 = *reinterpret_cast<const float4*>(as + m * G);
    const float4 a1 = *reinterpret_cast<const float4*>(as + m * G + 4);
    const float ap[G] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    // ap[j] is att * attw, rounded as the product the mix takes
    float mix = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) mix += (acc[i][j] + bj[j]) * ap[j];
    if (!TAIL) {
      Elem<float>::st(c.out + pix * C + ch, mix);
      continue;
    }
    const float v = ucdir::swishf(mix) + buf[m * L::RS + tn];
    Elem<float>::st(c.out + pix * C + ch, v);
    s += v;
    q += v * v;
  }
  if (!TAIL || red == nullptr) return;
  // the lanes tn, tn + NCX, ... of a warp hold one channel
#pragma unroll
  for (int k = T::NCX; k < 32; k <<= 1) {
    s += pc::shfl_xor(s, k);
    q += pc::shfl_xor(q, k);
  }
  if ((threadIdx.x & 31) < T::NCX) {
    float* r = red + ((threadIdx.x / 32) * T::NCX + tn) * 2;
    r[0] = s;
    r[1] = q;
  }
}

// One pixel tile (blockIdx.x) of image blockIdx.z by column tiles
// blockIdx.y * ncw .. + ncw - 1, one pipeline across them.
template <class T, bool TAIL>
__global__ void __launch_bounds__(T::NT) akgm_tail_kernel(TailArgs c) {
  using L = Layout<T>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* red = smem + L::RED;
  const int b = blockIdx.z;
  const int mt = blockIdx.x;
  const int m0 = mt * T::BM;
  const int nt0 = blockIdx.y * c.ncw;
  const bool stats = TAIL && c.ws != nullptr;
  const int nk = pc::igemm_setup<T>(smem, c.g, m0);
  if (threadIdx.x >= T::NC) {
    const TailStage<T, TAIL> st = {&c, smem, b, m0, nt0, c.g.H * c.g.W};
    pc::grouped_produce<T>(smem, c.h, c.a, c.t, c.w, c.g, b, nt0,
                           nt0 + c.ncw, nk, c.vec_a, st);
  } else {
    for (int i = 0; i < c.ncw; ++i) {
      float acc[T::TM][T::TN];
      pc::consume<T>(acc, smem, nk);
      tail_epilogue<T, TAIL>(acc, c, smem, i, b, m0, (nt0 + i) * T::BN,
                             stats ? red + i * L::NW * T::NCX * 2 : nullptr);
    }
  }
  if (!stats) return;
  // each channel's warp sums in warp order, stored plainly
  pc::block_sync<T::NT>();
  const int C = c.g.C;
  for (int l = threadIdx.x; l < c.ncw * T::NCX; l += T::NT) {
    const int i = l / T::NCX;
    const float* r = red + (i * L::NW * T::NCX + l % T::NCX) * 2;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int w = 0; w < L::NW; ++w) {
      s += r[w * T::NCX * 2];
      q += r[w * T::NCX * 2 + 1];
    }
    float* o = c.ws + ((int64_t)b * c.ntp + mt) * 2 * C + nt0 * T::NCX + l;
    o[0] = s;
    o[C] = q;
  }
}

template <class T, bool TAIL>
int launch_tile(TailArgs c, float* ssum, float* ssq, int B,
                cudaStream_t st) {
  constexpr int bytes = Layout<T>::BYTES;
  if (bytes > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        akgm_tail_kernel<T, TAIL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
  }
  const int P = c.g.H * c.g.W;
  const int ntn = c.g.C * G / T::BN;  // a multiple of 8: T::BN divides C
  c.ntp = (P + T::BM - 1) / T::BM;
  // one pipeline across MAX_CW column tiles, fewer where the grid would not
  // fill the card four times
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  c.ncw = MAX_CW;
  while (c.ncw > 1 && (int64_t)B * c.ntp * (ntn / c.ncw) < 4 * sms)
    c.ncw /= 2;
  akgm_tail_kernel<T, TAIL>
      <<<dim3(c.ntp, ntn / c.ncw, B), T::NT, bytes, st>>>(c);
  if (TAIL && c.ws != nullptr) {
    const int err = (int)cudaGetLastError();
    if (err) return err;
    ucdir::stats_reduce_kernel<<<dim3((c.g.C + 31) / 32, B), 1024, 0, st>>>(
        c.ws, ssum, ssq, c.ntp, c.g.C);
  }
  return (int)cudaGetLastError();
}

template <bool TAIL>
int launch(TailArgs c, float* ssum, float* ssq, int B, int H, int W, int C,
           cudaStream_t st) {
  c.g.H = H;
  c.g.W = W;
  c.g.C = C;
  c.g.Ho = H;
  c.g.Wo = W;
  c.g.ks = 3;
  c.g.stride = 1;
  c.g.cin = C / G;
  c.g.K = 9 * (C / G);
  constexpr uintptr_t run = 4 * sizeof(float);  // a 4-wide load
  c.vec_a = c.g.cin % 4 == 0 && pc::aligned(c.h, run) &&
            (c.a == nullptr ||
             (pc::aligned(c.a, run) && pc::aligned(c.t, run)));
  c.vec_res = c.res != nullptr && pc::aligned(c.res, run);
  if (C % 128 == 0) return launch_tile<pc::Wide, TAIL>(c, ssum, ssq, B, st);
  if (C % 64 == 0) return launch_tile<pc::Mid, TAIL>(c, ssum, ssq, B, st);
  if (C % 32 == 0)
    return launch_tile<pc::Thin<32>, TAIL>(c, ssum, ssq, B, st);
  if (C % 16 == 0)
    return launch_tile<pc::Thin<16>, TAIL>(c, ssum, ssq, B, st);
  return launch_tile<pc::Thin<8>, TAIL>(c, ssum, ssq, B, st);
}

int tail(const float* h, const float* att, const float* attw, const float* w,
         const float* bias, const float* res, const float* a, const float* t,
         float* out, float* ssum, float* ssq, float* ws, int B, int H, int W,
         int C, void* stream) {
  TailArgs c = {};
  c.h = h;
  c.att = att;
  c.attw = attw;
  c.w = w;
  c.bias = bias;
  c.res = res;
  c.a = a;
  c.t = t;
  c.out = out;
  c.ws = ws;
  return launch<true>(c, ssum, ssq, B, H, W, C, (cudaStream_t)stream);
}

// K1's and K8's bf16 product on the tensor cores: K5's z recompute
// (akgm_tail_bwd.cu) run forward over h (folded where a and t are given),
// m groups merged into one of m * cg channels on the caller's
// block-diagonal weights (ops/akgm.py k1_tc_merge, tc_merged_weights):
// below 8 channels a group, and until a group fills a 128-column tile.
ucdir::tc::TcArgs grouped_args(const bf16* h, const bf16* w, const bf16* bias,
                               const bf16* a, const bf16* t, int H, int W,
                               int C) {
  const int cg = C / G;
  int m = 1;
  while ((m * cg) % 8 && m < G) m *= 2;
  while (m * C < 128 && m < G) m *= 2;
  ucdir::tc::TcArgs p = {};
  p.x = h;
  p.w = w;
  p.bias = bias;
  p.a = a;
  p.t = t;
  p.g.H = p.g.Ho = H;
  p.g.W = p.g.Wo = W;
  p.g.C = C;
  p.g.ks = 3;
  p.g.stride = 1;
  p.g.cin = m * cg;
  p.g.K = 9 * m * cg;
  p.cout = p.wld = C * G;
  p.gw = m * C;
  p.xgs = m * cg;
  p.wgc = m * C;  // a group's weights: its columns
  p.wrows = p.g.K;
  return p;
}

// K1 in bf16 (the header's bf16 paragraph): the product with TailEpi as its
// epilogue, then the statistics over the tiles.
int tail_tc(const bf16* h, const bf16* att, const bf16* attw, const bf16* w,
            const bf16* bias, const bf16* res, const bf16* a, const bf16* t,
            bf16* out, float* ssum, float* ssq, float* ws, int B, int H,
            int W, int C, cudaStream_t st) {
  namespace tc = ucdir::tc;
  const tc::TailArgs e = {att, attw, res, out, ws};
  int err = tc::launch_grouped<pc::Affine, tc::TailEpi>(
      grouped_args(h, w, bias, a, t, H, W, C), e, B, false, st);
  if (err) return err;
  if (ws != nullptr) {
    const int ntp = (H + 7) / 8 * ((W + 15) / 16);
    ucdir::stats_reduce_kernel<<<dim3((C + 31) / 32, B), 1024, 0, st>>>(
        ws, ssum, ssq, ntp, C);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  ++tc::launch_count(tc::TC_AKGM_TAIL);
  return 0;
}

// K8 bf16's epilogue (the header's K8 paragraph), TailEpi's walk of the
// slabs without its roundings, swish, residual and statistics.
struct MixOutArgs {
  const bf16* att;  // (B, H, W, 8)
  bf16* out;        // (B, H, W, C)
};

struct MixOutEpi {
  using Args = MixOutArgs;
  static constexpr bool kPromote = false;
  static constexpr int MAXS = 16;  // slabs a tile: 128 columns at most
  float at[2][2];  // att of the lane's 2 candidates, rows a and b
  int64_t pix[2];
  bool in[2];
  uint32_t bb[MAXS];  // the bias of the lane's 2 columns a slab

  // rows 16 warp + lane / 4 and + 8 of the tile
  __device__ __forceinline__ void begin(const ucdir::tc::TcArgs& p,
                                        const MixOutArgs& e,
                                        const ucdir::tc::TilePos& gq,
                                        uint8_t*) {
    using EB = Elem<bf16>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j0 = 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + (lane >> 2) + 8 * r;
      const int y = gq.oy0 + row / p.tw, x = gq.ox0 + row % p.tw;
      in[r] = y < p.g.Ho && x < p.g.Wo;
      pix[r] = ((int64_t)gq.b * p.g.Ho + y) * p.g.Wo + x;
      float v[2] = {0.f, 0.f};
      if (in[r]) EB::ld2(v, e.att + pix[r] * G + j0);
      at[r][0] = v[0];
      at[r][1] = v[1];
    }
  }

  // before the tile's product: its bias, so that no load waits in the
  // epilogue
  template <class T>
  __device__ __forceinline__ void prefetch(const ucdir::tc::TcArgs& p,
                                           const MixOutArgs&,
                                           const ucdir::tc::TilePos& gq) {
    constexpr int NS = T::BN / 8;
    static_assert(NS <= MAXS, "128 columns at most");
    const int lane = threadIdx.x & 31;
    const int nv = (gq.nend - gq.n0) / 8;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      bb[j] = j < nv ? __ldg(reinterpret_cast<const unsigned int*>(
                           p.bias + gq.n0 + 8 * j + 2 * (lane & 3)))
                     : 0u;
  }

  template <class T>
  __device__ __forceinline__ void tile(const float (&acc)[T::BN / 2],
                                       const ucdir::tc::TcArgs& p,
                                       const MixOutArgs& e,
                                       const ucdir::tc::TilePos& gq,
                                       uint8_t*) {
    using EB = Elem<bf16>;
    constexpr int NS = T::BN / 8, LS = (NS + 3) / 4;
    const int lane = threadIdx.x & 31, k = lane & 3;
    const int C = p.cout / 8, nv = (gq.nend - gq.n0) / 8;
    float om[2][LS] = {};  // o of the lane's slabs LS k .. LS k + LS - 1
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (j >= nv) continue;  // the same for the whole block
      const float b0 = EB::lo(bb[j]), b1 = EB::hi(bb[j]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float o = (acc[4 * j + 2 * r] + b0) * at[r][0] +
                  (acc[4 * j + 2 * r + 1] + b1) * at[r][1];
        o += pc::shfl_xor(o, 1);
        o += pc::shfl_xor(o, 2);
        if (j / LS == k) om[r][j % LS] = o;
      }
    }
    const int mine = min(max(nv - LS * k, 0), LS);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (in[r] && mine > 0)
        ucdir::tc::store_run<LS>(e.out + pix[r] * C + gq.n0 / 8 + LS * k,
                                 om[r], mine);
  }

  template <class T>
  __device__ __forceinline__ void end(const ucdir::tc::TcArgs&,
                                      const MixOutArgs&,
                                      const ucdir::tc::TilePos&, uint8_t*) {}
};

// K8 in bf16: the product of h as it is, with MixOutEpi.
int mix_tc(const bf16* h, const bf16* att, const bf16* w, const bf16* bias,
           bf16* out, int B, int H, int W, int C, cudaStream_t st) {
  namespace tc = ucdir::tc;
  const MixOutArgs e = {att, out};
  const int err = tc::launch_grouped<pc::Raw, MixOutEpi>(
      grouped_args(h, w, bias, nullptr, nullptr, H, W, C), e, B, false, st);
  if (err) return err;
  ++tc::launch_count(tc::TC_AKGM_MIX);
  return 0;
}

}  // namespace

// h, res, out (B, H, W, C) NHWC; att (B, H, W, 8); attw (B, 8) or null;
// w (9 * C/8, 8 * C): the grouped HWIO kernel reshaped (row tap * (C/8) +
// ci, column c * 8 + j) with its columns permuted within each tile of the
// width ops/akgm.py tail_tile gives (128, 64, 32, 16 or 8), physical column
// h * bn / 2 + 4 * i + r holding logical column 8 * i + 4 * h + r; bias
// (8 * C) unpermuted; a, t (B, C) or null; ssum, ssq (B, C), written whole,
// and ws a (B, ceil(H * W / bm), 2, C) workspace, bm the tile's pixels
// (128, or 256 at 64 columns), or all three null. C must be a multiple of 8.
// Returns the first launch error as a cudaError_t.
extern "C" int ucdir_akgm_tail(const float* h, const float* att,
                               const float* attw, const float* w,
                               const float* bias, const float* res,
                               const float* a, const float* t, float* out,
                               float* ssum, float* ssq, float* ws, int B,
                               int H, int W, int C, void* stream) {
  return tail(h, att, attw, w, bias, res, a, t, out, ssum, ssq, ws, B, H, W,
              C, stream);
}

// K1 in bf16 on the tensor cores: every operand and out bf16, w (9 * m *
// C/8, 8 * C) in natural column order (c * 8 + j) with m groups below 8
// channels merged (ops/akgm.py tc_merged_weights), bias unpermuted; ssum,
// ssq float (B, C) and ws a float (B, ceil(H / 8) * ceil(W / 16), 2, C)
// workspace, or all three null.
extern "C" int ucdir_akgm_tail_bf16(const bf16* h, const bf16* att,
                                    const bf16* attw, const bf16* w,
                                    const bf16* bias, const bf16* res,
                                    const bf16* a, const bf16* t, bf16* out,
                                    float* ssum, float* ssq, float* ws, int B,
                                    int H, int W, int C, void* stream) {
  return tail_tc(h, att, attw, w, bias, res, a, t, out, ssum, ssq, ws, B, H,
                 W, C, (cudaStream_t)stream);
}

// K8: out (B, H, W, C) = the mix of h's candidates under att; operands as
// above.
extern "C" int ucdir_akgm_mix(const float* h, const float* att, const float* w,
                              const float* bias, float* out, int B, int H,
                              int W, int C, void* stream) {
  TailArgs c = {};
  c.h = h;
  c.att = att;
  c.w = w;
  c.bias = bias;
  c.out = out;
  return launch<false>(c, nullptr, nullptr, B, H, W, C, (cudaStream_t)stream);
}

// K8 in bf16 on the tensor cores: h, att, bias and out bf16, w (9 * m *
// C/8, 8 * C) as K1 bf16's (natural column order, narrow groups merged).
extern "C" int ucdir_akgm_mix_bf16(const bf16* h, const bf16* att,
                                   const bf16* w, const bf16* bias, bf16* out,
                                   int B, int H, int W, int C, void* stream) {
  return mix_tc(h, att, w, bias, out, B, H, W, C, (cudaStream_t)stream);
}
