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
// Both run on the producer/consumer core of igemm_pc.cuh, K5's z recompute's
// product (akgm_tail_bwd.cu):
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
#include "igemm_pc.cuh"

namespace {

namespace pc = ucdir::pc;
constexpr int G = 8;       // candidates per channel; a consumer thread's TN
constexpr int MAX_CW = 8;  // column tiles a block walks, at most

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
  bool vec_res;       // 16-byte loads of the residual's channels
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
    float4 aw0 = make_float4(1.f, 1.f, 1.f, 1.f), aw1 = aw0;
    if (TAIL && c->attw) {
      aw0 = __ldg(reinterpret_cast<const float4*>(c->attw + b * G));
      aw1 = __ldg(reinterpret_cast<const float4*>(c->attw + b * G + 4));
    }
    for (int u = tid; u < 2 * T::BM; u += T::NP) {
      const int m = u / 2;
      const float4 aw = u % 2 ? aw1 : aw0;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + m < P) {
        v = __ldg(reinterpret_cast<const float4*>(att + 4 * u));
        v = make_float4(v.x * aw.x, v.y * aw.y, v.z * aw.z, v.w * aw.w);
      }
      *reinterpret_cast<float4*>(as + 4 * u) = v;
    }
    tile(nt);
  }

  __device__ __forceinline__ void tile(int nt) const {
    const int tid = threadIdx.x - T::NC;
    float* buf = smem + L::BUF + ((nt - nt0) & 1) * L::BUF_WORDS;
    for (int u = tid; u < T::BN / 4; u += T::NP) {
      reinterpret_cast<float4*>(buf + T::BM * L::RS)[u] =
          __ldg(reinterpret_cast<const float4*>(c->bias + nt * T::BN) + u);
    }
    if (!TAIL) return;
    const int C = c->g.C;
    const float* res = c->res + ((int64_t)b * P + m0) * C + nt * T::NCX;
    if (T::NCX % 4 == 0 && c->vec_res) {
      constexpr int Q = T::NCX / 4;  // 16-byte loads a pixel
      for (int u = tid; u < T::BM * Q; u += T::NP) {
        const int m = u / Q, q = u % Q;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + m < P)
          v = __ldg(reinterpret_cast<const float4*>(res + (int64_t)m * C) +
                    q);
        float* r = buf + m * L::RS + 4 * q;
        r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
      }
    } else {
      for (int e = tid; e < T::BM * T::NCX; e += T::NP) {
        const int m = e / T::NCX, l = e % T::NCX;
        buf[m * L::RS + l] =
            m0 + m < P ? __ldg(res + (int64_t)m * C + l) : 0.f;
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
      c.out[pix * C + ch] = mix;
      continue;
    }
    const float v = ucdir::swishf(mix) + buf[m * L::RS + tn];
    c.out[pix * C + ch] = v;
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

// ssum, ssq (B, C) from the (B, ntp, 2, C) per-tile sums: warp w of block
// (channels 32 * blockIdx.x .., image blockIdx.y) adds the tiles
// [w * run, (w + 1) * run) in ascending order, run = ceil(ntp / 32), then
// the 32 runs are added in ascending order.
__global__ void __launch_bounds__(1024)
    stats_reduce_kernel(const float* __restrict__ ws, float* __restrict__ ssum,
                        float* __restrict__ ssq, int ntp, int C) {
  __shared__ float part[32][2][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int ch = blockIdx.x * 32 + lane;
  const int run = (ntp + 31) / 32;
  const int t1 = min(ntp, (w + 1) * run);
  float s = 0.f, q = 0.f;
  if (ch < C) {
    for (int tile = w * run; tile < t1; ++tile) {
      const float* r = ws + ((int64_t)b * ntp + tile) * 2 * C + ch;
      s += __ldg(r);
      q += __ldg(r + C);
    }
  }
  part[w][0][lane] = s;
  part[w][1][lane] = q;
  __syncthreads();
  if (w != 0 || ch >= C) return;
  float S = 0.f, Q = 0.f;
  for (int k = 0; k < 32; ++k) {
    S += part[k][0][lane];
    Q += part[k][1][lane];
  }
  ssum[(int64_t)b * C + ch] = S;
  ssq[(int64_t)b * C + ch] = Q;
}

template <class T, bool TAIL>
int launch_tile(TailArgs c, float* ssum, float* ssq, int B,
                cudaStream_t st) {
  constexpr int bytes = Layout<T>::BYTES;
  if (bytes > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        akgm_tail_kernel<T, TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
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
    stats_reduce_kernel<<<dim3((c.g.C + 31) / 32, B), 1024, 0, st>>>(
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
  c.vec_a = c.g.cin % 4 == 0 && pc::aligned(c.h, 16) &&
            (c.a == nullptr || (pc::aligned(c.a, 16) && pc::aligned(c.t, 16)));
  c.vec_res = c.res != nullptr && pc::aligned(c.res, 16);
  if (C % 128 == 0) return launch_tile<pc::Wide, TAIL>(c, ssum, ssq, B, st);
  if (C % 64 == 0) return launch_tile<pc::Mid, TAIL>(c, ssum, ssq, B, st);
  if (C % 32 == 0)
    return launch_tile<pc::Thin<32>, TAIL>(c, ssum, ssq, B, st);
  if (C % 16 == 0)
    return launch_tile<pc::Thin<16>, TAIL>(c, ssum, ssq, B, st);
  return launch_tile<pc::Thin<8>, TAIL>(c, ssum, ssq, B, st);
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
