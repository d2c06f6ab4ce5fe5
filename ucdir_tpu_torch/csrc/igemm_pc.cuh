// Implicit-GEMM core of the forward convolutions K2, K3 and K7 for an H100
// (sm_90a): fp32 in and out, fp32 FMA, producer and consumer warps.
//
// The product is igemm.cuh's: A (P x K) * Wt (K x N), row p of A output pixel
// p's receptive field, column k = tap * cin + ci, the per-(batch, channel)
// affine x * a + t applied as A is staged and the border read as 0 AFTER it.
// Every output is one accumulator that takes its K products in ascending k
// with fmaf, as in igemm.cuh, so both cores give the same bits. What differs
// is how the card is used:
//
// 1. Producer and consumer warps. The last PW warps of a block only stage:
//    they load a slice of A and Wt into registers, transform it and store it
//    to shared memory; the other warps only multiply. Two stages of shared
//    memory and one barrier of the whole block per BK-deep slice; the global
//    loads run two slices ahead, so a load has a whole iteration to arrive.
//    The two kinds of warp meet at a named barrier (bar.sync 1) from their own
//    loops, so the compiler gives each loop its own registers, and no FMA
//    waits for a bounds test, an address or an affine.
// 2. 16-byte loads along the channels: K is walked tap by tap, and where
//    cin % 4 == 0 one thread loads four consecutive channels of one pixel and
//    tap, so the tap arithmetic, the bounds test and the address are paid
//    once per four values and a warp reads whole 64-byte runs. The tap and
//    channel of a thread's column advance by additions: no division in the
//    loop. Other widths (cin = 6) take four scalar loads with the same
//    layout; K is padded to the slice with zeros.
// 3. The tile is a template parameter (Tile<...> below) chosen by cout at
//    launch: 128 x 128 where cout >= 128 (4 producer warps; 2 were slower)
//    and 256 x 64 up to there (8 producer warps: its slice of A is twice as
//    tall, and 4 were a tenth slower), both with 256 consumer threads of
//    8 x 8 outputs, one block per SM; and 128 x 8 with 128 consumer threads
//    of 4 x 2 outputs and 8 producer warps for heads of 8 columns or fewer
//    (64 -> 3), which the staging bounds.
// 4. The epilogue: bias, swish, 16-byte stores, and the (B, cout) sum and sum
//    of squares reduced over the lanes of a warp that hold one column with
//    shuffles before one shared-memory add per warp and column and one global
//    atomic per block and column.
//
// The product ran on the tensor cores first (mma.sync m16n8k8 TF32 with a
// 3xTF32 split, in this pipeline): about as fast as this form (the fragment
// loads, the adds and the MMAs of a warp took turns) and three times closer
// to a float64 product, but its rounding is not the host's, and the
// end-to-end comparison of card and host after DDIM's first step, which
// multiplies the network's output by 349, reads agreement to the last bit.
// PERF.md has the readings of both. wgmma with TF32 wants both operands
// K-major behind shared-memory descriptors and cannot transform A on its way
// in (see ROADMAP.md: fold a into the weights and t into a per-border-class
// bias, and A becomes a raw TMA copy).
//
// Shared-memory layouts:
//   As[k][m], row stride BM + 4 words: a consumer thread reads its rows as
//     16-byte groups of 4 (tm * 4 .. + 3, and the same BM / 2 further on), so
//     the threads of a warp read consecutive groups or the same one; a
//     producer thread stores its 4 consecutive k of one row as 4 scalars,
//     2-way conflicted, once per 16 FMAs of every consumer thread.
//   Bs[k][n], row stride BN: producers store and consumers load 16-byte groups
//     of 4 columns, consecutive threads consecutive groups.
// A consumer thread's TN columns are NG groups of GW, BN / NG apart, and its
// TM rows MG groups of 4, BM / MG apart: with 8 consecutive columns a thread
// the loads of a quarter warp would hit every bank twice.
#pragma once

#include "igemm.cuh"

namespace ucdir {
namespace pc {

// BM x BN output tile. (BM / TM) x (BN / TN) consumer threads hold TM x TN
// outputs each; PW producer warps, the last of the block, stage the BK-deep
// slices.
template <int BM_, int BN_, int TM_, int TN_, int BK_, int PW_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int NCX = BN / TN;              // consumer threads along n
  static constexpr int NC = (BM / TM) * NCX;       // consumer threads
  static constexpr int NP = 32 * PW_;              // producer threads
  static constexpr int NT = NC + NP;               // threads per block
  static constexpr int MG = TM / 4;                // 4-row groups per thread
  static constexpr int GW = TN < 4 ? TN : 4;       // columns per group
  static constexpr int NG = TN / GW;               // column groups per thread
  static constexpr int KG = BK / 4;        // 4-wide k groups per row of A
  static constexpr int AROWS = NP / KG;    // rows of A staged per pass
  static constexpr int AI = BM / AROWS;    // passes: 4-wide loads per thread
  static constexpr int CG = BN / 4;        // 4-wide column groups of Wt
  static constexpr int BU = BK / 2 * CG;   // pairs of 4-wide loads of Wt
  static constexpr int BI = (BU + NP - 1) / NP;
  static constexpr int SA = BM + 4;        // words per row (one k) of As
  static constexpr int SB = BN;            // words per row (one k) of Bs
  static constexpr int A_WORDS = BK * SA, B_WORDS = BK * SB;
  static constexpr int RED = 2 * (A_WORDS + B_WORDS);  // sums, sums of squares
  static constexpr int ORG = RED + 2 * BN;             // iy0, ix0
  static constexpr int SMEM_BYTES = 4 * (ORG + 2 * BM);
  static_assert(AI <= 8, "Staged::mask holds 4 bits per pass");
  static_assert(NC % 32 == 0 && TM % 4 == 0 && TN % GW == 0 && BK % 4 == 0 &&
                    (GW == 4 || GW == 2),
                "thread tile");
  static_assert(NP % KG == 0 && BM % AROWS == 0 && BN % 4 == 0, "staging");
  static_assert(NCX <= 32 && 32 % NCX == 0, "a column's lanes are one warp's");
  static_assert(SMEM_BYTES <= 48 * 1024, "static limit of dynamic smem");
};

using Wide = Tile<128, 128, 8, 8, 16, 4>;
using Mid = Tile<256, 64, 8, 8, 16, 8>;
using Narrow = Tile<128, 8, 4, 2, 16, 8>;

// What the staging does to a loaded value: x * a + t, or swish of it (the
// border stays 0 = swish(0)).
struct Affine {
  static constexpr bool kAffine = true;
  static __device__ __forceinline__ float apply(float v, float a, float t) {
    return fmaf(v, a, t);
  }
};
struct Preact {
  static constexpr bool kAffine = true;
  static __device__ __forceinline__ float apply(float v, float a, float t) {
    return swishf(fmaf(v, a, t));
  }
};

struct Raw {
  static constexpr bool kAffine = false;
  static __device__ __forceinline__ float apply(float v, float, float) {
    return v;
  }
};

// ---- PTX primitives
__device__ __forceinline__ float shfl_xor(float v, int mask) {
  return __shfl_xor_sync(0xffffffffu, v, mask);
}

// A barrier of all N threads of the block that producer and consumer warps
// may reach from different places in the code (named barrier 1).
template <int N>
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
}
// ---- end of PTX primitives

// One slice of A and Wt in registers, between its global loads and its
// stores to shared memory.
template <class T>
struct Staged {
  float a[T::AI][4];   // raw inputs, 4 consecutive k of one pixel each
  float sa[4], st[4];  // the affine of those k columns
  uint32_t mask;       // bit 4 * i + j: a[i][j] is inside the image and K
  float b[T::BI][2][4];  // 4 consecutive columns of two rows of Wt each
};

// The A column a thread stages: k = slice * BK + 4 * (tid % KG), as a tap and
// a channel, advanced slice by slice.
struct KColumn {
  int tap, ci;
};

struct Operands {
  const float* xb;  // image b's (H, W, C) input
  const float* ab;  // image b's (C) scale or null
  const float* tb;  // image b's (C) shift or null
  const float* w;   // (K, ncols) weights
  int ncols;
  bool vec_a;       // cin % 4 == 0 and xb, ab, tb 16-byte aligned
  bool vec_w;       // ncols % 4 == 0 and w 16-byte aligned
};

template <class T, class X>
__device__ __forceinline__ void load_slice(Staged<T>& s, KColumn& kc,
                                           const Operands& op, const Geom& g,
                                           const int* iy0, const int* ix0,
                                           int k0, int n0) {
  const int tid = threadIdx.x - T::NC;  // among the producers
  const int am = tid / T::KG;
  const int ntaps = g.ks * g.ks;
  s.mask = 0u;
  if (op.vec_a) {
    const bool valid = kc.tap < ntaps;
    const int ty = kc.tap / 3;
    const int tx = kc.tap - ty * 3;
    float4 sa = make_float4(1.f, 1.f, 1.f, 1.f);
    float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
    if (X::kAffine && valid && op.ab != nullptr) {
      sa = __ldg(reinterpret_cast<const float4*>(op.ab + kc.ci));
      st = __ldg(reinterpret_cast<const float4*>(op.tb + kc.ci));
    }
    s.sa[0] = sa.x; s.sa[1] = sa.y; s.sa[2] = sa.z; s.sa[3] = sa.w;
    s.st[0] = st.x; s.st[1] = st.y; s.st[2] = st.z; s.st[3] = st.w;
#pragma unroll
    for (int i = 0; i < T::AI; ++i) {
      const int m = am + i * T::AROWS;
      const int iy = iy0[m] + ty;
      const int ix = ix0[m] + tx;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid && (unsigned)iy < (unsigned)g.H &&
          (unsigned)ix < (unsigned)g.W) {
        v = __ldg(reinterpret_cast<const float4*>(
            op.xb + ((int64_t)iy * g.W + ix) * g.C + kc.ci));
        s.mask |= 0xfu << (4 * i);
      }
      s.a[i][0] = v.x; s.a[i][1] = v.y; s.a[i][2] = v.z; s.a[i][3] = v.w;
    }
    kc.ci += T::BK;
    while (kc.ci >= g.cin) {
      kc.ci -= g.cin;
      ++kc.tap;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * (tid % T::KG) + j;
      const bool valid = k < g.K;
      const int tap = valid ? k / g.cin : 0;
      const int ci = valid ? k - tap * g.cin : 0;
      const int ty = tap / 3;
      const int tx = tap - ty * 3;
      const bool aff = X::kAffine && op.ab != nullptr;
      s.sa[j] = aff ? op.ab[ci] : 1.f;
      s.st[j] = aff ? op.tb[ci] : 0.f;
#pragma unroll
      for (int i = 0; i < T::AI; ++i) {
        const int m = am + i * T::AROWS;
        const int iy = iy0[m] + ty;
        const int ix = ix0[m] + tx;
        float v = 0.f;
        if (valid && (unsigned)iy < (unsigned)g.H &&
            (unsigned)ix < (unsigned)g.W) {
          v = op.xb[((int64_t)iy * g.W + ix) * g.C + ci];
          s.mask |= 1u << (4 * i + j);
        }
        s.a[i][j] = v;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < T::BI; ++i) {
    const int u = tid + i * T::NP;
    const int n = n0 + 4 * (u % T::CG);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = k0 + 2 * (u / T::CG) + r;
      const float* wr = op.w + (int64_t)k * op.ncols + n;
      const bool row = (T::BU % T::NP == 0 || u < T::BU) && k < g.K;
      if (op.vec_w) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row && n < op.ncols)
          v = __ldg(reinterpret_cast<const float4*>(wr));
        s.b[i][r][0] = v.x; s.b[i][r][1] = v.y;
        s.b[i][r][2] = v.z; s.b[i][r][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s.b[i][r][j] = (row && n + j < op.ncols) ? wr[j] : 0.f;
      }
    }
  }
}

template <class T, class X>
__device__ __forceinline__ void store_slice(const Staged<T>& s, float* As,
                                            float* Bs) {
  const int tid = threadIdx.x - T::NC;  // among the producers
  const int kg = tid % T::KG;
  const int am = tid / T::KG;
#pragma unroll
  for (int i = 0; i < T::AI; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      As[(4 * kg + j) * T::SA + am + i * T::AROWS] =
          (s.mask >> (4 * i + j)) & 1u ? X::apply(s.a[i][j], s.sa[j], s.st[j])
                                       : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < T::BI; ++i) {
    const int u = tid + i * T::NP;
    if (T::BU % T::NP != 0 && u >= T::BU) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<float4*>(Bs + (2 * (u / T::CG) + r) * T::SB +
                                 4 * (u % T::CG)) =
          make_float4(s.b[i][r][0], s.b[i][r][1], s.b[i][r][2], s.b[i][r][3]);
    }
  }
}

// The producers' side of the product: stages slice 0, then in iteration i stores
// slice i + 1, loaded one iteration earlier, into stage (i + 1) % 2 and starts
// the loads of slice i + 2 into the registers the store has freed, so that a
// load has a whole iteration to arrive.
template <class T, class X>
__device__ __forceinline__ void produce(float* smem, const Operands& op,
                                        const Geom& g, int n0, int nk) {
  const int pt = threadIdx.x - T::NC;
  const int* iy0 = reinterpret_cast<const int*>(smem + T::ORG);
  const int* ix0 = iy0 + T::BM;
  float* As = smem;
  float* Bs = smem + 2 * T::A_WORDS;
  KColumn kc;
  kc.tap = 4 * (pt % T::KG) / g.cin;
  kc.ci = 4 * (pt % T::KG) - kc.tap * g.cin;
  Staged<T> s;
  load_slice<T, X>(s, kc, op, g, iy0, ix0, 0, n0);
  store_slice<T, X>(s, As, Bs);
  if (nk > 1) load_slice<T, X>(s, kc, op, g, iy0, ix0, T::BK, n0);
  block_sync<T::NT>();
  for (int i = 0; i < nk; ++i) {
    const int nxt = (i + 1) & 1;
    if (i + 1 < nk)
      store_slice<T, X>(s, As + nxt * T::A_WORDS, Bs + nxt * T::B_WORDS);
    if (i + 2 < nk)
      load_slice<T, X>(s, kc, op, g, iy0, ix0, (i + 2) * T::BK, n0);
    block_sync<T::NT>();
  }
}

// Row i and column j of a consumer thread's outputs within the tile.
template <class T>
__device__ __forceinline__ int tile_row(int tm, int i) {
  return (i / 4) * (T::BM / T::MG) + tm * 4 + i % 4;
}
template <class T>
__device__ __forceinline__ int tile_col(int tn, int j) {
  return (j / T::GW) * (T::BN / T::NG) + tn * T::GW + j % T::GW;
}

// The consumers' side: acc[i][j] = row m0 + tile_row(tm, i) of A times column
// n0 + tile_col(tn, j) of Wt, tm = threadIdx.x / NCX and tn = threadIdx.x %
// NCX, one fmaf per k in ascending k. Slice i is multiplied from stage i % 2.
// Both sides have passed a barrier after their last access to the stages when
// they return.
template <class T>
__device__ __forceinline__ void consume(float (&acc)[T::TM][T::TN],
                                        const float* smem, int nk) {
  const float* As = smem + (threadIdx.x / T::NCX) * 4;
  const float* Bs = smem + 2 * T::A_WORDS + (threadIdx.x % T::NCX) * T::GW;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  }
  block_sync<T::NT>();
  for (int s = 0; s < nk; ++s) {
    const float* Aw = As + (s & 1) * T::A_WORDS;
    const float* Bw = Bs + (s & 1) * T::B_WORDS;
#pragma unroll
    for (int kk = 0; kk < T::BK; ++kk) {
      float a[T::TM], b[T::TN];
#pragma unroll
      for (int g = 0; g < T::MG; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            Aw + kk * T::SA + g * (T::BM / T::MG));
        a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < T::NG; ++g) {
        const float* q = Bw + kk * T::SB + g * (T::BN / T::NG);
        if constexpr (T::GW == 4) {
          const float4 v = *reinterpret_cast<const float4*>(q);
          b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z;
          b[4 * g + 3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < T::GW; ++j) b[T::GW * g + j] = q[j];
        }
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i) {
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    block_sync<T::NT>();
  }
}

// What both kinds of warp need before they part: the input pixel of every
// row of the tile's first tap (OUTSIDE past the end) and the zeroed statistics
// buffer. Returns the number of slices.
template <class T>
__device__ __forceinline__ int igemm_setup(float* smem, const Geom& g,
                                           int m0) {
  const int tid = threadIdx.x;
  int* iy0 = reinterpret_cast<int*>(smem + T::ORG);
  int* ix0 = iy0 + T::BM;
  const int P = g.Ho * g.Wo;
  const int off = g.ks == 3 ? 1 : 0;
  for (int m = tid; m < T::BM; m += T::NT) {
    const int p = m0 + m;
    const int oy = p / g.Wo;
    iy0[m] = p < P ? oy * g.stride - off : OUTSIDE;
    ix0[m] = p < P ? (p - oy * g.Wo) * g.stride - off : OUTSIDE;
  }
  for (int i = tid; i < 2 * T::BN; i += T::NT) smem[T::RED + i] = 0.f;
  block_sync<T::NT>();
  return (g.K + T::BK - 1) / T::BK;
}

// Plain convolution epilogue of a consumer thread: + bias (null: none),
// optional swish, store, and with stats the tile's per-column sum and sum of
// squares of the stored values added into the buffer at smem + T::RED.
// vec: N % GW == 0 and out aligned to a group of GW columns.
template <class T>
__device__ __forceinline__ void conv_epilogue_pc(
    const float (&acc)[T::TM][T::TN], float* smem,
    const float* __restrict__ bias, float* __restrict__ out, bool stats,
    int act, bool vec, int P, int N, int b, int m0, int n0) {
  const int tn = threadIdx.x % T::NCX;
  const int tm = threadIdx.x / T::NCX;
  float* red = smem + T::RED;
  float bj[T::TN], s[T::TN], q[T::TN];
#pragma unroll
  for (int j = 0; j < T::TN; ++j) {
    const int n = n0 + tile_col<T>(tn, j);
    bj[j] = (bias != nullptr && n < N) ? bias[n] : 0.f;
    s[j] = 0.f;
    q[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int p = m0 + tile_row<T>(tm, i);
    if (p >= P) continue;
    float* orow = out + ((int64_t)b * P + p) * N;
#pragma unroll
    for (int g = 0; g < T::NG; ++g) {
      float v[T::GW];
#pragma unroll
      for (int j = 0; j < T::GW; ++j) {
        v[j] = acc[i][T::GW * g + j] + bj[T::GW * g + j];
        if (act) v[j] = swishf(v[j]);
      }
      const int n = n0 + tile_col<T>(tn, T::GW * g);
      if (vec && n + T::GW <= N) {
        if constexpr (T::GW == 4) {
          *reinterpret_cast<float4*>(orow + n) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
          *reinterpret_cast<float2*>(orow + n) = make_float2(v[0], v[1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < T::GW; ++j) {
          if (n + j < N) orow[n + j] = v[j];
        }
      }
#pragma unroll
      for (int j = 0; j < T::GW; ++j) {
        s[T::GW * g + j] += v[j];
        q[T::GW * g + j] += v[j] * v[j];
      }
    }
  }
  if (!stats) return;
  // the lanes tn, tn + NCX, ... of a warp hold one column
#pragma unroll
  for (int j = 0; j < T::TN; ++j) {
#pragma unroll
    for (int m = T::NCX; m < 32; m <<= 1) {
      s[j] += shfl_xor(s[j], m);
      q[j] += shfl_xor(q[j], m);
    }
    if ((threadIdx.x & 31) < T::NCX) {
      atomicAdd(&red[tile_col<T>(tn, j)], s[j]);
      atomicAdd(&red[T::BN + tile_col<T>(tn, j)], q[j]);
    }
  }
}

// The whole block, after its consumers' epilogue: the tile's statistics into
// the zeroed (B, N) buffers, one atomic per column.
template <class T>
__device__ __forceinline__ void flush_stats(const float* smem,
                                            float* __restrict__ ssum,
                                            float* __restrict__ ssq, int N,
                                            int b, int n0) {
  const float* red = smem + T::RED;
  block_sync<T::NT>();
  for (int c = threadIdx.x; c < T::BN; c += T::NT) {
    if (n0 + c >= N) continue;
    atomicAdd(&ssum[(int64_t)b * N + n0 + c], red[c]);
    atomicAdd(&ssq[(int64_t)b * N + n0 + c], red[T::BN + c]);
  }
}

struct ConvArgs {
  const float* x;     // (B, H, W, cin) NHWC
  const float* w;     // (K, cout), row tap * cin + ci
  const float* bias;  // (cout) or null
  const float* a;     // (B, cin) or null
  const float* t;     // (B, cin) or null
  float* out;         // (B, Ho, Wo, cout)
  float* ssum;        // zeroed (B, cout) or null
  float* ssq;
  Geom g;
  int cout, act;
  int ntn;            // column tiles; blockIdx.x = pixel tile * ntn + column tile
  bool vec_a, vec_w, vec_out;
};

// out = act(conv(X(x * a + t)) + bias) and its statistics: one BM x BN tile
// of one image per block.
template <class T, class X>
__global__ void __launch_bounds__(T::NT) conv_pc_kernel(ConvArgs c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int mt = blockIdx.x / c.ntn;
  const int m0 = mt * T::BM;
  const int n0 = (blockIdx.x - mt * c.ntn) * T::BN;
  Operands op;
  op.xb = c.x + (int64_t)b * c.g.H * c.g.W * c.g.C;
  op.ab = c.a ? c.a + (int64_t)b * c.g.C : nullptr;
  op.tb = c.t ? c.t + (int64_t)b * c.g.C : nullptr;
  op.w = c.w;
  op.ncols = c.cout;
  op.vec_a = c.vec_a;
  op.vec_w = c.vec_w;
  const int nk = igemm_setup<T>(smem, c.g, m0);
  // each kind of warp in a scope of its own, so that neither holds the
  // other's registers
  if (threadIdx.x >= T::NC) {
    produce<T, X>(smem, op, c.g, n0, nk);
  } else {
    float acc[T::TM][T::TN];
    consume<T>(acc, smem, nk);
    conv_epilogue_pc<T>(acc, smem, c.bias, c.out, c.ssum != nullptr, c.act,
                        c.vec_out, c.g.Ho * c.g.Wo, c.cout, b, m0, n0);
  }
  if (c.ssum != nullptr) flush_stats<T>(smem, c.ssum, c.ssq, c.cout, b, n0);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <class T, class X>
int launch_tile(ConvArgs c, int B, cudaStream_t stream) {
  const int P = c.g.Ho * c.g.Wo;
  c.vec_out = c.cout % T::GW == 0 && aligned(c.out, 4 * T::GW);
  c.ntn = (c.cout + T::BN - 1) / T::BN;
  const dim3 grid((unsigned)((P + T::BM - 1) / T::BM) * c.ntn, 1, B);
  conv_pc_kernel<T, X><<<grid, T::NT, T::SMEM_BYTES, stream>>>(c);
  return (int)cudaGetLastError();
}

// Launches the convolution on the tile that cout selects. c.g, the pointers,
// cout and act are the caller's; the rest is filled here.
template <class X>
int launch_conv(ConvArgs c, int B, cudaStream_t stream) {
  const bool affine_ok =
      (c.a == nullptr || (aligned(c.a, 16) && aligned(c.t, 16)));
  c.vec_a = c.g.cin % 4 == 0 && c.g.C % 4 == 0 && aligned(c.x, 16) &&
            affine_ok;
  c.vec_w = c.cout % 4 == 0 && aligned(c.w, 16);
  if (c.cout >= 128) return launch_tile<Wide, X>(c, B, stream);
  if (c.cout > 8) return launch_tile<Mid, X>(c, B, stream);
  return launch_tile<Narrow, X>(c, B, stream);
}

}  // namespace pc
}  // namespace ucdir
