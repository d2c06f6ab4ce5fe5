// Implicit-GEMM core of the convolutions K2, K3 and K7, of the AKGM tail K1,
// the mix K8 and the group-packed tail K9, and of the backward kernels K5 and
// K6 for an H100 (sm_90a): fp32 in and out, fp32 FMA, producer and consumer
// warps. The backward uses it three ways: the forward product with another
// epilogue (K6's dz, K5's do), the forward product on a rebuilt or raw
// cotangent with flipped, transposed weights (the input gradients), and the
// weight gradient at the end of this file, whose tile runs over k rows and
// whose reduction runs over pixels.
//
// A convolution is the product A (P x K) * Wt (K x N): row p of A is output
// pixel p's receptive field, column k = tap * cin + ci of it is input channel
// ci at tap (ty, tx) = (tap / 3, tap % 3), read at input pixel
// (oy * stride - 1 + ty, ox * stride - 1 + tx) for a 3x3 window (the 1x1
// window reads (oy, ox)). An optional per-(batch, channel) affine x * a + t (a
// folded GroupNorm(1)) is applied as A is staged; taps outside the image read
// 0 AFTER the affine, which is the SAME padding of the normalized tensor.
// Every output is one accumulator that takes its K products in ascending k
// with fmaf, as the host's libraries and the kernels this core replaced do,
// so that they share their rounding. How the card is used:
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
//
// Element type E of the operands in device memory (Elem<E> below): float,
// or bf16 for K1 (the TPU kernel's bf16 instantiation, validation under
// --compute_dtype bf16). The bf16 forms of K2, K3, K5, K6 and K7 run on the
// tensor cores instead (igemm_tc.cuh), which reuses Geom, Elem<bf16>, the
// staging functors and the weight gradient's reduction below. The producers
// load bf16 (a 4-wide run is 8 bytes, half the bytes of float) and convert
// it to float as they stage it, so shared memory, the consumers and their
// fp32 FMA product are the same for both; the epilogue rounds each output
// once to nearest even and takes the statistics of the rounded values,
// which is what the next layer reads. The staging rounds where the TPU
// kernel's bf16 arithmetic rounds: x * a and then + t each to bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ucdir {

constexpr int OUTSIDE = -(1 << 28);  // origin for rows past the end

struct Geom {
  int H, W, C;     // input height, width and channel stride
  int Ho, Wo;      // output height and width
  int ks, stride;  // 3 (padding 1) or 1
  int cin;         // input channels in this product (a group's width)
  int K;           // ks * ks * cin
};

__device__ __forceinline__ float swishf(float v) {
  return v * (1.f / (1.f + expf(-v)));
}

// d swish(v) / dv = sig * (1 + v * (1 - sig)).
__device__ __forceinline__ float dswishf(float v) {
  const float sig = 1.f / (1.f + expf(-v));
  return sig * (1.f + v * (1.f - sig));
}

using bf16 = __nv_bfloat16;

// Loads and stores of an element type as float: ld one value (ldg through
// the read-only cache), ld2 two and ld4 four consecutive ones (one 16-byte
// load of float, one 8-byte load of bf16; aligned to 2 or 4 elements), st,
// st2 and st4 their stores, and rnd a float
// rounded to the type and back (to nearest even; the identity for float).
// The producers load a slice two iterations before they store it, so their
// 4-wide loads are ld4raw: the loaded words as they are, turned into four
// floats by unpack4 only where the slice is stored (bf16: two words of two
// values each in v[0] and v[1]; a conversion next to the load would wait
// for it), with one4 and zero4 the packed 1s and 0s. bf16's mul2 and add2
// multiply and add two packed pairs in bf16 arithmetic (sm_90), each result
// rounded to nearest even.
template <class E>
struct Elem;

template <>
struct Elem<float> {
  static constexpr bool kLow = false;
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ float ldg(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void ld2(float (&v)[2], const float* p) {
    const float2 u = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = u.x; v[1] = u.y;
  }
  static __device__ __forceinline__ void ld4(float (&v)[4], const float* p) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  static __device__ __forceinline__ void ld4raw(float (&v)[4],
                                                const float* p) {
    ld4(v, p);
  }
  static __device__ __forceinline__ void unpack4(float (&)[4]) {}
  static __device__ __forceinline__ void one4(float (&v)[4]) {
    v[0] = v[1] = v[2] = v[3] = 1.f;
  }
  static __device__ __forceinline__ void zero4(float (&v)[4]) {
    v[0] = v[1] = v[2] = v[3] = 0.f;
  }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Elem<bf16> {
  static constexpr bool kLow = true;
  static __device__ __forceinline__ uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __uint_as_float(bits(v) << 16);
  }
  // the first of two bf16 in a word is its low half
  static __device__ __forceinline__ float lo(uint32_t u) {
    return __uint_as_float(u << 16);
  }
  static __device__ __forceinline__ float hi(uint32_t u) {
    return __uint_as_float(u & 0xffff0000u);
  }
  static __device__ __forceinline__ float ld(const bf16* p) {
    return lo(*reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ float ldg(const bf16* p) {
    return lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  static __device__ __forceinline__ void ld2(float (&v)[2], const bf16* p) {
    const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
    v[0] = lo(u); v[1] = hi(u);
  }
  static __device__ __forceinline__ void ld4(float (&v)[4], const bf16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = lo(u.x); v[1] = hi(u.x); v[2] = lo(u.y); v[3] = hi(u.y);
  }
  static __device__ __forceinline__ void ld4raw(float (&v)[4],
                                                const bf16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
  }
  static __device__ __forceinline__ void unpack4(float (&v)[4]) {
    const uint32_t u0 = __float_as_uint(v[0]), u1 = __float_as_uint(v[1]);
    v[0] = lo(u0); v[1] = hi(u0); v[2] = lo(u1); v[3] = hi(u1);
  }
  static __device__ __forceinline__ void one4(float (&v)[4]) {
    v[0] = v[1] = __uint_as_float(0x3f803f80u);  // two bf16 1.0
  }
  static __device__ __forceinline__ void zero4(float (&v)[4]) {
    v[0] = v[1] = 0.f;
  }
  static __device__ __forceinline__ float mul2(float a, float b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;"
        : "=r"(d)
        : "r"(__float_as_uint(a)), "r"(__float_as_uint(b)));
    return __uint_as_float(d);
  }
  static __device__ __forceinline__ float add2(float a, float b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;"
        : "=r"(d)
        : "r"(__float_as_uint(a)), "r"(__float_as_uint(b)));
    return __uint_as_float(d);
  }
  // a and b rounded to nearest even and packed, a in the low half: one
  // conversion for two values
  static __device__ __forceinline__ float pack2(float a, float b) {
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(b), "f"(a));
    return __uint_as_float(d);
  }
  // the low and the high value of a packed pair held as a float
  static __device__ __forceinline__ float lof(float u) {
    return lo(__float_as_uint(u));
  }
  static __device__ __forceinline__ float hif(float u) {
    return hi(__float_as_uint(u));
  }
  static __device__ __forceinline__ void st(bf16* p, float v) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)bits(v);
  }
  static __device__ __forceinline__ void st2(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = bits(a) | bits(b) << 16;
  }
  static __device__ __forceinline__ void st4(bf16* p, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bits(v[0]) | bits(v[1]) << 16,
                                              bits(v[2]) | bits(v[3]) << 16);
  }
};

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
// 64 x 64 and 96 x 64 for a weight gradient of K <= 64 rows (K6's 6 -> 64
// input conv) and of K <= 96 (K5 at C = 64), 64 or 96 consumer threads and
// 2 or 3 producer warps, several blocks an SM.
using Short = Tile<64, 64, 8, 8, 16, 2>;
using Low = Tile<96, 64, 8, 8, 16, 3>;
// 16 and 32 columns (the AKGM backward's input gradient at C = 128 and 256:
// C / 8 columns a group), 128 consumer threads of 8 x 4 or 8 x 8 outputs on
// a tall tile, and 8 producer warps: the staged operand is rebuilt from two
// tensors there.
using N16 = Tile<256, 16, 8, 4, 16, 8>;
using N32 = Tile<256, 32, 8, 8, 16, 8>;
// 128 pixels by 8, 16 or 32 columns, 4 x 8 outputs a thread (one AKGM
// channel's 8 candidates) and 2 producer warps: the AKGM tails and K5 where
// C is not a multiple of 64, K9 below C = 64.
template <int BN>
using Thin = Tile<128, BN, 4, 8, 16, 2>;
// 64 rows by 32, 16 or 8 columns, 64 consumer threads and 2 producer warps,
// several blocks an SM: K5's weight gradient below C = 64 (K = 9 C / 8 <= 63
// rows, which Thin's 128 would mostly waste).
template <int BN>
using ShortN = Tile<64, BN, BN == 8 ? 4 : 8, BN == 32 ? 4 : 2, 16, 2>;

// What the staging does to a loaded value of type E: x * a + t, or swish of
// it (the border stays 0 = swish(0)). In bf16 the product, the sum and the
// swish's sigmoid and product are each rounded to bf16, as the TPU kernel's
// bf16 staging computes them (_stage_padfree of
// ucdir_tpu/ops/akgm_pallas.py). pairs: the same on 4 bf16 values loaded
// 4-wide, x, a and t as packed pairs (Elem::ld4raw), into 4 floats in x: the
// fold two values at a time in bf16 arithmetic (its sum rounded once, where
// apply adds in float and then rounds: they differ only where that float sum
// is inexact and lands on a bf16 midpoint).
struct Affine {
  static constexpr bool kDz = false;
  static constexpr bool kAffine = true;
  static constexpr bool kAtt = false;
  template <class E>
  static __device__ __forceinline__ float apply(float v, float a, float t) {
    if constexpr (Elem<E>::kLow) {
      return Elem<E>::rnd(__fadd_rn(Elem<E>::rnd(__fmul_rn(v, a)), t));
    } else {
      return fmaf(v, a, t);
    }
  }
  template <class E>
  static __device__ __forceinline__ void pairs(float (&x)[4],
                                               const float (&a)[4],
                                               const float (&t)[4]) {
    x[0] = Elem<E>::add2(Elem<E>::mul2(x[0], a[0]), t[0]);
    x[1] = Elem<E>::add2(Elem<E>::mul2(x[1], a[1]), t[1]);
    Elem<E>::unpack4(x);
  }
};
struct Preact {
  static constexpr bool kDz = false;
  static constexpr bool kAffine = true;
  static constexpr bool kAtt = false;
  template <class E>
  static __device__ __forceinline__ float swish(float u) {
    const float sig = Elem<E>::rnd(1.f / (1.f + expf(-u)));
    return Elem<E>::rnd(__fmul_rn(u, sig));
  }
  template <class E>
  static __device__ __forceinline__ float apply(float v, float a, float t) {
    if constexpr (Elem<E>::kLow) {
      return swish<E>(Affine::apply<E>(v, a, t));
    } else {
      return swishf(fmaf(v, a, t));
    }
  }
  template <class E>
  static __device__ __forceinline__ void pairs(float (&x)[4],
                                               const float (&a)[4],
                                               const float (&t)[4]) {
    Affine::pairs<E>(x, a, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = swish<E>(x[j]);
  }
};

struct Raw {
  static constexpr bool kDz = false;
  static constexpr bool kAffine = false;
  static constexpr bool kAtt = false;
  template <class E>
  static __device__ __forceinline__ float apply(float v, float, float) {
    return v;
  }
  template <class E>
  static __device__ __forceinline__ void pairs(float (&x)[4],
                                               const float (&)[4],
                                               const float (&)[4]) {
    Elem<E>::unpack4(x);
  }
};
// The backward's input gradient: Raw's staging, an instance of its own so
// that a trace tells it from K3.
struct Dgrad : Raw {};
// K9's staging: x * a + t, 0 outside the image, then times the row's pixel's
// scale of the column's input group, op.ascale[m * 8 + ci / op.cg].
struct AttScaled : Affine {
  static constexpr bool kAtt = true;
};

// The AKGM backward's input gradient stages dz = do[c] * att[j] (att times
// attw) of the pixel, rebuilt from the two tensors: x is do (C channels a
// pixel) from the group's first channel, and k = tap * cin + nl reads column
// nl of the group's cin = C dz columns: channel nl / 8, candidate nl % 8.
struct Dz {
  static constexpr bool kDz = true;
  static constexpr bool kAffine = false;
  static constexpr bool kAtt = false;
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

// A 16-byte copy from global to shared memory that runs on while the thread
// goes on; full = false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
// Waits for every cp_async16 of this thread.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// ---- end of PTX primitives

// One slice of A and Wt in registers, between its global loads and its
// stores to shared memory.
template <class T>
struct Staged {
  float a[T::AI][4];   // raw inputs, 4 consecutive k of one pixel each
  float sa[4], st[4];  // the affine of those k columns
  float dv[T::AI];     // Dz: do of each row's pixel
  int grp[4];          // AttScaled: the input group of each of the 4 k
  uint32_t mask;       // bit 4 * i + j: a[i][j] is inside the image and K
  float b[T::BI][2][4];  // 4 consecutive columns of two rows of Wt each
};

// The A column a thread stages: k = slice * BK + 4 * (tid % KG), as a tap and
// a channel, and for AttScaled the channel's input group and its place in it
// (ci = grp * cg + gc), advanced slice by slice with additions.
struct KColumn {
  int tap, ci;
  int grp, gc;
};

// The operands of a product, E their element type in device memory (Dz and
// AttScaled: float).
template <class E>
struct OperandsT {
  const E* xb;      // image b's (H, W, C) input
  const E* ab;      // image b's (C) scale or null
  const E* tb;      // image b's (C) shift or null
  const float* att; // Dz: image b's (H, W, 8) attention times attw
  const float* ascale;  // AttScaled: the block's (BM, 8) scales, shared
  const E* w;       // (K, ncols) weights
  int ncols;
  int cg;           // AttScaled: channels per input group
  bool vec_a;       // cin % 4 == 0 and xb, ab, tb aligned to 4 elements
  bool vec_w;       // ncols % 4 == 0 and w aligned to 4 elements
};
using Operands = OperandsT<float>;

// The Wt half of a slice: rows k0 .. k0 + BK - 1, columns n0 .. n0 + BN - 1.
template <class T, class E>
__device__ __forceinline__ void load_w_slice(Staged<T>& s,
                                             const OperandsT<E>& op,
                                             const Geom& g, int k0, int n0) {
  const int tid = threadIdx.x - T::NC;  // among the producers
#pragma unroll
  for (int i = 0; i < T::BI; ++i) {
    const int u = tid + i * T::NP;
    const int n = n0 + 4 * (u % T::CG);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = k0 + 2 * (u / T::CG) + r;
      const E* wr = op.w + (int64_t)k * op.ncols + n;
      const bool row = (T::BU % T::NP == 0 || u < T::BU) && k < g.K;
      if (op.vec_w) {
        if (row && n < op.ncols) {
          Elem<E>::ld4raw(s.b[i][r], wr);
        } else {
          Elem<E>::zero4(s.b[i][r]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s.b[i][r][j] =
              (row && n + j < op.ncols) ? Elem<E>::ld(wr + j) : 0.f;
      }
    }
  }
}

template <class T, class X, class E>
__device__ __forceinline__ void load_slice(Staged<T>& s, KColumn& kc,
                                           const OperandsT<E>& op,
                                           const Geom& g,
                                           const int* iy0, const int* ix0,
                                           int k0, int n0) {
  const int tid = threadIdx.x - T::NC;  // among the producers
  const int am = tid / T::KG;
  const int ntaps = g.ks * g.ks;
  s.mask = 0u;
  if constexpr (X::kDz) {  // g.cin % 8 == 0: four candidates of a channel
    const bool valid = kc.tap < ntaps;
    const int ty = kc.tap / 3;
    const int tx = kc.tap - ty * 3;
#pragma unroll
    for (int i = 0; i < T::AI; ++i) {
      const int m = am + i * T::AROWS;
      const int iy = iy0[m] + ty;
      const int ix = ix0[m] + tx;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      s.dv[i] = 0.f;
      if (valid && (unsigned)iy < (unsigned)g.H &&
          (unsigned)ix < (unsigned)g.W) {
        const int64_t pix = (int64_t)iy * g.W + ix;
        s.dv[i] = Elem<E>::ldg(op.xb + pix * g.C + kc.ci / 8);
        v = __ldg(reinterpret_cast<const float4*>(op.att + pix * 8 +
                                                  kc.ci % 8));
        s.mask |= 0xfu << (4 * i);
      }
      s.a[i][0] = v.x; s.a[i][1] = v.y; s.a[i][2] = v.z; s.a[i][3] = v.w;
    }
    kc.ci += T::BK;
    while (kc.ci >= g.cin) {
      kc.ci -= g.cin;
      ++kc.tap;
    }
  } else if (op.vec_a) {
    const bool valid = kc.tap < ntaps;
    const int ty = kc.tap / 3;
    const int tx = kc.tap - ty * 3;
    if (X::kAffine && valid && op.ab != nullptr) {
      Elem<E>::ld4raw(s.sa, op.ab + kc.ci);
      Elem<E>::ld4raw(s.st, op.tb + kc.ci);
    } else {
      Elem<E>::one4(s.sa);
      Elem<E>::zero4(s.st);
    }
#pragma unroll
    for (int i = 0; i < T::AI; ++i) {
      const int m = am + i * T::AROWS;
      const int iy = iy0[m] + ty;
      const int ix = ix0[m] + tx;
      if (valid && (unsigned)iy < (unsigned)g.H &&
          (unsigned)ix < (unsigned)g.W) {
        Elem<E>::ld4raw(s.a[i],
                        op.xb + ((int64_t)iy * g.W + ix) * g.C + kc.ci);
        s.mask |= 0xfu << (4 * i);
      } else {
        Elem<E>::zero4(s.a[i]);
      }
    }
    if constexpr (X::kAtt) {  // a run of 4 channels may cross a group
      int gv = kc.grp, cv = kc.gc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s.grp[j] = gv;
        if (++cv == op.cg) {
          cv = 0;
          ++gv;
        }
      }
      kc.gc += T::BK;
      while (kc.gc >= op.cg) {
        kc.gc -= op.cg;
        ++kc.grp;
      }
    }
    kc.ci += T::BK;
    while (kc.ci >= g.cin) {
      kc.ci -= g.cin;
      ++kc.tap;
      if constexpr (X::kAtt) kc.grp -= 8;  // g.cin = 8 groups of op.cg
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
      if constexpr (X::kAtt) s.grp[j] = ci / op.cg;
      const bool aff = X::kAffine && op.ab != nullptr;
      s.sa[j] = aff ? Elem<E>::ld(op.ab + ci) : 1.f;
      s.st[j] = aff ? Elem<E>::ld(op.tb + ci) : 0.f;
#pragma unroll
      for (int i = 0; i < T::AI; ++i) {
        const int m = am + i * T::AROWS;
        const int iy = iy0[m] + ty;
        const int ix = ix0[m] + tx;
        float v = 0.f;
        if (valid && (unsigned)iy < (unsigned)g.H &&
            (unsigned)ix < (unsigned)g.W) {
          v = Elem<E>::ld(op.xb + ((int64_t)iy * g.W + ix) * g.C + ci);
          s.mask |= 1u << (4 * i + j);
        }
        s.a[i][j] = v;
      }
    }
  }
  load_w_slice<T, E>(s, op, g, k0, n0);
}

template <class T, class E>
__device__ __forceinline__ void store_w_slice(const Staged<T>& s,
                                              const OperandsT<E>& op,
                                              float* Bs) {
  const int tid = threadIdx.x - T::NC;  // among the producers
#pragma unroll
  for (int i = 0; i < T::BI; ++i) {
    const int u = tid + i * T::NP;
    if (T::BU % T::NP != 0 && u >= T::BU) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float b[4] = {s.b[i][r][0], s.b[i][r][1], s.b[i][r][2], s.b[i][r][3]};
      if (op.vec_w) Elem<E>::unpack4(b);
      *reinterpret_cast<float4*>(Bs + (2 * (u / T::CG) + r) * T::SB +
                                 4 * (u % T::CG)) =
          make_float4(b[0], b[1], b[2], b[3]);
    }
  }
}

template <class T, class X, class E>
__device__ __forceinline__ void store_slice(const Staged<T>& s,
                                            const OperandsT<E>& op, float* As,
                                            float* Bs) {
  const int tid = threadIdx.x - T::NC;  // among the producers
  const int kg = tid % T::KG;
  const int am = tid / T::KG;
  // bf16 loaded 4-wide: packed pairs, staged by X::pairs
  constexpr bool kPairs = Elem<E>::kLow && !X::kDz;
  const bool pairs = kPairs && op.vec_a;
#pragma unroll
  for (int i = 0; i < T::AI; ++i) {
    float a[4] = {s.a[i][0], s.a[i][1], s.a[i][2], s.a[i][3]};
    if constexpr (kPairs) {
      if (pairs) X::template pairs<E>(a, s.sa, s.st);
    }
    float sc[4];  // AttScaled: one load where the run lies in one group
    if constexpr (X::kAtt) {
      const float* arow = op.ascale + (am + i * T::AROWS) * 8;
      sc[0] = arow[s.grp[0]];
      if (s.grp[3] == s.grp[0]) {
        sc[1] = sc[2] = sc[3] = sc[0];
      } else {
#pragma unroll
        for (int j = 1; j < 4; ++j) sc[j] = arow[s.grp[j]];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = 0.f;
      if ((s.mask >> (4 * i + j)) & 1u) {
        if constexpr (X::kDz) {
          v = Elem<E>::rnd(s.dv[i] * a[j]);
        } else if constexpr (kPairs) {
          v = pairs ? a[j] : X::template apply<E>(a[j], s.sa[j], s.st[j]);
        } else {
          v = X::template apply<E>(a[j], s.sa[j], s.st[j]);
          if constexpr (X::kAtt) v *= sc[j];
        }
      }
      As[(4 * kg + j) * T::SA + am + i * T::AROWS] = v;
    }
  }
  store_w_slice<T, E>(s, op, Bs);
}

struct NoHook {
  __device__ __forceinline__ void operator()(int) const {}
};

// The producers' side of the product: stages slice 0, then in iteration i stores
// slice i + 1, loaded one iteration earlier, into stage (i + 1) % 2 and starts
// the loads of slice i + 2 into the registers the store has freed, so that a
// load has a whole iteration to arrive. hook(i) runs in every iteration i
// before its barrier; in iteration 0 the consumers have passed their first
// barrier of this product.
template <class T, class X, class E, class Hook = NoHook>
__device__ __forceinline__ void produce(float* smem, const OperandsT<E>& op,
                                        const Geom& g, int n0, int nk,
                                        const Hook& hook = Hook()) {
  const int pt = threadIdx.x - T::NC;
  const int* iy0 = reinterpret_cast<const int*>(smem + T::ORG);
  const int* ix0 = iy0 + T::BM;
  float* As = smem;
  float* Bs = smem + 2 * T::A_WORDS;
  KColumn kc;
  kc.tap = 4 * (pt % T::KG) / g.cin;
  kc.ci = 4 * (pt % T::KG) - kc.tap * g.cin;
  if constexpr (X::kAtt) {
    kc.grp = kc.ci / op.cg;
    kc.gc = kc.ci - kc.grp * op.cg;
  }
  Staged<T> s;
  load_slice<T, X, E>(s, kc, op, g, iy0, ix0, 0, n0);
  store_slice<T, X, E>(s, op, As, Bs);
  if (nk > 1) load_slice<T, X, E>(s, kc, op, g, iy0, ix0, T::BK, n0);
  block_sync<T::NT>();
  for (int i = 0; i < nk; ++i) {
    const int nxt = (i + 1) & 1;
    if (i + 1 < nk)
      store_slice<T, X, E>(s, op, As + nxt * T::A_WORDS,
                           Bs + nxt * T::B_WORDS);
    if (i + 2 < nk)
      load_slice<T, X, E>(s, kc, op, g, iy0, ix0, (i + 2) * T::BK, n0);
    hook(i);
    block_sync<T::NT>();
  }
}

// What the producers stage for the epilogues besides the product: nothing.
struct NoStage {
  __device__ __forceinline__ void block(int) const {}
  __device__ __forceinline__ void tile(int) const {}
};

// The producers of the AKGM tail's per-group product (K1, K8 and K5's z
// recompute): column tiles nt0 .. nt1 - 1 of the (9 * C / 8, 8 * C) weights
// w in turn, each staging its group's g.cin = C / 8 channels of image b's
// x * a + t (a, t null: x); a tile's first two slices are loaded and stored
// while the consumers run the epilogue of the tile before. st.block(nt0)
// runs first; st.tile(nt + 1) runs while the consumers multiply tile nt.
template <class T, class E, class Stage = NoStage>
__device__ __forceinline__ void grouped_produce(
    float* smem, const E* __restrict__ x, const E* __restrict__ a,
    const E* __restrict__ t, const E* __restrict__ w, const Geom& g,
    int b, int nt0, int nt1, int nk, bool vec_a,
    const Stage& st = Stage()) {
  const int C = g.C;
  st.block(nt0);
  for (int nt = nt0; nt < nt1; ++nt) {
    const int n0 = nt * T::BN;
    const int cin0 = (n0 / C) * g.cin;
    OperandsT<E> op;
    op.xb = x + (int64_t)b * g.H * g.W * C + cin0;
    op.ab = a ? a + (int64_t)b * C + cin0 : nullptr;
    op.tb = t ? t + (int64_t)b * C + cin0 : nullptr;
    op.att = nullptr;
    op.w = w;
    op.ncols = 8 * C;
    op.vec_a = vec_a;
    op.vec_w = true;
    produce<T, Affine>(smem, op, g, n0, nk, [&](int i) {
      if (i == 0 && nt + 1 < nt1) st.tile(nt + 1);
    });
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
// optional swish, rounded to E, store, and with stats the tile's per-column
// sum and sum of squares of the stored values added into the buffer at
// smem + T::RED. vec: N % GW == 0 and out aligned to a group of GW columns.
// DZ: the backward's dz = go * swish'(acc + bias) in place of the output,
// go (B, P, N) read as the output is stored, rounded to E once, no
// statistics.
template <class T, bool DZ, class E>
__device__ __forceinline__ void conv_epilogue_pc(
    const float (&acc)[T::TM][T::TN], float* smem,
    const E* __restrict__ bias, E* __restrict__ out, bool stats,
    int act, bool vec, int P, int N, int b, int m0, int n0,
    const E* __restrict__ go) {
  const int tn = threadIdx.x % T::NCX;
  const int tm = threadIdx.x / T::NCX;
  float* red = smem + T::RED;
  float bj[T::TN], s[T::TN], q[T::TN];
#pragma unroll
  for (int j = 0; j < T::TN; ++j) {
    const int n = n0 + tile_col<T>(tn, j);
    bj[j] = (bias != nullptr && n < N) ? Elem<E>::ld(bias + n) : 0.f;
    s[j] = 0.f;
    q[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int p = m0 + tile_row<T>(tm, i);
    if (p >= P) continue;
    E* orow = out + ((int64_t)b * P + p) * N;
#pragma unroll
    for (int g = 0; g < T::NG; ++g) {
      const int n = n0 + tile_col<T>(tn, T::GW * g);
      float v[T::GW];
      if constexpr (DZ) {
        const E* grow = go + ((int64_t)b * P + p) * N + n;
        float gv[T::GW];
        if (vec && n + T::GW <= N) {
          if constexpr (T::GW == 4) {
            Elem<E>::ld4(gv, grow);
          } else {
            Elem<E>::ld2(gv, grow);
          }
        } else {
#pragma unroll
          for (int j = 0; j < T::GW; ++j)
            gv[j] = n + j < N ? Elem<E>::ld(grow + j) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < T::GW; ++j)
          v[j] = gv[j] * dswishf(acc[i][T::GW * g + j] + bj[T::GW * g + j]);
      } else {
#pragma unroll
        for (int j = 0; j < T::GW; ++j) {
          v[j] = acc[i][T::GW * g + j] + bj[T::GW * g + j];
          if (act) v[j] = swishf(v[j]);
          v[j] = Elem<E>::rnd(v[j]);
        }
      }
      if (vec && n + T::GW <= N) {
        if constexpr (T::GW == 4) {
          Elem<E>::st4(orow + n, v);
        } else {
          Elem<E>::st2(orow + n, v[0], v[1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < T::GW; ++j) {
          if (n + j < N) Elem<E>::st(orow + n + j, v[j]);
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

template <class E>
struct ConvArgsT {
  const E* x;         // (B, H, W, cin) NHWC
  const E* w;         // (K, cout), row tap * cin + ci
  const E* bias;      // (cout) or null
  const E* a;         // (B, cin) or null
  const E* t;         // (B, cin) or null
  E* out;             // (B, Ho, Wo, cout)
  float* ssum;        // zeroed (B, cout) or null
  float* ssq;
  const E* go;        // DZ: (B, Ho, Wo, cout) output cotangent
  Geom g;
  int cout, act;
  int ntn;            // column tiles; blockIdx.x = pixel tile * ntn + column tile
  bool vec_a, vec_w, vec_out;
};

// out = act(conv(X(x * a + t)) + bias) and its statistics: one BM x BN tile
// of one image per block. DZ: out = go * swish'(conv(X(x * a + t)) + bias).
template <class T, class X, bool DZ, class E>
__global__ void __launch_bounds__(T::NT) conv_pc_kernel(ConvArgsT<E> c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int mt = blockIdx.x / c.ntn;
  const int m0 = mt * T::BM;
  const int n0 = (blockIdx.x - mt * c.ntn) * T::BN;
  OperandsT<E> op;
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
    conv_epilogue_pc<T, DZ, E>(acc, smem, c.bias, c.out, c.ssum != nullptr,
                            c.act, c.vec_out, c.g.Ho * c.g.Wo, c.cout, b, m0,
                            n0, c.go);
  }
  if (c.ssum != nullptr) flush_stats<T>(smem, c.ssum, c.ssq, c.cout, b, n0);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <class T, class X, bool DZ, class E>
int launch_tile(ConvArgsT<E> c, int B, cudaStream_t stream) {
  const int P = c.g.Ho * c.g.Wo;
  c.vec_out = c.cout % T::GW == 0 && aligned(c.out, sizeof(E) * T::GW) &&
              (!DZ || aligned(c.go, sizeof(E) * T::GW));
  c.ntn = (c.cout + T::BN - 1) / T::BN;
  const dim3 grid((unsigned)((P + T::BM - 1) / T::BM) * c.ntn, 1, B);
  conv_pc_kernel<T, X, DZ, E><<<grid, T::NT, T::SMEM_BYTES, stream>>>(c);
  return (int)cudaGetLastError();
}

// Launches the convolution on the tile that cout selects. c.g, the pointers,
// cout and act are the caller's; the rest is filled here.
template <class X, bool DZ = false, class E>
int launch_conv(ConvArgsT<E> c, int B, cudaStream_t stream) {
  constexpr uintptr_t run = 4 * sizeof(E);  // a 4-wide load
  const bool affine_ok =
      (c.a == nullptr || (aligned(c.a, run) && aligned(c.t, run)));
  c.vec_a = c.g.cin % 4 == 0 && c.g.C % 4 == 0 && aligned(c.x, run) &&
            affine_ok;
  c.vec_w = c.cout % 4 == 0 && aligned(c.w, run);
  if (c.cout >= 128) return launch_tile<Wide, X, DZ>(c, B, stream);
  if (c.cout > 8) return launch_tile<Mid, X, DZ>(c, B, stream);
  return launch_tile<Narrow, X, DZ>(c, B, stream);
}

// ---- The weight gradient
//   dW (K x N) = A^T D,  dbias (N) = sum of the rows of D,
// reduced over pixels: A the im2col matrix of the forward product (row =
// pixel, column k = tap * cin + ci of x * a + t, 0 outside the image AFTER
// the affine), D the (pixels x N) cotangent. The M side of the tile is k, the
// N side the columns of D, and the reduction runs over BK pixels a slice, so
// consume() is the forward's own. The pixels of the batch, taken in order
// across images, are cut into S chunks of a multiple of BK; block (tile,
// chunk) writes its partial tile with plain stores to a workspace (S, K + 1,
// N) whose row K holds the chunk's partial bias, and wgrad_reduce_kernel adds
// the S partials in ascending chunk order. No atomics: dW and dbias have the
// same bits from run to run.
//
// Producers: a thread stages one 4-wide k group (fixed for the block, so its
// tap, channel and border offsets are computed once) for AW pixel rows a
// slice, 16 bytes along the channels of x where cin % 4 == 0; the rows'
// (image, y, x) advance by BK pixels a slice with additions. The same
// threads stage BK pixels of D, 16 bytes along its columns, and sum them for
// the bias.
//
// float32 (K5's and K6's bf16 forms run on the tensor cores, igemm_tc.cuh
// wgrad_tc_kernel, which shares wgrad_reduce_kernel: dW and dbias rounded
// once to their type after the whole float32 sum).
template <class E>
struct WgradArgsT {
  const E* x;        // (B, H, W, g.C) NHWC input
  const E* a;        // (B, g.C) scale or null
  const E* t;        // (B, g.C) shift or null
  const E* d;        // PlainD: (npix, N) cotangent; DzD: do (npix, N / 8)
  const float* att;  // DzD: (npix, 8) attention times attw
  float* ws;         // (S, K + 1, N) partial sums
  Geom g;            // stride 1; g.cin channels of x per group, g.K = 9 * cin
  int N;             // columns of dW
  int gw;            // columns per group: group n / gw reads channels
                     // [(n / gw) * cin, + cin) of x
  int npix;          // B * H * W
  int chunk;         // pixels per block, a multiple of BK
  int ntn;           // column tiles; blockIdx.x = k tile * ntn + column tile
  bool vec_a;        // cin % 4 == 0, g.C % 4 == 0, x, a, t aligned to 4
  bool vec_d;        // 4-wide loads of D (PlainD: N % 4 == 0 and aligned)
  bool vec_ws;       // N % 4 == 0 and ws 16-byte aligned
};

// D[q][n..n+3] of the plain convolution: the cotangent itself.
struct PlainD {
  static constexpr bool kGroups = false;  // K6: one group, gw = N
  template <class E>
  static __device__ __forceinline__ void load(float (&v)[4],
                                              const WgradArgsT<E>& w,
                                              int64_t q, int n) {
    const E* r = w.d + q * w.N + n;
    if (w.vec_d) {
      Elem<E>::ld4(v, r);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = n + j < w.N ? Elem<E>::ld(r + j) : 0.f;
    }
  }
};

// D[q][n..n+3] of the AKGM tail, rebuilt: dz[c * 8 + j] = do[c] * att[j]
// (att already times attw), n % 4 == 0 so the four share channel c = n / 8.
struct DzD {
  static constexpr bool kGroups = true;  // K5: groups of gw = C of N = 8 C
  template <class E>
  static __device__ __forceinline__ void load(float (&v)[4],
                                              const WgradArgsT<E>& w,
                                              int64_t q, int n) {
    const E* pd = w.d + q * (w.N / 8) + n / 8;
    const float4 u =
        __ldg(reinterpret_cast<const float4*>(w.att + q * 8 + n % 8));
    const float d = Elem<E>::ldg(pd);
    v[0] = d * u.x; v[1] = d * u.y; v[2] = d * u.z; v[3] = d * u.w;
  }
};

template <class T>
struct WgradShape {
  static constexpr int KGW = T::BM / 4;         // k groups of a pixel row
  static constexpr int RSTEP = T::NP / KGW;     // pixel rows per pass
  static constexpr int AW = T::BK / RSTEP;      // passes: rows per thread
  static constexpr int DG = T::BN / 4;          // 4-wide column groups of D
  static constexpr int DU = T::BK * DG;         // 4-wide loads of D a slice
  static constexpr int DI = (DU + T::NP - 1) / T::NP;
  static_assert(T::NP % KGW == 0 && T::BK % RSTEP == 0 && AW <= 8,
                "wgrad staging");
  static_assert(T::B_WORDS >= T::BK * T::BN, "bias rows fit a stage of Bs");
};

// One slice of A and D in registers, and where the producer's rows are.
template <class T>
struct WgradStaged {
  using S = WgradShape<T>;
  float a[S::AW][4];
  float sa[S::AW][4], st[S::AW][4];
  uint32_t mask;              // bit 4 * i + j: a[i][j] is inside
  float d[S::DI][4];
  int py[S::AW], px[S::AW];   // the rows' pixel, advanced by BK a slice
  int pb[S::AW];              // and its image
  int lb[S::AW];              // the image of sa and st (-1: none yet)
};

// The producer's fixed k group: tap offsets and channels of its 4 columns.
struct KGroup {
  int dy[4], dx[4], ci[4];
  bool kv[4];
};

template <class T>
__device__ __forceinline__ void wgrad_advance(WgradStaged<T>& s,
                                              const Geom& g) {
#pragma unroll
  for (int i = 0; i < WgradShape<T>::AW; ++i) {
    s.px[i] += T::BK;
    while (s.px[i] >= g.W) {
      s.px[i] -= g.W;
      ++s.py[i];
    }
    while (s.py[i] >= g.H) {
      s.py[i] -= g.H;
      ++s.pb[i];
    }
  }
}

template <class T, class DL, class E>
__device__ __forceinline__ void wgrad_load(WgradStaged<T>& s, const KGroup& kg,
                                           const WgradArgsT<E>& w, int cin0,
                                           int64_t qs, int64_t q1, int n0) {
  using S = WgradShape<T>;
  const int tid = threadIdx.x - T::NC;
  const int pr = tid / S::KGW;
  const Geom& g = w.g;
  s.mask = 0u;
#pragma unroll
  for (int i = 0; i < S::AW; ++i) {
    const int64_t q = qs + pr + i * S::RSTEP;
    const bool in = q < q1;
    // the affine of the row's image, loaded again only when it changes
    const bool reload = w.a != nullptr && in && s.pb[i] != s.lb[i];
    if (reload) s.lb[i] = s.pb[i];
    if (w.vec_a) {
      const int iy = s.py[i] + kg.dy[0];
      const int ix = s.px[i] + kg.dx[0];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in && kg.kv[0] && (unsigned)iy < (unsigned)g.H &&
          (unsigned)ix < (unsigned)g.W) {
        v = __ldg(reinterpret_cast<const float4*>(
            w.x + (q + kg.dy[0] * g.W + kg.dx[0]) * g.C + cin0 + kg.ci[0]));
        s.mask |= 0xfu << (4 * i);
      }
      if (reload) {
        const int64_t o = (int64_t)s.pb[i] * g.C + cin0 + kg.ci[0];
        const float4 u = __ldg(reinterpret_cast<const float4*>(w.a + o));
        const float4 r = __ldg(reinterpret_cast<const float4*>(w.t + o));
        s.sa[i][0] = u.x; s.sa[i][1] = u.y; s.sa[i][2] = u.z;
        s.sa[i][3] = u.w;
        s.st[i][0] = r.x; s.st[i][1] = r.y; s.st[i][2] = r.z;
        s.st[i][3] = r.w;
      }
      s.a[i][0] = v.x; s.a[i][1] = v.y; s.a[i][2] = v.z; s.a[i][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int iy = s.py[i] + kg.dy[j];
        const int ix = s.px[i] + kg.dx[j];
        float v = 0.f;
        if (in && kg.kv[j] && (unsigned)iy < (unsigned)g.H &&
            (unsigned)ix < (unsigned)g.W) {
          v = Elem<E>::ld(w.x + (q + kg.dy[j] * g.W + kg.dx[j]) * g.C + cin0 +
                          kg.ci[j]);
          s.mask |= 1u << (4 * i + j);
        }
        if (reload) {
          const int64_t o = (int64_t)s.pb[i] * g.C + cin0 + kg.ci[j];
          s.sa[i][j] = Elem<E>::ld(w.a + o);
          s.st[i][j] = Elem<E>::ld(w.t + o);
        }
        s.a[i][j] = v;
      }
    }
  }
  wgrad_advance<T>(s, g);
#pragma unroll
  for (int i = 0; i < S::DI; ++i) {
    const int u = tid + i * T::NP;
    const int64_t q = qs + u / S::DG;
    const int n = n0 + 4 * (u % S::DG);
#pragma unroll
    for (int j = 0; j < 4; ++j) s.d[i][j] = 0.f;
    if ((S::DU % T::NP == 0 || u < S::DU) && q < q1 && n < w.N)
      DL::load(s.d[i], w, q, n);
  }
}

template <class T, class DL, class E>
__device__ __forceinline__ void wgrad_store(
    const WgradStaged<T>& s, float* As, float* Bs,
    float (&bsum)[WgradShape<T>::DI][4]) {
  using S = WgradShape<T>;
  const int tid = threadIdx.x - T::NC;
  const int kg = tid % S::KGW;
  const int pr = tid / S::KGW;
#pragma unroll
  for (int i = 0; i < S::AW; ++i) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (s.mask >> (4 * i + j)) & 1u
                 ? fmaf(s.a[i][j], s.sa[i][j], s.st[i][j])
                 : 0.f;
    *reinterpret_cast<float4*>(As + (pr + i * S::RSTEP) * T::SA + 4 * kg) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
#pragma unroll
  for (int i = 0; i < S::DI; ++i) {
    const int u = tid + i * T::NP;
    if (S::DU % T::NP != 0 && u >= S::DU) break;
    const float* d = s.d[i];
    *reinterpret_cast<float4*>(Bs + (u / S::DG) * T::SB + 4 * (u % S::DG)) =
        make_float4(d[0], d[1], d[2], d[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) bsum[i][j] += d[j];
  }
}

// The producers' side of the weight gradient, in produce()'s order; at the
// end the per-thread bias sums go to stage 0 of Bs, row = the thread's pixel
// row of D.
template <class T, class DL, class E>
__device__ __forceinline__ void wgrad_produce(float* smem,
                                              const WgradArgsT<E>& w,
                                              int cin0, int m0, int n0,
                                              int64_t q0, int64_t q1, int nk) {
  using S = WgradShape<T>;
  const int tid = threadIdx.x - T::NC;
  const int pr = tid / S::KGW;
  const Geom& g = w.g;
  float* As = smem;
  float* Bs = smem + 2 * T::A_WORDS;
  KGroup kg;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = m0 + 4 * (tid % S::KGW) + j;
    kg.kv[j] = k < g.K;
    const int tap = kg.kv[j] ? k / g.cin : 0;
    kg.ci[j] = kg.kv[j] ? k - tap * g.cin : 0;
    kg.dy[j] = tap / 3 - 1;
    kg.dx[j] = tap % 3 - 1;
  }
  WgradStaged<T> s;
#pragma unroll
  for (int i = 0; i < S::AW; ++i) {
    s.lb[i] = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s.sa[i][j] = 1.f;
      s.st[i][j] = 0.f;
    }
    const int64_t q = q0 + pr + i * S::RSTEP;
    const int p = (int)(q % ((int64_t)g.H * g.W));
    s.pb[i] = (int)(q / ((int64_t)g.H * g.W));
    s.py[i] = p / g.W;
    s.px[i] = p - s.py[i] * g.W;
  }
  float bsum[S::DI][4];
#pragma unroll
  for (int i = 0; i < S::DI; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) bsum[i][j] = 0.f;
  }
  wgrad_load<T, DL>(s, kg, w, cin0, q0, q1, n0);
  wgrad_store<T, DL, E>(s, As, Bs, bsum);
  if (nk > 1) wgrad_load<T, DL>(s, kg, w, cin0, q0 + T::BK, q1, n0);
  block_sync<T::NT>();
  for (int i = 0; i < nk; ++i) {
    const int nxt = (i + 1) & 1;
    if (i + 1 < nk)
      wgrad_store<T, DL, E>(s, As + nxt * T::A_WORDS, Bs + nxt * T::B_WORDS,
                            bsum);
    if (i + 2 < nk)
      wgrad_load<T, DL>(s, kg, w, cin0, q0 + (int64_t)(i + 2) * T::BK, q1,
                        n0);
    block_sync<T::NT>();
  }
#pragma unroll
  for (int i = 0; i < S::DI; ++i) {
    const int u = tid + i * T::NP;
    if (S::DU % T::NP != 0 && u >= S::DU) break;
    *reinterpret_cast<float4*>(Bs + (u / S::DG) * T::SB + 4 * (u % S::DG)) =
        make_float4(bsum[i][0], bsum[i][1], bsum[i][2], bsum[i][3]);
  }
}

// dW's partial tile of one chunk, and with the first k tile its partial
// bias: plain stores into chunk blockIdx.y's (K + 1, N) slab of w.ws.
template <class T, class DL, class E>
__global__ void __launch_bounds__(T::NT) wgrad_pc_kernel(WgradArgsT<E> w) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int mt = blockIdx.x / w.ntn;
  const int m0 = mt * T::BM;
  const int n0 = (blockIdx.x - mt * w.ntn) * T::BN;
  const int64_t q0 = (int64_t)blockIdx.y * w.chunk;
  const int64_t q1 = q0 + w.chunk < w.npix ? q0 + w.chunk : w.npix;
  const int nk = (int)((q1 - q0 + T::BK - 1) / T::BK);
  const int cin0 = (n0 / w.gw) * w.g.cin;
  const int K = w.g.K;
  float* slab = w.ws + (int64_t)blockIdx.y * (K + 1) * w.N;
  if (threadIdx.x >= T::NC) {
    wgrad_produce<T, DL>(smem, w, cin0, m0, n0, q0, q1, nk);
  } else {
    float acc[T::TM][T::TN];
    consume<T>(acc, smem, nk);
    const int tn = threadIdx.x % T::NCX;
    const int tm = threadIdx.x / T::NCX;
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int k = m0 + tile_row<T>(tm, i);
      if (k >= K) continue;
      float* row = slab + (int64_t)k * w.N;
#pragma unroll
      for (int g = 0; g < T::NG; ++g) {
        const int n = n0 + tile_col<T>(tn, T::GW * g);
        const float* v = &acc[i][T::GW * g];
        if (T::GW == 4 && w.vec_ws && n + 4 <= w.N) {
          *reinterpret_cast<float4*>(row + n) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < T::GW; ++j)
            if (n + j < w.N) row[n + j] = v[j];
        }
      }
    }
  }
  if (mt != 0) return;
  // the bias: the producers' row sums, added in ascending row order
  block_sync<T::NT>();
  const float* Bs = smem + 2 * T::A_WORDS;
  for (int c = threadIdx.x; c < T::BN; c += T::NT) {
    if (n0 + c >= w.N) continue;
    float v = 0.f;
    for (int r = 0; r < T::BK; ++r) v += Bs[r * T::SB + c];
    slab[(int64_t)K * w.N + n0 + c] = v;
  }
}

// dW (K, N) and dbias (N): the S partials of ws added in ascending order in
// float32, each result rounded once to E (an instance per D loader, so that
// a trace tells K5's from K6's).
template <class DL, class E>
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws,
                                    E* __restrict__ dw,
                                    E* __restrict__ dbias, int K, int N,
                                    int S) {
  const int64_t slab = (int64_t)(K + 1) * N;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < slab;
       e += (int64_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += ws[s * slab + e];
    if (e < (int64_t)K * N)
      Elem<E>::st(dw + e, v);
    else
      Elem<E>::st(dbias + (e - (int64_t)K * N), v);
  }
}

template <class T, class DL, class E>
int launch_wgrad_tile(WgradArgsT<E> w, int splits, E* dw, E* dbias,
                      cudaStream_t stream) {
  w.ntn = (w.N + T::BN - 1) / T::BN;
  const int mtiles = (w.g.K + T::BM - 1) / T::BM;
  int chunk = (int)((w.npix + splits - 1) / splits);
  w.chunk = (chunk + T::BK - 1) / T::BK * T::BK;
  const int used = (int)((w.npix + w.chunk - 1) / w.chunk);
  wgrad_pc_kernel<T, DL, E>
      <<<dim3(mtiles * w.ntn, used), T::NT, T::SMEM_BYTES, stream>>>(w);
  const int64_t n = (int64_t)(w.g.K + 1) * w.N;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  wgrad_reduce_kernel<DL, E><<<blocks, 256, 0, stream>>>(w.ws, dw, dbias,
                                                         w.g.K, w.N, used);
  return (int)cudaGetLastError();
}

// 64 columns by 64 rows where K <= 64, 96 where K <= 96, else 256.
template <class DL, class E>
int launch_wgrad_64(WgradArgsT<E> w, int splits, E* dw, E* dbias,
                    cudaStream_t stream) {
  if (w.g.K <= Short::BM)
    return launch_wgrad_tile<Short, DL>(w, splits, dw, dbias, stream);
  if (w.g.K <= Low::BM)
    return launch_wgrad_tile<Low, DL>(w, splits, dw, dbias, stream);
  return launch_wgrad_tile<Mid, DL>(w, splits, dw, dbias, stream);
}

// BN columns by 64 rows where K <= 64, else by 128.
template <int BN, class DL, class E>
int launch_wgrad_narrow(WgradArgsT<E> w, int splits, E* dw, E* dbias,
                        cudaStream_t stream) {
  if (w.g.K <= ShortN<BN>::BM)
    return launch_wgrad_tile<ShortN<BN>, DL>(w, splits, dw, dbias, stream);
  return launch_wgrad_tile<Thin<BN>, DL>(w, splits, dw, dbias, stream);
}

// dW and dbias on the tile that the group's width selects. One group (K6,
// gw = N): by width, as launch_conv selects by cout: 128 x 128 from 128
// columns, the 64-column tiles from 9, 128 x 8 below. Several groups (K5, gw
// = C of N = 8 C): the widest tile whose columns divide gw, so that no tile
// straddles two groups: 128 x 128 where gw % 128 == 0, the 64-column tiles
// where gw % 64 == 0, else 32, 16 or 8 columns. w.x .. w.gw, w.npix and w.ws
// are the caller's; splits is the number of chunks the caller's workspace
// holds (S), of which the launch uses the ones that a whole number of BK
// pixels fills.
template <class DL, class E>
int launch_wgrad(WgradArgsT<E> w, int splits, E* dw, E* dbias,
                 cudaStream_t stream) {
  constexpr uintptr_t run = 4 * sizeof(E);  // a 4-wide load
  const bool affine_ok =
      (w.a == nullptr || (aligned(w.a, run) && aligned(w.t, run)));
  w.vec_a = w.g.cin % 4 == 0 && w.g.C % 4 == 0 && aligned(w.x, run) &&
            affine_ok;
  w.vec_ws = w.N % 4 == 0 && aligned(w.ws, 16);
  if constexpr (!DL::kGroups) {
    if (w.gw >= 128)
      return launch_wgrad_tile<Wide, DL>(w, splits, dw, dbias, stream);
    if (w.gw > 8) return launch_wgrad_64<DL>(w, splits, dw, dbias, stream);
    return launch_wgrad_tile<Narrow, DL>(w, splits, dw, dbias, stream);
  } else {
    if (w.gw % 128 == 0)
      return launch_wgrad_tile<Wide, DL>(w, splits, dw, dbias, stream);
    if (w.gw % 64 == 0)
      return launch_wgrad_64<DL>(w, splits, dw, dbias, stream);
    if (w.gw % 32 == 0)
      return launch_wgrad_narrow<32, DL>(w, splits, dw, dbias, stream);
    if (w.gw % 16 == 0)
      return launch_wgrad_narrow<16, DL>(w, splits, dw, dbias, stream);
    return launch_wgrad_narrow<8, DL>(w, splits, dw, dbias, stream);
  }
}

}  // namespace pc
}  // namespace ucdir
