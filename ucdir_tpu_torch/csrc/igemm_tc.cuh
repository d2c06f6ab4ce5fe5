// Implicit-GEMM core of the bf16 forward convolutions on the H100's tensor
// cores (sm_90a): the bf16 entry points of K2 (3x3 conv, stride 1 or 2, the
// packed upsampling), K7 (the pre-activated 3x3 head) and K3 (1x1 conv). It
// replaces the bf16 instantiation of the TPU kernels B2, B4, B5, B3 and B6
// (ucdir_tpu/ops/conv_pallas.py _conv3x3_forward_padfree, _downconv_forward,
// upconv2x, conv3x3_preact_pallas, _conv1x1_forward).
// Every fp32 kernel, and K1, K4, K5, K6, K8 and K9 in either type, stay on
// the FMA core of igemm_pc.cuh, whose Geom, Elem<bf16> and staging functors
// Affine, Preact and Raw this core reuses.
//
// The product is the one of igemm_pc.cuh: A (P x K) * Wt (K x N), row p of A
// output pixel p's receptive field (x * a + t, 0 outside the image after the
// affine), Wt the (K, cout) weights. Here A and Wt are bf16 in shared memory
// and the sums fp32 in registers:
//
// 1. wgmma.mma_async m64nNk16 (N = 128, 64 or 8 by cout) from shared-memory
//    descriptors, two consumer warpgroups of 64 rows each, tiles of 128
//    output pixels (8 x 16 for a 3x3 convolution, a run along the row for
//    a 1x1). Each product of two bf16 operands is exact in fp32; the sums
//    run over ascending k16 chunks, each added into the fp32 accumulator by
//    the tensor core in its own way (not an IEEE add rounded to nearest), so
//    the result differs from the FMA core's sequential fmaf in the order and
//    the rounding of the sums, within one bf16 ulp of the plain version.
// 2. A ring of 4 to 8 stages (as many as shared memory holds) of one
//    64-deep slice each (A 16 KB, Wt 128 * BN bytes), handed between the
//    roles by mbarriers: full[s] when a
//    stage is staged, empty[s] when both consumer warpgroups' products on it
//    have completed. One persistent block an SM walks its tiles as one
//    stream of slices, so the producers stage the next tile while the
//    consumers run this one's epilogue (a block per tile paid its set-up,
//    its pipeline's fill and its epilogue in turn: downs_0, one slice a
//    tile, ran slower than the FMA core).
// 3. Wt by TMA where cout % 8 == 0 (the 16-byte row pitch TMA needs): boxes
//    of 64 rows by 64 columns, 128-byte swizzle, read by wgmma MN-major (the
//    descriptor's transpose bit); rows past K and columns past cout arrive
//    as zeros. Other widths (the 64 -> 3 heads: cout = 3) take the 8-column
//    tile, whose Wt the producers store transposed (K-major, as A).
// 4. A for K2 and K7 by 8 producer warps, K walked in chunks of 64 channels,
//    tap inner, on tiles of 8 x 16 output pixels. At stride 1 the producers
//    stage each chunk's halo once, the 10 x 18 input pixels the tile's taps
//    read, 16 bytes (8 channels of one pixel) a load, with the staging
//    applied where the TPU kernel's bf16 arithmetic rounds (x * a, then + t:
//    mul.rn.bf16x2 and add.rn.bf16x2; K7's swish after it, each step
//    rounded); each tap's slice of A is then a shared-to-shared copy of the
//    tile's rows shifted by the tap, stored into the 128-byte swizzled
//    K-major layout wgmma reads, then fence.proxy.async before the warp's
//    arrive. An input value is loaded and folded 1.4 times a tile, not 9
//    times. At stride 2 (B4) each tap's rows are loaded and folded as such,
//    three slices ahead in registers, the nine taps of a chunk in a row so
//    that they mostly hit L1. Channels past cin are 0, and so is the A
//    column they multiply. cin % 8 != 0 (cin = 6: K = 54) walks the flat k
//    of igemm_pc.cuh with scalar loads.
// 5. A for K3 by TMA where cin % 8 == 0: the (B * H * W, cin) rows are a
//    plain matrix (no fold), boxes of 128 rows by 64 channels, the ragged
//    last pixel tile filled with zeros by the hardware. K3 is then a Hopper
//    GEMM with an epilogue, and one producer thread issues every copy.
// 6. The epilogue on the accumulator fragments: bias, optional swish, each
//    pair rounded to bf16 by one cvt.rn.bf16x2.f32 into a warp's 16 rows in
//    shared memory, then stored 16 bytes a lane, a row's runs on
//    consecutive lanes; the (B, cout) sum and sum of squares of the rounded
//    values added over each warp's rows with shuffles, over the 8 consumer
//    warps in shared memory in warp order, stored per pixel tile into a
//    float32 workspace, and added over the tiles in a fixed order by
//    conv_stats_kernel. No atomics: the statistics repeat bit for bit.
//
// Bound: at the main path's widths the product, counted FLOP at 989 TFLOP/s
// bf16 (dense); the 64 -> 3 heads and downs_0 (6 -> 64) by their bytes at
// 3.35 TB/s. What holds this form back (tools/torch_tc_bench.cu, PERF.md
// §7): the consumers' side alone runs at 2x to 4x the bound (SS wgmma reads
// A and Wt from shared memory, which at 64 columns takes its whole rate, and
// the epilogue does not overlap the product), and the staging, whose
// per-tap copies share that bandwidth, takes about as long again.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "igemm_pc.cuh"

namespace ucdir {
namespace tc {

// BM x BN output tile, BK-deep slices, S stages: two consumer warpgroups of
// 64 rows and 8 producer warps. The 3x3 convolutions' tiles are TH x TW
// output pixels; their halo, (TH + 2) x (TW + 2) input pixels, takes two
// 64-channel buffers of HP rows of 128 bytes. The ring takes as many stages
// as about 210 KB of shared memory hold, at most 8.
template <int BN_>
struct Tile {
  static constexpr int BM = 128, BN = BN_, BK = 64;
  static constexpr int TH = 8, TW = 16;
  static constexpr int HW = TW + 2, HP = (TH + 2) * HW;
  static constexpr int NC = 256;      // consumer threads
  static constexpr int PW = 8;        // producer warps
  static constexpr int NP = 32 * PW;  // producer threads
  static constexpr int NT = NC + NP;
  static constexpr int RS = NP / 8;   // rows of A a producer pass covers
  static constexpr int AI = BM / RS;  // rows of A a producer thread stages
  static constexpr int HJ = (HP * 8 + NP - 1) / NP;  // halo chunks a thread
  static constexpr int A_BYTES = BM * 128;  // a 64-deep bf16 row is 128 bytes
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int HALO = 2 * HP * 128;
  static constexpr int RED_BYTES = 4 * (NC / 32) * 2 * BN;
  // a consumer warp's 16 output rows of BN bf16, rows padded by 16 bytes
  static constexpr int EPITCH = 2 * BN + 16;
  static constexpr int EPI_BYTES = (NC / 32) * 16 * EPITCH;
  static constexpr int FIT = (227 * 1024 - 1024 - HALO - RED_BYTES -
                              EPI_BYTES - 256) / STAGE;
  static constexpr int S = FIT < 8 ? FIT : 8;
  // registers a consumer and a producer thread hold (setmaxnreg): of the 128
  // a thread is launched with, the narrower tiles' consumers, whose
  // accumulators are BN / 2 floats, hand some to the producers
  static constexpr int CREG = BN == 128 ? 128 : BN == 64 ? 104 : 96;
  static constexpr int PREG = 256 - CREG;
  static constexpr int HBUF = S * STAGE;       // the two halo buffers
  static constexpr int BAR = HBUF + HALO;      // full[S], empty[S]
  static constexpr int RED = BAR + 16 * S;     // (NC / 32, 2, BN) floats
  static constexpr int EPI = RED + RED_BYTES;  // the warps' output rows
  static constexpr int BYTES = EPI + EPI_BYTES;
  static constexpr int SMEM = BYTES + 1024;    // the ring aligned to 1024
  static_assert(STAGE % 1024 == 0 && A_BYTES % 1024 == 0,
                "128-byte swizzle atoms are 1024-byte aligned");
  static_assert(TH * TW == BM && NP % 8 == 0 && S >= 3, "tiles");
  static_assert(AI * 8 <= 32 && HJ <= 32, "a bit of a mask per load");
  static_assert(SMEM <= 227 * 1024, "shared memory of a block");
};

struct TcArgs {
  const bf16* x;     // (B, H, W, g.C) NHWC
  const bf16* w;     // (K, cout), row tap * cin + ci
  const bf16* bias;  // (cout) or null
  const bf16* a;     // (B, cin) or null
  const bf16* t;
  bf16* out;         // (B, Ho, Wo, cout)
  float* ws;         // (B, 2, cout, ntp) per-tile sums, or null
  Geom g;
  int cout, act;
  int th, tw;        // a pixel tile's output rows and columns
  int ntx;           // pixel tiles along a row of the output
  int ntn, ntp;      // column tiles; pixel tiles of an image
  int tiles;         // B * ntp * ntn
  int nk;            // slices
  bool vec;          // cin % 8 == 0, every A operand 16-byte aligned
  bool halo;         // vec, 3x3, stride 1: A copied from a staged halo
  bool vec_out;      // cout % 8 == 0, out 16-byte aligned
};

// ---- PTX primitives
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Makes this thread's generic-proxy stores to shared memory visible to the
// async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One 2-D TMA copy of the box at (c0 innermost, c1) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// The registers of this warpgroup's threads, raised or lowered to N.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// A named barrier of the consumer threads alone (barrier 2; igemm_pc.cuh's
// block_sync is barrier 1).
template <int N>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 2, %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | (uint64_t)1 << 62;
}
// K-major (A, and Wt stored transposed): rows of 64 k at 128 bytes, 8-row
// groups 1024 bytes apart; the k16 step kk starts 32 * kk bytes in.
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int kk) {
  return desc128(base + 32 * kk, 16, 1024);
}
// MN-major (Wt as TMA stores it): rows of 64 columns at 128 bytes, 8-row
// (k) groups 1024 bytes apart, 64-column boxes 8192 bytes apart; the k16
// step kk starts 16 rows in.
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int kk) {
  return desc128(base + 2048 * kk, 8192, 1024);
}

// d += A (64 x 16) * B (16 x N): A K-major, B MN-major (TB = 1) or K-major.
template <int N>
struct Mma;

template <>
struct Mma<8> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, %7;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct Mma<64> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct Mma<128> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(TB));
  }
};
// ---- end of PTX primitives

// The ring of S stages in shared memory and its barriers: slice s of a
// block's stream takes stage s % S; full[s % S] completes when the producers
// have staged it, empty[s % S] when both consumer warpgroups have released it.
template <class T>
struct Ring {
  uint8_t* base;  // the ring, aligned to 1024 bytes; the rest follows it
  uint64_t *full, *empty;

  // The ring in a block's dynamic shared memory.
  __device__ __forceinline__ explicit Ring(uint8_t* smem)
      : base(reinterpret_cast<uint8_t*>(
            (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023))),
        full(reinterpret_cast<uint64_t*>(base + T::BAR)),
        empty(full + T::S) {}
  __device__ __forceinline__ uint8_t* a(int s) const {
    return base + (s % T::S) * T::STAGE;
  }
  __device__ __forceinline__ uint8_t* b(int s) const {
    return a(s) + T::A_BYTES;
  }
  // Thread 0, before the block's first sync: full[] expects `arrivals`.
  __device__ __forceinline__ void init(int arrivals) const {
    for (int i = 0; i < T::S; ++i) {
      mbar_init(&full[i], arrivals);
      mbar_init(&empty[i], T::NC / 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // A producer: waits until the consumers have released slice s - S.
  __device__ __forceinline__ void acquire(int s) const {
    if (s >= T::S) mbar_wait(&empty[s % T::S], (s / T::S - 1) & 1);
  }
  // One producer thread: arrives on full[s] with the bytes its TMA copies
  // into slice s will bring.
  __device__ __forceinline__ void expect(int s, int bytes) const {
    mbar_expect_tx(&full[s % T::S], bytes);
  }
  // One producer thread: Wt rows krow .. krow + 63, columns n0 .. n0 + BN -
  // 1, by TMA onto full[s] (whose bytes the caller has announced).
  __device__ __forceinline__ void load_w(const CUtensorMap* mb, int s,
                                         int krow, int n0) const {
#pragma unroll
    for (int j = 0; j < T::BN / 64; ++j)
      tma_load(b(s) + 8192 * j, mb, n0 + 64 * j, krow, &full[s % T::S]);
  }
  // A producer warp, after its stores to slice s: hands them to the async
  // proxy and arrives.
  __device__ __forceinline__ void hand_over(int s) const {
    fence_proxy_async();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&full[s % T::S]);
  }
  // A consumer: waits until slice s is staged.
  __device__ __forceinline__ void wait_full(int s) const {
    mbar_wait(&full[s % T::S], (s / T::S) & 1);
  }
  // A consumer warpgroup, once its products on slice s have completed.
  __device__ __forceinline__ void release(int s) const {
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[s % T::S]);
  }
};

// Byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte swizzled
// K-major tile (the layout of TMA's and wgmma's 128-byte swizzle).
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// 16 bytes through the read-only path.
__device__ __forceinline__ uint4 load16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 8 bf16 of one pixel as loaded (four packed pairs) through the staging X:
// Affine in bf16x2 arithmetic, Preact that and then the swish, each step
// rounded (igemm_pc.cuh's pairs), Raw as they are.
template <class X>
__device__ __forceinline__ uint4 stage8(uint4 v, const uint4& a,
                                        const uint4& t) {
  using EB = Elem<bf16>;
  if constexpr (!X::kAffine) {
    return v;
  } else {
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
    const uint32_t tw[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int h = 0; h < 4; h += 2) {
      float f[4] = {__uint_as_float(w[h]), __uint_as_float(w[h + 1]), 0.f,
                    0.f};
      const float fa[4] = {__uint_as_float(aw[h]), __uint_as_float(aw[h + 1]),
                           0.f, 0.f};
      const float ft[4] = {__uint_as_float(tw[h]), __uint_as_float(tw[h + 1]),
                           0.f, 0.f};
      X::template pairs<bf16>(f, fa, ft);
      w[h] = __float_as_uint(EB::pack2(f[0], f[1]));
      w[h + 1] = __float_as_uint(EB::pack2(f[2], f[3]));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Where a tile lies: image b, pixel tile mt of the image, whose th x tw
// output pixels start at (oy0, ox0), columns n0 ..; tile t of the (B, ntp,
// ntn) grid of tiles, column tile fastest, so that the blocks at work at one
// time share their input rows. Row r of the tile is output pixel (oy0 + r /
// tw, ox0 + r % tw).
struct TilePos {
  int b, mt, n0, oy0, ox0;
};

template <class T>
__device__ __forceinline__ TilePos tile_pos(const TcArgs& p, int t) {
  const int per_image = p.ntp * p.ntn;
  TilePos q;
  q.b = t / per_image;
  const int r = t - q.b * per_image;
  q.mt = r / p.ntn;
  q.n0 = (r - q.mt * p.ntn) * T::BN;
  const int ty = q.mt / p.ntx;
  q.oy0 = ty * p.th;
  q.ox0 = (q.mt - ty * p.ntx) * p.tw;
  return q;
}

// A producer thread's view of its tile: the image's operands, the columns,
// and the input pixel of each of its AI rows at tap 0 (OUTSIDE past the
// image's last pixel).
template <class T>
struct TileRows {
  const bf16 *xb, *ab, *tb;
  int n0;
  int iy[T::AI], ix[T::AI];
};

template <class T>
__device__ __forceinline__ void tile_rows(TileRows<T>& r, const TcArgs& p,
                                          int t, int r0) {
  const Geom& g = p.g;
  const TilePos q = tile_pos<T>(p, t);
  r.xb = p.x + (int64_t)q.b * g.H * g.W * g.C;
  r.ab = p.a ? p.a + (int64_t)q.b * g.C : nullptr;
  r.tb = p.t ? p.t + (int64_t)q.b * g.C : nullptr;
  r.n0 = q.n0;
  const int off = g.ks == 3 ? 1 : 0;
#pragma unroll
  for (int i = 0; i < T::AI; ++i) {
    const int row = r0 + T::RS * i, ry = row / p.tw;
    const int oy = q.oy0 + ry, ox = q.ox0 + row - ry * p.tw;
    const bool in = oy < g.Ho && ox < g.Wo;
    r.iy[i] = in ? oy * g.stride - off : OUTSIDE;
    r.ix[i] = in ? ox * g.stride - off : OUTSIDE;
  }
}

// One producer thread's chunk of a slice between its loads and its store:
// 8 channels of AI rows, the fold's a and t of those channels, which rows
// lie inside the image and cin, and the slice's Wt rows and columns.
template <class T>
struct ASet {
  uint4 v[T::AI];
  uint4 sa, st;
  uint32_t in;
  int krow;  // the slice's first row of Wt
  int kval;  // rows of Wt from krow that belong to it (the chunk's channels)
  int n0;    // the tile's first column
};

// The producers' walk over a block's slices on the vector path: tile t,
// then channel chunk c, then tap (inner), so that the nine taps of a chunk
// follow one another and mostly hit L1.
struct Walk {
  int t, c, tap;
};

template <class T, class X>
__device__ __forceinline__ void load_vec(ASet<T>& q, Walk& wk,
                                         TileRows<T>& tr, const TcArgs& p,
                                         int total, int r0, int kc) {
  const Geom& g = p.g;
  const int ci = 64 * wk.c + 8 * kc;
  const bool valid = ci < g.cin;
  const int ty = g.ks == 3 ? wk.tap / 3 : 0;
  const int tx = g.ks == 3 ? wk.tap - 3 * ty : 0;
  q.krow = wk.tap * g.cin + 64 * wk.c;
  q.kval = min(64, g.cin - 64 * wk.c);
  q.n0 = tr.n0;
  if (X::kAffine && valid && tr.ab != nullptr) {
    q.sa = __ldg(reinterpret_cast<const uint4*>(tr.ab + ci));
    q.st = __ldg(reinterpret_cast<const uint4*>(tr.tb + ci));
  } else {
    q.sa = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
    q.st = make_uint4(0u, 0u, 0u, 0u);
  }
  q.in = 0u;
#pragma unroll
  for (int i = 0; i < T::AI; ++i) {
    const int y = tr.iy[i] + ty, x = tr.ix[i] + tx;
    const bool in = valid && (unsigned)y < (unsigned)g.H &&
                    (unsigned)x < (unsigned)g.W;
    q.v[i] = load16(in ? tr.xb + ((int64_t)y * g.W + x) * g.C + ci : p.x);
    q.in |= (uint32_t)in << i;
  }
  if (++wk.tap == g.ks * g.ks) {
    wk.tap = 0;
    if (64 * ++wk.c >= g.cin) {
      wk.c = 0;
      wk.t += gridDim.x;
      if (wk.t < total) tile_rows<T>(tr, p, wk.t, r0);
    }
  }
}

// Wt rows krow .. krow + 63 (those past kval, or past K, as 0), columns
// n0 .. n0 + BN - 1, stored transposed into the K-major layout of A.
template <class T>
__device__ __forceinline__ void store_w_manual(uint8_t* bs, const TcArgs& p,
                                               int krow, int kval, int n0) {
  const int pt = threadIdx.x - T::NC;
  const uint16_t* w = reinterpret_cast<const uint16_t*>(p.w);
  for (int i = pt; i < T::BN * 64; i += T::NP) {
    const int n = i % T::BN, kl = i / T::BN;
    const int k = krow + kl;
    uint16_t v = 0;
    if (kl < kval && k < p.g.K && n0 + n < p.cout)
      v = __ldg(w + (int64_t)k * p.cout + n0 + n);
    *reinterpret_cast<uint16_t*>(bs + swz(n, kl >> 3) + 2 * (kl & 7)) = v;
  }
}

// A named barrier of the producer threads alone (barrier 3).
template <int N>
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 3, %0;" ::"n"(N) : "memory");
}

// A producer thread's part of one 64-channel chunk of a tile's halo between
// its loads and its store: HJ 16-byte runs (8 channels, channel run pt % 8,
// of halo pixels pt / 8 + NP / 8 * j), the fold's a and t of those
// channels, which runs lie inside the image and cin.
template <class T>
struct HaloSet {
  uint4 v[T::HJ];
  uint4 sa, st;
  uint32_t in;
};

template <class T, class X>
__device__ __forceinline__ void load_halo(HaloSet<T>& h, const TcArgs& p,
                                          int t, int c, int pt) {
  const Geom& g = p.g;
  const TilePos q = tile_pos<T>(p, t);
  const int ci = 64 * c + 8 * (pt & 7);
  const bool valid = ci < g.cin;
  const bf16* xb = p.x + (int64_t)q.b * g.H * g.W * g.C + ci;
  if (X::kAffine && valid && p.a != nullptr) {
    h.sa = __ldg(reinterpret_cast<const uint4*>(p.a + q.b * g.C + ci));
    h.st = __ldg(reinterpret_cast<const uint4*>(p.t + q.b * g.C + ci));
  } else {
    h.sa = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
    h.st = make_uint4(0u, 0u, 0u, 0u);
  }
  h.in = 0u;
#pragma unroll
  for (int j = 0; j < T::HJ; ++j) {
    const int hp = (pt >> 3) + T::NP / 8 * j;
    const int hr = hp / T::HW;
    const int y = q.oy0 - 1 + hr, x = q.ox0 - 1 + hp - hr * T::HW;
    const bool in = hp < T::HP && valid && (unsigned)y < (unsigned)g.H &&
                    (unsigned)x < (unsigned)g.W;
    h.v[j] = load16(in ? xb + ((int64_t)y * g.W + x) * g.C : p.x);
    h.in |= (uint32_t)in << j;
  }
}

// The producers of a 3x3, stride-1 convolution with the vector staging: per
// 64-channel chunk of a tile they stage its halo, (TH + 2) x (TW + 2) input
// pixels with the staging (fold, swish) applied once, into one of two
// buffers, and each of the chunk's nine slices of A is a copy of the tile's
// rows shifted by the tap, shared memory to shared memory: each input value
// is loaded and folded once a tile and chunk, not once a tap. The next
// chunk's halo is loaded into registers while this one's taps are copied.
// One producer barrier a chunk: every thread's copies from a buffer end
// before the barrier that follows the staging of the other buffer.
template <class T, class X, class Begin, class Finish>
__device__ __forceinline__ void produce_halo(const TcArgs& p,
                                             const Ring<T>& ring, int total,
                                             const Begin& begin,
                                             const Finish& finish) {
  const Geom& g = p.g;
  const int pt = threadIdx.x - T::NC;
  const int kc = pt & 7, r0 = pt >> 3;
  HaloSet<T> h;
  int t = blockIdx.x, c = 0, s = 0, hb = 0;
  load_halo<T, X>(h, p, t, c, pt);
  while (t < total) {
    const TilePos q = tile_pos<T>(p, t);
    uint8_t* hbuf = ring.base + T::HBUF + hb * T::HP * 128;
#pragma unroll
    for (int j = 0; j < T::HJ; ++j) {
      const int hp = (pt >> 3) + T::NP / 8 * j;
      if (hp < T::HP)
        *reinterpret_cast<uint4*>(hbuf + swz(hp, kc)) =
            ((h.in >> j) & 1u) ? stage8<X>(h.v[j], h.sa, h.st)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
    producer_sync<T::NP>();
    int tn = t, cn = c + 1;
    if (64 * cn >= g.cin) {
      cn = 0;
      tn += gridDim.x;
    }
    if (tn < total) load_halo<T, X>(h, p, tn, cn, pt);
    const int kval = min(64, g.cin - 64 * c);
    for (int tap = 0; tap < 9; ++tap, ++s) {
      const int ty = tap / 3, tx = tap - 3 * ty;
      const int krow = tap * g.cin + 64 * c;
      begin(s, krow, q.n0);
      uint8_t* as = ring.a(s);
#pragma unroll
      for (int i = 0; i < T::AI; ++i) {
        const int row = r0 + T::RS * i;
        const int hp = (row / T::TW + ty) * T::HW + row % T::TW + tx;
        *reinterpret_cast<uint4*>(as + swz(row, kc)) =
            *reinterpret_cast<const uint4*>(hbuf + swz(hp, kc));
      }
      finish(s, krow, kval, q.n0);
    }
    t = tn;
    c = cn;
    hb ^= 1;
  }
}

// The producers' side: the block's tiles t = blockIdx.x, + gridDim.x, ...
// in turn, nk slices each, one stream of slices s across the tiles, so the
// next tile's first slices are staged while the consumers run the epilogue
// of this one. Stage s % S of slice s is staged after the consumers have
// released slice s - S; each producer warp arrives on full[] after its
// stores and a proxy fence, and thread 0 also arrives with the bytes its TMA
// copies will bring.
template <class T, class X, bool BT, bool AT>
__device__ __forceinline__ void produce(const TcArgs& p, const CUtensorMap* ma,
                                        const CUtensorMap* mb,
                                        const Ring<T>& ring, int total) {
  const int pt = threadIdx.x - T::NC;
  const int ns = (total - blockIdx.x + gridDim.x - 1) / gridDim.x * p.nk;
  if constexpr (AT) {  // K3: both operands by TMA, one thread
    if (pt != 0) return;
    int s = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const TilePos q = tile_pos<T>(p, t);
      for (int c = 0; c < p.nk; ++c, ++s) {
        ring.acquire(s);
        ring.expect(s, T::STAGE);
        tma_load(ring.a(s), ma, 64 * c, q.ox0, &ring.full[s % T::S]);
        ring.load_w(mb, s, 64 * c, q.n0);
      }
    }
    return;
  }
  const Geom& g = p.g;
  const int kc = pt & 7, r0 = pt >> 3;
  // thread 0's TMA of the slice's Wt; then the slice's A rows and, without
  // TMA, its Wt; then the fence and the warp's arrive
  auto begin = [&](int s, int krow, int n0) {
    ring.acquire(s);
    if (BT && pt == 0) {
      ring.expect(s, T::B_BYTES);
      ring.load_w(mb, s, krow, n0);
    }
  };
  auto finish = [&](int s, int krow, int kval, int n0) {
    if constexpr (!BT) store_w_manual<T>(ring.b(s), p, krow, kval, n0);
    ring.hand_over(s);
  };
  if (p.halo) {
    produce_halo<T, X>(p, ring, total, begin, finish);
    return;
  }
  TileRows<T> tr;
  if (p.vec) {
    constexpr int D = 3;  // slices in registers: loads run two slices ahead
    ASet<T> q[D];
    Walk wk = {(int)blockIdx.x, 0, 0};
    tile_rows<T>(tr, p, wk.t, r0);
#pragma unroll
    for (int j = 0; j < D - 1; ++j)
      if (j < ns) load_vec<T, X>(q[j], wk, tr, p, total, r0, kc);
    for (int s0 = 0; s0 < ns; s0 += D) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const int s = s0 + j;
        if (s >= ns) break;
        if (s + D - 1 < ns)
          load_vec<T, X>(q[(j + D - 1) % D], wk, tr, p, total, r0, kc);
        const ASet<T>& c = q[j];
        begin(s, c.krow, c.n0);
        uint8_t* as = ring.a(s);
#pragma unroll
        for (int i = 0; i < T::AI; ++i) {
          const uint4 v = ((c.in >> i) & 1u) ? stage8<X>(c.v[i], c.sa, c.st)
                                             : make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(as + swz(r0 + T::RS * i, kc)) = v;
        }
        finish(s, c.krow, c.kval, c.n0);
      }
    }
    return;
  }
  // cin % 8 != 0 or an unaligned operand: the flat k of igemm_pc.cuh, one
  // value at a time. Warp w stages 8-column chunk w of the slice for the
  // rows lane + 32 * i, so that a warp whose chunk lies past K (cin = 6: K =
  // 54 at 3x3, 6 at 1x1) stores zeros and loads nothing.
  const int wc = pt >> 5, lr = pt & 31;
  int s = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    tile_rows<T>(tr, p, t, lr);
    for (int c = 0; c < p.nk; ++c, ++s) {
      const int k0 = 64 * c;
      begin(s, k0, tr.n0);
      uint8_t* as = ring.a(s);
      if (k0 + 8 * wc >= g.K) {
#pragma unroll
        for (int i = 0; i < T::AI; ++i)
          *reinterpret_cast<uint4*>(as + swz(lr + T::RS * i, wc)) =
              make_uint4(0u, 0u, 0u, 0u);
        finish(s, k0, 64, tr.n0);
        continue;
      }
      // every load first, from an address that is always valid, so that
      // none waits for another; then the staging of those inside
      float v[T::AI][8], fa[8], ft[8];
      uint32_t in = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + 8 * wc + j;
        const bool valid = k < g.K;
        const int tap = valid ? k / g.cin : 0;
        const int ci = valid ? k - tap * g.cin : 0;
        const int ty = g.ks == 3 ? tap / 3 : 0;
        const int tx = g.ks == 3 ? tap - 3 * ty : 0;
        const bool aff = X::kAffine && tr.ab != nullptr;
        fa[j] = aff ? Elem<bf16>::ldg(tr.ab + ci) : 1.f;
        ft[j] = aff ? Elem<bf16>::ldg(tr.tb + ci) : 0.f;
#pragma unroll
        for (int i = 0; i < T::AI; ++i) {
          const int y = tr.iy[i] + ty, x = tr.ix[i] + tx;
          const bool inside = valid && (unsigned)y < (unsigned)g.H &&
                              (unsigned)x < (unsigned)g.W;
          v[i][j] = Elem<bf16>::ldg(
              inside ? tr.xb + ((int64_t)y * g.W + x) * g.C + ci : p.x);
          in |= (uint32_t)inside << (8 * i + j);
        }
      }
#pragma unroll
      for (int i = 0; i < T::AI; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[i][j] = ((in >> (8 * i + j)) & 1u)
                        ? X::template apply<bf16>(v[i][j], fa[j], ft[j])
                        : 0.f;
      }
#pragma unroll
      for (int i = 0; i < T::AI; ++i) {
        uint4 u;
        u.x = __float_as_uint(Elem<bf16>::pack2(v[i][0], v[i][1]));
        u.y = __float_as_uint(Elem<bf16>::pack2(v[i][2], v[i][3]));
        u.z = __float_as_uint(Elem<bf16>::pack2(v[i][4], v[i][5]));
        u.w = __float_as_uint(Elem<bf16>::pack2(v[i][6], v[i][7]));
        *reinterpret_cast<uint4*>(as + swz(lr + T::RS * i, wc)) = u;
      }
      finish(s, k0, 64, tr.n0);
    }
  }
}

// The consumers' side of one tile: warpgroup wg multiplies rows 64 * wg ..
// + 63 of each of the tile's nk slices (block slices s .. s + nk - 1) into
// acc, four k16 steps a slice, and releases a stage once the products that
// read it have completed (one slice's batch stays in flight; the tile's last
// stage is released before its epilogue).
template <class T, bool BT>
__device__ __forceinline__ void consume(float (&acc)[T::BN / 2],
                                        const Ring<T>& ring, int s, int nk) {
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int j = 0; j < T::BN / 2; ++j) acc[j] = 0.f;
  for (int c = 0; c < nk; ++c, ++s) {
    ring.wait_full(s);
    const uint32_t as = smem_addr(ring.a(s)) + 8192 * wg;
    const uint32_t bs = smem_addr(ring.b(s));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<T::BN>::template run<BT ? 1 : 0>(
          acc, desc_k(as, kk), BT ? desc_mn(bs, kk) : desc_k(bs, kk));
    wgmma_commit();
    wgmma_wait<1>();
    if (c > 0) ring.release(s - 1);
  }
  wgmma_wait<0>();
  ring.release(s - 1);
}

// The epilogue on the fragments: thread (warp q of warpgroup wg, lane l)
// holds rows 64 * wg + 16 * q + l / 4 (+ 8) and columns 8 * j + 2 * (l % 4)
// (+ 1) of the tile. + bias, optional swish, rounded in pairs into the
// warp's rows at epi, stored from there 16 bytes a lane; with a workspace
// the tile's column sums and sums of squares of the rounded values, stored
// plainly at ws[b][0 or 1][column][mt].
template <class T>
__device__ __forceinline__ void epilogue(const float (&acc)[T::BN / 2],
                                         const TcArgs& p, float* red,
                                         uint8_t* epi, const TilePos& q) {
  using EB = Elem<bf16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Ho = p.g.Ho, Wo = p.g.Wo, N = p.cout;
  // rows ra and ra + 8 of the tile: output pixels (ya, xa) and (yb, xb)
  const int ra = 16 * warp + (lane >> 2), rb = ra + 8;
  const int ya = q.oy0 + ra / p.tw, xa = q.ox0 + ra % p.tw;
  const int yb = q.oy0 + rb / p.tw, xb = q.ox0 + rb % p.tw;
  const bool ina = ya < Ho && xa < Wo, inb = yb < Ho && xb < Wo;
  const bool stats = p.ws != nullptr;
  // this warp's 16 rows, written as fragments and read back as 16-byte runs
  uint8_t* rows = epi + warp * 16 * T::EPITCH;
  __syncwarp();  // the previous tile's runs are read
#pragma unroll
  for (int j = 0; j < T::BN / 8; ++j) {
    const int cl = 8 * j + 2 * (lane & 3);
    const int n = q.n0 + cl;
    const bool c0 = n < N, c1 = n + 1 < N;
    const float b0 = (p.bias && c0) ? EB::ld(p.bias + n) : 0.f;
    const float b1 = (p.bias && c1) ? EB::ld(p.bias + n + 1) : 0.f;
    float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0,
                  acc[4 * j + 3] + b1};
    if (p.act) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = swishf(v[e]);
    }
    const float ua = EB::pack2(v[0], v[1]), ub = EB::pack2(v[2], v[3]);
    const float r[4] = {EB::lof(ua), EB::hif(ua), EB::lof(ub), EB::hif(ub)};
    *reinterpret_cast<float*>(rows + (lane >> 2) * T::EPITCH + 2 * cl) = ua;
    *reinterpret_cast<float*>(rows + ((lane >> 2) + 8) * T::EPITCH + 2 * cl) =
        ub;
    if (!stats) continue;
    const float x0 = ina ? r[0] : 0.f, x1 = ina ? r[1] : 0.f;
    const float y0 = inb ? r[2] : 0.f, y1 = inb ? r[3] : 0.f;
    float s0 = x0 + y0, s1 = x1 + y1;
    float q0 = x0 * x0 + y0 * y0, q1 = x1 * x1 + y1 * y1;
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      s0 += pc::shfl_xor(s0, m);
      s1 += pc::shfl_xor(s1, m);
      q0 += pc::shfl_xor(q0, m);
      q1 += pc::shfl_xor(q1, m);
    }
    if (lane < 4) {
      float* rw = red + warp * 2 * T::BN;
      rw[cl] = s0;
      rw[cl + 1] = s1;
      rw[T::BN + cl] = q0;
      rw[T::BN + cl + 1] = q1;
    }
  }
  // the rows out in 16-byte runs, 8 columns each: a row's runs are
  // consecutive lanes' (the last of a row short where cout ends in it)
  __syncwarp();
  constexpr int RUNS = T::BN / 8;
  for (int i = lane; i < 16 * RUNS; i += 32) {
    const int rr = i / RUNS, n = q.n0 + 8 * (i - rr * RUNS);
    const int r = 16 * warp + rr;
    const int y = q.oy0 + r / p.tw, x = q.ox0 + r % p.tw;
    if (y >= Ho || x >= Wo || n >= N) continue;
    const uint8_t* src = rows + rr * T::EPITCH + 2 * (n - q.n0);
    bf16* dst = p.out + (((int64_t)q.b * Ho + y) * Wo + x) * N + n;
    if (p.vec_out && n + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e)
        reinterpret_cast<uint16_t*>(dst)[e] =
            reinterpret_cast<const uint16_t*>(src)[e];
    }
  }
  if (!stats) return;
  consumer_sync<T::NC>();
  for (int c = threadIdx.x; c < T::BN; c += T::NC) {
    if (q.n0 + c >= N) continue;
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int w = 0; w < T::NC / 32; ++w) {
      s += red[w * 2 * T::BN + c];
      sq += red[w * 2 * T::BN + T::BN + c];
    }
    float* o = p.ws + ((int64_t)q.b * 2 * N + q.n0 + c) * p.ntp + q.mt;
    o[0] = s;
    o[(int64_t)N * p.ntp] = sq;
  }
  consumer_sync<T::NC>();  // red is read before the next tile writes it
}

// A persistent block walks tiles blockIdx.x, + gridDim.x, ... of the
// (B, ntp, ntn) grid of BM x BN tiles.
template <class T, class X, bool BT, bool AT>
__global__ void __launch_bounds__(T::NT, 1)
    conv_tc_kernel(const TcArgs p, const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb) {
  extern __shared__ uint8_t smem_raw[];
  const Ring<T> ring(smem_raw);
  float* red = reinterpret_cast<float*>(ring.base + T::RED);
  uint8_t* epi = ring.base + T::EPI;
  const int total = p.tiles;
  if (threadIdx.x == 0) ring.init(AT ? 1 : T::PW + (BT ? 1 : 0));
  __syncthreads();
  if (threadIdx.x >= T::NC) {
    if constexpr (T::PREG != 128) setmaxnreg_inc<T::PREG>();
    produce<T, X, BT, AT>(p, &ma, &mb, ring, total);
    return;
  }
  if constexpr (T::CREG != 128) setmaxnreg_dec<T::CREG>();
  int s = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x, s += p.nk) {
    float acc[T::BN / 2];
    consume<T, BT>(acc, ring, s, p.nk);
    epilogue<T>(acc, p, red, epi, tile_pos<T>(p, t));
  }
}

// ssum, ssq (B, C) from the per-tile sums ws (B, 2, C, ntp): block (row r of
// the 2 * C, image blockIdx.y); thread i adds tiles i, i + 256, ... in
// ascending order, then the 256 partial sums are added by halves. A fixed
// order: the same bits from call to call. An instance per source that
// includes this header.
static __global__ void __launch_bounds__(256)
    conv_stats_kernel(const float* __restrict__ ws, float* __restrict__ ssum,
                      float* __restrict__ ssq, int ntp, int C) {
  __shared__ float part[256];
  const int r = blockIdx.x, b = blockIdx.y;
  const float* row = ws + ((int64_t)b * 2 * C + r) * ntp;
  float v = 0.f;
  for (int i = threadIdx.x; i < ntp; i += 256) v += __ldg(row + i);
  part[threadIdx.x] = v;
  __syncthreads();
  for (int h = 128; h > 0; h >>= 1) {
    if (threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    (r < C ? ssum : ssq)[(int64_t)b * C + r % C] = part[0];
}

// Launches of this core since the library was loaded, successful ones
// only, by entry point (TC_CONV3X3 ..): ucdir_tc_launches() reads them, so a
// run can show which launches went through the tensor cores.
enum Entry { TC_CONV3X3, TC_PREACT, TC_CONV1X1, TC_ENTRIES };
inline long long& launch_count(int entry) {
  static long long n[TC_ENTRIES] = {};
  return n[entry];
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no link to
// libcuda), or null.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess)
#endif
      f = nullptr;
    return q == cudaDriverEntryPointSuccess ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

// A map of the bf16 (rows, cols) matrix at ptr, row-major with a pitch of
// cols, in boxes of box_rows by 64 columns with the 128-byte swizzle; parts
// of a box outside the matrix read as zeros.
inline int tensor_map(CUtensorMap* map, const bf16* ptr, int64_t rows,
                      int64_t cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dim,
      pitch, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// How a convolution runs: the tile's columns (128, 64 or 8), and whether Wt
// and A come by TMA.
struct Route {
  int bn;
  bool bt, at;
};

// Fills c's tile-independent plan and returns its route. Wt comes by TMA on
// 128 or 64 columns where cout % 8 == 0 and w is 16-byte aligned, else the
// producers store it on 8 columns; A comes by TMA for a plain 1x1 product
// (raw: no staging, one image row: the caller flattens K3's pixels) where
// cin % 8 == 0 and x is aligned. A 3x3 convolution's pixel tiles are 8 x 16
// output pixels, ceil(Ho / 8) * ceil(Wo / 16) an image (ops/conv.py
// stats_tiles); a 1x1's runs of 128 pixels along its row.
inline Route plan(TcArgs& c, int B, bool raw) {
  const Geom& g = c.g;
  const bool affine_ok = c.a == nullptr || (pc::aligned(c.a, 16) &&
                                            pc::aligned(c.t, 16));
  c.vec = g.cin % 8 == 0 && g.C % 8 == 0 && pc::aligned(c.x, 16) && affine_ok;
  c.halo = c.vec && g.ks == 3 && g.stride == 1;
  c.th = g.ks == 3 ? 8 : 1;
  c.tw = g.ks == 3 ? 16 : 128;
  c.nk = c.vec ? g.ks * g.ks * ((g.cin + 63) / 64) : (g.K + 63) / 64;
  c.vec_out = c.cout % 8 == 0 && pc::aligned(c.out, 16);
  Route r;
  r.bt = c.cout % 8 == 0 && c.cout > 8 && pc::aligned(c.w, 16);
  r.at = raw && r.bt && c.vec && g.ks == 1 && g.H == 1 && B == 1 &&
         c.ws == nullptr;
  r.bn = !r.bt ? 8 : c.cout >= 128 ? 128 : 64;
  return r;
}

// c's grid of tiles for tile T, and the tensor maps of what comes by TMA.
template <class T, bool BT, bool AT>
int tile_grid(TcArgs& c, int B, CUtensorMap* ma, CUtensorMap* mb) {
  *ma = CUtensorMap{};
  *mb = CUtensorMap{};
  if (BT) {
    const int err = tensor_map(mb, c.w, c.g.K, c.cout, 64);
    if (err) return err;
  }
  if (AT) {
    const int err = tensor_map(ma, c.x, (int64_t)c.g.H * c.g.W, c.g.cin,
                               T::BM);
    if (err) return err;
  }
  c.ntn = (c.cout + T::BN - 1) / T::BN;
  c.ntx = (c.g.Wo + c.tw - 1) / c.tw;
  c.ntp = (c.g.Ho + c.th - 1) / c.th * c.ntx;
  c.tiles = B * c.ntp * c.ntn;
  return 0;
}

// The blocks of a persistent launch: one an SM (the count read once a
// device), or one a tile where there are fewer.
inline int grid_blocks(int tiles, int* blocks) {
  constexpr int MAX_DEV = 64;
  static int sms_of[MAX_DEV];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    err = (int)cudaDeviceGetAttribute(&sms_of[dev],
                                      cudaDevAttrMultiProcessorCount, dev);
    if (err) return err;
  }
  *blocks = tiles < sms_of[dev] ? tiles : sms_of[dev];
  return 0;
}

// Sets kernel's dynamic shared memory to `bytes`, once a device (the flags
// are the instance's own: one per kernel).
template <auto kernel>
int set_smem(int bytes) {
  constexpr int MAX_DEV = 64;
  static int done[MAX_DEV];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    done[dev] = 1;
  }
  return 0;
}

template <class T, class X, bool BT, bool AT>
int launch_tile(TcArgs c, float* ssum, float* ssq, int B, cudaStream_t st,
                Entry entry) {
  CUtensorMap ma, mb;
  int blocks = 0;
  int err = tile_grid<T, BT, AT>(c, B, &ma, &mb);
  if (!err) err = grid_blocks(c.tiles, &blocks);
  if (!err) err = set_smem<conv_tc_kernel<T, X, BT, AT>>(T::SMEM);
  if (err) return err;
  conv_tc_kernel<T, X, BT, AT><<<blocks, T::NT, T::SMEM, st>>>(c, ma, mb);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (c.ws != nullptr) {
    conv_stats_kernel<<<dim3(2 * c.cout, B), 256, 0, st>>>(c.ws, ssum, ssq,
                                                            c.ntp, c.cout);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  ++launch_count(entry);
  return 0;
}

// Launches the bf16 convolution c (c.g, the pointers, cout, act and ws the
// caller's; ws null without statistics, else a (B, 2, cout, pixel tiles)
// float workspace, and ssum and ssq receive them) on its route (plan),
// counted under `entry`.
template <class X>
int launch_conv(TcArgs c, float* ssum, float* ssq, int B, cudaStream_t st,
                Entry entry) {
  constexpr bool kRaw = !X::kAffine;
  const Route r = plan(c, B, kRaw);
  if (r.bn == 8)
    return launch_tile<Tile<8>, X, false, false>(c, ssum, ssq, B, st, entry);
  if (r.bn == 128) {
    if (kRaw && r.at)
      return launch_tile<Tile<128>, X, true, kRaw>(c, ssum, ssq, B, st,
                                                   entry);
    return launch_tile<Tile<128>, X, true, false>(c, ssum, ssq, B, st,
                                                  entry);
  }
  if (kRaw && r.at)
    return launch_tile<Tile<64>, X, true, kRaw>(c, ssum, ssq, B, st, entry);
  return launch_tile<Tile<64>, X, true, false>(c, ssum, ssq, B, st, entry);
}

}  // namespace tc
}  // namespace ucdir
