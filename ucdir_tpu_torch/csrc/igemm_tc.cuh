// Implicit-GEMM core of the bf16 convolutions on the H100's tensor cores
// (sm_90a): the bf16 entry points of K2 (3x3 conv, stride 1 or 2, the
// packed upsampling), K7 (the pre-activated 3x3 head) and K3 (1x1 conv),
// of the backward kernels K6 and K5 and of the AKGM block tail K1 (the
// grouped products: the section at the end of this file). It replaces the
// bf16 instantiation of the TPU kernels B2, B4, B5, B3 and B6
// (ucdir_tpu/ops/conv_pallas.py _conv3x3_forward_padfree,
// _downconv_forward, upconv2x, conv3x3_preact_pallas, _conv1x1_forward), B9
// (_conv3x3_backward), B8 and B1 (ucdir_tpu/ops/akgm_pallas.py
// _akgm_block_backward, _akgm_block_forward_padfree). Every fp32 kernel
// but K4, and K8 and K9, stay on the FMA core of igemm_pc.cuh, whose Geom,
// Elem<bf16>, staging functors Affine, Preact, Raw, Dgrad and Dz and
// weight-gradient reduction this core reuses.
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
  // the groups of output columns (the forward: one, gw = cout, wld = cout,
  // wrows = K, the offsets 0, tpu = 1; tile_grid sets them)
  int gw;            // output columns a group
  int tnw, ntg;      // a column tile's width, min(BN, gw); tiles a group
  int xgs;           // channels of x a group is offset by
  int wgr, wgc;      // rows and columns of w a group's weights are offset by
  int wld, wrows;    // the weights' row pitch, and rows of all groups
  int tpu, units;    // tiles a block walks in a row (a unit); units
  bool flat;         // halo slices of 64 flat k (cin <= 64, the backward's)
  // the backward's products (gconv_tc_kernel) only:
  const bf16* go;    // DZ epilogue: (B, H, W, cout) output cotangent
  const float* att;  // Dz staging: (B, H, W, 8) att * attw
  // K9's staging (AttMul, akgm_packed.cu) only:
  const bf16* patt;   // (B, H, W, 8) att
  const bf16* pattw;  // (B, 8) attw, or null
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

// d += A (64 x 16) * B (16 x N): each operand K-major, or MN-major (TA, TB
// = 1: the descriptor's transpose bit, which 16-bit types allow on both).
template <int N>
struct Mma;

template <>
struct Mma<8> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Mma<16> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Mma<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Mma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Mma<128> {
  template <int TA, int TB>
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
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
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

// K9's staging (akgm_packed.cu, the bf16 packed tail): the halo holds x as
// it is, and outside the image the fold's ring -t / a (p.t, 0 without the
// fold); each slice's run of 8 channels of output pixel p is multiplied by
// mult[p][c] = att[p][g(c)] * attw[g(c)] * a[c] rounded once (a 1 without
// the fold), g(c) = c / (C / 8) the channel's input group, and the product
// rounded (mul.rn.bf16x2): the scale depends on the OUTPUT pixel, so it is
// applied where a tap's slice is copied out of the halo, from a mult that a
// producer thread forms once a tile and chunk for its rows (att_mult). One
// group, 3x3, stride 1, the vector path (plan's halo) only. kAtt marks it,
// as it marks pc::AttScaled, K9's float32 staging.
struct AttMul : pc::Raw {
  static constexpr bool kAtt = true;
};

// Where a tile lies: image b, pixel tile mt of the image, whose th x tw
// output pixels start at (oy0, ox0), group g, columns n0 .. nend - 1; tile t
// of the (B, ntp, ntn) grid of tiles, column tile fastest, so that the
// blocks at work at one time share their input rows. Row r of the tile is
// output pixel (oy0 + r / tw, ox0 + r % tw).
//
// GR: the product has groups (gconv_tc_kernel). Without, the group terms
// below are 0 at compile time (g, the offsets of x and w, tpu = 1, no flat
// slices): read at run time, they cost K2's and K3's launches of one or two
// slices a tile 2% to 6%.
struct TilePos {
  int b, mt, g, n0, nend, oy0, ox0;
};

template <bool GR>
__device__ __forceinline__ TilePos tile_pos(const TcArgs& p, int t) {
  const int per_image = p.ntp * p.ntn;
  TilePos q;
  q.b = t / per_image;
  const int r = t - q.b * per_image;
  q.mt = r / p.ntn;
  const int nt = r - q.mt * p.ntn;
  if constexpr (GR) {
    q.g = nt / p.ntg;
    q.n0 = q.g * p.gw + (nt - q.g * p.ntg) * p.tnw;
    q.nend = min(min(q.n0 + p.tnw, (q.g + 1) * p.gw), p.cout);
  } else {
    q.g = 0;
    q.n0 = nt * p.tnw;
    q.nend = min(q.n0 + p.tnw, p.cout);
  }
  const int ty = q.mt / p.ntx;
  q.oy0 = ty * p.th;
  q.ox0 = (q.mt - ty * p.ntx) * p.tw;
  return q;
}

// A block's tiles: units blockIdx.x, + gridDim.x, ... of tpu tiles each.
template <bool GR>
__device__ __forceinline__ int first_tile(const TcArgs& p) {
  return GR ? blockIdx.x * p.tpu : blockIdx.x;
}
template <bool GR>
__device__ __forceinline__ int next_tile(const TcArgs& p, int t) {
  if constexpr (!GR) return t + gridDim.x;
  return (t + 1) % p.tpu ? t + 1 : t + 1 + (gridDim.x - 1) * p.tpu;
}

// A tile's weights: the element of w at its group's row 0 and its first
// column, its columns, and that element as coordinates (row, col) of the
// (wrows, wld) matrix that TMA reads.
struct WSel {
  int64_t off;
  int nv, row, col;
};

template <bool GR>
__device__ __forceinline__ WSel wsel(const TcArgs& p, const TilePos& q) {
  WSel s;
  s.nv = q.nend - q.n0;
  s.row = GR ? q.g * p.wgr : 0;
  s.col = GR ? q.g * p.wgc + q.n0 - q.g * p.gw : q.n0;
  s.off = (int64_t)s.row * p.wld + s.col;
  return s;
}

// A producer thread's view of its tile: where it lies, the image's operands
// (from the group's first channel), and the input pixel of each of its AI
// rows at tap 0 (OUTSIDE past the image's last pixel).
template <class T>
struct TileRows {
  const bf16 *xb, *ab, *tb;
  TilePos q;
  int iy[T::AI], ix[T::AI];
};

template <class T, bool GR>
__device__ __forceinline__ void tile_rows(TileRows<T>& r, const TcArgs& p,
                                          int t, int r0) {
  const Geom& g = p.g;
  r.q = tile_pos<GR>(p, t);
  const TilePos& q = r.q;
  const int xo = GR ? q.g * p.xgs : 0;
  r.xb = p.x + (int64_t)q.b * g.H * g.W * g.C + xo;
  r.ab = p.a ? p.a + (int64_t)q.b * g.C + xo : nullptr;
  r.tb = p.t ? p.t + (int64_t)q.b * g.C + xo : nullptr;
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
                                         int r0, int kc) {
  const Geom& g = p.g;
  const int ci = 64 * wk.c + 8 * kc;
  const bool valid = ci < g.cin;
  const int ty = g.ks == 3 ? wk.tap / 3 : 0;
  const int tx = g.ks == 3 ? wk.tap - 3 * ty : 0;
  q.krow = wk.tap * g.cin + 64 * wk.c;
  q.kval = min(64, g.cin - 64 * wk.c);
  q.n0 = tr.q.n0;
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
      if (wk.t < p.tiles) tile_rows<T, false>(tr, p, wk.t, r0);
    }
  }
}

// The tile's Wt rows krow .. krow + 63 of its group (those past kval, or
// past K, as 0), its columns, stored transposed into the K-major layout of
// A (the tiles whose weights do not come by TMA).
template <class T>
__device__ __forceinline__ void store_w(uint8_t* bs, const TcArgs& p,
                                        const WSel& ws, int krow, int kval) {
  const int pt = threadIdx.x - T::NC;
  const uint16_t* w = reinterpret_cast<const uint16_t*>(p.w) + ws.off;
  for (int i = pt; i < T::BN * 64; i += T::NP) {
    const int n = i % T::BN, kl = i / T::BN;
    const int k = krow + kl;
    uint16_t v = 0;
    if (kl < kval && k < p.g.K && n < ws.nv)
      v = __ldg(w + (int64_t)k * p.wld + n);
    *reinterpret_cast<uint16_t*>(bs + swz(n, kl >> 3) + 2 * (kl & 7)) = v;
  }
}

// A named barrier of the producer threads alone (barrier 3).
template <int N>
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 3, %0;" ::"n"(N) : "memory");
}

// A producer thread's part of one 64-channel chunk of a tile's halo between
// its loads and its store: HJ 16-byte runs (run pt % 8 of halo pixels pt / 8
// + NP / 8 * j). Raw, Affine, Preact: 8 channels of x from the group's
// first, the fold's a and t of those channels; Dz: the bits of do at the
// run's channel and the pixel's 8 values of A. `in`: which runs lie inside
// the image and cin.
template <class T, class X>
struct HaloSet {
  uint4 v[T::HJ];
  uint4 sa, st;
  uint32_t in;
};

template <class T>
struct HaloSet<T, pc::Dz> {
  uint32_t d[T::HJ];
  float4 alo[T::HJ], ahi[T::HJ];
  uint32_t in;
};

template <class T, class X, bool GR>
__device__ __forceinline__ void load_halo(HaloSet<T, X>& h, const TcArgs& p,
                                          const TilePos& q, int c, int pt) {
  const Geom& g = p.g;
  const int kc = pt & 7;
  const bool valid = 8 * kc < min(64, g.cin - 64 * c);
  const int64_t img = (int64_t)q.b * g.H * g.W;
  const int xo = GR ? q.g * p.xgs : 0;
  h.in = 0u;
  if constexpr (X::kDz) {
    // dz columns 64 c + 8 kc .. of the group: channel 8 c + kc of its do
    const bf16* db = p.x + img * g.C + xo + 8 * c + kc;
    const float* ab = p.att + img * 8;
#pragma unroll
    for (int j = 0; j < T::HJ; ++j) {
      const int hp = (pt >> 3) + T::NP / 8 * j;
      const int hr = hp / T::HW;
      const int y = q.oy0 - 1 + hr, x = q.ox0 - 1 + hp - hr * T::HW;
      const bool in = hp < T::HP && valid && (unsigned)y < (unsigned)g.H &&
                      (unsigned)x < (unsigned)g.W;
      const int64_t pix = in ? (int64_t)y * g.W + x : 0;
      h.d[j] = __ldg(reinterpret_cast<const unsigned short*>(
          in ? db + pix * g.C : p.x));
      const float4* ap =
          reinterpret_cast<const float4*>(in ? ab + pix * 8 : p.att);
      h.alo[j] = __ldg(ap);
      h.ahi[j] = __ldg(ap + 1);
      h.in |= (uint32_t)in << j;
    }
  } else {
    const int ci = xo + 64 * c + 8 * kc;
    const bf16* xb = p.x + img * g.C + ci;
    if ((X::kAffine || X::kAtt) && valid && p.a != nullptr) {
      h.sa = __ldg(reinterpret_cast<const uint4*>(p.a + q.b * g.C + ci));
      h.st = __ldg(reinterpret_cast<const uint4*>(p.t + q.b * g.C + ci));
    } else {
      h.sa = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
      h.st = make_uint4(0u, 0u, 0u, 0u);
    }
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
}

// Run j of the halo set, staged: Dz's 8 products do * A, each rounded once
// (both factors exact in float32); X's staging of 8 channels otherwise.
template <class T, class X>
__device__ __forceinline__ uint4 stage_halo(const HaloSet<T, X>& h, int j) {
  if constexpr (X::kDz) {
    using EB = Elem<bf16>;
    const float d = EB::lo(h.d[j]);
    const float4 u = h.alo[j], w = h.ahi[j];
    return make_uint4(__float_as_uint(EB::pack2(d * u.x, d * u.y)),
                      __float_as_uint(EB::pack2(d * u.z, d * u.w)),
                      __float_as_uint(EB::pack2(d * w.x, d * w.y)),
                      __float_as_uint(EB::pack2(d * w.z, d * w.w)));
  } else {
    return stage8<X>(h.v[j], h.sa, h.st);
  }
}

// AttMul: mult of the chunk's run (channels 64 c + 8 kc ..) for a producer
// thread's AI rows of tile q, the fold's a of the run in sa (packed pairs;
// 1s without the fold). att * attw and its product with a are exact in
// float32 (three bf16 factors), so mult is rounded once. Rows outside the
// image take 0.
template <class T>
__device__ __forceinline__ void att_mult(uint4 (&m)[T::AI], const TcArgs& p,
                                         const TilePos& q, int c,
                                         const uint4& sa, int r0, int kc) {
  using EB = Elem<bf16>;
  const Geom& g = p.g;
  const int cg = g.C / 8;
  const int c0 = 64 * c + 8 * kc;
  float aw[8], a[8];
  int grp[8];
  const uint32_t sw[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    aw[e] = p.pattw != nullptr ? EB::ldg(p.pattw + q.b * 8 + e) : 1.f;
    a[e] = (e & 1) ? EB::hi(sw[e / 2]) : EB::lo(sw[e / 2]);
    grp[e] = min((c0 + e) / cg, 7);
  }
#pragma unroll
  for (int i = 0; i < T::AI; ++i) {
    const int row = r0 + T::RS * i, ry = row / p.tw;
    const int oy = q.oy0 + ry, ox = q.ox0 + row - ry * p.tw;
    const bool in = oy < g.Ho && ox < g.Wo;
    const uint4 u = load16(
        in ? p.patt + (((int64_t)q.b * g.Ho + oy) * g.Wo + ox) * 8 : p.patt);
    const uint32_t uw[4] = {u.x, u.y, u.z, u.w};
    float A[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      A[j] = in ? ((j & 1) ? EB::hi(uw[j / 2]) : EB::lo(uw[j / 2])) * aw[j]
                : 0.f;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float sel = A[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) sel = grp[e] == j ? A[j] : sel;
      v[e] = sel * a[e];
    }
    m[i] = make_uint4(__float_as_uint(EB::pack2(v[0], v[1])),
                      __float_as_uint(EB::pack2(v[2], v[3])),
                      __float_as_uint(EB::pack2(v[4], v[5])),
                      __float_as_uint(EB::pack2(v[6], v[7])));
  }
}

// 8 bf16 times 8 bf16, each product rounded (AttMul's copy of a slice).
__device__ __forceinline__ uint4 mul8(const uint4& x, const uint4& m) {
  using EB = Elem<bf16>;
  return make_uint4(
      __float_as_uint(EB::mul2(__uint_as_float(x.x), __uint_as_float(m.x))),
      __float_as_uint(EB::mul2(__uint_as_float(x.y), __uint_as_float(m.y))),
      __float_as_uint(EB::mul2(__uint_as_float(x.z), __uint_as_float(m.z))),
      __float_as_uint(EB::mul2(__uint_as_float(x.w), __uint_as_float(m.w))));
}

// The producers of a 3x3, stride-1 convolution with the vector staging: per
// 64-channel chunk of a tile they stage its halo, (TH + 2) x (TW + 2) input
// pixels with the staging (fold, swish; Dz's products) applied once, into
// one of two buffers, and each of the chunk's slices of A is a copy of the
// tile's rows shifted by the tap, shared memory to shared memory: each input
// value is loaded and staged once a tile and chunk, not once a tap. A slice
// is one tap of the chunk, or with p.flat (cin <= 64) 64 flat k = tap * cin
// + ci (64 / cin taps). The next chunk's halo is loaded into registers while
// this one's slices are copied. One producer barrier a chunk: every
// thread's copies from a buffer end before the barrier that follows the
// staging of the other buffer.
template <class T, class X, bool GR, class Begin, class Finish>
__device__ __forceinline__ void produce_halo(const TcArgs& p,
                                             const Ring<T>& ring,
                                             const Begin& begin,
                                             const Finish& finish) {
  const Geom& g = p.g;
  const int pt = threadIdx.x - T::NC;
  const int kc = pt & 7, r0 = pt >> 3;
  const bool flat = GR && p.flat;
  const int nch = flat ? 1 : (g.cin + 63) / 64;
  const int nsl = flat ? (g.K + 63) / 64 : 9;
  int t = first_tile<GR>(p), c = 0, s = 0, hb = 0;
  if (t >= p.tiles) return;
  TilePos q = tile_pos<GR>(p, t);
  HaloSet<T, X> h;
  load_halo<T, X, GR>(h, p, q, c, pt);
  constexpr bool kMul = X::kAtt;
  uint4 mult[kMul ? T::AI : 1];
  while (t < p.tiles) {
    uint8_t* hbuf = ring.base + T::HBUF + hb * T::HP * 128;
    if constexpr (kMul) att_mult<T>(mult, p, q, c, h.sa, r0, kc);
    // outside the image: 0, or AttMul's ring (h.st: 0 past cin)
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kMul) out = h.st;
#pragma unroll
    for (int j = 0; j < T::HJ; ++j) {
      const int hp = r0 + T::NP / 8 * j;
      if (hp < T::HP)
        *reinterpret_cast<uint4*>(hbuf + swz(hp, kc)) =
            ((h.in >> j) & 1u) ? stage_halo<T, X>(h, j) : out;
    }
    producer_sync<T::NP>();
    int tn = t, cn = c + 1;
    if (cn >= nch) {
      cn = 0;
      tn = next_tile<GR>(p, t);
    }
    const TilePos qn = tn != t && tn < p.tiles ? tile_pos<GR>(p, tn) : q;
    if (tn < p.tiles) load_halo<T, X, GR>(h, p, qn, cn, pt);
    const int cc = min(64, g.cin - 64 * c);
    const WSel ws = wsel<GR>(p, q);
    for (int sl = 0; sl < nsl; ++sl, ++s) {
      const int krow = flat ? 64 * sl : sl * g.cin + 64 * c;
      const int kval = flat ? min(64, g.K - krow) : cc;
      begin(s, krow, ws);
      int tap, ci;
      if (flat) {
        const int kl = 64 * sl + 8 * kc;
        tap = kl / g.cin;
        ci = kl - tap * g.cin;
      } else {
        tap = sl;
        ci = 8 * kc;
      }
      const bool ok = tap < 9 && ci < cc;
      const int ty = tap / 3, tx = tap - 3 * ty;
      uint8_t* as = ring.a(s);
#pragma unroll
      for (int i = 0; i < T::AI; ++i) {
        const int row = r0 + T::RS * i;
        const int hp = (row / T::TW + ty) * T::HW + row % T::TW + tx;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          v = *reinterpret_cast<const uint4*>(hbuf + swz(hp, ci >> 3));
          if constexpr (kMul) v = mul8(v, mult[i]);
        }
        *reinterpret_cast<uint4*>(as + swz(row, kc)) = v;
      }
      finish(s, krow, kval, ws);
    }
    t = tn;
    c = cn;
    q = qn;
    hb ^= 1;
  }
}

// The vector staging without a halo (stride 2, 1x1; one group): each
// tap's rows loaded and staged as such, three slices ahead in registers.
template <class T, class X, class Begin, class Finish>
__device__ __forceinline__ void produce_vec(const TcArgs& p,
                                            const Ring<T>& ring,
                                            const Begin& begin,
                                            const Finish& finish) {
  const int pt = threadIdx.x - T::NC;
  const int kc = pt & 7, r0 = pt >> 3;
  const int total = p.tiles;
  TileRows<T> tr;
  const int ns = (total - blockIdx.x + gridDim.x - 1) / gridDim.x * p.nk;
  constexpr int D = 3;  // slices in registers: loads run two slices ahead
  ASet<T> q[D];
  Walk wk = {(int)blockIdx.x, 0, 0};
  tile_rows<T, false>(tr, p, wk.t, r0);
#pragma unroll
  for (int j = 0; j < D - 1; ++j)
    if (j < ns) load_vec<T, X>(q[j], wk, tr, p, r0, kc);
  for (int s0 = 0; s0 < ns; s0 += D) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int s = s0 + j;
      if (s >= ns) break;
      if (s + D - 1 < ns)
        load_vec<T, X>(q[(j + D - 1) % D], wk, tr, p, r0, kc);
      const ASet<T>& c = q[j];
      // one group: its weights from column n0 of row 0
      const WSel ws = {c.n0, min(T::BN, p.cout - c.n0), 0, c.n0};
      begin(s, c.krow, ws);
      uint8_t* as = ring.a(s);
#pragma unroll
      for (int i = 0; i < T::AI; ++i) {
        const uint4 v = ((c.in >> i) & 1u) ? stage8<X>(c.v[i], c.sa, c.st)
                                           : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(as + swz(r0 + T::RS * i, kc)) = v;
      }
      finish(s, c.krow, c.kval, ws);
    }
  }
}

// cin % 8 != 0 or an unaligned operand: the flat k of igemm_pc.cuh, one
// value at a time. Warp w stages 8-column chunk w of the slice for the
// rows lane + 32 * i, so that a warp whose chunk lies past K (cin = 6: K =
// 54 at 3x3, 6 at 1x1) stores zeros and loads nothing.
template <class T, class X, bool GR, class Begin, class Finish>
__device__ __forceinline__ void produce_scalar(const TcArgs& p,
                                               const Ring<T>& ring,
                                               const Begin& begin,
                                               const Finish& finish) {
  const Geom& g = p.g;
  const int pt = threadIdx.x - T::NC;
  const int total = p.tiles;
  TileRows<T> tr;
  const int wc = pt >> 5, lr = pt & 31;
  int s = 0;
  for (int t = first_tile<GR>(p); t < total; t = next_tile<GR>(p, t)) {
    tile_rows<T, GR>(tr, p, t, lr);
    const WSel ws = wsel<GR>(p, tr.q);
    for (int c = 0; c < p.nk; ++c, ++s) {
      const int k0 = 64 * c;
      begin(s, k0, ws);
      uint8_t* as = ring.a(s);
      if (k0 + 8 * wc >= g.K) {
#pragma unroll
        for (int i = 0; i < T::AI; ++i)
          *reinterpret_cast<uint4*>(as + swz(lr + T::RS * i, wc)) =
              make_uint4(0u, 0u, 0u, 0u);
        finish(s, k0, 64, ws);
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
      finish(s, k0, 64, ws);
    }
  }
}

// The producers' side: the block's tiles (first_tile, next_tile) in turn,
// nk slices each, one stream of slices s across the tiles, so the next
// tile's first slices are staged while the consumers run the epilogue of
// this one. Stage s % S of slice s is staged after the consumers have
// released slice s - S; each producer warp arrives on full[] after its
// stores and a proxy fence, and thread 0 also arrives with the bytes its TMA
// copies will bring. The grouped products (GR, gconv_tc_kernel: 3x3, stride
// 1) take the halo or the scalar staging; the vector staging without a halo
// (stride 2, 1x1) and A by TMA serve one group.
template <class T, class X, bool BT, bool AT, bool GR>
__device__ __forceinline__ void produce(const TcArgs& p, const CUtensorMap* ma,
                                        const CUtensorMap* mb,
                                        const Ring<T>& ring) {
  const int pt = threadIdx.x - T::NC;
  if constexpr (AT) {  // K3: both operands by TMA, one thread
    if (pt != 0) return;
    int s = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const TilePos q = tile_pos<false>(p, t);
      for (int c = 0; c < p.nk; ++c, ++s) {
        ring.acquire(s);
        ring.expect(s, T::STAGE);
        tma_load(ring.a(s), ma, 64 * c, q.ox0, &ring.full[s % T::S]);
        ring.load_w(mb, s, 64 * c, q.n0);
      }
    }
    return;
  }
  // thread 0's TMA of the slice's Wt; then the slice's A rows and, without
  // TMA, its Wt; then the fence and the warp's arrive
  auto begin = [&](int s, int krow, const WSel& ws) {
    ring.acquire(s);
    if (BT && pt == 0) {
      ring.expect(s, T::B_BYTES);
      ring.load_w(mb, s, ws.row + krow, ws.col);
    }
  };
  auto finish = [&](int s, int krow, int kval, const WSel& ws) {
    if constexpr (!BT) store_w<T>(ring.b(s), p, ws, krow, kval);
    ring.hand_over(s);
  };
  if (p.halo) {
    produce_halo<T, X, GR>(p, ring, begin, finish);
  } else if constexpr (!X::kDz && !X::kAtt) {
    // (dz columns come 8 to a channel; AttMul runs on the halo alone)
    if (!GR && p.vec)
      produce_vec<T, X>(p, ring, begin, finish);
    else
      produce_scalar<T, X, GR>(p, ring, begin, finish);
  }
}

// The consumers' side of one tile: warpgroup wg multiplies rows 64 * wg ..
// + 63 of each of the tile's nk slices (block slices s .. s + nk - 1) into
// acc, four k16 steps a slice, and releases a stage once the products that
// read it have completed (one slice's batch stays in flight; the tile's last
// stage is released before its epilogue).
template <class T, bool BT, int TA = 0>
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
      Mma<T::BN>::template run<TA, BT ? 1 : 0>(
          acc, TA ? desc_mn(as, kk) : desc_k(as, kk),
          BT ? desc_mn(bs, kk) : desc_k(bs, kk));
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
    produce<T, X, BT, AT, false>(p, &ma, &mb, ring);
    return;
  }
  if constexpr (T::CREG != 128) setmaxnreg_dec<T::CREG>();
  int s = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x, s += p.nk) {
    float acc[T::BN / 2];
    consume<T, BT>(acc, ring, s, p.nk);
    epilogue<T>(acc, p, red, epi, tile_pos<false>(p, t));
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
enum Entry {
  TC_CONV3X3, TC_PREACT, TC_CONV1X1, TC_CONV3X3_BWD, TC_AKGM_BWD, TC_AKGM_TAIL,
  TC_AKGM_MIX, TC_AKGM_PACKED, TC_ENTRIES
};
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
  // one group of every column, a block's tiles one at a time
  c.gw = c.wld = c.cout;
  c.tnw = T::BN;
  c.ntg = c.ntn;
  c.xgs = c.wgr = c.wgc = 0;
  c.wrows = c.g.K;
  c.tpu = 1;
  c.units = c.tiles;
  c.flat = false;
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


// ---- The backward's products in bf16 (K6: conv3x3_bwd.cu, K5:
// akgm_tail_bwd.cu), and K1's (akgm_tail.cu: K5's z recompute run
// forward), on the same ring, tiles and consumers.
//
// gconv_tc_kernel is conv_tc_kernel's product for a 3x3, stride-1
// convolution, with the same producers (produce), and
//   - groups: the output columns in groups of gw, group g reading channels
//     [g * xgs, + cin) of x, its weights from row g * wgr, column g * wgc
//     of the (wrows, wld) matrix w; a
//     column tile lies in one group (min(BN, gw) columns);
//   - the staging X: Affine (K6's and K5's recomputed z, K1's z), Dgrad
//     (K6's input gradient: raw) or Dz (K5's input gradient: dz[c * 8 + j]
//     = do[c] * A[j], rebuilt from do and the float32 A as it is staged,
//     rounded once);
//   - the halo's slices flat (p.flat) below 64 channels: 64 consecutive k =
//     tap * cin + ci, 64 / cin taps a slice (K5's z at cin = 8: 2 slices,
//     not 9); cin % 8 != 0 takes the scalar staging;
//   - the epilogue Epi: OutEpi (the output rounded once; DZ: dz = go *
//     swish'(z + bias) in float32, rounded once), MixEpi (K5's do, A and
//     datt terms; a block walking units of tpu column tiles in a row) or
//     TailEpi (K1's mix, swish, residual and statistics).
//
// wgrad_tc_kernel is the weight gradient dW (K x N) = im2col(x * a + t)^T
// D, reduced over pixels. Both operands are the NHWC rows as they lie, read
// MN-major by wgmma (the transpose bits): the im2col side A (k = M, 128 a
// tile, the producers staging 64 pixels of each 16-byte run of k a slice)
// and D (N, by TMA where it is a plain matrix, else rebuilt by the
// producers). The pixels of the batch are cut into chunks of a multiple of
// 64; each block's partial tile goes plainly into a float32 workspace (S,
// K + 1, N), whose row K is the bias: K6's from a column of ones in A (k =
// K), K5's the float32 sums of its unrounded dz, which the producers
// rebuild. pc::wgrad_reduce_kernel adds the chunks in ascending order and
// rounds dW and dbias once: the same bits from call to call.

// consume(), each slice's four k16 steps summed by the tensor core into a
// fresh fragment that is then added into acc in float32, rounded to
// nearest: the tensor core's own adds (not rounded to nearest) then span 64
// k, not all of K. The recomputed z of K6 and K5 take it: dz = go *
// swish'(z) (K6) and z's roundings in m = z * A and do * z (K5) are rounded
// to bf16 from the float32 z, so z's error moves those roundings, and each
// flipped value moves every sum that reads it (at K = 9 * 512 K6's input
// gradient kept 96.7% of the plain version's bits with the tensor core's
// sum over all of K, 99.3% with this; K5's dattw, 8 sums an image over all
// pixels and channels, lost a bit in 1 of 8 to 16).
template <class T, bool BT>
__device__ __forceinline__ void consume_promoted(float (&acc)[T::BN / 2],
                                                 const Ring<T>& ring, int s,
                                                 int nk) {
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int j = 0; j < T::BN / 2; ++j) acc[j] = 0.f;
  for (int c = 0; c < nk; ++c, ++s) {
    float part[T::BN / 2];
#pragma unroll
    for (int j = 0; j < T::BN / 2; ++j) part[j] = 0.f;
    ring.wait_full(s);
    const uint32_t as = smem_addr(ring.a(s)) + 8192 * wg;
    const uint32_t bs = smem_addr(ring.b(s));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<T::BN>::template run<0, BT ? 1 : 0>(
          part, desc_k(as, kk), BT ? desc_mn(bs, kk) : desc_k(bs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    ring.release(s);
#pragma unroll
    for (int j = 0; j < T::BN / 2; ++j) acc[j] += part[j];
  }
}

struct NoArgs {};

// The output of a grouped product: + bias (null: none), rounded once into
// the warp's rows in shared memory, stored from there 16 bytes a lane, the
// group's columns only. DZ (K6's dz): the warp's rows of go first copied
// into those rows 16 bytes a lane, then dz = go * swish'(acc + bias) in
// float32 in place of the output, rounded once.
template <bool DZ>
struct OutEpi {
  using Args = NoArgs;
  static constexpr bool kPromote = DZ;  // consume_promoted
  __device__ __forceinline__ void begin(const TcArgs&, const NoArgs&,
                                        const TilePos&, uint8_t*) {}
  template <class T>
  __device__ __forceinline__ void prefetch(const TcArgs&, const NoArgs&,
                                           const TilePos&) {}
  template <class T>
  __device__ __forceinline__ void end(const TcArgs&, const NoArgs&,
                                      const TilePos&, uint8_t*) {}
  template <class T>
  __device__ __forceinline__ void tile(const float (&acc)[T::BN / 2],
                                       const TcArgs& p, const NoArgs&,
                                       const TilePos& q, uint8_t* epi) {
    using EB = Elem<bf16>;
    constexpr int RUNS = T::BN / 8;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int Ho = p.g.Ho, Wo = p.g.Wo, N = p.cout;
    const bool vec = p.vec_out && (q.n0 & 7) == 0;
    uint8_t* rows = epi + warp * 16 * T::EPITCH;
    __syncwarp();  // the previous tile's runs are read
    if constexpr (DZ) {
      for (int i = lane; i < 16 * RUNS; i += 32) {
        const int rr = i / RUNS, n = q.n0 + 8 * (i - rr * RUNS);
        const int r = 16 * warp + rr;
        const int y = q.oy0 + r / p.tw, x = q.ox0 + r % p.tw;
        if (y >= Ho || x >= Wo || n >= q.nend) continue;
        const bf16* src = p.go + (((int64_t)q.b * Ho + y) * Wo + x) * N + n;
        uint8_t* dst = rows + rr * T::EPITCH + 2 * (n - q.n0);
        if (vec && n + 8 <= q.nend) {
          *reinterpret_cast<uint4*>(dst) = load16(src);
        } else {
          for (int e = 0; e < 8 && n + e < q.nend; ++e)
            reinterpret_cast<uint16_t*>(dst)[e] =
                __ldg(reinterpret_cast<const unsigned short*>(src) + e);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < RUNS; ++j) {
      const int cl = 8 * j + 2 * (lane & 3);
      const int n = q.n0 + cl;
      const float b0 = (p.bias && n < q.nend) ? EB::ld(p.bias + n) : 0.f;
      const float b1 = (p.bias && n + 1 < q.nend) ? EB::ld(p.bias + n + 1)
                                                  : 0.f;
      float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0,
                    acc[4 * j + 3] + b1};
      uint8_t* ra = rows + (lane >> 2) * T::EPITCH + 2 * cl;
      uint8_t* rb = ra + 8 * T::EPITCH;
      if constexpr (DZ) {
        const uint32_t ga = *reinterpret_cast<const uint32_t*>(ra);
        const uint32_t gb = *reinterpret_cast<const uint32_t*>(rb);
        v[0] = EB::lo(ga) * dswishf(v[0]);
        v[1] = EB::hi(ga) * dswishf(v[1]);
        v[2] = EB::lo(gb) * dswishf(v[2]);
        v[3] = EB::hi(gb) * dswishf(v[3]);
      }
      *reinterpret_cast<float*>(ra) = EB::pack2(v[0], v[1]);
      *reinterpret_cast<float*>(rb) = EB::pack2(v[2], v[3]);
    }
    __syncwarp();
    for (int i = lane; i < 16 * RUNS; i += 32) {
      const int rr = i / RUNS, n = q.n0 + 8 * (i - rr * RUNS);
      const int r = 16 * warp + rr;
      const int y = q.oy0 + r / p.tw, x = q.ox0 + r % p.tw;
      if (y >= Ho || x >= Wo || n >= q.nend) continue;
      const uint8_t* src = rows + rr * T::EPITCH + 2 * (n - q.n0);
      bf16* dst = p.out + (((int64_t)q.b * Ho + y) * Wo + x) * N + n;
      if (vec && n + 8 <= q.nend) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && n + e < q.nend; ++e)
          reinterpret_cast<uint16_t*>(dst)[e] =
              reinterpret_cast<const uint16_t*>(src)[e];
      }
    }
  }
};

// K5's z recompute with the mix as its epilogue (K1 runs the same product
// and mix forward). The columns are in natural order, c * 8 + j: in wgmma's
// accumulator a row's 8 columns of one 8-column slab, one channel's 8
// candidates, lie on the 4 lanes of a quad, 2 each. Per slab and row: m =
// z * A of z and A each rounded, itself rounded; o = the 8 terms added, a
// lane's 2 and then over the quad by two shuffles ((m0 + m1) + (m2 + m3)) +
// ((m4 + m5) + (m6 + m7)); do = go * swish'(o) rounded once, stored by the
// quad's first lane; the datt terms do * z (z unrounded) rounded and added
// in the lane's registers in ascending channel order across the unit's
// column tiles, which are every channel of the pixel tile: the lane ends
// with whole sums of its 2 rows and 2 candidates. At the unit's end datt =
// q * attw rounded once, and the dattw terms q * att of the tile's 128
// pixels added in ascending pixel order into the (B, pixel tiles, 8)
// workspace, which dattw_reduce_kernel adds in a fixed order. A = att *
// attw (exact in float32) is written for the input and weight gradients.
struct MixArgs {
  const bf16* go;    // (B, H, W, C)
  const bf16* att;   // (B, H, W, 8)
  const bf16* attw;  // (B, 8) or null
  bf16* dout;        // (B, H, W, C) do
  float* aa;         // (B, H, W, 8) A = att * attw
  bf16* datt;        // (B, H, W, 8)
  float* ws;         // (B, pixel tiles, 8) dattw terms a tile, or null
};

// NV consecutive bf16 (a run of a row) loaded into packed words, with one
// load where all NV are valid and the run is aligned to its width, else one
// by one (those past `valid` as 0); and stored alike from floats, each
// rounded once.
template <int NV>
__device__ __forceinline__ void load_run(uint32_t (&w)[(NV + 1) / 2],
                                         const bf16* p, int valid) {
  const bool whole = valid >= NV &&
                     reinterpret_cast<uintptr_t>(p) % (2 * NV) == 0;
  if constexpr (NV == 8) {
    if (whole) {
      const uint4 u = load16(p);
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
      return;
    }
  } else if constexpr (NV == 4) {
    if (whole) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x; w[1] = u.y;
      return;
    }
  } else if constexpr (NV == 2) {
    if (whole) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
      return;
    }
  }
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int i = 0; i < (NV + 1) / 2; ++i) {
    const uint32_t lo = 2 * i < valid ? __ldg(h + 2 * i) : 0u;
    const uint32_t hi = 2 * i + 1 < valid && 2 * i + 1 < NV
                            ? __ldg(h + 2 * i + 1) : 0u;
    w[i] = lo | hi << 16;
  }
}

template <int NV>
__device__ __forceinline__ void store_run(bf16* p, const float (&v)[NV],
                                          int valid) {
  using EB = Elem<bf16>;
  const bool whole = valid >= NV &&
                     reinterpret_cast<uintptr_t>(p) % (2 * NV) == 0;
  if constexpr (NV == 8) {
    if (whole) {
      *reinterpret_cast<uint4*>(p) = make_uint4(
          __float_as_uint(EB::pack2(v[0], v[1])),
          __float_as_uint(EB::pack2(v[2], v[3])),
          __float_as_uint(EB::pack2(v[4], v[5])),
          __float_as_uint(EB::pack2(v[6], v[7])));
      return;
    }
  } else if constexpr (NV == 4) {
    if (whole) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(__float_as_uint(EB::pack2(v[0], v[1])),
                     __float_as_uint(EB::pack2(v[2], v[3])));
      return;
    }
  } else if constexpr (NV == 2) {
    if (whole) {
      *reinterpret_cast<uint32_t*>(p) = __float_as_uint(EB::pack2(v[0], v[1]));
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < valid) EB::st(p + i, v[i]);
}

struct MixEpi {
  using Args = MixArgs;
  static constexpr bool kPromote = true;  // z's roundings move do and datt
  static constexpr int MAXS = 8;          // slabs a tile (64 columns)
  float at[2][2], aw[2], q[2][2];
  float ap[2];      // A of the lane's 2 candidates, rounded and packed
  int64_t pix[2];
  bool in[2];
  uint32_t gr[2][MAXS / 2];  // go of the tile's channels, rows a and b
  uint32_t bb[MAXS];         // the bias of the lane's 2 columns a slab

  // rows 16 warp + lane / 4 and + 8 of the tile
  __device__ __forceinline__ void begin(const TcArgs& p, const MixArgs& e,
                                        const TilePos& gq, uint8_t*) {
    using EB = Elem<bf16>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j0 = 2 * (lane & 3);
    aw[0] = aw[1] = 1.f;
    if (e.attw != nullptr) {
      aw[0] = EB::ld(e.attw + gq.b * 8 + j0);
      aw[1] = EB::ld(e.attw + gq.b * 8 + j0 + 1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + (lane >> 2) + 8 * r;
      const int y = gq.oy0 + row / p.tw, x = gq.ox0 + row % p.tw;
      in[r] = y < p.g.Ho && x < p.g.Wo;
      pix[r] = ((int64_t)gq.b * p.g.Ho + y) * p.g.Wo + x;
      float v[2] = {0.f, 0.f};
      if (in[r]) EB::ld2(v, e.att + pix[r] * 8 + j0);
      at[r][0] = v[0];
      at[r][1] = v[1];
      const float A0 = v[0] * aw[0], A1 = v[1] * aw[1];
      ap[r] = EB::pack2(A0, A1);
      if (in[r])
        *reinterpret_cast<float2*>(e.aa + pix[r] * 8 + j0) =
            make_float2(A0, A1);
      q[r][0] = q[r][1] = 0.f;
    }
  }

  // before the tile's product: its rows' go and its bias, so that no load
  // waits in the epilogue
  template <class T>
  __device__ __forceinline__ void prefetch(const TcArgs& p, const MixArgs& e,
                                           const TilePos& gq) {
    constexpr int NS = T::BN / 8;
    static_assert(NS <= MAXS, "promoted tiles: 64 columns at most");
    const int lane = threadIdx.x & 31;
    const int C = p.cout / 8, nv = (gq.nend - gq.n0) / 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t w[(NS + 1) / 2];
      load_run<NS>(w, e.go + pix[r] * C + gq.n0 / 8, in[r] ? nv : 0);
#pragma unroll
      for (int i = 0; i < (NS + 1) / 2; ++i) gr[r][i] = w[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
      bb[j] = j < nv ? __ldg(reinterpret_cast<const unsigned int*>(
                           p.bias + gq.n0 + 8 * j + 2 * (lane & 3)))
                     : 0u;
  }

  template <class T>
  __device__ __forceinline__ void tile(const float (&acc)[T::BN / 2],
                                       const TcArgs& p, const MixArgs& e,
                                       const TilePos& gq, uint8_t*) {
    using EB = Elem<bf16>;
    constexpr int NS = T::BN / 8;
    const int lane = threadIdx.x & 31;
    const int C = p.cout / 8, nv = (gq.nend - gq.n0) / 8;
    float dv[2][NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      dv[0][j] = dv[1][j] = 0.f;
      if (j >= nv) continue;  // the same for the whole block
      const float b0 = EB::lo(bb[j]), b1 = EB::hi(bb[j]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float z0 = acc[4 * j + 2 * r] + b0;
        const float z1 = acc[4 * j + 2 * r + 1] + b1;
        const float m = EB::mul2(EB::pack2(z0, z1), ap[r]);
        float o = EB::lof(m) + EB::hif(m);
        o += pc::shfl_xor(o, 1);
        o += pc::shfl_xor(o, 2);
        const uint32_t gw = gr[r][j / 2];
        const float g = (j & 1) ? EB::hi(gw) : EB::lo(gw);
        const float d = EB::rnd(g * dswishf(o));
        dv[r][j] = d;
        const float t = EB::pack2(__fmul_rn(d, z0), __fmul_rn(d, z1));
        q[r][0] += EB::lof(t);
        q[r][1] += EB::hif(t);
      }
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (in[r]) store_run<NS>(e.dout + pix[r] * C + gq.n0 / 8, dv[r], nv);
    }
  }

  template <class T>
  __device__ __forceinline__ void end(const TcArgs& p, const MixArgs& e,
                                      const TilePos& gq, uint8_t* epi) {
    using EB = Elem<bf16>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j0 = 2 * (lane & 3);
    float* terms = reinterpret_cast<float*>(epi);  // (128 rows, 8)
    static_assert(T::EPI_BYTES >= T::BM * 8 * 4, "dattw terms fit");
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + (lane >> 2) + 8 * r;
      float t0 = 0.f, t1 = 0.f;
      if (in[r]) {
        EB::st2(e.datt + pix[r] * 8 + j0, q[r][0] * aw[0], q[r][1] * aw[1]);
        t0 = q[r][0] * at[r][0];
        t1 = q[r][1] * at[r][1];
      }
      terms[row * 8 + j0] = t0;
      terms[row * 8 + j0 + 1] = t1;
    }
    if (e.ws == nullptr) return;
    consumer_sync<T::NC>();
    if (threadIdx.x < 8) {
      float v = 0.f;
      for (int m = 0; m < T::BM; ++m) v += terms[m * 8 + threadIdx.x];
      e.ws[((int64_t)gq.b * p.ntp + gq.mt) * 8 + threadIdx.x] = v;
    }
    consumer_sync<T::NC>();  // the terms are read before the next unit's
  }
};

// K1's tail (akgm_tail.cu) as the epilogue of the same product, run
// forward: per slab and row the mix o as MixEpi forms it (z + bias and A
// each rounded, z * A rounded, the 8 terms over the quad by two shuffles),
// which leaves o of every slab on all 4 lanes of the quad; lane k then
// takes its own run of LS = NS / 4 slabs (channels LS k ..): v = swish(o) +
// res rounded once, stored LS channels a row, so the swish runs once a
// value, not 4 times. With a workspace, the tile's sums of v and v * v per
// channel in a fixed order: a lane's 2 rows, then the warp's 8 quads by
// three shuffles, then the 8 consumer warps in warp order through epi (two
// buffers, a tile each in turn, so one barrier a tile), stored plainly at
// ws (B, pixel tiles, 2, C), which stats_reduce_kernel (tile_sums.cuh) adds
// over the tiles. Rows outside the image store and add nothing. z is the
// tensor core's own sum over all of K, on tiles of 128 columns where a
// group is that wide (consume_promoted, K5's per-slice sum, would cap the
// tile at 64 columns: measured slower, PERF.md §6).
struct TailArgs {
  const bf16* att;   // (B, H, W, 8)
  const bf16* attw;  // (B, 8) or null
  const bf16* res;   // (B, H, W, C)
  bf16* out;         // (B, H, W, C)
  float* ws;         // (B, pixel tiles, 2, C) per-tile sums, or null
};

struct TailEpi {
  using Args = TailArgs;
  static constexpr bool kPromote = false;
  static constexpr int MAXS = 16;  // slabs a tile: 128 columns at most
  static constexpr int MAXL = (MAXS + 3) / 4;  // a lane's slabs
  float ap[2];     // A of the lane's 2 candidates, rounded and packed
  int64_t pix[2];
  bool in[2];
  int turn = 0;    // the tile's buffer of warp sums in epi
  uint32_t rr[2][(MAXL + 1) / 2];  // res of the lane's channels, rows a, b
  uint32_t bb[MAXS];               // the bias of the lane's 2 columns a slab

  // rows 16 warp + lane / 4 and + 8 of the tile
  __device__ __forceinline__ void begin(const TcArgs& p, const TailArgs& e,
                                        const TilePos& gq, uint8_t*) {
    using EB = Elem<bf16>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j0 = 2 * (lane & 3);
    float aw[2] = {1.f, 1.f};
    if (e.attw != nullptr) EB::ld2(aw, e.attw + gq.b * 8 + j0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + (lane >> 2) + 8 * r;
      const int y = gq.oy0 + row / p.tw, x = gq.ox0 + row % p.tw;
      in[r] = y < p.g.Ho && x < p.g.Wo;
      pix[r] = ((int64_t)gq.b * p.g.Ho + y) * p.g.Wo + x;
      float v[2] = {0.f, 0.f};
      if (in[r]) EB::ld2(v, e.att + pix[r] * 8 + j0);
      ap[r] = EB::pack2(v[0] * aw[0], v[1] * aw[1]);
    }
  }

  // before the tile's product: the residual of the lane's channels of its
  // rows and the tile's bias, so that no load waits in the epilogue
  template <class T>
  __device__ __forceinline__ void prefetch(const TcArgs& p, const TailArgs& e,
                                           const TilePos& gq) {
    constexpr int NS = T::BN / 8, LS = (NS + 3) / 4;
    static_assert(NS <= MAXS, "128 columns at most");
    const int lane = threadIdx.x & 31, k = lane & 3;
    const int C = p.cout / 8, nv = (gq.nend - gq.n0) / 8;
    const int mine = min(max(nv - LS * k, 0), LS);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t w[(LS + 1) / 2];
      load_run<LS>(w, e.res + pix[r] * C + gq.n0 / 8 + LS * k,
                   in[r] ? mine : 0);
#pragma unroll
      for (int i = 0; i < (LS + 1) / 2; ++i) rr[r][i] = w[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
      bb[j] = j < nv ? __ldg(reinterpret_cast<const unsigned int*>(
                           p.bias + gq.n0 + 8 * j + 2 * k))
                     : 0u;
  }

  template <class T>
  __device__ __forceinline__ void tile(const float (&acc)[T::BN / 2],
                                       const TcArgs& p, const TailArgs& e,
                                       const TilePos& gq, uint8_t* epi) {
    using EB = Elem<bf16>;
    constexpr int NS = T::BN / 8, LS = (NS + 3) / 4;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, k = lane & 3;
    const int C = p.cout / 8, nv = (gq.nend - gq.n0) / 8;
    float om[2][LS] = {};  // o of the lane's slabs LS k .. LS k + LS - 1
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (j >= nv) continue;  // the same for the whole block
      const float b0 = EB::lo(bb[j]), b1 = EB::hi(bb[j]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float z0 = acc[4 * j + 2 * r] + b0;
        const float z1 = acc[4 * j + 2 * r + 1] + b1;
        const float m = EB::mul2(EB::pack2(z0, z1), ap[r]);
        float o = EB::lof(m) + EB::hif(m);
        o += pc::shfl_xor(o, 1);
        o += pc::shfl_xor(o, 2);
        if (j / LS == k) om[r][j % LS] = o;
      }
    }
    float v[2][LS] = {};  // v of the lane's channels, bf16 values
    float s[LS], q[LS];   // the lane's 2 rows' sums a channel
#pragma unroll
    for (int u = 0; u < LS; ++u) {
      s[u] = q[u] = 0.f;
      if (LS * k + u >= nv) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t rw = rr[r][u / 2];
        const float res = (u & 1) ? EB::hi(rw) : EB::lo(rw);
        v[r][u] = EB::rnd(swishf(om[r][u]) + res);
        if (in[r]) {
          s[u] += v[r][u];
          q[u] += v[r][u] * v[r][u];
        }
      }
    }
    const int mine = min(max(nv - LS * k, 0), LS);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (in[r] && mine > 0)
        store_run<LS>(e.out + pix[r] * C + gq.n0 / 8 + LS * k, v[r], mine);
    if (e.ws == nullptr) return;
    // the sums over the warp's 8 quads, the lane's LS channels each
    float* red = reinterpret_cast<float*>(epi) + turn * (T::NC / 32) * 2 * NS;
    static_assert(T::EPI_BYTES >= 2 * (T::NC / 32) * 2 * MAXS * 4,
                  "two buffers of warp sums fit");
#pragma unroll
    for (int u = 0; u < LS; ++u) {
#pragma unroll
      for (int d = 4; d < 32; d <<= 1) {
        s[u] += pc::shfl_xor(s[u], d);
        q[u] += pc::shfl_xor(q[u], d);
      }
      const int j = LS * lane + u;
      if (lane < 4 && j < NS) {
        red[(warp * 2) * NS + j] = s[u];
        red[(warp * 2 + 1) * NS + j] = q[u];
      }
    }
    consumer_sync<T::NC>();
    if ((int)threadIdx.x < nv) {
      const int j = threadIdx.x;
      float S = 0.f, Q = 0.f;
#pragma unroll
      for (int w = 0; w < T::NC / 32; ++w) {
        S += red[(w * 2) * NS + j];
        Q += red[(w * 2 + 1) * NS + j];
      }
      float* o = e.ws + ((int64_t)gq.b * p.ntp + gq.mt) * 2 * C + gq.n0 / 8;
      o[j] = S;
      o[C + j] = Q;
    }
    turn ^= 1;  // the next tile writes the other buffer; the barrier of
                // the one after it waits for this one's reads
  }

  template <class T>
  __device__ __forceinline__ void end(const TcArgs&, const TailArgs&,
                                      const TilePos&, uint8_t*) {}
};

// A persistent block walks its units of p.tpu tiles (columns fastest) of
// the (B, ntp, ntn) grid.
template <class T, class X, bool BT, class Epi>
__global__ void __launch_bounds__(T::NT, 1)
    gconv_tc_kernel(const TcArgs p, const typename Epi::Args e,
                    const __grid_constant__ CUtensorMap mb) {
  extern __shared__ uint8_t smem_raw[];
  const Ring<T> ring(smem_raw);
  uint8_t* epi = ring.base + T::EPI;
  if (threadIdx.x == 0) ring.init(T::PW + (BT ? 1 : 0));
  __syncthreads();
  if (threadIdx.x >= T::NC) {
    if constexpr (T::PREG != 128) setmaxnreg_inc<T::PREG>();
    produce<T, X, BT, false, true>(p, &mb, &mb, ring);
    return;
  }
  if constexpr (T::CREG != 128) setmaxnreg_dec<T::CREG>();
  Epi ep;
  int s = 0;
  for (int t = first_tile<true>(p); t < p.tiles;
       t = next_tile<true>(p, t), s += p.nk) {
    const TilePos q = tile_pos<true>(p, t);
    if (t % p.tpu == 0) ep.begin(p, e, q, epi);
    ep.template prefetch<T>(p, e, q);
    float acc[T::BN / 2];
    if constexpr (Epi::kPromote)
      consume_promoted<T, BT>(acc, ring, s, p.nk);
    else
      consume<T, BT>(acc, ring, s, p.nk);
    ep.template tile<T>(acc, p, e, q, epi);
    if ((t + 1) % p.tpu == 0) ep.template end<T>(p, e, q, epi);
  }
}

template <class T, class X, bool BT, class Epi>
int launch_g_tile(TcArgs p, const typename Epi::Args& e, int B, bool units,
                  cudaStream_t st) {
  const Geom& g = p.g;
  p.tnw = min(T::BN, p.gw);
  p.ntg = (p.gw + p.tnw - 1) / p.tnw;
  p.ntn = p.cout / p.gw * p.ntg;
  p.th = 8;
  p.tw = 16;
  p.ntx = (g.Wo + 15) / 16;
  p.ntp = (g.Ho + 7) / 8 * p.ntx;
  p.tiles = B * p.ntp * p.ntn;
  p.tpu = units ? p.ntn : 1;
  p.units = p.tiles / p.tpu;
  CUtensorMap mb = {};
  if (BT) {
    const int err = tensor_map(&mb, p.w, p.wrows, p.wld, 64);
    if (err) return err;
  }
  int blocks = 0;
  int err = grid_blocks(p.units, &blocks);
  if (!err) err = set_smem<gconv_tc_kernel<T, X, BT, Epi>>(T::SMEM);
  if (err) return err;
  gconv_tc_kernel<T, X, BT, Epi><<<blocks, T::NT, T::SMEM, st>>>(p, e, mb);
  return (int)cudaGetLastError();
}

// Launches the grouped product p (3x3, stride 1; p.g, the pointers, cout,
// gw, xgs, wgr, wgc, wld and wrows the caller's, cout a multiple of gw) on the
// tile its group's width selects: 128 (not with consume_promoted) or 64
// columns with the weights by TMA where their rows are 16-byte runs, else
// 32, 16 or 8 columns whose weights the producers store. units: a block
// walks all column tiles of a pixel tile in a row (MixEpi).
template <class X, class Epi>
int launch_grouped(TcArgs p, const typename Epi::Args& e, int B, bool units,
                   cudaStream_t st) {
  const Geom& g = p.g;
  const bool aff_ok = p.a == nullptr || (pc::aligned(p.a, 16) &&
                                         pc::aligned(p.t, 16));
  p.vec = g.cin % 8 == 0 && g.C % 8 == 0 && (X::kDz || p.xgs % 8 == 0) &&
          pc::aligned(p.x, 16) && aff_ok &&
          (!X::kDz || pc::aligned(p.att, 16));
  if (X::kDz && !p.vec) return (int)cudaErrorInvalidValue;
  p.halo = p.vec;
  p.flat = p.vec && g.cin <= 64;
  p.nk = !p.vec || p.flat ? (g.K + 63) / 64 : 9 * ((g.cin + 63) / 64);
  p.vec_out = p.out != nullptr && p.cout % 8 == 0 &&
              pc::aligned(p.out, 16) &&
              (p.go == nullptr || pc::aligned(p.go, 16));
  const bool tma = p.wld % 8 == 0 && pc::aligned(p.w, 16);
  // consume_promoted holds a second fragment: 64 columns at most
  if constexpr (!Epi::kPromote) {
    if (tma && p.gw >= 128)
      return launch_g_tile<Tile<128>, X, true, Epi>(p, e, B, units, st);
  }
  if (tma && p.gw > 32)
    return launch_g_tile<Tile<64>, X, true, Epi>(p, e, B, units, st);
  if (p.gw > 16)
    return launch_g_tile<Tile<32>, X, false, Epi>(p, e, B, units, st);
  if (p.gw > 8)
    return launch_g_tile<Tile<16>, X, false, Epi>(p, e, B, units, st);
  return launch_g_tile<Tile<8>, X, false, Epi>(p, e, B, units, st);
}

// ---- The weight gradient on the tensor cores
// BM (128 rows of dW, k) x BN (64 or 128 columns) tiles, 64 pixels a slice:
// A is two 64-row boxes of k (one a consumer warpgroup), each 64 pixels of
// 128 bytes, and D BN / 64 boxes of 64 pixels, both in the 128-byte swizzle
// and read MN-major. The ring takes as many stages as fit, at most 8.
template <int BN_>
struct WTile {
  static constexpr int BM = 128, BN = BN_, BK = 64;
  static constexpr int NC = 256, PW = 8, NP = 32 * PW, NT = NC + NP;
  static constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SUM_BYTES = NP * 8 * 4;  // K5's bias: 8 a producer
  static constexpr int FIT = (227 * 1024 - 1024 - SUM_BYTES - 256) / STAGE;
  static constexpr int S = FIT < 8 ? FIT : 8;
  static constexpr int BAR = S * STAGE;
  static constexpr int SUM = BAR + 16 * S;
  static constexpr int SMEM = SUM + SUM_BYTES + 1024;
  // registers a consumer and a producer thread hold (setmaxnreg): the
  // consumers' accumulators are BN / 2 floats
  static constexpr int CREG = BN == 128 ? 104 : 80;
  static constexpr int PREG = 256 - CREG;
  static constexpr int XU = BM / 8 * BK / NP;  // A runs a producer stages
  static constexpr int DC = BN / 8;            // D runs a pixel
  static constexpr int DU = BK * DC / NP;      // D runs a producer stages
  static_assert(STAGE % 1024 == 0 && S >= 3 && SMEM <= 227 * 1024, "ring");
  static_assert(XU * NP * 8 == BM * BK && DU * NP == BK * DC, "staging");
};

struct WArgs {
  const bf16* x;      // (B, H, W, g.C) NHWC
  const bf16* a;      // (B, g.C) or null
  const bf16* t;
  const bf16* d;      // K6: (npix, N) the cotangent; K5: do (npix, N / 8)
  const float* att;   // K5: (npix, 8) A = att * attw; K6: null
  float* ws;          // (S, K + 1, N)
  Geom g;             // 3x3, stride 1; g.cin channels a group, g.K = 9 cin
  int N;              // columns of dW
  int gw;             // columns a group (K6: N)
  int npix;           // B * H * W
  int chunk;          // pixels a block, a multiple of 64
  int tnw, ntg, ntn;  // a column tile's width, tiles a group, column tiles
  int krows;          // rows of the product: K (K5), K + 1 (K6: the ones)
  int kd;             // rows of dW (the slabs hold kd + 1: the bias last)
  // K5 below 8 channels a group: msub-channel groups of mcols columns
  // merged into one of g.cin channels (block-diagonal), 0 where not
  int msub, mcols;
  bool vec;           // cin % 8 == 0, x, a, t 16-byte aligned
  bool tma;           // K6: D by TMA (N % 8 == 0, d 16-byte aligned)
};

struct WPos {
  int m0, g, n0, nend, cin0;
  int64_t q0, q1;
};

__device__ __forceinline__ WPos wtile_pos(const WArgs& w) {
  WPos q;
  const int mt = blockIdx.x / w.ntn, nt = blockIdx.x - mt * w.ntn;
  q.m0 = mt * 128;
  q.g = nt / w.ntg;
  q.n0 = q.g * w.gw + (nt - q.g * w.ntg) * w.tnw;
  q.nend = min(min(q.n0 + w.tnw, (q.g + 1) * w.gw), w.N);
  q.cin0 = q.g * w.g.cin;
  q.q0 = (int64_t)blockIdx.y * w.chunk;
  q.q1 = min(q.q0 + w.chunk, (int64_t)w.npix);
  return q;
}

// The pixels of a producer thread's A runs in a slice, rows pt / 16 + 16 i
// of it: their index in the batch and (image, y, x), advanced by 64 pixels
// a slice with additions.
template <class T>
struct WRows {
  int q[T::XU], b[T::XU], y[T::XU], x[T::XU];
};

template <class T>
__device__ __forceinline__ void wrows_init(WRows<T>& r, const WArgs& w,
                                           const WPos& q) {
  const int pt = threadIdx.x - T::NC;
  const int HW = w.g.H * w.g.W;
#pragma unroll
  for (int i = 0; i < T::XU; ++i) {
    r.q[i] = (int)q.q0 + (pt >> 4) + 16 * i;
    r.b[i] = r.q[i] / HW;
    const int rem = r.q[i] - r.b[i] * HW;
    r.y[i] = rem / w.g.W;
    r.x[i] = rem - r.y[i] * w.g.W;
  }
}

template <class T>
__device__ __forceinline__ void wrows_advance(WRows<T>& r, const WArgs& w) {
#pragma unroll
  for (int i = 0; i < T::XU; ++i) {
    r.q[i] += 64;
    r.x[i] += 64;
    while (r.x[i] >= w.g.W) {
      r.x[i] -= w.g.W;
      ++r.y[i];
    }
    while (r.y[i] >= w.g.H) {
      r.y[i] -= w.g.H;
      ++r.b[i];
    }
  }
}

// How A's runs are staged: WV16 (cin % 8 == 0 and aligned operands: a run
// is one 16-byte copy by cp.async), WSC (else) each value loaded into
// registers.
enum WMode { WV16, WSC };

// A producer thread's fixed run of A: k = m0 + 8 (pt % 16) .. + 7 of the
// group's rows of dW: WV16 one tap's 8 channels of one pixel; WSC each k's
// tap and channel (tap -1 past K).
struct WRun {
  int k, ci, dy, dx;
  bool kv;
  int one;  // K6's column of ones: the run's element K - k, else -1
  int tap[8], cj[8];
};

template <int MODE>
__device__ __forceinline__ void wrun_init(WRun& k, const WArgs& w, int k0) {
  k.k = k0;
  k.kv = k0 < w.g.K;
  const int tap = k.kv ? k0 / w.g.cin : 0;
  k.ci = k.kv ? k0 - tap * w.g.cin : 0;
  k.dy = tap / 3 - 1;
  k.dx = tap % 3 - 1;
  k.one = w.krows > w.g.K && k0 <= w.g.K && w.g.K < k0 + 8 ? w.g.K - k0
                                                             : -1;
  if constexpr (MODE == WV16) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int kj = k0 + j;
    k.tap[j] = kj < w.g.K ? kj / w.g.cin : -1;
    k.cj[j] = kj < w.g.K ? kj - k.tap[j] * w.g.cin : 0;
  }
}

// The fold's a and t of the thread's run for one image, loaded when the
// image changes (rarely within a chunk): vector staging 8 packed channels,
// scalar staging the 8 k's channels.
struct WFold {
  int img;
  uint4 sa, st;
};

// Sets element `one` of 8 packed bf16 to 1.
__device__ __forceinline__ void set_one(uint4& v, int one) {
  const uint32_t b = 0x3f80u << (16 * (one & 1));
  const int h = one >> 1;
  v.x |= h == 0 ? b : 0u;
  v.y |= h == 1 ? b : 0u;
  v.z |= h == 2 ? b : 0u;
  v.w |= h == 3 ? b : 0u;
}

// A 16-byte copy from global to shared memory that runs on while the thread
// goes on; full = false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Waits until at most N of this thread's groups of copies are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The staging of A by cp.async (WV16): each of a producer thread's XU runs
// of a slice copied straight into the stage (the border and the pixels past
// the chunk as zeros), WD slices ahead, so that no register waits for device
// memory; once a slice's copies have landed, the fold x * a + t is applied
// in place to the values inside the image (as K2's bf16 form stages 8
// channels), and K6's column of ones set.
template <class T>
__device__ __forceinline__ void wgrad_issue_x(const WArgs& w, const WPos& q,
                                              const WRun& k,
                                              const WRows<T>& r,
                                              uint8_t* as) {
  const Geom& g = w.g;
  const int pt = threadIdx.x - T::NC;
  const int c16 = pt & 15;
#pragma unroll
  for (int i = 0; i < T::XU; ++i) {
    uint8_t* dst = as + 8192 * (c16 >> 3) + swz((pt >> 4) + 16 * i, c16 & 7);
    const int y = r.y[i] + k.dy, xx = r.x[i] + k.dx;
    const bool in = k.kv && r.q[i] < q.q1 && (unsigned)y < (unsigned)g.H &&
                    (unsigned)xx < (unsigned)g.W;
    const bf16* src =
        in ? w.x + ((int64_t)(r.q[i] + k.dy * g.W + k.dx) * g.C + q.cin0 +
                    k.ci)
           : w.x;
    cp_async16(dst, src, in);
  }
  cp_async_commit();
}

// 16 bytes of shared memory at a shared-space address.
__device__ __forceinline__ uint4 lds16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts16(uint32_t a, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The fold of a slice's landed runs: every run read first, then folded, then
// written back, so that no read waits for the write before it.
template <class T>
__device__ __forceinline__ void wgrad_fold_x(const WArgs& w, const WPos& q,
                                             const WRun& k,
                                             const WRows<T>& r, WFold& f,
                                             uint4* fc, uint8_t* as) {
  const Geom& g = w.g;
  const int pt = threadIdx.x - T::NC;
  const int c16 = pt & 15;
  const uint32_t base = smem_addr(as) + 8192 * (c16 >> 3);
  const bool fold = w.a != nullptr && k.kv;
  // the fold's values: reloaded into the thread's slot in shared memory when
  // the image changes (held in registers across the loop, they were
  // reloaded from device memory at every use)
  if (fold && r.b[0] != f.img && r.q[0] < q.q1) {
    f.img = r.b[0];
    const bf16* ab = w.a + (int64_t)f.img * g.C + q.cin0;
    const bf16* tb = w.t + (int64_t)f.img * g.C + q.cin0;
    fc[0] = load16(ab + k.ci);
    fc[1] = load16(tb + k.ci);
  }
  uint4 v[T::XU];
  uint32_t live = 0u, in = 0u;
#pragma unroll
  for (int i = 0; i < T::XU; ++i) {
    v[i] = lds16(base + swz((pt >> 4) + 16 * i, c16 & 7));
    live |= (uint32_t)(r.q[i] < q.q1) << i;
    const int y = r.y[i] + k.dy, xx = r.x[i] + k.dx;
    in |= (uint32_t)((unsigned)y < (unsigned)g.H &&
                     (unsigned)xx < (unsigned)g.W) << i;
  }
  if (fold) {
    // an image boundary inside the slice takes its own fold values
    const uint4 sa = fc[0], st = fc[1];
#pragma unroll
    for (int i = 0; i < T::XU; ++i) {
      uint4 a = sa, t = st;
      if (((live >> i) & 1u) && r.b[i] != f.img) {
        const int64_t o = (int64_t)r.b[i] * g.C + q.cin0;
        a = load16(w.a + o + k.ci);
        t = load16(w.t + o + k.ci);
      }
      if ((live >> i) & (in >> i) & 1u) v[i] = stage8<pc::Affine>(v[i], a, t);
    }
  }
  if (k.one >= 0) {
#pragma unroll
    for (int i = 0; i < T::XU; ++i)
      if ((live >> i) & 1u) set_one(v[i], k.one);
  }
#pragma unroll
  for (int i = 0; i < T::XU; ++i)
    sts16(base + swz((pt >> 4) + 16 * i, c16 & 7), v[i]);
}

// The scalar staging of A (WSC): each of a run's 8 k loaded on its
// own into registers a slice ahead of its store; x.in's bit 8 i + j: value
// j of run i lies inside the image; x.img the run's image (-1 past the
// chunk).
template <class T>
struct WxSet {
  uint4 v[T::XU];
  int img[T::XU];
  uint32_t in;
};

template <class T>
__device__ __forceinline__ void wgrad_load_x(WxSet<T>& x, const WArgs& w,
                                             const WPos& q, const WRun& k,
                                             const WRows<T>& r) {
  const Geom& g = w.g;
  x.in = 0u;
#pragma unroll
  for (int i = 0; i < T::XU; ++i) x.img[i] = r.q[i] < q.q1 ? r.b[i] : -1;
  if (!k.kv) return;  // a run past K loads nothing (the same for the block)
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(w.x);
#pragma unroll
  for (int i = 0; i < T::XU; ++i) {
    uint32_t e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int dy = k.tap[j] / 3 - 1, dx = k.tap[j] % 3 - 1;
      const int y = r.y[i] + dy, xx = r.x[i] + dx;
      const bool in = x.img[i] >= 0 && k.tap[j] >= 0 &&
                      (unsigned)y < (unsigned)g.H &&
                      (unsigned)xx < (unsigned)g.W;
      e[j] = __ldg(in ? xs + ((int64_t)(r.q[i] + dy * g.W + dx) * g.C +
                              q.cin0 + k.cj[j])
                      : xs);
      x.in |= (uint32_t)in << (8 * i + j);
    }
    x.v[i] = make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16,
                        e[4] | e[5] << 16, e[6] | e[7] << 16);
  }
}

// each value on its own: x * a, then + t, each rounded (Affine::apply)
template <class T>
__device__ __forceinline__ void wgrad_store_x(const WxSet<T>& x,
                                              const WArgs& w, const WPos& q,
                                              const WRun& k, WFold& f,
                                              uint8_t* as) {
  using EB = Elem<bf16>;
  const int pt = threadIdx.x - T::NC;
  const int c16 = pt & 15;
#pragma unroll
  for (int i = 0; i < T::XU; ++i) {
    if (w.a != nullptr && x.img[i] >= 0 && x.img[i] != f.img) {
      f.img = x.img[i];
      const int64_t o = (int64_t)f.img * w.g.C + q.cin0;
      const unsigned short* as16 =
          reinterpret_cast<const unsigned short*>(w.a + o);
      const unsigned short* ts16 =
          reinterpret_cast<const unsigned short*>(w.t + o);
      uint32_t ea[8], et[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ea[j] = __ldg(as16 + k.cj[j]);
        et[j] = __ldg(ts16 + k.cj[j]);
      }
      f.sa = make_uint4(ea[0] | ea[1] << 16, ea[2] | ea[3] << 16,
                        ea[4] | ea[5] << 16, ea[6] | ea[7] << 16);
      f.st = make_uint4(et[0] | et[1] << 16, et[2] | et[3] << 16,
                        et[4] | et[5] << 16, et[6] | et[7] << 16);
    }
    const uint32_t xv[4] = {x.v[i].x, x.v[i].y, x.v[i].z, x.v[i].w};
    const uint32_t av[4] = {f.sa.x, f.sa.y, f.sa.z, f.sa.w};
    const uint32_t tv[4] = {f.st.x, f.st.y, f.st.z, f.st.w};
    uint32_t o[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float e[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * h + u;
        const float xj = u ? EB::hi(xv[h]) : EB::lo(xv[h]);
        e[u] = 0.f;
        if ((x.in >> (8 * i + j)) & 1u)
          e[u] = w.a == nullptr ? xj
                 : pc::Affine::apply<bf16>(
                       xj, u ? EB::hi(av[h]) : EB::lo(av[h]),
                       u ? EB::hi(tv[h]) : EB::lo(tv[h]));
      }
      o[h] = __float_as_uint(EB::pack2(e[0], e[1]));
    }
    uint4 v = make_uint4(o[0], o[1], o[2], o[3]);
    if (k.one >= 0 && x.img[i] >= 0) set_one(v, k.one);
    *reinterpret_cast<uint4*>(as + 8192 * (c16 >> 3) +
                              swz((pt >> 4) + 16 * i, c16 & 7)) = v;
  }
}

// D's runs of a slice that the producers stage (without TMA), loaded before
// the slice's stage is acquired and stored after A: run pt % DC (8
// columns) of the pixels of rows pt / DC + NP / DC * i. K6 (DZ false): the
// cotangent's values as they are; K5 (DZ): do and the pixel's A.
template <class T, bool DZ>
struct WdSet {
  uint4 raw[T::DU];
};

template <class T>
struct WdSet<T, true> {
  float d[T::DU];
  float4 lo[T::DU], hi[T::DU];
};

template <class T, bool DZ>
__device__ __forceinline__ void wgrad_load_d(WdSet<T, DZ>& ds,
                                             const WArgs& w, const WPos& q,
                                             int s) {
  using EB = Elem<bf16>;
  const int pt = threadIdx.x - T::NC;
  const int n = q.n0 + 8 * (pt % T::DC);
  const bool nv = n < q.nend;
#pragma unroll
  for (int i = 0; i < T::DU; ++i) {
    const int64_t pq =
        q.q0 + 64 * (int64_t)s + pt / T::DC + T::NP / T::DC * i;
    const bool live = nv && pq < q.q1;
    if constexpr (DZ) {
      ds.d[i] = live ? EB::ldg(w.d + pq * (w.N / 8) + (n >> 3)) : 0.f;
      const float4* ap =
          reinterpret_cast<const float4*>(live ? w.att + pq * 8 : w.att);
      ds.lo[i] = __ldg(ap);
      ds.hi[i] = __ldg(ap + 1);
    } else {
      uint32_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = live && n + j < q.nend
                   ? __ldg(reinterpret_cast<const unsigned short*>(w.d) +
                           pq * w.N + n + j)
                   : 0u;
      ds.raw[i] = make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16,
                             e[4] | e[5] << 16, e[6] | e[7] << 16);
    }
  }
}

// K5: dz = do * A, rounded where it enters the product, its unrounded
// values added into bsum for the bias.
template <class T, bool DZ>
__device__ __forceinline__ void wgrad_store_d(const WdSet<T, DZ>& ds,
                                              uint8_t* bs, float (&bsum)[8]) {
  using EB = Elem<bf16>;
  const int pt = threadIdx.x - T::NC;
  const int dc = pt % T::DC;
#pragma unroll
  for (int i = 0; i < T::DU; ++i) {
    uint4 u;
    if constexpr (DZ) {
      const float d = ds.d[i];
      const float z[8] = {d * ds.lo[i].x, d * ds.lo[i].y, d * ds.lo[i].z,
                          d * ds.lo[i].w, d * ds.hi[i].x, d * ds.hi[i].y,
                          d * ds.hi[i].z, d * ds.hi[i].w};
#pragma unroll
      for (int j = 0; j < 8; ++j) bsum[j] += z[j];
      u = make_uint4(__float_as_uint(EB::pack2(z[0], z[1])),
                     __float_as_uint(EB::pack2(z[2], z[3])),
                     __float_as_uint(EB::pack2(z[4], z[5])),
                     __float_as_uint(EB::pack2(z[6], z[7])));
    } else {
      u = ds.raw[i];
    }
    *reinterpret_cast<uint4*>(bs + 8192 * (dc >> 3) +
                              swz(pt / T::DC + T::NP / T::DC * i, dc & 7)) =
        u;
  }
}

// One slice s of the scalar staging's producers: the next slice's A loads
// into nxt, D's loads, the stage, then A from cur and D into it.
template <class T, bool DZ>
__device__ __forceinline__ void wgrad_slice(
    const WArgs& w, const WPos& q, const CUtensorMap* mb, const Ring<T>& ring,
    int nk, int s, const WRun& k, WRows<T>& r, WxSet<T>& cur, WxSet<T>& nxt,
    WFold& f, float (&bsum)[8]) {
  const int pt = threadIdx.x - T::NC;
  if (s + 1 < nk) {
    wrows_advance<T>(r, w);
    wgrad_load_x<T>(nxt, w, q, k, r);
  }
  WdSet<T, DZ> ds;
  const bool tma = !DZ && w.tma;
  if (!tma) wgrad_load_d<T, DZ>(ds, w, q, s);
  ring.acquire(s);
  if (tma && pt == 0) {
    ring.expect(s, T::B_BYTES);
    ring.load_w(mb, s, (int)(q.q0 + 64 * (int64_t)s), q.n0);
  }
  wgrad_store_x<T>(cur, w, q, k, f, ring.a(s));
  if (!tma) wgrad_store_d<T, DZ>(ds, ring.b(s), bsum);
  ring.hand_over(s);
}

// K5's bias: the producers' sums, added in ascending row order per column
// into row K of the chunk's slab.
template <class T>
__device__ __forceinline__ void wgrad_bias(const WArgs& w, const WPos& q,
                                           const float (&bsum)[8],
                                           float* sums) {
  const int pt = threadIdx.x - T::NC;
#pragma unroll
  for (int j = 0; j < 8; ++j) sums[pt * 8 + j] = bsum[j];
  producer_sync<T::NP>();
  const int nv = q.nend - q.n0;
  for (int c = pt; c < nv; c += T::NP) {
    float v = 0.f;
    for (int rr = c / 8; rr < T::NP; rr += T::DC) v += sums[rr * 8 + c % 8];
    w.ws[((int64_t)blockIdx.y * (w.kd + 1) + w.kd) * w.N + q.n0 + c] = v;
  }
}

// The producers: slice s of the block's chunk takes stage s % S. WV16:
// A's runs by cp.async WD slices ahead (the stage of slice s + WD
// acquired first), D (K5: rebuilt; K6: by TMA, or loaded where it is no
// plain matrix) loaded before the wait for slice s's copies, the fold
// applied in place, D stored, the stage handed over. WSC: A's runs loaded
// into registers a slice ahead of their store (two register sets in turn,
// each named in the code: an array indexed by s would live in local
// memory, and each load would wait as it is stored there).
template <class T, bool DZ, int MODE>
__device__ __forceinline__ void wgrad_produce_tc(const WArgs& w,
                                                 const WPos& q,
                                                 const CUtensorMap* mb,
                                                 const Ring<T>& ring, int nk,
                                                 float* sums) {
  const int pt = threadIdx.x - T::NC;
  const bool tma = !DZ && w.tma;
  WRun k;
  wrun_init<MODE>(k, w, q.m0 + 8 * (pt & 15));
  float bsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  WRows<T> r;
  wrows_init<T>(r, w, q);
  WFold f;
  f.img = -1;
  f.sa = f.st = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (MODE != WSC) {
    // slices whose copies are in flight: acquiring slice s + WD waits for
    // the consumers to release slice s + WD - S, so WD near S would chain
    // each slice's copies to the product of the one before it
    constexpr int WD = T::S / 2 - 1;
    static_assert(WD >= 2, "the ring holds them");
    WRows<T> ri = r;       // the issue cursor, WD slices ahead of r
    // the thread's fold values (a, t) in the bias sums' room, which K5
    // takes only after the loop
    uint4* fc = reinterpret_cast<uint4*>(sums) + 2 * pt;
    auto issue = [&](int s) {
      ring.acquire(s);
      if (tma && pt == 0) {
        ring.expect(s, T::B_BYTES);
        ring.load_w(mb, s, (int)(q.q0 + 64 * (int64_t)s), q.n0);
      }
      wgrad_issue_x<T>(w, q, k, ri, ring.a(s));
      wrows_advance<T>(ri, w);
    };
    for (int s = 0; s < WD && s < nk; ++s) issue(s);
    const bool touch = k.one >= 0 || (w.a != nullptr && k.kv);
    // D's loads a slice ahead of their store, two register sets in turn
    auto slice = [&](int s, WdSet<T, DZ>& cur, WdSet<T, DZ>& nxt) {
      if (!tma && s + 1 < nk) wgrad_load_d<T, DZ>(nxt, w, q, s + 1);
      if (s + WD < nk)
        issue(s + WD);
      else
        cp_async_commit();  // an empty group: the count below stays WD
      cp_async_wait<WD>();
      if (touch) wgrad_fold_x<T>(w, q, k, r, f, fc, ring.a(s));
      if (!tma) wgrad_store_d<T, DZ>(cur, ring.b(s), bsum);
      ring.hand_over(s);
      wrows_advance<T>(r, w);
    };
    WdSet<T, DZ> da, db;
    if (!tma) wgrad_load_d<T, DZ>(da, w, q, 0);
    for (int s = 0; s < nk; s += 2) {
      slice(s, da, db);
      if (s + 1 < nk) slice(s + 1, db, da);
    }
  } else {
    WxSet<T> xa, xb;
    wgrad_load_x<T>(xa, w, q, k, r);
    for (int s = 0; s < nk; s += 2) {
      wgrad_slice<T, DZ>(w, q, mb, ring, nk, s, k, r, xa, xb, f, bsum);
      if (s + 1 < nk)
        wgrad_slice<T, DZ>(w, q, mb, ring, nk, s + 1, k, r, xb, xa, f, bsum);
    }
  }
  if (DZ && q.m0 == 0) wgrad_bias<T>(w, q, bsum, sums);
}

// One block: the partial tile of rows m0 .., columns n0 .. of chunk
// blockIdx.y, stored plainly into the chunk's (K + 1, N) slab of ws.
template <class T, bool DZ, int MODE>
__global__ void __launch_bounds__(T::NT, 1)
    wgrad_tc_kernel(const WArgs w, const __grid_constant__ CUtensorMap mb) {
  extern __shared__ uint8_t smem_raw[];
  const Ring<T> ring(smem_raw);
  float* sums = reinterpret_cast<float*>(ring.base + T::SUM);
  const WPos q = wtile_pos(w);
  const int nk = (int)((q.q1 - q.q0 + 63) / 64);
  if (threadIdx.x == 0) ring.init(T::PW + (w.tma ? 1 : 0));
  __syncthreads();
  if (threadIdx.x >= T::NC) {
    setmaxnreg_inc<T::PREG>();
    wgrad_produce_tc<T, DZ, MODE>(w, q, &mb, ring, nk, sums);
    return;
  }
  setmaxnreg_dec<T::CREG>();
  float acc[T::BN / 2];
  consume<T, true, 1>(acc, ring, 0, nk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ka = q.m0 + 16 * warp + (lane >> 2);  // warp w: rows 16 w ..
  float* slab = w.ws + (int64_t)blockIdx.y * (w.kd + 1) * w.N;
  const bool pairs = w.N % 2 == 0;
#pragma unroll
  for (int j = 0; j < T::BN / 8; ++j) {
    const int n = q.n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int k = ka + 8 * r;
      if (k >= w.krows) continue;
      if (w.msub) {  // merged groups: the diagonal blocks, as group rows
        const int tap = k / w.g.cin, cm = k - tap * w.g.cin;
        if (cm / w.msub != (n - q.g * w.gw) / w.mcols) continue;
        k = tap * w.msub + cm % w.msub;
      }
      float* o = slab + (int64_t)k * w.N + n;
      const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
      if (pairs && n + 1 < q.nend) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (n < q.nend) o[0] = v0;
        if (n + 1 < q.nend) o[1] = v1;
      }
    }
  }
}

// wgrad_reduce_kernel's instance of the tensor-core weight gradient
struct WgradTc {};

// dW (kd, N) and dbias (N) of w (x .. npix, krows, kd and the columns of a
// group the caller's) into the caller's (splits, kd + 1, N) workspace, then
// reduced in a fixed order, on BN-column tiles and the staging MODE.
template <int BN, bool DZ, int MODE>
int launch_wgrad_tile(WArgs w, int splits, bf16* dw, bf16* dbias,
                      cudaStream_t st) {
  using T = WTile<BN>;
  w.tnw = min(BN, w.gw);
  w.ntg = (w.gw + w.tnw - 1) / w.tnw;
  w.ntn = w.N / w.gw * w.ntg;
  const int mtiles = (w.krows + T::BM - 1) / T::BM;
  const int chunk = (int)(((int64_t)w.npix + splits - 1) / splits);
  w.chunk = (chunk + 63) / 64 * 64;
  const int used = (int)(((int64_t)w.npix + w.chunk - 1) / w.chunk);
  CUtensorMap mb = {};
  if (w.tma) {
    const int err = tensor_map(&mb, w.d, w.npix, w.N, 64);
    if (err) return err;
  }
  int err = set_smem<wgrad_tc_kernel<T, DZ, MODE>>(T::SMEM);
  if (err) return err;
  wgrad_tc_kernel<T, DZ, MODE>
      <<<dim3(mtiles * w.ntn, used), T::NT, T::SMEM, st>>>(w, mb);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int64_t n = (int64_t)(w.kd + 1) * w.N;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  pc::wgrad_reduce_kernel<WgradTc, bf16><<<blocks, 256, 0, st>>>(
      w.ws, dw, dbias, w.kd, w.N, used);
  return (int)cudaGetLastError();
}

// The launch on the staging that cin and the operands' alignment allow.
template <int BN, bool DZ>
int launch_wgrad_mode(const WArgs& w, int splits, bf16* dw, bf16* dbias,
                      cudaStream_t st) {
  if (w.vec) return launch_wgrad_tile<BN, DZ, WV16>(w, splits, dw, dbias, st);
  return launch_wgrad_tile<BN, DZ, WSC>(w, splits, dw, dbias, st);
}

// DZ: K5's D, rebuilt from do (w.d) and A (w.att); else K6's cotangent.
template <bool DZ>
int launch_wgrad_tc(WArgs w, int splits, bf16* dw, bf16* dbias,
                    cudaStream_t st) {
  const bool aff_ok = w.a == nullptr || (pc::aligned(w.a, 16) &&
                                         pc::aligned(w.t, 16));
  w.vec = w.g.cin % 8 == 0 && w.g.C % 8 == 0 && pc::aligned(w.x, 16) &&
          aff_ok;
  w.tma = !DZ && w.N % 8 == 0 && pc::aligned(w.d, 16);
  if (DZ && !pc::aligned(w.att, 16)) return (int)cudaErrorInvalidValue;
  if constexpr (DZ) {  // K5's D is loaded a slice ahead: 64 columns
    return launch_wgrad_mode<64, DZ>(w, splits, dw, dbias, st);
  } else {
    if (w.gw >= 128)
      return launch_wgrad_mode<128, DZ>(w, splits, dw, dbias, st);
    return launch_wgrad_mode<64, DZ>(w, splits, dw, dbias, st);
  }
}

}  // namespace tc
}  // namespace ucdir
