// What holds back the bf16 forward convolutions on the tensor cores
// (ucdir_tpu_torch/csrc/igemm_tc.cuh), measured apart from the port, at
// the validation shapes of chip_smoke.py's phase 2. Per case, the time of
//   full     the kernel as it ships (tc::launch_conv: the staging of A, the
//            weights by TMA or by the producers, wgmma, the epilogue and the
//            statistics' reduction);
//   product  the same consumers (wgmma on the ring, the epilogue), fed by
//            producers that bring only the weights and hand each stage over:
//            A is whatever the ring holds;
//   staging  the same producers (halo, per-tap copies or loads, weights),
//            drained by consumers that release each stage as it arrives;
// and the bound, the counted FLOP at 989 TFLOP/s (dense bf16). full against
// product and staging says which of the two sides bounds the kernel and how
// far they overlap. The two sides are the kernel's own produce and consume
// (with its epilogue), on its ring (tc::Ring).
//
// From the root of the checkout (ucdir_tpu_torch/_build/ is where the
// package builds its kernels too, and git ignores it):
//
//   mkdir -p ucdir_tpu_torch/_build && \
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -I ucdir_tpu_torch/csrc -o ucdir_tpu_torch/_build/torch_tc_bench \
//        tools/torch_tc_bench.cu && ucdir_tpu_torch/_build/torch_tc_bench
//
// Prints the card, then one line per case. Needs an sm_90a card.
#include <cstdio>

#include "igemm_tc.cuh"

namespace tc = ucdir::tc;
namespace pc = ucdir::pc;
using ucdir::bf16;

enum Side { PRODUCT, STAGING };

// conv_tc_kernel with one side replaced: PRODUCT keeps the consumers and
// gives them producers that only bring the weights (by TMA where BT, else
// nothing) and hand each stage over; STAGING keeps the producers and gives
// them consumers that release each stage as soon as it is full.
template <class T, class X, bool BT, Side SIDE>
__global__ void __launch_bounds__(T::NT, 1)
    side_kernel(const tc::TcArgs p, const __grid_constant__ CUtensorMap ma,
                const __grid_constant__ CUtensorMap mb) {
  extern __shared__ uint8_t smem_raw[];
  const tc::Ring<T> ring(smem_raw);
  float* red = reinterpret_cast<float*>(ring.base + T::RED);
  uint8_t* epi = ring.base + T::EPI;
  const int total = p.tiles;
  if (threadIdx.x == 0) ring.init(T::PW + (BT ? 1 : 0));
  __syncthreads();
  if (threadIdx.x >= T::NC) {
    if constexpr (T::PREG != 128) tc::setmaxnreg_inc<T::PREG>();
    if constexpr (SIDE == STAGING) {
      tc::produce<T, X, BT, false, false>(p, &ma, &mb, ring);
      return;
    }
    const int pt = threadIdx.x - T::NC;
    int s = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const tc::TilePos q = tc::tile_pos<false>(p, t);
      for (int c = 0; c < p.nk; ++c, ++s) {
        ring.acquire(s);
        if (BT && pt == 0) {
          ring.expect(s, T::B_BYTES);
          ring.load_w(&mb, s, 64 * c, q.n0);
        }
        ring.hand_over(s);
      }
    }
    return;
  }
  if constexpr (T::CREG != 128) tc::setmaxnreg_dec<T::CREG>();
  int s = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x, s += p.nk) {
    if constexpr (SIDE == PRODUCT) {
      float acc[T::BN / 2];
      tc::consume<T, BT>(acc, ring, s, p.nk);
      tc::epilogue<T>(acc, p, red, epi, tc::tile_pos<false>(p, t));
    } else {
      for (int c = 0; c < p.nk; ++c) {
        ring.wait_full(s + c);
        ring.release(s + c);
      }
    }
  }
}

template <class T, class X, bool BT, Side SIDE>
float time_tile(tc::TcArgs c, int B, int reps) {
  CUtensorMap ma, mb;
  int blocks = 0;
  if (tc::tile_grid<T, BT, false>(c, B, &ma, &mb) ||
      tc::grid_blocks(c.tiles, &blocks) ||
      tc::set_smem<side_kernel<T, X, BT, SIDE>>(T::SMEM))
    return -1.f;
  auto run = [&] {
    side_kernel<T, X, BT, SIDE><<<blocks, T::NT, T::SMEM>>>(c, ma, mb);
  };
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  run();
  cudaEventRecord(a);
  for (int i = 0; i < reps; ++i) run();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return cudaGetLastError() == cudaSuccess ? ms / reps : -1.f;
}

template <class X, Side SIDE>
float time_side(tc::TcArgs c, int B, int reps) {
  const tc::Route r = tc::plan(c, B, !X::kAffine);
  if (r.bn == 8) return time_tile<tc::Tile<8>, X, false, SIDE>(c, B, reps);
  if (r.bn == 128)
    return time_tile<tc::Tile<128>, X, true, SIDE>(c, B, reps);
  return time_tile<tc::Tile<64>, X, true, SIDE>(c, B, reps);
}

template <class X>
float time_full(const tc::TcArgs& c, float* ssum, float* ssq, int B,
                int reps) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  int err = tc::launch_conv<X>(c, ssum, ssq, B, 0, tc::TC_CONV3X3);
  cudaEventRecord(a);
  for (int i = 0; i < reps && !err; ++i)
    err = tc::launch_conv<X>(c, ssum, ssq, B, 0, tc::TC_CONV3X3);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return err ? -1.f : ms / reps;
}

// bf16 values of about `scale` around `off`, from a hash of the index.
__global__ void fill(bf16* p, int64_t n, float scale, float off,
                     uint32_t seed) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t h = (uint32_t)i * 2654435761u ^ seed;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    const float u = (h & 0xffffff) / 16777216.f - 0.5f;
    p[i] = __float2bfloat16_rn(off + 2.f * scale * u);
  }
}

bf16* random(int64_t n, float scale, float off, uint32_t seed) {
  bf16* p = nullptr;
  cudaMalloc(&p, n * sizeof(bf16));
  fill<<<1024, 256>>>(p, n, scale, off, seed);
  return p;
}

struct Case {
  const char* label;
  int H, W, cin, cout, stride;
  bool fold, swish, stats, preact;
};

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "torch_tc_bench: no CUDA card\n");
    return 2;
  }
  printf("%s, %d SMs; ms per call, mean of 10 after one\n", prop.name,
         prop.multiProcessorCount);
  const Case cases[] = {
      {"K2 downs_0 6->64 1568x2272 stats", 1568, 2272, 6, 64, 1, false,
       false, true, false},
      {"K2 conv1 192->64 1568x2272 fold+swish+stats", 1568, 2272, 192, 64, 1,
       true, true, true, false},
      {"K2 downsample 64->64 stride 2 1568x2272 stats", 1568, 2272, 64, 64, 2,
       false, false, true, false},
      {"K2 upsample 128->4x128 packed 784x1136 stats", 784, 1136, 128, 512, 1,
       false, false, true, false},
      {"K2 final 64->3 1568x2272 stats", 1568, 2272, 64, 3, 1, false, false,
       true, false},
      {"K2 conv1 1024->512 196x284 fold+swish+stats", 196, 284, 1024, 512, 1,
       true, true, true, false},
      {"K7 head 64->3 1568x2272 fold", 1568, 2272, 64, 3, 1, true, false,
       false, true},
  };
  for (const Case& k : cases) {
    const int Ho = (k.H - 1) / k.stride + 1, Wo = (k.W - 1) / k.stride + 1;
    const int64_t npix = (int64_t)k.H * k.W, nout = (int64_t)Ho * Wo;
    tc::TcArgs c = {};
    c.x = random(npix * k.cin, 0.5f, 0.f, 1);
    c.w = random(9LL * k.cin * k.cout, 1.f / sqrtf(9.f * k.cin), 0.f, 2);
    c.bias = random(k.cout, 0.1f, 0.f, 3);
    c.a = k.fold ? random(k.cin, 0.2f, 1.f, 4) : nullptr;
    c.t = k.fold ? random(k.cin, 0.2f, 0.f, 5) : nullptr;
    bf16* out = nullptr;
    cudaMalloc(&out, nout * k.cout * sizeof(bf16));
    c.out = out;
    float *ssum = nullptr, *ssq = nullptr, *ws = nullptr;
    if (k.stats) {
      cudaMalloc(&ssum, k.cout * sizeof(float));
      cudaMalloc(&ssq, k.cout * sizeof(float));
      const int64_t tiles = (int64_t)((Ho + 7) / 8) * ((Wo + 15) / 16);
      cudaMalloc(&ws, 2 * k.cout * tiles * sizeof(float));
    }
    c.ws = ws;
    c.g.H = k.H;
    c.g.W = k.W;
    c.g.C = k.cin;
    c.g.Ho = Ho;
    c.g.Wo = Wo;
    c.g.ks = 3;
    c.g.stride = k.stride;
    c.g.cin = k.cin;
    c.g.K = 9 * k.cin;
    c.cout = k.cout;
    c.act = k.swish;
    const int reps = 10;
    float full, product, staging;
    if (k.preact) {
      full = time_full<pc::Preact>(c, ssum, ssq, 1, reps);
      product = time_side<pc::Preact, PRODUCT>(c, 1, reps);
      staging = time_side<pc::Preact, STAGING>(c, 1, reps);
    } else {
      full = time_full<pc::Affine>(c, ssum, ssq, 1, reps);
      product = time_side<pc::Affine, PRODUCT>(c, 1, reps);
      staging = time_side<pc::Affine, STAGING>(c, 1, reps);
    }
    const double bound = 2.0 * 9 * k.cin * k.cout * nout / 989e9;
    printf("%-48s full %.3f  product %.3f  staging %.3f  bound %.3f (FLOP at "
           "989 TFLOP/s)  %s\n",
           k.label, full, product, staging, bound,
           cudaGetErrorString(cudaDeviceSynchronize()));
    cudaFree((void*)c.x);
    cudaFree((void*)c.w);
    cudaFree((void*)c.bias);
    cudaFree((void*)c.a);
    cudaFree((void*)c.t);
    cudaFree(out);
    cudaFree(ssum);
    cudaFree(ssq);
    cudaFree(ws);
  }
  return 0;
}
