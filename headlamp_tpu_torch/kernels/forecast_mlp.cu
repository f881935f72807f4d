// Fused forecaster inference for Hopper (sm_90a):
//   out = sigmoid(gelu_tanh(gelu_tanh(x·W1 + b1)·W2 + b2)·W3 + b3)
//
// Replaces the Pallas TPU kernel headlamp_tpu/models/pallas_forward.py
// (_forward_kernel, :43-69, launched by _padded_forward through
// pl.pallas_call at :155). It computes the same function with the same
// numerics: every matmul operand is rounded to bf16 (round to nearest
// even), products and sums are f32, the bias is added in f32, GELU is the
// tanh form in f32 (jax.nn.gelu's default, tanhf without fast math), each
// hidden activation is rounded to bf16 again as the next layer's operand,
// and the output is an f32 sigmoid. Only the order of the sums inside the
// tensor core differs from the plain version.
//
// What bounds it: at the forecaster's widths (32 -> 128 -> 128 -> 8) a
// row costs 43,008 FLOP and 160 bytes of x and out, so even 16k rows are
// about 0.7 GFLOP and 2.6 MB: under a microsecond of tensor-core or HBM
// time on an H100. What is left is latency, and one tile's path sets the
// time at every batch up to 16k rows: the launch (an empty launch of this
// block costs as much as a one-element add, about 5 us), the 2 x 8192
// accurate tanhf of a tile's GELUs (about 2.6 us, issue-bound: each
// thread of the tile's warpgroup runs 128 of them), the bulk copies' latency, the
// bf16 conversion of the weights (about 0.7 us) and three dependent wgmma
// chains (chip_ablation.py at the repo root measures each part on the
// card). The
// design attacks what it can:
//
// - Tensor cores. Each layer is a chain of wgmma.mma_async (m64n128k16,
//   or m64n8k16 for the 8-wide last layer) on bf16 with f32 accumulation,
//   so no thread spends instructions on the products. A comes from
//   registers: the f32 accumulator layout of an m64nN wgmma gives each
//   thread, for n-blocks 2s and 2s+1, exactly the elements of the k16 A
//   fragment of k-slice s, so bias + GELU + bf16 rounding on the
//   accumulators yields the next layer's A operand with no shuffle and no
//   shared-memory round trip. Activations never leave registers.
// - Bulk asynchronous copies. One thread issues, at the start, one
//   cp.async.bulk per weight and bias tensor into f32 staging in shared
//   memory, with one mbarrier per layer. Layer 1's weights are converted
//   to bf16 (in the no-swizzle K-major core-matrix layout that wgmma's B
//   descriptor reads) as soon as they land, and the first tile's layer 1
//   runs while W2 is still in flight; then W2 is converted, and so on.
// - Persistent tiles. The grid is min(tiles, SMs); a block of two
//   warpgroups stages the weights once and each warpgroup walks its own
//   64-row tiles (64 is wgmma's M) grid-stride. A warpgroup reads its x
//   tile into registers (layer 1's A fragments) and at once issues the
//   bulk copy of its next tile into the same buffer, so the copy overlaps
//   the current tile's three layers: the registers are the second buffer.
//   Two warpgroups share one copy of the weights, so at 16k rows (256
//   tiles on 132 SMs) no block walks two tiles in turn; at small batches
//   the second is idle but helps convert the weights.
//
// The main path's widths (W, H, Z) = (32, 128, 8) and anything narrower
// run the instantiation <32, 128, 8>; wider widths (each <= 128) run
// <128, 128, 128>. Both pad K to the instantiation's and zero-fill the
// padding in shared memory during conversion. Bulk copies move whole
// 16-byte groups: an array or tile whose byte size is not a multiple of 16
// has its last few elements read with plain loads. The wide
// instantiation's f32 weights do not fit shared memory at once, so it
// stages them one after another through one slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                         // rows per tile: wgmma's M
constexpr int kWarpgroups = 2;                    // tiles in flight per block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kMaxDim = 128;                      // the single-tile guard
constexpr int kMaxDevices = 64;
constexpr int kLayers = 3;

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k_sqrt_2_over_pi = 0.7978845608028654f;
  const float inner = k_sqrt_2_over_pi * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and bulk copies ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global
// to shared memory; the copy completes its bytes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (bulk copies, wgmma operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset (between the two 8-element core matrices along K) and
// stride byte offset (between 8-row core-matrix groups along N), each in
// 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  return d;  // base offset 0, layout type 0 (no swizzle)
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define HL_D8(i) "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
                 "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d[64] (+)= A (registers, 64x16 bf16) x B (shared, 16x128 bf16, K-major).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : HL_D8(0), HL_D8(8), HL_D8(16), HL_D8(24),
        HL_D8(32), HL_D8(40), HL_D8(48), HL_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[4] (+)= A (registers, 64x16 bf16) x B (shared, 16x8 bf16, K-major).
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#undef HL_D8

template <int N>
__device__ __forceinline__ void wgmma_step(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  static_assert(N == 128 || N == 8, "wgmma widths used here");
  if constexpr (N == 128) {
    wgmma_n128(d, a, desc_b, scale_d);
  } else {
    wgmma_n8(d, a, desc_b, scale_d);
  }
}

// One layer's product for the warpgroup's 64-row tile: acc = A x B, A as
// KP/16 register fragments, B the layer's bf16 weights in shared memory
// (core matrix (n-group g, k-chunk c) at (g * KP/8 + c) * 128 bytes).
template <int KP, int NP>
__device__ __forceinline__ void layer_product(float (&acc)[NP / 2],
                                              const uint32_t (&a)[KP / 16][4],
                                              const __nv_bfloat16* wb) {
  const uint64_t desc = make_desc(wb, 128, (KP / 8) * 128);
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KP / 16; ++s) {
    // k-slice s starts two core matrices (256 bytes) further along K.
    wgmma_step<NP>(acc, a[s], desc + static_cast<uint64_t>(s * 16), s > 0 ? 1 : 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(acc);
}

// Bias + GELU + bf16 on a hidden layer's accumulators, in the register
// layout of the next layer's A fragments: thread (lane l, g = l/4,
// t = l%4) holds for n-block j the columns 8j+2t, 8j+2t+1 of rows g and
// g+8, which are fragment k-slice j/2's elements.
template <int NP>
__device__ __forceinline__ void hidden_epilogue(const float (&acc)[NP / 2], const float* bias,
                                                uint32_t (&a)[NP / 16][4], int tig) {
#pragma unroll
  for (int s = 0; s < NP / 16; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 2 * s + (i >> 1);
      const int q = (i & 1) * 2;
      const int col = 8 * j + 2 * tig;
      a[s][i] = pack_bf16(gelu_tanh(acc[4 * j + q] + bias[col]),
                          gelu_tanh(acc[4 * j + q + 1] + bias[col + 1]));
    }
  }
}

struct Args {
  const float* x;
  const float* w[kLayers];
  const float* b[kLayers];
  float* out;
  int B, W, H, Z;
};

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// Shared-memory plan of one instantiation: padded widths K1 (window), NH
// (hidden) and N3 (horizon). Byte offsets, each a multiple of 128.
template <int K1, int NH, int N3>
struct Plan {
  __host__ __device__ static constexpr int kp(int l) { return l == 0 ? K1 : NH; }
  __host__ __device__ static constexpr int np(int l) { return l == 2 ? N3 : NH; }
  __host__ __device__ static constexpr size_t f32_bytes(int l) { return size_t(kp(l)) * np(l) * 4; }
  __host__ __device__ static constexpr size_t bf16_bytes(int l) { return size_t(kp(l)) * np(l) * 2; }
  static constexpr size_t kSmemLimit = 232448;  // an H100 block's maximum

  static constexpr size_t kBars = 0;  // kLayers weight barriers, then kWarpgroups x barriers
  __host__ __device__ static constexpr size_t bias_off(int l) {
    return 128 + (l > 0 ? round128(np(0) * 4) : 0) + (l > 1 ? round128(np(1) * 4) : 0);
  }
  static constexpr size_t kWb = bias_off(2) + round128(np(2) * 4);
  __host__ __device__ static constexpr size_t wb_off(int l) {
    return kWb + (l > 0 ? bf16_bytes(0) : 0) + (l > 1 ? bf16_bytes(1) : 0);
  }
  static constexpr size_t kX = wb_off(2) + round128(bf16_bytes(2));
  static constexpr size_t kXTile = size_t(kRows) * K1 * 4;
  static constexpr size_t kWf = kX + kWarpgroups * kXTile;
  static constexpr size_t kAllBytes = kWf + f32_bytes(0) + f32_bytes(1) + f32_bytes(2);
  // Stage all three f32 weights at once where they fit, else one at a
  // time through one slot sized for the largest.
  static constexpr bool kStageAll = kAllBytes <= kSmemLimit;
  __host__ __device__ static constexpr size_t wf_off(int l) {
    return kStageAll ? kWf + (l > 0 ? f32_bytes(0) : 0) + (l > 1 ? f32_bytes(1) : 0) : kWf;
  }
  static constexpr size_t kSlotBytes =
      f32_bytes(0) > f32_bytes(1) ? (f32_bytes(0) > f32_bytes(2) ? f32_bytes(0) : f32_bytes(2))
                                  : (f32_bytes(1) > f32_bytes(2) ? f32_bytes(1) : f32_bytes(2));
  static constexpr size_t kBytes = kStageAll ? kAllBytes : kWf + kSlotBytes;
  static_assert(kBytes <= kSmemLimit, "shared-memory plan exceeds a block's maximum");
};

__device__ __forceinline__ int layer_k(const Args& a, int l) { return l == 0 ? a.W : a.H; }
__device__ __forceinline__ int layer_n(const Args& a, int l) { return l == 2 ? a.Z : a.H; }

// Issue layer L's weight and bias copies (their 16-byte-aligned parts).
template <class P, int L>
__device__ void issue_weights(const Args& a, unsigned char* smem) {
  const uint32_t bar = smem_addr(smem + P::kBars + 8 * L);
  const int K = layer_k(a, L), N = layer_n(a, L);
  const uint32_t w_bytes = static_cast<uint32_t>(K * N * 4) & ~15u;
  const uint32_t b_bytes = static_cast<uint32_t>(N * 4) & ~15u;
  mbar_expect_tx(bar, w_bytes + b_bytes);
  if (w_bytes) bulk_copy(smem + P::wf_off(L), a.w[L], w_bytes, bar);
  if (b_bytes) bulk_copy(smem + P::bias_off(L), a.b[L], b_bytes, bar);
}

// Wait for layer L's copies, then (whole block) write its bf16 weights in
// wgmma's K-major core-matrix layout, zero-padded to KP x NP, and finish
// its padded f32 bias. Each task is one core-matrix row: 8 K-values of
// one column n, read down a column (conflict-free across lanes) and
// stored as 16 bytes (a quarter-warp fills one 128-byte core matrix).
template <class P, int L>
__device__ void convert_layer(const Args& a, unsigned char* smem) {
  constexpr int KP = P::kp(L), NP = P::np(L), KC = KP / 8;
  mbar_wait(smem_addr(smem + P::kBars + 8 * L), 0);
  const int K = layer_k(a, L), N = layer_n(a, L);
  const float* staged = reinterpret_cast<const float*>(smem + P::wf_off(L));
  const float* w = a.w[L];
  const int w_bulk = (K * N) & ~3;  // elements that came by bulk copy
  uint4* wb = reinterpret_cast<uint4*>(smem + P::wb_off(L));
  if (K == KP && N == NP) {
    // Unpadded (the main path's widths): every element came by bulk copy
    // and sits at a compile-time stride, so a task is 8 loads, 4
    // conversions and a store.
#pragma unroll 4
    for (int t = threadIdx.x; t < KC * NP; t += kThreads) {
      const int c = t / NP, n = t % NP;
      const float* src = staged + 8 * c * NP + n;
      wb[((n / 8) * KC + c) * 8 + (n % 8)] =
          make_uint4(pack_bf16(src[0], src[NP]), pack_bf16(src[2 * NP], src[3 * NP]),
                     pack_bf16(src[4 * NP], src[5 * NP]), pack_bf16(src[6 * NP], src[7 * NP]));
    }
  } else {
    for (int t = threadIdx.x; t < KC * NP; t += kThreads) {
      const int c = t / NP, n = t % NP;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = 8 * c + e;
        const int idx = k * N + n;
        v[e] = (k < K && n < N) ? (idx < w_bulk ? staged[idx] : __ldg(w + idx)) : 0.0f;
      }
      // Row n % 8 (16 bytes) of core matrix (n / 8, c).
      wb[((n / 8) * KC + c) * 8 + (n % 8)] =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
  }
  float* bias = reinterpret_cast<float*>(smem + P::bias_off(L));
  for (int n = (N & ~3) + threadIdx.x; n < NP; n += kThreads) {
    bias[n] = n < N ? __ldg(a.b[L] + n) : 0.0f;
  }
  fence_proxy_async();  // the bf16 weights are read by wgmma (async proxy)
  __syncthreads();
}

template <int K1, int NH, int N3>
__global__ void __launch_bounds__(kThreads, 1) forecast_mlp_kernel(const Args a) {
  using P = Plan<K1, NH, N3>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int n_tiles = (a.B + kRows - 1) / kRows;

  float* sx = reinterpret_cast<float*>(smem + P::kX + wg * P::kXTile);
  const uint32_t xbar = smem_addr(smem + P::kBars + 8 * (kLayers + wg));
  const float* bias1 = reinterpret_cast<const float*>(smem + P::bias_off(0));
  const float* bias2 = reinterpret_cast<const float*>(smem + P::bias_off(1));
  const float* bias3 = reinterpret_cast<const float*>(smem + P::bias_off(2));
  const __nv_bfloat16* wb1 = reinterpret_cast<const __nv_bfloat16*>(smem + P::wb_off(0));
  const __nv_bfloat16* wb2 = reinterpret_cast<const __nv_bfloat16*>(smem + P::wb_off(1));
  const __nv_bfloat16* wb3 = reinterpret_cast<const __nv_bfloat16*>(smem + P::wb_off(2));

  // The x tile's 16-byte-aligned part goes by bulk copy; the tail (at most
  // three floats) is read from global memory where it is used.
  auto tile_bulk_bytes = [&](int tile) -> uint32_t {
    const long long row0 = static_cast<long long>(tile) * kRows;
    const long long rows = min(static_cast<long long>(kRows), a.B - row0);
    return static_cast<uint32_t>(rows * a.W * 4) & ~15u;
  };
  auto issue_x = [&](int tile) {
    const uint32_t bytes = tile_bulk_bytes(tile);
    mbar_expect_tx(xbar, bytes);
    if (bytes) bulk_copy(sx, a.x + static_cast<long long>(tile) * kRows * a.W, bytes, xbar);
  };

  if (tid == 0) {
    for (int i = 0; i < kLayers + kWarpgroups; ++i) mbar_init(smem_addr(smem + P::kBars + 8 * i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int tile = blockIdx.x + wg * gridDim.x;
  const int stride = kWarpgroups * gridDim.x;
  if (tid == 0) {
    issue_weights<P, 0>(a, smem);
    if (P::kStageAll) {
      issue_weights<P, 1>(a, smem);
      issue_weights<P, 2>(a, smem);
    }
  }
  if (wt == 0 && tile < n_tiles) issue_x(tile);

  convert_layer<P, 0>(a, smem);
  if (!P::kStageAll && tid == 0) {
    fence_proxy_async();
    issue_weights<P, 1>(a, smem);
  }

  uint32_t xphase = 0;
  for (bool first = true;; first = false) {
    const bool has = tile < n_tiles;
    if (!has && !first) break;
    const int next = tile + stride;
    const long long row0 = static_cast<long long>(tile) * kRows;
    const int rows_valid = has ? static_cast<int>(min(static_cast<long long>(kRows), a.B - row0)) : 0;

    float acc[NH / 2];
    uint32_t act[NH / 16][4];
    if (has) {
      // Layer 1's A fragments straight from the x tile, rounded to bf16.
      mbar_wait(xbar, xphase);
      xphase ^= 1;
      const int x_bulk = static_cast<int>(tile_bulk_bytes(tile) / 4);
      const float* xg = a.x + row0 * a.W;
      uint32_t a1[K1 / 16][4];
#pragma unroll
      for (int s = 0; s < K1 / 16; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = warp * 16 + g + (i & 1) * 8;
          const int c = s * 16 + 2 * tig + (i >> 1) * 8;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = r * a.W + c + e;
            v[e] = (r < rows_valid && c + e < a.W) ? (idx < x_bulk ? sx[idx] : __ldg(xg + idx))
                                                   : 0.0f;
          }
          a1[s][i] = pack_bf16(v[0], v[1]);
        }
      }
      // The tile is in registers: the buffer takes the next tile now.
      warpgroup_sync(1 + wg);
      if (wt == 0 && next < n_tiles) {
        fence_proxy_async();
        issue_x(next);
      }
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) acc[i] = 0.0f;
      layer_product<K1, NH>(acc, a1, wb1);
      hidden_epilogue<NH>(acc, bias1, act, tig);
    }
    if (first) {
      convert_layer<P, 1>(a, smem);
      if (!P::kStageAll && tid == 0) {
        fence_proxy_async();
        issue_weights<P, 2>(a, smem);
      }
    }
    if (has) {
      layer_product<NH, NH>(acc, act, wb2);
      hidden_epilogue<NH>(acc, bias2, act, tig);
    }
    if (first) convert_layer<P, 2>(a, smem);
    if (has) {
      float out3[N3 / 2];
#pragma unroll
      for (int i = 0; i < N3 / 2; ++i) out3[i] = 0.0f;
      layer_product<NH, N3>(out3, act, wb3);
#pragma unroll
      for (int j = 0; j < N3 / 8; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = warp * 16 + g + (q >> 1) * 8;
          const int c = 8 * j + 2 * tig + (q & 1);
          if (r < rows_valid && c < a.Z) {
            a.out[(row0 + r) * a.Z + c] = sigmoid(out3[4 * j + q] + bias3[c]);
          }
        }
      }
    }
    tile = next;
  }
}

// Per-device launch configuration of one instantiation, filled on first
// use: the dynamic shared memory the kernel has been opened up to, and
// the SM count (the persistent grid's size).
struct DeviceConfig {
  int sms = 0;
};

template <int K1, int NH, int N3>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using P = Plan<K1, NH, N3>;
  static DeviceConfig configs[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceConfig& cfg = configs[device];
  if (cfg.sms == 0) {
    err = cudaFuncSetAttribute(forecast_mlp_kernel<K1, NH, N3>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(P::kBytes));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, forecast_mlp_kernel<K1, NH, N3>, kThreads, P::kBytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cfg.sms = sms;
  }
  const int n_tiles = (a.B + kRows - 1) / kRows;
  const int grid = n_tiles < cfg.sms ? n_tiles : cfg.sms;
  forecast_mlp_kernel<K1, NH, N3><<<grid, kThreads, P::kBytes, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// x [B, W], w1 [W, H], b1 [H], w2 [H, H], b2 [H], w3 [H, Z], b3 [Z] and
// out [B, Z], all f32, contiguous, 16-byte aligned, on the current
// device. 0 < W, H, Z <= 128. Enqueues on `stream` without synchronising;
// returns the CUDA error code of the configuration and the launch (0 on
// success).
int forecast_mlp_forward(const float* x, const float* w1, const float* b1,
                         const float* w2, const float* b2, const float* w3,
                         const float* b3, float* out, int B, int W, int H,
                         int Z, cudaStream_t stream) {
  if (W < 1 || H < 1 || Z < 1 || W > kMaxDim || H > kMaxDim || Z > kMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const void* ptrs[] = {x, w1, b1, w2, b2, w3, b3, out};
  for (const void* p : ptrs) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, {w1, w2, w3}, {b1, b2, b3}, out, B, W, H, Z};
  cudaError_t err = (W <= 32 && Z <= 8) ? launch<32, 128, 8>(a, stream)
                                        : launch<128, 128, 128>(a, stream);
  return static_cast<int>(err);
}

const char* forecast_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
