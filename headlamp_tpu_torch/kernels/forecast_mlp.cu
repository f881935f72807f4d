// Fused forecaster inference for Hopper (sm_90a):
//   out = sigmoid(gelu_tanh(gelu_tanh(x·W1 + b1)·W2 + b2)·W3 + b3)
//
// Replaces the Pallas TPU kernel headlamp_tpu/models/pallas_forward.py
// (_forward_kernel, launched by _padded_forward through pl.pallas_call).
// It computes the same function with the same numerics: every matmul
// operand is rounded to bf16 (__float2bfloat16_rn), products and the
// running sum are f32, the bias is added in f32, GELU is the tanh form
// in f32 (jax.nn.gelu's default), each hidden activation is rounded to
// bf16 again as the next layer's operand, and the output is an f32
// sigmoid.
//
// What bounds it: at the forecaster's widths (32 -> 128 -> 128 -> 8) a
// row costs 43,008 FLOP and 160 bytes of x and out, so even 16k rows are
// about 0.7 GFLOP and 2.6 MB: well under a microsecond of tensor-core or
// HBM time on an H100. This simple kernel is bound instead by the time
// one block takes to work through its tile: per k step each warp runs
// 12 shared-memory loads for 32 FMAs, and 8 warps per block hide little
// of their latency. Blocks run in parallel, so the time is nearly flat
// in the batch until the tiles outnumber the resident blocks
// (chip_smoke.py times it). Tensor-core fragments would cut the loads
// per FMA; that is later work. The design keeps every intermediate on
// chip, as the TPU kernel kept it in VMEM: each block stages W1, W2 and
// W3 once as bf16 in shared memory, then walks 64-row tiles
// (grid-stride) with the activation tile in shared memory, so device
// memory sees x read once and out written once. The TPU's 128-lane
// padding is not carried over: the kernel takes the true widths and
// masks the ragged tail tile.
//
// Work layout: 256 threads = 8 warps; warp w owns tile rows 8w..8w+7,
// lane l owns output columns l, l+32, l+64, l+96 (those below N). Each
// thread keeps an 8x4 block of f32 accumulators; per k step it reads 8
// activations (one address per warp: a broadcast) and 4 weights
// (consecutive across lanes: conflict-free) from shared memory. Plain
// FMA loops; wgmma, TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                         // rows per tile
constexpr int kThreads = 256;                     // threads per block
constexpr int kWarps = kThreads / 32;             // 8
constexpr int kRowsPerWarp = kRows / kWarps;      // 8
constexpr int kMaxDim = 128;                      // the single-tile guard
constexpr int kColsPerLane = kMaxDim / 32;        // 4
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k_sqrt_2_over_pi = 0.7978845608028654f;
  const float inner = k_sqrt_2_over_pi * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// One dense layer over the tile: act [kRows, K] bf16 (shared) times
// w [K, N] bf16 (shared) plus bias [N] f32 (global). Hidden layers write
// gelu(.) rounded to bf16 into act_out [kRows, N] (shared); the last
// layer writes sigmoid(.) to out rows row0.. (global), skipping rows at
// or beyond rows_valid.
template <bool kLast>
__device__ __forceinline__ void dense_layer(
    const __nv_bfloat16* __restrict__ act, int K,
    const __nv_bfloat16* __restrict__ w, int N,
    const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ act_out,
    float* __restrict__ out, long long row0, int rows_valid) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRowsPerWarp;

  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.0f;
  }

  for (int k = 0; k < K; ++k) {
    float a[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      a[i] = __bfloat162float(act[(r0 + i) * K + k]);
    }
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = lane + 32 * j;
      const float wv = (c < N) ? __bfloat162float(w[k * N + c]) : 0.0f;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) acc[i][j] = fmaf(a[i], wv, acc[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c >= N) continue;
    const float b = bias[c];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float v = acc[i][j] + b;
      const int r = r0 + i;
      if (kLast) {
        if (r < rows_valid) out[(row0 + r) * N + c] = sigmoid(v);
      } else {
        act_out[r * N + c] = __float2bfloat16_rn(gelu_tanh(v));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) forecast_mlp_kernel(
    const float* __restrict__ x,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const float* __restrict__ b3,
    float* __restrict__ out, int B, int W, int H, int Z) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sw1 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sw2 = sw1 + W * H;
  __nv_bfloat16* sw3 = sw2 + H * H;
  __nv_bfloat16* act0 = sw3 + H * Z;                  // [kRows, max(W, H)]
  __nv_bfloat16* act1 = act0 + kRows * (W > H ? W : H);  // [kRows, H]

  // Stage the weights once per block, rounded to bf16.
  for (int i = threadIdx.x; i < W * H; i += kThreads) sw1[i] = __float2bfloat16_rn(w1[i]);
  for (int i = threadIdx.x; i < H * H; i += kThreads) sw2[i] = __float2bfloat16_rn(w2[i]);
  for (int i = threadIdx.x; i < H * Z; i += kThreads) sw3[i] = __float2bfloat16_rn(w3[i]);

  const int n_tiles = (B + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kRows;
    const int rows_valid = min(kRows, static_cast<int>(B - row0));
    // Weights staged, and the previous tile's last layer done with act0.
    __syncthreads();
    const float* xt = x + row0 * W;
    for (int i = threadIdx.x; i < kRows * W; i += kThreads) {
      const float v = (i / W < rows_valid) ? xt[i] : 0.0f;
      act0[i] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    dense_layer<false>(act0, W, sw1, H, b1, act1, nullptr, row0, rows_valid);
    __syncthreads();
    dense_layer<false>(act1, H, sw2, H, b2, act0, nullptr, row0, rows_valid);
    __syncthreads();
    dense_layer<true>(act0, H, sw3, Z, b3, nullptr, out, row0, rows_valid);
  }
}

size_t smem_bytes(int W, int H, int Z) {
  const int widest = W > H ? W : H;
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(W) * H + static_cast<size_t>(H) * H +
          static_cast<size_t>(H) * Z + static_cast<size_t>(kRows) * widest +
          static_cast<size_t>(kRows) * H);
}

// Per-device launch configuration, filled on first use: the dynamic
// shared memory the kernel has been opened up to, and the grid size
// for that footprint (SMs times resident blocks per SM).
struct DeviceConfig {
  size_t smem = 0;
  int grid = 0;
};
DeviceConfig g_config[kMaxDevices];

cudaError_t configure(int device, size_t smem, int* grid) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceConfig& cfg = g_config[device];
  if (cfg.smem == smem && cfg.grid > 0) {
    *grid = cfg.grid;
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      forecast_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, forecast_mlp_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cfg.smem = smem;
  cfg.grid = sms * per_sm;
  *grid = cfg.grid;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x [B, W], w1 [W, H], b1 [H], w2 [H, H], b2 [H], w3 [H, Z], b3 [Z] and
// out [B, Z], all f32, contiguous, on the current device. 0 < W, H, Z <=
// 128. Enqueues on `stream` without synchronising; returns the CUDA
// error code of the configuration and the launch (0 on success).
int forecast_mlp_forward(const float* x, const float* w1, const float* b1,
                         const float* w2, const float* b2, const float* w3,
                         const float* b3, float* out, int B, int W, int H,
                         int Z, cudaStream_t stream) {
  if (W < 1 || H < 1 || Z < 1 || W > kMaxDim || H > kMaxDim || Z > kMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return static_cast<int>(cudaSuccess);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(W, H, Z);
  int grid = 0;
  err = configure(device, smem, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (B + kRows - 1) / kRows;
  if (grid > n_tiles) grid = n_tiles;
  forecast_mlp_kernel<<<grid, kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, w3, b3, out, B, W, H, Z);
  return static_cast<int>(cudaGetLastError());
}

const char* forecast_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
