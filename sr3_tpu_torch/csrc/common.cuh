// Shared helpers for the sr3_tpu_torch Hopper kernels.
//
// Every kernel reads float32 or bfloat16 activations and accumulates in
// float32. Layouts are the JAX package's: NHWC activations (a logical NCHW
// tensor in torch.channels_last memory), (Cout, 3, 3, Cin) conv weights (a
// channels_last OIHW tensor), (batch*heads, seq, head_dim) attention operands.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sr3 {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// GroupNorm statistics for an NHWC map, shared by the GroupNorm kernel (K2)
// and the fused GroupNorm->SiLU->conv3x3 kernel (K1). Two launches:
//   1. per-(batch, channel) partial sums of v and v*v over `splits` slices
//      of the pixels, where v = pre_scale*x + pre_bias (per (b, c); either
//      pointer may be null for 1 / 0), block = C*rows threads;
//   2. a fold per batch element: group mean and rstd (one-pass variance
//      clamped at 0), then per-channel mult = pre_scale*rstd*gamma and
//      add = (pre_bias - mean)*rstd*gamma + beta, so the normalized value of
//      v is x*mult + add.
// workspace: float32 scratch of gn_workspace_floats(B, HW, C) floats, laid
// out as mult (B, C), add (B, C), then the partial sums (B, splits, C, 2).
// C must be 1..1024 (one thread per channel).
constexpr int kGnMaxChannels = 1024;

struct GnTiling {
  int splits, rows;
};

// `rows` pixel rows per block of C threads (<= 1024 threads), and enough
// pixel slices that ~4 blocks per SM of an H100 (132 SMs) are in flight
// even at batch 1, with at least 4 pixels per thread.
inline GnTiling gn_tiling(int B, int HW, int C) {
  const int rows = C < 512 ? 512 / C : 1;
  int splits = (528 + B - 1) / B;
  if (splits > HW / (4 * rows)) splits = HW / (4 * rows);
  return {splits < 1 ? 1 : splits, rows};
}

// Floats of the statistics workspace, or -1 when C is out of range.
inline long long gn_workspace_floats(int B, int HW, int C) {
  if (B < 1 || HW < 1 || C < 1 || C > kGnMaxChannels) return -1;
  return (long long)B * C * (2LL + 2LL * gn_tiling(B, HW, C).splits);
}

// Where `add` starts in the workspace (`mult` starts at its beginning).
inline float* gn_add(float* workspace, int B, int C) {
  return workspace + (size_t)B * C;
}

cudaError_t launch_gn_stats(const void* x, int dtype, const float* pre_scale,
                            const float* pre_bias, const float* gamma,
                            const float* beta, float* workspace, int B,
                            int HW, int C, int G, float eps,
                            cudaStream_t stream);

}  // namespace sr3
