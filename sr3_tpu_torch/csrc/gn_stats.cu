// K3: GroupNorm statistics of a large NHWC map -- the float32 sum and sum of
// squares of every (batch, channel), s1 = sum_p x and s2 = sum_p x^2 over the
// H*W pixels. The group fold, the normalize and the backward stay outside, in
// PyTorch (sr3_tpu_torch/ops/groupnorm.py), as they stay in XLA on the TPU.
//
// Replaces the TPU kernel sr3_tpu/ops/groupnorm.py:66 `_gn_stats_kernel`
// (pallas_call in `gn_stats_pallas`, :114). In the port it runs wherever
// group_norm sees a map of H*W >= 256^2: on the 64->512 training path the
// dropout Blocks at 512^2 (C=64) and 256^2 (C=128), three of each per UNet
// forward.
//
// Bound on the card: device-memory bytes. It reads x once and writes 2*B*C
// floats; at (2, 512, 512, 64) bf16 that is 67.1 MB, 20.0 us at 3.35 TB/s,
// and 33.6 MB (10.0 us) at (2, 256, 256, 128). Two flops per element.
//
// Design. The TPU kernel walks H in order and adds each block's sums into one
// output block across grid steps; on the card blocks run in parallel in no
// order, so the pixels are split over blocks instead:
//   1. partial pass, grid (splits, B): block s owns a contiguous slice of the
//      pixels of one image. Each thread loads 16 bytes of channels (8 bf16 or
//      4 float32) per pixel, so the C/8 (C/4) threads of one pixel read one
//      contiguous row and a warp reads whole 128-byte lines; the block keeps
//      256 / (C/8) pixels in flight and four loads per thread outstanding.
//      `splits` is chosen for ~8 blocks on each of the 132 SMs at any batch.
//      The block reduces its pixel rows in shared memory in a fixed order and
//      writes its (s1, s2) partial of every channel;
//   2. fold pass: per (batch, channel), the partials of the slices summed in a
//      fixed order (8 strided runs, then the 8 run sums in order).
// No atomics: the result is the same every run.
//
// Tolerance against the plain version (`gn_stats_plain`, float32 sums): s1
// within 1e-5 of sum|x| and s2 within 1e-5 of s2, both taken against float64
// sums of the same inputs -- float32 partial sums of at most a few thousand
// terms each, summed in a tree.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSms = 132;
constexpr int kBlocksPerSm = 8;
constexpr int kMinPixelsPerThread = 8;
constexpr int kFoldRuns = 8;  // strided runs over the slices in the fold

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

struct StatsTiling {
  int lanes;   // threads per pixel: C / vec
  int rows;    // pixels in flight per block: kThreads / lanes
  int splits;  // pixel slices per image
};

// vec: channels per 16-byte load. lanes = 0 when C does not fit.
StatsTiling stats_tiling(int B, int HW, int C, int vec) {
  if (B < 1 || HW < 1 || C < 1 || C % vec || C / vec > kThreads)
    return {0, 0, 0};
  const int lanes = C / vec, rows = kThreads / lanes;
  int splits = (kSms * kBlocksPerSm + B - 1) / B;
  const int cap = HW / (rows * kMinPixelsPerThread);
  if (splits > cap) splits = cap;
  return {lanes, rows, splits < 1 ? 1 : splits};
}

int vec_of_dtype(int dtype) {
  return dtype == sr3::kF32 ? 4 : (dtype == sr3::kBF16 ? 8 : 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_stats_partial_kernel(const T* __restrict__ x,
                            float* __restrict__ partial, int HW, int C,
                            int lanes, int rows, int splits) {
  constexpr int V = static_cast<int>(16 / sizeof(T));  // channels per load
  extern __shared__ float red[];  // s1 [rows][C], then s2 [rows][C]
  const int b = blockIdx.y, s = blockIdx.x;
  const int lane = threadIdx.x % lanes, r = threadIdx.x / lanes;
  const bool active = r < rows;
  const int per = (HW + splits - 1) / splits;
  const int p0 = s * per, p1 = min(HW, p0 + per);
  float a1[V], a2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
  if (active) {
    const T* xb = x + (size_t)b * HW * C + lane * V;
    int p = p0 + r;
    for (; p + 3 * rows < p1; p += 4 * rows) {
      float v[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) load16(xb + (size_t)(p + u * rows) * C, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a1[j] += v[u][j];
          a2[j] = fmaf(v[u][j], v[u][j], a2[j]);
        }
    }
    for (; p < p1; p += rows) {
      float v[V];
      load16(xb + (size_t)p * C, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a1[j] += v[j];
        a2[j] = fmaf(v[j], v[j], a2[j]);
      }
    }
    float* r1 = red + r * C + lane * V;
    float* r2 = red + (rows + r) * C + lane * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      r1[j] = a1[j];
      r2[j] = a2[j];
    }
  }
  __syncthreads();
  float* out = partial + (size_t)(b * splits + s) * 2 * C;  // (s1[C], s2[C])
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < rows; ++k) {
      t1 += red[k * C + c];
      t2 += red[(rows + k) * C + c];
    }
    out[c] = t1;
    out[C + c] = t2;
  }
}

// Block (32 channels) x (kFoldRuns runs); grid (ceil(C / 32), B).
__global__ void gn_stats_fold_kernel(const float* __restrict__ partial,
                                     float* __restrict__ s1,
                                     float* __restrict__ s2, int C,
                                     int splits) {
  __shared__ float red[2][kFoldRuns][32];
  const int b = blockIdx.y, cx = threadIdx.x, run = threadIdx.y;
  const int c = blockIdx.x * 32 + cx;
  float t1 = 0.f, t2 = 0.f;
  if (c < C) {
    const float* pb = partial + (size_t)b * splits * 2 * C + c;
    for (int s = run; s < splits; s += kFoldRuns) {
      t1 += pb[(size_t)s * 2 * C];
      t2 += pb[(size_t)s * 2 * C + C];
    }
  }
  red[0][run][cx] = t1;
  red[1][run][cx] = t2;
  __syncthreads();
  if (run == 0 && c < C) {
    for (int k = 1; k < kFoldRuns; ++k) {
      t1 += red[0][k][cx];
      t2 += red[1][k][cx];
    }
    s1[b * C + c] = t1;
    s2[b * C + c] = t2;
  }
}

template <typename T>
cudaError_t gn_stats_t(const void* x, float* s1, float* s2, float* partial,
                       int B, int HW, int C, const StatsTiling& t,
                       cudaStream_t stream) {
  const size_t smem = 2 * (size_t)t.rows * C * sizeof(float);
  gn_stats_partial_kernel<T><<<dim3(t.splits, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), partial, HW, C, t.lanes, t.rows, t.splits);
  gn_stats_fold_kernel<<<dim3((C + 31) / 32, B), dim3(32, kFoldRuns), 0,
                         stream>>>(partial, s1, s2, C, t.splits);
  return cudaGetLastError();
}

}  // namespace

// Floats of float32 scratch that sr3_gn_stats takes as `workspace` for a
// (B, HW, C) input of dtype; -1 when the kernel does not take the shape (C a
// multiple of 8 for bf16 and of 4 for float32, at most 256 16-byte loads per
// pixel, B <= 65535).
extern "C" long long sr3_gn_stats_workspace_floats(int B, int HW, int C,
                                                   int dtype) {
  const int vec = vec_of_dtype(dtype);
  if (vec == 0 || B > 65535) return -1;
  const StatsTiling t = stats_tiling(B, HW, C, vec);
  if (t.lanes == 0) return -1;
  return (long long)B * t.splits * 2 * C;
}

// s1[b, c] = sum_p x[b, p, c], s2[b, c] = sum_p x[b, p, c]^2 in float32.
// x: (B, HW, C) of dtype, contiguous, 16-byte aligned; s1, s2: (B, C)
// float32; workspace: sr3_gn_stats_workspace_floats(B, HW, C, dtype) floats.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int sr3_gn_stats(const void* x, float* s1, float* s2,
                            float* workspace, int B, int HW, int C, int dtype,
                            void* stream) {
  if (sr3_gn_stats_workspace_floats(B, HW, C, dtype) < 0)
    return (int)cudaErrorInvalidValue;
  const StatsTiling t = stats_tiling(B, HW, C, vec_of_dtype(dtype));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sr3::kF32)
    return (int)gn_stats_t<float>(x, s1, s2, workspace, B, HW, C, t, st);
  return (int)gn_stats_t<__nv_bfloat16>(x, s1, s2, workspace, B, HW, C, t, st);
}
