// K2: GroupNorm with optional SiLU, NHWC, float32 one-pass statistics.
//
// Replaces the TPU kernel sr3_tpu/ops/groupnorm.py:237 `_gn_swish_kernel`
// (pallas_call in `group_norm_swish_pallas`, :290). On the 16->128 main path
// it is the attention pre-norm (swish off) at (B,16,16,512) and (B,8,8,512).
//
// Bound on the card: device-memory bytes. It reads x twice (statistics, then
// normalize) and writes y once; the arithmetic is a few FLOPs per element.
// Design: the statistics are split over pixel slices so that a small batch
// still spreads over the SMs; each block keeps one thread per channel (and
// `rows` pixel rows in flight), so loads of neighbouring threads are
// neighbouring channels of one pixel and coalesce. A per-batch fold turns
// the sums into per-channel mult/add, and the normalize pass is a coalesced
// elementwise kernel. The float32 partials are summed in a fixed order, so
// results do not vary from run to run.
//
// Tolerance against the plain version (sr3_tpu_torch/ops/groupnorm.py
// `group_norm_plain`): 1e-5 of max|ref| in float32 -- only the order of the
// float32 sums and x*mult+add versus (x-mean)*rstd*gamma+beta differ;
// 2e-2 in bfloat16 -- one bf16 rounding of the output (2^-8 relative).
#include "common.cuh"

namespace sr3 {
namespace {

template <typename T>
__global__ void gn_partial_stats_kernel(const T* __restrict__ x,
                                        const float* __restrict__ pre_scale,
                                        const float* __restrict__ pre_bias,
                                        float* __restrict__ partial, int HW,
                                        int C, int splits, int rows) {
  extern __shared__ float red[];  // 2 * C * rows
  const int b = blockIdx.y, s = blockIdx.x;
  const int c = threadIdx.x % C, r = threadIdx.x / C;
  const int per = (HW + splits - 1) / splits;
  const int p0 = s * per, p1 = min(HW, p0 + per);
  const float a = pre_scale ? pre_scale[b * C + c] : 1.f;
  const float o = pre_bias ? pre_bias[b * C + c] : 0.f;
  const T* xb = x + (size_t)b * HW * C;
  float s1 = 0.f, s2 = 0.f;
  for (int p = p0 + r; p < p1; p += rows) {
    const float v = fmaf(to_float(xb[(size_t)p * C + c]), a, o);
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
  const int n = C * rows;
  red[threadIdx.x] = s1;
  red[n + threadIdx.x] = s2;
  __syncthreads();
  if (r == 0) {
    for (int k = 1; k < rows; ++k) {
      s1 += red[k * C + c];
      s2 += red[n + k * C + c];
    }
    float* out = partial + ((size_t)(b * splits + s) * C + c) * 2;
    out[0] = s1;
    out[1] = s2;
  }
}

// One block per batch element, one warp per group.
__global__ void gn_fold_kernel(const float* __restrict__ partial,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta,
                               const float* __restrict__ pre_scale,
                               const float* __restrict__ pre_bias,
                               float* __restrict__ mult,
                               float* __restrict__ add, int HW, int C, int G,
                               int splits, float eps) {
  extern __shared__ float stat[];  // mean[G], rstd[G]
  const int b = blockIdx.x;
  const int cg = C / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int g = warp; g < G; g += n_warps) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < splits * cg; i += 32) {
      const int s = i / cg, j = i % cg;
      const float* pp = partial + ((size_t)(b * splits + s) * C + g * cg + j) * 2;
      s1 += pp[0];
      s2 += pp[1];
    }
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      const float cnt = (float)HW * (float)cg;
      const float mean = s1 / cnt;
      const float var = fmaxf(s2 / cnt - mean * mean, 0.f);
      stat[g] = mean;
      stat[G + g] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float a = pre_scale ? pre_scale[b * C + c] : 1.f;
    const float o = pre_bias ? pre_bias[b * C + c] : 0.f;
    const float sc = gamma[c] * stat[G + g];
    mult[b * C + c] = a * sc;
    add[b * C + c] = (o - stat[g]) * sc + beta[c];
  }
}

template <typename T, bool kSwish>
__global__ void gn_apply_kernel(const T* __restrict__ x,
                                const float* __restrict__ mult,
                                const float* __restrict__ add,
                                T* __restrict__ y, long long n, long long hwc,
                                int C) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const int bc = (int)(i / hwc) * C + c;
    float v = fmaf(to_float(x[i]), mult[bc], add[bc]);
    if (kSwish) v = silu(v);
    y[i] = from_float<T>(v);
  }
}

template <typename T>
cudaError_t launch_stats_t(const T* x, const float* pre_scale,
                           const float* pre_bias, const float* gamma,
                           const float* beta, float* partial, float* mult,
                           float* add, int B, int HW, int C, int G,
                           int splits, int rows, float eps,
                           cudaStream_t stream) {
  const int threads = C * rows;
  gn_partial_stats_kernel<T>
      <<<dim3(splits, B), threads, 2 * threads * sizeof(float), stream>>>(
          x, pre_scale, pre_bias, partial, HW, C, splits, rows);
  const int fold_threads = 32 * (G < 32 ? G : 32);
  gn_fold_kernel<<<B, fold_threads, 2 * G * sizeof(float), stream>>>(
      partial, gamma, beta, pre_scale, pre_bias, mult, add, HW, C, G, splits,
      eps);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_gn_stats(const void* x, int dtype, const float* pre_scale,
                            const float* pre_bias, const float* gamma,
                            const float* beta, float* workspace, int B,
                            int HW, int C, int G, float eps,
                            cudaStream_t stream) {
  if (gn_workspace_floats(B, HW, C) < 0 || G <= 0 || C % G)
    return cudaErrorInvalidValue;
  const GnTiling t = gn_tiling(B, HW, C);
  const int splits = t.splits, rows = t.rows;
  float* mult = workspace;
  float* add = gn_add(workspace, B, C);
  float* partial = add + (size_t)B * C;
  if (dtype == kF32)
    return launch_stats_t(static_cast<const float*>(x), pre_scale, pre_bias,
                          gamma, beta, partial, mult, add, B, HW, C, G,
                          splits, rows, eps, stream);
  if (dtype == kBF16)
    return launch_stats_t(static_cast<const __nv_bfloat16*>(x), pre_scale,
                          pre_bias, gamma, beta, partial, mult, add, B, HW, C,
                          G, splits, rows, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace sr3

template <typename T>
static cudaError_t group_norm_t(const void* x, void* y, const float* mult,
                                const float* add, long long n, long long hwc,
                                int C, int swish, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  if (swish)
    sr3::gn_apply_kernel<T, true><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), mult, add, static_cast<T*>(y), n, hwc, C);
  else
    sr3::gn_apply_kernel<T, false><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), mult, add, static_cast<T*>(y), n, hwc, C);
  return cudaGetLastError();
}

// Floats of float32 scratch that sr3_group_norm and sr3_gn_silu_conv3x3 take
// as `workspace` for a (B, HW, C) input; -1 when the kernels do not take C.
extern "C" long long sr3_gn_workspace_floats(int B, int HW, int C) {
  return sr3::gn_workspace_floats(B, HW, C);
}

// y = GroupNorm(x) (then SiLU when swish != 0). x, y: (B, HW, C) of dtype;
// workspace: sr3_gn_workspace_floats(B, HW, C) float32.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int sr3_group_norm(const void* x, const float* gamma,
                              const float* beta, void* y, float* workspace,
                              int B, int HW, int C, int G, float eps,
                              int swish, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = sr3::launch_gn_stats(x, dtype, nullptr, nullptr, gamma,
                                         beta, workspace, B, HW, C, G, eps,
                                         st);
  if (err != cudaSuccess) return (int)err;
  const float* mult = workspace;
  const float* add = sr3::gn_add(workspace, B, C);
  const long long hwc = (long long)HW * C;
  const long long n = hwc * B;
  if (dtype == sr3::kF32)
    return (int)group_norm_t<float>(x, y, mult, add, n, hwc, C, swish, st);
  return (int)group_norm_t<__nv_bfloat16>(x, y, mult, add, n, hwc, C, swish,
                                          st);
}
