// Shared helpers for the sr3_tpu_torch Hopper kernels.
//
// Every kernel reads float32 or bfloat16 activations and accumulates in
// float32. Layouts are the JAX package's: NHWC activations (a logical NCHW
// tensor in torch.channels_last memory), (Cout, 3, 3, Cin) conv weights (a
// channels_last OIHW tensor), (batch*heads, seq, head_dim) attention operands.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sr3 {

enum DType { kF32 = 0, kBF16 = 1 };

// ---- tensor cores, fragment loads and asynchronous copies (K1, K4, K5) ----

// d += a * b: one mma.sync m16n8k16, bf16 operands, float32 accumulate.
// a: the A fragment (rows gid / gid + 8, k 2*tig.. and 8 + 2*tig..; gid =
// lane / 4, tig = lane % 4); b0, b1: the B fragment (k 2*tig.. and
// 8 + 2*tig.., column gid); d: the C fragment (row gid: d[0], d[1]; row
// gid + 8: d[2], d[3]; columns 2*tig, 2*tig + 1).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring bf16 values as one 32-bit fragment register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) rounded to bf16 and packed as one fragment register: a float32
// C fragment of m16n8 becomes the A fragment of the next product.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring m16n8 C fragments (16 rows x 16 columns, float32)
// rounded to bf16 as the A fragment of an m16n8k16 product whose k runs over
// those 16 columns: the C layout is the A layout.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[i] receives
// matrix i in fragment layout (row gid, columns 2*tig, 2*tig + 1), or with
// `_trans` its transpose (rows 2*tig, 2*tig + 1, column gid).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16-byte asynchronous copy global -> shared (cp.async, L2 only); with
// `valid` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `n` of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Rows [r0, r0 + R) of a contiguous (S, D) bf16 matrix into a [R][ld]
// shared-memory tile, 16-byte cp.async copies by the block's `threads`
// threads; rows past S are zero-filled. D % 8 == 0, src 16-byte aligned.
template <int R, int threads>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int S, int D, int ld) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < R * chunks; i += threads) {
    const int r = i / chunks, c = 8 * (i % chunks);
    const bool ok = r0 + r < S;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)(r0 + r) * D + c : src,
               ok);
  }
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads,
// whole warps.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Raise a kernel's dynamic shared-memory limit (above the 48 KB default)
// once per device, not before every launch: `state` is a function-local
// static of the kernel's launcher, and `bytes` the most any launch asks.
constexpr int kMaxDevices = 64;
struct SmemLimit {
  std::atomic<bool> raised[kMaxDevices];
};
inline cudaError_t raise_smem_limit(SmemLimit& state, const void* kernel,
                                    size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && state.raised[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && keep)
    state.raised[dev].store(true, std::memory_order_release);
  return err;
}

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
