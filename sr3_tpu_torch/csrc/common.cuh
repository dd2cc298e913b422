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

// ---- tensor cores, fragment loads and asynchronous copies (K1, K4-K6) ----

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

// ---- warpgroup products (K1): wgmma with A from registers ----
//
// wgmma.mma_async m64nNk16, bf16 -> float32, is issued by the four warps of
// a warpgroup (128 threads, warp index % 4 == 0 first) and runs
// asynchronously. A (64 x 16) comes from registers in the m16n8k16 A layout
// per warp (warp i of the group holds rows 16i..16i+15: `a` as for mma_bf16,
// so ldmatrix_x4 loads it); B (16 x N) comes from shared memory through a
// matrix descriptor; D (64 x N float32) stays in registers, N / 2 a thread:
// d[4j + e] is row 16i + gid + 8 (e / 2), column 8j + 2 tig + e % 2 (the
// m16n8 C layout, one 8-column tile per j).

// Descriptor of a K-major B tile under the 128-byte swizzle: N rows of 64
// bf16 (128 bytes) at `addr` (shared, 1024-byte aligned, 16-byte chunk c of
// row n stored at chunk c ^ (n % 8)); eight-row groups 1024 bytes apart.
// The k-th 16-deep step of the tile starts 32 * k bytes further.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Before the first wgmma that reads registers written since the last one.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most `n` of the warpgroup's committed groups are in flight.
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// Keep the compiler from moving reads of an accumulator across a wait.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
// Order this thread's generic-proxy writes to shared memory (cp.async
// included) before async-proxy reads of it (wgmma descriptors).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += a * B: one m64nNk16 product, N in {8, 64, 128}.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3"
      "}, {%4,%5,%6,%7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
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

// Multiprocessor count of the current device, read once per device.
inline cudaError_t sm_count(int* sms) {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && (*sms = known[dev].load(std::memory_order_acquire)) > 0)
    return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && keep)
    known[dev].store(*sms, std::memory_order_release);
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
