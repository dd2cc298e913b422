// K5 / K6: flash-attention backward, non-causal, float32 throughout.
//
// K5 replaces sr3_tpu/ops/attention.py:163 `_flash_bwd_dkv_kernel` (the
// first pallas_call of `attention_flash_bwd`, :254): one block owns a tile
// of 16 keys, streams 16-row tiles of Q and dO, rebuilds the probabilities
// P = exp(q k^T * scale - lse) from the forward's logsumexp, and accumulates
// dV += P^T dO and dK += dS^T Q with dS = P (dO v^T - dsum) * scale.
// K6 replaces `_flash_bwd_dq_kernel` (:203, the pallas_call at :273): one
// block owns a tile of 16 queries (Q, dO, lse, dsum), streams K and V tiles
// and accumulates dQ += dS K. Neither kernel ever holds the (S x S) matrix:
// each 16 x 16 tile of P and dS lives in shared memory for one step, so the
// same code runs at any length; offsets are size_t and the grid is
// (ceil(S / 16), BH).
//
// On the 16->128 training path the shapes are (BH, S, D) = (B, 256, 512)
// and (B, 64, 512), scale 1/sqrt(512), six calls of each per train step; on
// the 64->512 path (2, 4096, 512) three times and (2, 1024, 512) four times
// per step. At 4096 tokens and more the float32 FMA loops are the bound, far
// above the bf16 tensor-core bound (8*BH*S^2*D operations for K5, 6*BH*S^2*D
// for K6).
// Bound on the card: like K4, shared-memory bandwidth of the float32 FMA
// loops (two shared loads per FMA in the 16 x 16 score and dP dot products
// over D) and, at batch 4, blocks in flight: K5 and K6 launch S/16 * BH
// blocks, 64 at S=256 for 132 SMs. head_dim 512 is the hard part: the four
// 16 x 512 float32 tiles (own Q or K, own dO or V, and the two streamed
// ones) take 131 KB of dynamic shared memory, above the 48 KB default, so
// each launch raises the kernel's cudaFuncAttributeMaxDynamicSharedMemorySize
// first; rows are padded to D + 1 floats so the 16 rows a warp reads in the
// dot products fall in 16 banks. The accumulators stay in registers: each
// thread owns row r = tid / 16 and d = tid % 16 + 16 j of its outputs (32
// floats for dQ; 64 for dK and dV).
//
// Tolerance against the plain version (sr3_tpu_torch/ops/attention.py
// `attention_bwd_plain`, float32 einsums, TF32 off): 1e-4 of max|plain| with
// float32 and bfloat16 q, k, v alike -- both sides widen the same inputs to
// float32 and keep P, dS and the accumulators in float32; only the order of
// the float32 sums differs.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kB = 16;          // rows per tile, queries and keys alike
constexpr int kThreads = 256;   // = kB * kB: 16 rows x 16 d-lanes
constexpr int kDMax = 512;
constexpr int kNJ = kDMax / 16; // accumulators of one output per thread

size_t smem_bytes(int D) {
  const size_t ld = D + 1;
  return sizeof(float) * (4 * kB * ld + 2 * kB * kB + 2 * kB);
}

// Rows [r0, r0 + kB) of a contiguous (S, D) matrix into a [kB][ld] float
// tile; rows past S read 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S, int D, int ld) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D, gr = r0 + r;
    dst[r * ld + d] = gr < S ? sr3::to_float(src[(size_t)gr * D + d]) : 0.f;
  }
}

// lse and dsum of rows [r0, r0 + kB); rows past S read 0.
__device__ __forceinline__ void load_rows(float* l_s, float* d_s,
                                          const float* lse, const float* dsum,
                                          int r0, int S) {
  if (threadIdx.x < kB) {
    const int r = r0 + threadIdx.x;
    l_s[threadIdx.x] = r < S ? lse[r] : 0.f;
    d_s[threadIdx.x] = r < S ? dsum[r] : 0.f;
  }
}

__device__ __forceinline__ float row_dot(const float* a, const float* b,
                                         int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// P and dS of the tile pair for this thread's (query qi, key kj); zero for
// a query or key past S.
__device__ __forceinline__ void p_ds(const float* q_s, const float* k_s,
                                     const float* g_s, const float* v_s,
                                     const float* l_s, const float* d_s,
                                     int qi, int kj, bool valid, int D, int ld,
                                     float scale, float* p, float* ds) {
  const float s = row_dot(q_s + qi * ld, k_s + kj * ld, D) * scale;
  const float pv = valid ? expf(s - l_s[qi]) : 0.f;
  const float dp = row_dot(g_s + qi * ld, v_s + kj * ld, D);
  *p = pv;
  *ds = pv * (dp - d_s[qi]) * scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         float* __restrict__ dk, float* __restrict__ dv, int S,
                         int D, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* k_s = smem;              // [kB][ld] this block's keys
  float* v_s = k_s + kB * ld;     // [kB][ld] this block's values
  float* q_s = v_s + kB * ld;     // [kB][ld] streamed queries
  float* g_s = q_s + kB * ld;     // [kB][ld] streamed dO
  float* p_s = g_s + kB * ld;     // [kB q][kB k] P
  float* ds_s = p_s + kB * kB;    // [kB q][kB k] dS
  float* l_s = ds_s + kB * kB;    // [kB] lse of the query tile
  float* d_s = l_s + kB;          // [kB] dsum of the query tile

  const int bh = blockIdx.y, k0 = blockIdx.x * kB, tid = threadIdx.x;
  const size_t base = (size_t)bh * S * D;
  load_tile(k_s, k + base, k0, S, D, ld);
  load_tile(v_s, v + base, k0, S, D, ld);

  const int row = tid / 16, lane = tid % 16;  // score (qi, kj) = (row, lane)
  const int nd = D / 16;
  float acc_k[kNJ], acc_v[kNJ];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) acc_k[j] = acc_v[j] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kB) {
    __syncthreads();  // the previous query tile, P and dS are consumed
    load_tile(q_s, q + base, q0, S, D, ld);
    load_tile(g_s, g + base, q0, S, D, ld);
    load_rows(l_s, d_s, lse + (size_t)bh * S, dsum + (size_t)bh * S, q0, S);
    __syncthreads();
    p_ds(q_s, k_s, g_s, v_s, l_s, d_s, row, lane,
         q0 + row < S && k0 + lane < S, D, ld, scale, &p_s[row * kB + lane],
         &ds_s[row * kB + lane]);
    __syncthreads();
    // key row `row`: dV += sum_i P[i][row] dO[i], dK += sum_i dS[i][row] Q[i]
    for (int i = 0; i < kB; ++i) {
      const float p = p_s[i * kB + row], ds = ds_s[i * kB + row];
      const float* gr = g_s + i * ld + lane;
      const float* qr = q_s + i * ld + lane;
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
        if (j < nd) {
          acc_v[j] = fmaf(p, gr[16 * j], acc_v[j]);
          acc_k[j] = fmaf(ds, qr[16 * j], acc_k[j]);
        }
    }
  }

  const int kr = k0 + row;
  if (kr >= S) return;
  float* dkb = dk + base + (size_t)kr * D + lane;
  float* dvb = dv + base + (size_t)kr * D + lane;
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
    if (j < nd) {
      dkb[16 * j] = acc_k[j];
      dvb[16 * j] = acc_v[j];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        float* __restrict__ dq, int S, int D, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;              // [kB][ld] this block's queries
  float* g_s = q_s + kB * ld;     // [kB][ld] this block's dO
  float* k_s = g_s + kB * ld;     // [kB][ld] streamed keys
  float* v_s = k_s + kB * ld;     // [kB][ld] streamed values
  float* p_s = v_s + kB * ld;     // [kB q][kB k] P (unused but for p_ds)
  float* ds_s = p_s + kB * kB;    // [kB q][kB k] dS
  float* l_s = ds_s + kB * kB;
  float* d_s = l_s + kB;

  const int bh = blockIdx.y, q0 = blockIdx.x * kB, tid = threadIdx.x;
  const size_t base = (size_t)bh * S * D;
  load_tile(q_s, q + base, q0, S, D, ld);
  load_tile(g_s, g + base, q0, S, D, ld);
  load_rows(l_s, d_s, lse + (size_t)bh * S, dsum + (size_t)bh * S, q0, S);

  const int row = tid / 16, lane = tid % 16;
  const int nd = D / 16;
  float acc[kNJ];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kB) {
    __syncthreads();  // the own tiles are loaded; the previous K/V, dS free
    load_tile(k_s, k + base, k0, S, D, ld);
    load_tile(v_s, v + base, k0, S, D, ld);
    __syncthreads();
    p_ds(q_s, k_s, g_s, v_s, l_s, d_s, row, lane,
         q0 + row < S && k0 + lane < S, D, ld, scale, &p_s[row * kB + lane],
         &ds_s[row * kB + lane]);
    __syncthreads();
    // query row `row`: dQ += sum_j dS[row][j] K[j]
    const float* dsr = ds_s + row * kB;
    for (int kj = 0; kj < kB; ++kj) {
      const float ds = dsr[kj];
      const float* kr = k_s + kj * ld + lane;
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
        if (j < nd) acc[j] = fmaf(ds, kr[16 * j], acc[j]);
    }
  }

  const int qr = q0 + row;
  if (qr >= S) return;
  float* dqb = dq + base + (size_t)qr * D + lane;
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
    if (j < nd) dqb[16 * j] = acc[j];
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
cudaError_t dkv_t(const void* q, const void* k, const void* v, const float* g,
                  const float* lse, const float* dsum, float* dk, float* dv,
                  int BH, int S, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kB - 1) / kB, BH);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), g, lse, dsum, dk, dv, S, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_t(const void* q, const void* k, const void* v, const float* g,
                 const float* lse, const float* dsum, float* dq, int BH, int S,
                 int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = prepare(flash_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kB - 1) / kB, BH);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), g, lse, dsum, dq, S, D, scale);
  return cudaGetLastError();
}

bool bad_shape(int BH, int S, int D) {
  return D % 16 || D > kDMax || D <= 0 || S <= 0 || BH <= 0 || BH > 65535;
}

}  // namespace

// K5: dk, dv of softmax(q k^T * scale) v. q, k, v: (BH, S, D) of dtype; g
// (= dO), dk, dv: (BH, S, D) float32; lse (the forward's logsumexp of q k^T
// * scale) and dsum (= rowsum(dO * O)): (BH, S) float32; all contiguous. D
// must be a multiple of 16 and at most 512. Returns the CUDA error code.
extern "C" int sr3_flash_attention_bwd_dkv(const void* q, const void* k,
                                           const void* v, const float* g,
                                           const float* lse, const float* dsum,
                                           float* dk, float* dv, int BH, int S,
                                           int D, float scale, int dtype,
                                           void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sr3::kF32)
    return (int)dkv_t<float>(q, k, v, g, lse, dsum, dk, dv, BH, S, D, scale,
                             st);
  if (dtype == sr3::kBF16)
    return (int)dkv_t<__nv_bfloat16>(q, k, v, g, lse, dsum, dk, dv, BH, S, D,
                                     scale, st);
  return (int)cudaErrorInvalidValue;
}

// K6: dq, with the operands of K5; dq: (BH, S, D) float32.
extern "C" int sr3_flash_attention_bwd_dq(const void* q, const void* k,
                                          const void* v, const float* g,
                                          const float* lse, const float* dsum,
                                          float* dq, int BH, int S, int D,
                                          float scale, int dtype,
                                          void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sr3::kF32)
    return (int)dq_t<float>(q, k, v, g, lse, dsum, dq, BH, S, D, scale, st);
  if (dtype == sr3::kBF16)
    return (int)dq_t<__nv_bfloat16>(q, k, v, g, lse, dsum, dq, BH, S, D,
                                    scale, st);
  return (int)cudaErrorInvalidValue;
}
