// K4: flash-attention forward, non-causal, online softmax with float32
// running max / sum / accumulator; float32 output and, optionally, the
// float32 per-row logsumexp m + log(l) of the scaled scores (the input of
// the backward kernels K5 / K6 in attention_bwd.cu).
//
// Replaces the TPU kernel sr3_tpu/ops/attention.py:58 `_flash_fwd_kernel`
// (pallas_call in `_fwd_pallas_call`, :104), with its `with_lse` output. On
// the 16->128 main path it is the single-head self-attention at 16x16 and in
// the 8x8 mid block: (B, 256, 512) and (B, 64, 512), scale 1/sqrt(512), six
// calls per UNet forward; a training step asks for the logsumexp. On the
// 64->512 path it runs at (2, 4096, 512) and (2, 1024, 512); attention at
// 128x128 on that model would give (B, 16384, D).
//
// Bound on the card: at these sequence lengths neither memory nor FLOPs are
// large (Q, K, V and O are 0.5-2 MB per image); the kernel is bound by
// shared-memory bandwidth of its float32 FMA loops and by the number of
// blocks in flight. K and V are streamed through shared memory in 16-key
// tiles with the online softmax, so the (seq x seq) matrix never exists at
// any length; offsets are size_t and the grid is (ceil(S / 16), BH), so
// 16384 tokens are well inside its limits (BH <= 65535). At 4096 tokens and
// more the kernel is bound by its float32 FMA loops (no tensor cores), far
// above the bf16 tensor-core bound of 4*BH*S^2*D operations. head_dim 512 is
// above the usual 256 limit: the Q tile (16 x 512) and one K and one V tile
// (16 x 512 each) are held in float32 in ~100 KB of dynamic shared memory,
// past the 48 KB default, so the launch raises the kernel's
// cudaFuncAttributeMaxDynamicSharedMemorySize first. Each thread owns 32 of
// the 16 x 512 float32 output accumulators in registers (d split 16 ways).
//
// Tolerance against the plain version (sr3_tpu_torch/ops/attention.py
// `attention_plain`, float32 einsum-softmax-einsum, TF32 off): 1e-4 of
// max|ref| with float32 and with bfloat16 inputs alike -- both sides widen
// the same inputs to float32 and never round P, the running sums or the
// P.V accumulator back to bf16, so only the order of the float32 sums and
// the rescaling of the online softmax differ.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 16;        // query rows per block
constexpr int kBK = 16;        // keys per shared-memory tile
constexpr int kThreads = 256;  // = kBQ * kBK = 16 rows x 16 d-lanes
constexpr int kDMax = 512;

size_t smem_bytes(int D) {
  const int ld = D + 1;  // padded rows: the 16 keys of a warp hit 16 banks
  return sizeof(float) *
         ((size_t)kBQ * ld + (size_t)kBK * ld + (size_t)kBK * D +
          kBQ * kBK + 3 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int D, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;              // [kBQ][ld], pre-scaled
  float* k_s = q_s + kBQ * ld;    // [kBK][ld]
  float* v_s = k_s + kBK * ld;    // [kBK][D]
  float* p_s = v_s + kBK * D;     // [kBQ][kBK] scores, then probabilities
  float* m_s = p_s + kBQ * kBK;   // [kBQ] running max
  float* l_s = m_s + kBQ;         // [kBQ] running sum
  float* a_s = l_s + kBQ;         // [kBQ] rescale of this tile

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ, tid = threadIdx.x;
  const size_t base = (size_t)bh * S * D;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, qi = q0 + r;
    q_s[r * ld + d] = qi < S ? sr3::to_float(qb[(size_t)qi * D + d]) * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int row = tid / 16, lane = tid % 16;  // output: row, d = lane + 16*j
  const int nd = D / 16;
  float acc[kDMax / 16];
#pragma unroll
  for (int j = 0; j < kDMax / 16; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // q_s ready; the previous tile's k_s/v_s/p_s are free
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < S) {
        kv = sr3::to_float(kb[(size_t)kj * D + d]);
        vv = sr3::to_float(vb[(size_t)kj * D + d]);
      }
      k_s[r * ld + d] = kv;
      v_s[r * D + d] = vv;
    }
    __syncthreads();

    {  // scores: thread (qi, kj) = (tid / kBK, tid % kBK)
      const int qi = tid / kBK, kj = tid % kBK;
      const float* qr = q_s + qi * ld;
      const float* kr = k_s + kj * ld;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[qi * kBK + kj] = (k0 + kj < S) ? s : -INFINITY;
    }
    __syncthreads();

    if (tid < kBQ) {  // online softmax, one thread per query row
      float* pr = p_s + tid * kBK;
      float mx = m_s[tid];
      for (int j = 0; j < kBK; ++j) mx = fmaxf(mx, pr[j]);
      const float alpha = expf(m_s[tid] - mx);
      float sum = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float p = (k0 + j < S) ? expf(pr[j] - mx) : 0.f;
        pr[j] = p;
        sum += p;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = mx;
      a_s[tid] = alpha;
    }
    __syncthreads();

    const float alpha = a_s[row];
    const float* pr = p_s + row * kBK;
#pragma unroll
    for (int j = 0; j < kDMax / 16; ++j)
      if (j < nd) acc[j] *= alpha;
    for (int kj = 0; kj < kBK; ++kj) {
      const float p = pr[kj];
      const float* vr = v_s + kj * D + lane;
#pragma unroll
      for (int j = 0; j < kDMax / 16; ++j)
        if (j < nd) acc[j] = fmaf(p, vr[16 * j], acc[j]);
    }
  }

  const int qi = q0 + row;
  if (qi >= S) return;
  if (lse != nullptr && lane == 0)
    lse[(size_t)bh * S + qi] = m_s[row] + logf(l_s[row]);
  const float inv = 1.f / l_s[row];
  float* ob = o + base + (size_t)qi * D + lane;
#pragma unroll
  for (int j = 0; j < kDMax / 16; ++j)
    if (j < nd) ob[16 * j] = acc[j] * inv;
}

template <typename T>
cudaError_t flash_t(const void* q, const void* k, const void* v, float* o,
                    float* lse, int BH, int S, int D, float scale,
                    cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, lse, S, D, scale);
  return cudaGetLastError();
}

}  // namespace

// o = softmax(q k^T * scale) v. q, k, v: (BH, S, D) of dtype, contiguous;
// o: (BH, S, D) float32; lse: (BH, S) float32 logsumexp of each row of
// q k^T * scale, or null to skip it. D must be a multiple of 16 and at most
// 512, BH at most 65535. Returns the CUDA error code (0 on success).
extern "C" int sr3_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, float* o, float* lse,
                                       int BH, int S, int D, float scale,
                                       int dtype, void* stream) {
  if (D % 16 || D > kDMax || D <= 0 || S <= 0 || BH <= 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sr3::kF32)
    return (int)flash_t<float>(q, k, v, o, lse, BH, S, D, scale, st);
  if (dtype == sr3::kBF16)
    return (int)flash_t<__nv_bfloat16>(q, k, v, o, lse, BH, S, D, scale, st);
  return (int)cudaErrorInvalidValue;
}
