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
// Bound on the card: operations. 4*BH*S^2*D (two products) against
// BH*S*D*(3*2 + 4) bytes: at (2, 4096, 512) 68.7 GFLOP, 0.069 ms on the bf16
// tensor cores (989 TFLOP/s), against 0.009 ms for the bytes. The (S x S)
// matrix never exists at any length: K and V stream through shared memory
// with the online softmax; offsets are size_t, BH <= 65535.
//
// Two routes, chosen by the input dtype in the C entry (as K1's):
//
// * float32: float32 FMAs (no TF32, which keeps ~3 decimal digits). 16-row
//   Q, K and V tiles in ~100 KB of dynamic shared memory, rows padded to
//   D + 1 floats; thread (row, lane) owns 32 output columns; one thread per
//   row runs the softmax. Tolerance against the plain version 1e-4 of
//   max|plain| (only the order of the float32 sums differs).
//
// * bfloat16: the tensor cores (mma.sync m16n8k16, bf16 -> float32). A block
//   of 8 warps owns 64 query rows; its Q tile stays in shared memory as bf16
//   and K / V stream in 32-key tiles through a two-stage ring filled with
//   16-byte cp.async copies, so the next tile's copy overlaps this tile's
//   products (one __syncthreads per tile). Staged rows are padded to D + 8
//   bf16 (a stride of an odd number of 16-byte units), so the eight rows one
//   ldmatrix phase reads fall in distinct banks.
//   Register budget: a 16 x 512 float32 O accumulator is 256 registers a
//   thread in one warp, above the 255 limit, so the two warps of a pair
//   share a 16-row query tile and split O's columns: each owns D/2 columns,
//   128 registers at D = 512. The pair shares S = Q K^T by a split-d partial
//   sum: each warp multiplies its half of D (16 x 32 scores, 16 registers),
//   writes the partial to shared memory, and after a named barrier of the
//   pair adds the other's (2 KB per warp per tile of shared-memory traffic,
//   instead of computing S twice, which would cost 1.5x the operations).
//   Both warps then hold the same S and run the same online softmax on its
//   fragments in registers: row max and row sum by two shuffles among the
//   four threads that share a row; no single-thread phase. The softmax
//   scale 1/sqrt(D) is applied to S in float32 after the product, as the
//   plain version and the TPU kernel do (pre-scaling a bf16 Q would round
//   once more). P is rounded to bf16 in registers and is directly the A
//   operand of P V (the m16n8 C layout is the m16n8k16 A layout); V's B
//   fragments come from ldmatrix.trans. l sums the unrounded P.
//   Shared memory at D = 512: Q 64 x 520 bf16 (66,560 B) + the ring 2 x
//   (K, V) x 32 x 520 bf16 (133,120 B) + the split-d partials 8 x 2 KB =
//   216,064 B of the 232,448 a block may use: one block of 256 threads per
//   SM, (S / 64) * BH blocks (128 at (2, 4096, 512)).
//   Tolerance against the plain version (float32 softmax and products): o
//   within 2e-2 of max|plain| -- P is rounded to bf16 (2^-9 relative) before
//   P V, as FlashAttention does and as neither the plain version nor the
//   TPU kernel (which widens every operand to float32) does; lse within
//   1e-4 -- S is a sum of exact bf16 products in float32 and l sums the
//   unrounded P, so only the order of float32 sums differs.
#include <math.h>

#include "common.cuh"

namespace {

// ------------------------------------------------------------ float32 route

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
  static sr3::SmemLimit limit;
  cudaError_t err = sr3::raise_smem_limit(
      limit, (const void*)flash_fwd_kernel<T>, smem_bytes(kDMax));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T><<<grid, kThreads, smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, lse, S, D, scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------- bfloat16 route

using bf16 = __nv_bfloat16;

constexpr int kMBQ = 64;               // query rows per block
constexpr int kMBK = 32;               // keys per streamed K / V tile
constexpr int kMWarps = 8;             // 4 row groups x 2 column halves
constexpr int kMThreads = 32 * kMWarps;
constexpr int kPad = 8;                // bf16 of padding per staged row
constexpr int kMaxNT = kDMax / 16;     // 8-column O tiles per warp
constexpr int kPartial = 16 * kMBK;    // floats of one warp's partial S

size_t mma_smem_bytes(int D) {
  const size_t ld = D + kPad;
  return sizeof(bf16) * (kMBQ + 2 * 2 * kMBK) * ld +
         sizeof(float) * kMWarps * kPartial;
}

__global__ void __launch_bounds__(kMThreads, 1)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int D, float scale) {
  extern __shared__ uint4 mma_smem[];
  const int ld = D + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(mma_smem);  // [kMBQ][ld]
  bf16* ring = q_s + kMBQ * ld;                   // [2][K, V][kMBK][ld]
  float* part = reinterpret_cast<float*>(ring + 2 * 2 * kMBK * ld);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = warp / 2, ch = warp % 2;  // rows 16rg.., column half
  const int gid = lane / 4, tig = lane % 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * kMBQ;
  const size_t base = (size_t)bh * S * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  // this warp's k-steps of Q K^T (over D) and 8-column tiles of O
  const int nks = D / 16, ks0 = ch * nks / 2, ks1 = (ch + 1) * nks / 2;
  const int nnt = D / 16, col0 = ch * (D / 2);
  const int ntiles = (S + kMBK - 1) / kMBK;

  sr3::stage_rows<kMBQ, kMThreads>(q_s, q + base, q0, S, D, ld);
  sr3::stage_rows<kMBK, kMThreads>(ring, kb, 0, S, D, ld);
  sr3::stage_rows<kMBK, kMThreads>(ring + kMBK * ld, vb, 0, S, D, ld);
  sr3::cp_async_commit();

  float acc[kMaxNT][4];
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // ldmatrix row addresses: A (16 rows x 16 k) and B (2 x 8 keys x 16 k)
  const bf16* qa = q_s + (16 * rg + lane % 16) * ld + 8 * (lane / 16);
  const int kb_off = ((lane % 8) + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2);
  float* mine = part + warp * kPartial + lane;
  const float* other = part + (warp ^ 1) * kPartial + lane;

  for (int t = 0; t < ntiles; ++t) {
    sr3::cp_async_wait<0>();
    __syncthreads();  // tile t landed for all; tile t - 1's stage is free
    if (t + 1 < ntiles) {
      bf16* next = ring + ((t + 1) % 2) * 2 * kMBK * ld;
      const int k1 = (t + 1) * kMBK;
      sr3::stage_rows<kMBK, kMThreads>(next, kb, k1, S, D, ld);
      sr3::stage_rows<kMBK, kMThreads>(next + kMBK * ld, vb, k1, S, D, ld);
      sr3::cp_async_commit();
    }
    const bf16* k_s = ring + (t % 2) * 2 * kMBK * ld;
    const bf16* v_s = k_s + kMBK * ld;

    // this warp's half-D partial of S (16 rows x 32 keys)
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int ks = ks0; ks < ks1; ++ks) {
      uint32_t a[4], b[4];
      sr3::ldmatrix_x4(a, qa + 16 * ks);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        sr3::ldmatrix_x4(b, k_s + 16 * jp * ld + kb_off + 16 * ks);
        sr3::mma_bf16(s[2 * jp], a, b[0], b[1]);
        sr3::mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) mine[32 * i] = s[i / 4][i % 4];
    sr3::bar_sync(1 + rg, 64);
    const int key0 = t * kMBK + 2 * tig;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = key0 + 8 * (i / 4) + (i % 2);
      const float full = s[i / 4][i % 4] + other[32 * i];
      s[i / 4][i % 4] = key < S ? full * scale : -INFINITY;
    }

    // online softmax on the fragments: row gid (r = 0), row gid + 8 (r = 1)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i / 4][i % 4]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i % 4) / 2;
      const float p = expf(s[i / 4][i % 4] - mx[r]);
      s[i / 4][i % 4] = p;
      sum[r] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }

    // O = O * alpha + P V over this warp's columns; P rounded to bf16
    uint32_t pa[2][4];  // keys 0-15, 16-31
    sr3::c_to_a(pa[0], s[0], s[1]);
    sr3::c_to_a(pa[1], s[2], s[3]);
    const bf16* vt = v_s + lane * ld + col0;
#pragma unroll
    for (int nt = 0; nt < kMaxNT; ++nt) {
      if (nt < nnt) {
        acc[nt][0] *= alpha[0];
        acc[nt][1] *= alpha[0];
        acc[nt][2] *= alpha[1];
        acc[nt][3] *= alpha[1];
        uint32_t b[4];
        sr3::ldmatrix_x4_trans(b, vt + 8 * nt);
        sr3::mma_bf16(acc[nt], pa[0], b[0], b[1]);
        sr3::mma_bf16(acc[nt], pa[1], b[2], b[3]);
      }
    }
  }

  const int row0 = q0 + 16 * rg + gid;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
    if (lse != nullptr && ch == 0 && tig == 0)
      lse[(size_t)bh * S + qi] = m[r] + logf(l[r]);
    const float inv = 1.f / l[r];
    float* orow = o + base + (size_t)qi * D + col0 + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < kMaxNT; ++nt)
      if (nt < nnt)
        *reinterpret_cast<float2*>(orow + 8 * nt) =
            make_float2(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
  }
}

cudaError_t flash_mma(const void* q, const void* k, const void* v, float* o,
                      float* lse, int BH, int S, int D, float scale,
                      cudaStream_t stream) {
  // 16-byte cp.async copies: every row starts 16-byte aligned (D % 16 == 0)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorInvalidValue;
  static sr3::SmemLimit limit;
  cudaError_t err = sr3::raise_smem_limit(
      limit, (const void*)flash_fwd_mma_kernel, mma_smem_bytes(kDMax));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kMBQ - 1) / kMBQ, BH);
  flash_fwd_mma_kernel<<<grid, kMThreads, mma_smem_bytes(D), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), o, lse, S, D, scale);
  return cudaGetLastError();
}

}  // namespace

// o = softmax(q k^T * scale) v. q, k, v: (BH, S, D) of dtype, contiguous
// (bfloat16: 16-byte aligned); o: (BH, S, D) float32; lse: (BH, S) float32
// logsumexp of each row of q k^T * scale, or null to skip it. D must be a
// multiple of 16 and at most 512, BH at most 65535. float32 runs the FMA
// route, bfloat16 the tensor-core route. Returns the CUDA error code (0 on
// success).
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
    return (int)flash_mma(q, k, v, o, lse, BH, S, D, scale, st);
  return (int)cudaErrorInvalidValue;
}
