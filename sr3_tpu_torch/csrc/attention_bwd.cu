// K5 / K6: flash-attention backward, non-causal.
//
// K5 replaces sr3_tpu/ops/attention.py:163 `_flash_bwd_dkv_kernel` (the
// first pallas_call of `attention_flash_bwd`, :254): one block owns a tile
// of keys, streams tiles of Q and dO, rebuilds the probabilities
// P = exp(q k^T * scale - lse) from the forward's logsumexp, and accumulates
// dV += P^T dO and dK += dS^T Q with dS = P (dO v^T - dsum) * scale.
// K6 replaces `_flash_bwd_dq_kernel` (:203, the pallas_call at :273): one
// block owns a tile of queries (Q, dO, lse, dsum), streams K and V tiles
// and accumulates dQ += dS K. Neither kernel ever holds the (S x S) matrix:
// each tile of P and dS lives for one step, so the same code runs at any
// length; offsets are size_t. Each block writes its own rows of dK, dV or
// dQ in float32, with no atomics: the same results on every run.
//
// On the 16->128 training path the shapes are (BH, S, D) = (B, 256, 512)
// and (B, 64, 512), scale 1/sqrt(512), six calls of each per train step; on
// the 64->512 path (2, 4096, 512) three times and (2, 1024, 512) four times
// per step. Bound on the card: operations, 8*BH*S^2*D for K5 (four
// products) and 6*BH*S^2*D for K6; at (2, 4096, 512) K5's 137 GFLOP take
// 0.139 ms on the bf16 tensor cores.
//
// Float32 route (K5 and K6 on float32 inputs): float32 FMAs. Each
// block streams 16-row tiles; the four 16 x 512 float32 tiles (own Q or K,
// own dO or V, and the two streamed ones) take 131 KB of dynamic shared
// memory, rows padded to D + 1 floats so the 16 rows a warp reads in the
// dot products fall in 16 banks; each thread owns row r = tid / 16 and
// d = tid % 16 + 16 j of its outputs (32 floats for dQ; 64 for dK and dV);
// the grid is (ceil(S / 16), BH). Bound in practice by the shared-memory
// loads of the FMA loops (two per FMA). Tolerance against the plain version
// (`attention_bwd_plain`, float32 einsums, TF32 off): 1e-4 of max|plain| --
// both sides widen the same inputs to float32 and keep P, dS and the
// accumulators in float32; only the order of the float32 sums differs.
//
// K5's bfloat16 route: the tensor cores (mma.sync m16n8k16, bf16 ->
// float32). A block of 8 warps owns 32 keys; its K and V tiles stay in
// shared memory as bf16, and 32-query tiles of Q and dO stream through a
// two-stage ring filled with 16-byte cp.async copies (the next tile's copy
// overlaps this tile's products; one __syncthreads per tile); lse and dsum
// of a thread's 8 query columns come straight from global memory. dO
// arrives in bf16: the wrapper rounds the float32 output gradient once, for
// K5 and K6 alike (dsum still comes from the float32 one). Staged rows are
// padded to D + 8 bf16, so ldmatrix reads are free of bank conflicts.
//   Products: S^T = K Q^T and dP^T = V dO^T (16 keys x 32 queries per warp),
// then P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T - dsum) * scale in
// float32 registers; P^T and dS^T are rounded to bf16 and used directly as
// the A operands (the m16n8 C layout is the m16n8k16 A layout) of
// dV += P^T dO and dK += dS^T Q, whose B fragments come from ldmatrix.trans
// of the same dO and Q tiles.
//   Register budget: dK and dV for 16 keys x 512 columns would be 512
// registers a thread in one warp, so the accumulator columns are split: warp
// w owns key group w / 4 (16 keys) and the w % 4-th quarter of the 8-column
// tiles of both dK and dV (16 keys x 128 columns each at D = 512: 128
// registers). S^T and dP^T are split-d partial products: each of the four
// warps of a key group multiplies its quarter of D, and the partials are
// summed through shared memory (2 KB per warp, used first for S^T then for
// dP^T, with named barriers of the group's 128 threads), in the same order
// in every warp, so the four hold identical P^T and dS^T.
//   Shared memory at D = 512: K and V 2 x 32 x 520 bf16 (66,560 B) + the
// ring 2 x (Q, dO) x 32 x 520 bf16 (133,120 B) + partials 8 x 2 KB =
// 216,064 B: one block of 256 threads per SM, (S / 32) * BH blocks (256 at
// (2, 4096, 512)).
//   Tolerance against the plain version: dK and dV within 2e-2 of
// max|plain| -- dO, P and dS are rounded to bf16 (2^-9 relative) before
// their products, as FlashAttention does; the plain version and the TPU
// kernel (which widens every operand to float32) keep them in float32.
//
// K6's bfloat16 route: K5's design with the roles of queries and keys
// swapped (flash_bwd_dq_mma_kernel below). A block of 8 warps owns 32
// queries, whose Q and dO rows stay in shared memory; 32-key tiles of K and
// V stream through the same two-stage cp.async ring, one __syncthreads per
// tile. S = Q K^T and dP = dO V^T are split-d partials summed by group_sum;
// P = exp(S * scale - lse) and dS = P (dP - dsum) * scale in float32
// registers (the scale applied after the product), dS rounded to bf16 as
// the A operand of dQ += dS K, whose B fragments come from ldmatrix.trans of
// the K tile. Three products per key tile against K5's four; the same
// 216,064 B of shared memory at D = 512 (Q, dO 66,560 B, the K / V ring
// 133,120 B, partials 16 KB); (S / 32) * BH blocks, so at (2, 1024, 512)
// its 64 blocks leave half of the card's 132 SMs idle (a split over keys
// would need a second reduction pass to stay free of atomics). Bound as
// K5: 6*BH*S^2*D operations, 0.104 ms at (2, 4096, 512) on the tensor
// cores; in practice the fragment loads from shared memory and the group
// sums set the pace, as in K4 and K5.
//   Tolerance: dQ within 2e-2 of max|plain| -- dO and dS are rounded to bf16
// before their products, which neither the plain version nor the TPU kernel
// does (1e-4 while K6 computed in float32; the float32 route stays at 1e-4).
//
// ptxas (sm_90a, CUDA 12.8, as chip_smoke.py's build phase prints it):
// flash_bwd_dkv_mma_kernel 248 registers, flash_bwd_dq_mma_kernel 195, the
// float32 kernels 98 (dK/dV) and 74 (dQ); no spills.
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

template <typename T>
cudaError_t dkv_t(const void* q, const void* k, const void* v, const float* g,
                  const float* lse, const float* dsum, float* dk, float* dv,
                  int BH, int S, int D, float scale, cudaStream_t stream) {
  static sr3::SmemLimit limit;
  cudaError_t err = sr3::raise_smem_limit(
      limit, (const void*)flash_bwd_dkv_kernel<T>, smem_bytes(kDMax));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kB - 1) / kB, BH);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), g, lse, dsum, dk, dv, S, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_t(const void* q, const void* k, const void* v, const float* g,
                 const float* lse, const float* dsum, float* dq, int BH, int S,
                 int D, float scale, cudaStream_t stream) {
  static sr3::SmemLimit limit;
  cudaError_t err = sr3::raise_smem_limit(
      limit, (const void*)flash_bwd_dq_kernel<T>, smem_bytes(kDMax));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kB - 1) / kB, BH);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), g, lse, dsum, dq, S, D, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------ K5, bfloat16 route

using bf16 = __nv_bfloat16;

constexpr int kMBK = 32;                 // keys per block: 2 groups of 16
constexpr int kMBQ = 32;                 // queries per streamed tile
constexpr int kMWarps = 8;               // 2 key groups x 4 column quarters
constexpr int kMThreads = 32 * kMWarps;
constexpr int kPad = 8;                  // bf16 of padding per staged row
constexpr int kMaxNT = kDMax / 8 / 4;    // 8-column dK / dV tiles per warp
constexpr int kPartial = 16 * kMBQ;      // floats of one warp's partial

size_t dkv_mma_smem_bytes(int D) {
  const size_t ld = D + kPad;
  return sizeof(bf16) * (2 * kMBK + 2 * 2 * kMBQ) * ld +
         sizeof(float) * kMWarps * kPartial;
}

// This warp's partial (16 x 32 floats) into shared memory, a named barrier
// of the key group, then the group's four partials summed in warp order.
__device__ __forceinline__ void group_sum(float (*x)[4], float* mine,
                                          const float* group, int bar) {
#pragma unroll
  for (int i = 0; i < 16; ++i) mine[32 * i] = x[i / 4][i % 4];
  sr3::bar_sync(bar, 128);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i / 4][i % 4] = group[32 * i] + group[kPartial + 32 * i] +
                      group[2 * kPartial + 32 * i] +
                      group[3 * kPartial + 32 * i];
}

__global__ void __launch_bounds__(kMThreads, 1)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ dsum,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int S, int D, float scale) {
  extern __shared__ uint4 mma_smem[];
  const int ld = D + kPad;
  bf16* k_s = reinterpret_cast<bf16*>(mma_smem);  // [kMBK][ld]
  bf16* v_s = k_s + kMBK * ld;                    // [kMBK][ld]
  bf16* ring = v_s + kMBK * ld;                   // [2][Q, dO][kMBQ][ld]
  float* part = reinterpret_cast<float*>(ring + 2 * 2 * kMBQ * ld);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kg = warp / 4, qt = warp % 4;  // key group, column quarter
  const int gid = lane / 4, tig = lane % 4;
  const int bh = blockIdx.y, k0 = blockIdx.x * kMBK;
  const size_t base = (size_t)bh * S * D;
  const bf16* qb = q + base;
  const bf16* gb = g + base;
  const float* lb = lse + (size_t)bh * S;
  const float* db = dsum + (size_t)bh * S;
  // this warp's k-steps of S^T, dP^T (over D) and 8-column dK / dV tiles
  const int nks = D / 16, ks0 = qt * nks / 4, ks1 = (qt + 1) * nks / 4;
  const int nnt = D / 8, nt0 = qt * nnt / 4, nt1 = (qt + 1) * nnt / 4;
  const int ntiles = (S + kMBQ - 1) / kMBQ;

  sr3::stage_rows<kMBK, kMThreads>(k_s, k + base, k0, S, D, ld);
  sr3::stage_rows<kMBK, kMThreads>(v_s, v + base, k0, S, D, ld);
  sr3::stage_rows<kMBQ, kMThreads>(ring, qb, 0, S, D, ld);
  sr3::stage_rows<kMBQ, kMThreads>(ring + kMBQ * ld, gb, 0, S, D, ld);
  sr3::cp_async_commit();

  float acc_k[kMaxNT][4], acc_v[kMaxNT][4];
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  // ldmatrix row addresses: A (16 keys x 16 d), B (2 x 8 queries x 16 d)
  const int a_off = (16 * kg + lane % 16) * ld + 8 * (lane / 16);
  const int b_off = ((lane % 8) + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2);
  float* mine = part + warp * kPartial + lane;
  const float* group = part + 4 * kg * kPartial + lane;
  const int key0 = k0 + 16 * kg + gid;  // keys of C rows gid, gid + 8

  for (int t = 0; t < ntiles; ++t) {
    sr3::cp_async_wait<0>();
    __syncthreads();  // tile t landed for all; tile t - 1's stage is free
    if (t + 1 < ntiles) {
      bf16* next = ring + ((t + 1) % 2) * 2 * kMBQ * ld;
      const int q1 = (t + 1) * kMBQ;
      sr3::stage_rows<kMBQ, kMThreads>(next, qb, q1, S, D, ld);
      sr3::stage_rows<kMBQ, kMThreads>(next + kMBQ * ld, gb, q1, S, D, ld);
      sr3::cp_async_commit();
    }
    const bf16* q_s = ring + (t % 2) * 2 * kMBQ * ld;
    const bf16* g_s = q_s + kMBQ * ld;
    const int qcol = t * kMBQ + 2 * tig;  // query of C column 2 * tig

    // lse and dsum of this thread's query columns 8 j + 2 tig + e
    float lq[8], dsq[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int qi = qcol + 8 * (c / 2) + c % 2;
      lq[c] = qi < S ? lb[qi] : 0.f;
      dsq[c] = qi < S ? db[qi] : 0.f;
    }

    // this warp's quarter-D partials of S^T and dP^T (16 keys x 32 queries)
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll 2
    for (int ks = ks0; ks < ks1; ++ks) {
      uint32_t ak[4], av[4], b[4];
      sr3::ldmatrix_x4(ak, k_s + a_off + 16 * ks);
      sr3::ldmatrix_x4(av, v_s + a_off + 16 * ks);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        sr3::ldmatrix_x4(b, q_s + 16 * jp * ld + b_off + 16 * ks);
        sr3::mma_bf16(st[2 * jp], ak, b[0], b[1]);
        sr3::mma_bf16(st[2 * jp + 1], ak, b[2], b[3]);
        sr3::ldmatrix_x4(b, g_s + 16 * jp * ld + b_off + 16 * ks);
        sr3::mma_bf16(dpt[2 * jp], av, b[0], b[1]);
        sr3::mma_bf16(dpt[2 * jp + 1], av, b[2], b[3]);
      }
    }
    group_sum(st, mine, group, 1 + kg);
    sr3::bar_sync(1 + kg, 128);  // the group has read the S^T partials
    group_sum(dpt, mine, group, 1 + kg);

    // P^T and dS^T in float32; masked keys and queries give 0
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = i / 4, e = i % 4, c = 2 * j + e % 2;
      const bool ok = key0 + 8 * (e / 2) < S && qcol + 8 * j + e % 2 < S;
      const float p = ok ? expf(st[j][e] * scale - lq[c]) : 0.f;
      st[j][e] = p;
      dpt[j][e] = p * (dpt[j][e] - dsq[c]) * scale;
    }
    uint32_t pa[2][4], da[2][4];  // queries 0-15, 16-31
    sr3::c_to_a(pa[0], st[0], st[1]);
    sr3::c_to_a(pa[1], st[2], st[3]);
    sr3::c_to_a(da[0], dpt[0], dpt[1]);
    sr3::c_to_a(da[1], dpt[2], dpt[3]);

    // dV += P^T dO and dK += dS^T Q over this warp's columns
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i) {
      if (nt0 + i < nt1) {
        const int col = 8 * (nt0 + i);
        uint32_t b[4];
        sr3::ldmatrix_x4_trans(b, g_s + lane * ld + col);
        sr3::mma_bf16(acc_v[i], pa[0], b[0], b[1]);
        sr3::mma_bf16(acc_v[i], pa[1], b[2], b[3]);
        sr3::ldmatrix_x4_trans(b, q_s + lane * ld + col);
        sr3::mma_bf16(acc_k[i], da[0], b[0], b[1]);
        sr3::mma_bf16(acc_k[i], da[1], b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
    const size_t row = base + (size_t)key * D + 2 * tig;
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i) {
      if (nt0 + i < nt1) {
        const size_t at = row + 8 * (nt0 + i);
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(acc_k[i][2 * r], acc_k[i][2 * r + 1]);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(acc_v[i][2 * r], acc_v[i][2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------ K6, bfloat16 route
//
// The mirror of K5's design with the queries resident: a block of 8 warps
// owns 32 queries, whose Q and dO rows stay in shared memory; 32-key tiles
// of K and V stream through the two-stage cp.async ring. Warp w owns query
// group w / 4 (16 queries) and the w % 4-th quarter of dQ's 8-column tiles
// (16 x 128 float32 at D = 512: 64 registers a thread). S = Q K^T and
// dP = dO V^T are split-d partials over the warp's quarter of D, summed by
// group_sum as in K5; P and dS follow in float32 registers, and dS, rounded
// to bf16, is the A operand of dQ += dS K, whose B fragments come from
// ldmatrix.trans of the same K tile.
constexpr int kQBQ = 32;  // queries per block: 2 groups of 16
constexpr int kQBK = 32;  // keys per streamed tile

size_t dq_mma_smem_bytes(int D) {
  const size_t ld = D + kPad;
  return sizeof(bf16) * (2 * kQBQ + 2 * 2 * kQBK) * ld +
         sizeof(float) * kMWarps * kPartial;
}

__global__ void __launch_bounds__(kMThreads, 1)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ g,
                            const float* __restrict__ lse,
                            const float* __restrict__ dsum,
                            float* __restrict__ dq, int S, int D,
                            float scale) {
  extern __shared__ uint4 mma_smem[];
  const int ld = D + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(mma_smem);  // [kQBQ][ld]
  bf16* g_s = q_s + kQBQ * ld;                    // [kQBQ][ld] dO
  bf16* ring = g_s + kQBQ * ld;                   // [2][K, V][kQBK][ld]
  float* part = reinterpret_cast<float*>(ring + 2 * 2 * kQBK * ld);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qg = warp / 4, qt = warp % 4;  // query group, column quarter
  const int gid = lane / 4, tig = lane % 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * kQBQ;
  const size_t base = (size_t)bh * S * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  // this warp's k-steps of S, dP (over D) and 8-column dQ tiles
  const int nks = D / 16, ks0 = qt * nks / 4, ks1 = (qt + 1) * nks / 4;
  const int nnt = D / 8, nt0 = qt * nnt / 4, nt1 = (qt + 1) * nnt / 4;
  const int ntiles = (S + kQBK - 1) / kQBK;

  sr3::stage_rows<kQBQ, kMThreads>(q_s, q + base, q0, S, D, ld);
  sr3::stage_rows<kQBQ, kMThreads>(g_s, g + base, q0, S, D, ld);
  sr3::stage_rows<kQBK, kMThreads>(ring, kb, 0, S, D, ld);
  sr3::stage_rows<kQBK, kMThreads>(ring + kQBK * ld, vb, 0, S, D, ld);
  sr3::cp_async_commit();

  float acc[kMaxNT][4];
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // lse and dsum of this thread's query rows gid, gid + 8
  const int query0 = q0 + 16 * qg + gid;
  float lq[2], dsq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = query0 + 8 * r;
    lq[r] = qi < S ? lse[(size_t)bh * S + qi] : 0.f;
    dsq[r] = qi < S ? dsum[(size_t)bh * S + qi] : 0.f;
  }

  // ldmatrix row addresses: A (16 queries x 16 d), B (2 x 8 keys x 16 d)
  const int a_off = (16 * qg + lane % 16) * ld + 8 * (lane / 16);
  const int b_off = ((lane % 8) + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2);
  float* mine = part + warp * kPartial + lane;
  const float* group = part + 4 * qg * kPartial + lane;

  for (int t = 0; t < ntiles; ++t) {
    sr3::cp_async_wait<0>();
    __syncthreads();  // tile t landed for all; tile t - 1's stage is free
    if (t + 1 < ntiles) {
      bf16* next = ring + ((t + 1) % 2) * 2 * kQBK * ld;
      const int k1 = (t + 1) * kQBK;
      sr3::stage_rows<kQBK, kMThreads>(next, kb, k1, S, D, ld);
      sr3::stage_rows<kQBK, kMThreads>(next + kQBK * ld, vb, k1, S, D, ld);
      sr3::cp_async_commit();
    }
    const bf16* k_s = ring + (t % 2) * 2 * kQBK * ld;
    const bf16* v_s = k_s + kQBK * ld;
    const int kcol = t * kQBK + 2 * tig;  // key of C column 2 * tig

    // this warp's quarter-D partials of S and dP (16 queries x 32 keys)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
    for (int ks = ks0; ks < ks1; ++ks) {
      uint32_t aq[4], ag[4], b[4];
      sr3::ldmatrix_x4(aq, q_s + a_off + 16 * ks);
      sr3::ldmatrix_x4(ag, g_s + a_off + 16 * ks);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        sr3::ldmatrix_x4(b, k_s + 16 * jp * ld + b_off + 16 * ks);
        sr3::mma_bf16(s[2 * jp], aq, b[0], b[1]);
        sr3::mma_bf16(s[2 * jp + 1], aq, b[2], b[3]);
        sr3::ldmatrix_x4(b, v_s + 16 * jp * ld + b_off + 16 * ks);
        sr3::mma_bf16(dp[2 * jp], ag, b[0], b[1]);
        sr3::mma_bf16(dp[2 * jp + 1], ag, b[2], b[3]);
      }
    }
    group_sum(s, mine, group, 1 + qg);
    sr3::bar_sync(1 + qg, 128);  // the group has read the S partials
    group_sum(dp, mine, group, 1 + qg);

    // P and dS in float32; masked queries and keys give 0
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = i / 4, e = i % 4, r = e / 2;
      const bool ok = query0 + 8 * r < S && kcol + 8 * j + e % 2 < S;
      const float p = ok ? expf(s[j][e] * scale - lq[r]) : 0.f;
      dp[j][e] = p * (dp[j][e] - dsq[r]) * scale;
    }
    uint32_t da[2][4];  // keys 0-15, 16-31
    sr3::c_to_a(da[0], dp[0], dp[1]);
    sr3::c_to_a(da[1], dp[2], dp[3]);

    // dQ += dS K over this warp's columns
    const bf16* kt = k_s + lane * ld;
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i) {
      if (nt0 + i < nt1) {
        uint32_t b[4];
        sr3::ldmatrix_x4_trans(b, kt + 8 * (nt0 + i));
        sr3::mma_bf16(acc[i], da[0], b[0], b[1]);
        sr3::mma_bf16(acc[i], da[1], b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = query0 + 8 * r;
    if (qi >= S) continue;
    float* row = dq + base + (size_t)qi * D + 2 * tig;
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i)
      if (nt0 + i < nt1)
        *reinterpret_cast<float2*>(row + 8 * (nt0 + i)) =
            make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

// 16-byte cp.async copies: every row starts 16-byte aligned (D % 16 == 0)
bool misaligned(const void* q, const void* k, const void* v, const void* g) {
  return (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g)) %
         16;
}

cudaError_t dkv_mma(const void* q, const void* k, const void* v,
                    const void* g, const float* lse, const float* dsum,
                    float* dk, float* dv, int BH, int S, int D, float scale,
                    cudaStream_t stream) {
  if (misaligned(q, k, v, g)) return cudaErrorInvalidValue;
  static sr3::SmemLimit limit;
  cudaError_t err = sr3::raise_smem_limit(
      limit, (const void*)flash_bwd_dkv_mma_kernel, dkv_mma_smem_bytes(kDMax));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kMBK - 1) / kMBK, BH);
  flash_bwd_dkv_mma_kernel<<<grid, kMThreads, dkv_mma_smem_bytes(D),
                             stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, dsum, dk,
      dv, S, D, scale);
  return cudaGetLastError();
}

cudaError_t dq_mma(const void* q, const void* k, const void* v,
                   const void* g, const float* lse, const float* dsum,
                   float* dq, int BH, int S, int D, float scale,
                   cudaStream_t stream) {
  if (misaligned(q, k, v, g)) return cudaErrorInvalidValue;
  static sr3::SmemLimit limit;
  cudaError_t err = sr3::raise_smem_limit(
      limit, (const void*)flash_bwd_dq_mma_kernel, dq_mma_smem_bytes(kDMax));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kQBQ - 1) / kQBQ, BH);
  flash_bwd_dq_mma_kernel<<<grid, kMThreads, dq_mma_smem_bytes(D), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, dsum, dq,
      S, D, scale);
  return cudaGetLastError();
}

bool bad_shape(int BH, int S, int D) {
  return D % 16 || D > kDMax || D <= 0 || S <= 0 || BH <= 0 || BH > 65535;
}

}  // namespace

// K5: dk, dv of softmax(q k^T * scale) v. q, k, v: (BH, S, D) of dtype; g
// (= dO): (BH, S, D) of dtype too (float32 route: float32; bfloat16 route:
// the output gradient rounded to bf16); dk, dv: (BH, S, D) float32; lse (the
// forward's logsumexp of q k^T * scale) and dsum (= rowsum(dO * O), from the
// float32 dO): (BH, S) float32; all contiguous, bf16 operands 16-byte
// aligned. D must be a multiple of 16 and at most 512. Returns the CUDA
// error code.
extern "C" int sr3_flash_attention_bwd_dkv(const void* q, const void* k,
                                           const void* v, const void* g,
                                           const float* lse, const float* dsum,
                                           float* dk, float* dv, int BH, int S,
                                           int D, float scale, int dtype,
                                           void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sr3::kF32)
    return (int)dkv_t<float>(q, k, v, static_cast<const float*>(g), lse, dsum,
                             dk, dv, BH, S, D, scale, st);
  if (dtype == sr3::kBF16)
    return (int)dkv_mma(q, k, v, g, lse, dsum, dk, dv, BH, S, D, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K6: dq, with the operands of K5 (g of dtype too); dq: (BH, S, D) float32.
extern "C" int sr3_flash_attention_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* g,
                                          const float* lse, const float* dsum,
                                          float* dq, int BH, int S, int D,
                                          float scale, int dtype,
                                          void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sr3::kF32)
    return (int)dq_t<float>(q, k, v, static_cast<const float*>(g), lse, dsum,
                            dq, BH, S, D, scale, st);
  if (dtype == sr3::kBF16)
    return (int)dq_mma(q, k, v, g, lse, dsum, dq, BH, S, D, scale, st);
  return (int)cudaErrorInvalidValue;
}
