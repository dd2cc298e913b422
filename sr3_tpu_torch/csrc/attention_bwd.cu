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
// bfloat16 routes of K5 and K6: flash_bwd_wgmma_kernel, one kernel
// template for Hopper with one instantiation per (kernel, head_dim class),
// and flash_bwd_merge_kernel after a split. The two stay two kernels, as on
// the TPU: a fused backward that adds dQ across key blocks by atomics would
// change its sums' order from run to run. Both kernels have one shape: a
// block keeps `rows` resident rows (K5: K and V; K6: Q and dO) and streams
// tiles of BN rows of the other pair (K5: Q and dO; K6: K and V); per tile
// X = R1 B1^T (S^T = K Q^T; S = Q K^T) and Y = R2 B2^T (dP^T = V dO^T;
// dP = dO V^T), then P = exp(X * scale - lse), dS = P (Y - dsum) * scale,
// and dV += P^T dO, dK += dS^T Q (K5) or dQ += dS K (K6). What held the
// mma.sync kernels they replace at 3-12% of their bounds, and
// what this design does about each:
//   1. Pre-Hopper products (mma.sync from single warps, every operand
//      through ldmatrix into registers). Now wgmma.mma_async m64nNk16 by
//      warpgroups: X and Y read both operands from shared memory by
//      descriptor; P and dS are formed in float32 on the accumulator
//      fragments, rounded to bf16 in registers and are the A operands of
//      the output products, whose B (dO, Q, K) is read MN-major by a
//      transposed descriptor: no transposing copy.
//   2. One tiling for every head_dim. Now a class per head_dim, DC = 64,
//      128, 256, 512 columns (every D the wrapper takes, a multiple of 16
//      up to 512, runs at the next class up; TMA zero-fills the columns
//      past D, which are never stored). The register file decides the
//      tiling: a consumer warpgroup's 64 x N float32 accumulator is N / 2
//      registers a thread, under 232 after setmaxnreg.
//        K5 <DC, BN, rows>: <64, 64, 128>, <128, 64, 128>: each warpgroup
//        owns 64 keys and holds dK and dV, 2 x DC / 2 = DC registers
//        (128 at D = 128) beside S^T and dP^T (BN / 2 each). <256, 32, 64>:
//        dK and dV of 64 keys at D = 256 would be 256 registers, so the two
//        warpgroups share the 64 keys and own 128 columns each (128
//        registers). <512, 32, 64>: even split, dK and dV of 64 keys x 256
//        columns are 256 registers a thread -- 64 keys x 512 x 2 outputs x
//        4 B is the SM's whole 256 KB register file -- so the block makes
//        two passes over the queries, dV then dK, each in 128 registers
//        (1.25x the products: S^T again in the second pass). Chosen over a
//        2-CTA cluster exchanging split-d partials through distributed
//        shared memory (two blocks, each holding K and V, in lockstep
//        across SMs) and over dK^T / dV^T with D as the wgmma M dimension
//        (P and dS would have to pass through shared memory as B).
//        K6 <DC, BN, rows>: <64, 128, 128>, <128, 64, 128>, <256, 64, 128>:
//        each warpgroup owns 64 queries and dQ, DC / 2 registers;
//        <512, 32, 64>: a 64 x 512 dQ tile is 256 registers, so the two
//        warpgroups share 64 queries and own 256 columns each.
//      Shared memory: the resident tiles (2 x rows x DC bf16: 128 KB at
//      D = 512), rings of as many stages of the streamed pair as fit, up to
//      4 (D = 512: one stage of 32 rows, 64 KB; K6 <256>: one stage of 64
//      rows; K5 <256>: four of 32 -- one stage of 64 measured 2.5-5.9%
//      slower at 16384 tokens and 19-22% at 16 in two runs on an H100 SXM,
//      sr3_tpu_torch/attention_variants.py bwd), the exchange below,
//      barriers; at most 230,912 B. Where S is shorter than a row tile,
//      the resident boxes shrink to S rounded up to 8 rows (fewer
//      zero-filled bytes: K6 at 8x16x256 0.0063 -> 0.0057 ms on the same
//      card).
//      Where the ring has one stage, the streamed operand the consumers
//      release first is loaded first and used first (Y before X), so the
//      next tile's copy overlaps the products that remain.
//   3. Split-d partial products at every D. Now only where a warpgroup
//      cannot hold its rows' whole output (K5 at 256 and 512, K6 at 512):
//      each warpgroup multiplies half of D for X and Y, and the two
//      partials are added through shared memory between named barriers
//      (a + b == b + a: both warpgroups hold the same X and Y and form the
//      same P and dS), as K4's <512,64> class does for S.
//   4. Grids under one wave, nothing split. Where the blocks of a call
//      (row tiles x BH) fill at most a quarter of the SMs, the streamed tiles
//      are split (bwd_plan: K5 splits the queries, K6 the keys) into splits
//      of at least kMinSplitTiles tiles (K4's measured lesson: shorter
//      splits cost more in the merge than the blocks gain); block z runs
//      tiles [z * per, (z + 1) * per) and writes its float32 partial sums
//      to the workspace, and flash_bwd_merge_kernel adds them in split
//      order (no atomics: two calls give the same bits).
//   5. Copies issued by every thread. Now one producer warp: one thread
//      issues TMA tiled loads (cp.async.bulk.tensor, 128-byte swizzle, the
//      layout the descriptors read) of the resident pair once and of the
//      streamed pair into the ring under mbarriers (full: TMA bytes landed
//      and, in K5, the 32 lanes' lse * log2(e) and dsum of the tile's
//      queries -- +inf and 0 past S, so P and dS are exactly 0 there;
//      empty: the 8 consumer warps are done with the stage), the two
//      operands with separate barriers. K6 keeps its rows' lse and dsum in
//      registers and masks keys past S. The producer warpgroup gives its
//      registers to the consumers (setmaxnreg 40 / 232).
//   Bound on the card: operations. K5 8*BH*S^2*D (four products), K6
//   6*BH*S^2*D (three): at (2, 4096, 512) 137 and 103 GFLOP, 0.139 and
//   0.104 ms on the bf16 tensor cores, against ~0.02 ms for the bytes. K5
//   and K6 recompute S and dP in both kernels: 14*BH*S^2*D operations
//   against a fused backward's 10.
//   Rounding: dO arrives in bf16 (the wrapper rounds the float32 output
//   gradient once, for K5 and K6 alike; dsum still comes from the float32
//   one); X and Y are sums of exact bf16 products in float32; the scale is
//   applied after the product (in the base-2 exponent: exp2(X * scale *
//   log2(e) - lse * log2(e))); P and dS are rounded to bf16 before their
//   products. Tolerance against the plain version (float32 einsums): dk,
//   dv and dq within 2e-2 of max|plain| -- dO, P and dS are rounded to
//   bf16 (2^-9 relative), as FlashAttention does and as neither the plain
//   version nor the TPU kernel (which widens every operand to float32)
//   does. sr3_flash_attention_bwd_tiles counts the launches of each class
//   and of the merge.
//
// ptxas (sm_90a, CUDA 12.8, as chip_smoke.py's build phase prints it):
// flash_bwd_wgmma_kernel 168 registers at launch in every class (setmaxnreg
// 40 / 232), flash_bwd_merge_kernel 40, the float32 kernels 98 (dK/dV) and
// 74 (dQ); no spills.
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


// ------------------------------------------- K5 and K6, bfloat16 route

using bf16 = __nv_bfloat16;

constexpr int kWThreads = 384;     // producer warpgroup + 2 consumer ones
constexpr int kProducerRegs = 40;  // 128 x 40 + 256 x 232 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kConsumerWarps = 8;  // arrivals that empty a ring stage
constexpr int kSmemMax = 232448;   // shared memory a block can use
constexpr int kMaxStages = 4;
constexpr int kMaxSplits = 16;
constexpr int kMinSplitTiles = 4;  // streamed tiles a split runs at least
constexpr float kLog2e = 1.4426950408889634f;

// What a kernel instantiation computes: K6's dQ; K5's dK and dV in one
// pass over the query tiles; or K5 in two passes, dV then dK (D = 512).
constexpr int kDq = 0, kDkv = 1, kDkv2 = 2;

// The classes of both kernels, by head_dim: DC columns (every D <= DC runs
// at the next class up; columns past D are zero-filled by TMA and never
// stored), then per kernel the streamed tile (BN rows) and the resident
// rows a block (128: each consumer warpgroup owns 64 rows and all of the
// output's DC columns; 64: the two share 64 rows, split D for their
// products and own DC / 2 output columns each). Counted in the order of
// sr3_flash_attention_bwd_tiles: K5's classes, K6's, then the merge.
constexpr int kClasses = 4;
constexpr int kClassDC[kClasses] = {64, 128, 256, 512};
constexpr int kDkvBN[kClasses] = {64, 64, 32, 32};
constexpr int kDkvRows[kClasses] = {128, 128, 64, 64};
constexpr int kDqBN[kClasses] = {128, 64, 64, 32};
constexpr int kDqRows[kClasses] = {128, 128, 128, 64};
std::atomic<long long> g_bwd_launches[2 * kClasses + 1];

// Shared memory of an instantiation: the two resident tiles (K, V for K5;
// Q, dO for K6), rings of kStages streamed tiles (Q, dO for K5; K, V for
// K6), K5's column statistics of each stage ([lse * log2(e)][dsum], BN
// floats each), the exchange of split-d partials ([warpgroup][X, Y]
// [BN / 2][128] floats) and the barriers. Every tile is DC / 64 column
// chunks of [rows][64] bf16 (128 bytes a row, 1024-byte aligned: the
// 128-byte swizzle's atom).
template <int DC, int BN, bool kSplitD, int kMode>
struct BwdTile {
  static constexpr int kBN = BN;
  static constexpr bool kSplit = kSplitD;
  static constexpr bool kColStats = kMode != kDq;
  static constexpr int kPasses = kMode == kDkv2 ? 2 : 1;
  static constexpr int kChunks = DC / 64;
  static constexpr int kRows = kSplitD ? 64 : 128;
  static constexpr int kOCols = kSplitD ? DC / 2 : DC;
  static constexpr int kRBytes = kRows * DC * 2;  // one resident tile
  static constexpr int kSBytes = BN * DC * 2;     // one streamed tile
  static constexpr int kStatBytes = kColStats ? 2 * BN * 4 : 0;
  static constexpr int kXTile = BN / 2 * 128;     // floats of one partial
  static constexpr int kXBytes = kSplitD ? 2 * 2 * kXTile * 4 : 0;
  static constexpr int kBarBytes = 256;
  static constexpr int kFit =
      (kSmemMax - 1024 - 2 * kRBytes - kXBytes - kBarBytes) /
      (2 * kSBytes + kStatBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static_assert(kStages >= 1, "a stage of both streamed tiles must fit");
  static_assert(8 * (1 + 4 * kStages) <= kBarBytes, "barriers");
  static_assert(kMode == kDq || kOCols <= 128 || kMode == kDkv2,
                "dK and dV of a warpgroup fit its registers in one pass");
  static constexpr size_t kSmem = 1024 + 2 * (size_t)kRBytes +
                                  (size_t)kStages * (2 * kSBytes + kStatBytes) +
                                  kXBytes + kBarBytes;
};

// What a consumer warpgroup keeps across its tiles.
struct BwdCtx {
  uint32_t r1, r2, b1, b2;  // shared addresses: resident rows of this
                            // warpgroup, the two rings
  const float* stats;       // K5: the rings' column statistics
  float* xs;                // the split-d exchange
  uint64_t *b1_full, *b1_empty, *b2_full, *b2_empty;
  int S, lane, tid, cw, tig, kk0, col0, total;
  float c, scale;           // scale * log2(e), scale
  float l2[2], ds[2];       // K6: lse * log2(e) and dsum of rows gid, gid + 8
};

// One tile step of a consumer warpgroup.
constexpr int kStepDq = 0, kStepDkv = 1, kStepDv = 2, kStepDk = 3;

__device__ __forceinline__ void release(const BwdCtx& x, uint64_t* empty) {
  __syncwarp();
  if (x.lane == 0) sr3::mbar_arrive(empty);
}

// Products of one streamed tile (stage s, phase ph, tile t; `it` counts
// the tiles of every pass). X = R1 B1^T (S^T = K Q^T in K5, S = Q K^T in
// K6) and Y = R2 B2^T (dP^T = V dO^T, dP = dO V^T) by shared-memory
// descriptors, Y first: its streamed operand is released first where the
// ring has one stage. Then P = exp2(X * c - lse * log2(e)) and
// dS = P (Y - dsum) * scale in float32 on the fragments; P rounded to bf16
// feeds acc_p += P B2 (dV += P^T dO) and dS rounded to bf16 feeds
// acc_ds += dS B1 (dK += dS^T Q, dQ += dS K), B1 / B2 read MN-major.
template <class T, int kStep>
__device__ __forceinline__ void bwd_step(const BwdCtx& x, float* acc_p,
                                         float* acc_ds, int it, int t, int s,
                                         uint32_t ph) {
  constexpr int BN = T::kBN;
  constexpr bool kSplitD = T::kSplit;
  constexpr bool kY = kStep != kStepDv;   // dP, hence dS, this step
  constexpr bool kP = kStep == kStepDkv || kStep == kStepDv;  // dV
  constexpr int kSteps = kSplitD ? T::kChunks * 2 : T::kChunks * 4;
  constexpr int kRows = T::kRows;
  float xv[BN / 2], yv[kY ? BN / 2 : 1];
  const uint32_t a_off = x.kk0 / 4 * kRows * 128;
  const uint32_t b_off = s * T::kSBytes + x.kk0 / 4 * BN * 128;
  if constexpr (kY) {
    const uint64_t da = sr3::wgmma_desc_sw128(x.r2 + a_off);
    const uint64_t db = sr3::wgmma_desc_sw128(x.b2 + b_off);
    sr3::mbar_wait(x.b2_full + s, ph);
    sr3::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      sr3::wgmma_ss<BN>(yv, da + (((kk / 4) * kRows * 128 + 32 * (kk % 4)) >> 4),
                        db + (((kk / 4) * BN * 128 + 32 * (kk % 4)) >> 4),
                        kk > 0);
    sr3::wgmma_commit();
  }
  {
    const uint64_t da = sr3::wgmma_desc_sw128(x.r1 + a_off);
    const uint64_t db = sr3::wgmma_desc_sw128(x.b1 + b_off);
    sr3::mbar_wait(x.b1_full + s, ph);
    sr3::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      sr3::wgmma_ss<BN>(xv, da + (((kk / 4) * kRows * 128 + 32 * (kk % 4)) >> 4),
                        db + (((kk / 4) * BN * 128 + 32 * (kk % 4)) >> 4),
                        kk > 0);
    sr3::wgmma_commit();
  }
  sr3::wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) sr3::fence_operand(xv[j]);
  if constexpr (kY) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) sr3::fence_operand(yv[j]);
  }
  // streamed operands no later product reads: V (K6), dO (K5's dK pass);
  // Q in K5's dV pass once its statistics are read, below
  if constexpr (kStep == kStepDq || kStep == kStepDk)
    release(x, x.b2_empty + s);

  if constexpr (kSplitD) {
    // barrier 1: both partials written; 2 + w: warpgroup w's buffer read
    // by the other, before w writes it again (a + b == b + a: both
    // warpgroups hold the same X and Y)
    float* mine = x.xs + x.cw * 2 * T::kXTile + x.tid % 128;
    const float* other = x.xs + (1 - x.cw) * 2 * T::kXTile + x.tid % 128;
    if (it > 0) sr3::bar_sync(2 + x.cw, 256);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) mine[128 * j] = xv[j];
    if constexpr (kY) {
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) mine[T::kXTile + 128 * j] = yv[j];
    }
    sr3::bar_sync(1, 256);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) xv[j] += other[128 * j];
    if constexpr (kY) {
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) yv[j] += other[T::kXTile + 128 * j];
    }
    if (it + 1 < x.total) sr3::bar_arrive(3 - x.cw, 256);
  }

  // P and dS on the fragments: d[4j + e] is row gid + 8 (e / 2), column
  // 8j + 2 tig + e % 2 of the tile
  if constexpr (T::kColStats) {
    // K5: the statistics of the query columns; a query past S has
    // lse = +inf and dsum = 0, so P = 0 and dS = 0 there
    const float* sl = x.stats + s * 2 * BN + 2 * x.tig;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(sl + 8 * j);
      float2 d = make_float2(0.f, 0.f);
      if constexpr (kY) d = *reinterpret_cast<const float2*>(sl + BN + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(xv[4 * j + e], x.c, -((e & 1) ? l.y : l.x)));
        if constexpr (kY)
          yv[4 * j + e] = p * (yv[4 * j + e] - ((e & 1) ? d.y : d.x)) * x.scale;
        xv[4 * j + e] = p;
      }
    }
  } else {
    // K6: the statistics of the rows; keys at or past S give P = 0
    const int k0 = t * BN;
    const bool ragged = k0 + BN > x.S;
    const int lim = x.S - k0 - 2 * x.tig;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(xv[4 * j + e], x.c, -x.l2[e >> 1]));
        if (ragged && 8 * j + (e & 1) >= lim) p = 0.f;
        yv[4 * j + e] = p * (yv[4 * j + e] - x.ds[e >> 1]) * x.scale;
      }
  }

  if constexpr (kStep == kStepDv) release(x, x.b1_empty + s);

  // acc_p += P B2 and acc_ds += dS B1, B1 / B2 MN-major by descriptor
  const uint32_t n_off = s * T::kSBytes + (x.col0 / 64) * BN * 128;
  uint32_t pa[kP ? BN / 16 : 1][4], da[kY ? BN / 16 : 1][4];
  if constexpr (kP) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sr3::c_to_a(pa[kk], xv + 8 * kk, xv + 8 * kk + 4);
  }
  if constexpr (kY) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sr3::c_to_a(da[kk], yv + 8 * kk, yv + 8 * kk + 4);
  }
  // K5's dV pass: dO has not been waited for by a Y product
  if constexpr (!kY) sr3::mbar_wait(x.b2_full + s, ph);
  sr3::wgmma_fence();
  if constexpr (kP) {
    const uint64_t d2 = sr3::wgmma_desc_sw128_mn(x.b2 + n_off, BN * 128);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sr3::wgmma_rs_t<T::kOCols>(acc_p, pa[kk], d2 + ((2048 * kk) >> 4));
  }
  if constexpr (kY) {
    const uint64_t d1 = sr3::wgmma_desc_sw128_mn(x.b1 + n_off, BN * 128);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sr3::wgmma_rs_t<T::kOCols>(acc_ds, da[kk], d1 + ((2048 * kk) >> 4));
  }
  sr3::wgmma_commit();
  sr3::wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < T::kOCols / 2; ++j) {
    if constexpr (kP) sr3::fence_operand(acc_p[j]);
    if constexpr (kY) sr3::fence_operand(acc_ds[j]);
  }
  if constexpr (kP) release(x, x.b2_empty + s);
  if constexpr (kY) release(x, x.b1_empty + s);
}

// A warpgroup's accumulator (its 64 rows from `row`, columns from col0)
// into rows of `out` (head base included); rows past S and columns past D
// are not written.
template <int kOCols>
__device__ __forceinline__ void store_rows(float* out, const float* acc,
                                           int row, int gid, int tig,
                                           int col0, int S, int D) {
  const int ncols = D - col0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ri = row + gid + 8 * r;
    if (ri >= S) continue;
    float* orow = out + (size_t)ri * D + col0 + 2 * tig;
#pragma unroll
    for (int j = 0; j < kOCols / 8; ++j)
      if (8 * j < ncols)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// Block (resident row tile x, bh y, split z of the streamed tiles):
// producer warpgroup 0 (warp 0: one thread issues every TMA load; in K5
// its 32 lanes also stage each query tile's lse and dsum), consumer
// warpgroups 1 and 2. K5 (kMode kDkv / kDkv2): r1, r2 = K, V; s1, s2 =
// Q, dO; out1 = dk, out2 = dv. K6 (kDq): r1, r2 = Q, dO; s1, s2 = K, V;
// out1 = dq. ws: null, or the workspace of a split ([splits][outputs]
// [BH][S][D] partial sums), where out1 / out2 are not written. rbox: rows
// of the resident tensor maps' box, fewer than the tile's where S is: the
// rows past it are left as they are in shared memory, and a resident row
// feeds only its own output row, which is past S and never stored.
template <int DC, int BN, bool kSplitD, int kMode>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap r1map,
                           const __grid_constant__ CUtensorMap r2map,
                           const __grid_constant__ CUtensorMap s1map,
                           const __grid_constant__ CUtensorMap s2map,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           float* __restrict__ out1, float* __restrict__ out2,
                           float* __restrict__ ws, int BH, int S, int D,
                           float scale, int per, int rbox) {
  using T = BwdTile<DC, BN, kSplitD, kMode>;
  extern __shared__ uint8_t bwd_smem[];
  uint8_t* base =
      bwd_smem + ((1024 - (sr3::smem_u32(bwd_smem) & 1023)) & 1023);
  bf16* r1 = reinterpret_cast<bf16*>(base);
  bf16* r2 = r1 + T::kRBytes / 2;
  bf16* b1 = r2 + T::kRBytes / 2;
  bf16* b2 = b1 + T::kStages * (T::kSBytes / 2);
  float* stats = reinterpret_cast<float*>(b2 + T::kStages * (T::kSBytes / 2));
  float* xs = stats + T::kStages * (T::kStatBytes / 4);
  uint64_t* r_full = reinterpret_cast<uint64_t*>(xs + T::kXBytes / 4);
  uint64_t* b1_full = r_full + 1;
  uint64_t* b1_empty = b1_full + T::kStages;
  uint64_t* b2_full = b1_empty + T::kStages;
  uint64_t* b2_empty = b2_full + T::kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, r0 = blockIdx.x * T::kRows, split = blockIdx.z;
  const int t0 = split * per;
  const int ntiles = min((S + BN - 1) / BN - t0, per);
  const int total = T::kPasses * ntiles;

  if (tid == 0) {
    sr3::mbar_init(r_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      // K5: the TMA thread's arrival and the 32 lanes' statistics
      sr3::mbar_init(b1_full + s, T::kColStats ? 33 : 1);
      sr3::mbar_init(b2_full + s, 1);
      sr3::mbar_init(b1_empty + s, kConsumerWarps);
      sr3::mbar_init(b2_empty + s, kConsumerWarps);
    }
    sr3::mbar_init_fence();
  }
  __syncthreads();

  // one if / else for the two roles, which never meet again (setmaxnreg)
  if (warp < 4) {  // producer
    sr3::setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && (T::kColStats || lane == 0)) {
      if (lane == 0) {
        sr3::tma_prefetch_map(&r1map);
        sr3::tma_prefetch_map(&r2map);
        sr3::tma_prefetch_map(&s1map);
        sr3::tma_prefetch_map(&s2map);
        sr3::mbar_expect_tx(r_full, 2 * T::kChunks * rbox * 128);
        for (int c = 0; c < T::kChunks; ++c) {
          sr3::tma_load_3d(r1 + c * T::kRows * 64, &r1map, r_full, 64 * c, r0,
                           bh);
          sr3::tma_load_3d(r2 + c * T::kRows * 64, &r2map, r_full, 64 * c, r0,
                           bh);
        }
      }
      const float* lrow = lse + (size_t)bh * S;
      const float* drow = dsum + (size_t)bh * S;
      for (int it = 0; it < total; ++it) {
        const int s = it % T::kStages, row = (t0 + it % ntiles) * BN;
        const uint32_t ph = (it / T::kStages) & 1;
        // K5's statistics of this tile, read before the wait
        constexpr int kPerLane = (BN + 31) / 32;
        float sl[kPerLane], sd[kPerLane];
        if constexpr (T::kColStats) {
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            const int c = lane + 32 * i, qi = row + c;
            const bool ok = c < BN && qi < S;
            sl[i] = ok ? lrow[qi] * kLog2e : INFINITY;
            sd[i] = ok ? drow[qi] : 0.f;
          }
        }
        // the operand the consumers release first is loaded first: Q in
        // K5's dV pass, else dO (K5) or V (K6)
        const bool b1_first = kMode == kDkv2 && it < ntiles;
        for (int o = 0; o < 2; ++o) {
          if ((o == 0) == b1_first) {
            sr3::mbar_wait(b1_empty + s, ph ^ 1);
            if (lane == 0) {
              sr3::mbar_expect_tx(b1_full + s, T::kSBytes);
              bf16* dst = b1 + s * (T::kSBytes / 2);
              for (int c = 0; c < T::kChunks; ++c)
                sr3::tma_load_3d(dst + c * BN * 64, &s1map, b1_full + s,
                                 64 * c, row, bh);
            }
            if constexpr (T::kColStats) {
              float* st = stats + s * 2 * BN;
#pragma unroll
              for (int i = 0; i < kPerLane; ++i) {
                const int c = lane + 32 * i;
                if (c < BN) {
                  st[c] = sl[i];
                  st[BN + c] = sd[i];
                }
              }
              sr3::mbar_arrive(b1_full + s);
            }
          } else if (lane == 0) {
            sr3::mbar_wait(b2_empty + s, ph ^ 1);
            sr3::mbar_expect_tx(b2_full + s, T::kSBytes);
            bf16* dst = b2 + s * (T::kSBytes / 2);
            for (int c = 0; c < T::kChunks; ++c)
              sr3::tma_load_3d(dst + c * BN * 64, &s2map, b2_full + s, 64 * c,
                               row, bh);
          }
        }
      }
    }
  } else {  // consumers
    sr3::setmaxnreg_inc<kConsumerRegs>();
    const int cw = warp / 4 - 1;  // consumer warpgroup 0 / 1
    const int gid = lane / 4, tig = lane % 4;
    const int row0 = kSplitD ? 0 : 64 * cw;  // its rows of the block's tile
    BwdCtx x;
    x.r1 = sr3::smem_u32(r1) + row0 * 128;
    x.r2 = sr3::smem_u32(r2) + row0 * 128;
    x.b1 = sr3::smem_u32(b1);
    x.b2 = sr3::smem_u32(b2);
    x.stats = stats;
    x.xs = xs;
    x.b1_full = b1_full;
    x.b1_empty = b1_empty;
    x.b2_full = b2_full;
    x.b2_empty = b2_empty;
    x.S = S;
    x.lane = lane;
    x.tid = tid;
    x.cw = cw;
    x.tig = tig;
    x.kk0 = kSplitD ? cw * T::kChunks * 2 : 0;  // its k-steps over D
    x.col0 = kSplitD ? cw * T::kOCols : 0;      // its output columns
    x.total = total;
    x.c = scale * kLog2e;
    x.scale = scale;
    const int row = r0 + row0 + 16 * (warp % 4);  // this warp's 16 rows
    x.l2[0] = x.l2[1] = x.ds[0] = x.ds[1] = 0.f;
    if constexpr (!T::kColStats) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = row + gid + 8 * r;
        if (qi < S) {
          x.l2[r] = lse[(size_t)bh * S + qi] * kLog2e;
          x.ds[r] = dsum[(size_t)bh * S + qi];
        }
      }
    }
    constexpr bool kTwoAcc = kMode == kDkv;
    float acc_p[kTwoAcc ? T::kOCols / 2 : 1];
    float acc[T::kOCols / 2];
#pragma unroll
    for (int i = 0; i < T::kOCols / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kTwoAcc ? T::kOCols / 2 : 1); ++i) acc_p[i] = 0.f;

    const size_t plane = (size_t)BH * S * D, head = (size_t)bh * S * D;
    constexpr int kOuts = T::kColStats ? 2 : 1;
    float* o1 = ws == nullptr ? out1 : ws + (size_t)split * kOuts * plane;
    float* o2 = ws == nullptr ? out2 : o1 + plane;

    sr3::mbar_wait(r_full, 0);
    for (int it = 0; it < total; ++it) {
      const int s = it % T::kStages, t = t0 + it % ntiles;
      const uint32_t ph = (it / T::kStages) & 1;
      if constexpr (kMode == kDq) {
        bwd_step<T, kStepDq>(x, acc, acc, it, t, s, ph);
      } else if constexpr (kMode == kDkv) {
        bwd_step<T, kStepDkv>(x, acc_p, acc, it, t, s, ph);
      } else {
        if (it < ntiles) {
          bwd_step<T, kStepDv>(x, acc, acc, it, t, s, ph);
          if (it == ntiles - 1) {  // dV done: store it, then dK's pass
            store_rows<T::kOCols>(o2 + head, acc, row, gid, tig, x.col0, S,
                                  D);
#pragma unroll
            for (int i = 0; i < T::kOCols / 2; ++i) acc[i] = 0.f;
          }
        } else {
          bwd_step<T, kStepDk>(x, acc, acc, it, t, s, ph);
        }
      }
    }
    store_rows<T::kOCols>(o1 + head, acc, row, gid, tig, x.col0, S, D);
    if constexpr (kTwoAcc)
      store_rows<T::kOCols>(o2 + head, acc_p, row, gid, tig, x.col0, S, D);
  }
}

// After a split: each output the sum of the splits' partials, in split
// order (no atomics: two calls give the same bits). 4 floats a thread.
__global__ void __launch_bounds__(256)
    flash_bwd_merge_kernel(const float* __restrict__ ws,
                           float* __restrict__ out1, float* __restrict__ out2,
                           long long n, int outs, int splits) {
  const long long i = 4 * ((long long)blockIdx.x * 256 + threadIdx.x);
  if (i >= n) return;
  for (int o = 0; o < outs; ++o) {
    float4 acc = *reinterpret_cast<const float4*>(ws + o * n + i);
    for (int z = 1; z < splits; ++z) {
      const float4 a =
          *reinterpret_cast<const float4*>(ws + (z * outs + o) * n + i);
      acc.x += a.x;
      acc.y += a.y;
      acc.z += a.z;
      acc.w += a.w;
    }
    *reinterpret_cast<float4*>((o == 0 ? out1 : out2) + i) = acc;
  }
}

// The launch plan of a bf16 backward kernel (kernel 0: K5, 1: K6; mirrored
// for the CPU tests in tests/torch_port_attention_plan.py): the class of
// D, resident row tiles of `rows`, streamed tiles of `bn`; where the blocks
// (row_tiles x BH) fill at most a quarter of the SMs, the streamed tiles
// (K5's queries, K6's keys) are split over `splits` blocks of `per` tiles
// each (as many as bring the blocks up to the SMs, at most kMaxSplits, at
// least kMinSplitTiles tiles a split). Not up to half a wave, as K4 splits:
// a split adds its outputs' float32 partials to the traffic twice (written,
// then read by the merge), and at 16x256x512 (64 blocks) the split ran
// 1.35-1.38x the unsplit time in two runs on an H100 SXM
// (sr3_tpu_torch/attention_variants.py bwd "half_wave").
struct BwdPlan {
  int cls, rows, bn, row_tiles, col_tiles, splits, per;
};

BwdPlan bwd_plan(int BH, int S, int D, int kernel, int sms) {
  BwdPlan p{};
  p.cls = D <= 64 ? 0 : D <= 128 ? 1 : D <= 256 ? 2 : 3;
  p.rows = kernel == 0 ? kDkvRows[p.cls] : kDqRows[p.cls];
  p.bn = kernel == 0 ? kDkvBN[p.cls] : kDqBN[p.cls];
  p.row_tiles = (S + p.rows - 1) / p.rows;
  p.col_tiles = (S + p.bn - 1) / p.bn;
  const long long blocks = (long long)p.row_tiles * BH;
  long long n = 1;
  if (4 * blocks <= sms) {
    n = sms / blocks;
    if (n > kMaxSplits) n = kMaxSplits;
    if (n > p.col_tiles / kMinSplitTiles) n = p.col_tiles / kMinSplitTiles;
    if (n < 1) n = 1;
  }
  p.per = (p.col_tiles + (int)n - 1) / (int)n;
  p.splits = (p.col_tiles + p.per - 1) / p.per;
  return p;
}

cudaError_t current_plan(int BH, int S, int D, int kernel, BwdPlan* p) {
  int sms = 0;
  const cudaError_t err = sr3::sm_count(&sms);
  if (err == cudaSuccess) *p = bwd_plan(BH, S, D, kernel, sms);
  return err;
}

// Floats of a split's workspace: the partial sums of K5's two outputs or
// K6's one, a split each.
long long workspace_floats(const BwdPlan& p, int BH, int S, int D,
                           int kernel) {
  return p.splits > 1 ? (long long)p.splits * (kernel == 0 ? 2 : 1) * BH *
                            S * D
                      : 0;
}

struct BwdArgs {
  const void *q, *k, *v, *g;
  const float *lse, *dsum;
  float *out1, *out2, *ws;  // K5: dk, dv; K6: dq, null
  int BH, S, D;
  float scale;
};

template <int kKernel, int kCls>
cudaError_t launch_class(const BwdArgs& a, const BwdPlan& p,
                         cudaStream_t st) {
  constexpr int DC = kClassDC[kCls];
  constexpr int BN = kKernel == 0 ? kDkvBN[kCls] : kDqBN[kCls];
  constexpr bool kSplitD =
      (kKernel == 0 ? kDkvRows[kCls] : kDqRows[kCls]) == 64;
  // K5 takes two passes where dK and dV together would not fit the
  // registers (above 128 output floats a thread)
  constexpr int kOCols = kSplitD ? DC / 2 : DC;
  constexpr int kMode = kKernel == 1 ? kDq : kOCols > 128 ? kDkv2 : kDkv;
  using T = BwdTile<DC, BN, kSplitD, kMode>;
  static_assert(T::kRows <= 256 && BN <= 256, "a TMA box has <= 256 rows");
  const auto kernel = flash_bwd_wgmma_kernel<DC, BN, kSplitD, kMode>;
  static sr3::SmemLimit limit;
  cudaError_t err = sr3::raise_smem_limit(limit, (const void*)kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  // resident operands (K5: K, V; K6: Q, dO) and streamed ones
  const void* r1 = kKernel == 0 ? a.k : a.q;
  const void* r2 = kKernel == 0 ? a.v : a.g;
  const void* s1 = kKernel == 0 ? a.q : a.k;
  const void* s2 = kKernel == 0 ? a.g : a.v;
  // the resident box: the tile's rows, or S rounded up to 8 where the
  // tile is longer (fewer bytes zero-filled); streamed tiles stay whole,
  // zero past S, as every row of them feeds every output row
  const int rbox = a.S < T::kRows ? (a.S + 7) / 8 * 8 : T::kRows;
  CUtensorMap r1map, r2map, s1map, s2map;
  if (!sr3::encode_map(&r1map, r1, a.BH, a.S, a.D, rbox) ||
      !sr3::encode_map(&r2map, r2, a.BH, a.S, a.D, rbox) ||
      !sr3::encode_map(&s1map, s1, a.BH, a.S, a.D, BN) ||
      !sr3::encode_map(&s2map, s2, a.BH, a.S, a.D, BN))
    return cudaErrorInvalidValue;
  const dim3 grid(p.row_tiles, a.BH, p.splits);
  kernel<<<grid, kWThreads, T::kSmem, st>>>(
      r1map, r2map, s1map, s2map, a.lse, a.dsum, a.out1, a.out2,
      p.splits > 1 ? a.ws : nullptr, a.BH, a.S, a.D, a.scale, p.per, rbox);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  g_bwd_launches[kKernel * kClasses + kCls].fetch_add(
      1, std::memory_order_relaxed);
  if (p.splits == 1) return cudaSuccess;
  const long long n = (long long)a.BH * a.S * a.D;
  flash_bwd_merge_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, st>>>(
      a.ws, a.out1, a.out2, n, kKernel == 0 ? 2 : 1, p.splits);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    g_bwd_launches[2 * kClasses].fetch_add(1, std::memory_order_relaxed);
  return err;
}

cudaError_t bwd_wgmma(const BwdArgs& a, int kernel, cudaStream_t st) {
  // TMA reads from 16-byte aligned rows (D % 16 == 0)
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.g)) %
      16)
    return cudaErrorInvalidValue;
  BwdPlan p;
  cudaError_t err = current_plan(a.BH, a.S, a.D, kernel, &p);
  if (err != cudaSuccess) return err;
  if (p.splits > 1 && a.ws == nullptr) return cudaErrorInvalidValue;
  if (kernel == 0) {
    switch (p.cls) {
      case 0: return launch_class<0, 0>(a, p, st);
      case 1: return launch_class<0, 1>(a, p, st);
      case 2: return launch_class<0, 2>(a, p, st);
      default: return launch_class<0, 3>(a, p, st);
    }
  }
  switch (p.cls) {
    case 0: return launch_class<1, 0>(a, p, st);
    case 1: return launch_class<1, 1>(a, p, st);
    case 2: return launch_class<1, 2>(a, p, st);
    default: return launch_class<1, 3>(a, p, st);
  }
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
// aligned; workspace: the floats sr3_flash_attention_bwd_workspace_floats
// asks for (null when it asks for none). D must be a multiple of 16 and at
// most 512, BH at most 65535. Returns the CUDA error code.
extern "C" int sr3_flash_attention_bwd_dkv(const void* q, const void* k,
                                           const void* v, const void* g,
                                           const float* lse, const float* dsum,
                                           float* dk, float* dv,
                                           float* workspace, int BH, int S,
                                           int D, float scale, int dtype,
                                           void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sr3::kF32)
    return (int)dkv_t<float>(q, k, v, static_cast<const float*>(g), lse, dsum,
                             dk, dv, BH, S, D, scale, st);
  if (dtype == sr3::kBF16)
    return (int)bwd_wgmma(BwdArgs{q, k, v, g, lse, dsum, dk, dv, workspace,
                                  BH, S, D, scale},
                          0, st);
  return (int)cudaErrorInvalidValue;
}

// K6: dq, with the operands of K5 (g of dtype too); dq: (BH, S, D) float32;
// workspace as K5's, for K6.
extern "C" int sr3_flash_attention_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* g,
                                          const float* lse, const float* dsum,
                                          float* dq, float* workspace, int BH,
                                          int S, int D, float scale, int dtype,
                                          void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sr3::kF32)
    return (int)dq_t<float>(q, k, v, static_cast<const float*>(g), lse, dsum,
                            dq, BH, S, D, scale, st);
  if (dtype == sr3::kBF16)
    return (int)bwd_wgmma(BwdArgs{q, k, v, g, lse, dsum, dq, nullptr,
                                  workspace, BH, S, D, scale},
                          1, st);
  return (int)cudaErrorInvalidValue;
}

// Floats of workspace kernel (0: K5, 1: K6) needs for (BH, S, D) of dtype
// on the current device: 0 without a split; -1 when it does not take the
// shape or the device cannot be read.
extern "C" long long sr3_flash_attention_bwd_workspace_floats(int BH, int S,
                                                              int D, int dtype,
                                                              int kernel) {
  if (bad_shape(BH, S, D) || (dtype != sr3::kF32 && dtype != sr3::kBF16) ||
      (kernel != 0 && kernel != 1))
    return -1;
  if (dtype == sr3::kF32) return 0;
  BwdPlan p;
  if (current_plan(BH, S, D, kernel, &p) != cudaSuccess) return -1;
  return workspace_floats(p, BH, S, D, kernel);
}

// The bf16 plan of kernel (0: K5, 1: K6) for (BH, S, D) on the current
// device into out[0..6]: class, rows, bn, row_tiles, col_tiles, splits,
// per. Returns 7, or -1 when it does not take the shape or the device
// cannot be read.
extern "C" int sr3_flash_attention_bwd_plan(int BH, int S, int D, int kernel,
                                            long long* out) {
  BwdPlan p;
  if (bad_shape(BH, S, D) || (kernel != 0 && kernel != 1) ||
      current_plan(BH, S, D, kernel, &p) != cudaSuccess)
    return -1;
  const int fields[7] = {p.cls, p.rows, p.bn, p.row_tiles, p.col_tiles,
                         p.splits, p.per};
  for (int i = 0; i < 7; ++i) out[i] = fields[i];
  return 7;
}

// Launches of the bf16 routes since the last reset into counts[0..8]: K5's
// classes dkv<DC,BN> <64,64>, <128,64>, <256,32>, <512,32>, K6's
// dq<64,128>, <128,64>, <256,64>, <512,32>, then the merge; reset != 0 sets
// them to 0 after reading. Returns 9.
extern "C" int sr3_flash_attention_bwd_tiles(long long* counts, int reset) {
  for (int i = 0; i <= 2 * kClasses; ++i)
    counts[i] = reset ? g_bwd_launches[i].exchange(0)
                      : g_bwd_launches[i].load();
  return 2 * kClasses + 1;
}
