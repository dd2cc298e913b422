// K4: flash-attention forward, non-causal, online softmax with float32
// running max / sum / accumulator; float32 output and, optionally, the
// float32 per-row logsumexp m + log(l) of the scaled scores (the input of
// the backward kernels K5 / K6 in attention_bwd.cu).
//
// Replaces the TPU kernel sr3_tpu/ops/attention.py:58 `_flash_fwd_kernel`
// (pallas_call in `_fwd_pallas_call`, :104), with its `with_lse` output. It
// runs as the single-head self-attention of every UNet: (B, 256, 512) and
// (B, 64, 512) on the 16->128 path, (B, 4096, 512) and (B, 1024, 512) on
// the 64->512 path, (B, 1024, 512) on the 128->1024 stage, (B, 256, 128)
// and (B, 16, 256) on sample_ddpm_128; a training step asks for the
// logsumexp.
//
// Bound on the card: operations. 4*BH*S^2*D (two products) against
// BH*S*D*(3*2 + 4) bytes: at (8, 4096, 512) 275 GFLOP, 0.278 ms on the bf16
// tensor cores (989 TFLOP/s), against 0.04 ms for the bytes. The (S x S)
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
// * bfloat16: flash_fwd_wgmma_kernel, one kernel template for Hopper with
//   one instantiation per head_dim class, and flash_merge_kernel after a
//   key split. What held the mma.sync kernel it replaces (PR 4) at 3-13% of
//   its bound, and what this design does about each:
//   1. Pre-Hopper products (mma.sync from single warps, every operand
//      through ldmatrix into registers). Now wgmma.mma_async m64nNk16 by
//      warpgroups: S = Q K^T reads Q and K from shared memory by
//      descriptor; P V takes P from registers and V by a transposed
//      (MN-major) descriptor, so V needs no transposing copy.
//   2. One tiling for every head_dim. Now a class per head_dim: <DC, BK,
//      split> = <64, 128, no>, <128, 128, no>, <256, 64, no>, <512, 64,
//      yes>: 128 query rows a block (two consumer warpgroups of 64) and 64
//      or 128 keys a tile where D <= 256; shared memory sized to the class
//      (the ring takes as many stages as fit, up to 4). Every D the wrapper
//      takes (a multiple of 16, at most 512) runs at the class of the next
//      multiple of 64 up; columns past D are zero-filled by TMA and never
//      stored.
//   3. Half the score work traded for shared-memory traffic at every D (the
//      warp pair's split-d partial scores). Now only the D = 512 class
//      splits: a 64 x 512 float32 O tile would be 256 registers a thread in
//      one warpgroup, over the 255 limit, so its two consumer warpgroups
//      share 64 query rows, each owns 256 of O's columns and computes S
//      over its half of D, and the two partial S (BK / 2 floats a thread,
//      16 KB a warpgroup a tile) are added through shared memory between
//      named barriers (a + b == b + a: both hold the same S and run the
//      same softmax). Computing the whole S in both warpgroups instead
//      (1.5x the operations of the two products, no exchange) measured
//      slower (sr3_tpu_torch/attention_variants.py k4 "recompute"). Below
//      512 each warpgroup owns its 64 rows and all of O's columns.
//   4. Grids under one wave. Where the blocks of a call (query tiles x BH)
//      fill at most half of the SMs, the keys are split (fwd_plan) into
//      splits of at least 4 key tiles: block z runs key tiles
//      [z*per, (z+1)*per) and writes its unnormalised O, m and l to the
//      workspace; flash_merge_kernel then merges the splits in index order
//      (no atomics: two calls give the same bits). Splits of 1 or 2 tiles
//      measured slower than none (attention_variants.py k4 "split_per1",
//      "split_per2": the merge launch and the partial O's round trip cost
//      more than the blocks gain); 2x1024x512 splits in 4.
//   5. Copies issued by all 256 threads. Now one producer warp issues TMA
//      tiled loads (cp.async.bulk.tensor, 128-byte swizzle, the layout the
//      wgmma descriptors read) of the Q tile once and of K and V tiles into
//      a ring guarded by mbarriers (full: TMA bytes landed; empty: the 8
//      consumer warps are done with the stage), K and V with separate
//      barriers so S waits only for K. The producer warpgroup gives its
//      registers to the consumers (setmaxnreg 40 / 232; ptxas, sm_90a, CUDA
//      12.8: no spills, no serialized wgmma in any class -- a trap in the
//      barrier wait cost that: the register split was lost and the D >= 256
//      classes spilled). Tensor maps (3-D: D, S, BH, so a ragged S is
//      zero-filled per head) are encoded on the host for every call,
//      through cudaGetDriverEntryPoint (no -lcuda). The D = 512 class fits
//      one ring stage (Q 64 KB + K and V 64 KB each + the exchange 32 KB);
//      two stages of 32 keys measured slower (variant "bk32").
//   Rounding as before: the scale is applied to S in float32 after the
//   product (in the base-2 exponent, scale * log2(e), as exp2); P is
//   rounded to bf16 at its tile's running max and is the register A operand
//   of P V; l sums the unrounded P. Tolerance against the plain version
//   (float32 softmax and products): o within 2e-2 of max|plain| -- P is
//   rounded to bf16 (2^-9 relative) before P V, as FlashAttention does and
//   as neither the plain version nor the TPU kernel (which widens every
//   operand to float32) does; lse within 1e-4 -- S is a sum of exact bf16
//   products in float32 and l sums the unrounded P, so only the order of
//   float32 sums differs. sr3_flash_attention_fwd_tiles counts the
//   launches of each class and of the merge.
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

constexpr int kWThreads = 384;    // producer warpgroup + 2 consumer ones
constexpr int kProducerRegs = 40;  // 128 x 40 + 256 x 232 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kConsumerWarps = 8;  // arrivals that empty a ring stage
constexpr int kSmemMax = 232448;   // shared memory a block can use
constexpr int kMaxStages = 4;
constexpr int kMaxSplits = 16;
constexpr int kMinSplitTiles = 4;  // key tiles a split runs at least
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A head_dim class: DC columns (every D <= DC runs at it), BK keys a tile;
// kSplitD: the two consumer warpgroups share 64 query rows and each owns
// DC / 2 of O's columns, else each owns 64 rows and all DC columns. Shared
// memory: the Q tile, then K and V rings of kStages tiles, then the
// barriers; every tile is DC / 64 column chunks of [rows][64] bf16 (128
// bytes a row, 1024-byte aligned: the 128-byte swizzle's atom).
template <int DC, int BK, bool kSplitD>
struct FwdTile {
  static constexpr int kChunks = DC / 64;
  static constexpr int kRows = kSplitD ? 64 : 128;
  static constexpr int kOCols = kSplitD ? DC / 2 : DC;
  static constexpr int kQBytes = kRows * DC * 2;
  static constexpr int kKVBytes = BK * DC * 2;  // one K or V tile
  static constexpr int kBarBytes = 256;
  // kSplitD: each consumer warpgroup's partial S, [BK / 2][128] floats
  static constexpr int kXBytes = kSplitD ? 2 * BK / 2 * 128 * 4 : 0;
  static constexpr int kFit =
      (kSmemMax - 1024 - kQBytes - kXBytes - kBarBytes) / (2 * kKVBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static_assert(kStages >= 1, "a K and a V tile must fit");
  static_assert(8 * (1 + 4 * kStages) <= kBarBytes, "barriers");
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * (size_t)kStages * kKVBytes + kXBytes + kBarBytes;
};

// Block (q tile x, bh y, key split z): producer warpgroup 0 (one thread
// issues every TMA load), consumer warpgroups 1 and 2. ws: null, or the
// workspace of a key split ([splits][BH][S][D] unnormalised O, then
// [splits][BH][S] m (base-2), then l), when o and lse are not written.
template <int DC, int BK, bool kSplitD>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           float* __restrict__ o, float* __restrict__ lse,
                           float* __restrict__ ws, int BH, int S, int D,
                           float scale_log2, int per) {
  using T = FwdTile<DC, BK, kSplitD>;
  extern __shared__ uint8_t fa_smem[];
  uint8_t* base =
      fa_smem + ((1024 - (sr3::smem_u32(fa_smem) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* ks = reinterpret_cast<bf16*>(base + T::kQBytes);
  bf16* vs = ks + T::kStages * (T::kKVBytes / 2);
  float* xs = reinterpret_cast<float*>(base + T::kQBytes +
                                      2 * T::kStages * T::kKVBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(xs) + T::kXBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + T::kStages;
  uint64_t* v_full = k_empty + T::kStages;
  uint64_t* v_empty = v_full + T::kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * T::kRows, split = blockIdx.z;
  const int t0 = split * per;
  const int ntiles = min((S + BK - 1) / BK - t0, per);

  if (tid == 0) {
    sr3::mbar_init(q_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      sr3::mbar_init(k_full + s, 1);
      sr3::mbar_init(v_full + s, 1);
      sr3::mbar_init(k_empty + s, kConsumerWarps);
      sr3::mbar_init(v_empty + s, kConsumerWarps);
    }
    sr3::mbar_init_fence();
  }
  __syncthreads();

  // one if / else for the two roles, which never meet again (setmaxnreg)
  if (warp < 4) {  // producer
    sr3::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      sr3::tma_prefetch_map(&qmap);
      sr3::tma_prefetch_map(&kmap);
      sr3::tma_prefetch_map(&vmap);
      sr3::mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c)
        sr3::tma_load_3d(qs + c * T::kRows * 64, &qmap, q_full, 64 * c, q0,
                         bh);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % T::kStages, k0 = (t0 + i) * BK;
        const uint32_t ph = (i / T::kStages) & 1;
        bf16* kt = ks + s * (T::kKVBytes / 2);
        bf16* vt = vs + s * (T::kKVBytes / 2);
        sr3::mbar_wait(k_empty + s, ph ^ 1);
        sr3::mbar_expect_tx(k_full + s, T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c)
          sr3::tma_load_3d(kt + c * BK * 64, &kmap, k_full + s, 64 * c, k0,
                           bh);
        sr3::mbar_wait(v_empty + s, ph ^ 1);
        sr3::mbar_expect_tx(v_full + s, T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c)
          sr3::tma_load_3d(vt + c * BK * 64, &vmap, v_full + s, 64 * c, k0,
                           bh);
      }
    }
  } else {  // consumers
    sr3::setmaxnreg_inc<kConsumerRegs>();
    const int cw = warp / 4 - 1;  // consumer warpgroup 0 / 1
    const int gid = lane / 4, tig = lane % 4;
    const int row0 = kSplitD ? 0 : 64 * cw;         // its rows of the tile
    const int col0 = kSplitD ? cw * T::kOCols : 0;  // its columns of O
    const uint32_t q_addr = sr3::smem_u32(qs) + row0 * 128;
    const uint32_t k_addr = sr3::smem_u32(ks), v_addr = sr3::smem_u32(vs);
    // k-steps of S over D: all, or (split) this warpgroup's half
    constexpr int kSteps = kSplitD ? DC / 32 : DC / 16;
    const int kk0 = kSplitD ? cw * kSteps : 0;

    float acc[T::kOCols / 2];
#pragma unroll
    for (int i = 0; i < T::kOCols / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    sr3::mbar_wait(q_full, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % T::kStages, k0 = (t0 + i) * BK;
      const uint32_t ph = (i / T::kStages) & 1;

      // S = Q K^T (64 rows x BK keys), Q and K by descriptor; split: this
      // warpgroup's half of D (k-steps from kk0), the other half's partial
      // S added through shared memory
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      // k-step kk reads 16 columns of chunk kk / 4 of Q and K: each
      // descriptor is its base plus a constant
      const uint64_t dq =
          sr3::wgmma_desc_sw128(q_addr + kk0 / 4 * T::kRows * 128);
      const uint64_t dk = sr3::wgmma_desc_sw128(k_addr + s * T::kKVBytes +
                                                kk0 / 4 * BK * 128);
      sr3::mbar_wait(k_full + s, ph);
      sr3::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        sr3::wgmma_ss<BK>(
            sc, dq + (((kk / 4) * T::kRows * 128 + 32 * (kk % 4)) >> 4),
            dk + (((kk / 4) * BK * 128 + 32 * (kk % 4)) >> 4), kk > 0);
      sr3::wgmma_commit();
      sr3::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sr3::fence_operand(sc[j]);
      __syncwarp();
      if (lane == 0) sr3::mbar_arrive(k_empty + s);
      if constexpr (kSplitD) {
        // barrier 1: both partials written; 2 + w: warpgroup w's buffer
        // read by the other, before w writes it again (a + b == b + a, so
        // both warpgroups hold the same S and run the same softmax)
        float* mine = xs + cw * (BK / 2) * 128 + tid % 128;
        const float* other = xs + (1 - cw) * (BK / 2) * 128 + tid % 128;
        if (i > 0) sr3::bar_sync(2 + cw, 256);
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) mine[128 * j] = sc[j];
        sr3::bar_sync(1, 256);
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] += other[128 * j];
        if (i + 1 < ntiles) sr3::bar_arrive(3 - cw, 256);
      }

      // online softmax on the fragments: row gid (r = 0), row gid + 8 (r = 1)
      // keys at or past S (ragged last tile): column 8j + 2tig + (e & 1)
      // of the tile, compared as a constant against `lim`
      const bool ragged = k0 + BK > S;
      const int lim = S - k0 - 2 * tig;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (ragged && 8 * j + (e & 1) >= lim) x = -INFINITY;
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const float p = exp2f(sc[j] - mx[(j % 4) >> 1]);
        sc[j] = p;
        sum[(j % 4) >> 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int j = 0; j < T::kOCols / 2; ++j) acc[j] *= alpha[(j % 4) >> 1];
      uint32_t pa[BK / 16][4];  // P rounded to bf16: the A operand of P V
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sr3::c_to_a(pa[kk], sc + 8 * kk, sc + 8 * kk + 4);

      // O += P V over this warpgroup's columns, V MN-major by descriptor
      const uint64_t dv = sr3::wgmma_desc_sw128_mn(
          v_addr + s * T::kKVBytes + (col0 / 64) * BK * 128, BK * 128);
      sr3::mbar_wait(v_full + s, ph);
      sr3::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sr3::wgmma_rs_t<T::kOCols>(acc, pa[kk], dv + ((2048 * kk) >> 4));
      sr3::wgmma_commit();
      sr3::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < T::kOCols / 2; ++j) sr3::fence_operand(acc[j]);
      __syncwarp();
      if (lane == 0) sr3::mbar_arrive(v_empty + s);
    }

    // epilogue: o = O / l and lse, or the split's O, m, l to the workspace
    const size_t plane = (size_t)BH * S;
    const bool stats = tig == 0 && (!kSplitD || cw == 0);
    const int ncols = D - col0;  // this warpgroup's columns of o
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + row0 + 16 * (warp % 4) + gid + 8 * r;
      if (qi >= S) continue;
      const size_t at = (size_t)bh * S + qi;
      const float inv = ws == nullptr ? 1.f / l[r] : 1.f;
      float* orow = (ws == nullptr ? o : ws + split * plane * D) + at * D +
                    col0 + 2 * tig;
#pragma unroll
      for (int j = 0; j < T::kOCols / 8; ++j)
        if (8 * j < ncols)
          *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(
              acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      if (!stats) continue;
      if (ws == nullptr) {
        if (lse != nullptr) lse[at] = m[r] * kLn2 + logf(l[r]);
      } else {
        float* ml = ws + gridDim.z * plane * D;
        ml[split * plane + at] = m[r];
        ml[(gridDim.z + split) * plane + at] = l[r];
      }
    }
  }
}

// After a key split: o and lse of each row from the splits' unnormalised
// O, m and l, in split order. A warp a row, 4 columns a lane.
__global__ void __launch_bounds__(256)
    flash_merge_kernel(const float* __restrict__ ws, float* __restrict__ o,
                       float* __restrict__ lse, int BH, int S, int D,
                       int splits) {
  const int qi = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (qi >= S) return;
  const size_t plane = (size_t)BH * S, at = (size_t)blockIdx.y * S + qi;
  const float* ml = ws + splits * plane * D;
  float mx = -INFINITY;
  for (int z = 0; z < splits; ++z) mx = fmaxf(mx, ml[z * plane + at]);
  float sum = 0.f;
  for (int z = 0; z < splits; ++z)
    sum += ml[(splits + z) * plane + at] * exp2f(ml[z * plane + at] - mx);
  const float inv = 1.f / sum;
  for (int c = 4 * lane; c < D; c += 128) {
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < splits; ++z) {
      const float w = exp2f(ml[z * plane + at] - mx) * inv;
      const float4 a =
          *reinterpret_cast<const float4*>(ws + (z * plane + at) * D + c);
      out.x = fmaf(w, a.x, out.x);
      out.y = fmaf(w, a.y, out.y);
      out.z = fmaf(w, a.z, out.z);
      out.w = fmaf(w, a.w, out.w);
    }
    *reinterpret_cast<float4*>(o + at * D + c) = out;
  }
  if (lse != nullptr && lane == 0) lse[at] = mx * kLn2 + logf(sum);
}

// The classes <DC, BK, split> in the order of sr3_flash_attention_fwd_tiles
// (index 4 counts the merge).
constexpr int kClasses = 4;
constexpr int kClassBK[kClasses] = {128, 128, 64, 64};
constexpr int kClassRows[kClasses] = {128, 128, 128, 64};
std::atomic<long long> g_fwd_launches[kClasses + 1];

// The launch plan of the bf16 route (mirrored for the CPU tests in
// tests/torch_port_attention_plan.py): the class of D, query tiles of
// `rows`, key tiles of `bk`; where the blocks (q_tiles x BH) fill at most
// half of the SMs, the key tiles are split over `splits` blocks of `per`
// tiles each (as many as bring the blocks up to the SMs, at most
// kMaxSplits, at least kMinSplitTiles tiles a split).
struct FwdPlan {
  int cls, rows, bk, q_tiles, key_tiles, splits, per;
};

FwdPlan fwd_plan(int BH, int S, int D, int sms) {
  FwdPlan p{};
  p.cls = D <= 64 ? 0 : D <= 128 ? 1 : D <= 256 ? 2 : 3;
  p.rows = kClassRows[p.cls];
  p.bk = kClassBK[p.cls];
  p.q_tiles = (S + p.rows - 1) / p.rows;
  p.key_tiles = (S + p.bk - 1) / p.bk;
  const long long blocks = (long long)p.q_tiles * BH;
  long long n = 1;
  if (2 * blocks <= sms) {
    n = sms / blocks;
    if (n > kMaxSplits) n = kMaxSplits;
    if (n > p.key_tiles / kMinSplitTiles) n = p.key_tiles / kMinSplitTiles;
    if (n < 1) n = 1;
  }
  p.per = (p.key_tiles + (int)n - 1) / (int)n;
  p.splits = (p.key_tiles + p.per - 1) / p.per;
  return p;
}

cudaError_t current_plan(int BH, int S, int D, FwdPlan* p) {
  int sms = 0;
  const cudaError_t err = sr3::sm_count(&sms);
  if (err == cudaSuccess) *p = fwd_plan(BH, S, D, sms);
  return err;
}

long long workspace_floats(const FwdPlan& p, int BH, int S, int D) {
  return p.splits > 1 ? (long long)p.splits * BH * S * (D + 2) : 0;
}

struct FwdArgs {
  const void *q, *k, *v;
  float *o, *lse, *ws;
  int BH, S, D;
  float scale;
};

template <int DC, int BK, bool kSplitD>
cudaError_t launch_class(const FwdArgs& a, const FwdPlan& p,
                         cudaStream_t st) {
  using T = FwdTile<DC, BK, kSplitD>;
  static_assert(T::kRows <= 256 && BK <= 256, "a TMA box has <= 256 rows");
  const auto kernel = flash_fwd_wgmma_kernel<DC, BK, kSplitD>;
  static sr3::SmemLimit limit;
  cudaError_t err = sr3::raise_smem_limit(limit, (const void*)kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap;
  if (!sr3::encode_map(&qmap, a.q, a.BH, a.S, a.D, T::kRows) ||
      !sr3::encode_map(&kmap, a.k, a.BH, a.S, a.D, BK) ||
      !sr3::encode_map(&vmap, a.v, a.BH, a.S, a.D, BK))
    return cudaErrorInvalidValue;
  const dim3 grid(p.q_tiles, a.BH, p.splits);
  kernel<<<grid, kWThreads, T::kSmem, st>>>(
      qmap, kmap, vmap, a.o, a.lse, p.splits > 1 ? a.ws : nullptr, a.BH, a.S,
      a.D, a.scale * kLog2e, p.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  g_fwd_launches[p.cls].fetch_add(1, std::memory_order_relaxed);
  if (p.splits == 1) return cudaSuccess;
  flash_merge_kernel<<<dim3((a.S + 7) / 8, a.BH), 256, 0, st>>>(
      a.ws, a.o, a.lse, a.BH, a.S, a.D, p.splits);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    g_fwd_launches[kClasses].fetch_add(1, std::memory_order_relaxed);
  return err;
}

cudaError_t flash_wgmma(const FwdArgs& a, cudaStream_t st) {
  // TMA reads from 16-byte aligned rows (D % 16 == 0)
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v)) % 16)
    return cudaErrorInvalidValue;
  FwdPlan p;
  cudaError_t err = current_plan(a.BH, a.S, a.D, &p);
  if (err != cudaSuccess) return err;
  if (p.splits > 1 && a.ws == nullptr) return cudaErrorInvalidValue;
  switch (p.cls) {
    case 0: return launch_class<64, 128, false>(a, p, st);
    case 1: return launch_class<128, 128, false>(a, p, st);
    case 2: return launch_class<256, 64, false>(a, p, st);
    default: return launch_class<512, 64, true>(a, p, st);
  }
}

}  // namespace

static bool fwd_takes(int BH, int S, int D) {
  return D % 16 == 0 && D > 0 && D <= kDMax && S > 0 && BH > 0 &&
         BH <= 65535;
}

// o = softmax(q k^T * scale) v. q, k, v: (BH, S, D) of dtype, contiguous
// (bfloat16: 16-byte aligned); o: (BH, S, D) float32; lse: (BH, S) float32
// logsumexp of each row of q k^T * scale, or null to skip it; workspace:
// the floats sr3_flash_attention_fwd_workspace_floats asks for (null when
// it asks for none). D must be a multiple of 16 and at most 512, BH at most
// 65535. float32 runs the FMA route, bfloat16 the wgmma route. Returns the
// CUDA error code (0 on success).
extern "C" int sr3_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, float* o, float* lse,
                                       float* workspace, int BH, int S, int D,
                                       float scale, int dtype, void* stream) {
  if (!fwd_takes(BH, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sr3::kF32)
    return (int)flash_t<float>(q, k, v, o, lse, BH, S, D, scale, st);
  if (dtype == sr3::kBF16)
    return (int)flash_wgmma(
        FwdArgs{q, k, v, o, lse, workspace, BH, S, D, scale}, st);
  return (int)cudaErrorInvalidValue;
}

// Floats of workspace sr3_flash_attention_fwd needs for (BH, S, D) of dtype
// on the current device: 0 without a key split; -1 when it does not take
// the shape or the device cannot be read.
extern "C" long long sr3_flash_attention_fwd_workspace_floats(int BH, int S,
                                                              int D,
                                                              int dtype) {
  if (!fwd_takes(BH, S, D) || (dtype != sr3::kF32 && dtype != sr3::kBF16))
    return -1;
  if (dtype == sr3::kF32) return 0;
  FwdPlan p;
  if (current_plan(BH, S, D, &p) != cudaSuccess) return -1;
  return workspace_floats(p, BH, S, D);
}

// The bf16 route's plan for (BH, S, D) on the current device into out[0..6]:
// class, rows, bk, q_tiles, key_tiles, splits, per. Returns 7, or -1 when
// it does not take the shape or the device cannot be read.
extern "C" int sr3_flash_attention_fwd_plan(int BH, int S, int D,
                                            long long* out) {
  FwdPlan p;
  if (!fwd_takes(BH, S, D) || current_plan(BH, S, D, &p) != cudaSuccess)
    return -1;
  const int fields[7] = {p.cls, p.rows, p.bk, p.q_tiles, p.key_tiles,
                         p.splits, p.per};
  for (int i = 0; i < 7; ++i) out[i] = fields[i];
  return 7;
}

// Launches of the bf16 route since the last reset into counts[0..4]: the
// classes <DC, BK> <64,128>, <128,128>, <256,64>, <512,64>, then the
// merge; reset != 0 sets them to 0 after reading. Returns 5.
extern "C" int sr3_flash_attention_fwd_tiles(long long* counts, int reset) {
  for (int i = 0; i <= kClasses; ++i)
    counts[i] = reset ? g_fwd_launches[i].exchange(0)
                      : g_fwd_launches[i].load();
  return kClasses + 1;
}
