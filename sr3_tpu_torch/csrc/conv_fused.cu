// K1: fused GroupNorm -> SiLU -> conv3x3 (stride 1, zero padding 1) + bias
// + optional residual, NHWC, with an optional per-(batch, channel) affine
// pre-transform a*x + b applied before the norm (the ResnetBlock's FiLM /
// noise-level conditioning).
//
// Replaces the TPU kernel sr3_tpu/ops/conv_fused.py:117 `_kernel`
// (pallas_call in `_gn_silu_conv3x3_pallas`, :262). On the 16->128 main path
// it runs in every Block of every ResnetBlock and in final_conv: 55 calls per
// UNet forward, C_in 64..1024 at 128^2..8^2, including the C=64 level that
// the TPU kernel had to leave to XLA, and C_out = 3 at final_conv.
//
// On the 64->512 path it runs 35 times per train step (C_in 64..1024 at
// 512^2..32^2) and 35 times per batch-8 512^2 serving step.
//
// The halo entry (sr3_gn_silu_conv3x3_halo) runs K1 on one H-shard of a map
// sharded over ranks (sr3_tpu_torch/parallel/spatial.py): the caller gives
// the per-(batch, channel) mult / add folded from the whole map's
// statistics (K3 on the shard, all-reduced over the ranks) and the raw
// input row above and below the shard from its neighbours, and only launch
// 2 runs, reading those rows where the map's own entry reads zero padding.
// The TPU package runs no kernel under its spatial sharding.
//
// Launch 1 (launch_gn_stats, groupnorm.cu), both routes: group statistics
// of a*x+b and the per-channel mult/add of the normalize, so the normalized
// value of a channel is x*mult + add. Launch 2 (this file) normalizes, SiLUs
// and rounds the input halo to the working type in shared memory -- the
// normalized map never goes to device memory -- with zeros outside the image
// (the padding belongs to the normalized map, so border taps read 0, not
// SiLU(add)), convolves, adds bias and residual in float32 and stores each
// output once in the input's type. Ragged C_out (C_out = 3) and image edges
// are masked.
//
// Float32 route (gn_silu_conv3x3_kernel): float32 FMAs, since TF32 tensor
// cores would keep only ~3 decimal digits. Each block computes 8x8 pixels x
// 64 output channels; per 16-channel chunk it stages the 10x10 halo and the
// 9x64x16 weight slice. Ragged C_in is masked.
//
// Bfloat16 route (gn_silu_conv3x3_wgmma_kernel): implicit GEMM on wgmma.
// Bound on the card: at 2x64x512^2->64 the function moves 201 MB (x,
// residual and y in bf16; 0.060 ms at 3.35 TB/s) for 38.7 GFLOP (0.039 ms on
// the bf16 tensor cores), so bytes bound it at C_in = 64 and operations at
// C_in >= 128. The mma.sync kernel it replaces reached 7% of the tensor
// rate: it restaged the whole 9x64 weight slice of every 16-channel chunk
// for each 64 pixels (3x the bytes the function moves, through L2 and
// shared memory), synchronized twice per 16 channels, and loaded fragments
// with 32-bit shared loads. What this design does about it:
//   * tiles: a block owns 128 output pixels (8 rows x 16 columns of one
//     image; on maps of width <= 8, 8x8 pixels of two images, so the 8x8
//     maps of the 16->128 UNet fill the tile) x BN output channels (8 for
//     C_out = 3, on the one-image tile; 64; or on maps wider than 8 128
//     where that still gives the card two blocks per SM): two consumer
//     warpgroups of 64 pixels each, so each staged weight byte serves 128
//     pixels, twice the old kernel's 64. sr3_gn_silu_conv3x3_tiles counts
//     the launches of each tile, so a check can show which tiles a run
//     took.
//   * weights asynchronously, in a ring: each (tap, 64-channel chunk) stage
//     of the (Cout, 3, 3, Cin) weight -- a BN x 64 K-major tile, 128 bytes a
//     row, in the 128-byte swizzle a wgmma descriptor reads -- goes straight
//     to shared memory by 16-byte cp.async into a ring of 4 stages, 2 stages
//     ahead of use, one __syncthreads per stage.
//   * the raw x halo of each 64-channel chunk (10 x 18 pixels, or 2 x 10 x
//     10) arrives by cp.async with the chunk's first weight stage, into one
//     of two buffers, rows padded to 72 bf16 so ldmatrix reads are free of
//     bank conflicts; all 256 threads normalize, SiLU and round it in place
//     once per element (each thread keeps one 8-channel group, so its
//     scales load once per chunk and image), then 9 taps x 4 k-steps read
//     it.
//   * products: wgmma.mma_async m64nBNk16 (bf16 -> float32), A from
//     registers -- ldmatrix of the shifted window of each tap, one row
//     address per pixel, since a shifted 3x3 window is no layout a
//     shared-memory descriptor can describe -- and B from the ring by
//     descriptor. A stage's products run while the next stage's barrier,
//     copies and (at a chunk's start) normalization proceed: the warpgroup
//     waits for them only before it loads the next A.
//   * epilogue: accumulators through shared memory (reusing the ring), bias
//     and residual added in float32, each output rounded once and stored in
//     16-byte stores where C_out % 8 == 0.
// Shared memory: ring 4 x BN x 128 B + halo 2 x 180 (or 200) x 144 B + 1 KB
// of alignment: 118 KB at BN = 128 (one block per SM), 85 KB at BN = 64 (two
// per SM). The wrapper's rule C_in % 16 == 0 holds; a last chunk of fewer
// than 64 channels is zero-filled.
//
// ptxas (sm_90a, CUDA 12.8, as chip_smoke.py's build phase prints it),
// registers of gn_silu_conv3x3_wgmma_kernel<TW, NI, BN, false>: <16,1,128>
// 164 (one block of 256 threads per SM), <16,1,64> 118 and <8,2,64> 127
// (two per SM), <16,1,8> 107; no spills, and no wgmma serialized by ptxas.
// The halo entry's reads are a separate instantiation (kHalo = true), so
// the map's own entry compiles to the kernel it was before that entry
// existed: a first version that decided the halo rows at run time in the
// one kernel took 9-12% longer in K1's conv on the card.
//
// Tolerance against the plain version (sr3_tpu_torch/ops/conv_fused.py
// `gn_silu_conv3x3_plain`, GroupNorm then F.conv2d with TF32 off): 1e-4 of
// max|ref| in float32 -- float32 sums in another order over 9*C_in <= 9216
// terms; 2e-2 in bfloat16 -- the plain version rounds a*x+b, the conv
// output, the bias and the residual add to bf16 separately (2^-8 relative
// each) where the kernel keeps them in float32 and rounds once.
#include "common.cuh"

namespace {

constexpr int kTH = 8, kTW = 8;  // output pixels per block
constexpr int kTCO = 64;         // output channels per block
constexpr int kCK = 16;          // input channels per shared-memory chunk
constexpr int kThreads = 256;

// float32: FMA arithmetic. kHalo: the halo entry's instantiation, which
// reads the rows above and below the map from top / bottom where given;
// the map's own entry compiles without that code.
template <bool kHalo>
__global__ void __launch_bounds__(kThreads)
    gn_silu_conv3x3_kernel(const float* __restrict__ x,
                           const float* __restrict__ top,
                           const float* __restrict__ bottom,
                           const float* __restrict__ mult,
                           const float* __restrict__ add,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ res, float* __restrict__ y,
                           int H, int W, int Cin, int Cout, int tiles_w) {
  __shared__ float in_s[kCK][kTH + 2][kTW + 2];
  __shared__ __align__(16) float w_s[kCK][9][kTCO];

  const int b = blockIdx.z;
  const int co0 = blockIdx.y * kTCO;
  const int ty0 = (blockIdx.x / tiles_w) * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int tid = threadIdx.x;
  const int cog = tid % 16;  // this thread's 4 output channels: co0+4*cog..
  const int pg = tid / 16;   // this thread's 4 pixels: row py, cols px0..+3
  const int py = pg / 2, px0 = (pg % 2) * 4;

  const float* xb = x + (size_t)b * H * W * Cin;
  const float* mb = mult + (size_t)b * Cin;
  const float* ab = add + (size_t)b * Cin;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCK) {
    __syncthreads();  // the previous chunk's reads of in_s / w_s are done
    for (int i = tid; i < kCK * (kTH + 2) * (kTW + 2); i += kThreads) {
      const int ci = i % kCK, pix = i / kCK;
      const int ry = pix / (kTW + 2), rx = pix % (kTW + 2);
      const int iy = ty0 - 1 + ry, ix = tx0 - 1 + rx;
      const int c = c0 + ci;
      float v = 0.f;
      if (c < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W) {
        v = sr3::silu(fmaf(xb[((size_t)iy * W + ix) * Cin + c], mb[c], ab[c]));
      } else if (kHalo && c < Cin && ix >= 0 && ix < W &&
                 ((iy == -1 && top) || (iy == H && bottom))) {
        // the row above / below the map from the neighbour's halo row
        const float* row = iy < 0 ? top : bottom;
        v = sr3::silu(fmaf(row[((size_t)b * W + ix) * Cin + c], mb[c], ab[c]));
      }
      in_s[ci][ry][rx] = v;
    }
    for (int i = tid; i < kCK * 9 * kTCO; i += kThreads) {
      const int ci = i % kCK, r = i / kCK;
      const int tap = r % 9, co = r / 9;
      const int c = c0 + ci, o = co0 + co;
      float v = 0.f;
      if (c < Cin && o < Cout) v = w[((size_t)o * 9 + tap) * Cin + c];
      w_s[ci][tap][co] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < kCK; ++ci) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        float iv[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) iv[j] = in_s[ci][py + kh][px0 + j];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&w_s[ci][kh * 3 + kw][cog * 4]);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float xv = iv[p + kw];
            acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
          }
        }
      }
    }
  }

  const int oy = ty0 + py;
  if (oy >= H) return;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int ox = tx0 + px0 + p;
    if (ox >= W) continue;
    const size_t base = (((size_t)b * H + oy) * W + ox) * Cout;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = co0 + cog * 4 + q;
      if (o >= Cout) continue;
      float v = acc[p][q] + (bias ? bias[o] : 0.f);
      if (res) v += res[base + o];
      y[base + o] = v;
    }
  }
}

// bfloat16: implicit GEMM on wgmma (M = pixels, N = output channels,
// K = 9 taps x C_in), two consumer warpgroups of 64 pixels each. The tile
// of one block is NI images x kWTH rows x TW columns = 128 pixels by BN
// output channels (template instantiations per map and C_out: the header).
using bf16 = __nv_bfloat16;

constexpr int kWThreads = 256;          // two warpgroups
constexpr int kWM = 128;                // output pixels per block
constexpr int kWTH = 8;                 // tile rows of each image
constexpr int kWK = 64;                 // input channels per chunk (128 B)
constexpr int kWStages = 4;             // weight ring: one (tap, chunk) each
constexpr int kWAhead = kWStages - 2;   // stages in flight ahead of use
constexpr int kHaloLd = kWK + 8;        // bf16 per halo pixel (144 B)

template <int TW, int NI, int BN>
struct WTile {
  static_assert(NI * kWTH * TW == kWM, "a block owns 128 pixels");
  static constexpr int kHW = TW + 2, kHH = kWTH + 2;  // halo width, height
  static constexpr int kHaloPix = NI * kHH * kHW;
  static constexpr int kHaloElems = kHaloPix * kHaloLd;
  static constexpr int kStageElems = BN * kWK;
  static constexpr int kOutLd = BN + 8;  // floats per staged output pixel
  static constexpr size_t kMain =
      sizeof(bf16) * (kWStages * kStageElems + 2 * kHaloElems);
  static constexpr size_t kOut = sizeof(float) * kWM * kOutLd;
  // + 1 KB to align the ring to the 1024-byte swizzle atom
  static constexpr size_t kSmem = 1024 + (kMain > kOut ? kMain : kOut);
};

template <int TW, int NI, int BN, bool kHalo>
__global__ void __launch_bounds__(kWThreads, BN == 128 ? 1 : 2)
    gn_silu_conv3x3_wgmma_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ top,
                                 const bf16* __restrict__ bottom,
                                 const float* __restrict__ mult,
                                 const float* __restrict__ add,
                                 const bf16* __restrict__ w,
                                 const float* __restrict__ bias,
                                 const bf16* __restrict__ res,
                                 bf16* __restrict__ y, int B, int H, int W,
                                 int Cin, int Cout, int tiles_w, int vec) {
  using T = WTile<TW, NI, BN>;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* base =
      wg_smem + ((1024 - (sr3::smem_u32(wg_smem) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(base);     // [kWStages][BN][kWK]
  bf16* halo = ring + kWStages * T::kStageElems;  // [2][kHaloPix][kHaloLd]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4;
  const int co0 = blockIdx.y * BN;
  const int ty0 = (blockIdx.x / tiles_w) * kWTH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int b0 = blockIdx.z * NI;
  const int nstages = 9 * ((Cin + kWK - 1) / kWK);

  // batch element, row and column of halo pixel `pix`; false outside the
  // batch or the map (the zero padding), but for kHalo true on the row
  // above / below the map where top / bottom is given
  auto halo_at = [&](int pix, int& bb, int& iy, int& ix) {
    const int img = pix / (T::kHH * T::kHW), r = pix % (T::kHH * T::kHW);
    bb = b0 + img;
    iy = ty0 - 1 + r / T::kHW;
    ix = tx0 - 1 + r % T::kHW;
    const bool in = bb < B && iy >= 0 && iy < H && ix >= 0 && ix < W;
    if constexpr (kHalo) {
      return in || (bb < B && ix >= 0 && ix < W &&
                    ((iy == -1 && top) || (iy == H && bottom)));
    } else {
      return in;
    }
  };

  // Stage s = (chunk s / 9, tap s % 9): its BN x 64 weight slice into ring
  // slot s % kWStages, 16-byte chunk c of row n at chunk c ^ (n % 8) (the
  // 128-byte swizzle the descriptor names); a chunk's first stage also
  // brings the chunk's raw halo. Zero-filled past C_out, C_in and the map.
  auto copy_stage = [&](int s) {
    const int tap = s % 9, c0 = (s / 9) * kWK;
    bf16* dst = ring + (s % kWStages) * T::kStageElems;
    for (int i = tid; i < BN * 8; i += kWThreads) {
      const int n = i / 8, c = i % 8;
      const bool ok = co0 + n < Cout && c0 + 8 * c < Cin;
      const bf16* src =
          ok ? w + ((size_t)(co0 + n) * 9 + tap) * Cin + c0 + 8 * c : w;
      sr3::cp_async16(dst + n * kWK + 8 * (c ^ (n % 8)), src, ok);
    }
    if (tap == 0) {
      bf16* hb = halo + (s / 9 % 2) * T::kHaloElems;
      for (int i = tid; i < T::kHaloPix * 8; i += kWThreads) {
        const int pix = i / 8, c = i % 8;
        int bb, iy, ix;
        const bool ok = halo_at(pix, bb, iy, ix) && c0 + 8 * c < Cin;
        const bf16* src;
        if constexpr (kHalo) {
          src = !ok ? x
                : iy >= 0 && iy < H
                    ? x + (((size_t)bb * H + iy) * W + ix) * Cin + c0 + 8 * c
                    : (iy < 0 ? top : bottom) + ((size_t)bb * W + ix) * Cin +
                          c0 + 8 * c;
        } else {
          src = ok ? x + (((size_t)bb * H + iy) * W + ix) * Cin + c0 + 8 * c
                   : x;
        }
        sr3::cp_async16(hb + pix * kHaloLd + 8 * c, src, ok);
      }
    }
  };

  // The chunk's halo normalized and SiLU'd in place, once per element, and
  // rounded to bf16; the padding and channels past C_in stay zero. A
  // thread keeps one 8-channel group (kWThreads % 8 == 0), so its scales
  // and shifts are loaded once per chunk and image; the SiLU takes the fast
  // exponential and division, far inside the bf16 rounding that follows.
  auto normalize = [&](int chunk) {
    const int c = tid % 8, ch = chunk * kWK + 8 * c;
    if (ch >= Cin) return;
    float mv[NI][8], av[NI][8];
#pragma unroll
    for (int img = 0; img < NI; ++img) {
      const int bb = min(b0 + img, B - 1);
      const float4* m4 =
          reinterpret_cast<const float4*>(mult + (size_t)bb * Cin + ch);
      const float4* a4 =
          reinterpret_cast<const float4*>(add + (size_t)bb * Cin + ch);
      const float4 m0 = __ldg(m4), m1 = __ldg(m4 + 1);
      const float4 a0 = __ldg(a4), a1 = __ldg(a4 + 1);
      mv[img][0] = m0.x, mv[img][1] = m0.y, mv[img][2] = m0.z;
      mv[img][3] = m0.w, mv[img][4] = m1.x, mv[img][5] = m1.y;
      mv[img][6] = m1.z, mv[img][7] = m1.w;
      av[img][0] = a0.x, av[img][1] = a0.y, av[img][2] = a0.z;
      av[img][3] = a0.w, av[img][4] = a1.x, av[img][5] = a1.y;
      av[img][6] = a1.z, av[img][7] = a1.w;
    }
    bf16* hb = halo + (chunk % 2) * T::kHaloElems + 8 * c;
    for (int pix = tid / 8; pix < T::kHaloPix; pix += kWThreads / 8) {
      int bb, iy, ix;
      if (!halo_at(pix, bb, iy, ix)) continue;
      const bool second = NI > 1 && bb > b0;
      uint4* at = reinterpret_cast<uint4*>(hb + pix * kHaloLd);
      uint4 raw = *at;
      __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(v[j]);
        const float u0 = fmaf(f.x, second ? mv[NI - 1][2 * j] : mv[0][2 * j],
                              second ? av[NI - 1][2 * j] : av[0][2 * j]);
        const float u1 =
            fmaf(f.y, second ? mv[NI - 1][2 * j + 1] : mv[0][2 * j + 1],
                 second ? av[NI - 1][2 * j + 1] : av[0][2 * j + 1]);
        v[j] = __floats2bfloat162_rn(__fdividef(u0, 1.f + __expf(-u0)),
                                     __fdividef(u1, 1.f + __expf(-u1)));
      }
      *at = raw;
    }
  };

  // ldmatrix row address of this lane's A row: pixel p of the block,
  // channels 8 (lane / 16).. of a 16-deep k-step
  const int p = 64 * wg + 16 * (warp % 4) + lane % 16;
  const int pq = p % (kWTH * TW);
  const int a_off =
      (((p / (kWTH * TW)) * T::kHH + pq / TW) * T::kHW + pq % TW) * kHaloLd +
      8 * (lane / 16);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kWAhead; ++s) {
    if (s < nstages) copy_stage(s);
    sr3::cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    sr3::cp_async_wait<kWAhead - 1>();
    sr3::fence_proxy_async();  // the weights are read by the async proxy
    __syncthreads();  // stage s landed for all; stage s - 2's slot is free
    if (s % 9 == 0) {
      normalize(s / 9);
      __syncthreads();
    }
    if (s + kWAhead < nstages) copy_stage(s + kWAhead);
    sr3::cp_async_commit();  // (empty near the end: the count stays exact)

    const int tap = s % 9;
    const bf16* ap = halo + (s / 9 % 2) * T::kHaloElems + a_off +
                     ((tap / 3) * T::kHW + tap % 3) * kHaloLd;
    sr3::wgmma_wait<0>();  // stage s - 1's products have read their A
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sr3::ldmatrix_x4(a[kk], ap + 16 * kk);
    const uint32_t wb =
        sr3::smem_u32(ring + (s % kWStages) * T::kStageElems);
    sr3::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sr3::wgmma_rs<BN>(acc, a[kk], sr3::wgmma_desc_sw128(wb + 32 * kk));
    sr3::wgmma_commit();
  }
  sr3::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sr3::fence_operand(acc[i]);
  sr3::cp_async_wait<0>();
  __syncthreads();  // both warpgroups are done with the ring and the halo

  // accumulators through shared memory, so that each output pixel's
  // channels leave in 16-byte stores
  float* out_s = reinterpret_cast<float*>(base);  // [kWM][kOutLd]
  {
    const int m0 = 64 * wg + 16 * (warp % 4) + lane / 4, n0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(out_s + (m0 + 8 * r) * T::kOutLd + 8 * j +
                                   n0) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
  __syncthreads();

  // bias and residual added in float32, each output rounded once
  for (int i = tid; i < kWM * (BN / 8); i += kWThreads) {
    const int m = i / (BN / 8), c = 8 * (i % (BN / 8));
    const int mq = m % (kWTH * TW);
    const int bb = b0 + m / (kWTH * TW), oy = ty0 + mq / TW,
              ox = tx0 + mq % TW, o = co0 + c;
    if (bb >= B || oy >= H || ox >= W || o >= Cout) continue;
    const size_t at = (((size_t)bb * H + oy) * W + ox) * Cout + o;
    const float* src = out_s + m * T::kOutLd + c;
    if (vec) {  // C_out % 8 == 0, y and res 16-byte aligned
      float v[8];
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
      if (bias) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += bias[o + j];
      }
      if (res) {
        uint4 r = *reinterpret_cast<const uint4*>(res + at);
        const __nv_bfloat162* rv = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(rv[j]);
          v[2 * j] += f.x;
          v[2 * j + 1] += f.y;
        }
      }
      uint4 out;
      uint32_t* ov = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ov[j] = sr3::pack_bf16(v[2 * j], v[2 * j + 1]);
      *reinterpret_cast<uint4*>(y + at) = out;
    } else {
      for (int j = 0; j < 8 && o + j < Cout; ++j) {
        float v = src[j] + (bias ? bias[o + j] : 0.f);
        if (res) v += __bfloat162float(res[at + j]);
        y[at + j] = __float2bfloat16(v);
      }
    }
  }
}

struct ConvArgs {
  const bf16 *x, *top, *bottom;
  const float *mult, *add;
  const bf16* w;
  const float* bias;
  const bf16* res;
  bf16* y;
  int B, H, W, Cin, Cout, vec;
};

// Launches of each bfloat16 tile since the last reset, by tile index (the
// order of sr3_gn_silu_conv3x3_tiles).
std::atomic<long long> g_tile_launches[4];

template <int TW, int NI, int BN, bool kHalo>
cudaError_t launch_wgmma_as(const ConvArgs& a, int tile, cudaStream_t st) {
  using T = WTile<TW, NI, BN>;
  static sr3::SmemLimit limit;
  const auto kernel = gn_silu_conv3x3_wgmma_kernel<TW, NI, BN, kHalo>;
  cudaError_t err =
      sr3::raise_smem_limit(limit, (const void*)kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (a.W + TW - 1) / TW;
  const dim3 grid(((a.H + kWTH - 1) / kWTH) * tiles_w, (a.Cout + BN - 1) / BN,
                  (a.B + NI - 1) / NI);
  kernel<<<grid, kWThreads, T::kSmem, st>>>(a.x, a.top, a.bottom, a.mult,
                                            a.add, a.w, a.bias,
                                            a.res, a.y, a.B, a.H, a.W, a.Cin,
                                            a.Cout, tiles_w, a.vec);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    g_tile_launches[tile].fetch_add(1, std::memory_order_relaxed);
  return err;
}

// The halo entry's instantiation when it is given a halo row, else the
// map's own.
template <int TW, int NI, int BN>
cudaError_t launch_wgmma(const ConvArgs& a, int tile, cudaStream_t st) {
  return a.top || a.bottom ? launch_wgmma_as<TW, NI, BN, true>(a, tile, st)
                           : launch_wgmma_as<TW, NI, BN, false>(a, tile, st);
}

// Tiles of 8 x 16 pixels of one image, or on maps of width <= 8 tiles of
// 8 x 8 pixels of two images, so an 8x8 map fills the 128 pixels. Output
// channels per block: 8 for final_conv's C_out = 3 (at any width); else 64,
// or 128 on maps wider than 8 where C_out > 64 and 128 still gives the card
// two blocks per SM (on maps of width <= 8 that would take a batch of 131 or
// more).
cudaError_t launch_bf16(const ConvArgs& a, cudaStream_t st) {
  if (a.Cout <= 8) return launch_wgmma<16, 1, 8>(a, 2, st);
  if (a.W <= 8) return launch_wgmma<8, 2, 64>(a, 3, st);
  int sms = 0;
  const cudaError_t err = sr3::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long blocks128 = (long long)((a.H + kWTH - 1) / kWTH) *
                              ((a.W + 15) / 16) * ((a.Cout + 127) / 128) * a.B;
  if (a.Cout <= 64 || blocks128 < 2LL * sms)
    return launch_wgmma<16, 1, 64>(a, 1, st);
  return launch_wgmma<16, 1, 128>(a, 0, st);
}

dim3 conv_grid(int B, int H, int W, int Cout, int* tiles_w) {
  const int tiles_h = (H + kTH - 1) / kTH;
  *tiles_w = (W + kTW - 1) / kTW;
  return dim3(tiles_h * *tiles_w, (Cout + kTCO - 1) / kTCO, B);
}

// The conv launch of both routes: y = conv3x3(SiLU(x * mult + add)) + bias
// (+ res), with the rows above and below the map from top / bottom where
// they are given (else zero padding after the activation).
cudaError_t launch_conv(const void* x, const void* top, const void* bottom,
                        const float* mult, const float* add, const void* w,
                        const float* bias, const void* res, void* y, int B,
                        int H, int W, int Cin, int Cout, int dtype,
                        cudaStream_t st) {
  if (dtype == sr3::kBF16) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
          reinterpret_cast<uintptr_t>(top) |
          reinterpret_cast<uintptr_t>(bottom) |
          reinterpret_cast<uintptr_t>(mult) |
          reinterpret_cast<uintptr_t>(add)) % 16) == 0;
    if (!aligned) return cudaErrorInvalidValue;
    const int vec = Cout % 8 == 0 &&
                    ((reinterpret_cast<uintptr_t>(y) |
                      reinterpret_cast<uintptr_t>(res)) % 16) == 0;
    const ConvArgs a{static_cast<const bf16*>(x),
                     static_cast<const bf16*>(top),
                     static_cast<const bf16*>(bottom), mult, add,
                     static_cast<const bf16*>(w), bias,
                     static_cast<const bf16*>(res), static_cast<bf16*>(y),
                     B, H, W, Cin, Cout, vec};
    return launch_bf16(a, st);
  }
  int tiles_w;
  const dim3 grid = conv_grid(B, H, W, Cout, &tiles_w);
  const auto kernel = top || bottom ? gn_silu_conv3x3_kernel<true>
                                    : gn_silu_conv3x3_kernel<false>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(top),
      static_cast<const float*>(bottom), mult, add,
      static_cast<const float*>(w), bias, static_cast<const float*>(res),
      static_cast<float*>(y), H, W, Cin, Cout, tiles_w);
  return cudaGetLastError();
}

}  // namespace

// y = conv3x3(SiLU(GroupNorm(pre_scale*x + pre_bias))) + bias (+ res).
// x: (B,H,W,Cin), w: (Cout,3,3,Cin), res/y: (B,H,W,Cout), all of dtype;
// pre_scale/pre_bias: (B,Cin) float32 or null; gamma/beta: (Cin) float32;
// bias: (Cout) float32 or null; workspace: sr3_gn_workspace_floats(B, H*W,
// Cin, G, dtype) float32 scratch (groupnorm.cu); tickets: B*Cin int32, 0
// before the call and left 0 by it. bfloat16 needs Cin % 16 == 0.
// Returns the CUDA error code (0 on success).
extern "C" int sr3_gn_silu_conv3x3(const void* x, const float* pre_scale,
                                   const float* pre_bias, const float* gamma,
                                   const float* beta, const void* w,
                                   const float* bias, const void* res,
                                   void* y, float* workspace, int* tickets,
                                   int B, int H, int W, int Cin, int Cout,
                                   int G, float eps, int dtype,
                                   void* stream) {
  if (dtype == sr3::kBF16 && Cin % kCK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = sr3::launch_gn_stats(x, dtype, pre_scale, pre_bias, gamma,
                                         beta, workspace, tickets, B, H * W,
                                         Cin, G, eps, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_conv(x, nullptr, nullptr, workspace,
                          sr3::gn_add(workspace, B, Cin), w, bias, res, y, B,
                          H, W, Cin, Cout, dtype, st);
}

// K1 on one H-shard of a map sharded over ranks (the halo entry): the conv
// launch alone, with the caller's per-(batch, channel) normalize -- the
// normalized value of x is x * mult + add, mult / add (B,Cin) float32 from
// the whole map's statistics, folded with the GroupNorm affine and the
// pre-affine -- and the shard's halo rows: top / bottom (B,1,W,Cin) of
// dtype, the raw input row above / below the shard, or null at the image
// border (zero padding after the activation, as in sr3_gn_silu_conv3x3).
// x: (B,H,W,Cin) the shard, w: (Cout,3,3,Cin), res/y: (B,H,W,Cout); bias:
// (Cout) float32 or null. bfloat16 needs Cin % 16 == 0 and every pointer
// but y / res 16-byte aligned. Returns the CUDA error code (0 on success).
extern "C" int sr3_gn_silu_conv3x3_halo(const void* x, const void* top,
                                        const void* bottom, const float* mult,
                                        const float* add, const void* w,
                                        const float* bias, const void* res,
                                        void* y, int B, int H, int W, int Cin,
                                        int Cout, int dtype, void* stream) {
  if (dtype == sr3::kBF16 && Cin % kCK) return (int)cudaErrorInvalidValue;
  return (int)launch_conv(x, top, bottom, mult, add, w, bias, res, y, B, H,
                          W, Cin, Cout, dtype,
                          static_cast<cudaStream_t>(stream));
}

// Launches of each bfloat16 tile <TW, NI, BN> since the last reset, into
// counts[0..3] in the order <16,1,128>, <16,1,64>, <16,1,8>, <8,2,64>;
// reset != 0 sets them to 0 after reading. Returns the number of tiles.
extern "C" int sr3_gn_silu_conv3x3_tiles(long long* counts, int reset) {
  for (int i = 0; i < 4; ++i)
    counts[i] = reset ? g_tile_launches[i].exchange(0)
                      : g_tile_launches[i].load();
  return 4;
}
