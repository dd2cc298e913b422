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
// With post_scale / post_shift the entry serves guided-diffusion's
// ADM ResBlocks, which scale and shift the normalized map per (batch,
// channel) after the norm, GN(x)*(1 + s) + t: 75 calls a forward of the
// 128->512 upsampler (C_in 192..1536 at 512^2..16^2; its up path
// concatenates up to 1536 channels, which K1's statistics launch takes up
// to kGnStatsMaxChannels).
//
// Launch 1 (launch_gn_stats, groupnorm.cu), both routes: group statistics
// of a*x+b and the per-channel mult/add of the normalize, so the normalized
// value of a channel is x*mult + add; with the scale-shift, mult*(1 + s)
// and add*(1 + s) + t. Launch 2 (this file) normalizes, SiLUs
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
// Bfloat16 route: implicit GEMM on wgmma (M = output pixels, N = output
// channels, K = 9 taps x C_in), A from registers -- ldmatrix of the
// shifted window of each tap out of the normalized halo, one row address a
// pixel, since a shifted 3x3 window is no layout a shared-memory descriptor
// can describe -- and B, a BN x 64 K-major weight slice of one (tap,
// 64-channel chunk) in the 128-byte swizzle, by descriptor.
//
// What bounds it on the card: at 8x192x512^2->192 (the ADM's main shape)
// 1.39 TFLOP, 1.407 ms on the bf16 tensor cores, against 2.4 GB of x, y
// and the residual (0.72 ms at 3.35 TB/s): operations. At 64 channels
// (8x64x512^2->64 + FiLM + residual) 0.155 ms of operations against 0.24
// ms of bytes: bytes, and the halo's normalization (an exponential and a
// division an input element) is as long as a chunk's products. The
// previous kernel (one block a 128-pixel tile, cp.async, all 256 threads
// normalizing between barriers) reached 18-27% of the bound at C_out > 64:
// its tensor pipe drained at every stage (A loaded into the one register
// set the products read, wgmma_wait<0> before the next ldmatrix, a
// __syncthreads a stage), no products ran while the halo was normalized,
// C_out = 192 ran as two N-tiles of 128 (a quarter of the products on zero
// weights, each input normalized twice), and each tile's prologue and
// epilogue overlapped nothing (one block an SM at BN 128).
//
// gn_silu_conv3x3_tma_kernel<TW, NI, BN> (every C_out > 8), what each part
// does about that:
//   * one persistent block an SM (384 threads, 161-230 KB of shared
//     memory) walks items blockIdx.x, + gridDim.x, ...: item it is pixel
//     tile it / n_tiles (NI images x 8 rows x TW columns = 128 pixels: 8 x
//     16 of one image, or on maps of width <= 8, 8 x 8 of two) by N-tile it
//     % n_tiles, so the N-tiles of one pixel tile run side by side on
//     neighbouring SMs while its halo is in L2, and one item's epilogue
//     runs while the producer and the normalizers go on with the next.
//   * warp 0, one lane, issues every copy by TMA: each chunk's raw x halo
//     (a 4-D box of 64 channels x (TW + 2) x 10 x NI of NHWC x, zero-filled
//     outside the map and past C_in) into one of two buffers, one chunk
//     ahead of the chunk's weight slices, which go into a ring of up to 8
//     stages (w seen as (C_out, 9, C_in): a box of 64 channels x 1 tap x
//     BN rows, zero past C_out and C_in), each under full / empty
//     mbarriers.
//   * warps 1-3 (96 threads, no wgmma) normalize chunk c + 1's raw halo
//     into the other of two normalized buffers while the consumers run
//     chunk c's nine taps: SiLU(x * mult + add) rounded to bf16, 0 on the
//     padding after the activation (not SiLU(add)) and past C_in, and for
//     the halo entry the rows above / below the map read from top / bottom
//     (a run-time test here, off the products' path).
//   * warpgroups 1 and 2 (64 pixels each) run the products: kASets A
//     register sets (3 at BN <= 128, 2 at 192 and 256, where the
//     accumulators take the registers) let the next taps' ldmatrix run
//     while a tap's four m64nBNk16 products do (wgmma_wait<kASets - 1>);
//     no __syncthreads in the loop: a weight stage goes back to the
//     producer on its empty barrier once its products retire, a normalized
//     buffer after its chunk's last tap's loads.
//   * the N-tile follows C_out and the items (conv_plan): BN 256, 192, 128
//     or 64 on wider maps, 128 or 64 on maps of width <= 8, whichever gives
//     the least waves of items times (BN + kItemCost) -- one N-tile of 192
//     for the ADM's 192 channels, 256 for SR3's 256 and 512 at 32^2 and
//     16^2 at batch 128, smaller on small maps. sr3_gn_silu_conv3x3_tiles
//     counts the launches of each class, sr3_gn_silu_conv3x3_plan reports
//     the plan (mirrored by tests/torch_port_conv_plan.py).
//   * epilogue from the fragments: bias and residual added in float32, each
//     output rounded once, two channels a 4-byte store (the residual read
//     while the last products run at BN <= 128); no atomics and no split
//     over K, so two calls give the same bits.
//   Registers (setmaxnreg): the producer warpgroup 88, the consumers 208.
//
// gn_silu_conv3x3_small_kernel (C_out <= 8, final_conv's 3 channels): the
// previous design at one N-tile of 8 -- a block an 8 x 16 tile, cp.async
// weight ring and halo, all 256 threads normalizing, two blocks an SM --
// where the products are a sliver of the work and the normalization holds
// the block either way; kHalo instantiations for the halo entry.
//
// ptxas (sm_90a, CUDA 12.8, chip_smoke.py's build phase): every
// gn_silu_conv3x3_tma_kernel class 168 registers at launch (setmaxnreg 88
// / 208), no spills, no wgmma serialized; gn_silu_conv3x3_small_kernel 112
// (kHalo 114), no spills; the float32 kernel 64 (8 B spill; kHalo none).
//
// Tolerance against the plain version (sr3_tpu_torch/ops/conv_fused.py
// `gn_silu_conv3x3_plain`, GroupNorm then F.conv2d with TF32 off): 1e-4 of
// max|ref| in float32 -- float32 sums in another order over 9*C_in <= 9216
// terms; 2e-2 in bfloat16 -- the plain version rounds a*x+b, the conv
// output, the bias and the residual add to bf16 separately (2^-8 relative
// each) where the kernel keeps them in float32 and rounds once.
#include <climits>

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

// 8 floats from 16-byte aligned global memory.
__device__ __forceinline__ void load8(float* v, const float* p) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// Eight bf16 channels SiLU(x * m + a), rounded to bf16 once, with image
// img's scales of an NI-image tile; the SiLU takes the fast exponential and
// division, far inside the bf16 rounding that follows.
template <int NI>
__device__ __forceinline__ uint4 gn_silu8(uint4 raw, const float (&m)[NI][8],
                                          const float (&a)[NI][8], int img) {
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool second = NI > 1 && img > 0;
    const float2 f = __bfloat1622float2(v[j]);
    const float u0 = fmaf(f.x, second ? m[NI - 1][2 * j] : m[0][2 * j],
                          second ? a[NI - 1][2 * j] : a[0][2 * j]);
    const float u1 =
        fmaf(f.y, second ? m[NI - 1][2 * j + 1] : m[0][2 * j + 1],
             second ? a[NI - 1][2 * j + 1] : a[0][2 * j + 1]);
    v[j] = __floats2bfloat162_rn(__fdividef(u0, 1.f + __expf(-u0)),
                                 __fdividef(u1, 1.f + __expf(-u1)));
  }
  return raw;
}

// bfloat16, C_out <= 8 (final_conv's C_out = 3): implicit GEMM on wgmma
// (M = pixels, N = output channels, K = 9 taps x C_in), a block of 8 x 16
// pixels of one image by 8 output channels, two consumer warpgroups of 64
// pixels each; the header's "small C_out" paragraph.
using bf16 = __nv_bfloat16;

constexpr int kWThreads = 256;          // two warpgroups
constexpr int kWM = 128;                // output pixels per tile
constexpr int kWTH = 8;                 // tile rows of each image
constexpr int kWK = 64;                 // input channels per chunk (128 B)
constexpr int kWStages = 4;             // weight ring: one (tap, chunk) each
constexpr int kWAhead = kWStages - 2;   // stages in flight ahead of use
constexpr int kHaloLd = kWK + 8;        // bf16 per halo pixel (144 B)
constexpr int kSmallBN = 8;             // output channels of a small block

struct WTile {
  static constexpr int TW = 16, BN = kSmallBN;
  static constexpr int kHW = TW + 2, kHH = kWTH + 2;  // halo width, height
  static constexpr int kHaloPix = kHH * kHW;
  static constexpr int kHaloElems = kHaloPix * kHaloLd;
  static constexpr int kStageElems = BN * kWK;
  static constexpr int kOutLd = BN + 8;  // floats per staged output pixel
  static constexpr size_t kMain =
      sizeof(bf16) * (kWStages * kStageElems + 2 * kHaloElems);
  static constexpr size_t kOut = sizeof(float) * kWM * kOutLd;
  // + 1 KB to align the ring to the 1024-byte swizzle atom
  static constexpr size_t kSmem = 1024 + (kMain > kOut ? kMain : kOut);
};

template <bool kHalo>
__global__ void __launch_bounds__(kWThreads, 2)
    gn_silu_conv3x3_small_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ top,
                                 const bf16* __restrict__ bottom,
                                 const float* __restrict__ mult,
                                 const float* __restrict__ add,
                                 const bf16* __restrict__ w,
                                 const float* __restrict__ bias,
                                 const bf16* __restrict__ res,
                                 bf16* __restrict__ y, int B, int H, int W,
                                 int Cin, int Cout, int tiles_w) {
  using T = WTile;
  constexpr int TW = T::TW, BN = T::BN;
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
  const int bb = blockIdx.z;
  const int nstages = 9 * ((Cin + kWK - 1) / kWK);

  // row and column of halo pixel `pix`; false outside the map (the zero
  // padding), but for kHalo true on the row above / below the map where
  // top / bottom is given
  auto halo_at = [&](int pix, int& iy, int& ix) {
    iy = ty0 - 1 + pix / T::kHW;
    ix = tx0 - 1 + pix % T::kHW;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    if constexpr (kHalo) {
      return in || (ix >= 0 && ix < W &&
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
        int iy, ix;
        const bool ok = halo_at(pix, iy, ix) && c0 + 8 * c < Cin;
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
  // rounded to bf16; the padding and channels past C_in stay zero.
  auto normalize = [&](int chunk) {
    const int c = tid % 8, ch = chunk * kWK + 8 * c;
    if (ch >= Cin) return;
    float mv[1][8], av[1][8];
    load8(mv[0], mult + (size_t)bb * Cin + ch);
    load8(av[0], add + (size_t)bb * Cin + ch);
    bf16* hb = halo + (chunk % 2) * T::kHaloElems + 8 * c;
    for (int pix = tid / 8; pix < T::kHaloPix; pix += kWThreads / 8) {
      int iy, ix;
      if (!halo_at(pix, iy, ix)) continue;
      uint4* at = reinterpret_cast<uint4*>(hb + pix * kHaloLd);
      *at = gn_silu8<1>(*at, mv, av, 0);
    }
  };

  // ldmatrix row address of this lane's A row: pixel p of the block,
  // channels 8 (lane / 16).. of a 16-deep k-step
  const int p = 64 * wg + 16 * (warp % 4) + lane % 16;
  const int a_off =
      ((p / TW) * T::kHW + p % TW) * kHaloLd + 8 * (lane / 16);

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

  // accumulators through shared memory, then bias and residual added in
  // float32, each output rounded once
  float* out_s = reinterpret_cast<float*>(base);  // [kWM][kOutLd]
  {
    const int m0 = 64 * wg + 16 * (warp % 4) + lane / 4, n0 = 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out_s + (m0 + 8 * r) * T::kOutLd + n0) =
          make_float2(acc[2 * r], acc[2 * r + 1]);
  }
  __syncthreads();
  for (int m = tid; m < kWM; m += kWThreads) {
    const int oy = ty0 + m / TW, ox = tx0 + m % TW;
    if (oy >= H || ox >= W) continue;
    const size_t at = (((size_t)bb * H + oy) * W + ox) * Cout + co0;
    for (int c = 0; c < BN && co0 + c < Cout; ++c) {
      float v = out_s[m * T::kOutLd + c] + (bias ? bias[co0 + c] : 0.f);
      if (res) v += __bfloat162float(res[at + c]);
      y[at + c] = __float2bfloat16(v);
    }
  }
}

// bfloat16, C_out > 8: the Hopper kernel (the header's design). Block
// roles: warp 0 issues every TMA load (lane 0), warps 1-3 normalize (the
// producer warpgroup, setmaxnreg kProducerRegs), warpgroups 1 and 2 run
// the products (kConsumerRegs). One block per SM walks the items it, it +
// gridDim.x, ...; item it is pixel tile it / n_tiles (NI images x kWTH
// rows x TW columns = 128 pixels) by output channels (it % n_tiles) * BN..
constexpr int kTThreads = 384;
constexpr int kNormThreads = 96;      // warps 1-3
constexpr int kProducerRegs = 88;     // 128 x 88 + 256 x 208 <= 65,536
constexpr int kConsumerRegs = 208;
constexpr int kConsumerWarps = 8;     // arrivals that empty a weight stage
constexpr int kSmemMax = 232448;      // shared memory a block can use
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 256;

// Shared memory of a class: the weight ring (kStages x BN rows of 128
// bytes, 128-byte swizzled, 1024-byte aligned), two raw halo buffers (the
// TMA box, 128 bytes a pixel), two normalized halo buffers (kHaloLd bf16 a
// pixel: ldmatrix rows free of bank conflicts), the barriers.
template <int TW, int NI, int BN>
struct TTile {
  static_assert(NI * kWTH * TW == kWM, "a tile is 128 pixels");
  static constexpr int kHW = TW + 2, kHH = kWTH + 2;  // halo width, height
  static constexpr int kHaloPix = NI * kHH * kHW;
  static constexpr int kRawBytes = kHaloPix * kWK * 2;
  static constexpr int kNormBytes = kHaloPix * kHaloLd * 2;
  static constexpr int kStageBytes = BN * kWK * 2;
  static constexpr int kFit = (kSmemMax - 1024 - 2 * kRawBytes -
                               2 * kNormBytes - kBarBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static_assert(kStages >= 2, "two weight stages fit");
  static_assert(8 * (2 * kStages + 8) <= kBarBytes, "barriers");
  static_assert(kRawBytes % 128 == 0 && kNormBytes % 16 == 0, "alignment");
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes +
                                  2 * kRawBytes + 2 * kNormBytes + kBarBytes;
};

struct Tile {
  int b0, ty0, tx0, co0;  // first image, row, column, output channel
};

// A register sets of a consumer warpgroup: tap t + 1's ldmatrix, and with
// three sets tap t + 2's too, overlap tap t's products. Three where the
// products of a tap are short (BN <= 128), two where the accumulators take
// the registers and the ring holds fewer stages (BN 192, 256).
template <int BN>
constexpr int kASets = BN <= 128 ? 3 : 2;

// A consumer warpgroup's step k of the item whose chunks start at q0: A of
// tap k % 9 of chunk q0 + k / 9 by ldmatrix into `a` while earlier steps'
// products run (the chunk's normalized halo released after its last tap's
// loads), then this step's four products on weight stage s; the stage of
// the step kASets - 1 back is released once its products have retired.
template <class T, int BN>
__device__ __forceinline__ void conv_step(
    float (&acc)[BN / 2], uint32_t (&a)[4][4], int q0, int k, int& s,
    int lane, int a_off, const __nv_bfloat16* norm, uint32_t ring_addr,
    uint64_t* w_full, uint64_t* w_empty, uint64_t* norm_full,
    uint64_t* norm_empty) {
  constexpr int kBack = kASets<BN> - 1;
  const int q = q0 + k / 9, tap = k % 9, nslot = q % 2;
  if (tap == 0) sr3::mbar_wait(norm_full + nslot, (q / 2) & 1);
  const __nv_bfloat16* ap = norm + nslot * (T::kNormBytes / 2) + a_off +
                            ((tap / 3) * T::kHW + tap % 3) * kHaloLd;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sr3::ldmatrix_x4(a[kk], ap + 16 * kk);
  if (tap == 8) {
    __syncwarp();
    if (lane == 0) sr3::mbar_arrive(norm_empty + nslot);
  }
  const int slot = s % T::kStages;
  sr3::mbar_wait(w_full + slot, (s / T::kStages) & 1);
  const uint64_t desc =
      sr3::wgmma_desc_sw128(ring_addr + slot * T::kStageBytes);
  sr3::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sr3::wgmma_rs<BN>(acc, a[kk], desc + ((32 * kk) >> 4));
  sr3::wgmma_commit();
  sr3::wgmma_wait<kBack>();
  if (k >= kBack) {
    __syncwarp();
    if (lane == 0) sr3::mbar_arrive(w_empty + (s - kBack) % T::kStages);
  }
  ++s;
}

template <int TW, int NI, int BN>
__global__ void __launch_bounds__(kTThreads, 1)
    gn_silu_conv3x3_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap wmap,
                               const bf16* __restrict__ top,
                               const bf16* __restrict__ bottom,
                               const float* __restrict__ mult,
                               const float* __restrict__ add,
                               const float* __restrict__ bias,
                               const bf16* __restrict__ res,
                               bf16* __restrict__ y, int B, int H, int W,
                               int Cin, int Cout, int tiles_w, int tiles_hw,
                               int n_tiles, int items, int vec) {
  using T = TTile<TW, NI, BN>;
  extern __shared__ uint8_t tc_smem[];
  uint8_t* base =
      tc_smem + ((1024 - (sr3::smem_u32(tc_smem) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(base);
  bf16* raw = reinterpret_cast<bf16*>(base + T::kStages * T::kStageBytes);
  bf16* norm = raw + T::kRawBytes;  // two raw buffers of kRawBytes / 2
  uint64_t* w_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(norm) + 2 * T::kNormBytes);
  uint64_t* w_empty = w_full + T::kStages;
  uint64_t* raw_full = w_empty + T::kStages;
  uint64_t* raw_empty = raw_full + 2;
  uint64_t* norm_full = raw_empty + 2;
  uint64_t* norm_empty = norm_full + 2;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nch = (Cin + kWK - 1) / kWK;
  // this block's items and chunks: chunk q is chunk q % nch of its item
  // q / nch, in the order every role walks them
  const int mine = (int)blockIdx.x < items
                       ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int nq = mine * nch;
  auto tile_of = [&](int q) {
    const int it = blockIdx.x + (q / nch) * gridDim.x;
    const int pt = it / n_tiles, r = pt % tiles_hw;
    return Tile{(pt / tiles_hw) * NI, (r / tiles_w) * kWTH,
                (r % tiles_w) * TW, (it % n_tiles) * BN};
  };

  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      sr3::mbar_init(w_full + s, 1);
      sr3::mbar_init(w_empty + s, kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      sr3::mbar_init(raw_full + i, 1);
      sr3::mbar_init(raw_empty + i, kNormThreads);
      sr3::mbar_init(norm_full + i, kNormThreads);
      sr3::mbar_init(norm_empty + i, kConsumerWarps);
    }
    sr3::mbar_init_fence();
  }
  __syncthreads();

  // one if / else for the roles, which never meet again (setmaxnreg)
  if (warp < 4) {
    sr3::setmaxnreg_dec<kProducerRegs>();
    if (warp == 0) {
      // producer: chunk q's raw halo one chunk ahead of its weights, so
      // the normalizers can start it while the consumers run chunk q - 1
      if (lane != 0 || nq == 0) return;
      sr3::tma_prefetch_map(&xmap);
      sr3::tma_prefetch_map(&wmap);
      auto load_raw = [&](int q) {
        const Tile t = tile_of(q);
        const int slot = q % 2;
        sr3::mbar_wait(raw_empty + slot, ((q / 2) & 1) ^ 1);
        sr3::mbar_expect_tx(raw_full + slot, T::kRawBytes);
        sr3::tma_load_4d(raw + slot * (T::kRawBytes / 2), &xmap,
                         raw_full + slot, (q % nch) * kWK, t.tx0 - 1,
                         t.ty0 - 1, t.b0);
      };
      load_raw(0);
      int s = 0;
      for (int q = 0; q < nq; ++q) {
        if (q + 1 < nq) load_raw(q + 1);
        const int co0 = tile_of(q).co0, c0 = (q % nch) * kWK;
        for (int tap = 0; tap < 9; ++tap, ++s) {
          const int slot = s % T::kStages;
          sr3::mbar_wait(w_empty + slot, ((s / T::kStages) & 1) ^ 1);
          sr3::mbar_expect_tx(w_full + slot, T::kStageBytes);
          sr3::tma_load_3d(ring + slot * (T::kStageBytes / 2), &wmap,
                           w_full + slot, c0, tap, co0);
        }
      }
      return;
    }
    // normalizers: chunk q's raw halo -> SiLU(x * mult + add) in bf16, in
    // the other normalized buffer than the consumers read; zero on the
    // padding (the map's, and past C_in and the batch), the halo entry's
    // rows above / below the map from top / bottom
    const int nt = tid - 32, cg = nt % 8, pl = nt / 8;
    for (int q = 0; q < nq; ++q) {
      const Tile t = tile_of(q);
      const int ch = (q % nch) * kWK + 8 * cg;
      const bool live = ch < Cin;
      float mv[NI][8], av[NI][8];
#pragma unroll
      for (int img = 0; img < NI; ++img) {
        const size_t at = (size_t)min(t.b0 + img, B - 1) * Cin + ch;
        if (live) {
          load8(mv[img], mult + at);
          load8(av[img], add + at);
        }
      }
      const int slot = q % 2;
      const uint32_t ph = (q / 2) & 1;
      sr3::mbar_wait(raw_full + slot, ph);
      sr3::mbar_wait(norm_empty + slot, ph ^ 1);
      const bf16* rb = raw + slot * (T::kRawBytes / 2) + 8 * cg;
      bf16* nb = norm + slot * (T::kNormBytes / 2) + 8 * cg;
      for (int pix = pl; pix < T::kHaloPix; pix += kNormThreads / 8) {
        const int img = pix / (T::kHH * T::kHW), r = pix % (T::kHH * T::kHW);
        const int bb = t.b0 + img, iy = t.ty0 - 1 + r / T::kHW,
                  ix = t.tx0 - 1 + r % T::kHW;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (live && bb < B && ix >= 0 && ix < W) {
          const bf16* row = nullptr;
          if (iy >= 0 && iy < H) {
            v = gn_silu8<NI>(*reinterpret_cast<const uint4*>(rb + pix * kWK),
                             mv, av, img);
          } else if (iy == -1 && top) {
            row = top;
          } else if (iy == H && bottom) {
            row = bottom;
          }
          if (row)
            v = gn_silu8<NI>(__ldg(reinterpret_cast<const uint4*>(
                                 row + ((size_t)bb * W + ix) * Cin + ch)),
                             mv, av, img);
        }
        *reinterpret_cast<uint4*>(nb + pix * kHaloLd) = v;
      }
      sr3::mbar_arrive(raw_empty + slot);
      sr3::mbar_arrive(norm_full + slot);
    }
    return;
  }

  // consumers: warpgroup cw owns pixels 64 cw.. of each tile
  sr3::setmaxnreg_inc<kConsumerRegs>();
  const int cw = warp / 4 - 1;
  // ldmatrix row address of this lane's A row: pixel p of the tile,
  // channels 8 (lane / 16).. of a 16-deep k-step
  const int p = 64 * cw + 16 * (warp % 4) + lane % 16;
  const int pq = p % (kWTH * TW);
  const int a_off =
      (((p / (kWTH * TW)) * T::kHH + pq / TW) * T::kHW + pq % TW) * kHaloLd +
      8 * (lane / 16);
  const uint32_t ring_addr = sr3::smem_u32(ring);
  const int nk = 9 * nch;  // (chunk, tap) steps of an item
  float acc[BN / 2];
  constexpr int kA = kASets<BN>;
  uint32_t a[kA][4][4];
  int s = 0;  // weight stages consumed

  for (int i = 0; i < mine; ++i) {
    const int q0 = i * nch;
    const Tile t = tile_of(q0);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    int k = 0;
    for (; k + kA <= nk; k += kA) {
#pragma unroll
      for (int u = 0; u < kA; ++u)
        conv_step<T, BN>(acc, a[u], q0, k + u, s, lane, a_off, norm,
                         ring_addr, w_full, w_empty, norm_full, norm_empty);
    }
#pragma unroll
    for (int u = 0; u < kA - 1; ++u)
      if (k + u < nk)
        conv_step<T, BN>(acc, a[u], q0, k + u, s, lane, a_off, norm,
                         ring_addr, w_full, w_empty, norm_full, norm_empty);
    // BN <= 128: the residual read while the last products run
    const int gid = lane / 4, tig = lane % 4;
    constexpr bool kEarly = BN <= 128;
    uint32_t rv[kEarly ? 2 : 1][kEarly ? BN / 8 : 1];
    if constexpr (kEarly) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = 64 * cw + 16 * (warp % 4) + gid + 8 * r;
        const int mq = m % (kWTH * TW);
        const int bb = t.b0 + m / (kWTH * TW), oy = t.ty0 + mq / TW,
                  ox = t.tx0 + mq % TW;
        const bool in = res && vec && bb < B && oy < H && ox < W;
        const size_t at = (((size_t)bb * H + oy) * W + ox) * Cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int o = t.co0 + 8 * j + 2 * tig;
          rv[r][j] = in && o < Cout
                         ? __ldg(reinterpret_cast<const unsigned int*>(
                               res + at + o))
                         : 0u;
        }
      }
    }
    sr3::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) sr3::fence_operand(acc[j]);
    __syncwarp();
    if (lane == 0) {
      for (int b = 1; b <= kA - 1 && b <= nk; ++b)
        sr3::mbar_arrive(w_empty + (s - b) % T::kStages);
    }

    // epilogue from the fragments while the producer and the normalizers
    // go on with the next item: bias and residual added in float32, each
    // output rounded once; two neighbouring channels a store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = 64 * cw + 16 * (warp % 4) + gid + 8 * r;
      const int mq = m % (kWTH * TW);
      const int bb = t.b0 + m / (kWTH * TW), oy = t.ty0 + mq / TW,
                ox = t.tx0 + mq % TW;
      if (bb >= B || oy >= H || ox >= W) continue;
      const size_t at = (((size_t)bb * H + oy) * W + ox) * Cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int o = t.co0 + 8 * j + 2 * tig;
        if (o >= Cout) continue;
        float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
        if (vec) {  // C_out even, y and res 4-byte aligned
          if (bias) v0 += bias[o], v1 += bias[o + 1];
          if (res) {
            uint32_t raw2;
            if constexpr (kEarly) {
              raw2 = rv[r][j];
            } else {
              raw2 = __ldg(reinterpret_cast<const unsigned int*>(res + at + o));
            }
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&raw2));
            v0 += f.x, v1 += f.y;
          }
          *reinterpret_cast<uint32_t*>(y + at + o) = sr3::pack_bf16(v0, v1);
        } else {
          if (bias) v0 += bias[o];
          if (res) v0 += __bfloat162float(res[at + o]);
          y[at + o] = __float2bfloat16(v0);
          if (o + 1 < Cout) {
            if (bias) v1 += bias[o + 1];
            if (res) v1 += __bfloat162float(res[at + o + 1]);
            y[at + o + 1] = __float2bfloat16(v1);
          }
        }
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
  int B, H, W, Cin, Cout;
};

// The bfloat16 classes <TW, NI, BN> in the order sr3_gn_silu_conv3x3_tiles
// counts their launches: the Hopper kernel's, then the small C_out one.
constexpr int kClasses = 7;
constexpr int kClassTW[kClasses] = {16, 16, 16, 16, 8, 8, 16};
constexpr int kClassNI[kClasses] = {1, 1, 1, 1, 2, 2, 1};
constexpr int kClassBN[kClasses] = {256, 192, 128, 64, 128, 64, 8};
constexpr int kSmallClass = kClasses - 1;
static_assert(kClassBN[kSmallClass] == kSmallBN, "the small class");
// An item's cost beyond its BN output channels, in output channels: the
// A loads, the pipeline's fill and the epilogue that do not shrink with BN
constexpr int kItemCost = 32;

struct ConvPlan {
  int cls, tiles_h, tiles_w, ptiles, n_tiles, items, grid;
};

ConvPlan plan_as(int cls, int B, int H, int W, int Cout, int sms) {
  ConvPlan p{};
  p.cls = cls;
  p.tiles_h = (H + kWTH - 1) / kWTH;
  p.tiles_w = (W + kClassTW[cls] - 1) / kClassTW[cls];
  const long long ptiles = (long long)((B + kClassNI[cls] - 1) /
                                       kClassNI[cls]) * p.tiles_h * p.tiles_w;
  p.n_tiles = (Cout + kClassBN[cls] - 1) / kClassBN[cls];
  const long long items = ptiles * p.n_tiles;
  p.ptiles = ptiles > INT_MAX ? -1 : (int)ptiles;
  p.items = items > INT_MAX ? -1 : (int)items;
  p.grid = cls == kSmallClass || items < sms ? p.items : sms;
  return p;
}

// C_out <= 8: the small class. Else the Hopper kernel: on maps of width
// <= 8 tiles of two images (an 8x8 map fills the 128 pixels), BN 128 or 64;
// on wider maps one image a tile, BN 256, 192, 128 or 64: the class whose
// waves of items (ceil(items / SMs)) times (BN + kItemCost) are least, the
// larger BN on a tie -- one N-tile for 192 channels, 256 where the items
// still fill the card, smaller on small maps.
ConvPlan conv_plan(int B, int H, int W, int Cout, int sms) {
  if (Cout <= kSmallBN) return plan_as(kSmallClass, B, H, W, Cout, sms);
  const int first = W <= 8 ? 4 : 0, last = W <= 8 ? 6 : 4;
  ConvPlan best{};
  long long least = -1;
  for (int cls = first; cls < last; ++cls) {
    const ConvPlan p = plan_as(cls, B, H, W, Cout, sms);
    const long long cost =
        ((long long)p.items + sms - 1) / sms * (kClassBN[cls] + kItemCost);
    if (least < 0 || cost < least) least = cost, best = p;
  }
  return best;
}

// Launches of each bfloat16 class since the last reset, by class index.
std::atomic<long long> g_tile_launches[kClasses];

// x (B, H, W, Cin) as a 4-D map read in boxes of 64 channels x (TW + 2)
// columns x (kWTH + 2) rows x NI images, dense (no swizzle); w (Cout, 9,
// Cin) as a 3-D map read in boxes of 64 channels x 1 tap x BN rows,
// 128-byte swizzled. Coordinates outside either tensor read zeros.
bool encode_conv_maps(CUtensorMap* xmap, CUtensorMap* wmap,
                      const ConvArgs& a, int TW, int NI, int BN) {
  const sr3::EncodeTiled encode = sr3::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t xdims[4] = {(cuuint64_t)a.Cin, (cuuint64_t)a.W,
                               (cuuint64_t)a.H, (cuuint64_t)a.B};
  const cuuint64_t xstrides[3] = {a.Cin * e, (cuuint64_t)a.W * a.Cin * e,
                                  (cuuint64_t)a.H * a.W * a.Cin * e};
  const cuuint32_t xbox[4] = {kWK, (cuuint32_t)TW + 2, kWTH + 2,
                              (cuuint32_t)NI};
  const cuuint64_t wdims[3] = {(cuuint64_t)a.Cin, 9, (cuuint64_t)a.Cout};
  const cuuint64_t wstrides[2] = {a.Cin * e, 9 * a.Cin * e};
  const cuuint32_t wbox[3] = {kWK, 1, (cuuint32_t)BN};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<bf16*>(a.x), xdims, xstrides, xbox, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<bf16*>(a.w), wdims, wstrides, wbox, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TW, int NI, int BN>
cudaError_t launch_tma(const ConvArgs& a, const ConvPlan& p,
                       cudaStream_t st) {
  using T = TTile<TW, NI, BN>;
  static sr3::SmemLimit limit;
  const auto kernel = gn_silu_conv3x3_tma_kernel<TW, NI, BN>;
  cudaError_t err =
      sr3::raise_smem_limit(limit, (const void*)kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  if (!encode_conv_maps(&xmap, &wmap, a, TW, NI, BN))
    return cudaErrorInvalidValue;
  const int vec = a.Cout % 2 == 0 &&
                  ((reinterpret_cast<uintptr_t>(a.y) |
                    reinterpret_cast<uintptr_t>(a.res)) % 4) == 0;
  kernel<<<p.grid, kTThreads, T::kSmem, st>>>(
      xmap, wmap, a.top, a.bottom, a.mult, a.add, a.bias, a.res, a.y, a.B,
      a.H, a.W, a.Cin, a.Cout, p.tiles_w, p.tiles_h * p.tiles_w, p.n_tiles,
      p.items, vec);
  return cudaGetLastError();
}

template <bool kHalo>
cudaError_t launch_small_as(const ConvArgs& a, const ConvPlan& p,
                            cudaStream_t st) {
  static sr3::SmemLimit limit;
  const auto kernel = gn_silu_conv3x3_small_kernel<kHalo>;
  cudaError_t err =
      sr3::raise_smem_limit(limit, (const void*)kernel, WTile::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.tiles_h * p.tiles_w, p.n_tiles, a.B);
  kernel<<<grid, kWThreads, WTile::kSmem, st>>>(
      a.x, a.top, a.bottom, a.mult, a.add, a.w, a.bias, a.res, a.y, a.B, a.H,
      a.W, a.Cin, a.Cout, p.tiles_w);
  return cudaGetLastError();
}

// The halo entry's reads in the small class are a separate instantiation;
// the Hopper kernel's normalizers test top / bottom off the products' path.
cudaError_t launch_bf16(const ConvArgs& a, cudaStream_t st) {
  int sms = 0;
  cudaError_t err = sr3::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const ConvPlan p = conv_plan(a.B, a.H, a.W, a.Cout, sms);
  if (p.items <= 0) return cudaErrorInvalidValue;
  switch (p.cls) {
    case 0: err = launch_tma<16, 1, 256>(a, p, st); break;
    case 1: err = launch_tma<16, 1, 192>(a, p, st); break;
    case 2: err = launch_tma<16, 1, 128>(a, p, st); break;
    case 3: err = launch_tma<16, 1, 64>(a, p, st); break;
    case 4: err = launch_tma<8, 2, 128>(a, p, st); break;
    case 5: err = launch_tma<8, 2, 64>(a, p, st); break;
    default:
      err = a.top || a.bottom ? launch_small_as<true>(a, p, st)
                              : launch_small_as<false>(a, p, st);
  }
  if (err == cudaSuccess)
    g_tile_launches[p.cls].fetch_add(1, std::memory_order_relaxed);
  return err;
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
    const ConvArgs a{static_cast<const bf16*>(x),
                     static_cast<const bf16*>(top),
                     static_cast<const bf16*>(bottom), mult, add,
                     static_cast<const bf16*>(w), bias,
                     static_cast<const bf16*>(res), static_cast<bf16*>(y),
                     B, H, W, Cin, Cout};
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

// y = conv3x3(SiLU(GroupNorm(pre_scale*x + pre_bias)*(1 + post_scale) +
// post_shift)) + bias (+ res).
// x: (B,H,W,Cin), w: (Cout,3,3,Cin), res/y: (B,H,W,Cout), all of dtype;
// pre_scale/pre_bias: (B,Cin) float32 or null; post_scale/post_shift:
// (B,Cin) float32 or null (the scale-shift conditioning of guided-diffusion's
// ResBlocks; they fold into the statistics launch's per-(batch, channel)
// mult / add, so the conv launch is the same, and with both null the
// statistics launch is the SR3 route's); gamma/beta: (Cin) float32;
// bias: (Cout) float32 or null; workspace: sr3_gn_workspace_floats(B, H*W,
// Cin, G, dtype) float32 scratch (groupnorm.cu); tickets: B*Cin int32, 0
// before the call and left 0 by it. bfloat16 needs Cin % 16 == 0.
// Returns the CUDA error code (0 on success).
extern "C" int sr3_gn_silu_conv3x3(
    const void* x, const float* pre_scale, const float* pre_bias,
    const float* post_scale, const float* post_shift, const float* gamma,
    const float* beta, const void* w, const float* bias, const void* res,
    void* y, float* workspace, int* tickets, int B, int H, int W, int Cin,
    int Cout, int G, float eps, int dtype, void* stream) {
  if (dtype == sr3::kBF16 && Cin % kCK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = sr3::launch_gn_stats(x, dtype, pre_scale, pre_bias, gamma,
                                         beta, workspace, tickets, B, H * W,
                                         Cin, G, eps, st, post_scale,
                                         post_shift);
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

// Launches of each bfloat16 class <TW, NI, BN> since the last reset, into
// counts[0..6] in the order <16,1,256>, <16,1,192>, <16,1,128>, <16,1,64>,
// <8,2,128>, <8,2,64> (the Hopper kernel), <16,1,8> (C_out <= 8); reset != 0
// sets them to 0 after reading. Returns the number of classes.
extern "C" int sr3_gn_silu_conv3x3_tiles(long long* counts, int reset) {
  for (int i = 0; i < kClasses; ++i)
    counts[i] = reset ? g_tile_launches[i].exchange(0)
                      : g_tile_launches[i].load();
  return kClasses;
}

// The bfloat16 conv launch's plan for a (B, H, W, C_out) map on the
// current device, into out[0..6]: class (the order of
// sr3_gn_silu_conv3x3_tiles), tile rows and columns of a map, pixel tiles,
// N-tiles, items (pixel tiles x N-tiles) and blocks (the Hopper kernel:
// min(items, SMs), each walking items blockIdx.x, + blocks, ...). Returns
// the CUDA error code (0 on success).
extern "C" int sr3_gn_silu_conv3x3_plan(int B, int H, int W, int Cout,
                                        long long* out) {
  int sms = 0;
  const cudaError_t err = sr3::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const ConvPlan p = conv_plan(B, H, W, Cout, sms);
  const int fields[7] = {p.cls,    p.tiles_h, p.tiles_w, p.ptiles,
                         p.n_tiles, p.items,  p.grid};
  for (int i = 0; i < 7; ++i) out[i] = fields[i];
  return 0;
}
