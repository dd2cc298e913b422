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
// Bound on the card: arithmetic. A 3x3 conv does 9*C_in multiply-adds per
// output value, far above the H100's bytes-per-FLOP line even at C_in=64.
// What the design does:
//   * launch 1-2 (common.cuh launch_gn_stats): group statistics of a*x+b and
//     the per-channel mult/add of the normalize;
//   * launch 3 (this file): each block computes an 8x8-pixel by 64-channel
//     output tile. For each chunk of 16 input channels it stages the
//     10x10-pixel halo tile into shared memory *already normalized, SiLU'd
//     and rounded to the working type* (so the normalized map never goes to
//     device memory), with zeros outside the image -- the padding belongs to
//     the normalized map, so border taps read 0, not SiLU(add) -- and the
//     64x9x16 weight slice. Bias and residual are added in the float32
//     epilogue and the result is stored once in the input's type. Ragged
//     C_out (C_out = 3) and image edges are masked; so is ragged C_in in
//     float32, while bfloat16 stages whole 16-channel chunks with 16-byte
//     loads and takes only C_in % 16 == 0.
//   * bfloat16 runs on the tensor cores (mma.sync m16n8k16, float32
//     accumulate); float32 runs on float32 FMAs, since TF32 tensor cores
//     would keep only ~3 decimal digits. wgmma + TMA pipelining come later.
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

// float32: FMA arithmetic.
__global__ void __launch_bounds__(kThreads)
    gn_silu_conv3x3_kernel(const float* __restrict__ x,
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

// bfloat16: the same tiling on the tensor cores. A block (4 warps) computes
// an 8x8-pixel by 64-channel output tile as an implicit GEMM
// (M = pixels, N = output channels, K = 9 taps x C_in) with
// mma.sync.m16n8k16 bf16 -> f32. Per 16-channel chunk the normalized,
// SiLU'd, bf16-rounded 10x10 halo tile and the 9x64x16 weight slice are
// staged in shared memory with rows padded to 24 bf16, so that the eight
// rows one fragment load touches fall in distinct banks. Each warp owns
// 32 pixels (4 rows) x 32 channels: 2 x 4 m16n8 accumulator tiles.
constexpr int kMThreads = 128;
constexpr int kMStride = kCK + 8;  // bf16 per staged pixel / (tap, co) row
constexpr int kHalo = (kTH + 2) * (kTW + 2);

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Staging of one 16-channel chunk (C_in % 16 == 0, as at every shape of the
// model; the entry point refuses other C_in): 16-byte loads, issued for
// chunk k+1 before chunk k's MMAs so that their latency hides behind the
// tensor-core work.
constexpr int kHaloVec = kHalo * 2;          // 8-channel halves of the halo
constexpr int kWVec = 9 * kTCO * 2;          // 8-channel halves of the slice
constexpr int kHaloIt = (kHaloVec + kMThreads - 1) / kMThreads;  // 2
constexpr int kWIt = kWVec / kMThreads;                          // 9

struct ChunkRegs {
  uint4 halo[kHaloIt];
  uint4 w[kWIt];
};

__device__ __forceinline__ void load_chunk(
    ChunkRegs& r, const __nv_bfloat16* xb, const __nv_bfloat16* w, int c0,
    int co0, int ty0, int tx0, int H, int W, int Cin, int Cout, int tid) {
#pragma unroll
  for (int k = 0; k < kHaloIt; ++k) {
    const int i = tid + k * kMThreads;
    const int pix = i / 2, half = i % 2;
    const int iy = ty0 - 1 + pix / (kTW + 2), ix = tx0 - 1 + pix % (kTW + 2);
    r.halo[k] = make_uint4(0, 0, 0, 0);
    if (i < kHaloVec && iy >= 0 && iy < H && ix >= 0 && ix < W)
      r.halo[k] = *reinterpret_cast<const uint4*>(
          xb + ((size_t)iy * W + ix) * Cin + c0 + 8 * half);
  }
#pragma unroll
  for (int k = 0; k < kWIt; ++k) {
    const int i = tid + k * kMThreads;
    const int half = i % 2, r9 = i / 2, tap = r9 % 9, co = r9 / 9;
    r.w[k] = make_uint4(0, 0, 0, 0);
    if (co0 + co < Cout)
      r.w[k] = *reinterpret_cast<const uint4*>(
          w + ((size_t)(co0 + co) * 9 + tap) * Cin + c0 + 8 * half);
  }
}

// Normalize + SiLU the halo (zero stays zero: it is the padding) and store
// both into shared memory.
__device__ __forceinline__ void store_chunk(
    const ChunkRegs& r, __nv_bfloat16* in_s, __nv_bfloat16* w_s,
    const float* mb, const float* ab, int c0, int ty0, int tx0, int H, int W,
    int tid) {
#pragma unroll
  for (int k = 0; k < kHaloIt; ++k) {
    const int i = tid + k * kMThreads;
    if (i >= kHaloVec) continue;
    const int pix = i / 2, half = i % 2;
    const int iy = ty0 - 1 + pix / (kTW + 2), ix = tx0 - 1 + pix % (kTW + 2);
    uint4 out = make_uint4(0, 0, 0, 0);
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      const int c = c0 + 8 * half;
      const __nv_bfloat162* xv =
          reinterpret_cast<const __nv_bfloat162*>(&r.halo[k]);
      uint32_t* ov = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(xv[j]);
        const float v0 = sr3::silu(fmaf(f.x, mb[c + 2 * j], ab[c + 2 * j]));
        const float v1 =
            sr3::silu(fmaf(f.y, mb[c + 2 * j + 1], ab[c + 2 * j + 1]));
        const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
        ov[j] = *reinterpret_cast<const uint32_t*>(&p);
      }
    }
    *reinterpret_cast<uint4*>(&in_s[pix * kMStride + 8 * half]) = out;
  }
#pragma unroll
  for (int k = 0; k < kWIt; ++k) {
    const int i = tid + k * kMThreads;
    const int half = i % 2, r9 = i / 2, tap = r9 % 9, co = r9 / 9;
    *reinterpret_cast<uint4*>(&w_s[(tap * kTCO + co) * kMStride + 8 * half]) =
        r.w[k];
  }
}

__global__ void __launch_bounds__(kMThreads)
    gn_silu_conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                               const float* __restrict__ mult,
                               const float* __restrict__ add,
                               const __nv_bfloat16* __restrict__ w,
                               const float* __restrict__ bias,
                               const __nv_bfloat16* __restrict__ res,
                               __nv_bfloat16* __restrict__ y, int H, int W,
                               int Cin, int Cout, int tiles_w) {
  __shared__ __align__(16) __nv_bfloat16 in_s[kHalo * kMStride];
  __shared__ __align__(16) __nv_bfloat16 w_s[9 * kTCO * kMStride];

  const int b = blockIdx.z;
  const int co0 = blockIdx.y * kTCO;
  const int ty0 = (blockIdx.x / tiles_w) * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // rows 4wm..4wm+3, chans 32wn..
  const int gid = lane / 4, tig = lane % 4;

  const __nv_bfloat16* xb = x + (size_t)b * H * W * Cin;
  const float* mb = mult + (size_t)b * Cin;
  const float* ab = add + (size_t)b * Cin;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  ChunkRegs regs;
  load_chunk(regs, xb, w, 0, co0, ty0, tx0, H, W, Cin, Cout, tid);

  for (int c0 = 0; c0 < Cin; c0 += kCK) {
    __syncthreads();  // the previous chunk's fragment loads are done
    store_chunk(regs, in_s, w_s, mb, ab, c0, ty0, tx0, H, W, tid);
    __syncthreads();
    if (c0 + kCK < Cin)  // in flight during this chunk's MMAs
      load_chunk(regs, xb, w, c0 + kCK, co0, ty0, tx0, H, W, Cin, Cout, tid);

#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A rows 0-7: output row oy, pixels 0-7; rows 8-15: row oy + 1
        const int oy = 4 * wm + 2 * mt;
        const __nv_bfloat16* r0 =
            in_s + ((oy + kh) * (kTW + 2) + gid + kw) * kMStride + tig * 2;
        const __nv_bfloat16* r1 = r0 + (kTW + 2) * kMStride;
        a[mt][0] = ld_pair(r0);
        a[mt][1] = ld_pair(r1);
        a[mt][2] = ld_pair(r0 + 8);
        a[mt][3] = ld_pair(r1 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* wp =
            w_s + (tap * kTCO + 32 * wn + 8 * nt + gid) * kMStride + tig * 2;
        const uint32_t b0 = ld_pair(wp), b1 = ld_pair(wp + 8);
        mma_bf16(acc[0][nt], a[0], b0, b1);
        mma_bf16(acc[1][nt], a[1], b0, b1);
      }
    }
  }

  // accumulator (mt, nt, 2*half + j): pixel (4wm + 2mt + half, gid),
  // channel 32wn + 8nt + 2tig + j
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int oy = ty0 + 4 * wm + 2 * mt + half, ox = tx0 + gid;
      if (oy >= H || ox >= W) continue;
      const size_t base = (((size_t)b * H + oy) * W + ox) * Cout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int o = co0 + 32 * wn + 8 * nt + 2 * tig + j;
          if (o >= Cout) continue;
          float v = acc[mt][nt][2 * half + j] + (bias ? bias[o] : 0.f);
          if (res) v += __bfloat162float(res[base + o]);
          y[base + o] = __float2bfloat16(v);
        }
    }
}

dim3 conv_grid(int B, int H, int W, int Cout, int* tiles_w) {
  const int tiles_h = (H + kTH - 1) / kTH;
  *tiles_w = (W + kTW - 1) / kTW;
  return dim3(tiles_h * *tiles_w, (Cout + kTCO - 1) / kTCO, B);
}

}  // namespace

// y = conv3x3(SiLU(GroupNorm(pre_scale*x + pre_bias))) + bias (+ res).
// x: (B,H,W,Cin), w: (Cout,3,3,Cin), res/y: (B,H,W,Cout), all of dtype;
// pre_scale/pre_bias: (B,Cin) float32 or null; gamma/beta: (Cin) float32;
// bias: (Cout) float32 or null; workspace: sr3_gn_workspace_floats(B, H*W,
// Cin) float32 scratch (groupnorm.cu). bfloat16 needs Cin % 16 == 0.
// Returns the CUDA error code (0 on success).
extern "C" int sr3_gn_silu_conv3x3(const void* x, const float* pre_scale,
                                   const float* pre_bias, const float* gamma,
                                   const float* beta, const void* w,
                                   const float* bias, const void* res,
                                   void* y, float* workspace, int B, int H,
                                   int W, int Cin, int Cout, int G, float eps,
                                   int dtype, void* stream) {
  if (dtype == sr3::kBF16 && Cin % kCK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = sr3::launch_gn_stats(x, dtype, pre_scale, pre_bias, gamma,
                                         beta, workspace, B, H * W, Cin, G,
                                         eps, st);
  if (err != cudaSuccess) return (int)err;
  const float* mult = workspace;
  const float* add = sr3::gn_add(workspace, B, Cin);
  int tiles_w;
  const dim3 grid = conv_grid(B, H, W, Cout, &tiles_w);
  if (dtype == sr3::kF32) {
    gn_silu_conv3x3_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), mult, add,
        static_cast<const float*>(w), bias, static_cast<const float*>(res),
        static_cast<float*>(y), H, W, Cin, Cout, tiles_w);
  } else {
    gn_silu_conv3x3_mma_kernel<<<grid, kMThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), mult, add,
        static_cast<const __nv_bfloat16*>(w), bias,
        static_cast<const __nv_bfloat16*>(res),
        static_cast<__nv_bfloat16*>(y), H, W, Cin, Cout, tiles_w);
  }
  return (int)cudaGetLastError();
}
