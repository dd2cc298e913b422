// The GroupNorm(+SiLU) backward of K1 and K2, NHWC: dx, dgamma and dbeta
// (and, with a pre-affine, the per-(b, c) gradients of its scale and bias)
// of y = SiLU?(GroupNorm(a*x + b)); and the recompute of K1's activation
// SiLU(GroupNorm(a*x + b)) that its conv backward takes.
//
// Replaces no TPU kernel: the JAX package leaves this backward to XLA (the
// bwd of `_gn_swish_fwd_bwd` and `_gn_swish_stats_fwd_bwd` in
// sr3_tpu/ops/groupnorm.py, jax.vjp of the XLA composition in
// `_fused_fwd_bwd`, sr3_tpu/ops/conv_fused.py). It was added because the
// port ran that backward as plain PyTorch in float32 -- 20 to 40 kernels a
// call, each reading and writing a float32 copy of the map -- which took
// two thirds of a training step.
//
// Bound on the card: device-memory bytes; a few dozen flops an element.
// The least traffic reads x and dy once and writes dx once: 6 bytes an
// element in bf16, 2.4 GB or 0.72 ms at 3.35 TB/s at 128x192x128^2. The
// passes move more: with the statistics given (the statistics route, K1),
// pass 1 reads x and dy and pass 2 reads them again and writes dx (10 bytes
// an element); without them (K2) a statistics pass reads x once more (12);
// K1's activation recompute reads x twice and writes the activation (6).
//
// Design. A map x (B, HW, C) is cut as K1's statistics cut it (common.cuh
// "GroupNorm statistics": channel blocks of whole groups, >= 128 bytes of a
// pixel, 16-byte loads of 8 bf16 or 4 float32 channels, neighbouring
// threads on neighbouring channels), and each (batch element, channel
// block) slice into `splits` pixel ranges, one block each, as many as fill
// the card's resident blocks once (one block a slice on maps with more
// slices than that, a slice over many blocks at 512^2 and 1024^2). Every
// pass streams its range with two pixels' loads in flight a thread and
// float32 arithmetic:
//   statistics  (no statistics given): sums of v = a*x + b and v^2 per
//               channel -> slots; a fold launch sums the slots in split
//               order and each group's channels in order -> mean, rstd;
//   activation  (K1): SiLU(v*mult + add), mult / add as K1's forward folds
//               them, in x's dtype;
//   pass 1      per channel: sum dz and sum dz*xhat (with a pre-affine also
//               sum dz*x, sum xhat, sum xhat*x, sum x), where xhat = (v -
//               mean)*rstd, z = xhat*gamma + beta and dz = dy*s*(1 + z*(1 -
//               s)), s = sigmoid(z), with SiLU, else dy -> slots; folded in
//               split order by a fold launch when there is more than one;
//   pass 2      m1 = sum gamma*dz / n and m2 = sum gamma*dz*xhat / n of
//               each group (its channels in order), then dx = a*rstd*(gamma*
//               dz - m1 - xhat*m2) in x's dtype; the first block of a slice
//               writes the pre-affine's gradients from the sums;
//   parameters  dgamma, dbeta: the per-(b, c) sums over b in a fixed order
//               (8 strided runs, then the runs in order).
// A block's thread sums are reduced over its rows in a fixed tree, two sums
// at a time. No atomics: the result is the same bits every run.
//
// Tolerance against the plain version (sr3_tpu_torch/ops/groupnorm.py
// `gn_silu_bwd_plain`): 1e-4 of max|plain| in float32 (sums in another
// order, rstd*gamma*dz - rstd*m1 - rstd*m2*xhat in place of
// rstd*(gamma*dz - m1 - xhat*m2)); 2e-2 in bfloat16 (dx rounded once; the
// plain version rounds its inputs the same way).
#include "common.cuh"

namespace sr3 {
namespace {

constexpr int kBwdMinBlocks = 2;   // __launch_bounds__: <= 128 registers
constexpr int kBwdMinPixels = 256;  // pixels a block at least
constexpr int kBwdUnroll = 2;      // pixels a thread keeps in flight
constexpr int kBwdFoldRuns = 8;    // strided runs over b in the parameters

// 16 bytes of neighbouring channels.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                      pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float sigmoid(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

// Where this block works: batch element b, channels c0 .. c0 + cb - 1,
// split s, pixels p0 .. p1 - 1; this thread: row r of `rows` (pixels p0 + r,
// p0 + r + rows, ...) and channels c0 + col*N .. c0 + col*N + N - 1.
struct Tile {
  int b, c0, s, p0, p1, rows, r, col;
};

template <int N>
__device__ __forceinline__ Tile tile_of(int HW, int cb, int per) {
  Tile t;
  const int cols = cb / N;
  t.rows = blockDim.x / cols;
  t.r = threadIdx.x / cols;
  t.col = threadIdx.x % cols;
  t.b = blockIdx.z;
  t.c0 = blockIdx.y * cb;
  t.s = blockIdx.x;
  t.p0 = min(HW, t.s * per);
  t.p1 = min(HW, t.p0 + per);
  return t;
}

// Two per-channel thread sums reduced over the block's rows (red:
// [2][rows][cb] floats), rows folded in a fixed tree; the result is row 0:
// red[ch] and red[rows*cb + ch]. Ends synchronized.
template <int N>
__device__ __forceinline__ void reduce_pair(float* red, int rows, int cb,
                                            int r, int col, const float* u,
                                            const float* w) {
  const int n = rows * cb;
#pragma unroll
  for (int v = 0; v < N; ++v) {
    red[r * cb + col * N + v] = u[v];
    red[n + r * cb + col * N + v] = w[v];
  }
  __syncthreads();
  int h = 1;
  while (2 * h < rows) h *= 2;
  for (; h > 0; h >>= 1) {
    for (int i = threadIdx.x; i < h * cb; i += blockDim.x) {
      if (i / cb + h < rows) {
        red[i] += red[i + h * cb];
        red[n + i] += red[n + i + h * cb];
      }
    }
    __syncthreads();
  }
}

// Sums of the slice's pixel range, per channel: kGrad false, sum v and sum
// v^2 of v = a*x + b; kGrad true, pass 1's sums. Grid (splits, C / cb, B);
// slots (B, splits, K, C); dynamic shared memory 2 * rows * cb floats.
template <typename T, bool kGrad, bool kPre, bool kSwish>
__global__ void __launch_bounds__(kGnThreads, kBwdMinBlocks)
    gn_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ pre_scale,
                       const float* __restrict__ pre_bias,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       float* __restrict__ slots, int HW, int C, int cb,
                       int per) {
  using IO = Vec16<T>;
  constexpr int N = IO::N;
  constexpr int K = kGrad && kPre ? 6 : 2;
  const Tile t = tile_of<N>(HW, cb, per);
  const int cf = t.c0 + t.col * N;  // this thread's first channel
  const size_t bc = (size_t)t.b * C + cf;
  float a[N], o[N], mu[N], rs[N], ga[N], be[N], acc[K][N];
#pragma unroll
  for (int v = 0; v < N; ++v) {
    a[v] = kPre && pre_scale ? pre_scale[bc + v] : 1.f;
    o[v] = kPre && pre_bias ? pre_bias[bc + v] : 0.f;
    if (kGrad) {
      mu[v] = mean[bc + v];
      rs[v] = rstd[bc + v];
      ga[v] = gamma[cf + v];
      be[v] = beta[cf + v];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k][v] = 0.f;
  }
  const size_t base = (size_t)t.b * HW * C + cf;
  for (int p = t.p0 + t.r; p < t.p1; p += kBwdUnroll * t.rows) {
    uint4 rx[kBwdUnroll], rd[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int q = p + u * t.rows;
      if (q < t.p1) {
        rx[u] = load16(x + base + (size_t)q * C);
        if (kGrad) rd[u] = load16(dy + base + (size_t)q * C);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (p + u * t.rows >= t.p1) continue;
      float xf[N], df[N];
      IO::unpack(rx[u], xf);
      if (kGrad) IO::unpack(rd[u], df);
#pragma unroll
      for (int v = 0; v < N; ++v) {
        const float vv = kPre ? fmaf(xf[v], a[v], o[v]) : xf[v];
        if constexpr (!kGrad) {
          acc[0][v] += vv;
          acc[1][v] = fmaf(vv, vv, acc[1][v]);
        } else {
          const float xh = (vv - mu[v]) * rs[v];
          float dz = df[v];
          if (kSwish) {
            const float z = fmaf(xh, ga[v], be[v]);
            const float sg = sigmoid(z);
            dz *= sg * (1.f + z * (1.f - sg));
          }
          acc[0][v] += dz;
          acc[1][v] = fmaf(dz, xh, acc[1][v]);
          if constexpr (kPre) {
            acc[2][v] = fmaf(dz, xf[v], acc[2][v]);
            acc[3][v] += xh;
            acc[4][v] = fmaf(xh, xf[v], acc[4][v]);
            acc[5][v] += xf[v];
          }
        }
      }
    }
  }
  extern __shared__ __align__(16) float red[];
  float* out = slots + ((size_t)t.b * gridDim.x + t.s) * K * C + t.c0;
#pragma unroll
  for (int k = 0; k < K; k += 2) {
    reduce_pair<N>(red, t.rows, cb, t.r, t.col, acc[k], acc[k + 1]);
    for (int ch = threadIdx.x; ch < cb; ch += blockDim.x) {
      out[(size_t)k * C + ch] = red[ch];
      out[(size_t)(k + 1) * C + ch] = red[t.rows * cb + ch];
    }
    __syncthreads();  // row 0 read before the next pair overwrites it
  }
}

// Slots (B, splits, K, C) summed in split order. kStats (K = 2): the
// channels' sums of v and v^2 folded per group (its channels in order) into
// per-channel mean (out0) and rstd (out1), (B, C) each; else the sums into
// out0 (B, K, C). Grid (C / cb, B).
template <bool kStats>
__global__ void __launch_bounds__(kGnThreads)
    gn_bwd_fold_kernel(const float* __restrict__ slots, int splits, int K,
                       int C, int cb, int cg, float cnt, float eps,
                       float* __restrict__ out0, float* __restrict__ out1) {
  __shared__ float tot[2 * kGnMaxChannels];
  const int b = blockIdx.y, c0 = blockIdx.x * cb;
  const size_t step = (size_t)K * C;
  for (int j = threadIdx.x; j < K * cb; j += blockDim.x) {
    const int k = j / cb, ch = j - k * cb;
    const float* src = slots + (size_t)b * splits * step + (size_t)k * C + c0 +
                       ch;
    float t = 0.f;
    int s = 0;
    for (; s + 4 <= splits; s += 4) {  // four loads in flight, added in order
      const float v0 = src[s * step], v1 = src[(s + 1) * step];
      const float v2 = src[(s + 2) * step], v3 = src[(s + 3) * step];
      t += v0;
      t += v1;
      t += v2;
      t += v3;
    }
    for (; s < splits; ++s) t += src[s * step];
    if (kStats)
      tot[j] = t;
    else
      out0[((size_t)b * K + k) * C + c0 + ch] = t;
  }
  if (!kStats) return;
  __syncthreads();
  for (int g = threadIdx.x; g < cb / cg; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      s1 += tot[g * cg + j];
      s2 += tot[cb + g * cg + j];
    }
    const float m = s1 / cnt;
    const float r = rsqrtf(fmaxf(s2 / cnt - m * m, 0.f) + eps);
    const size_t c = (size_t)b * C + c0 + g * cg;
    for (int j = 0; j < cg; ++j) {
      out0[c + j] = m;
      out1[c + j] = r;
    }
  }
}

template <typename T>
__device__ __forceinline__ float act_silu(float v) {
  // as K2 applies it: the fast exp and division err far below bf16's
  // rounding
  if constexpr (sizeof(T) == 2) return __fdividef(v, 1.f + __expf(-v));
  return silu(v);
}

// K1's activation SiLU(x*mult + add), mult = a*gamma*rstd and add = (b -
// mean)*gamma*rstd + beta as K1's forward folds them. Grid (splits, C / cb,
// B).
template <typename T, bool kPre>
__global__ void __launch_bounds__(kGnThreads, kBwdMinBlocks)
    gn_bwd_act_kernel(const T* __restrict__ x,
                      const float* __restrict__ pre_scale,
                      const float* __restrict__ pre_bias,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, T* __restrict__ act,
                      int HW, int C, int cb, int per) {
  using IO = Vec16<T>;
  constexpr int N = IO::N;
  constexpr int kLoads = 2 * kBwdUnroll;  // one input: twice the pixels
  const Tile t = tile_of<N>(HW, cb, per);
  const int cf = t.c0 + t.col * N;
  const size_t bc = (size_t)t.b * C + cf;
  float m[N], ad[N];
#pragma unroll
  for (int v = 0; v < N; ++v) {
    const float sc = gamma[cf + v] * rstd[bc + v];
    const float pa = kPre && pre_scale ? pre_scale[bc + v] : 1.f;
    const float po = kPre && pre_bias ? pre_bias[bc + v] : 0.f;
    m[v] = pa * sc;
    ad[v] = (po - mean[bc + v]) * sc + beta[cf + v];
  }
  const size_t base = (size_t)t.b * HW * C + cf;
  for (int p = t.p0 + t.r; p < t.p1; p += kLoads * t.rows) {
    uint4 rx[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = p + u * t.rows;
      if (q < t.p1) rx[u] = load16(x + base + (size_t)q * C);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = p + u * t.rows;
      if (q >= t.p1) continue;
      float f[N];
      IO::unpack(rx[u], f);
#pragma unroll
      for (int v = 0; v < N; ++v) f[v] = act_silu<T>(fmaf(f[v], m[v], ad[v]));
      *reinterpret_cast<uint4*>(act + base + (size_t)q * C) = IO::pack(f);
    }
  }
}

// Pass 2: dx from pass 1's folded sums (B, K, C); the first block of each
// slice writes the pre-affine's gradients (B, C) where asked. Grid (splits,
// C / cb, B).
template <typename T, bool kPre, bool kSwish>
__global__ void __launch_bounds__(kGnThreads, kBwdMinBlocks)
    gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ pre_scale,
                     const float* __restrict__ pre_bias,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ sums, T* __restrict__ dx,
                     float* __restrict__ dpre_scale,
                     float* __restrict__ dpre_bias, int HW, int C, int cg,
                     int cb, int per) {
  using IO = Vec16<T>;
  constexpr int N = IO::N;
  constexpr int K = kPre ? 6 : 2;
  __shared__ float gm[2 * kGnMaxChannels];  // m1, m2 of the block's groups
  const Tile t = tile_of<N>(HW, cb, per);
  const int ng = cb / cg;
  const float cnt = (float)HW * (float)cg;
  const float* sb = sums + (size_t)t.b * K * C;
  for (int g = threadIdx.x; g < ng; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      const int c = t.c0 + g * cg + j;
      s1 += gamma[c] * sb[c];
      s2 += gamma[c] * sb[C + c];
    }
    gm[g] = s1 / cnt;
    gm[ng + g] = s2 / cnt;
  }
  __syncthreads();
  if (kPre && t.s == 0) {
    for (int ch = threadIdx.x; ch < cb; ch += blockDim.x) {
      const int c = t.c0 + ch, g = ch / cg;
      const float* q = sb + c;
      const float r = rstd[(size_t)t.b * C + c], m1 = gm[g], m2 = gm[ng + g];
      if (dpre_bias)
        dpre_bias[(size_t)t.b * C + c] =
            r * (gamma[c] * q[0] - (float)HW * m1 - m2 * q[3 * C]);
      if (dpre_scale)
        dpre_scale[(size_t)t.b * C + c] =
            r * (gamma[c] * q[2 * C] - m1 * q[5 * C] - m2 * q[4 * C]);
    }
  }
  const int cf = t.c0 + t.col * N;
  const size_t bc = (size_t)t.b * C + cf;
  float a[N], o[N], mu[N], rs[N], ga[N], be[N], c1[N], c2[N];
#pragma unroll
  for (int v = 0; v < N; ++v) {
    const int g = (t.col * N + v) / cg;
    a[v] = kPre && pre_scale ? pre_scale[bc + v] : 1.f;
    o[v] = kPre && pre_bias ? pre_bias[bc + v] : 0.f;
    mu[v] = mean[bc + v];
    rs[v] = rstd[bc + v];
    ga[v] = gamma[cf + v];
    be[v] = beta[cf + v];
    c1[v] = rs[v] * gm[g];       // rstd*m1
    c2[v] = rs[v] * gm[ng + g];  // rstd*m2
  }
  const size_t base = (size_t)t.b * HW * C + cf;
  for (int p = t.p0 + t.r; p < t.p1; p += kBwdUnroll * t.rows) {
    uint4 rx[kBwdUnroll], rd[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int q = p + u * t.rows;
      if (q < t.p1) {
        rx[u] = load16(x + base + (size_t)q * C);
        rd[u] = load16(dy + base + (size_t)q * C);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int q = p + u * t.rows;
      if (q >= t.p1) continue;
      float xf[N], df[N];
      IO::unpack(rx[u], xf);
      IO::unpack(rd[u], df);
#pragma unroll
      for (int v = 0; v < N; ++v) {
        const float vv = kPre ? fmaf(xf[v], a[v], o[v]) : xf[v];
        const float xh = (vv - mu[v]) * rs[v];
        float dz = df[v];
        if (kSwish) {
          const float z = fmaf(xh, ga[v], be[v]);
          const float sg = sigmoid(z);
          dz *= sg * (1.f + z * (1.f - sg));
        }
        const float d = fmaf(rs[v] * ga[v], dz, -fmaf(c2[v], xh, c1[v]));
        xf[v] = kPre ? a[v] * d : d;
      }
      *reinterpret_cast<uint4*>(dx + base + (size_t)q * C) = IO::pack(xf);
    }
  }
}

// dgamma[c] = sum_b sums[b, 1, c], dbeta[c] = sum_b sums[b, 0, c]: 8
// strided runs over b, then the runs in order. Block (32, 8); grid C / 32
// rounded up.
__global__ void gn_bwd_params_kernel(const float* __restrict__ sums, int B,
                                     int K, int C,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta) {
  __shared__ float red[2][kBwdFoldRuns][32];
  const int cx = threadIdx.x, run = threadIdx.y;
  const int c = blockIdx.x * 32 + cx;
  float tb = 0.f, tg = 0.f;
  if (c < C) {
    for (int b = run; b < B; b += kBwdFoldRuns) {
      tb += sums[(size_t)b * K * C + c];
      tg += sums[((size_t)b * K + 1) * C + c];
    }
  }
  red[0][run][cx] = tb;
  red[1][run][cx] = tg;
  __syncthreads();
  if (run == 0 && c < C) {
    for (int k = 1; k < kBwdFoldRuns; ++k) {
      tb += red[0][k][cx];
      tg += red[1][k][cx];
    }
    dbeta[c] = tb;
    dgamma[c] = tg;
  }
}

struct BwdPlan {
  int vec, cb, threads, rows, splits, per;
  size_t smem;  // dynamic shared memory of the sums launches
};

// Blocks of 256 threads the card keeps resident on one SM for pass 2 (the
// heaviest launch in registers), read once per device and dtype.
template <typename T>
cudaError_t bwd_occupancy(int* occ) {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && (*occ = known[dev].load(std::memory_order_acquire)) > 0)
    return cudaSuccess;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      occ, gn_bwd_dx_kernel<T, false, true>, kGnThreads, 0);
  if (err == cudaSuccess && *occ < 1) *occ = 1;
  if (err == cudaSuccess && keep)
    known[dev].store(*occ, std::memory_order_release);
  return err;
}

// The channel blocks and threads of K1's statistics (16-byte loads); the
// slices split over pixels so that the grid fills the card's resident
// blocks once, each block at least kBwdMinPixels pixels. vec = 0 when C is
// not a multiple of one 16-byte load's channels.
BwdPlan bwd_plan(int B, int HW, int C, int G, int elem, int sms, int occ) {
  BwdPlan p{};
  const GnPlan g = gn_geometry(C, G, elem, true, kGnStatsRowBytes);
  if (g.vec * elem != 16) return p;
  p.vec = g.vec;
  p.cb = g.cb;
  p.threads = g.threads;
  p.rows = g.rows;
  const long long slices = (long long)B * (C / p.cb);
  long long s = (long long)occ * sms / slices;
  const long long most = (HW + kBwdMinPixels - 1) / kBwdMinPixels;
  if (s > most) s = most;
  if (s < 1) s = 1;
  p.per = (int)((HW + s - 1) / s);
  p.splits = (HW + p.per - 1) / p.per;
  p.smem = sizeof(float) * 2 * (size_t)p.rows * p.cb;
  return p;
}

template <typename T>
cudaError_t plan_of(int B, int HW, int C, int G, BwdPlan* p) {
  if (!gn_takes(B, HW, C, G)) return cudaErrorInvalidValue;
  int sms = 0, occ = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) err = bwd_occupancy<T>(&occ);
  if (err != cudaSuccess) return err;
  *p = bwd_plan(B, HW, C, G, sizeof(T), sms, occ);
  return p->vec ? cudaSuccess : cudaErrorInvalidValue;
}

// Workspace floats: mean, rstd (2, B, C); the slots (B, splits, K, C); the
// folded sums (B, K, C) when splits > 1.
size_t workspace_floats(int B, int C, const BwdPlan& p, bool pre) {
  const size_t k = pre ? 6 : 2, bc = (size_t)B * C;
  return 2 * bc + bc * p.splits * k + (p.splits > 1 ? bc * k : 0);
}

template <typename T, bool kPre>
cudaError_t stats_pass(const T* x, const float* pre_scale,
                       const float* pre_bias, float* mean, float* rstd,
                       float* slots, int B, int HW, int C, int G, float eps,
                       const BwdPlan& p, cudaStream_t st) {
  const dim3 grid(p.splits, C / p.cb, B);
  gn_bwd_sums_kernel<T, false, kPre, false><<<grid, p.threads, p.smem, st>>>(
      x, nullptr, pre_scale, pre_bias, nullptr, nullptr, nullptr, nullptr,
      slots, HW, C, p.cb, p.per);
  gn_bwd_fold_kernel<true><<<dim3(C / p.cb, B), kGnThreads, 0, st>>>(
      slots, p.splits, 2, C, p.cb, C / G, (float)HW * (float)(C / G), eps,
      mean, rstd);
  return cudaGetLastError();
}

template <typename T, bool kPre, bool kSwish>
cudaError_t bwd_t(const T* x, const T* dy, const float* pre_scale,
                  const float* pre_bias, const float* gamma,
                  const float* beta, const float* mean, const float* rstd,
                  T* dx, float* dgamma, float* dbeta, float* dpre_scale,
                  float* dpre_bias, float* ws, int B, int HW, int C, int G,
                  float eps, const BwdPlan& p, cudaStream_t st) {
  constexpr int K = kPre ? 6 : 2;
  const size_t bc = (size_t)B * C;
  float* slots = ws + 2 * bc;
  if (!mean) {
    float* m = ws;
    float* r = ws + bc;
    const cudaError_t err = stats_pass<T, kPre>(
        x, pre_scale, pre_bias, m, r, slots, B, HW, C, G, eps, p, st);
    if (err != cudaSuccess) return err;
    mean = m;
    rstd = r;
  }
  const dim3 grid(p.splits, C / p.cb, B);
  gn_bwd_sums_kernel<T, true, kPre, kSwish><<<grid, p.threads, p.smem, st>>>(
      x, dy, pre_scale, pre_bias, gamma, beta, mean, rstd, slots, HW, C, p.cb,
      p.per);
  float* sums = slots;
  if (p.splits > 1) {
    sums = slots + bc * p.splits * K;
    gn_bwd_fold_kernel<false><<<dim3(C / p.cb, B), kGnThreads, 0, st>>>(
        slots, p.splits, K, C, p.cb, C / G, 0.f, 0.f, sums, nullptr);
  }
  gn_bwd_dx_kernel<T, kPre, kSwish><<<grid, p.threads, 0, st>>>(
      x, dy, pre_scale, pre_bias, gamma, beta, mean, rstd, sums, dx,
      dpre_scale, dpre_bias, HW, C, C / G, p.cb, p.per);
  gn_bwd_params_kernel<<<(C + 31) / 32, dim3(32, kBwdFoldRuns), 0, st>>>(
      sums, B, K, C, dgamma, dbeta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dtype(const void* x, const void* dy, const float* pre_scale,
                      const float* pre_bias, const float* gamma,
                      const float* beta, const float* mean,
                      const float* rstd, void* dx, float* dgamma,
                      float* dbeta, float* dpre_scale, float* dpre_bias,
                      float* ws, int B, int HW, int C, int G, float eps,
                      bool swish, cudaStream_t st) {
  BwdPlan p;
  const cudaError_t err = plan_of<T>(B, HW, C, G, &p);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  T* out = static_cast<T*>(dx);
  const bool pre = pre_scale || pre_bias;
#define SR3_GN_BWD(P, S)                                                     \
  return bwd_t<T, P, S>(xt, dt, pre_scale, pre_bias, gamma, beta, mean,     \
                        rstd, out, dgamma, dbeta, dpre_scale, dpre_bias, ws, \
                        B, HW, C, G, eps, p, st)
  if (pre) {
    if (swish) SR3_GN_BWD(true, true);
    SR3_GN_BWD(true, false);
  }
  if (swish) SR3_GN_BWD(false, true);
  SR3_GN_BWD(false, false);
#undef SR3_GN_BWD
}

template <typename T>
cudaError_t act_dtype(const void* x, const float* pre_scale,
                      const float* pre_bias, const float* gamma,
                      const float* beta, void* act, float* mean, float* rstd,
                      float* ws, int B, int HW, int C, int G, float eps,
                      cudaStream_t st) {
  BwdPlan p;
  cudaError_t err = plan_of<T>(B, HW, C, G, &p);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  float* slots = ws + 2 * (size_t)B * C;
  const dim3 grid(p.splits, C / p.cb, B);
  if (pre_scale || pre_bias) {
    err = stats_pass<T, true>(xt, pre_scale, pre_bias, mean, rstd, slots, B,
                              HW, C, G, eps, p, st);
    if (err == cudaSuccess)
      gn_bwd_act_kernel<T, true><<<grid, p.threads, 0, st>>>(
          xt, pre_scale, pre_bias, gamma, beta, mean, rstd,
          static_cast<T*>(act), HW, C, p.cb, p.per);
  } else {
    err = stats_pass<T, false>(xt, nullptr, nullptr, mean, rstd, slots, B,
                               HW, C, G, eps, p, st);
    if (err == cudaSuccess)
      gn_bwd_act_kernel<T, false><<<grid, p.threads, 0, st>>>(
          xt, nullptr, nullptr, gamma, beta, mean, rstd,
          static_cast<T*>(act), HW, C, p.cb, p.per);
  }
  return err == cudaSuccess ? cudaGetLastError() : err;
}

}  // namespace
}  // namespace sr3

// Floats of float32 scratch that sr3_gn_bwd and sr3_gn_bwd_act take as
// `workspace` (pre != 0: with a pre-affine); -1 when the kernel does not
// take the shape.
extern "C" long long sr3_gn_bwd_workspace_floats(int B, int HW, int C, int G,
                                                 int dtype, int pre) {
  sr3::BwdPlan p;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == sr3::kF32) err = sr3::plan_of<float>(B, HW, C, G, &p);
  if (dtype == sr3::kBF16) err = sr3::plan_of<__nv_bfloat16>(B, HW, C, G, &p);
  if (err != cudaSuccess) return -1;
  return (long long)sr3::workspace_floats(B, C, p, pre != 0);
}

// dx (x's dtype), dgamma, dbeta (C float32) of y = SiLU?(GroupNorm(a*x+b))
// for the output gradient dy (x's dtype); x, dy, dx: (B, HW, C), 16-byte
// aligned. pre_scale / pre_bias: (B, C) float32 or null (then 1 / 0);
// dpre_scale / dpre_bias: their (B, C) gradients, or null where not asked.
// mean / rstd: per-(b, c) statistics of a*x+b, (B, C) float32, or null to
// take them in a pass of the kernel's own. Returns the CUDA error code of
// the launches (0 on success).
extern "C" int sr3_gn_bwd(const void* x, const void* dy,
                          const float* pre_scale, const float* pre_bias,
                          const float* gamma, const float* beta,
                          const float* mean, const float* rstd, void* dx,
                          float* dgamma, float* dbeta, float* dpre_scale,
                          float* dpre_bias, float* workspace, int B, int HW,
                          int C, int G, float eps, int swish, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((mean == nullptr) != (rstd == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == sr3::kF32)
    return (int)sr3::bwd_dtype<float>(
        x, dy, pre_scale, pre_bias, gamma, beta, mean, rstd, dx, dgamma,
        dbeta, dpre_scale, dpre_bias, workspace, B, HW, C, G, eps, swish != 0,
        st);
  if (dtype == sr3::kBF16)
    return (int)sr3::bwd_dtype<__nv_bfloat16>(
        x, dy, pre_scale, pre_bias, gamma, beta, mean, rstd, dx, dgamma,
        dbeta, dpre_scale, dpre_bias, workspace, B, HW, C, G, eps, swish != 0,
        st);
  return (int)cudaErrorInvalidValue;
}

// act = SiLU(GroupNorm(a*x + b)) in x's dtype, K1's activation, from
// statistics taken in a pass of its own and written to mean / rstd ((B, C)
// float32 each, for sr3_gn_bwd). Returns the CUDA error code (0 on
// success).
extern "C" int sr3_gn_bwd_act(const void* x, const float* pre_scale,
                              const float* pre_bias, const float* gamma,
                              const float* beta, void* act, float* mean,
                              float* rstd, float* workspace, int B, int HW,
                              int C, int G, float eps, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sr3::kF32)
    return (int)sr3::act_dtype<float>(x, pre_scale, pre_bias, gamma, beta,
                                      act, mean, rstd, workspace, B, HW, C,
                                      G, eps, st);
  if (dtype == sr3::kBF16)
    return (int)sr3::act_dtype<__nv_bfloat16>(x, pre_scale, pre_bias, gamma,
                                              beta, act, mean, rstd,
                                              workspace, B, HW, C, G, eps,
                                              st);
  return (int)cudaErrorInvalidValue;
}
