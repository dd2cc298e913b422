// K2: GroupNorm with optional SiLU, NHWC, in one launch; and K1's
// GroupNorm statistics, also in one launch (launch_gn_stats).
//
// Replaces the TPU kernel sr3_tpu/ops/groupnorm.py:237 `_gn_swish_kernel`
// (pallas_call in `group_norm_swish_pallas`, :290, call :295). On the paths
// it is the attention pre-norm (swish off: 16->128 at 16^2 and 8^2, 64->512
// at 64^2 and 32^2) and, in training, the norm of every dropout Block (swish
// on, maps up to 128^2; larger maps take the statistics route, K3).
//
// Bound on the card: device-memory bytes. The function reads x once and
// writes y once (2 x 8.4 MB at 2x512x64^2 in bf16: 5.0 us at 3.35 TB/s);
// a few FLOPs per element. The TPU kernel keeps its block resident in VMEM
// and reads x once. The three-launch kernel this replaces read x twice,
// spilled float32 partials to device memory, folded them with 2 blocks on
// 132 SMs, and loaded 2 bytes a thread.
//
// Design (common.cuh "GroupNorm statistics"): one thread-block cluster per
// (batch element, channel block of whole groups); each of its <= 16 blocks
// owns a pixel range, loads it once with 16-byte loads (8 bf16 / 4 float32
// channels a thread, neighbouring threads on neighbouring channels), sums v
// and v^2 in float32 and keeps the raw range in shared memory when the
// slice fits the cluster (every K2 site of the two configs does in bf16:
// the largest, 64 channels at 128^2, is split into two 1 MB slices of 32
// channels, 64 KB a block). After cluster.sync() every block reads its
// peers' per-channel sums through distributed shared memory in rank order
// (the same order in every block, so all of them compute the same
// mult / add), normalizes its own range from shared memory -- or from
// device memory (L2) when the slice did not fit -- applies SiLU when asked
// and stores with 16-byte stores. No atomics; the result does not vary
// from run to run.
//
// K1's statistics: the same loads and fold order over more blocks than a
// cluster holds (4 per SM; 2x64x512^2 has 2 slices of 64 channels, 128
// bytes a pixel, so a warp reads whole lines); each block writes
// its sums to a fixed slot, and the last block of a slice to take a ticket
// folds the slots in index order and resets the ticket. The fold does not
// depend on which block runs it.
//
// Tolerance against the plain version (sr3_tpu_torch/ops/groupnorm.py
// `group_norm_plain`): 1e-5 of max|ref| in float32 -- only the order of the
// float32 sums and x*mult+add versus (x-mean)*rstd*gamma+beta differ;
// 2e-2 in bfloat16 -- one bf16 rounding of the output (2^-8 relative).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cgrp = cooperative_groups;

namespace sr3 {
namespace {

// Loads and stores of `V` neighbouring channels: one 16-byte word, or one
// element.
template <typename T, int V>
struct GnIO;

template <>
struct GnIO<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct GnIO<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ float2 half(unsigned w) {
    __nv_bfloat162 h;
    *reinterpret_cast<unsigned*>(&h) = w;
    return __bfloat1622float2(h);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = half(w[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                      pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  }
};

template <typename T>
struct GnIO<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = to_float(r);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return from_float<T>(f[0]);
  }
};

constexpr int kUnroll = 4;    // loads in flight per thread
constexpr int kFoldLoads = 8;  // slot loads a thread keeps in flight in
                               // the fold

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Sums of v = a*x + o (kAffine) or x over pixels [p0, p1) of one slice:
// this thread takes pixels p0 + r, p0 + r + rows, ..., channels col*V ..
// col*V + V - 1 of the block (xs: the slice's first channel of pixel 0,
// pixel stride C). With kKeep it also stores the raw values into `tile`
// ([per][cb] of T).
template <typename T, int V, bool kAffine, bool kKeep>
__device__ __forceinline__ void gn_accumulate(const T* __restrict__ xs,
                                              int C, int p0, int p1, int r,
                                              int rows, int col,
                                              const float* a, const float* o,
                                              float* s1, float* s2, T* tile,
                                              int cb) {
  using IO = GnIO<T, V>;
  using Raw = typename IO::Raw;
  for (int p = p0 + r; p < p1; p += kUnroll * rows) {
    Raw raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q < p1)
        raw[u] = *reinterpret_cast<const Raw*>(xs + (size_t)q * C + col * V);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q < p1) {
        float f[V];
        IO::unpack(raw[u], f);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float t = kAffine ? fmaf(f[v], a[v], o[v]) : f[v];
          s1[v] += t;
          s2[v] = fmaf(t, t, s2[v]);
        }
        if (kKeep)
          *reinterpret_cast<Raw*>(tile + (size_t)(q - p0) * cb + col * V) =
              raw[u];
      }
    }
  }
}

// Sums of x over the first `n` pixels of a resident tile ([per][cb] of T),
// in gn_accumulate's order: this thread's pixels r, r + rows, ...
template <typename T, int V>
__device__ __forceinline__ void gn_sum_tile(const T* tile, int cb, int n,
                                            int r, int rows, int col,
                                            float* s1, float* s2) {
  using IO = GnIO<T, V>;
  for (int q = r; q < n; q += rows) {
    float f[V];
    IO::unpack(*reinterpret_cast<const typename IO::Raw*>(
                   tile + (size_t)q * cb + col * V),
               f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s1[v] += f[v];
      s2[v] = fmaf(f[v], f[v], s2[v]);
    }
  }
}

// gn_accumulate<T, V, true, false> for 16-byte loads, streamed through
// kGnRing cp.async slots of this thread in shared memory (`ring`: kGnRing
// x blockDim.x 16-byte slots), so that kGnRing loads a thread stay in
// flight without holding registers. Same order of sums. Ends with the
// thread's copies complete; other threads' slots may still be in flight.
template <typename T, int V>
__device__ __forceinline__ void gn_accumulate_ring(
    const T* __restrict__ xs, int C, int p0, int p1, int r, int rows,
    int col, const float* a, const float* o, float* s1, float* s2,
    uint4* ring) {
  using IO = GnIO<T, V>;
  uint4* mine = ring + threadIdx.x;  // slot u: mine[u * blockDim.x]
#pragma unroll
  for (int u = 0; u < kGnRing; ++u) {
    const int q = p0 + r + u * rows;
    if (q < p1)
      cp_async16(mine + u * blockDim.x, xs + (size_t)q * C + col * V, true);
    cp_async_commit();
  }
  int slot = 0;
  for (int q = p0 + r; q < p1; q += rows) {
    cp_async_wait<kGnRing - 1>();  // the copy into `slot` has landed
    float f[V];
    IO::unpack(mine[slot * blockDim.x], f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float t = fmaf(f[v], a[v], o[v]);
      s1[v] += t;
      s2[v] = fmaf(t, t, s2[v]);
    }
    // refill the slot just read (its value is consumed above)
    const int qn = q + kGnRing * rows;
    if (qn < p1)
      cp_async16(mine + slot * blockDim.x, xs + (size_t)qn * C + col * V,
                 true);
    cp_async_commit();
    slot = slot + 1 == kGnRing ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// The block's per-channel sums: thread sums into red ([2][rows][cb]), rows
// folded in a fixed tree (row i takes row i + h, h halving); the result is
// row 0: red[ch] (sum v), red[rows*cb + ch] (sum v^2). Ends synchronized.
template <int V>
__device__ __forceinline__ void gn_block_reduce(float* red, int rows, int cb,
                                                int r, int col,
                                                const float* s1,
                                                const float* s2) {
  const int n = rows * cb;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    red[r * cb + col * V + v] = s1[v];
    red[n + r * cb + col * V + v] = s2[v];
  }
  __syncthreads();
  int h = 1;
  while (2 * h < rows) h *= 2;
  for (; h > 0; h >>= 1) {
    for (int i = threadIdx.x; i < h * cb; i += blockDim.x) {
      const int rr = i / cb;
      if (rr + h < rows) {
        red[i] += red[i + h * cb];
        red[n + i] += red[n + i + h * cb];
      }
    }
    __syncthreads();
  }
}

// Group mean / rstd from the per-channel sums tot1 / tot2 of cb channels
// (cg a group, cnt values each), then per-channel mult / add (gamma, beta,
// a, o point at the block's first channel; a, o may be null). mult / add
// may alias tot1 / tot2. Ends synchronized.
__device__ __forceinline__ void gn_fold(const float* tot1, const float* tot2,
                                        float* gst, int cb, int cg,
                                        float cnt, float eps,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        const float* a, const float* o,
                                        float* mult, float* add) {
  const int ng = cb / cg;
  for (int k = threadIdx.x; k < ng; k += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      s1 += tot1[k * cg + j];
      s2 += tot2[k * cg + j];
    }
    const float mean = s1 / cnt;
    const float var = fmaxf(s2 / cnt - mean * mean, 0.f);
    gst[k] = mean;
    gst[ng + k] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < cb; ch += blockDim.x) {
    const int k = ch / cg;
    const float sc = gamma[ch] * gst[ng + k];
    const float pa = a ? a[ch] : 1.f, po = o ? o[ch] : 0.f;
    mult[ch] = pa * sc;
    add[ch] = (po - gst[k]) * sc + beta[ch];
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ float gn_silu(float v) {
  // bf16 output: the fast exp and division err far below its rounding
  if constexpr (sizeof(T) == 2) return __fdividef(v, 1.f + __expf(-v));
  return silu(v);
}

// K2. Grid (cluster size, C / cb, B), cluster (cluster size, 1, 1); block
// rows*cols threads; dynamic shared memory: the resident tile (when
// `resident`), then gn_scratch_bytes.
template <typename T, int V, bool kSwish>
__global__ void __launch_bounds__(V == 1 ? kGnMaxChannels : kGnThreads,
                                  V == 1 ? 1 : kGnMinBlocksPerSm)
    gn_cluster_kernel(const T* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      int HW, int C, int cg, int cb, int per, int resident,
                      float eps) {
  using IO = GnIO<T, V>;
  using Raw = typename IO::Raw;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  // the grid's x extent is one cluster: a block's rank is blockIdx.x
  const int rank = (int)cluster.block_rank(), cs = gridDim.x;
  const int cols = cb / V, rows = blockDim.x / cols;
  const int r = threadIdx.x / cols, col = threadIdx.x % cols;
  const int c0 = blockIdx.y * cb;
  const int p0 = min(HW, rank * per), p1 = min(HW, p0 + per);

  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const size_t tile_bytes =
      resident ? ((size_t)per * cb * sizeof(T) + 15) / 16 * 16 : 0;
  float* red = reinterpret_cast<float*>(smem + tile_bytes);
  float* tot = red + 2 * rows * cb;
  float* gst = tot + 2 * cb;

  const size_t base = (size_t)blockIdx.z * HW * C + c0;
  float s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.f;
  if (resident && V * sizeof(T) == 16) {
    // the whole range in flight at once: cp.async each of this thread's
    // 16-byte words into the tile, then sum them from shared memory (a
    // thread reads back only its own copies)
    for (int q = r; q < p1 - p0; q += rows)
      cp_async16(tile + (size_t)q * cb + col * V,
                 x + base + (size_t)(p0 + q) * C + col * V, true);
    cp_async_commit();
    cp_async_wait<0>();
    gn_sum_tile<T, V>(tile, cb, p1 - p0, r, rows, col, s1, s2);
  } else if (resident)
    gn_accumulate<T, V, false, true>(x + base, C, p0, p1, r, rows, col,
                                     nullptr, nullptr, s1, s2, tile, cb);
  else
    gn_accumulate<T, V, false, false>(x + base, C, p0, p1, r, rows, col,
                                      nullptr, nullptr, s1, s2, tile, cb);
  gn_block_reduce<V>(red, rows, cb, r, col, s1, s2);

  // every block's sums are in row 0 of its `red`: fold them in rank order
  cluster.sync();
  for (int ch = threadIdx.x; ch < cb; ch += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float* peer = cluster.map_shared_rank(red, k);
      t1 += peer[ch];
      t2 += peer[rows * cb + ch];
    }
    tot[ch] = t1;
    tot[cb + ch] = t2;
  }
  cluster_arrive();  // this block has read its peers' shared memory
  __syncthreads();
  gn_fold(tot, tot + cb, gst, cb, cg, (float)HW * (float)cg, eps, gamma + c0,
          beta + c0, nullptr, nullptr, tot, tot + cb);

  float m[V], ad[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m[v] = tot[col * V + v];
    ad[v] = tot[cb + col * V + v];
  }
  const T* xs = x + base;
  T* ys = y + base;
  for (int p = p0 + r; p < p1; p += kUnroll * rows) {
    Raw raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q < p1)
        raw[u] = resident ? *reinterpret_cast<const Raw*>(
                                tile + (size_t)(q - p0) * cb + col * V)
                          : *reinterpret_cast<const Raw*>(
                                xs + (size_t)q * C + col * V);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q < p1) {
        float f[V];
        IO::unpack(raw[u], f);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          f[v] = fmaf(f[v], m[v], ad[v]);
          if (kSwish) f[v] = gn_silu<T>(f[v]);
        }
        *reinterpret_cast<Raw*>(ys + (size_t)q * C + col * V) = IO::pack(f);
      }
    }
  }
  cluster_wait();  // no peer reads this block's shared memory any more
}

// K1's statistics. Grid (splits, C / cb, B); block rows*cols threads;
// dynamic shared memory as gn_stats_plan. mult / add: (B, C); slots:
// (B, C / cb, splits, 2, cb), 16-byte aligned, when splits > 1; tickets:
// (B, C / cb), 0 on entry and on exit.
template <typename T, int V>
__global__ void __launch_bounds__(V == 1 ? kGnMaxChannels : kGnThreads,
                                  V == 1 ? 1 : kGnMinBlocksPerSm)
    gn_stats_kernel(const T* __restrict__ x,
                    const float* __restrict__ pre_scale,
                    const float* __restrict__ pre_bias,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ mult,
                    float* __restrict__ add, float* __restrict__ slots,
                    int* __restrict__ tickets, int HW, int C, int cg, int cb,
                    int per, float eps) {
  const int s = blockIdx.x, splits = gridDim.x;
  const int cols = cb / V, rows = blockDim.x / cols;
  const int r = threadIdx.x / cols, col = threadIdx.x % cols;
  const int b = blockIdx.z, c0 = blockIdx.y * cb;
  const int slice = b * gridDim.y + blockIdx.y;
  const int p0 = min(HW, s * per), p1 = min(HW, p0 + per);

  // the cp.async ring and the thread sums `red` share the front of shared
  // memory (the sums are written after every thread's ring is drained)
  constexpr bool kRing = V * sizeof(T) == 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  const int ring_floats = kRing ? kGnRing * blockDim.x * 4 : 0;
  float* tot = red + max(2 * rows * cb, ring_floats);
  float* gst = tot + 2 * cb;
  __shared__ int last;

  const float* pa = pre_scale ? pre_scale + (size_t)b * C + c0 : nullptr;
  const float* po = pre_bias ? pre_bias + (size_t)b * C + c0 : nullptr;
  float a[V], o[V], s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    a[v] = pa ? pa[col * V + v] : 1.f;
    o[v] = po ? po[col * V + v] : 0.f;
    s1[v] = s2[v] = 0.f;
  }
  const T* xs = x + (size_t)b * HW * C + c0;
  if constexpr (kRing) {
    gn_accumulate_ring<T, V>(xs, C, p0, p1, r, rows, col, a, o, s1, s2,
                             reinterpret_cast<uint4*>(smem));
    __syncthreads();  // every ring drained before `red` overwrites it
  } else {
    gn_accumulate<T, V, true, false>(xs, C, p0, p1, r, rows, col, a, o, s1,
                                     s2, nullptr, cb);
  }
  gn_block_reduce<V>(red, rows, cb, r, col, s1, s2);

  const int n2 = 2 * cb;
  if (splits == 1) {
    for (int ch = threadIdx.x; ch < cb; ch += blockDim.x) {
      tot[ch] = red[ch];
      tot[cb + ch] = red[rows * cb + ch];
    }
  } else {
    float* mine = slots + ((size_t)slice * splits + s) * n2;
    for (int ch = threadIdx.x; ch < cb; ch += blockDim.x) {
      mine[ch] = red[ch];
      mine[cb + ch] = red[rows * cb + ch];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(tickets + slice, 1) == splits - 1;
      if (last) atomicExch(tickets + slice, 0);  // ready for the next call
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the slots in index order: `parts` threads per `w` values (one
    // 16-byte load when the slot width allows) each sum a fixed run of
    // slots, then the runs are added in order
    const float* all = slots + (size_t)slice * splits * n2;
    const int w = n2 % 4 == 0 ? 4 : 1, ncol = n2 / w;
    const int parts = max(1, min(rows, (int)blockDim.x / ncol));
    for (int i = threadIdx.x; i < parts * ncol; i += blockDim.x) {
      const int pt = i / ncol, jc = i - pt * ncol;
      const int k0 = (int)((long long)pt * splits / parts);
      const int k1 = (int)((long long)(pt + 1) * splits / parts);
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      if (w == 4) {
        const float4* col4 = reinterpret_cast<const float4*>(all) + jc;
        int k = k0;
        for (; k + kFoldLoads <= k1; k += kFoldLoads) {  // loads in flight
          float4 v[kFoldLoads];
#pragma unroll
          for (int u = 0; u < kFoldLoads; ++u)
            v[u] = __ldcg(col4 + (size_t)(k + u) * ncol);
#pragma unroll
          for (int u = 0; u < kFoldLoads; ++u) {
            t[0] += v[u].x;
            t[1] += v[u].y;
            t[2] += v[u].z;
            t[3] += v[u].w;
          }
        }
        for (; k < k1; ++k) {
          const float4 v = __ldcg(col4 + (size_t)k * ncol);
          t[0] += v.x;
          t[1] += v.y;
          t[2] += v.z;
          t[3] += v.w;
        }
      } else {
        for (int k = k0; k < k1; ++k) t[0] += __ldcg(all + (size_t)k * n2 + jc);
      }
      for (int e = 0; e < w; ++e) red[pt * n2 + jc * w + e] = t[e];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n2; j += blockDim.x) {
      float t = 0.f;
      for (int pt = 0; pt < parts; ++pt) t += red[pt * n2 + j];
      tot[j] = t;
    }
  }
  __syncthreads();
  gn_fold(tot, tot + cb, gst, cb, cg, (float)HW * (float)cg, eps, gamma + c0,
          beta + c0, pa, po, mult + (size_t)b * C + c0,
          add + (size_t)b * C + c0);
}

bool aligned16(const void* p, const void* q) {
  return ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(q)) %
          16) == 0;
}

template <typename T, int V>
cudaError_t stats_t(const T* x, const float* pre_scale, const float* pre_bias,
                    const float* gamma, const float* beta, float* workspace,
                    int* tickets, int B, int HW, int C, int G, float eps,
                    const GnPlan& p, cudaStream_t st) {
  float* mult = workspace;
  float* add = gn_add(workspace, B, C);
  gn_stats_kernel<T, V>
      <<<dim3(p.splits, C / p.cb, B), p.threads, p.smem, st>>>(
          x, pre_scale, pre_bias, gamma, beta, mult, add,
          workspace + gn_slots_offset(B, C), tickets, HW, C, C / G, p.cb,
          p.per, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t stats_dtype(const void* xv, const float* pre_scale,
                        const float* pre_bias, const float* gamma,
                        const float* beta, float* workspace, int* tickets,
                        int B, int HW, int C, int G, float eps,
                        cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const bool aligned = aligned16(x, x);
  const GnPlan p = gn_stats_plan(B, HW, C, G, sizeof(T), aligned, sms);
  if (p.splits > 1 && !tickets) return cudaErrorInvalidValue;
  if (p.vec > 1)
    return stats_t<T, 16 / sizeof(T)>(x, pre_scale, pre_bias, gamma, beta,
                                      workspace, tickets, B, HW, C, G, eps, p,
                                      st);
  return stats_t<T, 1>(x, pre_scale, pre_bias, gamma, beta, workspace,
                       tickets, B, HW, C, G, eps, p, st);
}

// K2's launches since the last reset, by dtype (0 float32, 1 bfloat16),
// residency and cluster size (the order of sr3_group_norm_clusters).
std::atomic<long long> g_cluster_launches[2][2][kGnMaxCluster];

template <typename T, int V, bool kSwish>
cudaError_t cluster_t(const T* x, const float* gamma, const float* beta,
                      T* y, int B, int HW, int C, int G, float eps,
                      const GnPlan& p, cudaStream_t st) {
  const auto kernel = gn_cluster_kernel<T, V, kSwish>;
  static SmemLimit smem_limit, nonportable;
  cudaError_t err = raise_smem_limit(smem_limit, (const void*)kernel,
                                     kGnMaxSmem);
  if (err == cudaSuccess)
    err = set_attribute_once(nonportable, (const void*)kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, C / p.cb, B);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, gamma, beta, y, HW, C, C / G,
                           p.cb, p.per, p.resident, eps);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess)
    g_cluster_launches[sizeof(T) == 2][p.resident != 0][p.splits - 1]
        .fetch_add(1, std::memory_order_relaxed);
  return err;
}

template <typename T>
cudaError_t group_norm_dtype(const void* xv, const float* gamma,
                             const float* beta, void* yv, int B, int HW,
                             int C, int G, float eps, int swish,
                             cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const GnPlan p =
      gn_cluster_plan(B, HW, C, G, sizeof(T), aligned16(x, y), sms);
  constexpr int kV = 16 / sizeof(T);
  if (p.vec > 1)
    return swish ? cluster_t<T, kV, true>(x, gamma, beta, y, B, HW, C, G,
                                          eps, p, st)
                 : cluster_t<T, kV, false>(x, gamma, beta, y, B, HW, C, G,
                                           eps, p, st);
  return swish ? cluster_t<T, 1, true>(x, gamma, beta, y, B, HW, C, G, eps,
                                       p, st)
               : cluster_t<T, 1, false>(x, gamma, beta, y, B, HW, C, G, eps,
                                        p, st);
}

}  // namespace

cudaError_t launch_gn_stats(const void* x, int dtype, const float* pre_scale,
                            const float* pre_bias, const float* gamma,
                            const float* beta, float* workspace,
                            int* tickets, int B, int HW, int C, int G,
                            float eps, cudaStream_t stream) {
  if (!gn_takes(B, HW, C, G)) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return stats_dtype<float>(x, pre_scale, pre_bias, gamma, beta, workspace,
                              tickets, B, HW, C, G, eps, stream);
  if (dtype == kBF16)
    return stats_dtype<__nv_bfloat16>(x, pre_scale, pre_bias, gamma, beta,
                                      workspace, tickets, B, HW, C, G, eps,
                                      stream);
  return cudaErrorInvalidValue;
}

}  // namespace sr3

// Floats of float32 scratch that sr3_gn_silu_conv3x3 takes as `workspace`
// for a (B, HW, C) input of dtype in G groups; -1 when the kernels do not
// take the shape.
extern "C" long long sr3_gn_workspace_floats(int B, int HW, int C, int G,
                                             int dtype) {
  return sr3::gn_workspace_floats(B, HW, C, G, dtype);
}

// The plan of a (B, HW, C) map of dtype in G groups, as the kernels take
// it: route 0 is K2 (one cluster per slice), 1 K1's statistics. out[0..7]:
// vec, cb, threads, splits (cluster size for K2), per, resident, shared
// memory bytes, SM count. Returns 0, or -1 when the kernels do not take the
// shape.
extern "C" int sr3_gn_plan(int B, int HW, int C, int G, int dtype, int route,
                           long long* out) {
  if (!sr3::gn_takes(B, HW, C, G) ||
      (dtype != sr3::kF32 && dtype != sr3::kBF16))
    return -1;
  int sms = 0;
  if (sr3::sm_count(&sms) != cudaSuccess) return -1;
  const int elem = dtype == sr3::kF32 ? 4 : 2;
  const sr3::GnPlan p =
      route == 0 ? sr3::gn_cluster_plan(B, HW, C, G, elem, true, sms)
                 : sr3::gn_stats_plan(B, HW, C, G, elem, true, sms);
  const long long v[8] = {p.vec, p.cb, p.threads, p.splits,
                          p.per, p.resident, (long long)p.smem, sms};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// K2's launches since the last reset into counts[0..63]: index
// (dtype * 2 + resident) * 16 + cluster size - 1, dtype 0 float32 and 1
// bfloat16; reset != 0 sets them to 0 after reading. Returns the number of
// counts.
extern "C" int sr3_group_norm_clusters(long long* counts, int reset) {
  int i = 0;
  for (auto& by_resident : sr3::g_cluster_launches)
    for (auto& by_size : by_resident)
      for (auto& n : by_size) counts[i++] = reset ? n.exchange(0) : n.load();
  return i;
}

// y = GroupNorm(x) (then SiLU when swish != 0) in one launch. x, y:
// (B, HW, C) of dtype. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int sr3_group_norm(const void* x, const float* gamma,
                              const float* beta, void* y, int B, int HW,
                              int C, int G, float eps, int swish, int dtype,
                              void* stream) {
  if (!sr3::gn_takes(B, HW, C, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sr3::kF32)
    return (int)sr3::group_norm_dtype<float>(x, gamma, beta, y, B, HW, C, G,
                                             eps, swish, st);
  if (dtype == sr3::kBF16)
    return (int)sr3::group_norm_dtype<__nv_bfloat16>(x, gamma, beta, y, B,
                                                     HW, C, G, eps, swish,
                                                     st);
  return (int)cudaErrorInvalidValue;
}
