// Shared helpers for the sr3_tpu_torch Hopper kernels.
//
// Every kernel reads float32 or bfloat16 activations and accumulates in
// float32. Layouts are the JAX package's: NHWC activations (a logical NCHW
// tensor in torch.channels_last memory), (Cout, 3, 3, Cin) conv weights (a
// channels_last OIHW tensor), (batch*heads, seq, head_dim) attention operands.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sr3 {

enum DType { kF32 = 0, kBF16 = 1 };

// ---- tensor cores, fragment loads and asynchronous copies (K1, K4-K6) ----

// d += a * b: one mma.sync m16n8k16, bf16 operands, float32 accumulate.
// a: the A fragment (rows gid / gid + 8, k 2*tig.. and 8 + 2*tig..; gid =
// lane / 4, tig = lane % 4); b0, b1: the B fragment (k 2*tig.. and
// 8 + 2*tig.., column gid); d: the C fragment (row gid: d[0], d[1]; row
// gid + 8: d[2], d[3]; columns 2*tig, 2*tig + 1).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 and packed as one fragment register: a float32
// C fragment of m16n8 becomes the A fragment of the next product.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring m16n8 C fragments (16 rows x 16 columns, float32)
// rounded to bf16 as the A fragment of an m16n8k16 product whose k runs over
// those 16 columns: the C layout is the A layout.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[i] receives
// matrix i in fragment layout (row gid, columns 2*tig, 2*tig + 1), or with
// `_trans` its transpose (rows 2*tig, 2*tig + 1, column gid).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16-byte asynchronous copy global -> shared (cp.async, L2 only); with
// `valid` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `n` of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Rows [r0, r0 + R) of a contiguous (S, D) bf16 matrix into a [R][ld]
// shared-memory tile, 16-byte cp.async copies by the block's `threads`
// threads; rows past S are zero-filled. D % 8 == 0, src 16-byte aligned.
template <int R, int threads>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int S, int D, int ld) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < R * chunks; i += threads) {
    const int r = i / chunks, c = 8 * (i % chunks);
    const bool ok = r0 + r < S;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)(r0 + r) * D + c : src,
               ok);
  }
}

// ---- warpgroup products (K1, K4): wgmma ----
//
// wgmma.mma_async m64nNk16, bf16 -> float32, is issued by the four warps of
// a warpgroup (128 threads, warp index % 4 == 0 first) and runs
// asynchronously. A (64 x 16) comes from registers in the m16n8k16 A layout
// per warp (warp i of the group holds rows 16i..16i+15: `a` as for mma_bf16,
// so ldmatrix_x4 loads it) or, in wgmma_ss, from shared memory by a
// descriptor of the K-major layout B's describes; B (16 x N) comes from
// shared memory through a matrix descriptor, K-major or (wgmma_rs_t)
// MN-major; D (64 x N float32) stays in registers, N / 2 a thread:
// d[4j + e] is row 16i + gid + 8 (e / 2), column 8j + 2 tig + e % 2 (the
// m16n8 C layout, one 8-column tile per j).

// Descriptor of a K-major B tile under the 128-byte swizzle: N rows of 64
// bf16 (128 bytes) at `addr` (shared, 1024-byte aligned, 16-byte chunk c of
// row n stored at chunk c ^ (n % 8)); eight-row groups 1024 bytes apart.
// The k-th 16-deep step of the tile starts 32 * k bytes further.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Before the first wgmma that reads registers written since the last one.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most `n` of the warpgroup's committed groups are in flight.
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// Keep the compiler from moving reads of an accumulator across a wait.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
// Order this thread's generic-proxy writes to shared memory (cp.async
// included) before async-proxy reads of it (wgmma descriptors).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += a * B: one m64nNk16 product, N in {8, 64, 128, 192, 256}.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3"
      "}, {%4,%5,%6,%7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,"
      "%88,%89,%90,%91,%92,%93,%94,%95"
      "}, {%96,%97,%98,%99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,"
      "%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,"
      "%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,"
      "%120,%121,%122,%123,%124,%125,%126,%127"
      "}, {%128,%129,%130,%131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d = a * B (accumulate 0) or d += a * B (accumulate != 0): one m64nNk16
// product with A (64 x 16) from shared memory too, both by descriptor,
// N in {32, 64, 128}.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a,
                                         uint64_t desc_b, int accumulate);

// d += a * B with B read transposed: B (16 x N) is stored MN-major, its N
// columns contiguous (wgmma_desc_sw128_mn), N in {64, 128, 256}; a as for
// wgmma_rs.
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float* d, const uint32_t* a,
                                           uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float* d, const uint32_t* a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<128>(float* d, const uint32_t* a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<256>(float* d, const uint32_t* a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,"
      "%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,"
      "%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,"
      "%120,%121,%122,%123,%124,%125,%126,%127"
      "}, {%128,%129,%130,%131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Descriptor of an MN-major operand under the 128-byte swizzle: 16-deep
// k-steps of rows of 64 bf16 (128 bytes, N contiguous) at `addr` (shared,
// 1024-byte aligned), eight k-rows 1024 bytes apart (stride byte offset);
// each further 64 columns `lbo` bytes further (leading byte offset). The
// k-th step starts 2048 * k bytes further.
__device__ __forceinline__ uint64_t wgmma_desc_sw128_mn(uint32_t addr,
                                                        uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// ---- TMA and mbarriers ----
//
// An mbarrier is 8 bytes of shared memory. A TMA tiled load (one thread)
// copies a box of a tensor map into shared memory, fills what lies outside
// the tensor with zeros, and adds the box's bytes to the barrier's
// transaction count; a phase completes when its arrivals and its expected
// bytes are all in.

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// After every mbar_init, before any thread uses the barriers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` more of transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase of parity 1 as completed). A plain spin: a trap on a
// timeout here would cost the kernels their setmaxnreg register split
// (ptxas then spills and serializes the wgmma of K4's larger classes).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}
// The box of a 3-D tensor map at element coordinates (c0, c1, c2), c0 the
// innermost, into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The box of a 4-D tensor map at element coordinates (c0, c1, c2, c3), c0
// the innermost (negative or past the end: zero-filled), into shared memory
// at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static std::atomic<void*> fn{nullptr};
  void* f = fn.load(std::memory_order_acquire);
  if (f == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn.store(f, std::memory_order_release);
  }
  return reinterpret_cast<EncodeTiled>(f);
}

// A (BH, S, D) bf16 tensor as a 3-D tensor map (D innermost) read in boxes
// of 64 columns x `rows` rows of one head, 128-byte swizzled; reads past D,
// S or BH fill zeros. K4 (attention.cu) and K5 / K6 (attention_bwd.cu).
inline bool encode_map(CUtensorMap* map, const void* ptr, int BH, int S, int D,
                       int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Registers of the calling warpgroup (all four warps execute it): give
// some back to the pool (dec), or take more (inc); a multiple of 8 in
// [24, 256].
template <int n>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(n));
}
template <int n>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(n));
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads,
// whole warps: wait for all (bar_sync), or count in without waiting
// (bar_arrive).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Set a kernel attribute once per device, not before every launch: `state`
// is a function-local static of the kernel's launcher.
constexpr int kMaxDevices = 64;
struct SmemLimit {
  std::atomic<bool> raised[kMaxDevices];
};
inline cudaError_t set_attribute_once(SmemLimit& state, const void* kernel,
                                      cudaFuncAttribute attr, int value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && state.raised[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, attr, value);
  if (err == cudaSuccess && keep)
    state.raised[dev].store(true, std::memory_order_release);
  return err;
}

// Raise a kernel's dynamic shared-memory limit (above the 48 KB default);
// `bytes` is the most any launch asks.
inline cudaError_t raise_smem_limit(SmemLimit& state, const void* kernel,
                                    size_t bytes) {
  return set_attribute_once(state, kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(bytes));
}

// Multiprocessor count of the current device, read once per device.
inline cudaError_t sm_count(int* sms) {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && (*sms = known[dev].load(std::memory_order_acquire)) > 0)
    return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && keep)
    known[dev].store(*sms, std::memory_order_release);
  return err;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// ---- GroupNorm statistics (K2, and the first launch of K1) ----
//
// A map x (B, HW, C) is cut into channel blocks of `cb` channels (whole
// groups, a multiple of the channels one 16-byte load holds, >= 64 or 128
// bytes of a pixel) and each
// (batch element, channel block) slice into `splits` pixel ranges of `per`
// pixels, one thread block each. A block's threads form `rows` x `cols`: a
// thread owns `vec` neighbouring channels (one 16-byte load: 8 bf16 or 4
// float32, or 1 where C or the pointers do not allow it) and every rows-th
// pixel of its range, so a warp's loads are neighbouring channels of
// neighbouring pixels. Sums are float32 of v = pre_scale*x + pre_bias (per
// (b, c); identity for K2), taken in a fixed order at every level: a
// thread's pixels in order, the rows of a block in a fixed tree, the
// blocks of a slice in index order, the channels of a group in order. The
// group mean and rstd (one-pass variance clamped at 0) become per-channel
// mult = pre_scale*rstd*gamma and add = (pre_bias - mean)*rstd*gamma + beta,
// so the normalized value is x*mult + add.
//   K2 (groupnorm.cu): the blocks of a slice are one thread-block cluster
//     (splits = cluster size <= 16); they fold through distributed shared
//     memory and normalize their own ranges, kept in shared memory when the
//     slice fits the cluster.
//   K1's statistics (launch_gn_stats): blocks of a slice write their sums to
//     fixed slots of the workspace; the last block of the slice to finish
//     (a ticket counter, reset by that block) folds the slots in index order
//     and writes mult / add.
constexpr int kGnMaxChannels = 1024;
constexpr int kGnStatsMaxChannels = 2048;  // K1's statistics launch
constexpr int kGnThreads = 256;        // per block, when vec > 1
constexpr int kGnMinBlocksPerSm = 3;   // registers: __launch_bounds__
constexpr int kGnClusterRowBytes = 64;   // K2: a block's bytes of a pixel
constexpr int kGnStatsRowBytes = 128;    // K1 statistics: the same
constexpr int kGnMaxCluster = 16;      // non-portable cluster size on H100
constexpr int kGnChunkBytes = 64 << 10;  // K2: target bytes of x a block
constexpr int kGnMaxSmem = 232448;       // shared memory a block can use
constexpr int kGnStatsBlocksPerSm = 4;   // K1 statistics: blocks per SM
constexpr int kGnStatsMinPixels = 256;   // K1 statistics: pixels a block
constexpr int kGnRing = 8;  // K1 statistics: cp.async loads a thread keeps
                            // in flight (16-byte loads only)

struct GnPlan {
  int vec, cb, cols, rows, threads;  // channels and threads of a block
  int splits, per;                   // blocks of a slice, pixels of a block
  int resident;                      // K2: the slice stays in shared memory
  size_t smem;                       // dynamic shared memory of a block
};

// Channels of one 16-byte load, when C allows it.
inline int gn_vec(int C, int elem) {
  const int v = 16 / elem;
  return C % v == 0 ? v : 1;
}

// The smallest multiple of lcm(C / G, vec) that divides C and spans at
// least `row_bytes` of a pixel; C when none does.
inline int gn_block_channels(int C, int G, int elem, int row_bytes) {
  const int cg = C / G, vec = gn_vec(C, elem);
  int a = cg, b = vec;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  const int unit = cg / a * vec;
  for (int cb = unit; cb < C; cb += unit)
    if (C % cb == 0 && cb * elem >= row_bytes) return cb;
  return C;
}

// Float32 scratch of a block: the thread sums tree-reduced over rows
// ([2][rows][cb]), the slice's per-channel sums, then mult / add ([2][cb]),
// and the group mean / rstd ([2][cb / cg]).
inline size_t gn_scratch_bytes(const GnPlan& p, int cg) {
  return sizeof(float) *
         (2 * (size_t)p.rows * p.cb + 2 * (size_t)p.cb + 2 * (p.cb / cg));
}

// Geometry of a block; vec = 1 when `aligned` is false (x or y not 16-byte
// aligned). The channel blocks do not depend on it.
inline GnPlan gn_geometry(int C, int G, int elem, bool aligned,
                          int row_bytes) {
  GnPlan p{};
  p.cb = gn_block_channels(C, G, elem, row_bytes);
  p.vec = aligned ? gn_vec(C, elem) : 1;
  p.cols = p.cb / p.vec;
  p.rows = p.cols >= kGnThreads ? 1 : kGnThreads / p.cols;
  p.threads = p.cols * p.rows;
  return p;
}

// K2: channel blocks of >= 64 bytes a pixel (more clusters at small
// batch); the cluster of a slice has enough blocks that each holds about
// kGnChunkBytes of x and the card gets a block per SM, at most 16 and at
// most HW; resident when a block's range and scratch fit its shared memory.
// (tools/torch_gn_variants.py: a block per SM beats two on 8^2 and 16^2
// maps -- larger clusters cost more to launch and synchronize -- and ties
// elsewhere; 32 or 128 KB chunks and 128-byte rows gain nothing.)
inline GnPlan gn_cluster_plan(int B, int HW, int C, int G, int elem,
                              bool aligned, int sms) {
  GnPlan p = gn_geometry(C, G, elem, aligned, kGnClusterRowBytes);
  const long long clusters = (long long)B * (C / p.cb);
  const long long slice = (long long)HW * p.cb * elem;
  long long cs = (slice + kGnChunkBytes - 1) / kGnChunkBytes;
  const long long fill = (sms + clusters - 1) / clusters;
  if (cs < fill) cs = fill;
  if (cs > kGnMaxCluster) cs = kGnMaxCluster;
  if (cs > HW) cs = HW;
  p.splits = cs < 1 ? 1 : (int)cs;
  p.per = (HW + p.splits - 1) / p.splits;
  const size_t tile = ((size_t)p.per * p.cb * elem + 15) / 16 * 16;
  const size_t scratch = gn_scratch_bytes(p, C / G);
  p.resident = tile + scratch <= (size_t)kGnMaxSmem;
  p.smem = scratch + (p.resident ? tile : 0);
  return p;
}

// K1's statistics: channel blocks of >= 128 bytes a pixel (a warp reads
// whole 128-byte lines), ~kGnStatsBlocksPerSm blocks per SM over all
// slices, at least kGnStatsMinPixels pixels a block. With 16-byte loads a
// thread streams its pixels through kGnRing cp.async slots of shared
// memory, which the thread sums share with (`red`).
inline GnPlan gn_stats_plan(int B, int HW, int C, int G, int elem,
                            bool aligned, int sms) {
  GnPlan p = gn_geometry(C, G, elem, aligned, kGnStatsRowBytes);
  const long long slices = (long long)B * (C / p.cb);
  long long s = ((long long)kGnStatsBlocksPerSm * sms + slices - 1) / slices;
  const long long most = HW / kGnStatsMinPixels;
  if (s > most) s = most;
  p.splits = s < 1 ? 1 : (int)s;
  p.per = (HW + p.splits - 1) / p.splits;
  const size_t red = sizeof(float) * 2 * (size_t)p.rows * p.cb;
  const size_t ring = p.vec > 1 ? (size_t)kGnRing * p.threads * 16 : 0;
  p.smem = gn_scratch_bytes(p, C / G) + (ring > red ? ring - red : 0);
  return p;
}

// Whether the statistics kernels take (B, HW, C, G).
inline bool gn_takes(int B, int HW, int C, int G) {
  return B >= 1 && B <= 65535 && HW >= 1 && C >= 1 &&
         C <= kGnMaxChannels && G >= 1 && C % G == 0;
}

// Whether K1's statistics launch takes (B, HW, C, G) of `elem`-byte
// elements: up to kGnStatsMaxChannels channels (the concatenated inputs of
// a UNet's up path), where a block's channels fit one block of threads
// even one channel a thread.
inline bool gn_stats_takes(int B, int HW, int C, int G, int elem) {
  return B >= 1 && B <= 65535 && HW >= 1 && C >= 1 &&
         C <= kGnStatsMaxChannels && G >= 1 && C % G == 0 &&
         gn_block_channels(C, G, elem, kGnStatsRowBytes) <= kGnMaxChannels;
}

// Where the slots start in K1's statistics workspace: after mult and add,
// 16-byte aligned.
inline size_t gn_slots_offset(int B, int C) {
  return ((size_t)2 * B * C + 3) / 4 * 4;
}

// Floats of K1's statistics workspace: mult (B, C), add (B, C), then the
// slots of the blocks' sums (B, C / cb, splits, 2, cb) when splits > 1;
// -1 when the kernels do not take the shape or the device is unknown.
inline long long gn_workspace_floats(int B, int HW, int C, int G, int dtype) {
  if ((dtype != kF32 && dtype != kBF16) ||
      !gn_stats_takes(B, HW, C, G, dtype == kF32 ? 4 : 2))
    return -1;
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  const GnPlan p = gn_stats_plan(B, HW, C, G, dtype == kF32 ? 4 : 2, true,
                                 sms);
  return (long long)gn_slots_offset(B, C) +
         (p.splits > 1 ? 2LL * B * C * p.splits : 0);
}

// Where `add` starts in the workspace (`mult` starts at its beginning).
inline float* gn_add(float* workspace, int B, int C) {
  return workspace + (size_t)B * C;
}

// K1's statistics in one launch (groupnorm.cu): mult / add of
// pre_scale*x + pre_bias into the workspace. `tickets`: B*C int32 that are
// 0 before the launch and 0 again after it. With post_scale / post_shift
// ((B, C) float32, either may be null) the normalized value is scaled and
// shifted after the norm, (x*mult + add)*(1 + post_scale) + post_shift,
// folded into the same mult / add.
cudaError_t launch_gn_stats(const void* x, int dtype, const float* pre_scale,
                            const float* pre_bias, const float* gamma,
                            const float* beta, float* workspace,
                            int* tickets, int B, int HW, int C, int G,
                            float eps, cudaStream_t stream,
                            const float* post_scale = nullptr,
                            const float* post_shift = nullptr);

}  // namespace sr3
