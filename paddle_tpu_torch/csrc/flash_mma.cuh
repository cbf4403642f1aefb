// Tensor-core tile primitives for the flash kernels (bf16 and fp16):
// cp.async copies into padded shared-memory tiles, ldmatrix fragment
// loads, the m16n8k16 mma.sync product, the hi + lo split of an fp32
// operand into two values of the input type, and reductions over the quad
// of lanes that holds one accumulator row.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16/.f16 inputs): lane l
// has g = l / 4 and t = l % 4. An fp32 accumulator tile of 16 x 8 holds
// (row g, cols 2t, 2t+1) in c[0], c[1] and (row g + 8, same cols) in
// c[2], c[3]. So the accumulators of two neighbouring n-tiles 2j, 2j+1
// are, element for element, the A fragment of k-step j of a following
// product (pack c[0..1], c[2..3] of tile 2j, then of tile 2j+1): a score
// tile goes from the accumulators into P.V without shared memory.
#pragma once


#include "flash_common.cuh"

// a block of 4 warps; each warp owns 16 rows of the block's row tile
constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
// shared-memory tiles are [rows][D + kTcPad]: the 16-byte pad shifts each
// row by 4 banks, so the 8 row addresses of one ldmatrix hit 8 distinct
// bank groups (no conflicts) and every row stays 16-byte aligned
constexpr int kTcPad = 8;
// a 64-row tile: the flash forwards' and dq's q rows, and every key tile
constexpr int kTcBlk = 64;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !ok (src must still be a
// valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a tensor whose row r holds D contiguous
// elements at src + r * stride (stride a multiple of 8, src 16-byte
// aligned) into a padded tile; rows at or past n_rows are zero-filled
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_rows(T* tile, const T* __restrict__ src, long long stride,
                                          int row0, int n_rows, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CH % kTcThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < ROWS * CH / kTcThreads; ++n) {
    const int i = tid + n * kTcThreads;
    const int r = i / CH, c = i - r * CH;
    const bool ok = row0 + r < n_rows;
    cp_async16(tile + r * (D + kTcPad) + c * 8,
               ok ? src + (long long)(row0 + r) * stride + c * 8 : src, ok);
  }
}

// rows [row0, row0 + ROWS) of a [*, D] row-major tensor
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(T* tile, const T* __restrict__ src, int row0,
                                          int n_rows, int tid) {
  load_rows<T, ROWS, D>(tile, src, D, row0, n_rows, tid);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Addresses of the x4 loads of a tile with row stride LD (elements), for
// lane l. A operand (m16 x k16) at (m0, k0) of a row-major [m][k] tile:
// registers a0..a3 of the mma.
template <int LD, typename T>
__device__ __forceinline__ const T* frag_a(const T* tile, int m0, int k0, int lane) {
  return tile + (m0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8;
}
// B operands of two n-tiles (n16 x k16) at (n0, k0) of a [n][k] tile
// (plain ldmatrix): {b0, b1} of n-tile n0 then of n-tile n0 + 8
template <int LD, typename T>
__device__ __forceinline__ const T* frag_b_nk(const T* tile, int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8;
}
// B operands of two n-tiles at (k0, n0) of a [k][n] tile (ldmatrix.trans)
template <int LD, typename T>
__device__ __forceinline__ const T* frag_b_kn(const T* tile, int k0, int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8;
}

// d += a * b, fp32 accumulate, exact products of the 16-bit inputs
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two 16-bit values of T in one register, x in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  __half2 v = __floats2half2_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t r);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t r) {
  return __half22float2(*reinterpret_cast<__half2*>(&r));
}

// fp32 (x, y) as hi + lo, both in T: hi = T(v), lo = T(v - hi). The pair
// carries 16 (bf16) or 22 (fp16) significant bits, so a product against
// hi and lo summed in fp32 is within ~2^-17 of the fp32 operand's product
// (a single rounding to bf16 is 2^-9).
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack2<T>(x, y);
  const float2 h = unpack2<T>(hi);
  lo = pack2<T>(x - h.x, y - h.y);
}

// The A fragments (hi and lo) of k-step j from accumulator n-tiles 2j, 2j+1
template <typename T>
__device__ __forceinline__ void acc_to_a(const float (&c0)[4], const float (&c1)[4],
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2<T>(c0[0], c0[1], hi[0], lo[0]);
  split2<T>(c0[2], c0[3], hi[1], lo[1]);
  split2<T>(c1[0], c1[1], hi[2], lo[2]);
  split2<T>(c1[2], c1[3], hi[3], lo[3]);
}

// max and sum over the 4 lanes (t = 0..3) that hold one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
