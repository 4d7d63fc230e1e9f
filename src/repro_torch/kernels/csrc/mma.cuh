// Tensor-core tile helpers shared by the bf16 kernels of the PyTorch port
// (flash_attention.cu, ssd_chunk.cu), sm_90a.
//
// The products run as warp-wide mma.sync.m16n8k16 bf16 -> f32 with
// operands fed by ldmatrix from shared memory, and tiles arrive in shared
// memory through cp.async.  Fragment layout of m16n8k16 (lane = 4*g + t):
//   A 16x16: a0 = (row g,   cols 2t, 2t+1), a1 = (row g+8, cols 2t, 2t+1),
//            a2 = (row g,   cols 2t+8, +9), a3 = (row g+8, cols 2t+8, +9);
//   B 16x8:  b0 = (k 2t, 2t+1; col g),      b1 = (k 2t+8, 2t+9; col g);
//   C 16x8:  c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, same).
// Two adjacent C tiles (16 columns) of f32 are therefore, once rounded to
// bf16 pairs, the A fragment of the next product (as in FlashAttention-2).
// In a pair the lower column sits in the low 16 bits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with pred false the 16 bytes
// are zero-filled and nothing is read (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously (through L1), for f32 rows
// whose starts are not 16-byte aligned; with pred false the 4 bytes are
// zero-filled and nothing is read (src must still be a valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i of every lane receives (row lane/4, cols 2(lane%4), +1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, transposed: register i receives (rows 2(lane%4), +1; col lane/4)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a . b on the tensor cores, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to nearest-even bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// x = hi + lo + r with hi, lo bf16 and |r| <= 2^-17 |x|: an f32 factor
// carried into a bf16 product as two terms keeps 16 significant bits
__device__ __forceinline__ void split_bf16(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = x - hi;
}

}  // namespace repro_mma
