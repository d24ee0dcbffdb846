// The bf16 tensor-core primitives of the hand-written sweeps (sa_mma.cuh
// and sa_fused.cu): mma.sync m16n8k16 bf16 with f32 accumulation, its
// ldmatrix loads, and bf16 rounding and packing. Fragments (g = lane / 4,
// t = lane % 4), each register two bf16 values, the lower column (or k)
// in the low half: A (16 x 16) a0 (row g, k 2t..), a1 (row g + 8), a2
// (row g, k 2t + 8..), a3 (row g + 8, k 2t + 8..); B (16 x 8) b0 (k 2t..,
// col g), b1 (k 2t + 8..); C c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row
// g + 8).
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Round to bf16 (nearest even), carried in f32: one cast point.
__device__ __forceinline__ float rb(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// Two values rounded to bf16 (nearest even) in one register, and back.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. Plain: register q holds row g, columns 2t, 2t + 1 of
// matrix q; transposed: rows 2t, 2t + 1 of column g.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

}  // namespace
