// The 3xTF32 tensor-core primitives of the f32 sweeps (sa_mma.cuh's B2b,
// B3b and B3c; sa_2sweep.cu's B8a; sa_fused.cu's B9): mma.sync m16n8k8 TF32 with f32
// accumulation, each f32 operand a split into hi = tf32(a) and lo =
// tf32(a - hi), each rounded to nearest (split), a product summed as
// lo.hi' + hi.lo' + hi.hi' in f32 (the dropped lo.lo' term is ~2^-22
// relative). Fragments (g = lane / 4,
// t = lane % 4): A (16 x 8) a0 (row g, k t), a1 (row g + 8, k t), a2 (row
// g, k t + 4), a3 (row g + 8, k t + 4); B (8 x 8) b0 (k t, col g), b1 (k
// t + 4, col g); C c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Split {
  uint32_t hi, lo;
};

// hi and lo rounded as cvt.rna.tf32.f32 rounds, on the integer pipe: half
// a TF32 ulp (bit 12) added to the magnitude's bits, then the low 13 bits
// cleared, rounds to nearest with ties away from zero, bit-identical to
// cvt.rna for finite values (tests/test_torch_tf32x3.py::tf32 is the same
// arithmetic) and faster in B9's f32 sweeps, whose operands are split as
// they load (PERF.md, chip_ablate.py b9_f32).
__device__ __forceinline__ Split split(float a) {
  Split s;
  s.hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  const float r = __fsub_rn(a, __uint_as_float(s.hi));
  s.lo = (__float_as_uint(r) + 0x1000u) & 0xffffe000u;
  return s;
}

__device__ __forceinline__ void mma_tf32(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A (16 x 8) and B (8 x 8) fragments, split.
struct FragA {
  Split v[4];
};
struct FragB {
  Split v[2];
};

// c += a b in 3xTF32: the two small products first, then hi.hi'.
__device__ __forceinline__ void mma3(float c[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.v[0].lo, a.v[1].lo, a.v[2].lo, a.v[3].lo, b.v[0].hi,
           b.v[1].hi);
  mma_tf32(c, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].lo,
           b.v[1].lo);
  mma_tf32(c, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].hi,
           b.v[1].hi);
}

// c += a b for one k8 step in 3xTF32: the step summed on its own (mma3
// from 0), then added to c in f32, round to nearest. The tensor cores'
// own adds truncate; chained over a whole product (3 K / 8 adds), their
// bias took B9's dx to 2.8x the twin's distance from float64 on an H100
// (phase 2's SA chain bar is 2x); step by step, the adds across steps
// round as the k-order chain's do (B9, sa_fused.cu; B8a, sa_2sweep.cu).
__device__ __forceinline__ void step3(float c[4], const FragA& a,
                                      const FragB& b) {
  float st[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(st, a, b);
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = __fadd_rn(c[q], st[q]);
}

}  // namespace
