// Tensor-core tile machinery of the redesigned SA sweeps (sa_pair.cu:
// fwd_gram_pool, bwd_sweep2, bwd_sweep3; bwd_sweep1 uses the TMA staging).
// Products run as mma.sync m16n8k8 TF32 in the 3xTF32 split, which keeps
// f32 accuracy: each f32 operand a becomes hi = tf32(a) and lo = tf32(a -
// hi), and a product sums lo.hi' + hi.lo' + hi.hi' in f32 (the dropped
// lo.lo' term is ~2^-22 relative). Row tiles arrive by TMA bulk copies
// into a ring of stages, one mbarrier each.
//
// Layouts (floats):
//  - Row tiles: (TR, LDT) row-major, LDT = 72. A row-major fragment reads
//    a float2 at (row g, cols 2t, 2t+1) and a transposed fragment a float
//    at (row t, col g) (g = lane / 4, t = lane % 4): with LDT = 8 mod 32
//    both are free of bank conflicts. The row-major form pairs the mma's
//    k slots t and t + 4 with the columns 2t and 2t + 1 of each 8-wide k
//    step; the B operand below uses the same pairing.
//  - B operands B[k][n] (k < 64): k = 8 kb + 2 tt + j is stored at
//    [4 kb + tt][2 n + j] with row stride 2 n_cols + 8, so one float2 at
//    (row 4 kb + t, col 2 (n0 + g)) is the fragment (k = 8 kb + 2t, + 1).
//
// Row tiles arrive as TMA lands them, (TR, CW) unpadded, one bulk copy
// per tile; the CUDA-core row passes below copy them into padded tiles.
//
// Nothing here decides a ReLU mask: the masks come from the CUDA-core op
// chains of sa_tile.cuh (relu_affine, and h1_rows below with h1_tile's
// exact chain), bit for bit as in the forward.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>
#include "sa_tile.cuh"

namespace {

constexpr int NTM = 512;                // threads of a tensor-core sweep
constexpr int LDT = 72;                 // row-tile stride
constexpr int TILE_F = TR * LDT;        // floats of one row tile

__host__ __device__ constexpr int b_stride(int ncols) {
  return 2 * ncols + 8;
}

// -- TMA staging ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The stage's one arrival, expecting `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy writes to shared memory must be ordered before the async
// proxy (a bulk store) reads it.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// 1-D bulk copy global -> shared (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 1-D bulk copy shared -> global, in the issuing thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The issuing thread: wait until its bulk stores have read shared memory.
__device__ __forceinline__ void bulk_store_drain() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The same for all but its latest bulk store (a double-buffered source).
__device__ __forceinline__ void bulk_store_drain_prior() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

// -- 3xTF32 mma -------------------------------------------------------

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float a) {
  Split s;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(s.hi) : "f"(a));
  const float r = __fsub_rn(a, __uint_as_float(s.hi));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(s.lo) : "f"(r));
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

__device__ __forceinline__ void zero4(float c[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
}

// Raw (unsplit) fragment values, split at load by split_a.
struct RawA {
  float v[4];
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Row-major A from a (TR, LDT) tile: rows m0 + g (+8), k step kb.
__device__ __forceinline__ RawA raw_a_rows(const float* X, int m0, int kb,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int k = 8 * kb + 2 * t;
  const float2 u = ld2(X + (m0 + g) * LDT + k);
  const float2 w = ld2(X + (m0 + g + 8) * LDT + k);
  return RawA{{u.x, w.x, u.y, w.y}};
}

__device__ __forceinline__ FragA split_a(const RawA& r) {
  return FragA{{split(r.v[0]), split(r.v[1]), split(r.v[2]), split(r.v[3])}};
}

// An operand split once, ahead of its products: hi and lo arrays of the
// same layout (a (TR, LDT) tile, or a paired B layout).
struct SplitBuf {
  const float* hi;
  const float* lo;
};

__device__ __forceinline__ Split at(const SplitBuf& s, int i) {
  return Split{__float_as_uint(s.hi[i]), __float_as_uint(s.lo[i])};
}

__device__ __forceinline__ void at2(const SplitBuf& s, int i, Split& a,
                                    Split& b) {
  const float2 h = ld2(s.hi + i), l = ld2(s.lo + i);
  a = Split{__float_as_uint(h.x), __float_as_uint(l.x)};
  b = Split{__float_as_uint(h.y), __float_as_uint(l.y)};
}

// hi + lo of a transposed A fragment's rows t and t + 4 of column m0 + g
// (half 0) or m0 + g + 8 (half 1): a lane's share of a column sum.
__device__ __forceinline__ float col_pair(const FragA& a, int half) {
  return (__uint_as_float(a.v[half].hi) + __uint_as_float(a.v[half].lo)) +
         (__uint_as_float(a.v[half + 2].hi) +
          __uint_as_float(a.v[half + 2].lo));
}

// Row-major A from a split tile (as raw_a_rows).
__device__ __forceinline__ FragA frag_a_rows(const SplitBuf& X, int m0,
                                             int kb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int k = 8 * kb + 2 * t;
  FragA a;
  at2(X, (m0 + g) * LDT + k, a.v[0], a.v[2]);
  at2(X, (m0 + g + 8) * LDT + k, a.v[1], a.v[3]);
  return a;
}

// Transposed A from a split tile: A[m][k] = X[k][m], m = m0 + g (+8),
// k = 8 kb + t (+4) — the rows of the tile are the reduction.
__device__ __forceinline__ FragA frag_a_cols(const SplitBuf& X, int m0,
                                             int kb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int i = (8 * kb + t) * LDT + m0 + g;
  return FragA{{at(X, i), at(X, i + 8), at(X, i + 4 * LDT),
                at(X, i + 4 * LDT + 8)}};
}

// B[k][n] = X[k][n] of a split tile: k = 8 kb + t (+4), n = n0 + g.
__device__ __forceinline__ FragB frag_b_rows(const SplitBuf& X, int n0,
                                             int kb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int i = (8 * kb + t) * LDT + n0 + g;
  return FragB{{at(X, i), at(X, i + 4 * LDT)}};
}

// B from the split paired layout (stride ld = b_stride(n_cols)).
__device__ __forceinline__ FragB frag_b_paired(const SplitBuf& Bs, int ld,
                                               int n0, int kb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  FragB b;
  at2(Bs, (4 * kb + t) * ld + 2 * (n0 + g), b.v[0], b.v[1]);
  return b;
}

__device__ __forceinline__ void copy_block(float* dst, const float* src,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += NTM) dst[i] = src[i];
}

// Block: (hi, lo) paired layouts <- the split of B[k][n] = src[k * sk +
// n * sn] (times scale[k], rounded, where scale is given), k < 64,
// n < ncols.
__device__ __forceinline__ void load_b_split(float* hi, float* lo,
                                             const float* src, int ncols,
                                             int sk, int sn,
                                             const float* scale = nullptr) {
  const int ld = b_stride(ncols);
  for (int e = threadIdx.x; e < CW * ncols; e += NTM) {
    const int k = e / ncols, n = e % ncols;
    const int i = (4 * (k >> 3) + ((k & 7) >> 1)) * ld + 2 * n + (k & 1);
    const float b = src[k * sk + n * sn];
    const Split s = split(scale ? __fmul_rn(b, scale[k]) : b);
    hi[i] = __uint_as_float(s.hi);
    lo[i] = __uint_as_float(s.lo);
  }
}

// -- CUDA-core row passes (bit-exact op chains) -----------------------
// Sources are staged tiles as TMA lands them: (TR, CW) unpadded.

__device__ __forceinline__ float4 relu4(float4 v, const float* mul,
                                        const float* shift, int c) {
  v.x = relu_affine(v.x, mul[c], shift[c]);
  v.y = relu_affine(v.y, mul[c + 1], shift[c + 1]);
  v.z = relu_affine(v.z, mul[c + 2], shift[c + 2]);
  v.w = relu_affine(v.w, mul[c + 3], shift[c + 3]);
  return v;
}

// Four values of a row tile -> their split, at hi/lo + offset.
__device__ __forceinline__ void store_split4(float* hi, float* lo, int off,
                                             const float4& v) {
  const Split a = split(v.x), b = split(v.y), c = split(v.z), d = split(v.w);
  *reinterpret_cast<float4*>(hi + off) =
      make_float4(__uint_as_float(a.hi), __uint_as_float(b.hi),
                  __uint_as_float(c.hi), __uint_as_float(d.hi));
  *reinterpret_cast<float4*>(lo + off) =
      make_float4(__uint_as_float(a.lo), __uint_as_float(b.lo),
                  __uint_as_float(c.lo), __uint_as_float(d.lo));
}

// (TR, LDT) tile <- relu(p * mul + shift) of a staged tile of p.
__device__ __forceinline__ void relu_rows(const float* S, const float* mul,
                                          const float* shift, float* T) {
  for (int e = threadIdx.x; e < TR * CW / 4; e += NTM) {
    const int r = e >> 4, c = (e & 15) * 4;
    const float4 v = *reinterpret_cast<const float4*>(S + r * CW + c);
    *reinterpret_cast<float4*>(T + r * LDT + c) = relu4(v, mul, shift, c);
  }
}

// Split (TR, LDT) tiles hi/lo <- relu(p * mul + shift) of a staged tile.
__device__ __forceinline__ void relu_split_rows(const float* S,
                                                const float* mul,
                                                const float* shift,
                                                float* hi, float* lo) {
  for (int e = threadIdx.x; e < TR * CW / 4; e += NTM) {
    const int r = e >> 4, c = (e & 15) * 4;
    const float4 v = *reinterpret_cast<const float4*>(S + r * CW + c);
    store_split4(hi, lo, r * LDT + c, relu4(v, mul, shift, c));
  }
}

// h1 = relu((x W1 + b1) * mul1 + shift1) for one tile, from xs staged
// channel-major (xs[c * TR + r]): its split into (TR, LDT) tiles hi/lo,
// and its ReLU mask (h1 > 0) as bytes, mask[r * CW + c]. vec1 = [b1 |
// mul1 | shift1]. The op chain is h1_tile's (sa_tile.cuh), so the masks
// are the forward's. Thread tid of nth (a multiple of 16) takes rows
// tid / 16, + nth / 16, ...
__device__ __forceinline__ void h1_rows(const float* xs, int C0,
                                        const float* W1s, const float* vec1,
                                        float* hi, float* lo, uint8_t* mask,
                                        int tid, int nth) {
  const int c = (tid & 15) * 4;
  const float4 b1 = *reinterpret_cast<const float4*>(vec1 + c);
  const float4 mul = *reinterpret_cast<const float4*>(vec1 + CW + c);
  const float4 sh = *reinterpret_cast<const float4*>(vec1 + 2 * CW + c);
  float4 w[C0MAX - 1];                  // this thread's columns of W1
#pragma unroll
  for (int k = 0; k < C0MAX - 1; ++k)
    if (k < C0) w[k] = *reinterpret_cast<const float4*>(W1s + k * CW + c);
  for (int r = tid >> 4; r < TR; r += nth / 16) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < C0MAX - 1; ++k) {
      if (k >= C0) break;
      const float xv = xs[k * TR + r];
      a.x = __fadd_rn(a.x, __fmul_rn(xv, w[k].x));
      a.y = __fadd_rn(a.y, __fmul_rn(xv, w[k].y));
      a.z = __fadd_rn(a.z, __fmul_rn(xv, w[k].z));
      a.w = __fadd_rn(a.w, __fmul_rn(xv, w[k].w));
    }
    float4 h;
    h.x = relu_affine(__fadd_rn(a.x, b1.x), mul.x, sh.x);
    h.y = relu_affine(__fadd_rn(a.y, b1.y), mul.y, sh.y);
    h.z = relu_affine(__fadd_rn(a.z, b1.z), mul.z, sh.z);
    h.w = relu_affine(__fadd_rn(a.w, b1.w), mul.w, sh.w);
    store_split4(hi, lo, r * LDT + c, h);
    *reinterpret_cast<uint32_t*>(mask + r * CW + c) =
        (h.x > 0.f ? 1u : 0u) | (h.y > 0.f ? 1u << 8 : 0u) |
        (h.z > 0.f ? 1u << 16 : 0u) | (h.w > 0.f ? 1u << 24 : 0u);
  }
}

// Sum over the lanes of one t group (lanes 4g .. 4g + 3): a column sum
// whose rows were spread over t.
__device__ __forceinline__ double sum_over_t(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

}  // namespace
