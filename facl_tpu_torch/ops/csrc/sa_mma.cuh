// Tensor-core tile machinery of the redesigned SA sweeps (sa_pair.cu:
// fwd_layer12, fwd_gram_pool, bwd_sweep2, bwd_sweep3 and the bf16 forms of
// all five sweeps; the f32 bwd_sweep1 uses the TMA staging; sa_2sweep.cu:
// B8a, bwd2_sweep1, at both dtypes).
// Products run as mma.sync m16n8k8 TF32 in the 3xTF32 split, which keeps
// f32-level accuracy: each f32 operand a becomes hi = tf32(a) and lo =
// tf32(a - hi), and a product sums lo.hi' + hi.lo' + hi.hi' in f32 (the
// dropped lo.lo' term is ~2^-22 relative). fwd_layer12 uses 6xTF32
// (below): exact operands, more accurate than f32. Row tiles arrive by
// TMA bulk copies into a ring of stages, one mbarrier each.
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
//
// bf16: the bf16 sweeps (their own kernels, sa_pair.cu) store the row
// tensors (x, p2, q3, mq) as __nv_bfloat16 and run their products on the
// bf16 tensor cores (bf16_mma.cuh's primitives and the helpers at the end
// of this file). Operands are
// rounded to bf16 (rb, pack_bf16) where the TPU kernels cast them, and
// results where they are cast or stored (ops/sa_pair.py's bf16 twins
// list the cast points); the ReLU masks are decided on bf16-rounded
// values. Row, rb_if, relu_affine_p and h1_of carry the row type of
// sa_2sweep.cu's templates.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include "bf16_mma.cuh"
#include "sa_tile.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int NTM = 512;                // threads of a tensor-core sweep
constexpr int LDT = 72;                 // row-tile stride
constexpr int TILE_F = TR * LDT;        // floats of one row tile

__host__ __device__ constexpr int b_stride(int ncols) {
  return 2 * ncols + 8;
}

// -- TMA staging ------------------------------------------------------

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

// -- 3xTF32 mma: Split, split, mma_tf32, FragA, FragB, mma3 in
// tf32_mma.cuh ---------------------------------------------------------

__device__ __forceinline__ void zero4(float c[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
}

// -- bf16 instantiations ---------------------------------------------

template <bool BF>
struct Row {
  using T = float;
};
template <>
struct Row<true> {
  using T = __nv_bfloat16;
};

// The halves of a packed pair to keep: bit 0 the low, bit 1 the high.
__device__ __forceinline__ uint32_t keep_halves(uint32_t bits) {
  return ((bits & 1u) ? 0x0000ffffu : 0u) | ((bits & 2u) ? 0xffff0000u : 0u);
}

// relu of a packed pair u of bf16 values (unpacked: f), and its mask bits:
// a half is kept where its value is > 0, else +0.
__device__ __forceinline__ uint32_t relu_packed(uint32_t u, float2& f,
                                                uint32_t& bits) {
  f = unpack_bf16(u);
  bits = (f.x > 0.f ? 1u : 0u) | (f.y > 0.f ? 2u : 0u);
  return u & keep_halves(bits);
}

template <bool BF>
__device__ __forceinline__ float rb_if(float a) {
  if constexpr (BF) return rb(a);
  return a;
}

__device__ __forceinline__ float to_f(float a) { return a; }
__device__ __forceinline__ float to_f(__nv_bfloat16 a) {
  return __bfloat162float(a);
}

// Two consecutive values of an f32 row stored (8-byte aligned).
__device__ __forceinline__ void st2r(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// relu(p * mul + shift), rounded to bf16 before the ReLU at BF (the TPU
// kernels' _h_from_p).
template <bool BF>
__device__ __forceinline__ float relu_affine_p(float p, float mul,
                                               float shift) {
  if constexpr (BF)
    return fmaxf(rb(__fadd_rn(__fmul_rn(p, mul), shift)), 0.0f);
  return relu_affine(p, mul, shift);
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

// -- 6xTF32: exact operands ------------------------------------------
// An f32 value is exactly hi + mid + lo in TF32 (11 + 11 + at most 2
// significant bits: a - hi and (a - hi) - mid are exact in f32). A product
// keeps every term down to 2^-22 of a b (lo.hi', hi.lo', mid.mid', then
// mid.hi', hi.mid', hi.hi'; the dropped ones are below 2^-33), so it is
// more accurate than an f32 product, where 3xTF32 is off by up to 2^-21
// (it drops mid.mid' and each operand's third piece). For outputs that
// feed a ReLU decision made elsewhere (B2a's p2).
struct Split3 {
  uint32_t v[3];
};

__device__ __forceinline__ Split3 split3(float a) {
  Split3 s;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(s.v[0]) : "f"(a));
  const float r = __fsub_rn(a, __uint_as_float(s.v[0]));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(s.v[1]) : "f"(r));
  s.v[2] = __float_as_uint(__fsub_rn(r, __uint_as_float(s.v[1])));
  return s;
}

// A (16 x 8) and B (8 x 8) fragments in three pieces: v[piece][register].
struct FragA3 {
  uint32_t v[3][4];
};
struct FragB3 {
  uint32_t v[3][2];
};

__device__ __forceinline__ void mma6(float c[4], const FragA3& a,
                                     const FragB3& b) {
  const int order[6][2] = {{2, 0}, {0, 2}, {1, 1}, {1, 0}, {0, 1}, {0, 0}};
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const uint32_t* x = a.v[order[q][0]];
    const uint32_t* y = b.v[order[q][1]];
    mma_tf32(c, x[0], x[1], x[2], x[3], y[0], y[1]);
  }
}

// Block: three paired layouts <- the pieces of B[k][n] = src[k * sk + n *
// sn], k < 64, n < ncols (as load_b_split).
__device__ __forceinline__ void load_b_split3(float* const p[3],
                                              const float* src, int ncols,
                                              int sk, int sn) {
  const int ld = b_stride(ncols);
  for (int e = threadIdx.x; e < CW * ncols; e += NTM) {
    const int k = e / ncols, n = e % ncols;
    const int i = (4 * (k >> 3) + ((k & 7) >> 1)) * ld + 2 * n + (k & 1);
    const Split3 s = split3(src[k * sk + n * sn]);
#pragma unroll
    for (int q = 0; q < 3; ++q) p[q][i] = __uint_as_float(s.v[q]);
  }
}

// The B fragment of n-tile n0, step kb from the three paired layouts.
__device__ __forceinline__ FragB3 frag_b3_paired(const float* const p[3],
                                                 int ld, int n0, int kb,
                                                 int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int i = (4 * kb + t) * ld + 2 * (n0 + g);
  FragB3 b;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float2 u = ld2(p[q] + i);
    b.v[q][0] = __float_as_uint(u.x);
    b.v[q][1] = __float_as_uint(u.y);
  }
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

// h1 from a = x W1 (summed in k order): h1_tile's chain relu((a + b1)
// mul1 + shift1); at BF, with W1 and b1 rounded to bf16 (by the caller),
// relu(bf16((bf16(a) + b1) mul1 + shift1)) (the TPU kernel's p1 sum is
// not rounded: ops/sa_pair.py, _h1_bf16).
template <bool BF>
__device__ __forceinline__ float h1_of(float a, float b1, float mul,
                                       float shift) {
  return relu_affine_p<BF>(__fadd_rn(rb_if<BF>(a), b1), mul, shift);
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
    h.x = h1_of<false>(a.x, b1.x, mul.x, sh.x);
    h.y = h1_of<false>(a.y, b1.y, mul.y, sh.y);
    h.z = h1_of<false>(a.z, b1.z, mul.z, sh.z);
    h.w = h1_of<false>(a.w, b1.w, mul.w, sh.w);
    store_split4(hi, lo, r * LDT + c, h);
    *reinterpret_cast<uint32_t*>(mask + r * CW + c) =
        (h.x > 0.f ? 1u : 0u) | (h.y > 0.f ? 1u << 8 : 0u) |
        (h.z > 0.f ? 1u << 16 : 0u) | (h.w > 0.f ? 1u << 24 : 0u);
  }
}

// The bf16 chain of h1 (h1_of<true>) for two rows (x values xa, xb) at
// columns col, col + 1 up to the ReLU: bf16((bf16(x W1) + b1) mul1 +
// shift1) as packed pairs pa (row a) and pb (row b), each rounding done
// for two values at once (cvt.rn.bf16x2 rounds as cvt.rn.bf16 does, at
// about three times its rate on this card). W1 and b1 rounded by the
// caller; vec1 = [b1 | mul1 | shift1].
__device__ __forceinline__ void h1_pre_bf16(const float (&xa)[C0MAX - 1],
                                            const float (&xb)[C0MAX - 1],
                                            int C0, const float* W1s,
                                            const float* vec1, int col,
                                            uint32_t& pa, uint32_t& pb) {
  float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < C0MAX - 1; ++k) {
    if (k >= C0) break;
    const float2 w = ld2(W1s + k * CW + col);
    a.x = __fadd_rn(a.x, __fmul_rn(xa[k], w.x));
    a.y = __fadd_rn(a.y, __fmul_rn(xa[k], w.y));
    b.x = __fadd_rn(b.x, __fmul_rn(xb[k], w.x));
    b.y = __fadd_rn(b.y, __fmul_rn(xb[k], w.y));
  }
  const float2 b1 = ld2(vec1 + col), mul = ld2(vec1 + CW + col);
  const float2 sh = ld2(vec1 + 2 * CW + col);
  const float2 ra = unpack_bf16(pack_bf16(a.x, a.y));
  const float2 rv = unpack_bf16(pack_bf16(b.x, b.y));
  pa = pack_bf16(__fadd_rn(__fmul_rn(__fadd_rn(ra.x, b1.x), mul.x), sh.x),
                 __fadd_rn(__fmul_rn(__fadd_rn(ra.y, b1.y), mul.y), sh.y));
  pb = pack_bf16(__fadd_rn(__fmul_rn(__fadd_rn(rv.x, b1.x), mul.x), sh.x),
                 __fadd_rn(__fmul_rn(__fadd_rn(rv.y, b1.y), mul.y), sh.y));
}

// h1 of two rows (x values xa, xb) at columns col, col + 1, in registers:
// ha for row a, hb for row b. vec1 = [b1 | mul1 | shift1]. The op chain is
// h1_tile's (and h1_rows'), so the masks are the ones every sweep that
// recomputes h1 gets. BF: the bf16 chain (h1_of), by h1_pre_bf16.
template <bool BF = false>
__device__ __forceinline__ void h1_pair(const float (&xa)[C0MAX - 1],
                                        const float (&xb)[C0MAX - 1],
                                        int C0, const float* W1s,
                                        const float* vec1, int col,
                                        float2& ha, float2& hb) {
  if constexpr (BF) {
    uint32_t ua, ub;
    h1_pre_bf16(xa, xb, C0, W1s, vec1, col, ua, ub);
    const float2 pa = unpack_bf16(ua), pb = unpack_bf16(ub);
    ha = make_float2(fmaxf(pa.x, 0.0f), fmaxf(pa.y, 0.0f));
    hb = make_float2(fmaxf(pb.x, 0.0f), fmaxf(pb.y, 0.0f));
    return;
  }
  float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < C0MAX - 1; ++k) {
    if (k >= C0) break;
    const float2 w = ld2(W1s + k * CW + col);
    a.x = __fadd_rn(a.x, __fmul_rn(xa[k], w.x));
    a.y = __fadd_rn(a.y, __fmul_rn(xa[k], w.y));
    b.x = __fadd_rn(b.x, __fmul_rn(xb[k], w.x));
    b.y = __fadd_rn(b.y, __fmul_rn(xb[k], w.y));
  }
  const float2 b1 = ld2(vec1 + col), mul = ld2(vec1 + CW + col);
  const float2 sh = ld2(vec1 + 2 * CW + col);
  ha.x = h1_of<BF>(a.x, b1.x, mul.x, sh.x);
  ha.y = h1_of<BF>(a.y, b1.y, mul.y, sh.y);
  hb.x = h1_of<BF>(b.x, b1.x, mul.x, sh.x);
  hb.y = h1_of<BF>(b.y, b1.y, mul.y, sh.y);
}

// Sum over the lanes of one t group (lanes 4g .. 4g + 3): a column sum
// whose rows were spread over t.
__device__ __forceinline__ double sum_over_t(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// -- bf16 tensor cores (the bf16 forms of B2b, B3a, B3b and B3c) -------
// Operands are bf16 in shared memory, tiles (rows, LDB) row-major with a
// stride of 72 values (144 bytes): the eight 16-byte rows that one
// ldmatrix phase reads fall in eight different bank groups. Products run
// as mma.sync m16n8k16 bf16 with f32 accumulation (products of two bf16
// values are exact; the tensor cores sum each k16 step into the f32
// accumulators). Fragments (g = lane / 4, t = lane % 4), each register
// two bf16 values, the lower column (or k) in the low half:
//   A (16 x 16): a0 (row g, k 2t..), a1 (row g + 8, k 2t..),
//                a2 (row g, k 2t + 8..), a3 (row g + 8, k 2t + 8..);
//   B (16 x 8):  b0 (k 2t.., col g), b1 (k 2t + 8.., col g);
//   C (16 x 8):  c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8).
// C of two neighbouring n-tiles is the A fragment of one k16 step.
constexpr int LDB = 72;

// Four 8 x 8 bf16 matrices stored: lane l gives the address of row l % 8
// of matrix l / 8, register q holds row g, columns 2t, 2t + 1 of matrix q
// (the C fragment's layout).
__device__ __forceinline__ void stsm4(void* p, const uint32_t r[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
          smem_addr(p)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// The A fragment of rows m0.., k step k0.. of a (rows, LDB) tile X[m][k].
__device__ __forceinline__ const __nv_bfloat16* a_rows_at(
    const __nv_bfloat16* X, int m0, int k0, int lane) {
  return X + (m0 + (lane & 15)) * LDB + k0 + ((lane >> 4) << 3);
}
// The A fragment of A[m][k] = X[k][m] (transposed load): the tile's rows
// are the reduction. (LDX: a tile of another stride.)
template <int LDX = LDB>
__device__ __forceinline__ const __nv_bfloat16* a_cols_at(
    const __nv_bfloat16* X, int m0, int k0, int lane) {
  return X + (k0 + (lane & 7) + ((lane >> 4) << 3)) * LDX + m0 +
         (((lane >> 3) & 1) << 3);
}
// B fragments of two n-tiles n0.., n0 + 8.. (registers b0, b1, b0', b1')
// from X[k][n] (transposed load) ...
__device__ __forceinline__ const __nv_bfloat16* b_rows_at(
    const __nv_bfloat16* X, int n0, int k0, int lane) {
  return X + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LDB + n0 +
         ((lane >> 4) << 3);
}
// ... or from X[n][k] (plain load).
template <int LDX = LDB>
__device__ __forceinline__ const __nv_bfloat16* b_cols_at(
    const __nv_bfloat16* X, int n0, int k0, int lane) {
  return X + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LDX + k0 +
         (((lane >> 3) & 1) << 3);
}

// h2 = relu(bf16(p2 mul2 + shift2)) of a staged (TR, CW) bf16 tile S into
// the (TR, LDB) tile H, eight values a step (v2 = [mul2 | shift2]; every
// rounding two values at once); thread tid of nth.
__device__ __forceinline__ void relu_rows_bf16(const __nv_bfloat16* S,
                                               const float* v2,
                                               __nv_bfloat16* H, int tid,
                                               int nth) {
  for (int e = tid; e < TR * CW / 8; e += nth) {
    const int r = e >> 3, c = (e & 7) << 3;
    const uint4 u = *reinterpret_cast<const uint4*>(S + r * CW + c);
    const uint32_t in[4] = {u.x, u.y, u.z, u.w};
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = unpack_bf16(in[j]);
      const int cc = c + 2 * j;
      float2 f;
      uint32_t bits;
      o[j] = relu_packed(
          pack_bf16(__fadd_rn(__fmul_rn(p.x, v2[cc]), v2[CW + cc]),
                    __fadd_rn(__fmul_rn(p.y, v2[cc + 1]), v2[CW + cc + 1])),
          f, bits);
    }
    *reinterpret_cast<uint4*>(H + r * LDB + c) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// 16-byte asynchronous copies global -> shared (cp.async), each thread's
// copies in groups it commits and waits for.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace
