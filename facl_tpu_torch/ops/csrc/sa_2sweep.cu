// B6, B7, B8: the two-sweep SA training paths — [Dense -> BN(train) ->
// ReLU] x3 (C0 -> 64 -> 64 -> 256) + max-pool over K.
//
// Replaces the TPU kernels of facl_tpu/ops/pallas/:
//   B7 sa_fwd.py::sa_forward_pallas (:148), sa_impl="hybrid2" (its layer
//     sweep, _make_layer_sweep :65, pallas_call :189, is B7a in
//     sa_layer.cu)
//     fwd_gram    <- _make_gram_sweep   (:97, pallas_call :219)
//     fwd_pool    <- _make_pool_sweep   (:117, pallas_call :242)
//   B8 sa_bwd.py::sa_backward_pallas (:232), sa_impl="hybrid"/"hybrid2"
//     bwd2_sweep1 <- _make_sweep1_kernel (:101, pallas_call :275)
//     bwd2_sweep2 <- _make_sweep2_kernel (:140, pallas_call :298), h1 from
//                    the stored p1
//   B6 sa_pair.py::sa_backward_pair, slim=False (:711), sa_impl="pair"
//     bwd2_sweep2 <- _make_sweep2_pair_kernel (:333, pallas_call :863), h1
//                    recomputed from x by the forward's chain (h1_pair)
// Each returns the named accumulators (per-block float64 partials that
// the caller sums in a fixed order, as in sa_pair.cu), not the TPU's
// packed (Lw, Rw) or paired main/aux blocks.
//
// Bounds on the card (R = 2,621,440 rows at the main path): fwd_gram by
// bytes (it streams 64-wide f32 rows), fwd_pool by operations
// (the recomputed 64x256 product, ~86 GFLOP: 0.54 ms in 3xTF32, 0.11 ms
// at bf16 with its CUDA-core passes, 1.30 ms on f32 CUDA cores),
// bwd2_sweep1 by operations (four dense products, h2 W3, Gram(h2), A3 =
// dy3^T h2 and q3 = D W3^T, 269 GFLOP on the tensor cores: 1.73 ms in
// 3xTF32, 0.38 ms at bf16 with its CUDA-core passes; dy3 is dense on the
// main path, ~25 tied rows a routed (group, channel)), bwd2_sweep2 by
// operations (two 64x64 products and C0 + 3 Grams of 64x64 per row, ~190
// GFLOP: 2.8 ms on f32 CUDA cores, 1.12-1.14 ms in 3xTF32, 0.31 ms on the
// bf16 tensor cores).
// Design: sa_pair.cu's persistent blocks over 64-row tiles. B7b keeps
// its port-time form, register-tiled products on CUDA cores (strict f32)
// with no copy/compute overlap; B7c, B8a, B6 and B8b run
// their products on the tensor cores in kernels of their own at each
// dtype (their sections below: the f32 ones in 3xTF32).
//
// bf16 (the template flag BF of B7b, B7c and B8a, entry points
// facl_sa_*_bf16): the row tensors (x, p1, p2, q3, dpooled, pooled) are
// __nv_bfloat16, the parameters the TPU kernels cast to the compute dtype
// (W1, b1, W2, W3, b3, M3, gi2, gi3) are rounded to bf16 where they are
// staged, and the results are rounded (rb) at the TPU kernels' cast
// points, listed by the bf16 twins of ops/sa_fwd.py and ops/sa_bwd.py.
// Every product then has two bf16 operands and is exact in f32, so the
// same f32 FMA chains sum them (B7c, B8a, B6 and B8b: the bf16 tensor
// cores; only the order of the sums differs from the twins), and the
// per-block float64 partials stay. The ReLU masks are decided on the
// bf16-rounded h (relu_affine_p, relu_packed); B6's h1 is sa_pair.cu's
// bf16 h1 bit for bit (h1_pre_bf16, the same k-order chain). In B7b
// every f32 path is the code it was before the template: the bf16 casts
// sit in `if constexpr (BF)` branches.
#include <cstdint>
#include "common.cuh"
#include "sa_mma.cuh"

namespace {

template <bool BF>
using RowT = typename Row<BF>::T;

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// sa_tile.cuh's row-tile loads and stores on rows stored as RowT<BF>;
// at BF h = relu(bf16(p * mul + shift)) (relu_affine_p).
template <bool BF>
__device__ __forceinline__ void load_h_tile_p(const RowT<BF>* __restrict__ p,
                                              int64_t r0, const float* mul,
                                              const float* shift, float* hs) {
  if constexpr (BF) {
    for (int e = threadIdx.x; e < TR * CW; e += NT) {
      const int r = e / CW, c = e % CW;
      hs[r * LD + c] =
          relu_affine_p<true>(to_f(p[(r0 + r) * CW + c]), mul[c], shift[c]);
    }
  } else {
    load_h_tile(p, r0, mul, shift, hs);
  }
}

// ---------------------------------------------------------------------
// B7b: per-block Gram(h2) and colsum(h2), h2 = relu(p2 * mul2 + shift2).
// vec2 = [mul2 | shift2]; partG (blocks, 64, 64), partc (blocks, 64).
template <bool BF>
__global__ void __launch_bounds__(NT)
fwd_gram_kernel(const RowT<BF>* __restrict__ p2, int64_t ntiles,
                const float* __restrict__ vec2, double* __restrict__ partG,
                double* __restrict__ partc) {
  extern __shared__ float sm[];
  float* h2s = sm;                      // TR*LD
  float* v2 = h2s + TR * LD;            // mul2 | shift2

  copy_vec(v2, vec2, 2 * CW);
  __syncthreads();
  double g[4][4] = {};
  double ch = 0.0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    load_h_tile_p<BF>(p2, t * TR, v2, v2 + CW, h2s);
    __syncthreads();
    float tg[4][4];
    zero_patch(tg);
    acc_atb(h2s, h2s, tg);
    add_patch(g, tg);
    if (threadIdx.x < CW) {
      float tc = 0.f;
      for (int r = 0; r < TR; ++r) tc += h2s[r * LD + threadIdx.x];
      ch += tc;
    }
    __syncthreads();
  }
  write_patch(g, partG + (int64_t)blockIdx.x * CW * CW);
  if (threadIdx.x < CW) partc[(int64_t)blockIdx.x * CW + threadIdx.x] = ch;
}

// ---------------------------------------------------------------------
// B8a (hybrid2 and hybrid's sweep 1) on the tensor cores. Per 64-row
// tile: h2 = relu(p2 mul2 + shift2) (rounded to bf16 before the ReLU at
// BF); z = (h2 W3 + b3) mul3 + shift3 (at BF p3 = bf16(h2 W3) + b3 in
// f32); each group's dpooled split evenly among the rows whose relu(z)
// reaches the group's max, where that max is > 0 (_dy_top, sa_bwd.py:
// 70-91; at BF the share rounded to bf16); A3 = dy3^T h2 (256, 64), u3 =
// sum dy3, Gram(h2) and colsum(h2) as per-block float64 partials; the row
// output q3 = (gi3 dy3) W3^T (R, 64) (at BF bf16(bf16(dy3 bf16(gi3))
// bf16(W3)^T)). Every product is dense: dy3 has no branch on its zeros.
//
// One block of 512 threads an SM (16 warps). p2 tiles arrive by TMA, one
// bulk copy a tile, STAGES in flight; all threads turn a tile into h2 in
// shared memory. Warp w then forms z^T = W3^T h2^T for the channels
// 16 w.. over all 64 rows (m = channel, n = row), so lane (g, t) holds
// channel 16 w + 8 hh + g at rows 8 j + 2 t + e in c[j][2 hh + e]: a
// (group, channel)'s rows meet inside one warp, in the lanes of one t
// group. The route is taken from the accumulators: the group's max of
// relu(z) over the lane's values and two shuffle steps over t, then the
// count of rows equal to it the same way; dy3 overwrites z in registers.
// The C fragment of z^T pairs rows 2 t, 2 t + 1 of each 8-row step, so
// dy3^T is the A fragment of A3 = dy3^T h2 as it stands (the B operand
// h2 read with the same pairing), and u3 is summed from it. D = gi3 dy3
// goes to a (256, 64) shared tile D^T; after one block barrier warp
// (mw, nw) takes q3's rows 16 mw.., columns 16 nw.. (k = the 256
// channels) and the same (16, 16) block of Gram(h2) (at f32 the blocks
// on and above the diagonal), the diagonal warps the column sums from the
// same fragments. Two barriers a tile.
//   bf16: mma.sync m16n8k16 on bf16 tiles (stride LDB; W3 staged once a
//         block as a bf16 (64, 264) tile [j][c], read by ldmatrix as
//         z^T's A and q3's B); A3 adds each k16 step to its f32 running
//         sums round-to-nearest.
//   f32:  mma.sync m16n8k8 TF32 in 3xTF32 (tf32_mma.cuh's split and
//         mma3). The tensor cores' own adds truncate: z^T and the Gram
//         chain their 64-deep sums a tile (as B2b), q3 sums each 32
//         channels on its own and adds them round-to-nearest, and A3,
//         whose f32 running sums span every row of the block, adds each
//         k8 step round-to-nearest (step3); h2 split into hi and lo tiles
//         once, as it is made (sa_mma.cuh's layout: A3's row-pair reads
//         meet 2-way bank conflicts, which an XOR swizzle removed for ~1%
//         of the time); W3 (64, 260) and D^T in f32, split as loaded (a
//         pre-split W3 or D^T would not fit beside them).
// Exact ties stay exact: identical rows of h2 give identical columns of
// z^T's B operand, and the tensor cores sum each output the same way
// wherever it sits. A group spanning tiles (pool > TR, upt = pool / TR)
// is walked twice by one block: z alone for its max and tie count, then
// every product with the route.
// vec = [mul2 | shift2 | b3 | mul3 | shift3 | gi3]; partA (blocks, 256,
// 64), partu (blocks, 256), partG (blocks, 64, 64), partc (blocks, 64).
constexpr int S8_LDWB = C3W + 8;      // bf16 W3 tile stride (values)
constexpr int S8_LDWF = C3W + 4;      // f32 W3 tile stride
constexpr uint32_t S8_FULL = 0xffffffffu;
constexpr int S8_NT = 512;

// Shared memory of B8a's block (bytes): STAGES p2 tiles | h2 (bf16 tile;
// f32 hi and lo tiles) | W3 tile | D^T tile | vec | mbarriers.
template <bool BF>
struct S8 {
  static constexpr int STAGES = BF ? 4 : 2;
  static constexpr size_t STAGE = TR * CW * (BF ? 2 : 4);
  static constexpr size_t H = STAGES * STAGE;
  static constexpr size_t W = H + (BF ? TR * LDB * 2 : 2 * TR * LDT * 4);
  static constexpr size_t D = W + (BF ? CW * S8_LDWB * 2 : CW * S8_LDWF * 4);
  static constexpr size_t V = D + (BF ? C3W * LDB * 2 : C3W * LDT * 4);
  static constexpr size_t BARS = V + (2 * CW + 4 * C3W) * 4;
  static constexpr size_t TOTAL = BARS + STAGES * 8;
};

// c += a b (m16n8k16 bf16) as a step of its own, added round-to-nearest.
__device__ __forceinline__ void step_bf16(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(s, a, b0, b1);
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = __fadd_rn(c[q], s[q]);
}

// h2 of a staged p2 tile -> the block's h2 tile; v = [mul2 | shift2].
template <bool BF>
__device__ __forceinline__ void s8_h2(const RowT<BF>* S, const float* v,
                                      unsigned char* hb) {
  if constexpr (BF) {
    relu_rows_bf16(S, v, reinterpret_cast<__nv_bfloat16*>(hb), threadIdx.x,
                   S8_NT);
  } else {
    float* hi = reinterpret_cast<float*>(hb);
    relu_split_rows(S, v, v + CW, hi, hi + TILE_F);
  }
}

// z^T = W3^T h2^T for the warp's channels n0.. (z before the affine):
// c[j][2 hh + e] = channel n0 + 8 hh + g, row 8 j + 2 t + e.
template <bool BF>
__device__ __forceinline__ void s8_zt(const unsigned char* hb,
                                      const unsigned char* wb, int n0,
                                      int lane, float c[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) zero4(c[j]);
  if constexpr (BF) {
    const __nv_bfloat16* H = reinterpret_cast<const __nv_bfloat16*>(hb);
    const __nv_bfloat16* Ws = reinterpret_cast<const __nv_bfloat16*>(wb);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm4t(a, a_cols_at<S8_LDWB>(Ws, n0, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4(b, b_cols_at(H, 16 * np, 16 * kk, lane));
        mma_bf16(c[2 * np], a, b[0], b[1]);
        mma_bf16(c[2 * np + 1], a, b[2], b[3]);
      }
    }
  } else {
    const float* hi = reinterpret_cast<const float*>(hb);
    const SplitBuf H{hi, hi + TILE_F};
    const float* Ws = reinterpret_cast<const float*>(wb);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int kb = 0; kb < 8; ++kb) {
      const float* w = Ws + (8 * kb + 2 * t) * S8_LDWF + n0 + g;
      const FragA a{{split(w[0]), split(w[8]), split(w[S8_LDWF]),
                     split(w[S8_LDWF + 8])}};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragB b;
        at2(H, (8 * j + g) * LDT + 8 * kb + 2 * t, b.v[0], b.v[1]);
        mma3(c[j], a, b);
      }
    }
  }
}

// Gram(h2) for warp (mw, nw)'s (16, 16) block, each tile's part added to
// the f32 running sums G round-to-nearest, and at nw == mw the column
// sums 16 mw + g (+ 8) into ch; at f32 only the blocks with nw >= mw (the
// caller mirrors them). h2 >= 0: every term is >= 0, so the f32 running
// sums lose no more than ~tiles 2^-24 of their value.
template <bool BF>
__device__ __forceinline__ void s8_gram(const unsigned char* hb, int mw,
                                        int nw, int lane, float G[2][4],
                                        float ch[2]) {
  float c[2][4];
  zero4(c[0]);
  zero4(c[1]);
  float s0 = 0.f, s1 = 0.f;
  if constexpr (BF) {
    const __nv_bfloat16* H = reinterpret_cast<const __nv_bfloat16*>(hb);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4], b[4];
      ldsm4t(a, a_cols_at(H, 16 * mw, 16 * kk, lane));
      ldsm4t(b, b_rows_at(H, 16 * nw, 16 * kk, lane));
      if (nw == mw) {
        const float2 u0 = unpack_bf16(a[0]), u1 = unpack_bf16(a[1]);
        const float2 u2 = unpack_bf16(a[2]), u3 = unpack_bf16(a[3]);
        s0 += (u0.x + u0.y) + (u2.x + u2.y);
        s1 += (u1.x + u1.y) + (u3.x + u3.y);
      }
      mma_bf16(c[0], a, b[0], b[1]);
      mma_bf16(c[1], a, b[2], b[3]);
    }
  } else {
    if (nw < mw) return;                // sa_pair.cu's B2b f32 Gram
    const float* hi = reinterpret_cast<const float*>(hb);
    const SplitBuf H{hi, hi + TILE_F};
#pragma unroll 2
    for (int kb = 0; kb < 8; ++kb) {
      const FragA a = frag_a_cols(H, 16 * mw, kb, lane);
      if (nw == mw) {
        s0 += col_pair(a, 0);
        s1 += col_pair(a, 1);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        mma3(c[nj], a, frag_b_rows(H, 16 * nw + 8 * nj, kb, lane));
    }
  }
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int q = 0; q < 4; ++q) G[nj][q] = __fadd_rn(G[nj][q], c[nj][q]);
  ch[0] = __fadd_rn(ch[0], s0);
  ch[1] = __fadd_rn(ch[1], s1);
}

// z = (p3 + b3) mul3 + shift3 from z^T's accumulators (p3 = bf16(acc)
// at BF); cg = channel n0 + g of the tile.
template <bool BF>
__device__ __forceinline__ void s8_affine(float c[8][4], int cg,
                                          const float* b3s,
                                          const float* mul3,
                                          const float* shift3) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int cn = cg + 8 * hh;
    const float b = b3s[cn], m3 = mul3[cn], s3 = shift3[cn];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 p = make_float2(c[j][2 * hh], c[j][2 * hh + 1]);
      if constexpr (BF) p = unpack_bf16(pack_bf16(p.x, p.y));
      c[j][2 * hh] = __fadd_rn(__fmul_rn(__fadd_rn(p.x, b), m3), s3);
      c[j][2 * hh + 1] = __fadd_rn(__fmul_rn(__fadd_rn(p.y, b), m3), s3);
    }
  }
}

// A group spanning tiles, its first walk: the tile's max of relu(z) and
// the rows equal to it (the lane's values, then the t group), merged into
// the group's running max gm and tie count gn.
__device__ __forceinline__ void s8_span_max(const float c[8][4], float gm[2],
                                            int gn[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      m = fmaxf(m, fmaxf(c[j][2 * hh], c[j][2 * hh + 1]));
    m = fmaxf(m, __shfl_xor_sync(S8_FULL, m, 1));
    m = fmaxf(m, __shfl_xor_sync(S8_FULL, m, 2));
    int n = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      n += (c[j][2 * hh] == m ? 1 : 0) + (c[j][2 * hh + 1] == m ? 1 : 0);
    n += __shfl_xor_sync(S8_FULL, n, 1);
    n += __shfl_xor_sync(S8_FULL, n, 2);
    if (m > gm[hh]) {
      gm[hh] = m;
      gn[hh] = n;
    } else if (m == gm[hh]) {
      gn[hh] += n;
    }
  }
}

// The route of one channel tile (n0..) from z (c, the affine applied):
// per (group, channel) the max of relu(z) and the count of rows equal to
// it (m, n; given for a group spanning tiles, upt > 1), share = dpooled
// / n where m > 0 (rounded to bf16 at BF); c becomes dy3. A group of 2^LP
// rows spans JS of a lane's j and ES of its e, and the low TB bits of t.
// us[hh] += the lane's sum of dy3 for channel n0 + 8 hh + g.
template <bool BF, int LP>
__device__ __forceinline__ void s8_route(float c[8][4], int n0, int lane,
                                         int64_t tile, int upt,
                                         const float gm[2], const int gn[2],
                                         const RowT<BF>* __restrict__ dp,
                                         float us[2]) {
  constexpr int JS = LP > 3 ? 1 << (LP - 3) : 1;
  constexpr int ES = LP > 0 ? 2 : 1;
  constexpr int TB = LP > 2 ? 2 : (LP > 1 ? 1 : 0);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ch = n0 + 8 * hh + g;
    float s = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += JS)
#pragma unroll
      for (int e0 = 0; e0 < 2; e0 += ES) {
        float m;
        int n;
        if (upt > 1) {
          m = gm[hh];
          n = gn[hh];
        } else {
          m = 0.f;
#pragma unroll
          for (int jj = 0; jj < JS; ++jj)
#pragma unroll
            for (int ee = 0; ee < ES; ++ee)
              m = fmaxf(m, c[j0 + jj][2 * hh + e0 + ee]);
#pragma unroll
          for (int b = 0; b < TB; ++b)
            m = fmaxf(m, __shfl_xor_sync(S8_FULL, m, 1 << b));
          n = 0;
#pragma unroll
          for (int jj = 0; jj < JS; ++jj)
#pragma unroll
            for (int ee = 0; ee < ES; ++ee)
              n += c[j0 + jj][2 * hh + e0 + ee] == m ? 1 : 0;
#pragma unroll
          for (int b = 0; b < TB; ++b)
            n += __shfl_xor_sync(S8_FULL, n, 1 << b);
        }
        float share = 0.f;
        if (m > 0.f) {
          const int base = ((8 * j0 + 2 * t + e0) >> LP) << LP;
          const int64_t grp =
              upt > 1 ? tile / upt : tile * (TR >> LP) + (base >> LP);
          share = rb_if<BF>(
              __fdiv_rn(to_f(dp[grp * C3W + ch]), static_cast<float>(n)));
        }
#pragma unroll
        for (int jj = 0; jj < JS; ++jj)
#pragma unroll
          for (int ee = 0; ee < ES; ++ee) {
            float& z = c[j0 + jj][2 * hh + e0 + ee];
            z = (m > 0.f && z == m) ? share : 0.f;
            s += z;
          }
      }
    us[hh] += s;
  }
}

// dy3 (bf16 values) packed in pairs as dy3^T's A fragments: k16 step kk
// (rows 16 kk..) from z^T's C fragments 2 kk and 2 kk + 1 as they stand.
__device__ __forceinline__ void s8_pack(const float c[8][4],
                                        uint32_t dy[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    dy[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    dy[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    dy[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    dy[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// D = gi3 dy3 of the channel tile n0.. into the D^T tile [channel][row]:
// bf16(dy3 bf16(gi3)) by stmatrix (bf16), or the f32 products (f32).
__device__ __forceinline__ void s8_dstore(const uint32_t dy[4][4],
                                          const float* gi3, int n0, int lane,
                                          unsigned char* db) {
  const int g = lane >> 2;
  const float ga = gi3[n0 + g], gb = gi3[n0 + 8 + g];
  __nv_bfloat16* DT = reinterpret_cast<__nv_bfloat16*>(db);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 d = unpack_bf16(dy[kk][q]);
      const float s = (q & 1) ? gb : ga;
      r[q] = pack_bf16(__fmul_rn(d.x, s), __fmul_rn(d.y, s));
    }
    stsm4(DT + (n0 + (((lane >> 3) & 1) << 3) + (lane & 7)) * LDB +
              16 * kk + ((lane >> 4) << 3),
          r);
  }
}

__device__ __forceinline__ void s8_dstore(const float c[8][4],
                                          const float* gi3, int n0, int lane,
                                          unsigned char* db) {
  const int g = lane >> 2, t = lane & 3;
  const float ga = gi3[n0 + g], gb = gi3[n0 + 8 + g];
  float* DT = reinterpret_cast<float*>(db);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    st2r(DT + (n0 + g) * LDT + 8 * j + 2 * t,
         make_float2(__fmul_rn(c[j][0], ga), __fmul_rn(c[j][1], ga)));
    st2r(DT + (n0 + 8 + g) * LDT + 8 * j + 2 * t,
         make_float2(__fmul_rn(c[j][2], gb), __fmul_rn(c[j][3], gb)));
  }
}

// A3 += dy3^T h2 for the warp's channels: dy3^T's A fragments are z^T's
// C fragments as they stand (rows 2 t, 2 t + 1 of each k step), h2 the B
// operand read with the same pairing; each k step added round-to-nearest.
__device__ __forceinline__ void s8_a3(const uint32_t dy[4][4],
                                      const unsigned char* hb, int lane,
                                      float a3[8][4]) {
  const __nv_bfloat16* H = reinterpret_cast<const __nv_bfloat16*>(hb);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm4t(b, b_rows_at(H, 16 * np, 16 * kk, lane));
      step_bf16(a3[2 * np], dy[kk], b[0], b[1]);
      step_bf16(a3[2 * np + 1], dy[kk], b[2], b[3]);
    }
}

__device__ __forceinline__ void s8_a3(const float c[8][4],
                                      const unsigned char* hb, int lane,
                                      float a3[8][4]) {
  const float* hi = reinterpret_cast<const float*>(hb);
  const SplitBuf H{hi, hi + TILE_F};
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    const FragA a{{split(c[kb][0]), split(c[kb][2]), split(c[kb][1]),
                   split(c[kb][3])}};
    const int o = (8 * kb + 2 * t) * LDT + g;   // rows 2 t, 2 t + 1
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      step3(a3[nt], a, FragB{{at(H, o + 8 * nt), at(H, o + LDT + 8 * nt)}});
  }
}

// q3 of the tile's rows 16 mw.., columns 16 nw.. = D W3^T (k = the 256
// channels, D from the D^T tile, W3 from its tile), stored to out (the
// tile's first row).
template <bool BF>
__device__ __forceinline__ void s8_q3(const unsigned char* db,
                                      const unsigned char* wb, int mw,
                                      int nw, int lane, RowT<BF>* out) {
  const int g = lane >> 2, t = lane & 3;
  float qa[2][4];                       // rows 16 mw + g (+8), columns
  zero4(qa[0]);                         // 16 nw + 8 nj + 2t (+1)
  zero4(qa[1]);
  if constexpr (BF) {
    const __nv_bfloat16* DT = reinterpret_cast<const __nv_bfloat16*>(db);
    const __nv_bfloat16* Ws = reinterpret_cast<const __nv_bfloat16*>(wb);
#pragma unroll 4
    for (int kk = 0; kk < C3W / 16; ++kk) {
      uint32_t a[4], b[4];
      ldsm4t(a, a_cols_at(DT, 16 * mw, 16 * kk, lane));
      ldsm4(b, b_cols_at<S8_LDWB>(Ws, 16 * nw, 16 * kk, lane));
      mma_bf16(qa[0], a, b[0], b[1]);
      mma_bf16(qa[1], a, b[2], b[3]);
    }
  } else {
    const float* DT = reinterpret_cast<const float*>(db);
    const float* Ws = reinterpret_cast<const float*>(wb);
    for (int k0 = 0; k0 < C3W / 8; k0 += 4) {   // 32 channels a step
      float st[2][4];
      zero4(st[0]);
      zero4(st[1]);
#pragma unroll
      for (int kb = k0; kb < k0 + 4; ++kb) {
        const float* d = DT + (8 * kb + t) * LDT + 16 * mw + g;
        const FragA a{{split(d[0]), split(d[8]), split(d[4 * LDT]),
                       split(d[4 * LDT + 8])}};
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const float* x = Ws + (16 * nw + 8 * nj + g) * S8_LDWF + 8 * kb + t;
          mma3(st[nj], a, FragB{{split(x[0]), split(x[4])}});
        }
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) qa[nj][q] = __fadd_rn(qa[nj][q], st[nj][q]);
    }
  }
  RowT<BF>* o = out + (16 * mw + g) * CW + 16 * nw + 2 * t;
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    if constexpr (BF) {
      *reinterpret_cast<uint32_t*>(o + 8 * nj) =
          pack_bf16(qa[nj][0], qa[nj][1]);
      *reinterpret_cast<uint32_t*>(o + 8 * CW + 8 * nj) =
          pack_bf16(qa[nj][2], qa[nj][3]);
    } else {
      st2r(o + 8 * nj, make_float2(qa[nj][0], qa[nj][1]));
      st2r(o + 8 * CW + 8 * nj, make_float2(qa[nj][2], qa[nj][3]));
    }
  }
}

template <bool BF, int LP>
__global__ void __launch_bounds__(S8_NT, 1)
bwd2_sweep1_kernel(const RowT<BF>* __restrict__ p2, int64_t ntiles, int upt,
                   const float* __restrict__ vec,
                   const float* __restrict__ W3,
                   const RowT<BF>* __restrict__ dpooled,
                   RowT<BF>* __restrict__ q3,
                   double* __restrict__ partA, double* __restrict__ partu,
                   double* __restrict__ partG, double* __restrict__ partc) {
  using L = S8<BF>;
  using T = RowT<BF>;
  extern __shared__ __align__(128) unsigned char smb[];
  T* stage = reinterpret_cast<T*>(smb);
  unsigned char* hb = smb + L::H;
  unsigned char* wb = smb + L::W;
  unsigned char* db = smb + L::D;
  float* v = reinterpret_cast<float*>(smb + L::V);
  const float* b3s = v + 2 * CW;        // b3 (rounded at BF)
  const float* mul3 = v + 2 * CW + C3W;
  const float* shift3 = v + 2 * CW + 2 * C3W;
  const float* gi3 = v + 2 * CW + 3 * C3W;   // (rounded at BF)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smb + L::BARS);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = 16 * warp;             // z^T, dy3, A3, u3: channels n0..
  const int mw = warp & 3, nw = warp >> 2;  // q3, Gram: rows 16 mw.., 16 nw..
  // This block's steps: whole units of upt tiles (a group spanning tiles
  // stays with one block, walked twice), units strided over the grid.
  const int steps = upt > 1 ? 2 * upt : 1;
  const int64_t units = ntiles / upt;
  const int64_t count =
      units > blockIdx.x ? ((units - 1 - blockIdx.x) / gridDim.x + 1) * steps
                         : 0;
  auto tile_at = [&](int64_t i) {
    return (blockIdx.x + (i / steps) * gridDim.x) * upt + (i % steps) % upt;
  };
  auto fetch = [&](int64_t i) {               // thread 0: one bulk copy
    uint64_t* bar = &bars[i % L::STAGES];
    mbar_expect(bar, static_cast<uint32_t>(L::STAGE));
    bulk_load(stage + (i % L::STAGES) * TR * CW, p2 + tile_at(i) * TR * CW,
              static_cast<uint32_t>(L::STAGE), bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) mbar_init(&bars[s]);
    for (int64_t i = 0; i < L::STAGES && i < count; ++i) fetch(i);
  }
  if constexpr (BF) {                   // W3 as a bf16 tile [j][c]
    __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(wb);
    for (int e = threadIdx.x; e < CW * C3W / 2; e += S8_NT) {
      const int j = e / (C3W / 2), c = (e % (C3W / 2)) * 2;
      *reinterpret_cast<uint32_t*>(Ws + j * S8_LDWB + c) =
          pack_bf16(W3[j * C3W + c], W3[j * C3W + c + 1]);
    }
  } else {
    float* Ws = reinterpret_cast<float*>(wb);
    for (int e = threadIdx.x; e < CW * C3W; e += S8_NT)
      Ws[(e / C3W) * S8_LDWF + e % C3W] = W3[e];
  }
  for (int i = threadIdx.x; i < 2 * CW + 4 * C3W; i += S8_NT) {
    const bool r = BF && ((i >= 2 * CW && i < 2 * CW + C3W) ||
                          i >= 2 * CW + 3 * C3W);
    v[i] = r ? rb(vec[i]) : vec[i];
  }
  __syncthreads();

  float a3[8][4];            // A3: channels n0 + g (+8), columns 8 j + 2t (+1)
#pragma unroll
  for (int j = 0; j < 8; ++j) zero4(a3[j]);
  float G[2][4];             // Gram: rows 16 mw + g (+8), cols 16 nw + 8 nj + 2t
  zero4(G[0]);
  zero4(G[1]);
  float ch[2] = {0.f, 0.f};
  double u3[2] = {0.0, 0.0};
  float gm[2] = {0.f, 0.f};  // a group spanning tiles: its max and ties
  int gn[2] = {0, 0};
  for (int64_t i = 0; i < count; ++i) {
    const int w = static_cast<int>(i % steps);
    const int64_t tile = tile_at(i);
    mbar_wait(&bars[i % L::STAGES],
              static_cast<uint32_t>((i / L::STAGES) & 1));
    s8_h2<BF>(stage + (i % L::STAGES) * TR * CW, v, hb);
    __syncthreads();
    if (threadIdx.x == 0 && i + L::STAGES < count) fetch(i + L::STAGES);

    float c[8][4];
    s8_zt<BF>(hb, wb, n0, lane, c);
    s8_affine<BF>(c, n0 + g, b3s, mul3, shift3);
    if (upt > 1 && w < upt) {           // pass 1: the group's max, ties
      if (w == 0) {
        gm[0] = gm[1] = 0.f;
        gn[0] = gn[1] = 0;
      }
      s8_span_max(c, gm, gn);
      __syncthreads();                  // h2 is rewritten next step
      continue;
    }
    s8_gram<BF>(hb, mw, nw, lane, G, ch);
    float us[2] = {0.f, 0.f};
    s8_route<BF, LP>(c, n0, lane, tile, upt, gm, gn, dpooled, us);
    u3[0] += us[0];
    u3[1] += us[1];
    if constexpr (BF) {                 // dy3 packed: half the registers
      uint32_t dy[4][4];
      s8_pack(c, dy);
      s8_dstore(dy, gi3, n0, lane, db);
      s8_a3(dy, hb, lane, a3);
    } else {
      s8_dstore(c, gi3, n0, lane, db);
      s8_a3(c, hb, lane, a3);
    }
    __syncthreads();                    // D^T complete
    s8_q3<BF>(db, wb, mw, nw, lane, q3 + tile * TR * CW);
  }

  double* pa = partA + (int64_t)blockIdx.x * C3W * CW;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pa[(n0 + g + 8 * (q >> 1)) * CW + 8 * j + 2 * t + (q & 1)] = a3[j][q];
  const double ua = sum_over_t(u3[0]), ub = sum_over_t(u3[1]);
  if (t == 0) {
    partu[(int64_t)blockIdx.x * C3W + n0 + g] = ua;
    partu[(int64_t)blockIdx.x * C3W + n0 + 8 + g] = ub;
  }
  double* pg = partG + (int64_t)blockIdx.x * CW * CW;
  if (BF || nw >= mw) {
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 16 * mw + g + 8 * (q >> 1);
        const int cc = 16 * nw + 8 * nj + 2 * t + (q & 1);
        pg[r * CW + cc] = G[nj][q];
        if (!BF && nw > mw) pg[cc * CW + r] = G[nj][q];
      }
  }
  if (nw == mw) {
    const double a = sum_over_t(static_cast<double>(ch[0]));
    const double b = sum_over_t(static_cast<double>(ch[1]));
    if (t == 0) {
      partc[(int64_t)blockIdx.x * CW + 16 * mw + g] = a;
      partc[(int64_t)blockIdx.x * CW + 16 * mw + g + 8] = b;
    }
  }
}

// ---------------------------------------------------------------------
// B6 / B8b at bf16 (facl_sa_bwd2_sweep2_bf16) on the bf16 tensor cores.
// Replaces sa_bwd.py::_make_sweep2_kernel (:140, pallas_call :298; B8b, h1
// from the stored p1) and sa_pair.py::_make_sweep2_pair_kernel (:333,
// pallas_call :863; B6, h1 from x) at compute_dtype bfloat16 (the twins:
// ops/sa_bwd.py::_sweep2_bf16 and _sweep2_sums). h2 = relu(bf16(p2 mul2 +
// shift2)); dy2 = bf16([h2 > 0] (q3 - bf16(h2 bf16(M3)) - rc3)); q2 =
// bf16(bf16(dy2 bf16(gi2)) bf16(W2)^T); h1 = relu(bf16(p1 mul1 + shift1))
// (B8b) or the bf16 chain of B2a and B3b (h1_pre_bf16; B6), so the
// layer-1 masks m1 = [h1 > 0] are the forward's; mq = m1 q2. Per block,
// the TPU kernels' packed left^T right (sa_bwd.py:172-185):
//   [dy2 | h1 | m1 | m1 x_i (i < C0)]^T h1   A2, G1, TM1, U1_i
//                                            partM (blocks, 2, 64, 64),
//                                            partU (blocks, C0 + 1, 64, 64)
//   [dy2 | m1 | h1 | mq | x]^T [x | 1]       u2, T1x, cnt1, ch1, P1, acc1,
//                                            Gx, cx: partV (blocks, 4, 64),
//                                            partX (blocks, NX)
// every product of two bf16 values (m1 x_i too: m1 is 0 or 1) exact in
// f32, so only the order of the sums differs from the twin's.
//
// Bound on the card at the main path: 0.31 ms by operations (69,696 flops
// a row at C0 = 4 on the bf16 tensor cores). One 512-thread block an SM
// walks 128-row steps in three stages of padded bf16 tiles: while step
// i + 1's p2, q3 and p1 (or x) arrive by cp.async, every warp runs its
// part of step i's row chain and of step i - 1's contraction, one block
// barrier a step (warps 0-7 take the row chain first, warps 8-15 the
// contraction, so one half's products run beside the other's row
// passes):
//  - the row chain (s2f_rows): warp w takes rows 16 (w / 2).. and the
//    column half w % 2, in the mma fragment layouts. It writes h1 over the
//    p1 it read (B6: from x); makes h2's A fragments from p2's (ldmatrix,
//    the chain); runs h2 bf16(M3) on mma.sync m16n8k16; writes dy2 over
//    the q3 it read and bf16(dy2 gi2) to a tile the warp pair shares (one
//    named barrier for the two warps); runs q2 = that bf16(W2)^T; writes
//    mq over p2. The masks stay bits in registers.
//  - the contraction over the step's rows (s2f_contract): warp (m, n)
//    owns the 16 x 16 block (channels 16 m.., columns 16 n..) of A2, G1,
//    TM1 and every U1_i. Each k16 step of rows loads h1's B fragments once
//    (ldmatrix .trans) for all 3 + C0 products; A is dy2^T or h1^T by
//    ldmatrix .trans, m1^T is h1^T's fragment made a mask (mask_of),
//    TM1's A that mask's bf16 ones, U1_i's the mask anded with x_i's bf16
//    bits. The n8 tile [x | 1] is built from x's staged tile; warps (m, 0),
//    (m, 1) and (0, 2) take its five left operands.
// The accumulators ride the mma's f32 registers, 8 (3 + C0) + 8 a thread,
// for at most S2F_FLUSH steps, then are added to the block's float64
// partials in global memory (each partial owned by one thread: no
// atomics, a fixed order, run to run bit-identical). The tensor cores'
// f32 sums of a long chain drift (a 64-step chain put Gx 1.9e-5 of its
// max-abs off the twin, a 32-step one 6.6e-6: chip_ablate.py b8b on an
// H100), so the chain is cut at 32 steps (4,096 rows). C0 is a template
// argument, so the accumulators' count is known to the compiler.
// 219,264 bytes of shared memory (S2F_SMEM).
constexpr int S2F_NT = 512;
constexpr int S2F_ROWS = 128;                  // rows a step
constexpr int S2F_STAGES = 3;
constexpr int S2F_FLUSH = 32;                  // steps between float64 adds
constexpr int S2F_TILE = S2F_ROWS * LDB;       // a padded (128, 64) tile
constexpr int S2F_XS = S2F_ROWS + 8;           // x's channel stride
// A stage (bf16 values): p2 (then mq) | q3 (then dy2) | p1 (then h1) | x
// channel-major (C0MAX, S2F_XS) | x as stored, row-major (128, C0), when
// N == 1.
constexpr int S2F_P2 = 0, S2F_Q3 = S2F_TILE, S2F_H1 = 2 * S2F_TILE;
constexpr int S2F_X = 3 * S2F_TILE, S2F_XR = S2F_X + C0MAX * S2F_XS;
constexpr int S2F_STAGE = S2F_XR + S2F_ROWS * C0MAX;
constexpr size_t S2F_SMEM =
    sizeof(__nv_bfloat16) *
        (S2F_STAGES * S2F_STAGE + S2F_TILE + 2 * CW * LDB) +
    sizeof(float) * (C0MAX * CW + 7 * CW);
constexpr uint32_t BF16_ONES = 0x3f803f80u;   // two bf16 1.0

// 0xffff for each nonzero half of a packed pair of bf16 values >= 0 (a
// ReLU output whose zeros are +0), else 0: bit 15 of h + 0x7fff is set
// iff h > 0, and prmt replicates it over the half.
__device__ __forceinline__ uint32_t mask_of(uint32_t h) {
  uint32_t m;
  asm("prmt.b32 %0, %1, 0, 0xbb99;" : "=r"(m) : "r"(h + 0x7fff7fffu));
  return m;
}

template <int C0>
struct S2FAcc {
  float a2[2][4], g1[2][4], tm[2][4], u[C0][2][4], e[2][4];
};

template <int C0>
__device__ __forceinline__ void s2f_zero(S2FAcc<C0>& A) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    zero4(A.a2[n]);
    zero4(A.g1[n]);
    zero4(A.tm[n]);
    zero4(A.e[n]);
#pragma unroll
    for (int i = 0; i < C0; ++i) zero4(A.u[i][n]);
  }
}

// x_c of staged row r (the channel-major tile, or the row-major copy).
template <int C0>
__device__ __forceinline__ float s2f_x(const __nv_bfloat16* S, bool rowx,
                                       int c, int r) {
  return to_f(rowx ? S[S2F_XR + r * C0 + c] : S[S2F_X + c * S2F_XS + r]);
}

// h1 of the warp's rows rw + g (+8) and columns 32 hc + 8 jj + 2t (+1),
// written as bf16 to the stage's h1 tile (over p1 for B8b); returns its
// mask m1, bit 4 jj + 2 h + e. vec1 = [b1 | mul1 | shift1], b1 rounded.
template <int C0, bool FROM_X>
__device__ __forceinline__ uint32_t s2f_h1(__nv_bfloat16* S, bool rowx,
                                           const float* W1s,
                                           const float* vec1, int rw,
                                           int hc, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* H1 = S + S2F_H1;
  uint32_t m1 = 0;
  if constexpr (FROM_X) {
    float xa[C0MAX - 1], xb[C0MAX - 1];
#pragma unroll
    for (int k = 0; k < C0; ++k) {
      xa[k] = s2f_x<C0>(S, rowx, k, rw + g);
      xb[k] = s2f_x<C0>(S, rowx, k, rw + g + 8);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = 32 * hc + 8 * jj + 2 * t;
      uint32_t ua, ub, ba, bb;
      float2 f;
      h1_pre_bf16(xa, xb, C0, W1s, vec1, col, ua, ub);
      st32(H1 + (rw + g) * LDB + col, relu_packed(ua, f, ba));
      st32(H1 + (rw + g + 8) * LDB + col, relu_packed(ub, f, bb));
      m1 |= (ba | bb << 2) << (4 * jj);
    }
  } else {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = 32 * hc + 8 * jj + 2 * t;
      const float2 mul = ld2(vec1 + CW + col), sh = ld2(vec1 + 2 * CW + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat16* at = H1 + (rw + g + 8 * h) * LDB + col;
        const float2 p = unpack_bf16(ld32(at));
        float2 f;
        uint32_t bits;
        st32(at, relu_packed(
                     pack_bf16(__fadd_rn(__fmul_rn(p.x, mul.x), sh.x),
                               __fadd_rn(__fmul_rn(p.y, mul.y), sh.y)),
                     f, bits));
        m1 |= bits << (4 * jj + 2 * h);
      }
    }
  }
  return m1;
}

// The row chain of one warp on the step staged at S (module comment).
// v2 = [mul2 | shift2 | rc3 | gi2] (gi2 rounded); DG the pair's bf16(dy2
// gi2) tile.
template <int C0, bool FROM_X>
__device__ __forceinline__ void s2f_rows(__nv_bfloat16* S, bool rowx,
                                         const float* W1s, const float* vec1,
                                         const float* v2,
                                         const __nv_bfloat16* Ms,
                                         const __nv_bfloat16* W2s,
                                         __nv_bfloat16* DG, int warp,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp >> 1), hc = warp & 1;
  __nv_bfloat16* Q3 = S + S2F_Q3;
  __nv_bfloat16* P2 = S + S2F_P2;
  const uint32_t m1 = s2f_h1<C0, FROM_X>(S, rowx, W1s, vec1, rw, hc, lane);
  // h2's A fragments from p2's (all 64 columns), and h2's mask at this
  // half's columns (bit 4 jj + 2 h + e, as m1).
  uint32_t ha2[4][4];
  const uint32_t m2 =
      h2_frags_bf16(ha2, P2, rw, v2, v2 + CW, lane) >> (16 * hc);
  // h2 bf16(M3) at this half's n-tiles 4 hc + jj.
  float c[4][4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) zero4(c[jj]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t b[4];
      ldsm4t(b, b_rows_at(Ms, 32 * hc + 16 * p, 16 * kk, lane));
      mma_bf16(c[2 * p], ha2[kk], b[0], b[1]);
      mma_bf16(c[2 * p + 1], ha2[kk], b[2], b[3]);
    }
  // dy2 = bf16([h2 > 0] (q3 - bf16(h2 M3) - rc3)) over q3, and
  // bf16(dy2 gi2) to DG.
  const float* rc3 = v2 + 2 * CW;
  const float* gi2 = v2 + 3 * CW;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int cc = 32 * hc + 8 * jj + 2 * t;
    const float2 rc = ld2(rc3 + cc), gk = ld2(gi2 + cc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + g + 8 * h;
      const float2 qv = unpack_bf16(ld32(Q3 + r * LDB + cc));
      const uint32_t mb = m2 >> (4 * jj + 2 * h);
      const float2 hm =
          unpack_bf16(pack_bf16(c[jj][2 * h], c[jj][2 * h + 1]));
      const float dx =
          (mb & 1u) ? __fsub_rn(__fsub_rn(qv.x, hm.x), rc.x) : 0.f;
      const float dy =
          (mb & 2u) ? __fsub_rn(__fsub_rn(qv.y, hm.y), rc.y) : 0.f;
      const uint32_t d = pack_bf16(dx, dy);
      st32(Q3 + r * LDB + cc, d);
      const float2 dd = unpack_bf16(d);
      st32(DG + r * LDB + cc,
           pack_bf16(__fmul_rn(dd.x, gk.x), __fmul_rn(dd.y, gk.y)));
    }
  }
  named_sync(1 + (warp >> 1), 64);     // the pair: DG's rows whole, p2
                                       // read by both
  // q2 = bf16(dy2 gi2) bf16(W2)^T at this half's n-tiles; mq = m1 bf16(q2)
  // over p2.
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) zero4(c[jj]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    ldsm4(a, a_rows_at(DG, rw, 16 * kk, lane));
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t b[4];
      ldsm4(b, b_cols_at(W2s, 32 * hc + 16 * p, 16 * kk, lane));
      mma_bf16(c[2 * p], a, b[0], b[1]);
      mma_bf16(c[2 * p + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st32(P2 + (rw + g + 8 * h) * LDB + 32 * hc + 8 * jj + 2 * t,
           pack_bf16(c[jj][2 * h], c[jj][2 * h + 1]) &
               keep_halves(m1 >> (4 * jj + 2 * h)));
}

// U1_i += (m1 x_i)^T h1 for one k16 step from row k0: am is m1^T's A
// fragment as masks, X the staged x (channel-major).
template <int C0>
__device__ __forceinline__ void s2f_u1(S2FAcc<C0>& A, const uint32_t am[4],
                                       const uint32_t bh[4],
                                       const __nv_bfloat16* X, int k0,
                                       int t) {
#pragma unroll
  for (int i = 0; i < C0; ++i) {
    const uint32_t x0 = ld32(X + i * S2F_XS + k0 + 2 * t);
    const uint32_t x1 = ld32(X + i * S2F_XS + k0 + 8 + 2 * t);
    const uint32_t a[4] = {am[0] & x0, am[1] & x0, am[2] & x1, am[3] & x1};
    mma_bf16(A.u[i][0], a, bh[0], bh[1]);
    mma_bf16(A.u[i][1], a, bh[2], bh[3]);
  }
}

// The n8 tile [x | 1] (column C0 the ones) of one k16 step from row k0:
// warps (m, 0) take dy2 and m1, (m, 1) h1 and mq, (0, 2) x.
template <int C0>
__device__ __forceinline__ void s2f_n8(S2FAcc<C0>& A, const uint32_t ad[4],
                                       const uint32_t at[4],
                                       const uint32_t ah[4],
                                       const __nv_bfloat16* S, int k0,
                                       int m, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if (n > 2 || (n == 2 && m != 0)) return;
  const __nv_bfloat16* X = S + S2F_X;
  const uint32_t bx0 = g < C0 ? ld32(X + g * S2F_XS + k0 + 2 * t)
                              : (g == C0 ? BF16_ONES : 0u);
  const uint32_t bx1 = g < C0 ? ld32(X + g * S2F_XS + k0 + 8 + 2 * t)
                              : (g == C0 ? BF16_ONES : 0u);
  if (n == 0) {
    mma_bf16(A.e[0], ad, bx0, bx1);
    mma_bf16(A.e[1], at, bx0, bx1);
  } else if (n == 1) {
    uint32_t aq[4];
    ldsm4t(aq, a_cols_at(S + S2F_P2, 16 * m, k0, lane));
    mma_bf16(A.e[0], ah, bx0, bx1);
    mma_bf16(A.e[1], aq, bx0, bx1);
  } else {
    const uint32_t ax[4] = {bx0, 0u, bx1, 0u};   // rows x_g, g < C0
    mma_bf16(A.e[0], ax, bx0, bx1);
  }
}

// The contraction over the step's rows (nk k16 steps) for warp (m, n).
template <int C0>
__device__ __forceinline__ void s2f_contract(S2FAcc<C0>& A,
                                             const __nv_bfloat16* S, int nk,
                                             int m, int n, int lane) {
  const int t = lane & 3;
  const __nv_bfloat16* H1 = S + S2F_H1;
  const __nv_bfloat16* DY = S + S2F_Q3;
  for (int kk = 0; kk < nk; ++kk) {
    const int k0 = 16 * kk;
    uint32_t bh[4], ad[4], ah[4], am[4], at[4];
    ldsm4t(bh, b_rows_at(H1, 16 * n, k0, lane));
    ldsm4t(ad, a_cols_at(DY, 16 * m, k0, lane));
    ldsm4t(ah, a_cols_at(H1, 16 * m, k0, lane));
    mma_bf16(A.a2[0], ad, bh[0], bh[1]);
    mma_bf16(A.a2[1], ad, bh[2], bh[3]);
    mma_bf16(A.g1[0], ah, bh[0], bh[1]);
    mma_bf16(A.g1[1], ah, bh[2], bh[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      am[q] = mask_of(ah[q]);
      at[q] = am[q] & BF16_ONES;
    }
    mma_bf16(A.tm[0], at, bh[0], bh[1]);
    mma_bf16(A.tm[1], at, bh[2], bh[3]);
    s2f_u1<C0>(A, am, bh, S + S2F_X, k0, t);
    s2f_n8<C0>(A, ad, at, ah, S, k0, m, n, lane);
  }
}

// The accumulators added to (first: written as) the block's float64
// partials, in the f32 kernel's layouts. Each batch of partials is read
// whole before any is written, so its loads are in flight together.
template <int C0>
__device__ __forceinline__ void s2f_flush(const S2FAcc<C0>& A, bool first,
                                          int m, int n, int lane,
                                          double* __restrict__ partM,
                                          double* __restrict__ partV,
                                          double* __restrict__ partX,
                                          double* __restrict__ partU) {
  const int g = lane >> 2, t = lane & 3;
  const int64_t b = blockIdx.x;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * m + g + 8 * h, j = 16 * n + 8 * nt + 2 * t;
      double2* p[3 + C0];
      const float* v[3 + C0];
      p[0] = reinterpret_cast<double2*>(partM + ((b * 2) * CW + c) * CW + j);
      p[1] = reinterpret_cast<double2*>(partM + ((b * 2 + 1) * CW + c) * CW +
                                        j);
      v[0] = A.a2[nt] + 2 * h;
      v[1] = A.g1[nt] + 2 * h;
#pragma unroll
      for (int i = 0; i <= C0; ++i) {     // TM1, then U1_i
        p[2 + i] = reinterpret_cast<double2*>(
            partU + ((b * (C0 + 1) + i) * CW + c) * CW + j);
        v[2 + i] = i == 0 ? A.tm[nt] + 2 * h : A.u[i - 1][nt] + 2 * h;
      }
      double2 o[3 + C0];
#pragma unroll
      for (int k = 0; k < 3 + C0; ++k)
        o[k] = first ? make_double2(0.0, 0.0) : *p[k];
#pragma unroll
      for (int k = 0; k < 3 + C0; ++k)
        *p[k] = make_double2(o[k].x + static_cast<double>(v[k][0]),
                             o[k].y + static_cast<double>(v[k][1]));
    }
  if (n > 2 || (n == 2 && m != 0)) return;
  // The n8 tile: a lane's four entries (rows c, columns k), each at most
  // two partials (e0's, e1's; nullptr where none).
  double* px = partX + b * (2 * CW * C0 + C0 * (C0 + 1));
  double* pv = partV + b * 4 * CW;
  double* p0[4];
  double* p1[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = 16 * m + g + 8 * (q >> 1), k = 2 * t + (q & 1);
    p0[q] = p1[q] = nullptr;
    if (k > C0) continue;
    if (n == 0) {                         // e0: dy2 (u2), e1: m1 (T1x, cnt1)
      p0[q] = k == C0 ? pv + c : nullptr;
      p1[q] = k == C0 ? pv + 2 * CW + c : px + c * C0 + k;
    } else if (n == 1) {                  // e0: h1 (ch1), e1: mq (P1, acc1)
      p0[q] = k == C0 ? pv + CW + c : nullptr;
      p1[q] = k == C0 ? pv + 3 * CW + c : px + CW * C0 + c * C0 + k;
    } else if (q < 2 && g < C0) {         // e0: x, rows x_g: Gx | cx
      p0[q] = px + 2 * CW * C0 + g * (C0 + 1) + k;
    }
  }
  double o0[4], o1[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o0[q] = first || !p0[q] ? 0.0 : *p0[q];
    o1[q] = first || !p1[q] ? 0.0 : *p1[q];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (p0[q]) *p0[q] = o0[q] + static_cast<double>(A.e[0][q]);
    if (p1[q]) *p1[q] = o1[q] + static_cast<double>(A.e[1][q]);
  }
}

// xmode: 0 x channel-major in 16-byte copies (N % 8 == 0, x 16-byte
// aligned), 1 x row-major (N == 1, aligned) copied as stored, 2 x read
// value by value.
template <int C0, bool FROM_X>
__global__ void __launch_bounds__(S2F_NT, 1)
bwd2_sweep2_bf16_kernel(const __nv_bfloat16* __restrict__ x, int64_t N,
                        int64_t R, int xmode,
                        const __nv_bfloat16* __restrict__ p1,
                        const float* __restrict__ W1,
                        const float* __restrict__ vec,
                        const __nv_bfloat16* __restrict__ p2,
                        const __nv_bfloat16* __restrict__ q3,
                        const float* __restrict__ M3,
                        const float* __restrict__ W2,
                        double* __restrict__ partM,
                        double* __restrict__ partV,
                        double* __restrict__ partX,
                        double* __restrict__ partU) {
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smb[];
  bf* stage = reinterpret_cast<bf*>(smb);        // S2F_STAGES x a stage
  bf* DG = stage + S2F_STAGES * S2F_STAGE;       // (128, LDB)
  bf* Ms = DG + S2F_TILE;                        // bf16(M3) [k][n]
  bf* W2s = Ms + CW * LDB;                       // bf16(W2) [n][k]
  float* W1s = reinterpret_cast<float*>(W2s + CW * LDB);   // C0MAX x CW
  // b1 | mul1 | shift1 | mul2 | shift2 | rc3 | gi2 (b1, gi2 rounded)
  float* v = W1s + C0MAX * CW;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t nsteps = (R + S2F_ROWS - 1) / S2F_ROWS;
  const int64_t count =
      nsteps > blockIdx.x ? (nsteps - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto row0 = [&](int64_t i) {
    return (blockIdx.x + i * gridDim.x) * S2F_ROWS;
  };
  auto fetch = [&](int64_t i) {   // every thread: its copies of step i
    if (i < count) {
      bf* S = stage + (i % S2F_STAGES) * S2F_STAGE;
      const int64_t r0 = row0(i);
      const int nr = R - r0 < S2F_ROWS ? static_cast<int>(R - r0) : S2F_ROWS;
      for (int e = threadIdx.x; e < nr * 8; e += S2F_NT) {
        const int r = e >> 3, c = (e & 7) << 3;
        const int64_t o = (r0 + r) * CW + c;
        cp_async16(S + S2F_P2 + r * LDB + c, p2 + o);
        cp_async16(S + S2F_Q3 + r * LDB + c, q3 + o);
        if (!FROM_X) cp_async16(S + S2F_H1 + r * LDB + c, p1 + o);
      }
      if (xmode == 0) {
        const int nc = nr >> 3;
        for (int e = threadIdx.x; e < C0 * nc; e += S2F_NT) {
          const int c = e / nc, j = e - c * nc;
          const int64_t r = r0 + 8 * j, b = r / N, n = r - b * N;
          cp_async16(S + S2F_X + c * S2F_XS + 8 * j,
                     x + (b * C0 + c) * N + n);
        }
      } else if (xmode == 1) {
        for (int e = threadIdx.x; e < nr * C0 / 8; e += S2F_NT)
          cp_async16(S + S2F_XR + 8 * e, x + r0 * C0 + 8 * e);
      } else {
        for (int e = threadIdx.x; e < C0 * nr; e += S2F_NT) {
          const int c = e / nr, j = e - c * nr;
          const int64_t r = r0 + j, b = r / N, n = r - b * N;
          S[S2F_X + c * S2F_XS + j] = x[(b * C0 + c) * N + n];
        }
      }
    }
    cp_async_commit();
  };

  fetch(0);
  for (int e = threadIdx.x; e < CW * CW; e += S2F_NT) {
    const int r = e >> 6, c = e & 63;
    Ms[r * LDB + c] = __float2bfloat16_rn(M3[e]);
    W2s[r * LDB + c] = __float2bfloat16_rn(W2[e]);
  }
  if (FROM_X)
    for (int e = threadIdx.x; e < C0 * CW; e += S2F_NT) W1s[e] = rb(W1[e]);
  for (int e = threadIdx.x; e < 7 * CW; e += S2F_NT)
    v[e] = e < CW || e >= 6 * CW ? rb(vec[e]) : vec[e];

  const int m = warp & 3, n = warp >> 2;      // the contraction's block
  auto nrows = [&](int64_t i) {
    const int64_t r0 = row0(i);
    return R - r0 < S2F_ROWS ? static_cast<int>(R - r0) : S2F_ROWS;
  };
  S2FAcc<C0> A;
  s2f_zero<C0>(A);
  bool first = true;
  // Step i's row chain and step i - 1's contraction share a phase (one
  // barrier a step) while step i + 1's copies are in flight. Warps 0-7
  // take the row chain first, warps 8-15 the contraction, so that one
  // half's products run beside the other half's row passes.
  auto rows = [&](int64_t i) {
    bf* S = stage + (i % S2F_STAGES) * S2F_STAGE;
    // A pair whose 16 rows lie past R (the last step's second half) skips
    // the row chain; the contraction reads the step's rows only.
    if (16 * (warp >> 1) >= nrows(i)) return;
    s2f_rows<C0, FROM_X>(S, xmode == 1, W1s, v, v + 3 * CW, Ms, W2s, DG,
                         warp, lane);
    if (xmode == 1 && (warp & 1) == 0)  // x channel-major for contract
      for (int e = lane; e < 16 * C0; e += 32) {
        const int r = 8 * warp + (e & 15), c = e >> 4;
        S[S2F_X + c * S2F_XS + r] = S[S2F_XR + r * C0 + c];
      }
  };
  auto contract = [&](int64_t j) {
    s2f_contract<C0>(A, stage + (j % S2F_STAGES) * S2F_STAGE, nrows(j) / 16,
                     m, n, lane);
    // Blocks flush at staggered steps, so that their float64 traffic does
    // not meet at device memory all at once.
    if ((j + 1 + blockIdx.x) % S2F_FLUSH == 0 || j + 1 == count) {
      s2f_flush<C0>(A, first, m, n, lane, partM, partV, partX, partU);
      s2f_zero<C0>(A);
      first = false;
    }
  };
  const bool rows_first = warp < 8;
  for (int64_t i = 0; i <= count; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i < count) fetch(i + 1);
    if (rows_first && i < count) rows(i);
    if (i > 0) contract(i - 1);
    if (!rows_first && i < count) rows(i);
  }
  if (count == 0)                       // a block with no step: zeros
    s2f_flush<C0>(A, true, m, n, lane, partM, partV, partX, partU);
}

// ---------------------------------------------------------------------
// B6 / B8b at f32 (facl_sa_bwd2_sweep2) on the TF32 tensor cores in
// 3xTF32, by wgmma. Replaces sa_bwd.py::_make_sweep2_kernel (:140,
// pallas_call :298; B8b, h1 from the stored p1) and
// sa_pair.py::_make_sweep2_pair_kernel (:333, pallas_call :863; B6, h1
// from x) at compute_dtype float32 (the twins: ops/sa_bwd.py::
// _sweep2_plain and _sweep2_sums). h2 = relu(p2 mul2 + shift2); dy2 =
// [h2 > 0] (q3 - h2 M3 - rc3); q2 = dy2 (gi2 W2^T) (gi2 folded into W2
// once a block, as B3b does); h1 = relu(p1 mul1 + shift1) (B8b) or h1_pair's
// k-order chain from x (B6), so that the layer-1 masks m1 = [h1 > 0], and
// with them cnt1, are the forward's bit for bit; mq = m1 q2. Per block,
// the TPU kernels' packed left^T right (sa_bwd.py:172-185), as the bf16
// form: [dy2 | h1 | m1 | m1 x_i]^T h1 (A2, G1, TM1, U1_i) and [dy2 | m1 |
// h1 | mq | x]^T [x | 1] (u2, T1x, cnt1, ch1, P1, acc1, Gx, cx), into
// the same partials (s2t_flush).
//
// Bound on the card at the main path: 1.12-1.14 ms by operations (69,696
// product flops a row at C0 = 4, plus the n8 tile's, in three TF32 passes
// at 495 TFLOP/s, or two where an operand is exact, and ~0.04 ms of
// CUDA-core passes); 2.8 ms on f32 CUDA cores. One 512-thread block an
// SM (four warpgroups) walks 64-row steps in two stages of padded f32
// tiles (stride LDT, sa_mma.cuh: the row-major float2 reads and the
// transposed single reads are both free of bank conflicts), filled by
// cp.async (16-byte copies, 4-byte ones for a tensor that is not 16-byte
// aligned) while the step before runs. A step is two phases between block
// barriers: its row chain, then its contraction.
//  - the row chain (s2t_rows): warp w takes rows 16 (w % 4).. and columns
//    16 (w / 4).. of h1, h2, dy2 and mq in the C fragments' places, and
//    splits x and [x | 1] of its rows for the contraction. It writes h1
//    split into the core-layout tiles the contraction's wgmmas read (h1
//    from p1, or B6: from x) and h2 over p2; after the four warps of its
//    rows meet at a named barrier, warpgroup w / 4 runs h2 M3 at its
//    columns on wgmma m64n16k8 (A: h2's fragments of each warp's rows,
//    split as they load; B: M3 split once a block), and the warp writes
//    dy2 over the q3 it read; after a second named barrier, q2 = dy2 (gi2
//    W2^T) the same way, and mq over h2. Both products chain their eight
//    k8 steps in the tensor cores, as B3b's do.
//  - the contraction over the step's 64 rows (s2t_contract): warpgroup W
//    owns whole 64 x 64 products (S2TG: kinds W, W + 4, .. of A2, G1, TM1,
//    U1_i; at C0 = 4 two each, one for warpgroup 3), their accumulators in
//    wgmma's layout, 32 values a thread each. Each k8 step of rows and
//    n chunk of S2T_NH columns is one wgmma m64nS2T_NHk8 a pass, A from
//    registers (dy2^T split as it loads; h1^T from its split tiles; m1,
//    exact in TF32, two passes; m1 x_i, x_i's split anded with the mask),
//    B = h1 from its split tiles; the n8 tile [x | 1] rides as one more
//    n8 chunk of warpgroups 0-2's first products (dy2 and h1 against the
//    ones column alone, two passes) and as warpgroup 3's mq and x. Each k8
//    step is summed on its own and added round-to-nearest: the tensor
//    cores' own adds truncate, and chained over every row of a flush their
//    bias would pull the sums away from the twin's (a chained form put G1
//    3.8e-5 of its max-abs off the twin: chip_ablate.py b8b_f32 on an
//    H100, PERF.md).
// Operands split by tf32_mma.cuh's split, as every f32 tensor-core
// product of the port is (hi and lo each rounded to TF32). The f32 sums
// ride in registers for S2T_FLUSH steps, then are added to the block's
// float64 partials (each partial owned by one thread: no atomics, a fixed
// order, run to run bit-identical). 229,120 bytes of shared memory (S2T_SMEM).
constexpr int S2T_NT = 512;
constexpr int S2T_FLUSH = 128;                 // steps between float64 adds
constexpr int S2T_XS = TR + 8;                 // x's channel stride
constexpr int S2T_XP = 2 * TR + 8;             // x split's channel stride
// A stage (floats): p2 (then h2, then mq) | q3 (then dy2) | p1, each (TR,
// LDT) | x channel-major (C0MAX, S2T_XS), or row-major (TR, C0) as stored
// when N == 1. Two stages, then (floats, from a 1024-byte boundary): h1
// split, hi then lo, each (CW, TR) in wgmma's K-major core layout
// (s2t_core); [x | 1] split likewise, (8, TR) each; the ones column
// alone, (8, TR); x split (C0MAX, S2T_XP), (hi, lo) of row r at 2 r; M3
// and gi2 W2^T split, hi then lo, each (CW, CW) in the core layout with
// its k permuted (s2t_kslot); W1; vec.
constexpr int S2T_P2 = 0, S2T_Q3 = TILE_F, S2T_P1 = 2 * TILE_F;
constexpr int S2T_X = 3 * TILE_F;
constexpr int S2T_STAGE = S2T_X + C0MAX * S2T_XS;
constexpr int S2T_H1H = (2 * S2T_STAGE + 255) / 256 * 256;
constexpr int S2T_H1L = S2T_H1H + CW * TR;
constexpr int S2T_XBH = S2T_H1L + CW * TR;
constexpr int S2T_XBL = S2T_XBH + 8 * TR;
constexpr int S2T_ONE = S2T_XBL + 8 * TR;
constexpr int S2T_XSP = S2T_ONE + 8 * TR;
constexpr int S2T_MH = (S2T_XSP + C0MAX * S2T_XP + 255) / 256 * 256;
constexpr int S2T_ML = S2T_MH + CW * CW;
constexpr int S2T_WH = S2T_ML + CW * CW;
constexpr int S2T_WL = S2T_WH + CW * CW;
constexpr int S2T_W1 = S2T_WL + CW * CW;
constexpr int S2T_V = S2T_W1 + C0MAX * CW;
constexpr size_t S2T_SMEM = sizeof(float) * (S2T_V + 7 * CW);
constexpr uint32_t TF32_ONE = 0x3f800000u;

// 4-byte asynchronous copy global -> shared (a tensor that is not 16-byte
// aligned), in the thread's cp.async groups.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Element (n, k) of a K-major (n, TR) tf32 wgmma operand without swizzle:
// core matrices of 8 n and 4 k (128 contiguous bytes), the next 4 k at
// +128 bytes (LBO), the next 8 n at +TR / 4 x 128 bytes (SBO).
__device__ __forceinline__ int s2t_core(int n, int k) {
  return ((n >> 3) * (TR / 4) + (k >> 2)) * 32 + (n & 7) * 4 + (k & 3);
}
constexpr uint32_t S2T_LBO = 128, S2T_SBO = TR / 4 * 128;

// d (+)= a b for the warpgroup: A (64 x 8, tf32) in registers, each warp
// its 16 rows in mma.sync's m16n8k8 A layout; B (8 x 64) by descriptor;
// d in mma.sync's C layout, n-tile j in d[4 j ..]; acc 0: d = a b.
__device__ __forceinline__ void s2t_wg64(float (&d)[32], const uint32_t a[4],
                                         uint64_t bdesc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(acc));
}

// The same for a (8 x 32) B: d (64 x 32), n-tile j in d[4 j ..].
__device__ __forceinline__ void s2t_wg32(float (&d)[16], const uint32_t a[4],
                                         uint64_t bdesc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(acc));
}

// The same for a (8 x 16) B: d (64 x 16).
__device__ __forceinline__ void s2t_wg16(float (&d)[8], const uint32_t a[4],
                                         uint64_t bdesc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(acc));
}

// The same for an (8 x 8) B: d (64 x 8).
__device__ __forceinline__ void s2t_wg8(float (&d)[4], const uint32_t a[4],
                                        uint64_t bdesc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(acc));
}

// An A fragment in its two pieces: hi[4], lo[4].
struct S2TA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ S2TA s2t_a(float v0, float v1, float v2,
                                      float v3) {
  const Split a = split(v0), b = split(v1), c = split(v2),
              d = split(v3);
  return S2TA{{a.hi, b.hi, c.hi, d.hi}, {a.lo, b.lo, c.lo, d.lo}};
}

// One wgmma pass of a chunk of N accumulator values a thread.
template <int N>
__device__ __forceinline__ void s2t_pass(float (&st)[N], const uint32_t a[4],
                                         uint64_t b, int acc) {
  if constexpr (N == 32)
    s2t_wg64(st, a, b, acc);
  else if constexpr (N == 16)
    s2t_wg32(st, a, b, acc);
  else if constexpr (N == 8)
    s2t_wg16(st, a, b, acc);
  else
    s2t_wg8(st, a, b, acc);
}

// c (N values a thread) += the k8 step of a b in 3xTF32, st its scratch:
// lo hi' + hi lo' + hi hi' summed on their own, then added round-to-
// nearest; exact_a (m1's ones) or exact_b (the ones column): two passes.
template <int N>
__device__ __forceinline__ void s2t_step(float* c, float (&st)[N],
                                         const S2TA& a, uint64_t bh,
                                         uint64_t bl, bool exact_a,
                                         bool exact_b) {
  wgmma_fence();
  if (exact_a) {
    s2t_pass(st, a.hi, bl, 0);
    s2t_pass(st, a.hi, bh, 1);
  } else if (exact_b) {
    s2t_pass(st, a.lo, bh, 0);
    s2t_pass(st, a.hi, bh, 1);
  } else {
    s2t_pass(st, a.lo, bh, 0);
    s2t_pass(st, a.hi, bl, 1);
    s2t_pass(st, a.hi, bh, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int q = 0; q < N; ++q) {
    pin(st[q]);
    c[q] = __fadd_rn(c[q], st[q]);
  }
}

// x_c of staged row r (channel-major, or row-major as stored).
template <int C0>
__device__ __forceinline__ float s2t_x(const float* S, bool rowx, int c,
                                       int r) {
  return rowx ? S[S2T_X + r * C0 + c] : S[S2T_X + c * S2T_XS + r];
}

// x_c of row r, split (the row chain's copy).
__device__ __forceinline__ Split s2t_xs(const float* sm, int c, int r) {
  const float2 u = ld2(sm + S2T_XSP + c * S2T_XP + 2 * r);
  return Split{__float_as_uint(u.x), __float_as_uint(u.y)};
}

// The k slot of channel k in the row chain's B tiles: an A fragment's
// float2 (row g, channels 8 kk + 2t, + 1) fills its k slots t and t + 4,
// so the B operand holds channel 8 kk + 2t + j at slot 8 kk + t + 4 j.
__device__ __forceinline__ int s2t_kslot(int k) {
  return (k & ~7) + ((k & 7) >> 1) + 4 * (k & 1);
}

// One 64 x 64 row product of the warpgroup at its columns 16 q..: c (64 x
// 16, mma.sync's C layout) = rows (X, stride LDT, warp v's rows rw..) B,
// B split in the core tiles bh, bl (k permuted): eight k8 steps chained
// in the tensor cores, three passes each (as B3b's mma3 chain), each step
// waited for before its A registers are rebuilt.
__device__ __forceinline__ void s2t_rowprod(float (&c)[8], const float* X,
                                            int rw, const float* bh,
                                            const float* bl, int q,
                                            int lane) {
  const uint64_t dh =
      wgmma_desc(bh, S2T_LBO, S2T_SBO) + 2 * q * (S2T_SBO >> 4);
  const uint64_t dl =
      wgmma_desc(bl, S2T_LBO, S2T_SBO) + 2 * q * (S2T_SBO >> 4);
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = 0.f;
#pragma unroll 1
  for (int kb = 0; kb < 8; ++kb) {
    const RawA r = raw_a_rows(X, rw, kb, lane);
    const S2TA a = s2t_a(r.v[0], r.v[1], r.v[2], r.v[3]);
    wgmma_fence();
    s2t_wg16(c, a.lo, dh + 16 * kb, kb > 0);
    s2t_wg16(c, a.hi, dl + 16 * kb, 1);
    s2t_wg16(c, a.hi, dh + 16 * kb, 1);
    wgmma_commit();
    wgmma_wait_all();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) pin(c[i]);
}

// The mask bits of two values at a C fragment's row half hh: bit 2 hh + e.
__device__ __forceinline__ uint32_t s2t_bits(float2 h, int hh) {
  return ((h.x > 0.f ? 1u : 0u) | (h.y > 0.f ? 2u : 0u)) << (2 * hh);
}

// h1 split into the core-layout tiles at rows r, r (+ 1 column).
__device__ __forceinline__ void s2t_put_h1(float* sm, int col, int r,
                                           float2 h) {
  const Split a = split(h.x), b = split(h.y);
  sm[S2T_H1H + s2t_core(col, r)] = __uint_as_float(a.hi);
  sm[S2T_H1L + s2t_core(col, r)] = __uint_as_float(a.lo);
  sm[S2T_H1H + s2t_core(col + 1, r)] = __uint_as_float(b.hi);
  sm[S2T_H1L + s2t_core(col + 1, r)] = __uint_as_float(b.lo);
}

// The row chain of one warp on the step staged at S (module comment); sm
// the block's shared memory (the contraction's operands). Masks: bit 4 nj
// + 2 hh + e for the value c[nj][2 hh + e].
template <int C0, bool FROM_X>
__device__ __forceinline__ void s2t_rows(float* S, float* sm, bool rowx,
                                         int warp, int lane) {
  const float* W1s = sm + S2T_W1;
  const float* v = sm + S2T_V;
  const int g = lane >> 2, t = lane & 3;
  // rows 16 sl.. (the four warps sharing them meet at named barrier 1 +
  // sl), columns 16 q.. (warpgroup q runs their products on wgmma)
  const int sl = warp & 3, q = warp >> 2, rw = 16 * sl;
  float* Q3 = S + S2T_Q3;
  float* P2 = S + S2T_P2;
  {   // x of the warp's 16 rows split: x_c, and [x | 1]'s column c
    const int e = 32 * q + lane, r = rw + (e & 15), cx = e >> 4;
    const float xv = cx < C0 ? s2t_x<C0>(S, rowx, cx, r)
                             : (cx == C0 ? 1.f : 0.f);
    const Split s = split(xv);
    if (cx < C0)
      st2r(sm + S2T_XSP + cx * S2T_XP + 2 * r,
           make_float2(__uint_as_float(s.hi), __uint_as_float(s.lo)));
    sm[S2T_XBH + s2t_core(cx, r)] = __uint_as_float(s.hi);
    sm[S2T_XBL + s2t_core(cx, r)] = __uint_as_float(s.lo);
  }
  uint32_t m1 = 0, m2 = 0;
  if constexpr (FROM_X) {               // the forward's chain, h1_pair
    float xa[C0MAX - 1], xb[C0MAX - 1];
#pragma unroll
    for (int k = 0; k < C0; ++k) {
      xa[k] = s2t_x<C0>(S, rowx, k, rw + g);
      xb[k] = s2t_x<C0>(S, rowx, k, rw + g + 8);
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const int col = 16 * q + 8 * nj + 2 * t;
      float2 ha, hb;
      h1_pair<false>(xa, xb, C0, W1s, v, col, ha, hb);
      s2t_put_h1(sm, col, rw + g, ha);
      s2t_put_h1(sm, col, rw + g + 8, hb);
      m1 |= (s2t_bits(ha, 0) | s2t_bits(hb, 1)) << (4 * nj);
    }
  }
  // h1 = relu(p1 mul1 + shift1) (B8b) and h2 = relu(p2 mul2 + shift2)
  // over p2, at this warp's columns, and their masks.
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const int col = 16 * q + 8 * nj + 2 * t;
    const float2 mu2 = ld2(v + 3 * CW + col), sh2 = ld2(v + 4 * CW + col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int o = (rw + g + 8 * hh) * LDT + col;
      if constexpr (!FROM_X) {
        const float2 mu1 = ld2(v + CW + col), sh1 = ld2(v + 2 * CW + col);
        const float2 p = ld2(S + S2T_P1 + o);
        const float2 h = make_float2(relu_affine(p.x, mu1.x, sh1.x),
                                     relu_affine(p.y, mu1.y, sh1.y));
        s2t_put_h1(sm, col, rw + g + 8 * hh, h);
        m1 |= s2t_bits(h, hh) << (4 * nj);
      }
      const float2 p = ld2(P2 + o);
      const float2 h = make_float2(relu_affine(p.x, mu2.x, sh2.x),
                                   relu_affine(p.y, mu2.y, sh2.y));
      st2r(P2 + o, h);
      m2 |= s2t_bits(h, hh) << (4 * nj);
    }
  }
  named_sync(1 + sl, 128);              // the rows' h2 whole
  // h2 M3 at this warp's columns, h2's A fragments of all 64 channels
  // (k8 step kb pairs channels 8 kb + 2t, + 1).
  float c[8];
  s2t_rowprod(c, P2, rw, sm + S2T_MH, sm + S2T_ML, q, lane);
  // dy2 = [h2 > 0] (q3 - h2 M3 - rc3) over q3.
  const float* rc3 = v + 5 * CW;
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const int cc = 16 * q + 8 * nj + 2 * t;
    const float2 rc = ld2(rc3 + cc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* at = Q3 + (rw + g + 8 * hh) * LDT + cc;
      const float2 qv = ld2(at);
      const uint32_t mb = m2 >> (4 * nj + 2 * hh);
      const float* hm = c + 4 * nj + 2 * hh;
      st2r(at, make_float2(
                   (mb & 1u) ? __fsub_rn(__fsub_rn(qv.x, hm[0]), rc.x) : 0.f,
                   (mb & 2u) ? __fsub_rn(__fsub_rn(qv.y, hm[1]), rc.y)
                             : 0.f));
    }
  }
  named_sync(1 + sl, 128);              // the rows' dy2 whole, h2 read
  // q2 = dy2 (gi2 W2^T) at this warp's columns; mq = m1 q2 over h2.
  s2t_rowprod(c, Q3, rw, sm + S2T_WH, sm + S2T_WL, q, lane);
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t mb = m1 >> (4 * nj + 2 * hh);
      const float* qq = c + 4 * nj + 2 * hh;
      st2r(P2 + (rw + g + 8 * hh) * LDT + 16 * q + 8 * nj + 2 * t,
           make_float2((mb & 1u) ? qq[0] : 0.f, (mb & 2u) ? qq[1] : 0.f));
    }
  fence_async_smem();                   // h1, [x | 1]: read by wgmma
}

// A product's 64 columns in chunks of S2T_NH (one wgmma m64nS2T_NHk8 a
// pass each; a chunk's scratch S2T_NH / 2 values a thread).
constexpr int S2T_NH = 32;
constexpr int S2T_NC = CW / S2T_NH;

// The products of warpgroup W: kinds p = W, W + 4, .. < C0 + 3 (0 A2, 1
// G1, 2 TM1, 3 + i U1_i), each a 64 x 64 accumulator over the group (32
// values a thread). The n8 tile [x | 1]: warpgroups 0-2 run their first
// product's left operand against one more n8 chunk (e8[0]: dy2 and h1
// against the ones column alone, u2 and ch1; m1 against [x | 1], T1x and
// cnt1); warpgroup 3 (the fewest products) the other two (e8[0]: mq, P1
// and acc1; e8[1]: x, Gx and cx).
template <int C0, int W>
struct S2TG {
  static constexpr int NP = (C0 + 3 - W + 3) / 4;
  float acc[NP][32];
  float e8[W == 3 ? 2 : 1][4];
};

template <int C0, int W>
__device__ __forceinline__ void s2t_zero(S2TG<C0, W>& A) {
#pragma unroll
  for (int p = 0; p < S2TG<C0, W>::NP; ++p)
#pragma unroll
    for (int q = 0; q < 32; ++q) A.acc[p][q] = 0.f;
#pragma unroll
  for (int u = 0; u < (W == 3 ? 2 : 1); ++u) zero4(A.e8[u]);
}

// The contraction over the step's rows (eight k8 steps) for warpgroup W,
// its warp v (rows 16 v.. of every product).
template <int C0, int W>
__device__ __forceinline__ void s2t_contract(S2TG<C0, W>& A, const float* S,
                                             const float* sm, int v,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int c = 16 * v + g;             // the fragment's rows c, c + 8
  const uint64_t dh = wgmma_desc(sm + S2T_H1H, S2T_LBO, S2T_SBO);
  const uint64_t dl = wgmma_desc(sm + S2T_H1L, S2T_LBO, S2T_SBO);
  const uint64_t xh = wgmma_desc(sm + S2T_XBH, S2T_LBO, S2T_SBO);
  const uint64_t xl = wgmma_desc(sm + S2T_XBL, S2T_LBO, S2T_SBO);
  const uint64_t one = wgmma_desc(sm + S2T_ONE, S2T_LBO, S2T_SBO);
  float st[S2T_NH / 2], s8[4];          // the k8 steps' sums (scratch)
#pragma unroll
  for (int q = 0; q < S2T_NH / 2; ++q) st[q] = 0.f;
  zero4(s8);
#pragma unroll 1
  for (int kk = 0; kk < TR / 8; ++kk) {
    const int ra = 8 * kk + t, rb = ra + 4;
    const int k0 = s2t_core(c, ra), k1 = s2t_core(c + 8, ra);
    const int k2 = s2t_core(c, rb), k3 = s2t_core(c + 8, rb);
    const float* H = sm + S2T_H1H;
    uint32_t am[4];                     // m1 = [h1 > 0] (hi > 0 there)
    am[0] = H[k0] > 0.f ? 0xffffffffu : 0u;
    am[1] = H[k1] > 0.f ? 0xffffffffu : 0u;
    am[2] = H[k2] > 0.f ? 0xffffffffu : 0u;
    am[3] = H[k3] > 0.f ? 0xffffffffu : 0u;
    const S2TA ones{{am[0] & TF32_ONE, am[1] & TF32_ONE, am[2] & TF32_ONE,
                     am[3] & TF32_ONE},
                    {0u, 0u, 0u, 0u}};
#pragma unroll
    for (int p = 0; p < S2TG<C0, W>::NP; ++p) {
      const int kind = W + 4 * p;
      S2TA a;
      if (kind == 0) {                  // A2: dy2^T
        const float* D = S + S2T_Q3;
        a = s2t_a(D[ra * LDT + c], D[ra * LDT + c + 8], D[rb * LDT + c],
                  D[rb * LDT + c + 8]);
      } else if (kind == 1) {           // G1: h1^T, split in the tiles
        const float* L = sm + S2T_H1L;
        a = S2TA{{__float_as_uint(H[k0]), __float_as_uint(H[k1]),
                  __float_as_uint(H[k2]), __float_as_uint(H[k3])},
                 {__float_as_uint(L[k0]), __float_as_uint(L[k1]),
                  __float_as_uint(L[k2]), __float_as_uint(L[k3])}};
      } else if (kind == 2) {           // TM1: m1
        a = ones;
      } else {                          // U1_i: m1 x_i
        const int i = kind - 3;
        const Split xa = s2t_xs(sm, i, ra), xb = s2t_xs(sm, i, rb);
        a = S2TA{{xa.hi & am[0], xa.hi & am[1], xb.hi & am[2],
                  xb.hi & am[3]},
                 {xa.lo & am[0], xa.lo & am[1], xb.lo & am[2],
                  xb.lo & am[3]}};
      }
#pragma unroll
      for (int h = 0; h < S2T_NC; ++h) {  // n chunk h: + S2T_NH / 8 SBOs
        const uint64_t o = 16 * kk + h * (S2T_NH / 8) * (S2T_SBO >> 4);
        s2t_step(A.acc[p] + h * (S2T_NH / 2), st, a, dh + o, dl + o,
                 kind == 2, false);
      }
      if (kind == 2)                    // m1^T [x | 1]
        s2t_step(A.e8[0], s8, a, xh + 16 * kk, xl + 16 * kk, true, false);
      else if (kind < 2)                // dy2^T 1, h1^T 1
        s2t_step(A.e8[0], s8, a, one + 16 * kk, one + 16 * kk, false, true);
    }
    if constexpr (W == 3) {             // the n8 tile: mq, x
      const uint64_t yh = xh + 16 * kk, yl = xl + 16 * kk;
      const float* Q = S + S2T_P2;
      s2t_step(A.e8[0], s8, s2t_a(Q[ra * LDT + c], Q[ra * LDT + c + 8],
                                  Q[rb * LDT + c], Q[rb * LDT + c + 8]),
               yh, yl, false, false);
      // x^T: rows x_c (c < C0: warp 0's first rows), others zero.
      const bool xr = c < C0;
      const Split xa = s2t_xs(sm, xr ? c : 0, ra);
      const Split xb = s2t_xs(sm, xr ? c : 0, rb);
      const S2TA ax{{xr ? xa.hi : 0u, 0u, xr ? xb.hi : 0u, 0u},
                    {xr ? xa.lo : 0u, 0u, xr ? xb.lo : 0u, 0u}};
      s2t_step(A.e8[1], s8, ax, yh, yl, false, false);
    }
  }
}

// Warpgroup W's accumulators added to (first: written as) the block's
// float64 partials, in the bf16 form's layouts (s2f_flush).
template <int C0, int W>
__device__ __forceinline__ void s2t_flush(const S2TG<C0, W>& A, bool first,
                                          int v, int lane,
                                          double* __restrict__ partM,
                                          double* __restrict__ partV,
                                          double* __restrict__ partX,
                                          double* __restrict__ partU) {
  const int g = lane >> 2, t = lane & 3;
  const int64_t b = blockIdx.x;
#pragma unroll
  for (int p = 0; p < S2TG<C0, W>::NP; ++p) {
    const int kind = W + 4 * p;
    double* base = kind < 2 ? partM + (b * 2 + kind) * CW * CW
                            : partU + (b * (C0 + 1) + kind - 2) * CW * CW;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * v + g + 8 * h;
      double2* pp = reinterpret_cast<double2*>(base + c * CW + 2 * t);
      double2 o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = first ? make_double2(0.0, 0.0) : pp[4 * j];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pp[4 * j] = make_double2(
            o[j].x + static_cast<double>(A.acc[p][4 * j + 2 * h]),
            o[j].y + static_cast<double>(A.acc[p][4 * j + 2 * h + 1]));
    }
  }
  {
    double* px = partX + b * (2 * CW * C0 + C0 * (C0 + 1));
    double* pv = partV + b * 4 * CW;
#pragma unroll
    for (int s = 0; s < (W == 3 ? 2 : 1); ++s) {
      const int u = W == 3 ? 3 + s : W;   // 0 dy2, 1 h1, 2 m1, 3 mq, 4 x
      double* pp[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 16 * v + g + 8 * (q >> 1), k = 2 * t + (q & 1);
        pp[q] = nullptr;
        if (u == 4) {
          if (c < C0 && k <= C0) pp[q] = px + 2 * CW * C0 + c * (C0 + 1) + k;
        } else if (k == C0) {           // u2 | ch1 | cnt1 | acc1
          pp[q] = pv + (u == 0 ? 0 : u == 1 ? 1 : u == 2 ? 2 : 3) * CW + c;
        } else if (k < C0 && u >= 2) {  // T1x | P1
          pp[q] = px + (u == 3 ? CW * C0 : 0) + c * C0 + k;
        }
      }
      double oo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) oo[q] = first || !pp[q] ? 0.0 : *pp[q];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (pp[q]) *pp[q] = oo[q] + static_cast<double>(A.e8[s][q]);
    }
  }
}

// The step loop of warpgroup W (every warp runs the row chain; the
// barriers are the block's).
template <int C0, bool FROM_X, int W, typename Fetch>
__device__ __forceinline__ void s2t_loop(float* sm, int64_t count,
                                         bool rowx, int warp, int lane,
                                         Fetch&& fetch,
                                         double* __restrict__ partM,
                                         double* __restrict__ partV,
                                         double* __restrict__ partX,
                                         double* __restrict__ partU) {
  S2TG<C0, W> A;
  s2t_zero<C0, W>(A);
  const int v = warp & 3;
  bool first = true;
  // Two stages: step i + 1's copies fly while step i's row chain, then
  // its contraction, run (two block barriers a step).
  for (int64_t i = 0; i < count; ++i) {
    float* S = sm + (i & 1) * S2T_STAGE;
    cp_async_wait<0>();
    __syncthreads();                    // step i in; step i - 1 contracted
    fetch(i + 1);                       // the next step's copies
    s2t_rows<C0, FROM_X>(S, sm, rowx, warp, lane);
    __syncthreads();                    // the contraction's operands whole
    s2t_contract<C0, W>(A, S, sm, v, lane);
    // Blocks flush at staggered steps, so that their float64 traffic does
    // not meet at device memory all at once.
    if ((i + 1 + blockIdx.x) % S2T_FLUSH == 0 || i + 1 == count) {
      s2t_flush<C0, W>(A, first, v, lane, partM, partV, partX, partU);
      s2t_zero<C0, W>(A);
      first = false;
    }
  }
  if (count == 0)                       // a block with no step: zeros
    s2t_flush<C0, W>(A, true, v, lane, partM, partV, partX, partU);
}

// xmode: 0 x channel-major in 16-byte copies (N % 4 == 0, x 16-byte
// aligned), 1 x row-major (N == 1, aligned) copied as stored, 2 x value
// by value. a16: bit 0 p2, bit 1 q3, bit 2 p1 16-byte aligned (else their
// rows arrive by 4-byte copies).
template <int C0, bool FROM_X>
__global__ void __launch_bounds__(S2T_NT, 1)
bwd2_sweep2_tf32_kernel(const float* __restrict__ x, int64_t N, int64_t R,
                        int xmode, int a16, const float* __restrict__ p1,
                        const float* __restrict__ W1,
                        const float* __restrict__ vec,
                        const float* __restrict__ p2,
                        const float* __restrict__ q3,
                        const float* __restrict__ M3,
                        const float* __restrict__ W2,
                        double* __restrict__ partM,
                        double* __restrict__ partV,
                        double* __restrict__ partX,
                        double* __restrict__ partU) {
  extern __shared__ __align__(1024) float smw[];
  float* sm = smw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t nsteps = R / TR;
  const int64_t count =
      nsteps > blockIdx.x ? (nsteps - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto row0 = [&](int64_t i) { return (blockIdx.x + i * gridDim.x) * TR; };
  auto tile = [&](float* dst, const float* src, bool al) {   // (TR, CW)
    if (al) {
      for (int e = threadIdx.x; e < TR * CW / 4; e += S2T_NT) {
        const int r = e >> 4, cc = (e & 15) << 2;
        cp_async16(dst + r * LDT + cc, src + r * CW + cc);
      }
    } else {
      for (int e = threadIdx.x; e < TR * CW; e += S2T_NT)
        cp_async4(dst + (e >> 6) * LDT + (e & 63), src + e);
    }
  };
  auto fetch = [&](int64_t i) {   // every thread: its copies of step i
    if (i < count) {
      float* S = sm + (i & 1) * S2T_STAGE;
      const int64_t r0 = row0(i);
      tile(S + S2T_P2, p2 + r0 * CW, a16 & 1);
      tile(S + S2T_Q3, q3 + r0 * CW, a16 & 2);
      if (!FROM_X) tile(S + S2T_P1, p1 + r0 * CW, a16 & 4);
      if (xmode == 0) {
        for (int e = threadIdx.x; e < C0 * TR / 4; e += S2T_NT) {
          const int cx = e / (TR / 4), j = e % (TR / 4);
          const int64_t r = r0 + 4 * j, b = r / N, nn = r - b * N;
          cp_async16(S + S2T_X + cx * S2T_XS + 4 * j,
                     x + (b * C0 + cx) * N + nn);
        }
      } else if (xmode == 1) {
        for (int e = threadIdx.x; e < TR * C0 / 4; e += S2T_NT)
          cp_async16(S + S2T_X + 4 * e, x + r0 * C0 + 4 * e);
      } else {
        for (int e = threadIdx.x; e < C0 * TR; e += S2T_NT) {
          const int cx = e / TR, j = e % TR;
          const int64_t r = r0 + j, b = r / N, nn = r - b * N;
          cp_async4(S + S2T_X + cx * S2T_XS + j, x + (b * C0 + cx) * N + nn);
        }
      }
    }
    cp_async_commit();
  };

  fetch(0);
  for (int e = threadIdx.x; e < CW * CW; e += S2T_NT) {   // M3, gi2 W2^T
    const int k = e >> 6, nn = e & 63;
    const int i = s2t_core(nn, s2t_kslot(k));
    const Split m = split(M3[k * CW + nn]);
    const Split w = split(__fmul_rn(vec[6 * CW + k], W2[nn * CW + k]));
    sm[S2T_MH + i] = __uint_as_float(m.hi);
    sm[S2T_ML + i] = __uint_as_float(m.lo);
    sm[S2T_WH + i] = __uint_as_float(w.hi);
    sm[S2T_WL + i] = __uint_as_float(w.lo);
  }
  for (int e = threadIdx.x; e < 8 * TR; e += S2T_NT)       // the ones column
    sm[S2T_ONE + s2t_core(e / TR, e % TR)] = e / TR == C0 ? 1.f : 0.f;
  if (FROM_X)
    for (int e = threadIdx.x; e < C0 * CW; e += S2T_NT) sm[S2T_W1 + e] = W1[e];
  for (int e = threadIdx.x; e < 7 * CW; e += S2T_NT) sm[S2T_V + e] = vec[e];
  fence_async_smem();

  const bool rowx = xmode == 1;
  switch (warp >> 2) {
    case 0:
      s2t_loop<C0, FROM_X, 0>(sm, count, rowx, warp, lane, fetch, partM,
                              partV, partX, partU);
      break;
    case 1:
      s2t_loop<C0, FROM_X, 1>(sm, count, rowx, warp, lane, fetch, partM,
                              partV, partX, partU);
      break;
    case 2:
      s2t_loop<C0, FROM_X, 2>(sm, count, rowx, warp, lane, fetch, partM,
                              partV, partX, partU);
      break;
    default:
      s2t_loop<C0, FROM_X, 3>(sm, count, rowx, warp, lane, fetch, partM,
                              partV, partX, partU);
  }
}

// ---------------------------------------------------------------------
// B7c (facl_sa_fwd_pool, facl_sa_fwd_pool_bf16) on the tensor cores.
// Replaces sa_fwd.py::_make_pool_sweep (:117, pallas_call :242): h2 =
// relu(p2 mul2 + shift2), z = (h2 W3 + b3) mul3 + shift3, and the max of
// relu(z) over each group of `pool` consecutive rows, (R / pool, 256);
// only the pooled rows reach device memory (the twin: ops/sa_fwd.py::
// sa_fwd_pool_plain). At BF h2 = relu(bf16(p2 mul2 + shift2)), p3 =
// bf16(h2 bf16(W3)) + bf16(b3) in f32, z in f32 rounded to bf16 before
// the ReLU, pooled stored bf16 (sa_fwd_pool_bf16_plain).
//
// Bound on the card at the main path: by operations, the 64 x 256
// product (85.9 GFLOP) and the CUDA-core passes (h2 a row, a max a p3,
// the affine a group): 0.108 ms at bf16, 0.539 ms in 3xTF32 (1.30 ms on
// f32 CUDA cores); reading p2 takes 0.106 / 0.213 ms. One kernel,
// fwd_pool_kernel<BF, LP>, one 512-thread block an SM. p2 tiles arrive
// by TMA (one bulk copy a 64-row tile, P7::STAGES in flight; p2 16-byte
// aligned, which the wrapper checks); all threads turn a tile into h2
// in one of two buffers, so one block barrier a tile suffices (a warp
// that has finished tile i goes on to tile i + 1's pass while others
// still read tile i's h2).
// Warp w then forms p3^T = W3^T h2^T for the channels 16 w.. over the
// tile's 64 rows (m = channel, n = row), W3^T's fragments held in
// registers for the whole sweep: lane (g, t) holds channel 16 w + 8 hh +
// g at rows 8 j + 2 t + e, so a (group, channel)'s rows meet inside one
// warp, in the lanes of one t group, and its max is reduced from the
// accumulators there (p7_pool; B2b-bf16's pool_tile_t reduces p3 alike).
// Only the h2 pass (p7_h2), W3^T's fragments (p7_w3) and the product
// (p7_p3) differ between the dtypes:
//   bf16: mma.sync m16n8k16, h2 a bf16 (TR, LDB) tile read by ldmatrix;
//         four p2 stages (54,816 bytes of shared memory).
//   f32:  wgmma m64n64k8 in 3xTF32 (tf32_mma.cuh's split): warpgroup W
//         owns the channels 64 W.. (A = W3^T from registers, its hi and
//         lo 64 values a thread; B = h2 split into hi and lo tiles as it
//         is made, in s2t_core's K-major layout), the eight k8 steps'
//         three passes (lo hi' + hi lo' + hi hi') chained in the tensor
//         cores, as B2b's and B8a's mma3 chains; three p2 stages (118,296
//         bytes).
// The layer-3 affine, the roundings and the ReLU are applied to a group's
// extreme p3 alone: each is monotone in p3 (non-decreasing, or
// non-increasing where mul3 < 0), so the group's max of relu(y) is relu(y)
// of its largest p3 (of its smallest where mul3 < 0), the twin's value
// bit for bit for the same p3. W3's column is negated where mul3 < 0, so
// every channel takes a max, one FMNMX a value (the products are exact
// negations, and the tensor cores' sums, which truncate, are the negated
// sums: chip_ablate.py b7c holds this build bit-equal to one that takes a
// min there instead). A group spanning tiles (pool = upt TR) is walked
// in order by one block, its running max in registers. At bf16 p3's
// sums are B8a-bf16's (the same m16n8k16 steps on the same bf16
// operands), so B8a routes on the z whose max B7c pooled; at f32 B8a
// sums on mma.sync in its own order.
constexpr int P7_NT = 512;                      // 16 warps
constexpr uint32_t P7_FULL = 0xffffffffu;

// Shared memory of B7c's block (bytes): STAGES p2 tiles | two h2 buffers
// (bf16: a (TR, LDB) tile; f32: hi and lo core tiles) | vec | mbarriers.
template <bool BF>
struct P7 {
  static constexpr int STAGES = BF ? 4 : 3;
  static constexpr size_t STAGE = TR * CW * (BF ? 2 : 4);
  static constexpr size_t HBUF = BF ? TR * LDB * 2 : 2 * TR * CW * 4;
  static constexpr size_t H = STAGES * STAGE;
  static constexpr size_t V = H + 2 * HBUF;
  static constexpr size_t BARS = V + (2 * CW + 3 * C3W) * 4;
  static constexpr size_t TOTAL = BARS + STAGES * 8;
};

// A block's walk over its tiles in order: whole units of upt tiles (a
// pool group spanning tiles stays with one block), units strided over the
// grid; tile = unit upt + j, advanced without a division.
struct P7Walk {
  int64_t unit;
  int j;
  __device__ __forceinline__ int64_t tile(int upt) const {
    return unit * upt + j;
  }
  __device__ __forceinline__ void next(int upt) {
    if (++j == upt) {
      j = 0;
      unit += gridDim.x;
    }
  }
};

// The group maxima of one tile from p3^T's accumulators c (lane (g, t):
// channel n0 + 8 hh + g at the tile's rows 8 j + 2 t + e in c[4 j + 2 hh
// + e], W3's column negated where neg[hh]) -> pooled. A group of 2^LP rows
// spans JS of a lane's j and ES of its e, and the low TB bits of t: its
// max over the lane's values (a tree), then over those lanes. pool > TR
// (upt > 1, LP == 6): the unit's tile w.j merges its max into the running
// max run[hh], stored at the unit's last tile. vp = [b3 | mul3 | shift3]
// (b3 rounded at BF).
template <bool BF, int LP>
__device__ __forceinline__ void p7_pool(const float (&c)[32], int n0,
                                        int lane, const bool neg[2],
                                        const float* vp, const P7Walk& w,
                                        int upt, float run[2],
                                        RowT<BF>* __restrict__ pooled) {
  constexpr int JS = LP > 3 ? 1 << (LP - 3) : 1;
  constexpr int ES = LP > 0 ? 2 : 1;
  constexpr int TB = LP > 2 ? 2 : (LP > 1 ? 1 : 0);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ch = n0 + 8 * hh + g;
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += JS)
#pragma unroll
      for (int e0 = 0; e0 < 2; e0 += ES) {
        float a[JS];
#pragma unroll
        for (int jj = 0; jj < JS; ++jj) {
          const float* cj = c + 4 * (j0 + jj) + 2 * hh + e0;
          a[jj] = ES == 2 ? fmaxf(cj[0], cj[1]) : cj[0];
        }
#pragma unroll
        for (int sp = 1; sp < JS; sp *= 2)
#pragma unroll
          for (int jj = 0; jj < JS; jj += 2 * sp)
            a[jj] = fmaxf(a[jj], a[jj + sp]);
        float m = a[0];
#pragma unroll
        for (int b = 0; b < TB; ++b)
          m = fmaxf(m, __shfl_xor_sync(P7_FULL, m, 1 << b));
        int64_t o;
        if (upt > 1) {
          run[hh] = w.j == 0 ? m : fmaxf(run[hh], m);
          if (w.j != upt - 1) continue;
          m = run[hh];
          o = w.unit * C3W + ch;
        } else {
          o = (w.unit * (TR >> LP) + ((8 * j0 + 2 * t + e0) >> LP)) * C3W +
              ch;
        }
        if ((t & ((1 << TB) - 1)) != 0) continue;
        const float p = rb_if<BF>(neg[hh] ? -m : m);     // p3's extreme
        const float y = rb_if<BF>(__fadd_rn(
            __fmul_rn(__fadd_rn(p, vp[ch]), vp[C3W + ch]), vp[2 * C3W + ch]));
        put(pooled + o, fmaxf(y, 0.f));
      }
  }
}

// The number of tiles the block walks.
__device__ __forceinline__ int64_t p7_count(int64_t ntiles, int upt) {
  const int64_t units = ntiles / upt;
  return units > blockIdx.x
             ? ((units - 1 - blockIdx.x) / gridDim.x + 1) * upt
             : 0;
}

// vec = [mul2 | shift2 | b3 | mul3 | shift3] -> v (b3 rounded at BF); neg:
// mul3 < 0 at the warp's channels n0 + g (+ 8).
template <bool BF>
__device__ __forceinline__ void p7_vec(const float* __restrict__ vec,
                                       float* v, int n0, int g,
                                       bool neg[2]) {
  for (int i = threadIdx.x; i < 2 * CW + 3 * C3W; i += P7_NT)
    v[i] = BF && i >= 2 * CW && i < 2 * CW + C3W ? rb(vec[i]) : vec[i];
  neg[0] = __float_as_uint(vec[2 * CW + C3W + n0 + g]) >> 31;
  neg[1] = __float_as_uint(vec[2 * CW + C3W + n0 + 8 + g]) >> 31;
}

// h2 = relu(p2 mul2 + shift2) of a staged (TR, CW) f32 tile S, split into
// the hi and lo core tiles (s2t_core(row, k)), four values a step: the
// eight lanes of a phase take eight rows and eight column quads, so both
// the staged reads and the core-tile writes are free of bank conflicts.
__device__ __forceinline__ void p7_h2_split(const float* S, const float* v,
                                            float* hi, float* lo) {
  for (int e = threadIdx.x; e < TR * CW / 4; e += P7_NT) {
    const int i = e & 7;
    const int r = 8 * (e >> 7) + i;
    const int k = 4 * (8 * ((e >> 6) & 1) + ((i + (e >> 3)) & 7));
    const float4 p = *reinterpret_cast<const float4*>(S + r * CW + k);
    store_split4(hi, lo, s2t_core(r, k), relu4(p, v, v + CW, k));
  }
}

// h2 of a staged p2 tile S -> the h2 buffer hb (bf16: a (TR, LDB) tile;
// f32: the hi and lo core tiles); v = [mul2 | shift2].
template <bool BF>
__device__ __forceinline__ void p7_h2(const RowT<BF>* S, const float* v,
                                      unsigned char* hb) {
  if constexpr (BF) {
    relu_rows_bf16(S, v, reinterpret_cast<__nv_bfloat16*>(hb), threadIdx.x,
                   P7_NT);
  } else {
    float* hi = reinterpret_cast<float*>(hb);
    p7_h2_split(S, v, hi, hi + TR * CW);
    fence_async_smem();                 // h2: read by wgmma
  }
}

// W3^T's A fragments of the warp's channels n0.. (lane (g, t)), held for
// the whole sweep, a column negated where its mul3 < 0 (neg): bf16(W3)^T
// for m16n8k16 (k step kk), or W3^T split for m16n8k8's layout (k8 step
// kb).
template <bool BF>
struct P7A;
template <>
struct P7A<true> {
  uint32_t a[4][4];
};
template <>
struct P7A<false> {
  S2TA a[8];
};

template <bool BF>
__device__ __forceinline__ P7A<BF> p7_w3(const float* __restrict__ W3,
                                         int n0, int g, int t,
                                         const bool neg[2]) {
  const uint32_t sb = BF ? 0x80008000u : 0x80000000u;   // sign bits
  const uint32_t na = neg[0] ? sb : 0u, nb = neg[1] ? sb : 0u;
  P7A<BF> wa;
  if constexpr (BF) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* w = W3 + (16 * kk + 2 * t) * C3W + n0 + g;
      wa.a[kk][0] = pack_bf16(w[0], w[C3W]) ^ na;
      wa.a[kk][1] = pack_bf16(w[8], w[C3W + 8]) ^ nb;
      wa.a[kk][2] = pack_bf16(w[8 * C3W], w[9 * C3W]) ^ na;
      wa.a[kk][3] = pack_bf16(w[8 * C3W + 8], w[9 * C3W + 8]) ^ nb;
    }
  } else {
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      const float* w = W3 + (8 * kb + t) * C3W + n0 + g;
      wa.a[kb] = s2t_a(w[0], w[8], w[4 * C3W], w[4 * C3W + 8]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wa.a[kb].hi[q] ^= q & 1 ? nb : na;
        wa.a[kb].lo[q] ^= q & 1 ? nb : na;
      }
    }
  }
  return wa;
}

// p3^T = W3^T h2^T of the warp's channels over the tile's rows from the
// h2 buffer hb -> c (lane (g, t): channel n0 + 8 hh + g, row 8 j + 2 t +
// e in c[4 j + 2 hh + e]). bf16: mma.sync m16n8k16, h2 by ldmatrix; f32:
// warpgroup W's wgmma m64n64k8 over its channels 64 W.., the eight k8
// steps' three passes (lo hi' + hi lo' + hi hi') chained.
template <bool BF>
__device__ __forceinline__ void p7_p3(const P7A<BF>& wa,
                                      const unsigned char* hb, int lane,
                                      float (&c)[32]) {
#pragma unroll
  for (int q = 0; q < 32; ++q) c[q] = 0.f;
  if constexpr (BF) {
    const __nv_bfloat16* H = reinterpret_cast<const __nv_bfloat16*>(hb);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4(b, b_cols_at(H, 16 * np, 16 * kk, lane));
        mma_bf16(c + 8 * np, wa.a[kk], b[0], b[1]);
        mma_bf16(c + 8 * np + 4, wa.a[kk], b[2], b[3]);
      }
  } else {
    const float* hi = reinterpret_cast<const float*>(hb);
    const uint64_t dh = wgmma_desc(hi, S2T_LBO, S2T_SBO);
    const uint64_t dl = wgmma_desc(hi + TR * CW, S2T_LBO, S2T_SBO);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      s2t_wg64(c, wa.a[kb].lo, dh + 16 * kb, kb > 0);
      s2t_wg64(c, wa.a[kb].hi, dl + 16 * kb, 1);
      s2t_wg64(c, wa.a[kb].hi, dh + 16 * kb, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int q = 0; q < 32; ++q) pin(c[q]);
  }
}

template <bool BF, int LP>
__global__ void __launch_bounds__(P7_NT, 1)
fwd_pool_kernel(const RowT<BF>* __restrict__ p2, int64_t ntiles, int upt,
                const float* __restrict__ vec, const float* __restrict__ W3,
                RowT<BF>* __restrict__ pooled) {
  using L = P7<BF>;
  extern __shared__ __align__(1024) unsigned char smp[];
  RowT<BF>* stage = reinterpret_cast<RowT<BF>*>(smp);
  float* v = reinterpret_cast<float*>(smp + L::V);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smp + L::BARS);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = 16 * warp;             // f32: 64 (warp / 4) + 16 (warp % 4)
  const int64_t count = p7_count(ntiles, upt);
  P7Walk fetched{blockIdx.x, 0}, walk{blockIdx.x, 0};
  auto fetch = [&](int64_t i) {               // thread 0: one bulk copy
    uint64_t* bar = &bars[i % L::STAGES];
    mbar_expect(bar, static_cast<uint32_t>(L::STAGE));
    bulk_load(stage + (i % L::STAGES) * TR * CW,
              p2 + fetched.tile(upt) * TR * CW,
              static_cast<uint32_t>(L::STAGE), bar);
    fetched.next(upt);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) mbar_init(&bars[s]);
    for (int64_t i = 0; i < L::STAGES && i < count; ++i) fetch(i);
  }
  bool neg[2];
  p7_vec<BF>(vec, v, n0, g, neg);
  const P7A<BF> wa = p7_w3<BF>(W3, n0, g, t, neg);
  __syncthreads();

  float run[2] = {0.f, 0.f};
  for (int64_t i = 0; i < count; ++i) {
    unsigned char* hb = smp + L::H + (i & 1) * L::HBUF;
    mbar_wait(&bars[i % L::STAGES],
              static_cast<uint32_t>((i / L::STAGES) & 1));
    p7_h2<BF>(stage + (i % L::STAGES) * TR * CW, v, hb);
    __syncthreads();
    if (threadIdx.x == 0 && i + L::STAGES < count) fetch(i + L::STAGES);

    float c[32];
    p7_p3<BF>(wa, hb, lane, c);
    p7_pool<BF, LP>(c, n0, lane, neg, v + 2 * CW, walk, upt, run, pooled);
    walk.next(upt);
  }
}

// -- launchers ---------------------------------------------------------

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}


template <bool BF>
int launch_fwd_gram(const RowT<BF>* p2, int64_t R, const float* vec2,
                    double* partG, double* partc, int nblk, void* stream) {
  if (R % TR != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (TR * LD + 2 * CW);
  fwd_gram_kernel<BF><<<nblk, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      p2, R / TR, vec2, partG, partc);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF, int LP>
int launch_fwd_pool_lp(const RowT<BF>* p2, int64_t R, int upt,
                       const float* vec, const float* W3, RowT<BF>* pooled,
                       int nblk, cudaStream_t st) {
  const size_t smem = P7<BF>::TOTAL;
  cudaError_t e = prepare(fwd_pool_kernel<BF, LP>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_pool_kernel<BF, LP><<<nblk, P7_NT, smem, st>>>(p2, R / TR, upt, vec, W3,
                                                      pooled);
  return static_cast<int>(cudaGetLastError());
}

// B7c: LP = log2(min(pool, TR)); a pool > TR spans upt = pool / TR tiles.
// One 512-thread block an SM (nblk); p2 16-byte aligned (TMA bulk copies).
template <bool BF>
int launch_fwd_pool(const RowT<BF>* p2, int64_t R, int pool, const float* vec,
                    const float* W3, RowT<BF>* pooled, int nblk,
                    void* stream) {
  if (bad_pool(R, pool) || nblk < 1 || !aligned16(p2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int upt = pool <= TR ? 1 : pool / TR;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define P7_LAUNCH(LP) \
  return launch_fwd_pool_lp<BF, LP>(p2, R, upt, vec, W3, pooled, nblk, st)
  switch (pool <= TR ? pool : TR) {
    case 1: P7_LAUNCH(0);
    case 2: P7_LAUNCH(1);
    case 4: P7_LAUNCH(2);
    case 8: P7_LAUNCH(3);
    case 16: P7_LAUNCH(4);
    case 32: P7_LAUNCH(5);
    default: P7_LAUNCH(6);
  }
#undef P7_LAUNCH
}

template <bool BF, int LP>
int launch_bwd2_sweep1_lp(const RowT<BF>* p2, int64_t R, int upt,
                          const float* vec, const float* W3,
                          const RowT<BF>* dpooled, RowT<BF>* q3,
                          double* partA, double* partu, double* partG,
                          double* partc, int nblk, cudaStream_t st) {
  const size_t smem = S8<BF>::TOTAL;
  cudaError_t e = prepare(bwd2_sweep1_kernel<BF, LP>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd2_sweep1_kernel<BF, LP><<<nblk, S8_NT, smem, st>>>(
      p2, R / TR, upt, vec, W3, dpooled, q3, partA, partu, partG, partc);
  return static_cast<int>(cudaGetLastError());
}

// B8a: LP = log2(min(pool, TR)); a pool > TR spans upt = pool / TR tiles.
template <bool BF>
int launch_bwd2_sweep1(const RowT<BF>* p2, int64_t R, int pool,
                       const float* vec, const float* W3,
                       const RowT<BF>* dpooled, RowT<BF>* q3, double* partA,
                       double* partu, double* partG, double* partc, int nblk,
                       void* stream) {
  if (bad_pool(R, pool)) return static_cast<int>(cudaErrorInvalidValue);
  const int upt = pool <= TR ? 1 : pool / TR;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define S8_LAUNCH(LP)                                                     \
  return launch_bwd2_sweep1_lp<BF, LP>(p2, R, upt, vec, W3, dpooled, q3, \
                                       partA, partu, partG, partc, nblk, st)
  switch (pool <= TR ? pool : TR) {
    case 1: S8_LAUNCH(0);
    case 2: S8_LAUNCH(1);
    case 4: S8_LAUNCH(2);
    case 8: S8_LAUNCH(3);
    case 16: S8_LAUNCH(4);
    case 32: S8_LAUNCH(5);
    default: S8_LAUNCH(6);
  }
#undef S8_LAUNCH
}

template <int C0, bool FROM_X>
int launch_s2f(const __nv_bfloat16* x, int64_t N, int64_t R, int xmode,
               const __nv_bfloat16* p1, const float* W1, const float* vec,
               const __nv_bfloat16* p2, const __nv_bfloat16* q3,
               const float* M3, const float* W2, double* partM,
               double* partV, double* partX, double* partU, int nblk,
               cudaStream_t st) {
  cudaError_t e = prepare(bwd2_sweep2_bf16_kernel<C0, FROM_X>, S2F_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd2_sweep2_bf16_kernel<C0, FROM_X><<<nblk, S2F_NT, S2F_SMEM, st>>>(
      x, N, R, xmode, p1, W1, vec, p2, q3, M3, W2, partM, partV, partX,
      partU);
  return static_cast<int>(cudaGetLastError());
}

template <int C0, bool FROM_X>
int launch_s2t(const float* x, int64_t N, int64_t R, int xmode, int a16,
               const float* p1, const float* W1, const float* vec,
               const float* p2, const float* q3, const float* M3,
               const float* W2, double* partM, double* partV, double* partX,
               double* partU, int nblk, cudaStream_t st) {
  cudaError_t e = prepare(bwd2_sweep2_tf32_kernel<C0, FROM_X>, S2T_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd2_sweep2_tf32_kernel<C0, FROM_X><<<nblk, S2T_NT, S2T_SMEM, st>>>(
      x, N, R, xmode, a16, p1, W1, vec, p2, q3, M3, W2, partM, partV, partX,
      partU);
  return static_cast<int>(cudaGetLastError());
}

// B6 / B8b at f32 (p1 == nullptr: B6): one 512-thread block an SM (nblk);
// rows at any 4-byte alignment.
int launch_bwd2_sweep2(const float* x, int B, int C0, int N, const float* p1,
                       const float* W1, const float* vec, const float* p2,
                       const float* q3, const float* M3, const float* W2,
                       double* partM, double* partV, double* partX,
                       double* partU, int nblk, void* stream) {
  const int64_t R = (int64_t)B * N;
  if (bad_shape(C0, R) || nblk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int a16 = (aligned16(p2) ? 1 : 0) | (aligned16(q3) ? 2 : 0) |
                  (p1 != nullptr && aligned16(p1) ? 4 : 0);
  const int xmode = !aligned16(x) ? 2 : N % 4 == 0 ? 0 : N == 1 ? 1 : 2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define S2T_LAUNCH(C)                                                        \
  return p1 == nullptr                                                       \
             ? launch_s2t<C, true>(x, N, R, xmode, a16, p1, W1, vec, p2, q3, \
                                   M3, W2, partM, partV, partX, partU, nblk, \
                                   st)                                       \
             : launch_s2t<C, false>(x, N, R, xmode, a16, p1, W1, vec, p2,    \
                                    q3, M3, W2, partM, partV, partX, partU,  \
                                    nblk, st)
  switch (C0) {
    case 1: S2T_LAUNCH(1);
    case 2: S2T_LAUNCH(2);
    case 3: S2T_LAUNCH(3);
    case 4: S2T_LAUNCH(4);
    case 5: S2T_LAUNCH(5);
    case 6: S2T_LAUNCH(6);
    default: S2T_LAUNCH(7);
  }
#undef S2T_LAUNCH
}

// B6 / B8b at bf16: one 512-thread block an SM (nblk), p2, q3 and p1
// 16-byte aligned (they arrive by 16-byte copies).
int launch_bwd2_sweep2_bf16(const __nv_bfloat16* x, int B, int C0, int N,
                            const __nv_bfloat16* p1, const float* W1,
                            const float* vec, const __nv_bfloat16* p2,
                            const __nv_bfloat16* q3, const float* M3,
                            const float* W2, double* partM, double* partV,
                            double* partX, double* partU, int nblk,
                            void* stream) {
  const int64_t R = (int64_t)B * N;
  if (bad_shape(C0, R) || nblk < 1 || !aligned16(p2) || !aligned16(q3) ||
      (p1 != nullptr && !aligned16(p1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int xmode = !aligned16(x) ? 2 : N % 8 == 0 ? 0 : N == 1 ? 1 : 2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define S2F_LAUNCH(C)                                                       \
  return p1 == nullptr                                                      \
             ? launch_s2f<C, true>(x, N, R, xmode, p1, W1, vec, p2, q3, M3, \
                                   W2, partM, partV, partX, partU, nblk, st) \
             : launch_s2f<C, false>(x, N, R, xmode, p1, W1, vec, p2, q3,     \
                                    M3, W2, partM, partV, partX, partU,      \
                                    nblk, st)
  switch (C0) {
    case 1: S2F_LAUNCH(1);
    case 2: S2F_LAUNCH(2);
    case 3: S2F_LAUNCH(3);
    case 4: S2F_LAUNCH(4);
    case 5: S2F_LAUNCH(5);
    case 6: S2F_LAUNCH(6);
    default: S2F_LAUNCH(7);
  }
#undef S2F_LAUNCH
}

}  // namespace

// Every launcher: nblk persistent blocks over R / 64 row tiles (128-row
// steps for the bf16 bwd2_sweep2); returns
// cudaGetLastError() (0 on success). The _bf16 entry points take the row
// tensors as bf16 and the same f32 parameters.
using bf16_t = __nv_bfloat16;

extern "C" int facl_sa_fwd_gram(const float* p2, int64_t R,
                                const float* vec2, double* partG,
                                double* partc, int nblk, void* stream) {
  return launch_fwd_gram<false>(p2, R, vec2, partG, partc, nblk, stream);
}

extern "C" int facl_sa_fwd_gram_bf16(const bf16_t* p2, int64_t R,
                                     const float* vec2, double* partG,
                                     double* partc, int nblk, void* stream) {
  return launch_fwd_gram<true>(p2, R, vec2, partG, partc, nblk, stream);
}

extern "C" int facl_sa_fwd_pool(const float* p2, int64_t R, int pool,
                                const float* vec, const float* W3,
                                float* pooled, int nblk, void* stream) {
  return launch_fwd_pool<false>(p2, R, pool, vec, W3, pooled, nblk, stream);
}

extern "C" int facl_sa_fwd_pool_bf16(const bf16_t* p2, int64_t R, int pool,
                                     const float* vec, const float* W3,
                                     bf16_t* pooled, int nblk, void* stream) {
  return launch_fwd_pool<true>(p2, R, pool, vec, W3, pooled, nblk, stream);
}

extern "C" int facl_sa_bwd2_sweep1(const float* p2, int64_t R, int pool,
                                   const float* vec, const float* W3,
                                   const float* dpooled, float* q3,
                                   double* partA, double* partu,
                                   double* partG, double* partc, int nblk,
                                   void* stream) {
  return launch_bwd2_sweep1<false>(p2, R, pool, vec, W3, dpooled, q3, partA,
                                   partu, partG, partc, nblk, stream);
}

extern "C" int facl_sa_bwd2_sweep1_bf16(const bf16_t* p2, int64_t R,
                                        int pool, const float* vec,
                                        const float* W3,
                                        const bf16_t* dpooled, bf16_t* q3,
                                        double* partA, double* partu,
                                        double* partG, double* partc,
                                        int nblk, void* stream) {
  return launch_bwd2_sweep1<true>(p2, R, pool, vec, W3, dpooled, q3, partA,
                                  partu, partG, partc, nblk, stream);
}

// p1 == nullptr: B6 (h1 from x by h1_pair, at bf16 h1_pre_bf16; x
// channel-major (B, C0, N)). Otherwise B8b (h1 from p1; x row-major,
// passed as B = R, N = 1). At bf16 p1, p2 and q3 must be 16-byte aligned.
extern "C" int facl_sa_bwd2_sweep2(const float* x, int B, int C0, int N,
                                   const float* p1, const float* W1,
                                   const float* vec, const float* p2,
                                   const float* q3, const float* M3,
                                   const float* W2, double* partM,
                                   double* partV, double* partX,
                                   double* partU, int nblk, void* stream) {
  return launch_bwd2_sweep2(x, B, C0, N, p1, W1, vec, p2, q3, M3, W2, partM,
                            partV, partX, partU, nblk, stream);
}

extern "C" int facl_sa_bwd2_sweep2_bf16(const bf16_t* x, int B, int C0,
                                        int N, const bf16_t* p1,
                                        const float* W1, const float* vec,
                                        const bf16_t* p2, const bf16_t* q3,
                                        const float* M3, const float* W2,
                                        double* partM, double* partV,
                                        double* partX, double* partU,
                                        int nblk, void* stream) {
  return launch_bwd2_sweep2_bf16(x, B, C0, N, p1, W1, vec, p2, q3, M3, W2,
                                 partM, partV, partX, partU, nblk, stream);
}
