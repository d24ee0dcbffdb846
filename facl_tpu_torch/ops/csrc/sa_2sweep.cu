// B6, B7, B8: the two-sweep SA training paths — [Dense -> BN(train) ->
// ReLU] x3 (C0 -> 64 -> 64 -> 256) + max-pool over K.
//
// Replaces the TPU kernels of facl_tpu/ops/pallas/:
//   B7 sa_fwd.py::sa_forward_pallas (:148), sa_impl="hybrid2"
//     fwd_layer   <- _make_layer_sweep  (:65, pallas_call :189), run twice:
//                    x -> p1 and p1 -> p2
//     fwd_gram    <- _make_gram_sweep   (:97, pallas_call :219)
//     fwd_pool    <- _make_pool_sweep   (:117, pallas_call :242)
//   B8 sa_bwd.py::sa_backward_pallas (:232), sa_impl="hybrid"/"hybrid2"
//     bwd2_sweep1 <- _make_sweep1_kernel (:101, pallas_call :275)
//     bwd2_sweep2 <- _make_sweep2_kernel (:140, pallas_call :298), h1 from
//                    the stored p1
//   B6 sa_pair.py::sa_backward_pair, slim=False (:711), sa_impl="pair"
//     bwd2_sweep2 <- _make_sweep2_pair_kernel (:333, pallas_call :863), h1
//                    recomputed from x by the forward's h1_tile
// Each returns the named accumulators (per-block float64 partials that
// the caller sums in a fixed order, as in sa_pair.cu), not the TPU's
// packed (Lw, Rw) or paired main/aux blocks.
//
// Bounds on the card (R = 2,621,440 rows at the main path): fwd_layer and
// fwd_gram by bytes (they stream 64-wide f32 rows), fwd_pool by f32
// operations (the recomputed 64x256 product, ~86 GFLOP), bwd2_sweep1 by
// operations (four dense products, h2 W3, Gram(h2), A3 = dy3^T h2 and q3
// = D W3^T, 269 GFLOP on the tensor cores: 1.73 ms in 3xTF32, 0.38 ms at
// bf16 with its CUDA-core passes; dy3 is dense on the main path, ~25 tied
// rows a routed (group, channel)), bwd2_sweep2 by operations (two 64x64
// products and C0 + 3 Grams of 64x64 per row, ~190 GFLOP).
// Design: sa_pair.cu's persistent blocks over 64-row tiles. B7 and B8b
// (and B6) keep their port-time form, register-tiled products on CUDA
// cores (strict f32) with no copy/compute overlap; B8a runs its products
// on the tensor cores with its tiles staged by TMA (its own section
// below).
//
// bf16 (the template flag BF, entry points facl_sa_*_bf16): the row
// tensors (x, p1, p2, q3, dpooled, pooled) are __nv_bfloat16, the
// parameters the TPU kernels cast to the compute dtype (W1, b1, W2, W3,
// b3, M3, gi2, gi3) are rounded to bf16 where they are staged, and the
// results are rounded (rb) at the TPU kernels' cast points, listed by the
// bf16 twins of ops/sa_fwd.py and ops/sa_bwd.py. Every product then has
// two bf16 operands and is exact in f32, so the same f32 FMA chains sum
// them (B8a: the bf16 tensor cores; only the order of the sums differs
// from the twins), and the per-block float64 partials stay. The ReLU
// masks are decided on the bf16-rounded h (relu_affine_p); B6's h1 is
// sa_pair.cu's bf16 h1 bit for bit (h1_of, the same k-order chain). In B6,
// B7 and B8b every f32 path is the code it was before the template: the
// bf16 casts sit in `if constexpr (BF)` branches.
#include <cstdint>
#include "common.cuh"
#include "sa_mma.cuh"

namespace {

constexpr int LDZ = C3W + 1;   // padded stride of (TR, 256) tiles

template <bool BF>
using RowT = typename Row<BF>::T;

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// copy_vec, each value rounded to bf16 at BF (a parameter the TPU kernel
// casts to the compute dtype).
template <bool BF>
__device__ __forceinline__ void copy_vec_p(float* dst, const float* src,
                                           int n) {
  if constexpr (BF) {
    for (int i = threadIdx.x; i < n; i += NT) dst[i] = rb(src[i]);
  } else {
    copy_vec(dst, src, n);
  }
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

template <bool BF>
__device__ __forceinline__ void load_tile_p(const RowT<BF>* __restrict__ src,
                                            int64_t r0, float* dst) {
  if constexpr (BF) {
    for (int e = threadIdx.x; e < TR * CW; e += NT) {
      const int r = e / CW, c = e % CW;
      dst[r * LD + c] = to_f(src[(r0 + r) * CW + c]);
    }
  } else {
    load_tile(src, r0, dst);
  }
}

template <bool BF>
__device__ __forceinline__ void store_tile_p(const float* src, int64_t r0,
                                             RowT<BF>* __restrict__ dst) {
  if constexpr (BF) {
    for (int e = threadIdx.x; e < TR * CW; e += NT) {
      const int r = e / CW, c = e % CW;
      put(dst + (r0 + r) * CW + c, src[r * LD + c]);
    }
  } else {
    store_tile(src, r0, dst);
  }
}

template <bool BF>
__device__ __forceinline__ void load_x_tile_p(const RowT<BF>* __restrict__ x,
                                              int C0, int64_t N, int64_t r0,
                                              float* xs) {
  if constexpr (BF) {
    for (int e = threadIdx.x; e < TR * C0; e += NT) {
      const int i = e % TR, c = e / TR;
      const int64_t r = r0 + i;
      const int64_t b = r / N, n = r - b * N;
      xs[i * C0MAX + c] = to_f(x[(b * C0 + c) * N + n]);
    }
  } else {
    load_x_tile(x, C0, N, r0, xs);
  }
}

// h1_tile's chain; at BF the bf16 chain of sa_pair.cu's sweeps (h1_of:
// relu(bf16((bf16(x W1) + b1) mul1 + shift1)), W1 and b1 staged rounded).
template <bool BF>
__device__ __forceinline__ void h1_tile_p(const float* xs, int C0,
                                          const float* W1s, const float* vec1,
                                          float* h1s) {
  if constexpr (BF) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float acc = 0.0f;
        for (int k = 0; k < C0; ++k)
          acc = __fadd_rn(acc, __fmul_rn(xs[r * C0MAX + k], W1s[k * CW + c]));
        h1s[r * LD + c] =
            h1_of<true>(acc, vec1[c], vec1[CW + c], vec1[2 * CW + c]);
      }
    }
  } else {
    h1_tile(xs, C0, W1s, vec1, h1s);
  }
}

// mm64 with the scaled operand rounded to bf16 at BF (a bf16 product the
// TPU kernel feeds its dot).
template <bool BF>
__device__ __forceinline__ void mm64_p(const float* A, const float* Bm,
                                       const float* scale,
                                       float acc[4][4]) {
  if constexpr (BF) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < CW; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = A[(ty + 16 * i) * LD + k];
        if (scale) a[i] = rb(__fmul_rn(a[i], scale[k]));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bm[k * CW + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  } else {
    mm64(A, Bm, scale, acc);
  }
}

// z = (h2 W3 + b3) * mul3 + shift3, the layer-3 BatchNorm output before
// its ReLU, for one tile into zs (TR, LDZ); vec3 = [b3 | mul3 | shift3].
// The pool sweep (B7c) sums h2 W3 in k order on CUDA cores; the
// backward's sweep 1 (B8a) recomputes z on the tensor cores in its own
// order and routes on that recompute, as the JAX backward does
// (sa_bwd.py:70-91) and as hybrid does after its plain forward: at
// near-ties of z a hybrid2 backward may route to another row than the
// one B7c pooled. At BF p3 = bf16(h2 W3) + b3 (b3 staged rounded),
// summed in f32, and z stays f32 (sa_bwd.py:76-78).
template <bool BF>
__device__ __forceinline__ void z_tile(const float* h2s, const float* W3s,
                                       const float* vec3, float* zs) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < CW; ++k) {
    float a[4], bb[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = h2s[(ty + 16 * i) * LD + k];
#pragma unroll
    for (int j = 0; j < 16; ++j) bb[j] = W3s[k * C3W + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = tx + 16 * j;
      float p3;
      if constexpr (BF)
        p3 = __fadd_rn(rb(acc[i][j]), vec3[c]);
      else
        p3 = __fadd_rn(acc[i][j], vec3[c]);
      zs[(ty + 16 * i) * LDZ + c] =
          __fadd_rn(__fmul_rn(p3, vec3[C3W + c]), vec3[2 * C3W + c]);
    }
}

// Per-block sums of a (TR, 64) tile's columns into red[16][64] rows ->
// part[2][64]; s/ss are this thread's running sums of columns tx + 16 j.
__device__ __forceinline__ void write_sums(const double s[4],
                                           const double ss[4], double* red,
                                           double* __restrict__ part) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[ty * CW + tx + 16 * j] = s[j];
    red[(16 + ty) * CW + tx + 16 * j] = ss[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * CW) {
    const int w = threadIdx.x / CW, c = threadIdx.x % CW;
    double a = 0.0;
    for (int y = 0; y < 16; ++y) a += red[(w * 16 + y) * CW + c];
    part[(int64_t)blockIdx.x * 2 * CW + w * CW + c] = a;
  }
}

// ---------------------------------------------------------------------
// B7a: p = h W + b, written (R, 64), with per-block sums of p and p^2.
// affine == 0: h = x, row-major (R, cin), cin <= 7 (the cast-only input
// sweep); affine == 1: h = relu(in * mul + shift), in = p1 (R, 64).
// vec = [b | mul | shift] (3*CW); part: (blocks, 2, 64) float64. At BF p =
// bf16(h W) + b in f32 is stored rounded and summed unrounded
// (sa_fwd.py:86-91).
template <bool BF>
__global__ void __launch_bounds__(NT)
fwd_layer_kernel(const RowT<BF>* __restrict__ in, int cin, int affine,
                 int64_t ntiles, const float* __restrict__ W,
                 const float* __restrict__ vec, RowT<BF>* __restrict__ p,
                 double* __restrict__ part) {
  extern __shared__ float sm[];
  float* Ws = sm;                       // cin*CW (<= CW*CW)
  float* hs = Ws + CW * CW;             // TR*LD: input tile, then p tile
  float* v = hs + TR * LD;              // b | mul | shift
  double* red = reinterpret_cast<double*>(v + 3 * CW);   // 2*16*CW

  copy_vec_p<BF>(Ws, W, cin * CW);
  copy_vec_p<BF>(v, vec, CW);
  copy_vec(v + CW, vec + CW, 2 * CW);
  __syncthreads();

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  double s[4] = {0.0, 0.0, 0.0, 0.0}, ss[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t r0 = t * TR;
    if (affine) {
      load_h_tile_p<BF>(in, r0, v + CW, v + 2 * CW, hs);
    } else {
      for (int e = threadIdx.x; e < TR * cin; e += NT) {
        const int r = e / cin, c = e % cin;
        hs[r * LD + c] = to_f(in[(r0 + r) * cin + c]);
      }
    }
    __syncthreads();
    float acc[4][4];
    if (affine) {
      mm64(hs, Ws, nullptr, acc);
    } else {
      zero_patch(acc);
      for (int k = 0; k < cin; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(hs[(ty + 16 * i) * LD + k],
                             Ws[k * CW + tx + 16 * j], acc[i][j]);
    }
    __syncthreads();                   // hs is reused as the p tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float ts = 0.f, tss = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float val;
        if constexpr (BF)
          val = __fadd_rn(rb(acc[i][j]), v[c]);
        else
          val = __fadd_rn(acc[i][j], v[c]);
        hs[(ty + 16 * i) * LD + c] = val;
        ts += val;
        tss = fmaf(val, val, tss);
      }
      s[j] += ts;
      ss[j] += tss;
    }
    __syncthreads();
    store_tile_p<BF>(hs, r0, p);
    __syncthreads();
  }
  write_sums(s, ss, red, part);
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
// B7c: per tile, z (z_tile) and the max of relu(z) over each group of
// `pool` consecutive rows (affine -> ReLU -> max, the JAX order); only
// pooled (R / pool, 256) reaches device memory. Groups spanning tiles
// (pool > TR) are walked in order by one block, thread c keeping channel
// c's running max (NT == C3W).
// vec = [mul2 | shift2 | b3 | mul3 | shift3]. At BF the affine is rounded
// to bf16 before the ReLU, and pooled is stored bf16 (sa_fwd.py:127-131).
template <bool BF>
__global__ void __launch_bounds__(NT)
fwd_pool_kernel(const RowT<BF>* __restrict__ p2, int64_t ntiles, int pool,
                const float* __restrict__ vec, const float* __restrict__ W3,
                RowT<BF>* __restrict__ pooled) {
  extern __shared__ float sm[];
  float* W3s = sm;                      // CW*C3W
  float* zs = W3s + CW * C3W;           // TR*LDZ
  float* h2s = zs + TR * LDZ;           // TR*LD
  float* v = h2s + TR * LD;             // 2*CW + 3*C3W

  copy_vec_p<BF>(W3s, W3, CW * C3W);
  copy_vec(v, vec, 2 * CW);
  copy_vec_p<BF>(v + 2 * CW, vec + 2 * CW, C3W);
  copy_vec(v + 2 * CW + C3W, vec + 2 * CW + C3W, 2 * C3W);
  __syncthreads();

  const int gpt = pool <= TR ? TR / pool : 1;
  const int upt = pool <= TR ? 1 : pool / TR;
  for (int64_t u = blockIdx.x; u < ntiles / upt; u += gridDim.x) {
    float run = 0.f;
    for (int j = 0; j < upt; ++j) {
      const int64_t t = u * upt + j;
      load_h_tile_p<BF>(p2, t * TR, v, v + CW, h2s);
      __syncthreads();
      z_tile<BF>(h2s, W3s, v + 2 * CW, zs);
      __syncthreads();
      if (pool <= TR) {
        for (int e = threadIdx.x; e < gpt * C3W; e += NT) {
          const int gi = e / C3W, c = e % C3W;
          float m = 0.f;
          for (int r = 0; r < pool; ++r)
            m = fmaxf(m, rb_if<BF>(zs[(gi * pool + r) * LDZ + c]));
          put(pooled + (t * gpt + gi) * C3W + c, m);
        }
      } else {
        const int c = threadIdx.x;
        for (int r = 0; r < TR; ++r)
          run = fmaxf(run, rb_if<BF>(zs[r * LDZ + c]));
        if (j == upt - 1) put(pooled + u * C3W + c, run);
      }
      __syncthreads();
    }
  }
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
// B6 / B8b: the layer-2 backward sweep with layer 1 left in third-order
// moment form (sa_bwd.py:140-195, sa_pair.py:333-401). Per tile: h1 —
// recomputed from x by h1_tile (FROM_X: B6, x channel-major) or from the
// stored p1 (B8b, x row-major: B = R, N = 1) —, h2 from p2, dy2 = [h2 > 0]
// (q3 - h2 M3 - rc3), q2 = (gi2 * dy2) W2^T and mq = m1 q2 (m1 = [h1 > 0]).
// The accumulators are split over gridDim.y slices of blocks, each slice
// walking every tile, so that no thread carries more than 32 float64
// accumulators:
//   slice 0:      A2 = dy2^T h1, G1 = h1^T h1    partM (blocks, 2, 64, 64)
//                 u2, ch1, cnt1 = sum m1, acc1 = sum mq
//                                                partV (blocks, 4, 64)
//                 T1x = m1^T x, P1 = mq^T x (64, C0), [Gx | cx] (C0, C0+1)
//                                                partX (blocks, NX)
//   slice s >= 1: blocks v = 2 (s - 1) + {0, 1} of TM1 = m1^T h1 (v = 0)
//                 and U1_i = (m1 x_i)^T h1 (v = 1 + i)
//                                                partU (blocks, C0+1, 64, 64)
// The U slices recompute only h1 (they read x, and p1 for B8b).
// vec = [b1 | mul1 | shift1 | mul2 | shift2 | rc3 | gi2] (7*CW).
// At BF (sa_bwd.py:150-186, sa_pair.py:362-400): dy2 = bf16([h2 > 0] (q3 -
// bf16(h2 M3) - rc3)) and q2 = bf16(sum bf16(dy2 gi2) W2^T); every
// accumulator then sums products of bf16 rows (u2 and acc1 of the rounded
// dy2 and mq).
template <bool BF, bool FROM_X>
__device__ __forceinline__ void load_h1(const RowT<BF>* __restrict__ x,
                                        int C0, int64_t N,
                                        const RowT<BF>* __restrict__ p1,
                                        int64_t r0, const float* W1s,
                                        const float* v, float* xs,
                                        float* h1s) {
  load_x_tile_p<BF>(x, C0, N, r0, xs);
  if (!FROM_X) load_h_tile_p<BF>(p1, r0, v + CW, v + 2 * CW, h1s);
  __syncthreads();
  if (FROM_X) {
    h1_tile_p<BF>(xs, C0, W1s, v, h1s);
    __syncthreads();
  }
}

template <bool BF, bool FROM_X>
__device__ void sweep2_dy_slice(const RowT<BF>* __restrict__ x, int C0,
                                int64_t N, int64_t ntiles,
                                const RowT<BF>* __restrict__ p1,
                                const RowT<BF>* __restrict__ p2,
                                const RowT<BF>* __restrict__ q3, float* sm,
                                double* __restrict__ partM,
                                double* __restrict__ partV,
                                double* __restrict__ partX) {
  const float* M3s = sm;
  const float* W2t = M3s + CW * CW;
  float* h1s = sm + 2 * CW * CW;
  float* h2s = h1s + TR * LD;           // h2, then the mq tile
  float* dys = h2s + TR * LD;           // q3, then dy2
  float* xs = dys + TR * LD;
  const float* W1s = xs + TR * C0MAX;
  const float* v = W1s + C0MAX * CW;
  const float* mul2 = v + 3 * CW;
  const float* shift2 = v + 4 * CW;
  const float* rc3 = v + 5 * CW;
  const float* gi2 = v + 6 * CW;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nx = 2 * CW * C0 + C0 * (C0 + 1);     // <= 4 * NT for C0 <= 7
  double a2[4][4] = {}, g1[4][4] = {};
  double colsum = 0.0;    // thread w*64 + c: [u2 | ch1 | cnt1 | acc1][c]
  double sx[4] = {0.0, 0.0, 0.0, 0.0};

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t r0 = t * TR;
    load_h_tile_p<BF>(p2, r0, mul2, shift2, h2s);
    load_tile_p<BF>(q3, r0, dys);
    load_h1<BF, FROM_X>(x, C0, N, p1, r0, W1s, v, xs, h1s);
    float acc[4][4];
    mm64(h2s, M3s, nullptr, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float dh = __fsub_rn(
            __fsub_rn(dys[r * LD + c], rb_if<BF>(acc[i][j])), rc3[c]);
        dys[r * LD + c] = h2s[r * LD + c] > 0.f ? rb_if<BF>(dh) : 0.f;
      }
    __syncthreads();
    mm64_p<BF>(dys, W2t, gi2, acc);    // q2
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        h2s[r * LD + c] = h1s[r * LD + c] > 0.f ? rb_if<BF>(acc[i][j]) : 0.f;
      }
    {
      float ta[4][4];
      zero_patch(ta);
      acc_atb(dys, h1s, ta);
      add_patch(a2, ta);
      zero_patch(ta);
      acc_atb(h1s, h1s, ta);
      add_patch(g1, ta);
    }
    __syncthreads();
    {
      const int w = threadIdx.x / CW, c = threadIdx.x % CW;
      float tc = 0.f;
      if (w == 2) {
        for (int r = 0; r < TR; ++r) tc += h1s[r * LD + c] > 0.f ? 1.f : 0.f;
      } else {
        const float* src = w == 0 ? dys : (w == 1 ? h1s : h2s);
        for (int r = 0; r < TR; ++r) tc += src[r * LD + c];
      }
      colsum += tc;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = threadIdx.x + q * NT;
      if (e >= nx) continue;
      float a = 0.f;
      if (e < 2 * CW * C0) {            // T1x, then P1: [c][i]
        const int e1 = e % (CW * C0), c = e1 / C0, i = e1 % C0;
        if (e < CW * C0) {
          for (int r = 0; r < TR; ++r)
            a += h1s[r * LD + c] > 0.f ? xs[r * C0MAX + i] : 0.f;
        } else {
          for (int r = 0; r < TR; ++r)
            a = fmaf(h2s[r * LD + c], xs[r * C0MAX + i], a);
        }
      } else {                          // [Gx | cx]: [i][k]
        const int e2 = e - 2 * CW * C0, i = e2 / (C0 + 1), k = e2 % (C0 + 1);
        if (k < C0) {
          for (int r = 0; r < TR; ++r)
            a = fmaf(xs[r * C0MAX + i], xs[r * C0MAX + k], a);
        } else {
          for (int r = 0; r < TR; ++r) a += xs[r * C0MAX + i];
        }
      }
      sx[q] += a;
    }
    __syncthreads();
  }
  write_patch(a2, partM + (int64_t)blockIdx.x * 2 * CW * CW);
  write_patch(g1, partM + ((int64_t)blockIdx.x * 2 + 1) * CW * CW);
  partV[(int64_t)blockIdx.x * 4 * CW + threadIdx.x] = colsum;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = threadIdx.x + q * NT;
    if (e < nx) partX[(int64_t)blockIdx.x * nx + e] = sx[q];
  }
}

template <bool BF, bool FROM_X>
__device__ void sweep2_u_slice(const RowT<BF>* __restrict__ x, int C0,
                               int64_t N, int64_t ntiles,
                               const RowT<BF>* __restrict__ p1, float* sm,
                               double* __restrict__ partU) {
  float* h1s = sm + 2 * CW * CW;
  float* xs = h1s + 3 * TR * LD;
  const float* W1s = xs + TR * C0MAX;
  const float* v = W1s + C0MAX * CW;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int v0 = 2 * (blockIdx.y - 1);
  const int nv = C0 + 1 - v0 < 2 ? C0 + 1 - v0 : 2;
  double run[2][4][4] = {};
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    load_h1<BF, FROM_X>(x, C0, N, p1, t * TR, W1s, v, xs, h1s);
#pragma unroll
    for (int b = 0; b < 2; ++b) {       // unrolled: run[b] stays in registers
      if (b >= nv) break;
      const int vv = v0 + b;            // 0: TM1, 1 + i: U1 block i
      float acc[4][4];
      zero_patch(acc);
#pragma unroll 4
      for (int r = 0; r < TR; ++r) {
        const float w = vv == 0 ? 1.f : xs[r * C0MAX + vv - 1];
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = h1s[r * LD + ty + 16 * i] > 0.f ? w : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = h1s[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      add_patch(run[b], acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int b = 0; b < 2; ++b)
    if (b < nv)
      write_patch(run[b], partU + ((int64_t)blockIdx.x * (C0 + 1) + v0 + b) *
                                      CW * CW);
}

template <bool BF, bool FROM_X>
__global__ void __launch_bounds__(NT)
bwd2_sweep2_kernel(const RowT<BF>* __restrict__ x, int C0, int64_t N,
                   int64_t ntiles, const RowT<BF>* __restrict__ p1,
                   const float* __restrict__ W1,
                   const float* __restrict__ vec,
                   const RowT<BF>* __restrict__ p2,
                   const RowT<BF>* __restrict__ q3,
                   const float* __restrict__ M3, const float* __restrict__ W2,
                   double* __restrict__ partM, double* __restrict__ partV,
                   double* __restrict__ partX, double* __restrict__ partU) {
  extern __shared__ float sm[];
  float* M3s = sm;                      // CW*CW
  float* W2t = M3s + CW * CW;           // CW*CW, W2t[c][j] = W2[j][c]
  float* W1s = W2t + CW * CW + 3 * TR * LD + TR * C0MAX;   // C0MAX*CW
  float* v = W1s + C0MAX * CW;          // 7*CW
  if (blockIdx.y == 0) {
    copy_vec_p<BF>(M3s, M3, CW * CW);
    for (int e = threadIdx.x; e < CW * CW; e += NT) {
      const int c = e / CW, j = e % CW;
      W2t[e] = rb_if<BF>(W2[j * CW + c]);
    }
  }
  if (FROM_X) copy_vec_p<BF>(W1s, W1, C0 * CW);
  copy_vec_p<BF>(v, vec, CW);
  copy_vec(v + CW, vec + CW, 5 * CW);
  copy_vec_p<BF>(v + 6 * CW, vec + 6 * CW, CW);
  __syncthreads();
  if (blockIdx.y == 0)
    sweep2_dy_slice<BF, FROM_X>(x, C0, N, ntiles, p1, p2, q3, sm, partM,
                                partV, partX);
  else
    sweep2_u_slice<BF, FROM_X>(x, C0, N, ntiles, p1, sm, partU);
}

// -- launchers ---------------------------------------------------------

template <bool BF>
int launch_fwd_layer(const RowT<BF>* in, int64_t R, int cin, int affine,
                     const float* W, const float* vec, RowT<BF>* p,
                     double* part, int nblk, void* stream) {
  if (R % TR != 0 || cin < 1 || (affine ? cin != CW : cin > C0MAX - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (CW * CW + TR * LD + 3 * CW) +
                      sizeof(double) * 2 * 16 * CW;
  cudaError_t e = prepare(fwd_layer_kernel<BF>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_layer_kernel<BF><<<nblk, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      in, cin, affine, R / TR, W, vec, p, part);
  return static_cast<int>(cudaGetLastError());
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

template <bool BF>
int launch_fwd_pool(const RowT<BF>* p2, int64_t R, int pool, const float* vec,
                    const float* W3, RowT<BF>* pooled, int nblk,
                    void* stream) {
  if (bad_pool(R, pool)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (CW * C3W + TR * LDZ + TR * LD +
                                       2 * CW + 3 * C3W);
  cudaError_t e = prepare(fwd_pool_kernel<BF>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_pool_kernel<BF><<<nblk, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      p2, R / TR, pool, vec, W3, pooled);
  return static_cast<int>(cudaGetLastError());
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

template <bool BF>
int launch_bwd2_sweep2(const RowT<BF>* x, int B, int C0, int N,
                       const RowT<BF>* p1, const float* W1, const float* vec,
                       const RowT<BF>* p2, const RowT<BF>* q3,
                       const float* M3, const float* W2, double* partM,
                       double* partV, double* partX, double* partU, int nblk,
                       void* stream) {
  const int64_t R = (int64_t)B * N;
  if (bad_shape(C0, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * CW * CW + 3 * TR * LD +
                                       TR * C0MAX + C0MAX * CW + 7 * CW);
  const dim3 grid(nblk, 1 + (C0 + 2) / 2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p1 == nullptr) {
    e = prepare(bwd2_sweep2_kernel<BF, true>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    bwd2_sweep2_kernel<BF, true><<<grid, NT, smem, st>>>(
        x, C0, N, R / TR, p1, W1, vec, p2, q3, M3, W2, partM, partV, partX,
        partU);
  } else {
    e = prepare(bwd2_sweep2_kernel<BF, false>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    bwd2_sweep2_kernel<BF, false><<<grid, NT, smem, st>>>(
        x, C0, N, R / TR, p1, W1, vec, p2, q3, M3, W2, partM, partV, partX,
        partU);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every launcher: nblk persistent blocks over R / 64 row tiles (times the
// slices of bwd2_sweep2); returns cudaGetLastError() (0 on success). The
// _bf16 entry points take the row tensors as bf16 and the same f32
// parameters.
using bf16_t = __nv_bfloat16;

extern "C" int facl_sa_fwd_layer(const float* in, int64_t R, int cin,
                                 int affine, const float* W, const float* vec,
                                 float* p, double* part, int nblk,
                                 void* stream) {
  return launch_fwd_layer<false>(in, R, cin, affine, W, vec, p, part, nblk,
                                 stream);
}

extern "C" int facl_sa_fwd_layer_bf16(const bf16_t* in, int64_t R, int cin,
                                      int affine, const float* W,
                                      const float* vec, bf16_t* p,
                                      double* part, int nblk, void* stream) {
  return launch_fwd_layer<true>(in, R, cin, affine, W, vec, p, part, nblk,
                                stream);
}

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

// p1 == nullptr: B6 (h1 from x by h1_tile; x channel-major (B, C0, N)).
// Otherwise B8b (h1 from p1; x row-major, passed as B = R, N = 1).
extern "C" int facl_sa_bwd2_sweep2(const float* x, int B, int C0, int N,
                                   const float* p1, const float* W1,
                                   const float* vec, const float* p2,
                                   const float* q3, const float* M3,
                                   const float* W2, double* partM,
                                   double* partV, double* partX,
                                   double* partU, int nblk, void* stream) {
  return launch_bwd2_sweep2<false>(x, B, C0, N, p1, W1, vec, p2, q3, M3, W2,
                                   partM, partV, partX, partU, nblk, stream);
}

extern "C" int facl_sa_bwd2_sweep2_bf16(const bf16_t* x, int B, int C0,
                                        int N, const bf16_t* p1,
                                        const float* W1, const float* vec,
                                        const bf16_t* p2, const bf16_t* q3,
                                        const float* M3, const float* W2,
                                        double* partM, double* partV,
                                        double* partX, double* partU,
                                        int nblk, void* stream) {
  return launch_bwd2_sweep2<true>(x, B, C0, N, p1, W1, vec, p2, q3, M3, W2,
                                  partM, partV, partX, partU, nblk, stream);
}
