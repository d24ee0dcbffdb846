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
// operations (the same product plus Gram(h2); dy3 is nonzero only at the
// pool winners, and A3 and q3 skip its zeros), bwd2_sweep2 by operations
// (two 64x64 products and C0 + 3 Grams of 64x64 per row, ~190 GFLOP).
// Design, kept simple: sa_pair.cu's persistent blocks over 64-row tiles,
// register-tiled products on CUDA cores (strict f32), no copy/compute
// overlap.
//
// bf16 (the template flag BF, entry points facl_sa_*_bf16): the row
// tensors (x, p1, p2, q3, dpooled, pooled) are __nv_bfloat16, the
// parameters the TPU kernels cast to the compute dtype (W1, b1, W2, W3,
// b3, M3, gi2, gi3) are rounded to bf16 where they are staged, and the
// results are rounded (rb) at the TPU kernels' cast points, listed by the
// bf16 twins of ops/sa_fwd.py and ops/sa_bwd.py. Every product then has
// two bf16 operands and is exact in f32, so the same f32 FMA chains sum
// them (only the order of the sums differs from the twins), and the
// per-block float64 partials stay. The ReLU masks are decided on the
// bf16-rounded h (relu_affine_p); B6's h1 is sa_pair.cu's bf16 h1 bit for
// bit (h1_of, the same k-order chain). Every f32 path is the code it was
// before the template: the bf16 casts sit in `if constexpr (BF)` branches.
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
// The pool sweep (B7c) and the backward's sweep 1 (B8a) both call this
// one function, so the max a hybrid2 backward finds is the max its
// forward pooled. At BF p3 = bf16(h2 W3) + b3 (b3 staged rounded), summed
// in f32, and z stays f32 (sa_bwd.py:76-78).
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
// B8a: recompute z per tile (z_tile, as B7c); split each group's pooled
// cotangent evenly among the rows whose relu(z) reaches the group's max,
// when that max is > 0 (_dy_top, sa_bwd.py:70-91); accumulate A3 = dy3^T
// h2 (256, 64), u3 = sum dy3, Gram(h2) and colsum(h2); write the row
// output q3 = (gi3 * dy3) W3^T (R, 64). dy3 overwrites z in shared memory
// and never reaches device memory; A3 and q3 skip its zeros, so their
// cost follows the winners (one row per (group, channel), more on exact
// ties). A group spanning tiles (pool > TR) is walked twice: once for its
// max and tie count, once to route.
// vec = [mul2 | shift2 | b3 | mul3 | shift3 | gi3]; partA (blocks, 256,
// 64), partu (blocks, 256), partG (blocks, 64, 64), partc (blocks, 64).
// At BF the routing is decided on the f32 z, the split share is rounded to
// bf16 (dy3), and q3 = bf16(sum bf16(dy3 gi3) W3) (sa_bwd.py:110-135).
template <bool BF>
__global__ void __launch_bounds__(NT)
bwd2_sweep1_kernel(const RowT<BF>* __restrict__ p2, int64_t ntiles, int pool,
                   const float* __restrict__ vec,
                   const float* __restrict__ W3,
                   const RowT<BF>* __restrict__ dpooled,
                   RowT<BF>* __restrict__ q3,
                   double* __restrict__ partA, double* __restrict__ partu,
                   double* __restrict__ partG, double* __restrict__ partc) {
  extern __shared__ float sm[];
  float* W3s = sm;                      // CW*C3W
  float* zs = W3s + CW * C3W;           // TR*LDZ: z, then dy3
  float* h2s = zs + TR * LDZ;           // TR*LD
  float* q3s = h2s + TR * LD;           // TR*LD
  float* v = q3s + TR * LD;             // 2*CW + 4*C3W
  const float* vec3 = v + 2 * CW;
  const float* gi3 = v + 2 * CW + 3 * C3W;

  copy_vec_p<BF>(W3s, W3, CW * C3W);
  copy_vec(v, vec, 2 * CW);
  copy_vec_p<BF>(v + 2 * CW, vec + 2 * CW, C3W);
  copy_vec(v + 2 * CW + C3W, vec + 2 * CW + C3W, 2 * C3W);
  copy_vec_p<BF>(v + 2 * CW + 3 * C3W, vec + 2 * CW + 3 * C3W, C3W);
  __syncthreads();

  const int gpt = pool <= TR ? TR / pool : 1;
  const int upt = pool <= TR ? 1 : pool / TR;
  const int c = threadIdx.x;            // channel / A3 row (NT == C3W)
  // float32 running sums for A3, as sa_pair.cu's sweep 1: 64 float64
  // registers more would not fit beside the z tile's 64 accumulators.
  float a3[CW];
#pragma unroll
  for (int k = 0; k < CW; ++k) a3[k] = 0.f;
  double u3 = 0.0, ch = 0.0;
  double g[4][4] = {};

  for (int64_t u = blockIdx.x; u < ntiles / upt; u += gridDim.x) {
    float gm = 0.f, gshare = 0.f;       // a group spanning tiles
    if (upt > 1) {
      int n = 0;
      for (int j = 0; j < upt; ++j) {
        load_h_tile_p<BF>(p2, (u * upt + j) * TR, v, v + CW, h2s);
        __syncthreads();
        z_tile<BF>(h2s, W3s, vec3, zs);
        __syncthreads();
        for (int r = 0; r < TR; ++r) {
          const float h = fmaxf(zs[r * LDZ + c], 0.f);
          if (h > gm) {
            gm = h;
            n = 1;
          } else if (h == gm) {
            ++n;
          }
        }
        __syncthreads();
      }
      gshare = gm > 0.f
                   ? rb_if<BF>(__fdiv_rn(to_f(dpooled[u * C3W + c]), (float)n))
                   : 0.f;
    }
    for (int j = 0; j < upt; ++j) {
      const int64_t t = u * upt + j;
      const int64_t r0 = t * TR;
      load_h_tile_p<BF>(p2, r0, v, v + CW, h2s);
      __syncthreads();
      z_tile<BF>(h2s, W3s, vec3, zs);
      {
        float tg[4][4];
        zero_patch(tg);
        acc_atb(h2s, h2s, tg);
        add_patch(g, tg);
      }
      if (threadIdx.x < CW) {
        float tc = 0.f;
        for (int r = 0; r < TR; ++r) tc += h2s[r * LD + threadIdx.x];
        ch += tc;
      }
      __syncthreads();

      // Route: thread c rewrites column c of the tile with dy3.
      float ut = 0.f;
      for (int gi = 0; gi < gpt; ++gi) {
        const int base = pool <= TR ? gi * pool : 0;
        const int rows = pool <= TR ? pool : TR;
        float m = gm, share = gshare;
        if (upt == 1) {
          int n = 0;
          m = 0.f;
          for (int r = 0; r < rows; ++r) {
            const float h = fmaxf(zs[(base + r) * LDZ + c], 0.f);
            if (h > m) {
              m = h;
              n = 1;
            } else if (h == m) {
              ++n;
            }
          }
          share = m > 0.f
                      ? rb_if<BF>(__fdiv_rn(
                            to_f(dpooled[(t * gpt + gi) * C3W + c]),
                            (float)n))
                      : 0.f;
        }
        for (int r = 0; r < rows; ++r) {
          float* zp = zs + (base + r) * LDZ + c;
          const float d = (m > 0.f && *zp == m) ? share : 0.f;
          *zp = d;
          ut += d;
        }
      }
      u3 += ut;
      for (int r = 0; r < TR; ++r) {
        const float d = zs[r * LDZ + c];
        if (d != 0.f) {
          const float* hrow = h2s + r * LD;
#pragma unroll
          for (int k = 0; k < CW; ++k) a3[k] = fmaf(d, hrow[k], a3[k]);
        }
      }
      __syncthreads();

      // q3: thread (quarter, r) owns row r, columns [16 quarter, +16).
      {
        const int r = threadIdx.x & (TR - 1), j0 = (threadIdx.x >> 6) * 16;
        float acc[16];
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) acc[jj] = 0.f;
        const float* drow = zs + r * LDZ;
        for (int k = 0; k < C3W; ++k) {
          const float d = drow[k];
          if (d != 0.f) {
            const float vg = rb_if<BF>(__fmul_rn(d, gi3[k]));
#pragma unroll
            for (int jj = 0; jj < 16; ++jj)
              acc[jj] = fmaf(vg, W3s[(j0 + jj) * C3W + k], acc[jj]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) q3s[r * LD + j0 + jj] = acc[jj];
      }
      __syncthreads();
      store_tile_p<BF>(q3s, r0, q3);
      __syncthreads();
    }
  }
#pragma unroll
  for (int k = 0; k < CW; ++k)
    partA[((int64_t)blockIdx.x * C3W + c) * CW + k] = a3[k];
  partu[(int64_t)blockIdx.x * C3W + c] = u3;
  write_patch(g, partG + (int64_t)blockIdx.x * CW * CW);
  if (threadIdx.x < CW) partc[(int64_t)blockIdx.x * CW + threadIdx.x] = ch;
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

template <bool BF>
int launch_bwd2_sweep1(const RowT<BF>* p2, int64_t R, int pool,
                       const float* vec, const float* W3,
                       const RowT<BF>* dpooled, RowT<BF>* q3, double* partA,
                       double* partu, double* partG, double* partc, int nblk,
                       void* stream) {
  if (bad_pool(R, pool)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (CW * C3W + TR * LDZ + 2 * TR * LD +
                                       2 * CW + 4 * C3W);
  cudaError_t e = prepare(bwd2_sweep1_kernel<BF>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd2_sweep1_kernel<BF>
      <<<nblk, NT, smem, static_cast<cudaStream_t>(stream)>>>(
          p2, R / TR, pool, vec, W3, dpooled, q3, partA, partu, partG,
          partc);
  return static_cast<int>(cudaGetLastError());
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
