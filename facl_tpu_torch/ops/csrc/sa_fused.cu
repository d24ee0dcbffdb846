// B9: the generic fused set-abstraction stage, sa_impl="pallas" —
// [Dense -> BatchNorm(train) -> ReLU] x L then the max over each group of
// `pool` consecutive rows, forward and backward (with the input gradient),
// recomputing every activation per tile instead of storing it.
//
// Replaces the TPU kernels of facl_tpu/ops/pallas/sa_kernel.py:
//   sa_train_forward_unified  (pallas_call :282; the multi-call form's
//                              _grid_call :152 in sa_train_forward_pallas)
//   sa_train_backward_unified (pallas_call :480; sa_train_backward_pallas)
// The TPU runs each as one call whose grid walks L + 1 phases in order,
// a phase's statistics finalised at the first tile of the next. A GPU's
// blocks run in no order, so each phase is one launch here (mode below):
//   mode 0  stats sweep of layer `target`: layers < target recomputed with
//           their finalised statistics, per-column sums of p and p^2
//   mode 1  pool sweep: all layers, max of relu(y) over each group
//   mode 2  BN-sum sweep of layer `target` (L-1 down to 0): the forward
//           recomputed, the pooled cotangent split evenly among each
//           group's exact ties (_pool_grad :513), propagated down to
//           layer target, per-column sums of dy and dy * xhat
//   mode 3  final sweep: propagated to the input; per-block dW and db of
//           every layer, and dx = dp0 W0^T when `out` is given
// so the forward is L + 1 launches and the backward L + 1. Statistics are
// finalised between launches on the host, as the TPU kernel does between
// phases (sa_kernel.py:206-214).
//
// Every sweep runs the same tile code (prefix, chunk_p, route_top), so the
// recomputed activations, ReLU masks and pool routing are bit-identical in
// all four backward launches and equal to what the pool sweep pooled.
// Arithmetic follows the JAX kernel's op chain: p = hW + b; y = p * ay +
// by and xhat = p * inv + bx with the folded per-channel affines
// (_layer_forward :54-80); dp = gi * ((dy - sdy/R) - xhat * sdyx/R)
// (_backprop_to :532-560).
//
// What bounds it on the card: f32 operations. At the main path's widths
// (C0 = 4 -> 64 -> 64 -> 256) the recomputes cost 46,080 MAC per row over
// the forward's four launches and 161,280 over the backward's (with dx).
// Design, kept simple: persistent blocks of 256 threads walk tiles of 64
// rows (128 when pool > 64) that hold whole groups. Layer outputs are made
// in chunks of 64 columns by register-tiled products on CUDA cores (strict
// f32, the weights read through the L1 cache); the pre-activations of the
// layers below the top stay in shared memory for the backward, and the top
// layer (up to 256 wide) is never stored whole: each 64-column chunk is
// pooled, routed and pushed down (da += dp W^T) before the next. Column
// sums are per-block float64 partials, and dW is a float64 accumulator
// private to each block in device memory; the host sums the blocks in a
// fixed order, so every result is deterministic and no atomics are used.
//
// compute_dtype bfloat16 (template BF, entry facl_sa_fused_bf16): the same
// kernel with one rounding at each cast point that the JAX kernel at bf16
// rounds (its interpret-mode outputs show which; sa_kernel.py:45-80,
// :513-560): x rounded to bf16 at load; each product h W (bf16 operands:
// the host passes the rounded weights) summed in f32 and rounded, the
// rounded bias added in f32 and kept unrounded; y rounded before the ReLU,
// its mask and the pool (ties on the bf16 activations); dp rounded before
// da = dp W^T for the layers above 0, while dW, db and dx = dp0 W0^T
// take the f32 dp (the host passes the f32 W0^T). P stays f32 in shared
// memory, so the layout is the same. The f32 instantiation's code is
// unchanged: every bf16 cast sits behind `if constexpr (BF)`.
#include <cstdint>
#include <cuda_bf16.h>
#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads per block
constexpr int CH = 64;           // columns per product chunk (NT == 4 CH)
constexpr int C0MAX = 8;         // input channels
constexpr int LMAX = 4;          // layers
constexpr int WMAX = 256;        // layer width
constexpr int NVEC = 8;          // per-layer vector rows in `vec`
constexpr size_t kSmemMax = 227 * 1024;

// vec (L, NVEC, WMAX): per-layer, per-channel vectors made on the host.
enum { VB = 0, VINV, VBX, VAY, VBY, VGI, VSDY, VSDYX };

struct Net {
  int64_t R;
  int L, C0, pool;
  int w[LMAX], cin[LMAX];
  int64_t woff[LMAX], wtoff[LMAX];   // W_l, W_l^T in prm
  int dwoff[LMAX], dboff[LMAX];      // dW_l, db_l in a block's partial
  int ndw, nb;                       // floats of all dW, all db
  int pcum[LMAX];                    // column offset of P_l in P
  int smid, wa, wbuf;                // sum / max of the lower widths; DA
};

bool make_net(int64_t R, int C0, int L, const int* w, int pool, Net* n) {
  if (L < 1 || L > LMAX || C0 < 1 || C0 > C0MAX || pool < 1 ||
      pool > 2 * CH || R < 1 || R % pool != 0)
    return false;
  n->R = R;
  n->L = L;
  n->C0 = C0;
  n->pool = pool;
  int64_t po = 0;
  int dw = 0, db = 0, smid = 0, wa = 1;
  for (int l = 0; l < L; ++l) {
    if (w[l] < 1 || w[l] > WMAX) return false;
    n->w[l] = w[l];
    n->cin[l] = l ? w[l - 1] : C0;
    n->woff[l] = po;
    n->wtoff[l] = po + static_cast<int64_t>(n->cin[l]) * w[l];
    po += 2 * static_cast<int64_t>(n->cin[l]) * w[l];
    n->dwoff[l] = dw;
    dw += n->cin[l] * w[l];
    n->dboff[l] = db;
    db += w[l];
    n->pcum[l] = smid;
    if (l < L - 1) {
      smid += w[l];
      wa = w[l] > wa ? w[l] : wa;
    }
  }
  n->ndw = dw;
  n->nb = db;
  n->smid = smid;
  n->wa = wa;
  n->wbuf = wa > CH ? wa : CH;
  return true;
}

int tile_rows(int pool) { return pool <= CH ? CH : 2 * CH; }

// Shared memory: vacc (float64 column sums) | xs | P | AS | ZC | red | DA |
// DB, the last two for the backward only. Returns the bytes.
__host__ __device__ inline size_t layout(const Net& n, int TR, bool bwd,
                                         size_t off[7]) {
  const int nv = n.nb > 2 * WMAX ? n.nb : 2 * WMAX;
  size_t o = sizeof(double) * nv;
  off[0] = o; o += sizeof(float) * TR * C0MAX;      // xs: input rows
  off[1] = o; o += sizeof(float) * TR * n.smid;     // P_l, l < L - 1
  off[2] = o; o += sizeof(float) * TR * n.wa;       // AS: one activation
  off[3] = o; o += sizeof(float) * TR * CH;         // ZC: top-layer chunk
  off[4] = o; o += sizeof(float) * 8 * CH;          // red: column sums
  off[5] = o; o += bwd ? sizeof(float) * TR * n.wbuf : 0;   // DA
  off[6] = o; o += bwd ? sizeof(float) * TR * n.wbuf : 0;   // DB
  return o;
}

__device__ __forceinline__ float vget(const float* __restrict__ vec, int l,
                                      int q, int c) {
  return __ldg(vec + (l * NVEC + q) * WMAX + c);
}

__device__ __forceinline__ float affine(float p, float a, float b) {
  return __fadd_rn(__fmul_rn(p, a), b);
}

// v at a cast point of the compute dtype: rounded to bf16 (kept in f32)
// under BF, else unchanged.
template <bool BF>
__device__ __forceinline__ float cast(float v) {
  if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Round n floats of shared memory to bf16 in place (BF only), between two
// barriers: the operand dp of da = dp W^T.
template <bool BF>
__device__ __forceinline__ void round_smem(float* a, int n) {
  if constexpr (BF) {
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += NT) a[e] = cast<true>(a[e]);
    __syncthreads();
  }
}

// acc[i][j] = sum_{k < kdim} A[r][k] B[k][c], r = ty + 16 i, c = tx + 16 j
// (c < ncols); A in shared memory, B in device memory (row stride ldb).
template <int TR>
__device__ __forceinline__ void prod(const float* A, int lda, int kdim,
                                     const float* __restrict__ B, int ldb,
                                     int ncols, float (&acc)[TR / 16][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  bool cv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) cv[j] = tx + 16 * j < ncols;
#pragma unroll
  for (int i = 0; i < TR / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kdim; ++k) {
    float a[TR / 16], b[4];
#pragma unroll
    for (int i = 0; i < TR / 16; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = cv[j] ? __ldg(B + static_cast<int64_t>(k) * ldb + tx + 16 * j)
                   : 0.f;
#pragma unroll
    for (int i = 0; i < TR / 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// out[r][c] = (A W_l)[r][c0 + c] + b_l[c0 + c] for c < nc; `out` points at
// the chunk's first column. The one function every sweep computes a
// pre-activation with (under BF the product is rounded before the add).
template <int TR, bool BF>
__device__ __forceinline__ void chunk_p(const Net& n,
                                        const float* __restrict__ prm,
                                        const float* __restrict__ vec, int l,
                                        const float* A, int lda, int c0,
                                        int nc, float* out, int ldo) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[TR / 16][4];
  prod<TR>(A, lda, n.cin[l], prm + n.woff[l] + c0, n.w[l], nc, acc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tx + 16 * j;
    if (c >= nc) continue;
    const float b = vget(vec, l, VB, c0 + c);
#pragma unroll
    for (int i = 0; i < TR / 16; ++i)
      out[(ty + 16 * i) * ldo + c] = __fadd_rn(cast<BF>(acc[i][j]), b);
  }
}

// out (+)= A B for all `ncols` columns of B, in chunks of CH.
template <int TR>
__device__ void prod_store(const float* A, int lda, int kdim,
                           const float* __restrict__ B, int ldb, int ncols,
                           float* out, int ldo, bool add) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int oc0 = 0; oc0 < ncols; oc0 += CH) {
    const int nc = ncols - oc0 < CH ? ncols - oc0 : CH;
    float acc[TR / 16][4];
    prod<TR>(A, lda, kdim, B + oc0, ldb, nc, acc);
#pragma unroll
    for (int i = 0; i < TR / 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        if (c >= nc) continue;
        float* o = out + (ty + 16 * i) * ldo + oc0 + c;
        *o = add ? __fadd_rn(*o, acc[i][j]) : acc[i][j];
      }
  }
}

// AS = relu(P_l * ay + by): layer l's activation, the next layer's input.
template <int TR, bool BF>
__device__ void to_act(const float* __restrict__ vec, int l, const float* Pl,
                       int w, float* AS) {
  for (int e = threadIdx.x; e < TR * w; e += NT) {
    const int c = e % w;
    AS[e] = fmaxf(cast<BF>(affine(Pl[e], vget(vec, l, VAY, c),
                                  vget(vec, l, VBY, c))),
                  0.f);
  }
}

// Load the tile's input rows (zeros past nrows) and run layers < upto:
// P_l = pre-activations, AS = the activation of layer upto - 1.
template <int TR, bool BF>
__device__ void prefix(const Net& n, const float* __restrict__ x,
                       const float* __restrict__ prm,
                       const float* __restrict__ vec, int64_t r0, int nrows,
                       int upto, float* xs, float* P, float* AS) {
  for (int e = threadIdx.x; e < TR * C0MAX; e += NT) {
    const int r = e / C0MAX, c = e % C0MAX;
    xs[e] = (r < nrows && c < n.C0) ? cast<BF>(x[(r0 + r) * n.C0 + c]) : 0.f;
  }
  __syncthreads();
  for (int l = 0; l < upto; ++l) {
    const int w = n.w[l];
    float* Pl = P + TR * n.pcum[l];
    const float* A = l ? AS : xs;
    const int lda = l ? n.w[l - 1] : C0MAX;
    for (int c0 = 0; c0 < w; c0 += CH)
      chunk_p<TR, BF>(n, prm, vec, l, A, lda, c0, w - c0 < CH ? w - c0 : CH,
                      Pl + c0, w);
    __syncthreads();
    to_act<TR, BF>(vec, l, Pl, w, AS);
    __syncthreads();
  }
}

// s1[c] += sum_{r < nrows} A[r][c]; s2[c] += sum of A[r][c]^2 (square) or
// of B[r][c]. Four row quarters per column in float32, then float64.
template <int TR>
__device__ void colsums(const float* A, int lda, const float* B, int ldb,
                        bool square, int ncols, int nrows, double* s1,
                        double* s2, float* red) {
  const int t = threadIdx.x, c = t % CH, q = t / CH;
  for (int c0 = 0; c0 < ncols; c0 += CH) {
    float a1 = 0.f, a2 = 0.f;
    if (c0 + c < ncols)
      for (int r = q; r < nrows; r += 4) {
        const float v = A[r * lda + c0 + c];
        a1 += v;
        if (s2) a2 += square ? __fmul_rn(v, v) : B[r * ldb + c0 + c];
      }
    red[q * CH + c] = a1;
    red[(4 + q) * CH + c] = a2;
    __syncthreads();
    if (t < 2 * CH) {
      const int which = t / CH, cc = t % CH;
      double* s = which ? s2 : s1;
      if (s != nullptr && c0 + cc < ncols) {
        double d = 0.0;
        for (int k = 0; k < 4; ++k) d += red[(4 * which + k) * CH + cc];
        s[c0 + cc] += d;
      }
    }
    __syncthreads();
  }
}

// g[k][c] += sum_{r < nrows} A[r][k] B[r][c] for k < m, c < ncols; g is
// this block's private float64 accumulator (row stride ldg).
template <int TR>
__device__ void atb_global(const float* A, int lda, int m, const float* B,
                           int ldb, int ncols, int nrows,
                           double* __restrict__ g, int ldg) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int m0 = 0; m0 < m; m0 += CH)
    for (int n0 = 0; n0 < ncols; n0 += CH) {
      bool rv[4], cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rv[i] = m0 + ty + 16 * i < m;
#pragma unroll
      for (int j = 0; j < 4; ++j) cv[j] = n0 + tx + 16 * j < ncols;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int r = 0; r < nrows; ++r) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = rv[i] ? A[r * lda + m0 + ty + 16 * i] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = cv[j] ? B[r * ldb + n0 + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (rv[i] && cv[j])
            g[static_cast<int64_t>(m0 + ty + 16 * i) * ldg + n0 + tx +
              16 * j] += acc[i][j];
    }
}

// Top layer, one chunk: ZC holds p (TR x CH, nc columns). Per (group,
// column): m = max relu(y), cnt = its exact ties, share = dout / cnt; dy =
// share on the tied rows with y > 0, else 0 (a dead group's ties all have
// y <= 0, so cnt >= 1 never meets a zero). With D2: ZC = dy, D2 = dy *
// xhat (the BN sums of the top layer); without: ZC = dp, zero past nrows.
// Under BF, y is rounded first: ties, mask and max on the bf16 values.
template <int TR, bool BF>
__device__ void route_top(const Net& n, const float* __restrict__ vec,
                          const float* __restrict__ dout, int64_t g0, int ng,
                          int nrows, int c0, int nc, float* ZC, float* D2) {
  const int l = n.L - 1, pool = n.pool;
  for (int e = threadIdx.x; e < ng * CH; e += NT) {
    const int g = e / CH, c = e % CH;
    if (c >= nc) continue;
    const int cc = c0 + c;
    const float ay = vget(vec, l, VAY, cc), by = vget(vec, l, VBY, cc);
    const float inv = vget(vec, l, VINV, cc), bx = vget(vec, l, VBX, cc);
    float* z = ZC + g * pool * CH + c;
    float m = 0.f;
    int cnt = 0;
    for (int r = 0; r < pool; ++r) {
      const float h = fmaxf(cast<BF>(affine(z[r * CH], ay, by)), 0.f);
      if (h > m) {
        m = h;
        cnt = 1;
      } else if (h == m) {
        ++cnt;
      }
    }
    const float share =
        __fdiv_rn(__ldg(dout + (g0 + g) * n.w[l] + cc), (float)cnt);
    const float gi = vget(vec, l, VGI, cc), sdy = vget(vec, l, VSDY, cc);
    const float sdyx = vget(vec, l, VSDYX, cc);
    for (int r = 0; r < pool; ++r) {
      const float p = z[r * CH];
      const float y = cast<BF>(affine(p, ay, by));
      const float dy = (y > 0.f && fmaxf(y, 0.f) == m) ? share : 0.f;
      const float xh = affine(p, inv, bx);
      if (D2 != nullptr) {
        z[r * CH] = dy;
        D2[(g * pool + r) * CH + c] = __fmul_rn(dy, xh);
      } else {
        z[r * CH] = __fmul_rn(
            gi, __fsub_rn(__fsub_rn(dy, sdy), __fmul_rn(xh, sdyx)));
      }
    }
  }
  if (D2 == nullptr)
    for (int e = nrows * CH + threadIdx.x; e < TR * CH; e += NT) ZC[e] = 0.f;
}

// Layer l < L - 1: cur holds da_l (TR x w). dy = da where y > 0 (y
// rounded under BF); with oth: cur = dy, oth = dy * xhat; without: cur =
// dp (zero past nrows).
template <int TR, bool BF>
__device__ void mid_dy(const float* __restrict__ vec, int l, const float* Pl,
                       int w, int nrows, float* cur, float* oth) {
  for (int e = threadIdx.x; e < TR * w; e += NT) {
    const int r = e / w, c = e % w;
    const float p = Pl[e];
    const float y =
        cast<BF>(affine(p, vget(vec, l, VAY, c), vget(vec, l, VBY, c)));
    const float dy = y > 0.f ? cur[e] : 0.f;
    const float xh = affine(p, vget(vec, l, VINV, c), vget(vec, l, VBX, c));
    if (oth != nullptr) {
      cur[e] = dy;
      oth[e] = __fmul_rn(dy, xh);
    } else {
      cur[e] = r < nrows
                   ? __fmul_rn(vget(vec, l, VGI, c),
                               __fsub_rn(__fsub_rn(dy, vget(vec, l, VSDY, c)),
                                         __fmul_rn(xh, vget(vec, l,
                                                            VSDYX, c))))
                   : 0.f;
    }
  }
}

template <int TR, bool BF>
__global__ void __launch_bounds__(NT)
sa_fused_kernel(const Net n, int mode, int target,
                const float* __restrict__ x, const float* __restrict__ prm,
                const float* __restrict__ vec,
                const float* __restrict__ dout, float* __restrict__ out,
                double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smraw[];
  size_t off[7];
  layout(n, TR, mode >= 2, off);
  double* vacc = reinterpret_cast<double*>(smraw);
  float* xs = reinterpret_cast<float*>(smraw + off[0]);
  float* P = reinterpret_cast<float*>(smraw + off[1]);
  float* AS = reinterpret_cast<float*>(smraw + off[2]);
  float* ZC = reinterpret_cast<float*>(smraw + off[3]);
  float* red = reinterpret_cast<float*>(smraw + off[4]);
  float* DA = reinterpret_cast<float*>(smraw + off[5]);
  float* DB = reinterpret_cast<float*>(smraw + off[6]);

  const int top = n.L - 1;
  const int nv = n.nb > 2 * WMAX ? n.nb : 2 * WMAX;
  for (int e = threadIdx.x; e < nv; e += NT) vacc[e] = 0.0;
  double* blk = part + static_cast<int64_t>(blockIdx.x) * (n.ndw + n.nb);
  __syncthreads();

  const int gpt = TR / n.pool;                      // groups per tile
  const int64_t G = n.R / n.pool;
  const int64_t ntiles = (G + gpt - 1) / gpt;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t g0 = t * gpt;
    const int ng = static_cast<int>(G - g0 < gpt ? G - g0 : gpt);
    const int nrows = ng * n.pool;
    const int64_t r0 = g0 * n.pool;
    const int lt = mode == 0 ? target : top;        // the chunked layer
    prefix<TR, BF>(n, x, prm, vec, r0, nrows, lt, xs, P, AS);
    const float* A = lt ? AS : xs;
    const int lda = lt ? n.w[lt - 1] : C0MAX;
    const int wl = n.w[lt], cin = n.cin[lt];
    const bool sums_top = mode == 2 && target == top;
    for (int c0 = 0; c0 < wl; c0 += CH) {
      const int nc = wl - c0 < CH ? wl - c0 : CH;
      chunk_p<TR, BF>(n, prm, vec, lt, A, lda, c0, nc, ZC, CH);
      __syncthreads();
      if (mode == 0) {
        colsums<TR>(ZC, CH, nullptr, 0, true, nc, nrows, vacc + c0,
                    vacc + WMAX + c0, red);
        continue;
      }
      if (mode == 1) {
        const float* ay = vec + (top * NVEC + VAY) * WMAX + c0;
        const float* by = vec + (top * NVEC + VBY) * WMAX + c0;
        for (int e = threadIdx.x; e < ng * CH; e += NT) {
          const int g = e / CH, c = e % CH;
          if (c >= nc) continue;
          float m = 0.f;
          for (int r = 0; r < n.pool; ++r)
            m = fmaxf(m, fmaxf(cast<BF>(affine(ZC[(g * n.pool + r) * CH + c],
                                               __ldg(ay + c), __ldg(by + c))),
                               0.f));
          out[(g0 + g) * wl + c0 + c] = m;
        }
        __syncthreads();
        continue;
      }
      route_top<TR, BF>(n, vec, dout, g0, ng, nrows, c0, nc, ZC,
                        sums_top ? DA : nullptr);
      __syncthreads();
      if (sums_top) {
        colsums<TR>(ZC, CH, DA, CH, false, nc, nrows, vacc + c0,
                    vacc + WMAX + c0, red);
        continue;
      }
      if (mode == 3) {
        atb_global<TR>(A, lda, cin, ZC, CH, nc, nrows,
                       blk + n.dwoff[top] + c0, wl);
        colsums<TR>(ZC, CH, nullptr, 0, false, nc, nrows,
                    vacc + n.dboff[top] + c0, nullptr, red);
      }
      if (top >= 1) round_smem<BF>(ZC, TR * CH);     // da's operand dp
      if (top >= 1 || out != nullptr)               // da of the layer below
        prod_store<TR>(ZC, CH, nc, prm + n.wtoff[top] + c0 * cin, cin, cin,
                       DA, cin, c0 > 0);
      __syncthreads();
    }
    if (mode < 2 || sums_top) continue;

    float* cur = DA;
    float* oth = DB;
    for (int l = top - 1; l >= 0; --l) {
      const int w = n.w[l];
      const float* Pl = P + TR * n.pcum[l];
      if (mode == 2 && l == target) {
        mid_dy<TR, BF>(vec, l, Pl, w, nrows, cur, oth);
        __syncthreads();
        colsums<TR>(cur, w, oth, w, false, w, nrows, vacc, vacc + WMAX,
                    red);
        break;
      }
      mid_dy<TR, BF>(vec, l, Pl, w, nrows, cur, nullptr);
      __syncthreads();
      if (mode == 3) {
        const float* Ain = xs;
        int ldin = C0MAX;
        if (l >= 1) {
          to_act<TR, BF>(vec, l - 1, P + TR * n.pcum[l - 1], n.w[l - 1],
                         AS);
          __syncthreads();
          Ain = AS;
          ldin = n.w[l - 1];
        }
        atb_global<TR>(Ain, ldin, n.cin[l], cur, w, w, nrows,
                       blk + n.dwoff[l], w);
        colsums<TR>(cur, w, nullptr, 0, false, w, nrows,
                    vacc + n.dboff[l], nullptr, red);
      }
      if (l >= 1) round_smem<BF>(cur, TR * w);      // da's operand dp
      if (l >= 1 || out != nullptr) {
        prod_store<TR>(cur, w, w, prm + n.wtoff[l], n.cin[l], n.cin[l], oth,
                       n.cin[l], false);
        __syncthreads();
        float* s = cur;
        cur = oth;
        oth = s;
      }
    }
    if (mode == 3 && out != nullptr) {               // cur = dx (TR x C0)
      for (int e = threadIdx.x; e < nrows * n.C0; e += NT)
        out[r0 * n.C0 + e] = cur[e];
    }
    __syncthreads();
  }

  if (mode == 3) {
    for (int e = threadIdx.x; e < n.nb; e += NT) blk[n.ndw + e] = vacc[e];
  } else if (mode != 1) {
    const int w = n.w[target];
    for (int e = threadIdx.x; e < 2 * w; e += NT)
      part[static_cast<int64_t>(blockIdx.x) * 2 * w + e] =
          vacc[(e / w) * WMAX + e % w];
  }
}

template <int TR, bool BF>
int launch(const Net& n, int mode, int target, const float* x,
           const float* prm, const float* vec, const float* dout, float* out,
           double* part, int nblk, cudaStream_t st) {
  size_t off[7];
  const size_t smem = layout(n, TR, mode >= 2, off);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      sa_fused_kernel<TR, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  sa_fused_kernel<TR, BF><<<nblk, NT, smem, st>>>(n, mode, target, x, prm,
                                                  vec, dout, out, part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of the backward's launches (the largest) in bytes, or -1
// outside the kernel's range (1 <= L <= 4, C0 <= 8, widths <= 256,
// pool <= 128 dividing R).
extern "C" long long facl_sa_fused_smem(long long R, int C0, int L,
                                        const int* widths, int pool) {
  Net n;
  if (!make_net(R, C0, L, widths, pool, &n)) return -1;
  size_t off[7];
  return static_cast<long long>(layout(n, tile_rows(pool), true, off));
}

template <bool BF>
int sweep(int mode, int target, const float* x, long long R, int C0, int L,
          const int* widths, int pool, const float* prm, const float* vec,
          const float* dout, float* out, double* part, int nblk,
          void* stream) {
  Net n;
  if (!make_net(R, C0, L, widths, pool, &n) || mode < 0 || mode > 3 ||
      ((mode == 0 || mode == 2) && (target < 0 || target >= L)) ||
      (mode == 1 && out == nullptr) || nblk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tile_rows(pool) == CH
             ? launch<CH, BF>(n, mode, target, x, prm, vec, dout, out, part,
                              nblk, st)
             : launch<2 * CH, BF>(n, mode, target, x, prm, vec, dout, out,
                                  part, nblk, st);
}

// One sweep (mode 0-3, see the top of this file) over x (R, C0) row-major.
// prm: W_0, W_0^T, W_1, W_1^T, ...; vec (L, 8, 256). part: (nblk, 2,
// w_target) float64 for modes 0 and 2; (nblk, sum cin*w + sum w) float64,
// zeroed, for mode 3. out: pooled (R / pool, w_top) for mode 1; dx (R, C0)
// or null for mode 3.
extern "C" int facl_sa_fused(int mode, int target, const float* x,
                             long long R, int C0, int L, const int* widths,
                             int pool, const float* prm, const float* vec,
                             const float* dout, float* out, double* part,
                             int nblk, void* stream) {
  return sweep<false>(mode, target, x, R, C0, L, widths, pool, prm, vec,
                      dout, out, part, nblk, stream);
}

// The same sweep at compute_dtype bfloat16 (see the top of this file), on
// the same f32 arguments: prm holds the bf16-rounded W_l and W_l^T but the
// f32 W_0^T (dx's operand), vec the rounded bias; pooled holds bf16 values.
extern "C" int facl_sa_fused_bf16(int mode, int target, const float* x,
                                  long long R, int C0, int L,
                                  const int* widths, int pool,
                                  const float* prm, const float* vec,
                                  const float* dout, float* out, double* part,
                                  int nblk, void* stream) {
  return sweep<true>(mode, target, x, R, C0, L, widths, pool, prm, vec, dout,
                     out, part, nblk, stream);
}
