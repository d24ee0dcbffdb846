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
// Every sweep runs the same tile code (prefix, chunk_p, route_top; at bf16
// prefix_bf, layer_p, route_bf; on the TF32 tensor cores prefix_tf,
// layer_tf, route_bf), so the recomputed activations, ReLU masks
// and pool routing are bit-identical in all four backward launches and
// equal to what the pool sweep pooled.
// Arithmetic follows the JAX kernel's op chain: p = hW + b; y = p * ay +
// by and xhat = p * inv + bx with the folded per-channel affines
// (_layer_forward :54-80); dp = gi * ((dy - sdy/R) - xhat * sdyx/R)
// (_backprop_to :532-560).
//
// compute_dtype float32 (entry facl_sa_fused). At the main path's widths
// (C0 = 4 -> 64 -> 64 -> 256) the recomputes cost 46,080 MAC per row over
// the forward's four launches and 161,280 over the backward's (with dx).
// Two kernels serve it. sa_fused_tf32_kernel, on the TF32 tensor cores in
// the 3xTF32 split (its design at "B9 at f32 on the TF32 tensor cores"
// below), runs every net whose 64-row layout fits 227 KB (pool <= 64), the
// main path's among them; facl_sa_fused_tc says which kernel serves a net.
// The other nets of the range run sa_fused_kernel<TR, false>, the
// CUDA-core kernel. What bounds that one on the card: f32 operations.
// Its design, kept simple: persistent blocks of 256 threads walk tiles of 64
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
// compute_dtype bfloat16 (entry facl_sa_fused_bf16): one rounding at each
// cast point that the JAX kernel at bf16 rounds (its interpret-mode
// outputs show which; sa_kernel.py:45-80, :513-560): x rounded to bf16 at
// load; each product h W (bf16 operands: the host passes the rounded
// weights) summed in f32 and rounded, the rounded bias added in f32 and
// kept unrounded; y rounded before the ReLU, its mask and the pool (ties
// on the bf16 activations); dp rounded before da = dp W^T for the layers
// above 0, while dW, db and dx = dp0 W0^T take the f32 dp (the host passes
// the f32 W0^T). Two kernels serve it. sa_fused_bf16_kernel, on the bf16
// tensor cores (its design at "B9 at bf16" below), runs every net whose
// layout fits 227 KB, the main path's among them. The other nets of the
// range run sa_fused_kernel<TR, true>: the CUDA-core kernel above with
// every bf16 cast behind `if constexpr (BF)` (the f32 instantiation's code
// is unchanged), its products summed in k order. facl_sa_fused_bf16_tc
// says which kernel serves a net.
#include <cstdint>
#include <cuda_bf16.h>
#include "bf16_mma.cuh"
#include "common.cuh"
#include "tf32_mma.cuh"

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

// -- B9 at bf16 on the bf16 tensor cores -------------------------------
// The bf16 sweeps (entry facl_sa_fused_bf16) run their products as
// mma.sync m16n8k16 bf16 with f32 accumulation; every operand of those
// products is bf16-exact where the JAX kernel casts it (x, h, W, bf16(dp)),
// so a product of two is exact and the tensor cores sum each k16 step into
// the f32 accumulators:
//   forward  p_l = bf16(h_{l-1} W_l) + b_l for l >= 1 (layer 0, C0 <= 8
//            terms, on CUDA cores in k order). The bf16 rounding decides
//            masks and the pool, so the few sums that lie near a bf16
//            rounding boundary are summed again in k order (fwd_mma): p is
//            the JAX chain's (and the twin's) on every sum measured;
//   da       da_{l-1} = bf16(dp_l) W_l^T for l >= 1, each k16 step summed
//            on its own and added in f32 (dx = dp_0 W0^T with the f32 W0^T
//            on CUDA cores);
//   dW       dW_l += h_{l-1}^T dp_l with the f32 dp split into three bf16
//            pieces (hi + mid + lo == dp exactly: each piece takes the
//            next 8 bits), three products a step, smallest first.
// What bounds it on the card: at the main path's widths the products are
// ~0.2 ms a launch at the bf16 rate; the kernel is held by its CUDA-core
// passes (routing, masks, column sums, the k-order sums) between block
// barriers, with one block an SM (PERF.md has the parts).
// The bf16 weights are staged into shared memory once per block, tiles
// padded to k16 steps with zero rows and columns (stride k16 + 8 values:
// ldmatrix reads them free of bank conflicts); so are the top layer's
// per-channel vectors. dW never touches device memory per tile: each warp
// owns DWJ units of 16 x 16 outputs of the net's dW for the block's life
// and keeps them in f32 registers, carried into the block's float64
// partial every DW_FLUSH tiles and at the end; a net with more units than
// the warps hold runs the final sweep in rounds, each over every tile for
// its share of the units. The pool and routing passes give each (group,
// column) eight threads that split its rows and combine max and tie count
// by shuffles (exact: a max and integer counts). The next tile's x is
// copied in (cp.async) while a tile is computed. One block of NTB threads
// an SM (shared memory): the activations stay in shared memory as bf16 (h,
// the products' A operand) and f32 (p), so a 128-row tile of the main
// path's net (4 -> 64 -> 64 -> 256) fits; a net whose tile does not fit
// 227 KB at 64 rows (or at 128, pool > 64) runs the CUDA-core kernel
// (tc_fits), as every bf16 net did before this kernel.

constexpr int NTB = 512;          // threads of a bf16 block
constexpr int NWB = NTB / 32;     // its warps
constexpr int DWJ = 6;            // dW units a warp holds (48 registers)
constexpr int DW_FLUSH = 32;      // tiles between carries of dW to float64
constexpr int SLICES = 8;         // threads per (group, column) in routing
constexpr int FIXW = 64;          // a warp's list of sums to redo (red)
static_assert(FIXW * NWB <= 2 * SLICES * CH, "the lists share red");

__host__ __device__ constexpr int k16(int c) { return (c + 15) & ~15; }
__host__ __device__ constexpr int ldh(int c) { return k16(c) + 8; }  // bf16
__host__ __device__ constexpr int ldf(int c) { return k16(c) + 4; }  // f32
__host__ __device__ constexpr size_t al16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

struct NetB {
  Net n;
  int wboff[LMAX];                  // W_l (l >= 1), bf16 values into Wb
  int poff[LMAX];                   // P_l (l < L - 1): TR * poff floats in
  int wa, wz;                       // AS width; ZC / DA width
  int ub[LMAX][WMAX / CH + 1];      // first dW unit of layer l, chunk c
  int rounds;                       // final-sweep rounds over the tiles
};

__host__ __device__ constexpr int nchunks(int w) { return (w + CH - 1) / CH; }

void make_netb(const Net& n, NetB* b) {
  b->n = n;
  int wo = 0, po = 0, wa = 16, wz = CH, u = 0;
  for (int l = 0; l < n.L; ++l) {
    b->wboff[l] = wo;
    if (l) wo += k16(n.cin[l]) * ldh(n.w[l]);
    b->poff[l] = po;
    if (l < n.L - 1) {
      po += ldf(n.w[l]);
      wa = n.w[l] > wa ? n.w[l] : wa;
      wz = n.w[l] > wz ? n.w[l] : wz;
    }
    const int mu = k16(n.cin[l]) / 16;
    for (int c = 0; c < nchunks(n.w[l]); ++c) {
      b->ub[l][c] = u;
      const int nc = n.w[l] - c * CH < CH ? n.w[l] - c * CH : CH;
      u += mu * (k16(nc) / 16);
    }
    b->ub[l][nchunks(n.w[l])] = u;
  }
  b->wa = wa;
  b->wz = wz;
  b->rounds = (u + NWB * DWJ - 1) / (NWB * DWJ);
}

// Shared memory of the bf16 kernel: vacc | red | vt (the top layer's
// vectors) | xst (two tiles' x as loaded) | xs | W0 | W0T | Wb | P | AS |
// ZC | DA (the backward's; D2 of the top's BN sums, then the da ping-pong
// with ZC). Returns the bytes.
__host__ __device__ inline size_t layout_bf(const NetB& b, int TR, bool bwd,
                                            size_t off[11]) {
  const Net& n = b.n;
  const int nv = n.nb > 2 * WMAX ? n.nb : 2 * WMAX;
  int wo = 0, po = 0;
  for (int l = 0; l < n.L; ++l) {
    if (l) wo += k16(n.cin[l]) * ldh(n.w[l]);
    if (l < n.L - 1) po += ldf(n.w[l]);
  }
  const size_t bytes[11] = {
      sizeof(float) * 2 * SLICES * CH,                  // red
      sizeof(float) * NVEC * WMAX,                      // vt
      sizeof(float) * 2 * TR * C0MAX,                   // xst
      sizeof(float) * TR * C0MAX,                       // xs
      sizeof(float) * n.C0 * n.w[0],                    // W0
      sizeof(float) * n.C0 * n.w[0],                    // W0T
      sizeof(__nv_bfloat16) * wo,                       // Wb
      sizeof(float) * TR * po,                          // P
      sizeof(__nv_bfloat16) * TR * ldh(b.wa),           // AS
      sizeof(float) * TR * ldf(b.wz),                   // ZC
      bwd ? sizeof(float) * TR * ldf(b.wz) : 0};        // DA
  size_t o = sizeof(double) * nv;                      // vacc
  for (int i = 0; i < 11; ++i) {
    off[i] = o;
    o = al16(o + bytes[i]);
  }
  return o;
}

// Rows of a bf16 tile: 128 wherever the layout fits (half the tiles, so
// half the barriers and latencies a sweep waits on), else 64.
int tile_rows_bf(const NetB& b) {
  size_t off[11];
  return b.n.pool > CH || layout_bf(b, 2 * CH, true, off) <= kSmemMax
             ? 2 * CH
             : CH;
}

// 4-byte asynchronous copies global -> shared (cp.async), waited for as
// one group.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The three bf16 pieces of two f32 values (v0 the low half): hi + mid +
// lo == v exactly (each difference is exact in f32, and the last holds at
// most 8 significant bits).
__device__ __forceinline__ void split3(float v0, float v1, uint32_t p[3]) {
  p[0] = pack_bf16(v0, v1);
  const float2 a = unpack_bf16(p[0]);
  const float r0 = __fsub_rn(v0, a.x), r1 = __fsub_rn(v1, a.y);
  p[1] = pack_bf16(r0, r1);
  const float2 b = unpack_bf16(p[1]);
  p[2] = pack_bf16(__fsub_rn(r0, b.x), __fsub_rn(r1, b.y));
}

// sum_k a[k] w[k ldw] for k < kdim (a multiple of 8) as the k-order chain
// sums it (fmaf from 0, k ascending), eight steps' operands loaded at once
// (a 16-byte aligned).
__device__ __forceinline__ float kdot(const __nv_bfloat16* a,
                                      const __nv_bfloat16* w, int ldw,
                                      int kdim) {
  float s = 0.f;
  for (int k0 = 0; k0 < kdim; k0 += 8) {
    const uint4 av = *reinterpret_cast<const uint4*>(a + k0);
    const uint32_t ap[4] = {av.x, av.y, av.z, av.w};
    float wv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wv[j] = __bfloat162float(w[(k0 + j) * ldw]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack_bf16(ap[j]);
      s = fmaf(f.x, wv[2 * j], s);
      s = fmaf(f.y, wv[2 * j + 1], s);
    }
  }
  return s;
}

// Whether the f32 sum v lies within `win` of a bf16 rounding boundary
// (the midpoint of two bf16 neighbours, low 16 bits 0x8000): there a sum
// in another order may round to the other neighbour. win 0: never (every
// product zero, or no redo asked).
__device__ __forceinline__ bool near_mid(float v, float win) {
  const uint32_t u = __float_as_uint(v);
  const float ulp = __uint_as_float(u & 0x7f800000u) * 0x1p-23f;
  const int d = static_cast<int>(u & 0xffffu) - 0x8000;
  return win > 0.f && fabsf(static_cast<float>(d)) * ulp <= win;
}

// out[r][c] = bf16(sum_k A[r][k] W[k][c0 + c]) + bias[c] for c < nc: A a
// bf16 tile (stride lda), W a staged bf16 W_l (stride ldw), k < kdim
// (k16-padded with zeros in both), bias at the chunk's first column.
// Warps take 16 x 16 output blocks. The bf16 rounding decides masks and
// the pool, and the JAX chain (and the twin) sums the products in k
// order: beside each sum the tensor cores also form S = sum_k A |W| (A >=
// 0: an activation), and a sum within (16 + kdim / 2) 2^-24 S of a bf16
// rounding boundary is summed again in k order on CUDA cores (kdot): each
// warp lists its flagged sums (in wrk) and redoes them one a lane. The
// window is not a proven bound: the chain alone may be off the exact sum
// by up to (kdim - 1) 2^-24 S, and the tensor cores' order of adds is not
// documented. On an H100 the two sums stood at most 4.5-28.3 units of
// 2^-24 S apart at kdim 64-256, a fifth of the window or less, and no sum
// of 151 million rounded apart from the chain (chip_ablate.py tc_sums). A
// sum that did would move p by one bf16 ulp. Without `exact` (p only
// summed: a stats sweep's own layer) no sum is redone.
template <int TR>
__device__ void fwd_mma(const __nv_bfloat16* A, int lda, int kdim,
                        const __nv_bfloat16* W, int ldw, int c0, int nc,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int ldo, int* wrk,
                        bool exact) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int MT = TR / 16;
  const int units = MT * (k16(nc) / 16);
  const float wc = exact ? (16.f + 0.5f * kdim) * 0x1p-24f : 0.f;
  int* list = wrk + warp * FIXW;         // this warp's flagged sums
  int listed = 0;
  // The listed sums again in k order, one a lane.
  auto redo = [&]() {
    __syncwarp();
    for (int i = lane; i < listed; i += 32) {
      const int r = list[i] / CH, c = list[i] % CH;
      out[r * ldo + c] = __fadd_rn(
          rb(kdot(A + r * lda, W + c0 + c, ldw, kdim)), bias[c]);
    }
    __syncwarp();
    listed = 0;
  };
  for (int u = warp; u < units; u += NWB) {
    const int m0 = 16 * (u % MT), n0 = 16 * (u / MT);
    float acc[2][4] = {}, sab[2][4] = {};
    const __nv_bfloat16* pa = A + (m0 + (lane & 15)) * lda + ((lane >> 4) << 3);
    const __nv_bfloat16* pb = W + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldw +
                              c0 + n0 + ((lane >> 4) << 3);
    for (int k0 = 0; k0 < kdim; k0 += 16) {
      uint32_t a[4], b[4];
      ldsm4(a, pa + k0);
      ldsm4t(b, pb + k0 * ldw);
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] &= 0x7fff7fffu;     // |W|
      mma_bf16(sab[0], a, b[0], b[1]);
      mma_bf16(sab[1], a, b[2], b[3]);
    }
    uint32_t flag = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + g + 8 * (q >> 1), c = n0 + 8 * h + 2 * t + (q & 1);
        if (c >= nc) continue;
        out[r * ldo + c] = __fadd_rn(rb(acc[h][q]), bias[c]);
        if (near_mid(acc[h][q], wc * sab[h][q])) flag |= 1u << (4 * h + q);
      }
    // List this unit's flagged sums (about 2% of them) after the warp's
    // earlier ones; redo the list once it holds a lane's worth.
    const int mine = __popc(flag);
    int below = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, below, o);
      if (lane >= o) below += v;
    }
    const int total = __shfl_sync(0xffffffffu, below, 31);
    if (listed + total > FIXW) redo();
    int pos = listed + below - mine;
    while (flag != 0) {
      const int sl = __ffs(flag) - 1, h = sl >> 2, q = sl & 3;
      flag &= flag - 1;
      const int r = m0 + g + 8 * (q >> 1), c = n0 + 8 * h + 2 * t + (q & 1);
      if (pos < FIXW)
        list[pos] = r * CH + c;
      else                            // more than a list's worth: in place
        out[r * ldo + c] = __fadd_rn(
            rb(kdot(A + r * lda, W + c0 + c, ldw, kdim)), bias[c]);
      ++pos;
    }
    listed = min(listed + total, FIXW);
    if (listed >= 32) redo();
  }
  if (listed > 0) redo();
}

// out[r][n] (+)= sum_k bf16(D[r][k]) W[n][k] for n < ncols, k < kdim: D an
// f32 tile (stride ldd, zero over the k16 padding), W a staged bf16 W_l
// (stride ldw) whose rows n are the output columns (da = dp W^T). With
// `add` the sums start from out (the previous chunks' part). Each k16
// step is summed by the tensor cores on its own and added to the sum in
// f32 (round to nearest), as the k-order chain adds: bf16(dp) of the layer
// below rounds da's f32 value, and the tensor cores' own accumulation
// (truncating) over many steps moves it across rounding boundaries far
// more often.
template <int TR>
__device__ void da_mma(const float* D, int ldd, int kdim,
                       const __nv_bfloat16* W, int ldw, int ncols,
                       float* out, int ldo, bool add) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int MT = TR / 16;
  const int units = MT * (k16(ncols) / 16);
  for (int u = warp; u < units; u += NWB) {
    const int m0 = 16 * (u % MT), n0 = 16 * (u / MT);
    float acc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + g + 8 * (q >> 1), c = n0 + 8 * h + 2 * t + (q & 1);
        acc[h][q] = add && c < ncols ? out[r * ldo + c] : 0.f;
      }
    const float* pd = D + (m0 + g) * ldd + 2 * t;
    const __nv_bfloat16* pb = W + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ldw +
                              (((lane >> 3) & 1) << 3);
    for (int k0 = 0; k0 < kdim; k0 += 16) {
      const float2 v0 = *reinterpret_cast<const float2*>(pd + k0);
      const float2 v1 = *reinterpret_cast<const float2*>(pd + 8 * ldd + k0);
      const float2 v2 = *reinterpret_cast<const float2*>(pd + k0 + 8);
      const float2 v3 =
          *reinterpret_cast<const float2*>(pd + 8 * ldd + k0 + 8);
      const uint32_t a[4] = {pack_bf16(v0.x, v0.y), pack_bf16(v1.x, v1.y), pack_bf16(v2.x, v2.y),
                             pack_bf16(v3.x, v3.y)};
      uint32_t b[4];
      ldsm4(b, pb + k0);
      float st[2][4] = {};
      mma_bf16(st[0], a, b[0], b[1]);
      mma_bf16(st[1], a, b[2], b[3]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[h][q] = __fadd_rn(acc[h][q], st[h][q]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + g + 8 * (q >> 1), c = n0 + 8 * h + 2 * t + (q & 1);
        if (c < ncols) out[r * ldo + c] = acc[h][q];
      }
  }
}

// This warp's dW units in [lo, hi) (ids counted from the round's first):
// dw[j] += H^T D over the tile's TR rows for unit lo + (m-block) nb +
// (n-block) of one chunk — H the bf16 tile of the layer's input (stride
// lda; rows m of dW), D the f32 dp of the chunk (stride ldd; columns n),
// zero on the rows past the tile's groups. dp enters as its three bf16
// pieces, lo first (split3); the tile's part is summed on its own, then
// added to dw in f32.
template <int TR>
__device__ __forceinline__ void dw_mma(float (&dw)[DWJ][8], int lo, int hi,
                                       int nb, const __nv_bfloat16* H,
                                       int lda, const float* D, int ldd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < DWJ; ++j) {
    const int id = warp + NWB * j;
    if (id < lo || id >= hi) continue;
    const int m0 = 16 * ((id - lo) / nb), n0 = 16 * ((id - lo) % nb);
    const __nv_bfloat16* pa =
        H + ((lane & 7) + ((lane >> 4) << 3)) * lda + m0 +
        (((lane >> 3) & 1) << 3);
    const float* pd = D + 2 * t * ldd + n0 + g;
    float st[8] = {};
#pragma unroll 1
    for (int k0 = 0; k0 < TR; k0 += 16) {
      uint32_t a[4];
      ldsm4t(a, pa + k0 * lda);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* p = pd + k0 * ldd + 8 * h;
        uint32_t b0[3], b1[3];
        split3(p[0], p[ldd], b0);
        split3(p[8 * ldd], p[9 * ldd], b1);
#pragma unroll
        for (int s = 2; s >= 0; --s) mma_bf16(st + 4 * h, a, b0[s], b1[s]);
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) dw[j][q] = __fadd_rn(dw[j][q], st[q]);
  }
}

// Add this warp's dW units (the round's, from unit `base`) into the
// block's float64 partial `blk` (dW_l row-major at dwoff) and zero them.
__device__ void dw_flush(const NetB& b, float (&dw)[DWJ][8], int base,
                         double* __restrict__ blk) {
  const Net& n = b.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < DWJ; ++j) {
    const int id = base + warp + NWB * j;
    for (int l = 0; l < n.L; ++l)
      for (int c = 0; c < nchunks(n.w[l]); ++c) {
        const int lo = b.ub[l][c], hi = b.ub[l][c + 1];
        if (id < lo || id >= hi) continue;
        const int nc = n.w[l] - c * CH < CH ? n.w[l] - c * CH : CH;
        const int nb = k16(nc) / 16;
        const int m0 = 16 * ((id - lo) / nb);
        const int n0 = c * CH + 16 * ((id - lo) % nb);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int m = m0 + g + 8 * (q >> 1);
            const int col = n0 + 8 * h + 2 * t + (q & 1);
            if (m < n.cin[l] && col < n.w[l])
              blk[n.dwoff[l] + static_cast<int64_t>(m) * n.w[l] + col] +=
                  static_cast<double>(dw[j][4 * h + q]);
          }
      }
#pragma unroll
    for (int q = 0; q < 8; ++q) dw[j][q] = 0.f;
  }
}

// The dW units of layer l's chunks cbeg .. cend - 1 in this round (ids
// from `base`): D holds chunk cbeg's columns first.
template <int TR>
__device__ __forceinline__ void dw_layer(const NetB& b, float (&dw)[DWJ][8],
                                         int base, int l, int cbeg, int cend,
                                         const __nv_bfloat16* H, int lda,
                                         const float* D, int ldd) {
  for (int c = cbeg; c < cend; ++c) {
    const int nc = b.n.w[l] - c * CH < CH ? b.n.w[l] - c * CH : CH;
    dw_mma<TR>(dw, b.ub[l][c] - base, b.ub[l][c + 1] - base, k16(nc) / 16,
               H, lda, D + (c - cbeg) * CH, ldd);
  }
}

// Layer 0's p = x W0 + b0 for columns c0 .. c0 + nc on CUDA cores (C0 <=
// 8 products summed in k order; under BF xs holds the rounded x, the
// products are exact and their sum is rounded to bf16 before the bias).
// Thread t takes column t % CH (its W0 column and bias in registers) and
// rows t / CH, + RS, ...
constexpr int RS = NTB / CH;      // row slices of a CUDA-core pass

template <int TR, bool BF>
__device__ void p0_chunk(const Net& n, const float* xs, const float* W0,
                         const float* __restrict__ bias, int c0, int nc,
                         float* __restrict__ out, int ldo) {
  const int c = threadIdx.x % CH, q = threadIdx.x / CH, C0 = n.C0;
  if (c >= nc) return;
  float w[C0MAX];
#pragma unroll
  for (int k = 0; k < C0MAX; ++k)
    w[k] = k < C0 ? W0[k * n.w[0] + c0 + c] : 0.f;
  const float bc = bias[c];
#pragma unroll 2
  for (int r = q; r < TR; r += RS) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < C0MAX; ++k)
      if (k < C0) acc = fmaf(xs[r * C0MAX + k], w[k], acc);
    out[r * ldo + c] = __fadd_rn(cast<BF>(acc), bc);
  }
}

// p of layer l, columns c0 .. c0 + nc, from the tile's input (xs for
// layer 0, else AS), bias at the chunk's first column: the one function
// every sweep computes p with.
template <int TR>
__device__ void layer_p(const NetB& b, const float* xs, const float* W0,
                        const __nv_bfloat16* Wb, const __nv_bfloat16* AS,
                        const float* bias, int l, int c0, int nc, float* out,
                        int ldo, int* wrk, bool exact = true) {
  const Net& n = b.n;
  if (l == 0)
    p0_chunk<TR, true>(n, xs, W0, bias, c0, nc, out, ldo);
  else
    fwd_mma<TR>(AS, ldh(b.wa), k16(n.cin[l]), Wb + b.wboff[l], ldh(n.w[l]),
                c0, nc, bias, out, ldo, wrk, exact);
}

// AS = relu(bf16(P_l * ay + by)) as bf16, zero over the k16 padding:
// layer l's activation, the next layer's input.
template <int TR>
__device__ void act_bf(const float* __restrict__ vec, int l, const float* Pl,
                       int w, __nv_bfloat16* AS, int lda) {
  const int ldp = ldf(w), q = threadIdx.x / CH;
  for (int c = threadIdx.x % CH; c < k16(w); c += CH) {
    const bool live = c < w;
    const float ay = live ? vget(vec, l, VAY, c) : 0.f;
    const float by = live ? vget(vec, l, VBY, c) : 0.f;
#pragma unroll 2
    for (int r = q; r < TR; r += RS)
      AS[r * lda + c] = __float2bfloat16_rn(
          live ? fmaxf(rb(affine(Pl[r * ldp + c], ay, by)), 0.f)
               : 0.f);
  }
}

// AS = x (rounded) as bf16, k16-padded: layer 0's input for its dW.
template <int TR>
__device__ void x_bf(const Net& n, const float* xs, __nv_bfloat16* AS,
                     int lda) {
  const int C0 = n.C0;
  for (int e = threadIdx.x; e < TR * 16; e += NTB) {
    const int r = e / 16, c = e % 16;
    AS[r * lda + c] = __float2bfloat16_rn(c < C0 ? xs[r * C0MAX + c] : 0.f);
  }
}

// Start copying tile t's input rows (nrows x C0 as they lie) into xst:
// the next tile's, while this one is computed.
template <int TR>
__device__ void x_fetch(const Net& n, const float* __restrict__ x, int64_t t,
                        int64_t ntiles, float* xst) {
  if (t < ntiles) {
    const int pool = n.pool, C0 = n.C0, gpt = TR / pool;
    const int64_t G = n.R / pool, g0 = t * gpt;
    const int nrows = static_cast<int>(G - g0 < gpt ? G - g0 : gpt) * pool;
    const float* src = x + g0 * pool * C0;
    for (int e = threadIdx.x; e < nrows * C0; e += NTB)
      cp_async4(xst + e, src + e);
  }
  cp_commit();
}

// The tile's input rows from xst (rounded; zeros past nrows), then layers
// < upto: P_l = pre-activations, AS = the activation of layer upto - 1.
template <int TR>
__device__ void prefix_bf(const NetB& b, const float* xst,
                          const float* __restrict__ vec, int nrows, int upto,
                          float* xs, const float* W0,
                          const __nv_bfloat16* Wb, float* P,
                          __nv_bfloat16* AS, int* wrk) {
  const Net& n = b.n;
  const int C0 = n.C0;
  for (int e = threadIdx.x; e < TR * C0MAX; e += NTB) {
    const int r = e / C0MAX, c = e % C0MAX;
    xs[e] = (r < nrows && c < C0) ? rb(xst[r * C0 + c]) : 0.f;
  }
  __syncthreads();
  for (int l = 0; l < upto; ++l) {
    const int w = n.w[l];
    float* Pl = P + TR * b.poff[l];
    for (int c0 = 0; c0 < w; c0 += CH)
      layer_p<TR>(b, xs, W0, Wb, AS, vec + (l * NVEC + VB) * WMAX + c0, l,
                  c0, w - c0 < CH ? w - c0 : CH, Pl + c0, ldf(w), wrk);
    __syncthreads();
    act_bf<TR>(vec, l, Pl, w, AS, ldh(b.wa));
    __syncthreads();
  }
}

// s1[c] += sum_{r < nrows} A[r][c]; s2[c] += sum of A[r][c]^2 (square) or
// of B[r][c]. Eight row slices per column in float32, then float64.
template <int TR>
__device__ void colsums_bf(const float* A, int lda, const float* B, int ldb,
                           bool square, int ncols, int nrows, double* s1,
                           double* s2, float* red) {
  const int t = threadIdx.x, c = t % CH, q = t / CH;
  for (int c0 = 0; c0 < ncols; c0 += CH) {
    float a1 = 0.f, a2 = 0.f;
    if (c0 + c < ncols)
      for (int r = q; r < nrows; r += SLICES) {
        const float v = A[r * lda + c0 + c];
        a1 = __fadd_rn(a1, v);
        if (s2)
          a2 = __fadd_rn(a2, square ? __fmul_rn(v, v) : B[r * ldb + c0 + c]);
      }
    red[q * CH + c] = a1;
    red[(SLICES + q) * CH + c] = a2;
    __syncthreads();
    if (t < 2 * CH) {
      const int which = t / CH, cc = t % CH;
      double* s = which ? s2 : s1;
      if (s != nullptr && c0 + cc < ncols) {
        double d = 0.0;
        for (int k = 0; k < SLICES; ++k)
          d += red[(SLICES * which + k) * CH + cc];
        s[c0 + cc] += d;
      }
    }
    __syncthreads();
  }
}

// Max and exact-tie count of relu(y), y = p ay + by (rounded to bf16
// under BF), over the rows r = s, s + SLICES, .. < pool of one (group,
// column) (z at its first row, stride ld), combined over the SLICES lanes
// of the pair (lane bits 0-2): exact at either dtype (a max and integer
// counts).
template <bool BF>
__device__ __forceinline__ void group_max(const float* z, int ld, int pool,
                                          int s, bool ok, float ay, float by,
                                          float& m, int& cnt) {
  m = 0.f;
  cnt = 0;
  if (ok)
    for (int r = s; r < pool; r += SLICES) {
      const float h = fmaxf(cast<BF>(affine(z[r * ld], ay, by)), 0.f);
      if (h > m) {
        m = h;
        cnt = 1;
      } else if (h == m) {
        ++cnt;
      }
    }
#pragma unroll
  for (int o = 1; o < SLICES; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const int co = __shfl_xor_sync(0xffffffffu, cnt, o);
    if (mo > m) {
      m = mo;
      cnt = co;
    } else if (mo == m) {
      cnt += co;
    }
  }
}

// Pool sweep, one chunk: pooled[g0 + g][c0 + c] = max over the group of
// relu(y) (y rounded to bf16 under BF; ZC holds p).
template <int TR, bool BF>
__device__ void pool_bf(const Net& n, const float* vt, int64_t g0, int ng,
                        int c0, int nc, const float* Z, int ldz,
                        float* __restrict__ out) {
  const int pool = n.pool, wl = n.w[n.L - 1], items = ng * nc * SLICES;
  for (int e = threadIdx.x; e < ((items + 31) & ~31); e += NTB) {
    const bool ok = e < items;
    const int s = e % SLICES, gc = ok ? e / SLICES : 0;
    const int g = gc / nc, c = gc % nc;
    float m;
    int cnt;
    group_max<BF>(Z + g * pool * ldz + c, ldz, pool, s, ok,
              vt[VAY * WMAX + c0 + c], vt[VBY * WMAX + c0 + c], m, cnt);
    if (ok && s == 0) out[(g0 + g) * wl + c0 + c] = m;
  }
}

// Top layer, one chunk (as route_top): Z holds p (TR x nc). dy = dout /
// ties on the tied rows with y > 0, else 0. With D2: Z = dy, D2 = dy *
// xhat (the top's BN sums); without: Z = dp, zero past nrows and over the
// k16 padding of the chunk (da's and dW's operand). y rounded to bf16
// under BF.
template <int TR, bool BF>
__device__ void route_bf(const Net& n, const float* vt,
                         const float* __restrict__ dout, int64_t g0, int ng,
                         int nrows, int c0, int nc, float* Z, int ldz,
                         float* D2) {
  const int pool = n.pool, wl = n.w[n.L - 1], items = ng * nc * SLICES;
  for (int e = threadIdx.x; e < ((items + 31) & ~31); e += NTB) {
    const bool ok = e < items;
    const int s = e % SLICES, gc = ok ? e / SLICES : 0;
    const int g = gc / nc, c = gc % nc, cc = c0 + c;
    const float ay = vt[VAY * WMAX + cc], by = vt[VBY * WMAX + cc];
    const float inv = vt[VINV * WMAX + cc], bx = vt[VBX * WMAX + cc];
    const float gi = vt[VGI * WMAX + cc], sdy = vt[VSDY * WMAX + cc];
    const float sdyx = vt[VSDYX * WMAX + cc];
    float* z = Z + g * pool * ldz + c;
    const float d = ok ? __ldg(dout + (g0 + g) * wl + cc) : 0.f;
    float m;
    int cnt;
    group_max<BF>(z, ldz, pool, s, ok, ay, by, m, cnt);
    if (!ok) continue;
    const float share = __fdiv_rn(d, (float)cnt);
    for (int r = s; r < pool; r += SLICES) {
      const float p = z[r * ldz];
      const float y = cast<BF>(affine(p, ay, by));
      const float dy = (y > 0.f && fmaxf(y, 0.f) == m) ? share : 0.f;
      const float xh = affine(p, inv, bx);
      if (D2 != nullptr) {
        z[r * ldz] = dy;
        D2[(g * pool + r) * ldz + c] = __fmul_rn(dy, xh);
      } else {
        z[r * ldz] = __fmul_rn(
            gi, __fsub_rn(__fsub_rn(dy, sdy), __fmul_rn(xh, sdyx)));
      }
    }
  }
  if (D2 == nullptr) {
    const int wp = k16(nc);
    for (int e = threadIdx.x; e < TR * wp; e += NTB) {
      const int r = e / wp, c = e % wp;
      if (r >= nrows || c >= nc) Z[r * ldz + c] = 0.f;
    }
  }
}

// Layer l < L - 1 (as mid_dy): cur holds da_l (TR x w; cur, oth and Pl
// at stride ld). dy = da where y > 0 (y rounded to bf16 under BF); with
// oth: cur = dy, oth = dy * xhat; without: cur = dp, zero past nrows and
// over the k16 padding.
template <int TR, bool BF>
__device__ void mid_bf(const float* __restrict__ vec, int l, const float* Pl,
                       int w, int ld, int nrows, float* cur, float* oth) {
  const int q = threadIdx.x / CH;
  for (int c = threadIdx.x % CH; c < k16(w); c += CH) {
    if (c >= w) {
      for (int r = q; r < TR; r += RS) cur[r * ld + c] = 0.f;
      continue;
    }
    const float ay = vget(vec, l, VAY, c), by = vget(vec, l, VBY, c);
    const float inv = vget(vec, l, VINV, c), bx = vget(vec, l, VBX, c);
    const float gi = vget(vec, l, VGI, c), sdy = vget(vec, l, VSDY, c);
    const float sdyx = vget(vec, l, VSDYX, c);
#pragma unroll 2
    for (int r = q; r < TR; r += RS) {
      const int i = r * ld + c;
      const float p = Pl[i];
      const float y = cast<BF>(affine(p, ay, by));
      const float dy = y > 0.f ? cur[i] : 0.f;
      const float xh = affine(p, inv, bx);
      if (oth != nullptr) {
        cur[i] = dy;
        oth[i] = __fmul_rn(dy, xh);
      } else {
        cur[i] = r < nrows
                     ? __fmul_rn(gi, __fsub_rn(__fsub_rn(dy, sdy),
                                               __fmul_rn(xh, sdyx)))
                     : 0.f;
      }
    }
  }
}

// out[r][k] (+)= sum_{c < nc} D[r][c] W0T[c0 + c][k], k < C0: dx = dp0
// W0^T with the f32 W0^T on CUDA cores, in c order (out stride C0).
template <int TR>
__device__ void dx_part(const Net& n, const float* D, int ldd, int nc,
                        const float* W0T, int c0, float* out, bool add) {
  const int C0 = n.C0;
  for (int e = threadIdx.x; e < TR * C0; e += NTB) {
    const int r = e / C0, k = e % C0;
    const float* d = D + r * ldd;
    const float* w = W0T + c0 * C0 + k;
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < nc; ++c) acc = fmaf(d[c], w[c * C0], acc);
    out[e] = add ? __fadd_rn(out[e], acc) : acc;
  }
}

template <int TR, bool FINAL>
__global__ void __launch_bounds__(NTB, 1)
sa_fused_bf16_kernel(const __grid_constant__ NetB b, int mode, int target,
                     const float* __restrict__ x,
                     const float* __restrict__ prm,
                     const float* __restrict__ vec,
                     const float* __restrict__ dout, float* __restrict__ out,
                     double* __restrict__ part) {
  const Net& n = b.n;
  extern __shared__ __align__(16) unsigned char smraw[];
  size_t off[11];
  layout_bf(b, TR, mode >= 2, off);
  double* vacc = reinterpret_cast<double*>(smraw);
  float* red = reinterpret_cast<float*>(smraw + off[0]);
  float* vt = reinterpret_cast<float*>(smraw + off[1]);
  float* xst = reinterpret_cast<float*>(smraw + off[2]);
  float* xs = reinterpret_cast<float*>(smraw + off[3]);
  float* W0 = reinterpret_cast<float*>(smraw + off[4]);
  float* W0T = reinterpret_cast<float*>(smraw + off[5]);
  __nv_bfloat16* Wb = reinterpret_cast<__nv_bfloat16*>(smraw + off[6]);
  float* P = reinterpret_cast<float*>(smraw + off[7]);
  __nv_bfloat16* AS = reinterpret_cast<__nv_bfloat16*>(smraw + off[8]);
  float* ZC = reinterpret_cast<float*>(smraw + off[9]);
  float* DA = reinterpret_cast<float*>(smraw + off[10]);

  // The weights, once per block: W0 (rounded) and the f32 W0^T as given,
  // W_l (l >= 1) as bf16 in k16-padded tiles.
  for (int e = threadIdx.x; e < n.C0 * n.w[0]; e += NTB) {
    W0[e] = prm[n.woff[0] + e];
    W0T[e] = prm[n.wtoff[0] + e];
  }
  for (int l = 1; l < n.L; ++l) {
    const int w = n.w[l], ld = ldh(w), cin = n.cin[l];
    for (int e = threadIdx.x; e < k16(cin) * ld; e += NTB) {
      const int k = e / ld, c = e % ld;
      Wb[b.wboff[l] + e] = __float2bfloat16_rn(
          k < cin && c < w ? prm[n.woff[l] + k * w + c] : 0.f);
    }
  }
  const int nv = n.nb > 2 * WMAX ? n.nb : 2 * WMAX;
  for (int e = threadIdx.x; e < nv; e += NTB) vacc[e] = 0.0;
  for (int e = threadIdx.x; e < NVEC * WMAX; e += NTB)
    vt[e] = vec[(n.L - 1) * NVEC * WMAX + e];
  double* blk = part + static_cast<int64_t>(blockIdx.x) * (n.ndw + n.nb);
  __syncthreads();

  const int top = n.L - 1, lda = ldh(b.wa), ldz = ldf(b.wz);
  const int gpt = TR / n.pool;
  const int64_t G = n.R / n.pool;
  const int64_t ntiles = (G + gpt - 1) / gpt;
  const int lt = mode == 0 ? target : top;          // the chunked layer
  const bool sums_top = mode == 2 && target == top;
  float dw[FINAL ? DWJ : 1][8] = {};
  for (int rd = 0; rd < (FINAL ? b.rounds : 1); ++rd) {
    const int base = rd * NWB * DWJ;
    int done = 0;
    x_fetch<TR>(n, x, blockIdx.x, ntiles, xst);
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++done) {
      const int64_t g0 = t * gpt;
      const int ng = static_cast<int>(G - g0 < gpt ? G - g0 : gpt);
      const int nrows = ng * n.pool;
      const int64_t r0 = g0 * n.pool;
      float* xcur = xst + (done & 1) * TR * C0MAX;
      cp_wait_all();
      __syncthreads();
      x_fetch<TR>(n, x, t + gridDim.x, ntiles,
                  xst + ((done + 1) & 1) * TR * C0MAX);
      prefix_bf<TR>(b, xcur, vec, nrows, lt, xs, W0, Wb, P, AS,
                    reinterpret_cast<int*>(red));
      if (mode == 3 && lt == 0) {
        x_bf<TR>(n, xs, AS, lda);
        __syncthreads();
      }
      const int wl = n.w[lt], cin = n.cin[lt];
      for (int c0 = 0; c0 < wl; c0 += CH) {
        const int nc = wl - c0 < CH ? wl - c0 : CH;
        layer_p<TR>(b, xs, W0, Wb, AS,
                    (lt == top ? vt : vec + lt * NVEC * WMAX) + VB * WMAX + c0,
                    lt, c0, nc, ZC, ldz, reinterpret_cast<int*>(red),
                    mode != 0);
        __syncthreads();
        if (mode == 0) {
          colsums_bf<TR>(ZC, ldz, nullptr, 0, true, nc, nrows, vacc + c0,
                         vacc + WMAX + c0, red);
          continue;
        }
        if (mode == 1) {
          pool_bf<TR, true>(n, vt, g0, ng, c0, nc, ZC, ldz, out);
          __syncthreads();
          continue;
        }
        route_bf<TR, true>(n, vt, dout, g0, ng, nrows, c0, nc, ZC, ldz,
                           sums_top ? DA : nullptr);
        __syncthreads();
        if (sums_top) {
          colsums_bf<TR>(ZC, ldz, DA, ldz, false, nc, nrows, vacc + c0,
                         vacc + WMAX + c0, red);
          continue;
        }
        if constexpr (FINAL) {
          dw_layer<TR>(b, dw, base, top, c0 / CH, c0 / CH + 1, AS, lda, ZC,
                       ldz);
          if (rd == 0)
            colsums_bf<TR>(ZC, ldz, nullptr, 0, false, nc, nrows,
                           vacc + n.dboff[top] + c0, nullptr, red);
        }
        if (top >= 1)                               // da of the layer below
          da_mma<TR>(ZC, ldz, k16(nc), Wb + b.wboff[top] + c0, ldh(wl), cin,
                     DA, ldf(cin), c0 > 0);
        else if (out != nullptr && mode == 3 && rd == 0)
          dx_part<TR>(n, ZC, ldz, nc, W0T, c0, DA, c0 > 0);
        __syncthreads();
      }
      if (mode >= 2 && !sums_top) {
        float* cur = DA;
        float* oth = ZC;
        for (int l = top - 1; l >= 0; --l) {
          const int w = n.w[l], ldc = ldf(w);
          const float* Pl = P + TR * b.poff[l];
          if (mode == 2 && l == target) {
            mid_bf<TR, true>(vec, l, Pl, w, ldc, nrows, cur, oth);
            __syncthreads();
            colsums_bf<TR>(cur, ldc, oth, ldc, false, w, nrows, vacc,
                           vacc + WMAX, red);
            break;
          }
          mid_bf<TR, true>(vec, l, Pl, w, ldc, nrows, cur, nullptr);
          __syncthreads();
          if constexpr (FINAL) {
            if (l >= 1)
              act_bf<TR>(vec, l - 1, P + TR * b.poff[l - 1], n.w[l - 1], AS,
                         lda);
            else
              x_bf<TR>(n, xs, AS, lda);
            __syncthreads();
            dw_layer<TR>(b, dw, base, l, 0, nchunks(w), AS, lda, cur, ldc);
            if (rd == 0)
              colsums_bf<TR>(cur, ldc, nullptr, 0, false, w, nrows,
                             vacc + n.dboff[l], nullptr, red);
          }
          if (l >= 1) {
            da_mma<TR>(cur, ldc, k16(w), Wb + b.wboff[l], ldh(w), n.cin[l],
                       oth, ldf(n.cin[l]), false);
          } else if (out != nullptr && mode == 3 && rd == 0) {
            dx_part<TR>(n, cur, ldc, w, W0T, 0, oth, false);
          } else {
            break;
          }
          __syncthreads();
          float* s = cur;
          cur = oth;
          oth = s;
        }
        if (mode == 3 && out != nullptr && rd == 0)   // cur = dx (TR x C0)
          for (int e = threadIdx.x; e < nrows * n.C0; e += NTB)
            out[r0 * n.C0 + e] = cur[e];
      }
      if constexpr (FINAL)
        if ((done + 1) % DW_FLUSH == 0) dw_flush(b, dw, base, blk);
      __syncthreads();
    }
    if constexpr (FINAL) dw_flush(b, dw, base, blk);
  }

  if (mode == 3) {
    __syncthreads();
    for (int e = threadIdx.x; e < n.nb; e += NTB) blk[n.ndw + e] = vacc[e];
  } else if (mode != 1) {
    __syncthreads();
    const int w = n.w[target];
    for (int e = threadIdx.x; e < 2 * w; e += NTB)
      part[static_cast<int64_t>(blockIdx.x) * 2 * w + e] =
          vacc[(e / w) * WMAX + e % w];
  }
}

template <int TR>
int launch_bf(const NetB& b, int mode, int target, const float* x,
              const float* prm, const float* vec, const float* dout,
              float* out, double* part, int nblk, cudaStream_t st) {
  size_t off[11];
  const size_t smem = layout_bf(b, TR, mode >= 2, off);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = mode == 3 ? sa_fused_bf16_kernel<TR, true>
                              : sa_fused_bf16_kernel<TR, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<nblk, NTB, smem, st>>>(b, mode, target, x, prm, vec, dout, out,
                                part);
  return static_cast<int>(cudaGetLastError());
}

// Whether the bf16 tensor-core kernel serves the net: its layout fits
// 227 KB at tile_rows_bf. A net in the range that it does not fit runs the
// CUDA-core kernel's bf16 instantiation (sa_fused_kernel<TR, true>).
bool tc_fits(const NetB& b) {
  size_t off[11];
  return layout_bf(b, tile_rows_bf(b), true, off) <= kSmemMax;
}

// -- B9 at f32 on the TF32 tensor cores ---------------------------------
// The f32 sweeps (entry facl_sa_fused) of every net whose layout fits
// 227 KB at 64-row tiles (pool <= 64; the main path's net among them) run
// sa_fused_tf32_kernel: the bf16 kernel's frame (one block of NTB threads
// an SM; the weights and the top layer's vectors staged once a block; the
// next tile's x copied in while a tile is computed; pool and routing by
// SLICES threads a (group, column); dW in per-warp f32 registers, carried
// into the block's float64 partial every DW_FLUSH tiles) with f32
// activations, and its products on the tensor cores as mma.sync m16n8k8
// TF32 in the 3xTF32 split (tf32_mma.cuh; each f32 operand split into its
// two TF32 pieces as its fragment is loaded, by integer operations
// (split: cvt.rna's rounding, at the integer pipe's rate); pre-split
// copies of the f32 weights would not fit beside a tile; each k8 step
// summed on its own and added round-to-nearest, step3):
//   forward  p_l = h_{l-1} W_l + b_l for l >= 1 (layer 0, C0 <= 8 terms,
//            on CUDA cores in k order, as the CUDA-core kernel);
//   da       da_{l-1} = dp_l W_l^T for l >= 1 (dx = dp_0 W0^T on CUDA
//            cores, dx_part);
//   dW       dW_l += h_{l-1}^T dp_l, each tile's part summed on its own.
// A split product is within ~2^-21 of sum |a b| of the exact one, as an f32
// product is, so every output meets the f32 bars that the CUDA-core kernel
// (k-order sums, as the twin's products) meets. A ReLU mask below the top
// is a decision, though: where y = p ay + by lies within the two sums'
// distance of 0 the mask may differ from the twin's and move a whole row
// of dx. So beside each p of a layer below the top the tensor cores also
// form S = sum_k h |W| (one TF32 pass; h >= 0), and a p whose y lies
// within (4 K + 64) 2^-24 S |ay| (and the affine's roundings) of 0 is
// summed again on CUDA cores as the k-order chain sums it (fmaf from 0):
// its mask is the chain's wherever the tensor cores' sum lies within the
// window of the chain's, a margin measured on the card, not proven
// (near_zero; on the main path's magnitudes 7 sums in 10^5 are redone,
// tests/test_torch_b9_tf32.py). The top layer's p is not
// redone: its routing differs from the chain's only at near-ties, which
// the bars leave out. Every sweep runs the same tile code (prefix_tf,
// layer_tf, route_bf), so p, masks and routing agree bit for bit across
// the launches. Shared memory strides: activations h at ldf (4 mod 8
// floats: conflict-free A fragments), W_l, p and dp at ldt (8 mod 16:
// conflict-free B fragments, and the float2 pairs of da's operands, whose
// k8 slots t and t + 4 take columns 2t and 2t + 1); dW reads dp's rows in
// pairs too, with two-way conflicts. What bounds it on the card: at the
// main path's widths the products are ~7.6 ms a step at the 3xTF32 rate;
// the kernel is held by instruction issue at one block an SM, in the
// CUDA-core passes between block barriers (routing most) and in the
// products' splits and loads (PERF.md has the parts).

__host__ __device__ constexpr int ldt(int c) { return k16(c) + 8; }

struct NetT {
  NetB b;
  int wfo[LMAX];                    // W_l (l >= 1), f32 values into Wt
  int pfo[LMAX];                    // P_l (l < L - 1): TR * pfo floats in
  int wtot, ptot;                   // floats of Wt; P's floats a row
};

void make_nett(const Net& n, NetT* t) {
  make_netb(n, &t->b);
  int wo = 0, po = 0;
  for (int l = 0; l < n.L; ++l) {
    t->wfo[l] = wo;
    if (l) wo += k16(n.cin[l]) * ldt(n.w[l]);
    t->pfo[l] = po;
    if (l < n.L - 1) po += ldt(n.w[l]);
  }
  t->wtot = wo;
  t->ptot = po;
}

// Shared memory of the f32 tensor-core kernel, as layout_bf: vacc | red |
// vt | xst | xs | W0 | W0T | Wt | P | AS | ZC | DA. Returns the bytes.
__host__ __device__ inline size_t layout_tf(const NetT& t, int TR, bool bwd,
                                            size_t off[11]) {
  const NetB& b = t.b;
  const Net& n = b.n;
  const int nv = n.nb > 2 * WMAX ? n.nb : 2 * WMAX;
  const size_t bytes[11] = {
      sizeof(float) * 2 * SLICES * CH,                  // red
      sizeof(float) * NVEC * WMAX,                      // vt
      sizeof(float) * 2 * TR * C0MAX,                   // xst
      sizeof(float) * TR * C0MAX,                       // xs
      sizeof(float) * n.C0 * n.w[0],                    // W0
      sizeof(float) * n.C0 * n.w[0],                    // W0T
      sizeof(float) * t.wtot,                           // Wt
      sizeof(float) * TR * t.ptot,                      // P
      sizeof(float) * TR * ldf(b.wa),                   // AS
      sizeof(float) * TR * ldt(b.wz),                   // ZC
      bwd ? sizeof(float) * TR * ldt(b.wz) : 0};        // DA
  size_t o = sizeof(double) * nv;                      // vacc
  for (int i = 0; i < 11; ++i) {
    off[i] = o;
    o = al16(o + bytes[i]);
  }
  return o;
}

// Whether the f32 tensor-core kernel serves the net: 64-row tiles (pool
// <= 64) whose layout fits 227 KB. The other nets of the range run the
// CUDA-core kernel (sa_fused_kernel<TR, false>).
bool tc_fits_tf(const NetT& t) {
  size_t off[11];
  return t.b.n.pool <= CH && layout_tf(t, CH, true, off) <= kSmemMax;
}

__device__ __forceinline__ float2 ld2f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// sum_k a[k] w[k ldw] for k < kdim, fmaf from 0 with k ascending: the
// k-order chain of the CUDA-core kernel (prod) and of the twin's product.
__device__ __forceinline__ float kdot_tf(const float* a, const float* w,
                                         int ldw, int kdim) {
  float s = 0.f;
#pragma unroll 4
  for (int k = 0; k < kdim; ++k) s = fmaf(a[k], w[k * ldw], s);
  return s;
}

// Whether y = fl(fl(p ay) + by) may lie on the other side of 0 for the
// k-order chain's p: S = sum_k |h W| (the TF32 pass; its pieces are within
// 2^-10 of it), K the terms. The window takes (4 K + 64) 2^-24 S, and the
// two roundings of the affine. It is a margin, not a proven bound: the
// chain is off the exact sum by at most K 2^-24 S and the split product
// by ~12 2^-24 S, but the tensor cores' accumulation error has no
// published bound; chip_ablate.py tc_sums_tf measures |tensor cores -
// chain| against the window on the card (PERF.md).
__device__ __forceinline__ bool near_zero(float p, float ay, float by,
                                          float S, int K) {
  const float pa = __fmul_rn(p, ay);
  const float y = __fadd_rn(pa, by);
  const float win = (4.f * K + 64.f) * 0x1p-24f * 1.01f * S * fabsf(ay) +
                    0x1p-22f * (fabsf(pa) + fabsf(by));
  return fabsf(y) <= win;
}

// out[r][c] = sum_k A[r][k] W[k][c0 + c] + bias[c] for c < nc: A the f32
// tile of the layer's input (stride lda), W the staged f32 W_l (stride
// ldw), k < kdim (k16-padded with zeros in both), kreal the layer's input
// width; bias, ay and by at the chunk's first column. Warps take 16 x 16
// output units, 3xTF32. With `exact` (a layer below the top) a p near its
// ReLU's switch (near_zero) is summed again in k order.
template <int TR>
__device__ void fwd_tf(const float* A, int lda, int kdim, int kreal,
                       const float* W, int ldw, int c0, int nc,
                       const float* bias, const float* __restrict__ ay,
                       const float* __restrict__ by, float* __restrict__ out,
                       int ldo, bool exact) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int MT = TR / 16;
  const int units = MT * (k16(nc) / 16);
  for (int u = warp; u < units; u += NWB) {
    const int m0 = 16 * (u % MT), n0 = 16 * (u / MT);
    float acc[2][4] = {}, sab[2][4] = {};
    const float* pa = A + (m0 + g) * lda + t;
    const float* pb = W + t * ldw + c0 + n0 + g;
#pragma unroll 2
    for (int k0 = 0; k0 < kdim; k0 += 8) {
      const float* qa = pa + k0;
      const FragA a{{split(qa[0]), split(qa[8 * lda]), split(qa[4]),
                     split(qa[8 * lda + 4])}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* qb = pb + k0 * ldw + 8 * h;
        const FragB bb{{split(qb[0]), split(qb[4 * ldw])}};
        step3(acc[h], a, bb);
        if (exact)                                  // S = sum h |W|
          mma_tf32(sab[h], a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi,
                   bb.v[0].hi & 0x7fffffffu, bb.v[1].hi & 0x7fffffffu);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + g + 8 * (q >> 1), c = n0 + 8 * h + 2 * t + (q & 1);
        if (c >= nc) continue;
        float p = __fadd_rn(acc[h][q], bias[c]);
        if (exact && near_zero(p, __ldg(ay + c), __ldg(by + c), sab[h][q],
                               kreal))
          p = __fadd_rn(kdot_tf(A + r * lda, W + c0 + c, ldw, kreal),
                        bias[c]);
        out[r * ldo + c] = p;
      }
  }
}

// out[r][j] (+)= sum_n D[r][n] W[j][n] for j < ncols, n < kdim: D an f32
// dp tile (stride ldd, zero over the k16 padding), W a staged f32 W_l at
// the chunk's first column (stride ldw), whose rows j are the output
// columns (da = dp W^T). The k8 slots t and t + 4 take the columns 2t and
// 2t + 1 (one float2 of each operand). With `add` the sums start from out
// (the previous chunks' part).
template <int TR>
__device__ void da_tf(const float* D, int ldd, int kdim, const float* W,
                      int ldw, int ncols, float* out, int ldo, bool add) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int MT = TR / 16;
  const int units = MT * (k16(ncols) / 16);
  for (int u = warp; u < units; u += NWB) {
    const int m0 = 16 * (u % MT), n0 = 16 * (u / MT);
    float acc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + g + 8 * (q >> 1), c = n0 + 8 * h + 2 * t + (q & 1);
        acc[h][q] = add && c < ncols ? out[r * ldo + c] : 0.f;
      }
    const float* pd = D + (m0 + g) * ldd + 2 * t;
    const float* pw = W + (n0 + g) * ldw + 2 * t;
#pragma unroll 2
    for (int k0 = 0; k0 < kdim; k0 += 8) {
      const float2 d0 = ld2f(pd + k0), d1 = ld2f(pd + 8 * ldd + k0);
      const FragA a{{split(d0.x), split(d1.x), split(d0.y),
                     split(d1.y)}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 w = ld2f(pw + 8 * h * ldw + k0);
        const FragB bb{{split(w.x), split(w.y)}};
        step3(acc[h], a, bb);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + g + 8 * (q >> 1), c = n0 + 8 * h + 2 * t + (q & 1);
        if (c < ncols) out[r * ldo + c] = acc[h][q];
      }
  }
}

// This warp's dW units in [lo, hi) (as dw_mma): dw[j] += H^T D over the
// tile's TR rows, H the f32 tile of the layer's input (stride lda; rows m
// of dW), D the f32 dp of the chunk (stride ldd; columns n), zero on the
// rows past the tile's groups. The k8 slots t and t + 4 take the rows 2t
// and 2t + 1; the tile's part is summed on its own, then added to dw.
template <int TR>
__device__ __forceinline__ void dw_tf(float (&dw)[DWJ][8], int lo, int hi,
                                      int nb, const float* H, int lda,
                                      const float* D, int ldd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < DWJ; ++j) {
    const int id = warp + NWB * j;
    if (id < lo || id >= hi) continue;
    const int m0 = 16 * ((id - lo) / nb), n0 = 16 * ((id - lo) % nb);
    const float* pa = H + 2 * t * lda + m0 + g;
    const float* pd = D + 2 * t * ldd + n0 + g;
    float st[8] = {};
#pragma unroll 1
    for (int k0 = 0; k0 < TR; k0 += 8) {
      const float* qa = pa + k0 * lda;
      const FragA a{{split(qa[0]), split(qa[8]), split(qa[lda]),
                     split(qa[lda + 8])}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* qd = pd + k0 * ldd + 8 * h;
        const FragB bb{{split(qd[0]), split(qd[ldd])}};
        step3(st + 4 * h, a, bb);
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) dw[j][q] = __fadd_rn(dw[j][q], st[q]);
  }
}

// The dW units of layer l's chunks cbeg .. cend - 1 in this round (as
// dw_layer).
template <int TR>
__device__ __forceinline__ void dw_layer_tf(const NetB& b,
                                            float (&dw)[DWJ][8], int base,
                                            int l, int cbeg, int cend,
                                            const float* H, int lda,
                                            const float* D, int ldd) {
  for (int c = cbeg; c < cend; ++c) {
    const int nc = b.n.w[l] - c * CH < CH ? b.n.w[l] - c * CH : CH;
    dw_tf<TR>(dw, b.ub[l][c] - base, b.ub[l][c + 1] - base, k16(nc) / 16, H,
              lda, D + (c - cbeg) * CH, ldd);
  }
}

// p of layer l, columns c0 .. c0 + nc, from the tile's input (xs for
// layer 0, else AS), bias at the chunk's first column: the one function
// every sweep computes p with; `exact` for the layers below the top.
template <int TR>
__device__ void layer_tf(const NetT& nt, const float* xs, const float* W0,
                         const float* Wt, const float* AS,
                         const float* __restrict__ vec, const float* bias,
                         int l, int c0, int nc, float* out, int ldo,
                         bool exact) {
  const Net& n = nt.b.n;
  if (l == 0) {
    p0_chunk<TR, false>(n, xs, W0, bias, c0, nc, out, ldo);
    return;
  }
  const float* v = vec + l * NVEC * WMAX + c0;
  fwd_tf<TR>(AS, ldf(nt.b.wa), k16(n.cin[l]), n.cin[l], Wt + nt.wfo[l],
             ldt(n.w[l]), c0, nc, bias, v + VAY * WMAX, v + VBY * WMAX, out,
             ldo, exact);
}

// AS = relu(P_l * ay + by), zero over the k16 padding: layer l's
// activation, the next layer's input (P_l at stride ldp).
template <int TR>
__device__ void act_tf(const float* __restrict__ vec, int l, const float* Pl,
                       int ldp, int w, float* AS, int lda) {
  const int q = threadIdx.x / CH;
  for (int c = threadIdx.x % CH; c < k16(w); c += CH) {
    const bool live = c < w;
    const float ay = live ? vget(vec, l, VAY, c) : 0.f;
    const float by = live ? vget(vec, l, VBY, c) : 0.f;
#pragma unroll 2
    for (int r = q; r < TR; r += RS)
      AS[r * lda + c] =
          live ? fmaxf(affine(Pl[r * ldp + c], ay, by), 0.f) : 0.f;
  }
}

// AS = x, k16-padded: layer 0's input for its dW.
template <int TR>
__device__ void x_tf(const Net& n, const float* xs, float* AS, int lda) {
  const int C0 = n.C0;
  for (int e = threadIdx.x; e < TR * 16; e += NTB) {
    const int r = e / 16, c = e % 16;
    AS[r * lda + c] = c < C0 ? xs[r * C0MAX + c] : 0.f;
  }
}

// The tile's input rows from xst (zeros past nrows), then layers < upto:
// P_l = pre-activations, AS = the activation of layer upto - 1.
template <int TR>
__device__ void prefix_tf(const NetT& nt, const float* xst,
                          const float* __restrict__ vec, int nrows, int upto,
                          float* xs, const float* W0, const float* Wt,
                          float* P, float* AS) {
  const Net& n = nt.b.n;
  const int C0 = n.C0;
  for (int e = threadIdx.x; e < TR * C0MAX; e += NTB) {
    const int r = e / C0MAX, c = e % C0MAX;
    xs[e] = (r < nrows && c < C0) ? xst[r * C0 + c] : 0.f;
  }
  __syncthreads();
  for (int l = 0; l < upto; ++l) {
    const int w = n.w[l];
    float* Pl = P + TR * nt.pfo[l];
    for (int c0 = 0; c0 < w; c0 += CH)
      layer_tf<TR>(nt, xs, W0, Wt, AS, vec, vec + (l * NVEC + VB) * WMAX + c0,
                   l, c0, w - c0 < CH ? w - c0 : CH, Pl + c0, ldt(w), true);
    __syncthreads();
    act_tf<TR>(vec, l, Pl, ldt(w), w, AS, ldf(nt.b.wa));
    __syncthreads();
  }
}

template <int TR, bool FINAL>
__global__ void __launch_bounds__(NTB, 1)
sa_fused_tf32_kernel(const __grid_constant__ NetT nt, int mode, int target,
                     const float* __restrict__ x,
                     const float* __restrict__ prm,
                     const float* __restrict__ vec,
                     const float* __restrict__ dout, float* __restrict__ out,
                     double* __restrict__ part) {
  const NetB& b = nt.b;
  const Net& n = b.n;
  extern __shared__ __align__(16) unsigned char smraw[];
  size_t off[11];
  layout_tf(nt, TR, mode >= 2, off);
  double* vacc = reinterpret_cast<double*>(smraw);
  float* red = reinterpret_cast<float*>(smraw + off[0]);
  float* vt = reinterpret_cast<float*>(smraw + off[1]);
  float* xst = reinterpret_cast<float*>(smraw + off[2]);
  float* xs = reinterpret_cast<float*>(smraw + off[3]);
  float* W0 = reinterpret_cast<float*>(smraw + off[4]);
  float* W0T = reinterpret_cast<float*>(smraw + off[5]);
  float* Wt = reinterpret_cast<float*>(smraw + off[6]);
  float* P = reinterpret_cast<float*>(smraw + off[7]);
  float* AS = reinterpret_cast<float*>(smraw + off[8]);
  float* ZC = reinterpret_cast<float*>(smraw + off[9]);
  float* DA = reinterpret_cast<float*>(smraw + off[10]);

  // The weights, once per block: W0 and W0^T as given, W_l (l >= 1) in
  // k16-padded tiles (zero rows and columns) at stride ldt(w).
  for (int e = threadIdx.x; e < n.C0 * n.w[0]; e += NTB) {
    W0[e] = prm[n.woff[0] + e];
    W0T[e] = prm[n.wtoff[0] + e];
  }
  for (int l = 1; l < n.L; ++l) {
    const int w = n.w[l], ld = ldt(w), cin = n.cin[l];
    for (int e = threadIdx.x; e < k16(cin) * ld; e += NTB) {
      const int k = e / ld, c = e % ld;
      Wt[nt.wfo[l] + e] = k < cin && c < w ? prm[n.woff[l] + k * w + c] : 0.f;
    }
  }
  const int nv = n.nb > 2 * WMAX ? n.nb : 2 * WMAX;
  for (int e = threadIdx.x; e < nv; e += NTB) vacc[e] = 0.0;
  for (int e = threadIdx.x; e < NVEC * WMAX; e += NTB)
    vt[e] = vec[(n.L - 1) * NVEC * WMAX + e];
  double* blk = part + static_cast<int64_t>(blockIdx.x) * (n.ndw + n.nb);
  __syncthreads();

  const int top = n.L - 1, lda = ldf(b.wa), ldz = ldt(b.wz);
  const int gpt = TR / n.pool;
  const int64_t G = n.R / n.pool;
  const int64_t ntiles = (G + gpt - 1) / gpt;
  const int lt = mode == 0 ? target : top;          // the chunked layer
  const bool sums_top = mode == 2 && target == top;
  float dw[FINAL ? DWJ : 1][8] = {};
  for (int rd = 0; rd < (FINAL ? b.rounds : 1); ++rd) {
    const int base = rd * NWB * DWJ;
    int done = 0;
    x_fetch<TR>(n, x, blockIdx.x, ntiles, xst);
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++done) {
      const int64_t g0 = t * gpt;
      const int ng = static_cast<int>(G - g0 < gpt ? G - g0 : gpt);
      const int nrows = ng * n.pool;
      const int64_t r0 = g0 * n.pool;
      float* xcur = xst + (done & 1) * TR * C0MAX;
      cp_wait_all();
      __syncthreads();
      x_fetch<TR>(n, x, t + gridDim.x, ntiles,
                  xst + ((done + 1) & 1) * TR * C0MAX);
      prefix_tf<TR>(nt, xcur, vec, nrows, lt, xs, W0, Wt, P, AS);
      if (mode == 3 && lt == 0) {
        x_tf<TR>(n, xs, AS, lda);
        __syncthreads();
      }
      const int wl = n.w[lt], cin = n.cin[lt];
      for (int c0 = 0; c0 < wl; c0 += CH) {
        const int nc = wl - c0 < CH ? wl - c0 : CH;
        layer_tf<TR>(nt, xs, W0, Wt, AS, vec,
                     (lt == top ? vt : vec + lt * NVEC * WMAX) + VB * WMAX +
                         c0,
                     lt, c0, nc, ZC, ldz, false);
        __syncthreads();
        if (mode == 0) {
          colsums_bf<TR>(ZC, ldz, nullptr, 0, true, nc, nrows, vacc + c0,
                         vacc + WMAX + c0, red);
          continue;
        }
        if (mode == 1) {
          pool_bf<TR, false>(n, vt, g0, ng, c0, nc, ZC, ldz, out);
          __syncthreads();
          continue;
        }
        route_bf<TR, false>(n, vt, dout, g0, ng, nrows, c0, nc, ZC, ldz,
                            sums_top ? DA : nullptr);
        __syncthreads();
        if (sums_top) {
          colsums_bf<TR>(ZC, ldz, DA, ldz, false, nc, nrows, vacc + c0,
                         vacc + WMAX + c0, red);
          continue;
        }
        if constexpr (FINAL) {
          dw_layer_tf<TR>(b, dw, base, top, c0 / CH, c0 / CH + 1, AS, lda,
                          ZC, ldz);
          if (rd == 0)
            colsums_bf<TR>(ZC, ldz, nullptr, 0, false, nc, nrows,
                           vacc + n.dboff[top] + c0, nullptr, red);
        }
        if (top >= 1)                               // da of the layer below
          da_tf<TR>(ZC, ldz, k16(nc), Wt + nt.wfo[top] + c0, ldt(wl), cin,
                    DA, ldt(cin), c0 > 0);
        else if (out != nullptr && mode == 3 && rd == 0)
          dx_part<TR>(n, ZC, ldz, nc, W0T, c0, DA, c0 > 0);
        __syncthreads();
      }
      if (mode >= 2 && !sums_top) {
        float* cur = DA;
        float* oth = ZC;
        for (int l = top - 1; l >= 0; --l) {
          const int w = n.w[l], ldc = ldt(w);
          const float* Pl = P + TR * nt.pfo[l];
          if (mode == 2 && l == target) {
            mid_bf<TR, false>(vec, l, Pl, w, ldc, nrows, cur, oth);
            __syncthreads();
            colsums_bf<TR>(cur, ldc, oth, ldc, false, w, nrows, vacc,
                           vacc + WMAX, red);
            break;
          }
          mid_bf<TR, false>(vec, l, Pl, w, ldc, nrows, cur, nullptr);
          __syncthreads();
          if constexpr (FINAL) {
            if (l >= 1)
              act_tf<TR>(vec, l - 1, P + TR * nt.pfo[l - 1],
                         ldt(n.w[l - 1]), n.w[l - 1], AS, lda);
            else
              x_tf<TR>(n, xs, AS, lda);
            __syncthreads();
            dw_layer_tf<TR>(b, dw, base, l, 0, nchunks(w), AS, lda, cur,
                            ldc);
            if (rd == 0)
              colsums_bf<TR>(cur, ldc, nullptr, 0, false, w, nrows,
                             vacc + n.dboff[l], nullptr, red);
          }
          if (l >= 1) {
            da_tf<TR>(cur, ldc, k16(w), Wt + nt.wfo[l], ldt(w), n.cin[l],
                      oth, ldt(n.cin[l]), false);
          } else if (out != nullptr && mode == 3 && rd == 0) {
            dx_part<TR>(n, cur, ldc, w, W0T, 0, oth, false);
          } else {
            break;
          }
          __syncthreads();
          float* s = cur;
          cur = oth;
          oth = s;
        }
        if (mode == 3 && out != nullptr && rd == 0)   // cur = dx (TR x C0)
          for (int e = threadIdx.x; e < nrows * n.C0; e += NTB)
            out[r0 * n.C0 + e] = cur[e];
      }
      if constexpr (FINAL)
        if ((done + 1) % DW_FLUSH == 0) dw_flush(b, dw, base, blk);
      __syncthreads();
    }
    if constexpr (FINAL) dw_flush(b, dw, base, blk);
  }

  if (mode == 3) {
    __syncthreads();
    for (int e = threadIdx.x; e < n.nb; e += NTB) blk[n.ndw + e] = vacc[e];
  } else if (mode != 1) {
    __syncthreads();
    const int w = n.w[target];
    for (int e = threadIdx.x; e < 2 * w; e += NTB)
      part[static_cast<int64_t>(blockIdx.x) * 2 * w + e] =
          vacc[(e / w) * WMAX + e % w];
  }
}

template <int TR>
int launch_tf(const NetT& nt, int mode, int target, const float* x,
              const float* prm, const float* vec, const float* dout,
              float* out, double* part, int nblk, cudaStream_t st) {
  size_t off[11];
  const size_t smem = layout_tf(nt, TR, mode >= 2, off);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = mode == 3 ? sa_fused_tf32_kernel<TR, true>
                              : sa_fused_tf32_kernel<TR, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<nblk, NTB, smem, st>>>(nt, mode, target, x, prm, vec, dout, out,
                                part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of the backward's launches (the largest) in bytes, at the
// kernel that serves the net, or -1 outside the kernels' range (1 <= L <=
// 4, C0 <= 8, widths <= 256, pool <= 128 dividing R).
extern "C" long long facl_sa_fused_smem(long long R, int C0, int L,
                                        const int* widths, int pool) {
  Net n;
  if (!make_net(R, C0, L, widths, pool, &n)) return -1;
  NetT t;
  make_nett(n, &t);
  size_t off[11];
  return static_cast<long long>(
      tc_fits_tf(t) ? layout_tf(t, CH, true, off)
                    : layout(n, tile_rows(pool), true, off));
}

// 1 if the f32 sweeps of the net run on the tensor cores, 0 if on CUDA
// cores, -1 outside the range.
extern "C" int facl_sa_fused_tc(long long R, int C0, int L,
                                const int* widths, int pool) {
  Net n;
  if (!make_net(R, C0, L, widths, pool, &n)) return -1;
  NetT t;
  make_nett(n, &t);
  return tc_fits_tf(t) ? 1 : 0;
}

// The same for the bf16 sweeps, at the kernel that serves the net.
extern "C" long long facl_sa_fused_bf16_smem(long long R, int C0, int L,
                                             const int* widths, int pool) {
  Net n;
  if (!make_net(R, C0, L, widths, pool, &n)) return -1;
  NetB b;
  make_netb(n, &b);
  size_t off[11];
  return static_cast<long long>(
      tc_fits(b) ? layout_bf(b, tile_rows_bf(b), true, off)
                 : layout(n, tile_rows(pool), true, off));
}

// 1 if the bf16 sweeps of the net run on the tensor cores, 0 if on CUDA
// cores, -1 outside the range.
extern "C" int facl_sa_fused_bf16_tc(long long R, int C0, int L,
                                     const int* widths, int pool) {
  Net n;
  if (!make_net(R, C0, L, widths, pool, &n)) return -1;
  NetB b;
  make_netb(n, &b);
  return tc_fits(b) ? 1 : 0;
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
  if constexpr (BF) {
    NetB b;
    make_netb(n, &b);
    if (tc_fits(b))
      return tile_rows_bf(b) == CH
                 ? launch_bf<CH>(b, mode, target, x, prm, vec, dout, out,
                                 part, nblk, st)
                 : launch_bf<2 * CH>(b, mode, target, x, prm, vec, dout, out,
                                     part, nblk, st);
  } else {
    NetT t;
    make_nett(n, &t);
    if (tc_fits_tf(t))
      return launch_tf<CH>(t, mode, target, x, prm, vec, dout, out, part,
                           nblk, st);
  }
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
