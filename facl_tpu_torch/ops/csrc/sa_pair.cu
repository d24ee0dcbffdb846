// B2 + B3: the pair3 set-abstraction stage — [Dense -> BN(train) -> ReLU]
// x3 (C0 -> 64 -> 64 -> 256) + max-pool over K — as five row sweeps.
//
// Replaces the TPU kernels of facl_tpu/ops/pallas/sa_pair.py:
//   B2 sa_forward_pair (:557)
//     sa_fwd_layer12   <- _make_pair_layer12_kernel (:121, pallas_call :634)
//     sa_fwd_gram_pool <- _make_gram_pool_sweep     (:179, pallas_call :660)
//   B3 sa_backward_pair, slim=True (:711)
//     sa_bwd_sweep1    <- _make_sweep1_pair_kernel  (:252, pallas_call :772)
//     sa_bwd_sweep2    <- _make_sweep2_slim_kernel  (:404, pallas_call :800)
//     sa_bwd_sweep3    <- _make_sweep3_pair_kernel  (:461, pallas_call :835)
// What each computes is written above its kernel. The TPU's paired-row
// layout (two rows side by side against block-diagonal weights, 2x the
// MACs, only to fill 128 lanes) is not carried over: these kernels work
// on plain (R, 64) rows and read the (B, C0, S*K) channel-major input.
//
// Bounds on the card (R = 2,621,440 rows at the main path): layer12,
// gram_pool and sweep2 are bound by f32 operations (the 64-wide matmuls:
// ~23, ~107 and ~86 GFLOP against 67 TFLOP/s on CUDA cores; strict f32,
// no TF32), sweep3 by operations too (~23 GFLOP), sweep1 by bytes (it
// reads p2 and writes q3, 671 MB each; dy3 has one nonzero per (group,
// channel), so its products are taken sparsely). Design, kept simple: a
// persistent grid of blocks, each looping over 64-row tiles with the
// weights resident in shared memory and a register-tiled 64x64 product
// (each of 256 threads owns a 4x4 or 4x16 output patch). Row tiles are
// staged in shared memory so device-memory reads and writes are coalesced.
//
// The TPU grid runs in order and carries its accumulators across steps;
// CUDA blocks run in parallel, so every block writes its own partial sums
// (moments, Grams, A-matrices) to a (blocks, ...) float64 buffer and the
// caller reduces them in a fixed order — no float atomics, so runs are
// deterministic. Within a block each 64-row tile is summed in float32 and
// the tile sums are carried in float64 (except sweep 1, see there): a
// block covers ~10^4 rows, and the moments feed E[p^2] - E[p]^2 and the
// Gram identities, where cancellation magnifies a running sum's error.
// Layer-1 moments, the layer-3 finalize, the pool finalize and the
// closed-form layer algebra between sweeps stay in PyTorch at full f32
// (ops/sa_pair.py), as XLA did them outside Pallas.
//
// The backward recomputes p1 -> h1 from x with the forward's exact op
// chain (h1_tile in sa_tile.cuh, shared by every x-reading kernel, B6 in
// sa_2sweep.cu too), so the ReLU masks agree bit for bit with the
// forward's (sa_pair.py:316-330).
#include <cstdint>
#include "common.cuh"
#include "sa_tile.cuh"

namespace {

// ---------------------------------------------------------------------
// B2 sweep A: x -> p1 -> h1 -> p2, plus per-block sums of p2 and p2^2.
// part: (blocks, 2, 64) float64 = [sum p2 | sum p2^2].
__global__ void __launch_bounds__(NT)
fwd_layer12_kernel(const float* __restrict__ x, int C0, int64_t N,
                   int64_t ntiles, const float* __restrict__ W1,
                   const float* __restrict__ vec1, const float* __restrict__ W2,
                   const float* __restrict__ b2, float* __restrict__ p2,
                   double* __restrict__ part) {
  extern __shared__ float sm[];
  float* W2s = sm;                      // CW*CW
  float* h1s = W2s + CW * CW;           // TR*LD
  float* xs = h1s + TR * LD;            // TR*C0MAX
  float* W1s = xs + TR * C0MAX;         // C0MAX*CW
  float* v1 = W1s + C0MAX * CW;         // 3*CW
  float* b2s = v1 + 3 * CW;             // CW
  double* red = reinterpret_cast<double*>(b2s + CW);   // 2*16*CW

  copy_vec(W2s, W2, CW * CW);
  copy_vec(W1s, W1, C0 * CW);
  copy_vec(v1, vec1, 3 * CW);
  copy_vec(b2s, b2, CW);
  __syncthreads();

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  double s[4] = {0.0, 0.0, 0.0, 0.0}, ss[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t r0 = t * TR;
    load_x_tile(x, C0, N, r0, xs);
    __syncthreads();
    h1_tile(xs, C0, W1s, v1, h1s);
    __syncthreads();
    float acc[4][4];
    mm64(h1s, W2s, nullptr, acc);
    __syncthreads();                   // h1s is reused as the p2 tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float ts = 0.f, tss = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = __fadd_rn(acc[i][j], b2s[c]);
        h1s[(ty + 16 * i) * LD + c] = v;
        ts += v;
        tss = fmaf(v, v, tss);
      }
      s[j] += ts;
      ss[j] += tss;
    }
    __syncthreads();
    store_tile(h1s, r0, p2);
    __syncthreads();
  }
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
// B2 sweep B: over p2, h2 = relu(p2*mul2 + shift2); per-block Gram(h2)
// and colsum(h2); raw p3 = h2 W3 + b3 and, per (pool group, channel), its
// max and min with the first row index of each (the layer-3 affine is
// applied after the moments finalize — exact by monotone commutation,
// sa_pair.py:179-209).
// partG: (blocks, 64, 64), partc: (blocks, 64), both float64;
// mx/mn/imx/imn: (P, 256).
__global__ void __launch_bounds__(NT)
fwd_gram_pool_kernel(const float* __restrict__ p2, int64_t ntiles, int pool,
                     const float* __restrict__ vec2,
                     const float* __restrict__ W3, const float* __restrict__ b3,
                     double* __restrict__ partG, double* __restrict__ partc,
                     float* __restrict__ mx, float* __restrict__ mn,
                     int* __restrict__ imx, int* __restrict__ imn) {
  extern __shared__ float sm[];
  float* W3s = sm;                      // CW*C3W
  float* p3s = W3s + CW * C3W;          // TR*C3W
  float* h2s = p3s + TR * C3W;          // TR*LD
  float* v2 = h2s + TR * LD;            // mul2 | shift2
  float* b3s = v2 + 2 * CW;             // C3W

  copy_vec(W3s, W3, CW * C3W);
  copy_vec(v2, vec2, 2 * CW);
  copy_vec(b3s, b3, C3W);
  __syncthreads();

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // pool <= TR: gpt whole groups per tile. pool > TR: a group spans upt
  // consecutive tiles, walked in order by one block with the running
  // max/min in registers (thread c owns channel c; NT == C3W).
  const int gpt = pool <= TR ? TR / pool : 1;
  const int upt = pool <= TR ? 1 : pool / TR;
  double g[4][4] = {};
  double ch = 0.0;

  for (int64_t u = blockIdx.x; u < ntiles / upt; u += gridDim.x) {
    float rmax = 0.f, rmin = 0.f;
    int amax = 0, amin = 0;
    for (int j = 0; j < upt; ++j) {
      const int64_t t = u * upt + j;
      const int64_t r0 = t * TR;
      load_h_tile(p2, r0, v2, v2 + CW, h2s);
      __syncthreads();
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
          p3s[(ty + 16 * i) * C3W + c] = __fadd_rn(acc[i][j], b3s[c]);
        }
      __syncthreads();

      if (pool <= TR) {
        for (int e = threadIdx.x; e < gpt * C3W; e += NT) {
          const int gi = e / C3W, c = e % C3W;
          const int base = gi * pool;
          float vmax = p3s[base * C3W + c], vmin = vmax;
          int imax = 0, imin = 0;
          for (int r = 1; r < pool; ++r) {
            const float v = p3s[(base + r) * C3W + c];
            if (v > vmax) { vmax = v; imax = r; }
            if (v < vmin) { vmin = v; imin = r; }
          }
          const int64_t o = (t * gpt + gi) * C3W + c;
          mx[o] = vmax;
          mn[o] = vmin;
          imx[o] = imax;
          imn[o] = imin;
        }
      } else {
        const int c = threadIdx.x;
        for (int r = 0; r < TR; ++r) {
          const float v = p3s[r * C3W + c];
          const int rg = j * TR + r;      // row within the group
          if (rg == 0) {
            rmax = rmin = v;
          } else {
            if (v > rmax) { rmax = v; amax = rg; }
            if (v < rmin) { rmin = v; amin = rg; }
          }
        }
        if (j == upt - 1) {
          const int64_t o = u * C3W + c;
          mx[o] = rmax;
          mn[o] = rmin;
          imx[o] = amax;
          imn[o] = amin;
        }
      }
      __syncthreads();
    }
  }
  write_patch(g, partG + (int64_t)blockIdx.x * CW * CW);
  if (threadIdx.x < CW) partc[(int64_t)blockIdx.x * CW + threadIdx.x] = ch;
}

// ---------------------------------------------------------------------
// B3 sweep 1: dy3 from the pool-argmax residual (dy3[row, c] = dpooled[g,
// c] at row = g*pool + idx[g, c], zero elsewhere; idx == pool marks a dead
// ReLU), per-block A3 = dy3^T h2 (256, 64) and u3 = sum dy3, and the row
// output q3 = (gi3 * dy3) W3^T (R, 64). dy3 has one nonzero per (group,
// channel), so A3 and q3 are accumulated from those entries only.
__global__ void __launch_bounds__(NT)
bwd_sweep1_kernel(const float* __restrict__ p2, int64_t ntiles, int pool,
                  const float* __restrict__ vec2,
                  const float* __restrict__ dpooled,
                  const int* __restrict__ idx, const float* __restrict__ gi3,
                  const float* __restrict__ W3, float* __restrict__ q3,
                  double* __restrict__ partA, double* __restrict__ partu) {
  extern __shared__ float sm[];
  // Groups per tile (pool <= TR) or tiles per group (pool > TR, walked
  // in order by one block), as in fwd_gram_pool_kernel.
  const int gpt = pool <= TR ? TR / pool : 1;
  const int upt = pool <= TR ? 1 : pool / TR;
  float* W3t = sm;                      // C3W*CW, W3t[c][j] = W3[j][c]
  float* h2s = W3t + C3W * CW;          // TR*LD
  float* q3s = h2s + TR * LD;           // TR*LD
  float* v2 = q3s + TR * LD;            // mul2 | shift2
  float* gis = v2 + 2 * CW;             // C3W
  float* dvs = gis + C3W;               // gpt*C3W: dpooled
  float* vgs = dvs + gpt * C3W;         // gpt*C3W: dpooled * gi3
  // rs: the tile row that takes dpooled[g, c], or -1 (dead ReLU, or the
  // argmax row lies in another tile of a group spanning tiles).
  int* rs = reinterpret_cast<int*>(vgs + gpt * C3W);   // gpt*C3W

  for (int e = threadIdx.x; e < C3W * CW; e += NT) {
    const int c = e / CW, j = e % CW;
    W3t[e] = W3[j * C3W + c];
  }
  copy_vec(v2, vec2, 2 * CW);
  copy_vec(gis, gi3, C3W);
  __syncthreads();

  const int c_own = threadIdx.x;        // A3 row owned by this thread
  // float32 running sums here: at K = 64 a block adds one product per
  // tile (~150 at the main path), and 64 float64 registers would halve
  // the blocks per SM (measured 2.8 -> 6.9 ms).
  float a3[CW];
#pragma unroll
  for (int k = 0; k < CW; ++k) a3[k] = 0.f;
  float u3 = 0.f;
  const int jq = threadIdx.x % CW, quarter = threadIdx.x / CW;

  for (int64_t u = blockIdx.x; u < ntiles / upt; u += gridDim.x) {
    for (int j = 0; j < upt; ++j) {
      const int64_t t = u * upt + j;
      const int64_t r0 = t * TR;
      const int64_t g0 = pool <= TR ? t * gpt : u;     // first group
      load_h_tile(p2, r0, v2, v2 + CW, h2s);
      for (int e = threadIdx.x; e < TR * LD; e += NT) q3s[e] = 0.f;
      for (int e = threadIdx.x; e < gpt * C3W; e += NT) {
        const int64_t o = g0 * C3W + e;
        const float dv = dpooled[o];
        const int rr = idx[o];
        const int lr = pool <= TR ? (e / C3W) * pool + rr : rr - j * TR;
        dvs[e] = dv;
        vgs[e] = __fmul_rn(dv, gis[e % C3W]);
        rs[e] = (rr < pool && lr >= 0 && lr < TR) ? lr : -1;
      }
      __syncthreads();

      for (int gi = 0; gi < gpt; ++gi) {
        const int lr = rs[gi * C3W + c_own];
        if (lr >= 0) {
          const float dv = dvs[gi * C3W + c_own];
          const float* hrow = h2s + lr * LD;
#pragma unroll
          for (int k = 0; k < CW; ++k) a3[k] = fmaf(dv, hrow[k], a3[k]);
          u3 += dv;
        }
      }
      // q3: thread (quarter, jq) owns column jq of rows [16 quarter, +16).
      for (int gi = 0; gi < gpt; ++gi) {
        for (int c = 0; c < C3W; ++c) {
          const int row = rs[gi * C3W + c];
          if (row >= 0 && (row >> 4) == quarter)
            q3s[row * LD + jq] =
                fmaf(vgs[gi * C3W + c], W3t[c * CW + jq], q3s[row * LD + jq]);
        }
      }
      __syncthreads();
      store_tile(q3s, r0, q3);
      __syncthreads();
    }
  }
#pragma unroll
  for (int k = 0; k < CW; ++k)
    partA[((int64_t)blockIdx.x * C3W + c_own) * CW + k] = a3[k];
  partu[(int64_t)blockIdx.x * C3W + c_own] = u3;
}

// ---------------------------------------------------------------------
// B3 sweep 2 (slim): recompute h1 (from x) and h2 (from p2); dy2 =
// [h2 > 0] (q3 - h2 M3 - rc3); q2 = (gi2 * dy2) W2^T; row output mq =
// [h1 > 0] q2; per-block A2 = dy2^T h1, G1 = h1^T h1, u2 = sum dy2,
// ch1 = sum h1. vec holds [b1 | mul1 | shift1 | mul2 | shift2 | rc3 | gi2].
__global__ void __launch_bounds__(NT)
bwd_sweep2_kernel(const float* __restrict__ x, int C0, int64_t N,
                  int64_t ntiles, const float* __restrict__ W1,
                  const float* __restrict__ vec,
                  const float* __restrict__ p2, const float* __restrict__ q3,
                  const float* __restrict__ M3, const float* __restrict__ W2,
                  float* __restrict__ mq, double* __restrict__ partA,
                  double* __restrict__ partG, double* __restrict__ partu,
                  double* __restrict__ partc) {
  extern __shared__ float sm[];
  float* M3s = sm;                      // CW*CW
  float* W2t = M3s + CW * CW;           // CW*CW, W2t[c][j] = W2[j][c]
  float* h1s = W2t + CW * CW;           // TR*LD
  float* h2s = h1s + TR * LD;           // TR*LD (later: the mq tile)
  float* dys = h2s + TR * LD;           // TR*LD (q3, then dy2)
  float* xs = dys + TR * LD;            // TR*C0MAX
  float* W1s = xs + TR * C0MAX;         // C0MAX*CW
  float* v = W1s + C0MAX * CW;          // 7*CW
  const float* v1 = v;                  // b1 | mul1 | shift1
  const float* mul2 = v + 3 * CW;
  const float* shift2 = v + 4 * CW;
  const float* rc3 = v + 5 * CW;
  const float* gi2 = v + 6 * CW;

  copy_vec(M3s, M3, CW * CW);
  for (int e = threadIdx.x; e < CW * CW; e += NT) {
    const int c = e / CW, j = e % CW;
    W2t[e] = W2[j * CW + c];
  }
  copy_vec(W1s, W1, C0 * CW);
  copy_vec(v, vec, 7 * CW);
  __syncthreads();

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  double a2[4][4] = {}, g1[4][4] = {};
  double colsum = 0.0;   // threads 0..63: u2[c]; 64..127: ch1[c - 64]

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t r0 = t * TR;
    load_x_tile(x, C0, N, r0, xs);
    load_h_tile(p2, r0, mul2, shift2, h2s);
    load_tile(q3, r0, dys);
    __syncthreads();
    h1_tile(xs, C0, W1s, v1, h1s);
    float acc[4][4];
    mm64(h2s, M3s, nullptr, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float dh = __fsub_rn(__fsub_rn(dys[r * LD + c], acc[i][j]),
                                   rc3[c]);
        dys[r * LD + c] = h2s[r * LD + c] > 0.f ? dh : 0.f;
      }
    __syncthreads();
    mm64(dys, W2t, gi2, acc);          // q2
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        h2s[r * LD + c] = h1s[r * LD + c] > 0.f ? acc[i][j] : 0.f;
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
    if (threadIdx.x < 2 * CW) {
      const float* src = threadIdx.x < CW ? dys + threadIdx.x
                                          : h1s + threadIdx.x - CW;
      float tc = 0.f;
      for (int r = 0; r < TR; ++r) tc += src[r * LD];
      colsum += tc;
    }
    __syncthreads();
    store_tile(h2s, r0, mq);
    __syncthreads();
  }
  write_patch(a2, partA + (int64_t)blockIdx.x * CW * CW);
  write_patch(g1, partG + (int64_t)blockIdx.x * CW * CW);
  if (threadIdx.x < CW)
    partu[(int64_t)blockIdx.x * CW + threadIdx.x] = colsum;
  else if (threadIdx.x < 2 * CW)
    partc[(int64_t)blockIdx.x * CW + threadIdx.x - CW] = colsum;
}

// ---------------------------------------------------------------------
// B3 sweep 3: recompute h1 from x; dy1 = [h1 > 0] (mq - (h1 M2 + rc2));
// per-block dy1^T [x | 1] -> part (blocks, 64, C0 + 1) = [A1 | u1].
// vec holds [b1 | mul1 | shift1 | rc2].
__global__ void __launch_bounds__(NT)
bwd_sweep3_kernel(const float* __restrict__ x, int C0, int64_t N,
                  int64_t ntiles, const float* __restrict__ W1,
                  const float* __restrict__ vec, const float* __restrict__ mq,
                  const float* __restrict__ M2, double* __restrict__ part) {
  extern __shared__ float sm[];
  float* M2s = sm;                      // CW*CW
  float* h1s = M2s + CW * CW;           // TR*LD
  float* dys = h1s + TR * LD;           // TR*LD (mq, then dy1)
  float* xs = dys + TR * LD;            // TR*C0MAX
  float* W1s = xs + TR * C0MAX;         // C0MAX*CW
  float* v = W1s + C0MAX * CW;          // 4*CW
  const float* rc2 = v + 3 * CW;

  copy_vec(M2s, M2, CW * CW);
  copy_vec(W1s, W1, C0 * CW);
  copy_vec(v, vec, 4 * CW);
  __syncthreads();

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int ne = CW * (C0 + 1);         // <= 2 * NT for C0 <= 7
  double out[2] = {0.0, 0.0};

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t r0 = t * TR;
    load_x_tile(x, C0, N, r0, xs);
    load_tile(mq, r0, dys);
    __syncthreads();
    h1_tile(xs, C0, W1s, v, h1s);
    __syncthreads();
    float acc[4][4];
    mm64(h1s, M2s, nullptr, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float corr = __fadd_rn(acc[i][j], rc2[c]);
        dys[r * LD + c] =
            h1s[r * LD + c] > 0.f ? __fsub_rn(dys[r * LD + c], corr) : 0.f;
      }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = threadIdx.x + u * NT;
      if (e < ne) {
        const int j = e % CW, i = e / CW;
        float a = 0.f;
        if (i < C0) {
          for (int r = 0; r < TR; ++r)
            a = fmaf(dys[r * LD + j], xs[r * C0MAX + i], a);
        } else {
          for (int r = 0; r < TR; ++r) a += dys[r * LD + j];
        }
        out[u] += a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = threadIdx.x + u * NT;
    if (e < ne) {
      const int j = e % CW, i = e / CW;
      part[(int64_t)blockIdx.x * ne + j * (C0 + 1) + i] = out[u];
    }
  }
}

}  // namespace

// Every launcher: grid = nblk persistent blocks over R / 64 row tiles;
// returns cudaGetLastError() (0 on success).
extern "C" int facl_sa_fwd_layer12(const float* x, int B, int C0, int N,
                                   const float* W1, const float* vec1,
                                   const float* W2, const float* b2,
                                   float* p2, double* part, int nblk,
                                   void* stream) {
  const int64_t R = (int64_t)B * N;
  if (bad_shape(C0, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (CW * CW + TR * LD + TR * C0MAX +
                                       C0MAX * CW + 4 * CW) +
                      sizeof(double) * 2 * 16 * CW;
  cudaError_t e = prepare(fwd_layer12_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_layer12_kernel<<<nblk, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, C0, N, R / TR, W1, vec1, W2, b2, p2, part);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int facl_sa_fwd_gram_pool(const float* p2, int64_t R, int pool,
                                     const float* vec2, const float* W3,
                                     const float* b3, double* partG,
                                     double* partc, float* mx, float* mn,
                                     int* imx, int* imn, int nblk,
                                     void* stream) {
  if (bad_pool(R, pool)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (CW * C3W + TR * C3W + TR * LD + 2 * CW + C3W);
  cudaError_t e = prepare(fwd_gram_pool_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_gram_pool_kernel<<<nblk, NT, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      p2, R / TR, pool, vec2, W3, b3, partG, partc, mx, mn, imx, imn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int facl_sa_bwd_sweep1(const float* p2, int64_t R, int pool,
                                  const float* vec2, const float* dpooled,
                                  const int* idx, const float* gi3,
                                  const float* W3, float* q3, double* partA,
                                  double* partu, int nblk, void* stream) {
  if (bad_pool(R, pool)) return static_cast<int>(cudaErrorInvalidValue);
  const int gpt = pool <= TR ? TR / pool : 1;
  const size_t smem = sizeof(float) * (C3W * CW + 2 * TR * LD + 2 * CW +
                                       C3W + 3 * gpt * C3W);
  cudaError_t e = prepare(bwd_sweep1_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_sweep1_kernel<<<nblk, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      p2, R / TR, pool, vec2, dpooled, idx, gi3, W3, q3, partA, partu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int facl_sa_bwd_sweep2(const float* x, int B, int C0, int N,
                                  const float* W1, const float* vec,
                                  const float* p2, const float* q3,
                                  const float* M3, const float* W2,
                                  float* mq, double* partA, double* partG,
                                  double* partu, double* partc, int nblk,
                                  void* stream) {
  const int64_t R = (int64_t)B * N;
  if (bad_shape(C0, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * CW * CW + 3 * TR * LD +
                                       TR * C0MAX + C0MAX * CW + 7 * CW);
  cudaError_t e = prepare(bwd_sweep2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_sweep2_kernel<<<nblk, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, C0, N, R / TR, W1, vec, p2, q3, M3, W2, mq, partA, partG, partu,
      partc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int facl_sa_bwd_sweep3(const float* x, int B, int C0, int N,
                                  const float* W1, const float* vec,
                                  const float* mq, const float* M2,
                                  double* part, int nblk, void* stream) {
  const int64_t R = (int64_t)B * N;
  if (bad_shape(C0, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (CW * CW + 2 * TR * LD + TR * C0MAX +
                                       C0MAX * CW + 4 * CW);
  cudaError_t e = prepare(bwd_sweep3_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_sweep3_kernel<<<nblk, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, C0, N, R / TR, W1, vec, mq, M2, part);
  return static_cast<int>(cudaGetLastError());
}
