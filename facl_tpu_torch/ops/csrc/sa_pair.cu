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
// Bounds on the card (R = 2,621,440 rows at the main path). layer12 and
// sweep3 are bound by f32 operations on CUDA cores (~23 GFLOP each
// against 67 TFLOP/s), sweep1 by bytes (it reads p2 and writes q3, 671 MB
// each; dy3 has one nonzero per (group, channel), so its products are
// taken sparsely). Their design: a persistent grid of blocks, each
// looping over 64-row tiles with the weights resident in shared memory
// and a register-tiled 64x64 product (each of 256 threads owns a 4x4 or
// 4x16 output patch), row tiles staged in shared memory.
//
// gram_pool (B2b) and sweep2 (B3b) run their 64-wide products on tensor
// cores in 3xTF32 (sa_mma.cuh; f32-level accuracy). Their bounds there:
// gram_pool ~0.63 ms by operations (~97 GFLOP of products, three TF32
// passes each at 495 TFLOP/s, plus its CUDA-core work), sweep2 ~0.61 ms
// by bytes (x, p2, q3 in and mq out: 784 B a row); on CUDA cores in f32
// they would be bound at 1.48 and 1.18 ms. What holds them above that on
// mma.sync: each warp reads its A and B fragments from shared memory
// (hi and lo), ~640 KB per gram_pool tile against 128 B a clock, and the
// per-(group, column) pool and the ReLU/split passes are CUDA-core work
// between barriers that the products do not overlap. The designs keep
// what they can off that path: one TMA bulk copy per row tile, several
// tiles in flight; operands used by several warps (W3, M3, gi2 * W2^T,
// h2 in gram_pool, h1 and dy2 in sweep2) split into hi/lo once; the pool
// reduced from the accumulators (no p3 tile in shared memory); sweep2's
// mq leaving by a TMA bulk store. The backward recomputes h1 in B3b
// with h1_tile's op chain (h1_rows in sa_mma.cuh), and 3xTF32 moves no
// ReLU mask: masks come from the CUDA-core chains only.
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
// sa_2sweep.cu too, and h1_rows in sa_mma.cuh), so the ReLU masks agree
// bit for bit with the forward's (sa_pair.py:316-330).
#include <cstdint>
#include "common.cuh"
#include "sa_tile.cuh"
#include "sa_mma.cuh"

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
//
// Tensor cores (sa_mma.cuh), 16 warps: warp w = (mw, nw) = (w % 4, w / 4)
// takes the Gram's rows 16 mw.. and columns 16 nw..; for p3 it takes the
// columns 16 w.. of all 64 rows, so each (group, column) max and min is
// reduced from the accumulators inside one warp (pool_tile). p2 tiles arrive by
// TMA, one bulk copy each, three in flight; h2 and W3 are split into
// hi/lo once (the tile after its ReLU, W3 when the block starts), so the
// products load their fragments ready. One block per SM (220 KB of shared
// memory).

constexpr uint32_t FULL = 0xffffffffu;

// Per (group, column) max and min of one tile's raw p3 (acc + b3) for the
// 16 columns n0.. of a warp, with the first in-group row of each (the
// smallest row holding the group's max, or min). LP = log2(min(pool,
// TR)). Lane (g, t) holds rows 8 i + g (i < 8) of columns n0 + 8 nj + 2t
// (+1); a group's rows span SI of a lane's i and the low SH bits of g.
// pool > TR (upt > 1): a group spans upt consecutive tiles, walked in
// order by one block; the running max/min sit in run.
template <int LP>
__device__ __forceinline__ void pool_tile(const float c[4][2][4], int n0,
                                          const float* b3s, int64_t tile,
                                          int upt, float* run, float* mx,
                                          float* mn, int* imx, int* imn) {
  constexpr int SI = LP > 3 ? 1 << (LP - 3) : 1;
  constexpr int SH = LP < 3 ? LP : 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int* irun = reinterpret_cast<int*>(run + 2 * C3W);
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int cj = 0; cj < 2; ++cj) {
      const int col = n0 + 8 * nj + 2 * t + cj;
      const float bias = b3s[col];
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = __fadd_rn(c[i >> 1][nj][((i & 1) << 1) | cj], bias);
      // Per group: its max and min over the lane's rows and then the
      // group's lanes; then the first row holding each (min over rows).
      float vx[8], vn[8];
      int ix[8], in[8];
#pragma unroll
      for (int i = 0; i < 8; i += SI) {
        float m = v[i], n = v[i];
#pragma unroll
        for (int k = 1; k < SI; ++k) {
          m = fmaxf(m, v[i + k]);
          n = fminf(n, v[i + k]);
        }
#pragma unroll
        for (int b = 0; b < SH; ++b) {
          m = fmaxf(m, __shfl_xor_sync(FULL, m, 4 << b));
          n = fminf(n, __shfl_xor_sync(FULL, n, 4 << b));
        }
        int jm = TR, jn = TR;
#pragma unroll
        for (int k = SI - 1; k >= 0; --k) {
          if (v[i + k] == m) jm = 8 * (i + k) + g;
          if (v[i + k] == n) jn = 8 * (i + k) + g;
        }
#pragma unroll
        for (int b = 0; b < SH; ++b) {
          jm = min(jm, __shfl_xor_sync(FULL, jm, 4 << b));
          jn = min(jn, __shfl_xor_sync(FULL, jn, 4 << b));
        }
        vx[i] = m;
        vn[i] = n;
        ix[i] = jm;
        in[i] = jn;
      }
      if ((g & ((1 << SH) - 1)) != 0) continue;
#pragma unroll
      for (int i = 0; i < 8; i += SI) {
        const int grp = (8 * i + g) >> LP;      // group within the tile
        const int base = grp << LP;
        if (upt == 1) {
          const int64_t o = (tile * (TR >> LP) + grp) * C3W + col;
          mx[o] = vx[i];
          mn[o] = vn[i];
          imx[o] = ix[i] - base;
          imn[o] = in[i] - base;
        } else {                                // LP == 6: one group
          const int j = static_cast<int>(tile % upt);
          if (j == 0 || vx[i] > run[col]) {
            run[col] = vx[i];
            irun[col] = ix[i] + j * TR;
          }
          if (j == 0 || vn[i] < run[C3W + col]) {
            run[C3W + col] = vn[i];
            irun[C3W + col] = in[i] + j * TR;
          }
          if (j == upt - 1) {
            const int64_t o = (tile / upt) * C3W + col;
            mx[o] = run[col];
            mn[o] = run[C3W + col];
            imx[o] = irun[col];
            imn[o] = irun[C3W + col];
          }
        }
      }
    }
}

constexpr int GP_STAGES = 3;    // p2 tiles in flight per block

template <int LP>
__global__ void __launch_bounds__(NTM, 1)
fwd_gram_pool_kernel(const float* __restrict__ p2, int64_t ntiles, int upt,
                     const float* __restrict__ vec2,
                     const float* __restrict__ W3, const float* __restrict__ b3,
                     double* __restrict__ partG, double* __restrict__ partc,
                     float* __restrict__ mx, float* __restrict__ mn,
                     int* __restrict__ imx, int* __restrict__ imn) {
  extern __shared__ __align__(128) float smt[];
  float* stage = smt;                         // GP_STAGES x (TR, CW): p2
  float* Hh = stage + GP_STAGES * TR * CW;    // h2, split: hi
  float* Hl = Hh + TILE_F;                    //            lo
  float* W3h = Hl + TILE_F;                   // W3, split, paired layout
  float* W3l = W3h + 32 * b_stride(C3W);
  float* v2 = W3l + 32 * b_stride(C3W);       // mul2 | shift2
  float* b3s = v2 + 2 * CW;                   // C3W
  float* run = b3s + C3W;                     // 4 x C3W (pool > TR)
  uint64_t* bars = reinterpret_cast<uint64_t*>(run + 4 * C3W);
  const SplitBuf H{Hh, Hl}, W{W3h, W3l};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mw = warp & 3, nw = warp >> 2;
  // This block's tiles in order: whole units of upt tiles (a pool group
  // spanning tiles stays with one block), units strided over the grid.
  const int64_t units = ntiles / upt;
  const int64_t count =
      units > blockIdx.x ? ((units - 1 - blockIdx.x) / gridDim.x + 1) * upt
                         : 0;
  auto tile_at = [&](int64_t i) {
    return (blockIdx.x + (i / upt) * gridDim.x) * upt + i % upt;
  };
  auto fetch = [&](int64_t i) {               // thread 0: one bulk copy
    uint64_t* bar = &bars[i % GP_STAGES];
    mbar_expect(bar, TR * CW * 4);
    bulk_load(stage + (i % GP_STAGES) * TR * CW, p2 + tile_at(i) * TR * CW,
              TR * CW * 4, bar);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < GP_STAGES; ++s) mbar_init(&bars[s]);
    for (int64_t i = 0; i < GP_STAGES && i < count; ++i) fetch(i);
  }
  load_b_split(W3h, W3l, W3, C3W, C3W, 1);
  copy_block(v2, vec2, 2 * CW);
  copy_block(b3s, b3, C3W);
  __syncthreads();

  // Gram(h2) is symmetric: warps with nw < mw (blocks below the diagonal)
  // skip it, and the warps above it write their block twice.
  double G[2][4] = {};        // rows 16 mw + g (+8), cols 16 nw + 8 nj + 2t
  double ch[2] = {0.0, 0.0};  // diagonal warps: channels 16 mw + g, + 8
  for (int64_t i = 0; i < count; ++i) {
    const int64_t tile = tile_at(i);
    mbar_wait(&bars[i % GP_STAGES],
              static_cast<uint32_t>((i / GP_STAGES) & 1));
    relu_split_rows(stage + (i % GP_STAGES) * TR * CW, v2, v2 + CW, Hh, Hl);
    __syncthreads();
    if (threadIdx.x == 0 && i + GP_STAGES < count) fetch(i + GP_STAGES);

    if (nw >= mw) {   // Gram(h2); the column sums from the same fragments
      float c[2][4];
      float s0 = 0.f, s1 = 0.f;
      zero4(c[0]);
      zero4(c[1]);
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
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) G[nj][q] += c[nj][q];
      ch[0] += s0;
      ch[1] += s1;
    }

    {   // p3 = h2 W3 (+ b3 in pool_tile) for the columns 16 w..
      const int n0 = 16 * warp;
      float c[4][2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        zero4(c[mi][0]);
        zero4(c[mi][1]);
      }
#pragma unroll 4
      for (int kb = 0; kb < 8; ++kb) {
        const FragB b0 = frag_b_paired(W, b_stride(C3W), n0, kb, lane);
        const FragB b1 = frag_b_paired(W, b_stride(C3W), n0 + 8, kb, lane);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const FragA a = frag_a_rows(H, 16 * mi, kb, lane);
          mma3(c[mi][0], a, b0);
          mma3(c[mi][1], a, b1);
        }
      }
      pool_tile<LP>(c, n0, b3s, tile, upt, run, mx, mn, imx, imn);
    }
    __syncthreads();
  }

  double* pg = partG + (int64_t)blockIdx.x * CW * CW;
  if (nw >= mw) {
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 16 * mw + g + 8 * (q >> 1);
        const int cc = 16 * nw + 8 * nj + 2 * t + (q & 1);
        pg[r * CW + cc] = G[nj][q];
        if (nw > mw) pg[cc * CW + r] = G[nj][q];
      }
  }
  if (nw == mw) {
    const double a = sum_over_t(ch[0]), b = sum_over_t(ch[1]);
    if (t == 0) {
      partc[(int64_t)blockIdx.x * CW + 16 * mw + g] = a;
      partc[(int64_t)blockIdx.x * CW + 16 * mw + g + 8] = b;
    }
  }
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
//
// Tensor cores (sa_mma.cuh), 16 warps: warp w = (mw, nw) = (w % 4, w / 4)
// takes rows 16 mw.. and columns 16 nw.. of h2 M3 and q2, and rows
// (channels) 16 mw.. and columns 16 nw.. of A2 and G1, whose B fragments
// (h1) it shares. x (channel-major: one bulk copy per channel when
// N % TR == 0), p2 and q3 tiles arrive by TMA (one bulk copy each; p2 and
// x two tiles ahead, q3 one); h2 is copied into a padded tile after its
// ReLU, q3 is read where it landed. mq is staged in shared memory and
// leaves by a TMA bulk store. M3, gi2 * W2^T (once per block), h1 and dy2
// (per tile) are split into hi/lo ahead of the products, h2 at fragment
// load; h1's ReLU mask is kept as bytes. One block per SM (218 KB of
// shared memory).
__device__ __forceinline__ void load_x_rows(const float* __restrict__ x,
                                            int C0, int64_t N, int64_t r0,
                                            float* xs) {
  for (int e = threadIdx.x; e < TR * C0; e += NTM) {
    const int i = e % TR, c = e / TR;
    const int64_t r = r0 + i;
    const int64_t b = r / N, n = r - b * N;
    xs[c * TR + i] = x[(b * C0 + c) * N + n];
  }
}

__global__ void __launch_bounds__(NTM, 1)
bwd_sweep2_kernel(const float* __restrict__ x, int C0, int64_t N,
                  int64_t ntiles, const float* __restrict__ W1,
                  const float* __restrict__ vec,
                  const float* __restrict__ p2, const float* __restrict__ q3,
                  const float* __restrict__ M3, const float* __restrict__ W2,
                  float* __restrict__ mq, double* __restrict__ partA,
                  double* __restrict__ partG, double* __restrict__ partu,
                  double* __restrict__ partc) {
  constexpr int STAGE = TR * CW + C0MAX * TR;      // p2 | x
  constexpr int WB = 32 * b_stride(CW);            // a 64x64 paired B
  extern __shared__ __align__(128) float smt[];
  float* stage = smt;                       // 2 x STAGE, as TMA lands them
  float* Q = stage + 2 * STAGE;             // q3 (TR, CW), as TMA lands it
  float* H2 = Q + TR * CW;                  // (TR, LDT): h2; then mq
  float* dyh = H2 + TILE_F;                 // dy2, split: hi
  float* dyl = dyh + TILE_F;                //             lo
  float* h1h = dyl + TILE_F;                // h1, split: hi
  float* h1l = h1h + TILE_F;                //            lo
  float* Mh = h1l + TILE_F;                 // M3, split, paired layout
  float* Ml = Mh + WB;
  float* W2h = Ml + WB;                     // gi2 * W2^T, split, paired
  float* W2l = W2h + WB;
  float* W1s = W2l + WB;                    // C0MAX * CW
  float* v = W1s + C0MAX * CW;              // 7 * CW
  uint8_t* m1 = reinterpret_cast<uint8_t*>(v + 7 * CW);   // TR * CW
  uint64_t* bars = reinterpret_cast<uint64_t*>(m1 + TR * CW);  // 3
  const float* mul2 = v + 3 * CW;
  const float* shift2 = v + 4 * CW;
  const float* rc3 = v + 5 * CW;
  const SplitBuf H1{h1h, h1l}, DY{dyh, dyl}, Ms{Mh, Ml}, W2s{W2h, W2l};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mw = warp & 3, nw = warp >> 2;
  const int m0 = 16 * mw, n0 = 16 * nw;
  const bool xbulk =
      N % TR == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int64_t count =
      ntiles > blockIdx.x ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto row0 = [&](int64_t i) { return (blockIdx.x + i * gridDim.x) * TR; };
  auto fetch = [&](int64_t i) {             // thread 0: p2 and x of tile i
    uint64_t* bar = &bars[i & 1];
    float* S = stage + (i & 1) * STAGE;
    const int64_t r0 = row0(i);
    mbar_expect(bar, TR * CW * 4 + (xbulk ? C0 * TR * 4 : 0));
    bulk_load(S, p2 + r0 * CW, TR * CW * 4, bar);
    if (xbulk) {
      const int64_t b = r0 / N, n = r0 - b * N;
      for (int c = 0; c < C0; ++c)
        bulk_load(S + TR * CW + c * TR, x + (b * C0 + c) * N + n, TR * 4,
                  bar);
    }
  };
  auto fetch_q3 = [&](int64_t i) {        // thread 0: q3 of tile i
    mbar_expect(&bars[2], TR * CW * 4);
    bulk_load(Q, q3 + row0(i) * CW, TR * CW * 4, &bars[2]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < 3; ++s) mbar_init(&bars[s]);
    for (int64_t i = 0; i < 2 && i < count; ++i) fetch(i);
    if (count > 0) fetch_q3(0);
  }
  load_b_split(Mh, Ml, M3, CW, CW, 1);
  load_b_split(W2h, W2l, W2, CW, 1, CW, vec + 6 * CW);  // gi2[k] W2[n][k]
  copy_block(W1s, W1, C0 * CW);
  copy_block(v, vec, 7 * CW);
  __syncthreads();

  double A2[2][4] = {}, G1[2][4] = {};  // rows m0 + g (+8), cols n0 + 8 nj
  double cs[2] = {0.0, 0.0};  // nw 0: u2, nw 1: ch1; channels m0 + g, + 8
  for (int64_t i = 0; i < count; ++i) {
    const int64_t r0 = row0(i);
    const float* S = stage + (i & 1) * STAGE;
    float* X = stage + (i & 1) * STAGE + TR * CW;
    mbar_wait(&bars[i & 1], static_cast<uint32_t>((i >> 1) & 1));
    if (!xbulk) {
      load_x_rows(x, C0, N, r0, X);
      __syncthreads();
    }
    relu_rows(S, mul2, shift2, H2);
    h1_rows(X, C0, W1s, v, h1h, h1l, m1);
    __syncthreads();
    if (threadIdx.x == 0 && i + 2 < count) fetch(i + 2);

    {   // dy2 = [h2 > 0] (q3 - h2 M3 - rc3), written split; each warp on
        // its own (16, 16) block
      float c[2][4];
      zero4(c[0]);
      zero4(c[1]);
#pragma unroll 2
      for (int kb = 0; kb < 8; ++kb) {
        const FragA a = split_a(raw_a_rows(H2, m0, kb, lane));
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          mma3(c[nj], a,
               frag_b_paired(Ms, b_stride(CW), n0 + 8 * nj, kb, lane));
      }
      mbar_wait(&bars[2], static_cast<uint32_t>(i & 1));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h, cc = n0 + 8 * nj + 2 * t;
          const float2 hv = ld2(H2 + r * LDT + cc);
          const float2 qv = ld2(Q + r * CW + cc);
          const float dx =
              hv.x > 0.f
                  ? __fsub_rn(__fsub_rn(qv.x, c[nj][2 * h]), rc3[cc])
                  : 0.f;
          const float dy =
              hv.y > 0.f
                  ? __fsub_rn(__fsub_rn(qv.y, c[nj][2 * h + 1]), rc3[cc + 1])
                  : 0.f;
          const Split sx = split(dx), sy = split(dy);
          *reinterpret_cast<float2*>(dyh + r * LDT + cc) =
              make_float2(__uint_as_float(sx.hi), __uint_as_float(sy.hi));
          *reinterpret_cast<float2*>(dyl + r * LDT + cc) =
              make_float2(__uint_as_float(sx.lo), __uint_as_float(sy.lo));
        }
    }
    __syncthreads();
    if (threadIdx.x == 0 && i + 1 < count) fetch_q3(i + 1);

    {   // q2 = dy2 (gi2 W2^T) -> mq = [h1 > 0] q2, staged unpadded in H2
      float c[2][4];
      zero4(c[0]);
      zero4(c[1]);
#pragma unroll 2
      for (int kb = 0; kb < 8; ++kb) {
        const FragA a = frag_a_rows(DY, m0, kb, lane);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          mma3(c[nj], a,
               frag_b_paired(W2s, b_stride(CW), n0 + 8 * nj, kb, lane));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h, cc = n0 + 8 * nj + 2 * t;
          const uint32_t mk =
              *reinterpret_cast<const uint16_t*>(m1 + r * CW + cc);
          float2 o;
          o.x = (mk & 0xff) ? c[nj][2 * h] : 0.f;
          o.y = (mk >> 8) ? c[nj][2 * h + 1] : 0.f;
          *reinterpret_cast<float2*>(H2 + r * CW + cc) = o;
        }
    }
    fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) bulk_store(mq + r0 * CW, H2, TR * CW * 4);

    {   // A2 = dy2^T h1, G1 = h1^T h1, and the column sums (hi + lo)
      float ca[2][4], cg[2][4];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        zero4(ca[nj]);
        zero4(cg[nj]);
      }
#pragma unroll 2
      for (int kb = 0; kb < 8; ++kb) {
        const FragA ad = frag_a_cols(DY, m0, kb, lane);
        const FragA ah = frag_a_cols(H1, m0, kb, lane);
        if (nw == 0) {
          s0 += col_pair(ad, 0);
          s1 += col_pair(ad, 1);
        } else if (nw == 1) {
          s0 += col_pair(ah, 0);
          s1 += col_pair(ah, 1);
        }
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const FragB b = frag_b_rows(H1, n0 + 8 * nj, kb, lane);
          mma3(ca[nj], ad, b);
          mma3(cg[nj], ah, b);
        }
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          A2[nj][q] += ca[nj][q];
          G1[nj][q] += cg[nj][q];
        }
      cs[0] += s0;
      cs[1] += s1;
    }
    if (threadIdx.x == 0) bulk_store_drain();   // H2 is rewritten next
    __syncthreads();
  }

  double* pa = partA + (int64_t)blockIdx.x * CW * CW;
  double* pg = partG + (int64_t)blockIdx.x * CW * CW;
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const int r = m0 + g, cc = n0 + 8 * nj + 2 * t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = (r + 8 * (q >> 1)) * CW + cc + (q & 1);
      pa[o] = A2[nj][q];
      pg[o] = G1[nj][q];
    }
  }
  if (nw < 2) {
    const double a = sum_over_t(cs[0]), b = sum_over_t(cs[1]);
    if (t == 0) {
      double* out = (nw == 0 ? partu : partc) + (int64_t)blockIdx.x * CW;
      out[m0 + g] = a;
      out[m0 + g + 8] = b;
    }
  }
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
      sizeof(float) * (GP_STAGES * TR * CW + 2 * TILE_F +
                       2 * 32 * b_stride(C3W) + 2 * CW + 5 * C3W) +
      GP_STAGES * sizeof(uint64_t);
  const int upt = pool > TR ? pool / TR : 1;
  int lp = 0;
  while ((1 << lp) < pool && lp < 6) ++lp;      // log2(min(pool, TR))
  decltype(&fwd_gram_pool_kernel<0>) kern;
  switch (lp) {
    case 0: kern = fwd_gram_pool_kernel<0>; break;
    case 1: kern = fwd_gram_pool_kernel<1>; break;
    case 2: kern = fwd_gram_pool_kernel<2>; break;
    case 3: kern = fwd_gram_pool_kernel<3>; break;
    case 4: kern = fwd_gram_pool_kernel<4>; break;
    case 5: kern = fwd_gram_pool_kernel<5>; break;
    default: kern = fwd_gram_pool_kernel<6>; break;
  }
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<nblk, NTM, smem, static_cast<cudaStream_t>(stream)>>>(
      p2, R / TR, upt, vec2, W3, b3, partG, partc, mx, mn, imx, imn);
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
  const size_t smem =
      sizeof(float) * (2 * (TR * CW + C0MAX * TR) + TR * CW + 5 * TILE_F +
                       4 * 32 * b_stride(CW) + C0MAX * CW + 7 * CW) +
      TR * CW + 3 * sizeof(uint64_t);
  cudaError_t e = prepare(bwd_sweep2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_sweep2_kernel<<<nblk, NTM, smem,
                      static_cast<cudaStream_t>(stream)>>>(
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
