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
// Bounds on the card (R = 2,621,440 rows at the main path). layer12 is
// bound by f32 operations on CUDA cores (~23 GFLOP against 67 TFLOP/s).
// Its design: a persistent grid of blocks, each looping over 64-row tiles
// with the weights resident in shared memory and a register-tiled 64x64
// product (each of 256 threads owns a 4x4 output patch), row tiles staged
// in shared memory. sweep1 (B3a) is bound by bytes (it reads p2 and
// writes q3, 671 MB each; dy3 has one nonzero per (group, channel), so
// its products are taken sparsely): it streams tiles by TMA and builds q3
// from row bitmaps of each tile's entries (see there).
//
// gram_pool (B2b), sweep2 (B3b) and sweep3 (B3c) run their 64-wide
// products on tensor cores in 3xTF32 (sa_mma.cuh; f32-level accuracy).
// Their bounds there: gram_pool ~0.63 ms by operations (~97 GFLOP of
// products, three TF32 passes each at 495 TFLOP/s, plus its CUDA-core
// work), sweep2 ~0.61 ms by bytes (x, p2, q3 in and mq out: 784 B a row),
// sweep3 ~0.21 ms by bytes (x and mq in: 272 B a row); on CUDA cores in
// f32 they would be bound at 1.48, 1.18 and 0.38 ms. What holds them above
// that on mma.sync: each warp reads its A and B fragments from shared
// memory (hi and lo), ~640 KB per gram_pool tile against 128 B a clock,
// and the per-(group, column) pool and the ReLU/split passes are CUDA-core
// work between barriers that the products do not overlap. The designs
// keep what they can off that path: one TMA bulk copy per row tile,
// several tiles in flight; operands used by several warps (W3, M3, M2,
// gi2 * W2^T, h2 in gram_pool, h1 and dy2 in sweep2, h1 and dy1 in
// sweep3) split into hi/lo once; the pool reduced from the accumulators
// (no p3 tile in shared memory); sweep2's mq leaving by a TMA bulk store.
// The backward recomputes h1 in B3b and B3c with h1_tile's op chain
// (h1_rows in sa_mma.cuh), and 3xTF32 moves no ReLU mask: masks come from
// the CUDA-core chains only.
//
// The TPU grid runs in order and carries its accumulators across steps;
// CUDA blocks run in parallel, so every block writes its own partial sums
// (moments, Grams, A-matrices) to a (blocks, ...) float64 buffer and the
// caller reduces them in a fixed order — no float atomics, so runs are
// deterministic. Within a block each 64-row tile is summed in float32 and
// the tile sums are carried in float64 (except A3 in sweep 1, see there): a
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
//
// Bound by bytes (p2 in, q3 out); its own work is sparse (one 64-wide FMA
// row per live entry for A3 and one for q3), so what costs is the chain of
// short dependent steps between barriers: the design keeps them few and
// parallel. 512 threads, one block per SM;
// each tile's p2 rows, dpooled and idx arrive by three TMA bulk copies
// into a ring of up to four stages, and q3 leaves by a TMA bulk store
// from one of two staging tiles. A tile's entries e = (group, channel) are
// binned by argmax row as bitmaps: bit e % 32 of word (row, e / 32 % 8) is
// set when e's argmax is the row (match.any: one store per row present in
// a 32-entry word), so q3 row r is the sum over the set bits of its 8
// words, in entry order. One warp counts the rows and cuts them into
// tasks: a row of at most T = max(32, live entries / 16) entries is one
// task, a longer one eight (a word each), so the skew of random points
// (most channels on one padded row) is spread over the warps, which take
// the tasks round-robin, a lane per column pair; a split row is summed
// from its eight partials in word order. A3 takes a thread per (channel,
// 32 columns), reading its argmax row of h2 (formed once per tile into a
// padded tile) as eight 16-byte loads. Sums keep a fixed order: runs are
// bit-identical from one run to the next. A tile holds U rows:
// 64, or 8 pool for pool < 8, so it spans at most 8 pool groups (2,048
// entries).

constexpr int NWARP = NTM / 32;
constexpr int DEAD = 255;                 // entry key: no argmax row here
constexpr int MAX_SMEM = 232448;          // a block's shared memory, bytes
constexpr int SPLITS = 8 * NWARP;         // partial rows: <= 16 split rows
constexpr int LDH = CW + 4;               // h2 tile stride: rows 4 banks
                                          // apart for 16-byte loads

__host__ __device__ constexpr int sweep1_rows(int pool) {
  return pool >= 8 ? TR : 8 * pool;
}

// Byte offsets of sweep 1's shared memory for U rows, gpt pool groups and
// S stages a tile: S x [p2 (U, CW) | dpooled (gpt, C3W) | idx (gpt, C3W)],
// W3^T, two q3 tiles, the split rows' partials, mul2 | shift2 | gi3, h2
// (U, LDH), the row bitmaps (TR, 8) and tasks, a 32-entry list per warp,
// and each entry's key.
struct S1Layout {
  int w3t, out, part, vec, h2, bits, info, lists, key, bars, total;
};

__host__ __device__ inline S1Layout s1_layout(int U, int gpt, int S) {
  const int E = gpt * C3W;
  S1Layout l;
  l.w3t = S * (U * CW + 2 * E) * 4;
  l.out = l.w3t + C3W * CW * 4;
  l.part = l.out + 2 * TR * CW * 4;
  l.vec = l.part + SPLITS * CW * 4;
  l.h2 = l.vec + (2 * CW + C3W) * 4;
  l.bits = l.h2 + U * LDH * 4;
  l.info = l.bits + TR * 8 * 4;
  l.lists = l.info + (TR + 4) * 4;
  l.key = l.lists + NWARP * 32 * 8;
  l.bars = (l.key + E + 7) & ~7;
  l.total = l.bars + S * 8;
  return l;
}

// Inclusive sum over a warp's lanes.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

__device__ __forceinline__ void fma4(float* a, float s, const float4& w) {
  a[0] = fmaf(s, w.x, a[0]);
  a[1] = fmaf(s, w.y, a[1]);
  a[2] = fmaf(s, w.z, a[2]);
  a[3] = fmaf(s, w.w, a[3]);
}

// Word jw of row r's bitmap: rows 2l and 2l + 1 in four 16-byte blocks
// that lane l reads without bank conflicts.
__device__ __forceinline__ int bit_slot(int r, int jw) {
  return (r & 1) * 256 + (jw >> 2) * 128 + (r >> 1) * 4 + (jw & 3);
}

__device__ __forceinline__ uint4 ld4u(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ int popc4(const uint4& a) {
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
}

__global__ void __launch_bounds__(NTM, 1)
bwd_sweep1_kernel(const float* __restrict__ p2, int64_t ntiles, int U,
                  int pool, int S, const float* __restrict__ vec2,
                  const float* __restrict__ dpooled,
                  const int* __restrict__ idx, const float* __restrict__ gi3,
                  const float* __restrict__ W3, float* __restrict__ q3,
                  double* __restrict__ partA, double* __restrict__ partu) {
  extern __shared__ __align__(128) unsigned char smb[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Groups per tile (pool <= U) or tiles per group (pool > U = TR).
  const int gpt = pool <= U ? U / pool : 1;
  const int upt = pool > U ? pool / U : 1;
  const int gr = pool <= U ? pool : U;        // rows of a group in a tile
  const int E = gpt * C3W;                    // entries of a tile
  const int SF = U * CW + 2 * E;              // floats of one stage
  const S1Layout ly = s1_layout(U, gpt, S);
  float* stage = reinterpret_cast<float*>(smb);
  float* W3t = reinterpret_cast<float*>(smb + ly.w3t);   // W3t[c][j]
  float* outs = reinterpret_cast<float*>(smb + ly.out);
  float* part = reinterpret_cast<float*>(smb + ly.part);
  float* v = reinterpret_cast<float*>(smb + ly.vec);
  float* h2 = reinterpret_cast<float*>(smb + ly.h2);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smb + ly.bits);
  int* info = reinterpret_cast<int*>(smb + ly.info);
  float2* list = reinterpret_cast<float2*>(smb + ly.lists) + warp * 32;
  uint8_t* key = smb + ly.key;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smb + ly.bars);
  const float* gis = v + 2 * CW;
  const int io = NTM - 32;            // the thread that issues TMA copies

  const int64_t count =
      ntiles > blockIdx.x ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto tile_at = [&](int64_t i) { return blockIdx.x + i * gridDim.x; };
  auto fetch = [&](int64_t i, int s) {      // thread io: tile i to slot s
    float* st = stage + s * SF;
    const int64_t t = tile_at(i), g0 = upt > 1 ? t / upt : t * gpt;
    mbar_expect(&bars[s], SF * 4);
    bulk_load(st, p2 + t * U * CW, U * CW * 4, &bars[s]);
    bulk_load(st + U * CW, dpooled + g0 * C3W, E * 4, &bars[s]);
    bulk_load(st + U * CW + E, idx + g0 * C3W, E * 4, &bars[s]);
  };

  if (threadIdx.x == io) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s]);
    for (int i = 0; i < S && i < count; ++i) fetch(i, i);
  }
  for (int e = threadIdx.x; e < C3W * CW; e += NTM)
    W3t[(e % C3W) * CW + e / C3W] = W3[e];
  copy_block(v, vec2, 2 * CW);
  copy_block(v + 2 * CW, gi3, C3W);
  __syncthreads();

  // A3: thread (ac, ah) owns channel ac, columns 32 ah.. (and, for ah = 0,
  // the channel's u3). A3 is carried in f32 (at most one product per
  // channel and group, ~310 tiles a block at the main path): 32 float64
  // registers would spill at 512 threads.
  const int ac = threadIdx.x >> 1, ah = threadIdx.x & 1;
  float a3[32] = {};
  double u3 = 0.0;
  const int hc = (threadIdx.x % (CW / 4)) * 4;    // the h2 pass's columns
  const float4 mul = *reinterpret_cast<const float4*>(v + hc);
  const float4 sh = *reinterpret_cast<const float4*>(v + CW + hc);
  int s = 0;                          // this tile's stage
  uint32_t phase = 0;                 // and its mbarrier parity
  for (int64_t i = 0; i < count; ++i) {
    const int64_t t = tile_at(i);
    const int j = upt > 1 ? static_cast<int>(t % upt) : 0;
    const float* P = stage + s * SF;          // p2 (U, CW)
    const float* DP = P + U * CW;             // dpooled (gpt, C3W)
    const int* IX = reinterpret_cast<const int*>(DP + E);
    float* out = outs + (i & 1) * TR * CW;
    mbar_wait(&bars[s], phase);

    // 1. Each entry's tile row (key) or DEAD, and the row bitmaps, a warp
    // per 32-entry word (its group's rows cleared first, then one store
    // per row present); h2 = relu(p2 mul2 + shift2), padded.
    for (int w = warp; w < E / 32; w += NWARP) {
      const int e = 32 * w + lane, gi = e / C3W;
      const int rr = IX[e];
      const int lr = upt > 1 ? rr - j * U : gi * pool + rr;
      const int k = rr < pool && lr >= 0 && lr < U ? lr : DEAD;
      key[e] = static_cast<uint8_t>(k);
      for (int r = lane; r < gr; r += 32)
        bits[bit_slot(gi * gr + r, w & 7)] = 0u;
      const unsigned peers = __match_any_sync(FULL, k);
      __syncwarp();
      if (k != DEAD && lane == __ffs(peers) - 1)
        bits[bit_slot(k, w & 7)] = peers;
    }
    for (int q = threadIdx.x; q < U * CW / 4; q += NTM) {
      const int r = q / (CW / 4);
      float4 p = *reinterpret_cast<const float4*>(P + r * CW + hc);
      p.x = relu_affine(p.x, mul.x, sh.x);
      p.y = relu_affine(p.y, mul.y, sh.y);
      p.z = relu_affine(p.z, mul.z, sh.z);
      p.w = relu_affine(p.w, mul.w, sh.w);
      *reinterpret_cast<float4*>(h2 + r * LDH + hc) = p;
    }
    __syncthreads();

    // 2. The last warp counts the rows, the live total and the tasks (row
    // r of n_r entries is 0, 1 or, if n_r > T, 8 tasks; task and split
    // starts by one scan), kept per row as first task | first split << 16
    // | tasks << 24, and the task count. Every thread: A3 and u3 from the
    // argmax rows of h2.
    if (warp == NWARP - 1) {
      const int n0 = 2 * lane < U ? popc4(ld4u(bits + 4 * lane)) +
                                        popc4(ld4u(bits + 128 + 4 * lane))
                                  : 0;
      const int n1 = 2 * lane + 1 < U ? popc4(ld4u(bits + 256 + 4 * lane)) +
                                            popc4(ld4u(bits + 384 + 4 * lane))
                                      : 0;
      const int nlive = __reduce_add_sync(FULL, n0 + n1);
      const int T = max(32, (nlive + NWARP - 1) / NWARP);
      const int u0 = n0 == 0 ? 0 : n0 > T ? 8 : 1;
      const int u1 = n1 == 0 ? 0 : n1 > T ? 8 : 1;
      const int x0 = ((u0 == 8) << 16) | u0, x1 = ((u1 == 8) << 16) | u1;
      const int xs = warp_scan(x0 + x1, lane);    // splits high, tasks low
      *reinterpret_cast<int2*>(info + 2 * lane) =
          make_int2((xs - x0 - x1) | (u0 << 24), (xs - x1) | (u1 << 24));
      if (lane == 31) info[TR] = xs & 0xffff;
    }
    {
      float su = 0.f;
      for (int gi = 0; gi < gpt; ++gi) {
        const int e = gi * C3W + ac;
        const int k = key[e];
        if (k != DEAD) {
          const float dv = DP[e];
          const float* hr = h2 + k * LDH + 32 * ah;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            fma4(a3 + 4 * q, dv,
                 *reinterpret_cast<const float4*>(hr + 4 * q));
          su += dv;
        }
      }
      if (ah == 0) u3 += su;
    }
    if (threadIdx.x == io) bulk_store_drain_prior();   // out was read
    __syncthreads();

    // 3. q3 rows, task by task, task k to warp k % NWARP, a lane per
    // column pair (lane l holds the tasks of rows 2l, 2l + 1): the set
    // bits of the row's words (all 8, or the task's one for a split row),
    // in order. A whole row goes to out, a split row's word to its
    // partial.
    const int2 inf = *reinterpret_cast<const int2*>(info + 2 * lane);
    const int ta = inf.x & 0xffff, tb = inf.y & 0xffff;
    const int sa = (inf.x >> 16) & 0xff, sb = (inf.y >> 16) & 0xff;
    const int t0 = inf.x >> 24, t1 = inf.y >> 24;
    const int ntask = info[TR];
    for (int k = warp; k < ntask; k += NWARP) {
      const int L = 31 - __clz(__ballot_sync(FULL, ta <= k));
      const int ka = __shfl_sync(FULL, ta, L), kb = __shfl_sync(FULL, tb, L);
      const int ntb = __shfl_sync(FULL, t1, L);
      const int sl = __shfl_sync(FULL, k >= kb ? sb : sa, L);
      const bool hi = k >= kb;
      const int r = 2 * L + hi, tk = hi ? kb : ka;
      const bool split = (hi ? ntb : kb - ka) == 8;
      const int gb = upt > 1 ? 0 : (r / pool) * 8;   // the group's words
      const uint4 wa = ld4u(bits + bit_slot(r, 0));
      const uint4 wb = ld4u(bits + bit_slot(r, 4));
      const uint32_t wd[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int jw = 0; jw < 8; ++jw) {
        const uint32_t m = wd[jw];
        if (m == 0u || (split && jw != k - tk)) continue;
        // The word's entries, listed in order: (dpooled * gi3, channel).
        const int e = 32 * (gb + jw) + lane, c = e & (C3W - 1);
        if ((m >> lane) & 1u)
          list[__popc(m & ((1u << lane) - 1))] =
              make_float2(__fmul_rn(DP[e], gis[c]), __int_as_float(c));
        __syncwarp();
        const int n = __popc(m);
        int q = 0;
#pragma unroll 4
        for (; q + 1 < n; q += 2) {
          const float4 vc = *reinterpret_cast<const float4*>(list + q);
          const float2 w0 = ld2(W3t + __float_as_int(vc.y) * CW + 2 * lane);
          const float2 w1 = ld2(W3t + __float_as_int(vc.w) * CW + 2 * lane);
          acc.x = fmaf(vc.x, w0.x, acc.x);
          acc.y = fmaf(vc.x, w0.y, acc.y);
          acc.x = fmaf(vc.z, w1.x, acc.x);
          acc.y = fmaf(vc.z, w1.y, acc.y);
        }
        if (q < n) {
          const float2 vc = list[q];
          const float2 w = ld2(W3t + __float_as_int(vc.y) * CW + 2 * lane);
          acc.x = fmaf(vc.x, w.x, acc.x);
          acc.y = fmaf(vc.x, w.y, acc.y);
        }
        __syncwarp();
      }
      float* dst = split ? part + (sl * 8 + k - tk) * CW : out + r * CW;
      *reinterpret_cast<float2*>(dst + 2 * lane) = acc;
    }
    __syncthreads();
    if (threadIdx.x == io && i + S < count) fetch(i + S, s);

    // 4. Split rows: their eight partials summed in word order. Rows with
    // no entry: zeros.
    for (int r = warp; r < U; r += NWARP) {
      const int nt = __shfl_sync(FULL, (r & 1) ? t1 : t0, r >> 1);
      const int sl = __shfl_sync(FULL, (r & 1) ? sb : sa, r >> 1);
      if (nt == 1) continue;
      float2 acc = make_float2(0.f, 0.f);
      if (nt == 8) {
        const float* pr = part + sl * 8 * CW + 2 * lane;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float2 pv = ld2(pr + q * CW);
          acc.x += pv.x;
          acc.y += pv.y;
        }
      }
      *reinterpret_cast<float2*>(out + r * CW + 2 * lane) = acc;
    }
    fence_async_smem();
    __syncthreads();
    if (threadIdx.x == io) bulk_store(q3 + t * U * CW, out, U * CW * 4);
    if (++s == S) {
      s = 0;
      phase ^= 1u;
    }
  }
  if (threadIdx.x == io) bulk_store_drain();

  double* pa = partA + ((int64_t)blockIdx.x * C3W + ac) * CW + 32 * ah;
#pragma unroll
  for (int q = 0; q < 16; ++q)
    *reinterpret_cast<double2*>(pa + 2 * q) =
        make_double2(a3[2 * q], a3[2 * q + 1]);
  if (ah == 0) partu[(int64_t)blockIdx.x * C3W + ac] = u3;
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
                                            float* xs, int tid, int nth) {
  for (int e = tid; e < TR * C0; e += nth) {
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
      load_x_rows(x, C0, N, r0, X, threadIdx.x, NTM);
      __syncthreads();
    }
    relu_rows(S, mul2, shift2, H2);
    h1_rows(X, C0, W1s, v, h1h, h1l, m1, threadIdx.x, NTM);
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
//
// Tensor cores (sa_mma.cuh). The block's 16 warps form two groups of 8,
// each on every other tile of the block, with barriers of its own: one
// group's CUDA-core pass (h1 and its split) runs beside the other's
// products. In a group, warp w = (mw, nh) = (w % 4, w / 4) takes rows
// 16 mw.. and columns 32 nh.. of h1 M2 and forms dy1 there from the
// accumulators; then [A1 | u1] = dy1^T [x | 1 | 0] (64 x 8, one more small
// product) for the same rows and channels, its A fragments gathered from
// the accumulators by shuffles, so dy1 never leaves the registers and a
// tile takes two barriers. The eight (group, row quarter) partials are
// summed in order once, at the end. mq (one bulk copy) and x (one bulk
// copy per channel when N % TR == 0) arrive by TMA, four tiles in flight.
// M2 is split into hi/lo once per block; h1 (with its ReLU mask as bytes,
// from h1_rows' CUDA-core chain: the forward's masks bit for bit) and
// [x | 1] once per tile. Bound by bytes (x and mq in, 272 B a row). One
// block per SM (~200 KB of shared memory).
constexpr int S3_STAGES = 4;
constexpr int S3_GT = NTM / 2;      // threads of a warp group
constexpr int XLD = 68;             // [x | 1] tile stride: conflict-free B
constexpr int S3_GROUP = 2 * TILE_F + 2 * 8 * XLD + TR * CW / 4;  // floats

__global__ void __launch_bounds__(NTM, 1)
bwd_sweep3_kernel(const float* __restrict__ x, int C0, int64_t N,
                  int64_t ntiles, const float* __restrict__ W1,
                  const float* __restrict__ vec, const float* __restrict__ mq,
                  const float* __restrict__ M2, double* __restrict__ part) {
  constexpr int STAGE = TR * CW + C0MAX * TR;      // mq | x
  constexpr int WB = 32 * b_stride(CW);
  extern __shared__ __align__(128) float smt[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp >> 3, gt = threadIdx.x % S3_GT;
  float* stage = smt;                       // S3_STAGES x STAGE
  float* Mh = stage + S3_STAGES * STAGE;    // M2, split, paired layout
  float* Ml = Mh + WB;
  float* W1s = Ml + WB;                     // C0MAX * CW
  float* v = W1s + C0MAX * CW;              // 4 * CW
  float* gb = v + 4 * CW + grp * S3_GROUP;  // this group's:
  float* hh = gb;                           //   h1, split: hi
  float* hl = hh + TILE_F;                  //                lo
  float* Xh = hl + TILE_F;                  //   [x | 1 | 0], split (8, XLD)
  float* Xl = Xh + 8 * XLD;
  uint8_t* m1 = reinterpret_cast<uint8_t*>(Xl + 8 * XLD);  // TR * CW
  uint64_t* bars = reinterpret_cast<uint64_t*>(v + 4 * CW + 2 * S3_GROUP);
  const float* rc2 = v + 3 * CW;
  const SplitBuf H{hh, hl}, Ms{Mh, Ml};

  const int lw = warp & 7, g = lane >> 2, t = lane & 3;
  const int mw = lw & 3, nh = lw >> 2, m0 = 16 * mw;
  const bool xbulk =
      N % TR == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int64_t count =
      ntiles > blockIdx.x ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto row0 = [&](int64_t i) { return (blockIdx.x + i * gridDim.x) * TR; };
  auto fetch = [&](int64_t i) {             // one thread: mq and x of tile i
    const int s = static_cast<int>(i % S3_STAGES);
    float* S = stage + s * STAGE;
    const int64_t r0 = row0(i);
    mbar_expect(&bars[s], TR * CW * 4 + (xbulk ? C0 * TR * 4 : 0));
    bulk_load(S, mq + r0 * CW, TR * CW * 4, &bars[s]);
    if (xbulk) {
      const int64_t b = r0 / N, n = r0 - b * N;
      for (int c = 0; c < C0; ++c)
        bulk_load(S + TR * CW + c * TR, x + (b * C0 + c) * N + n, TR * 4,
                  &bars[s]);
    }
  };
  auto gsync = [&]() {                      // this group's barrier
    asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(S3_GT) : "memory");
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S3_STAGES; ++s) mbar_init(&bars[s]);
    for (int64_t i = 0; i < S3_STAGES && i < count; ++i) fetch(i);
  }
  load_b_split(Mh, Ml, M2, CW, CW, 1);
  copy_block(W1s, W1, C0 * CW);
  copy_block(v, vec, 4 * CW);
  __syncthreads();

  // [A1 | u1]: channels 32 nh + 16 mt + g (+8), columns 2t (+1) of [x | 1]
  double acc[2][4] = {};
  for (int64_t i = grp; i < count; i += 2) {
    const int s = static_cast<int>(i % S3_STAGES);
    const float* Q = stage + s * STAGE;
    float* X = stage + s * STAGE + TR * CW;
    mbar_wait(&bars[s], static_cast<uint32_t>((i / S3_STAGES) & 1));
    float2 qv[4][2];                    // this warp's mq, read early so
#pragma unroll                        // that the stage is free sooner
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        qv[nj][hf] = ld2(Q + (m0 + g + 8 * hf) * CW + 32 * nh + 8 * nj + 2 * t);
    if (!xbulk) {
      load_x_rows(x, C0, N, row0(i), X, gt, S3_GT);
      gsync();
    }
    h1_rows(X, C0, W1s, v, hh, hl, m1, gt, S3_GT);
    for (int e = gt; e < 8 * TR; e += S3_GT) {   // [x | 1 | 0], split
      const int c = e / TR, r = e % TR;
      const Split sp = split(c < C0 ? X[c * TR + r] : c == C0 ? 1.f : 0.f);
      Xh[c * XLD + r] = __uint_as_float(sp.hi);
      Xl[c * XLD + r] = __uint_as_float(sp.lo);
    }
    gsync();
    if (gt == 0 && i + S3_STAGES < count) fetch(i + S3_STAGES);

    // h1 M2 for the warp's rows 16 mw.. and columns 32 nh..
    float c[4][4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) zero4(c[nj]);
#pragma unroll 2
    for (int kb = 0; kb < 8; ++kb) {
      const FragA a = frag_a_rows(H, m0, kb, lane);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        mma3(c[nj], a,
             frag_b_paired(Ms, b_stride(CW), 32 * nh + 8 * nj, kb, lane));
    }
    // dy1 = [h1 > 0] (mq - (h1 M2 + rc2)), in the accumulators' places
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + g + 8 * hf, cc = 32 * nh + 8 * nj + 2 * t;
        const uint32_t mk =
            *reinterpret_cast<const uint16_t*>(m1 + r * CW + cc);
        const float2 q = qv[nj][hf];
        float* cv = c[nj] + 2 * hf;
        cv[0] = (mk & 0xff) ? __fsub_rn(q.x, __fadd_rn(cv[0], rc2[cc])) : 0.f;
        cv[1] = (mk >> 8) ? __fsub_rn(q.y, __fadd_rn(cv[1], rc2[cc + 1]))
                          : 0.f;
      }
    // [A1 | u1] += dy1^T [x | 1] over the warp's 16 rows, for its 32
    // channels (two 16-channel tiles mt): the A fragment (channel g (+8),
    // row t (+4) of a k step) is gathered from the lanes holding those
    // rows (t, t + 4) and channels (g) by shuffles.
    {
      const int src = 4 * t + (g >> 1), odd = g & 1;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float d[4];
        zero4(d);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          float av[4];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const float* cf = c[2 * mt + (f & 1)];
            const int sl = src + 16 * (f >> 1);
            const float ev = __shfl_sync(FULL, cf[2 * ks], sl);
            const float ov = __shfl_sync(FULL, cf[2 * ks + 1], sl);
            av[f] = odd ? ov : ev;
          }
          const int k = g * XLD + m0 + 8 * ks + t;
          const FragB b{{Split{__float_as_uint(Xh[k]), __float_as_uint(Xl[k])},
                         Split{__float_as_uint(Xh[k + 4]),
                               __float_as_uint(Xl[k + 4])}}};
          mma3(d, FragA{{split(av[0]), split(av[1]), split(av[2]),
                         split(av[3])}},
               b);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][q] += d[q];
      }
    }
    gsync();                                  // h1 and [x | 1] read
  }

  // The eight (group, row quarter) partials summed in order: staged in the
  // (idle) stage area, then one thread per output.
  __syncthreads();
  double* red = reinterpret_cast<double*>(smt);    // (8, CW, 8)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      red[((4 * grp + mw) * CW + 32 * nh + 16 * mt + g + 8 * (q >> 1)) * 8 +
          2 * t + (q & 1)] = acc[mt][q];
  __syncthreads();
  const int ne = CW * (C0 + 1);
  for (int e = threadIdx.x; e < ne; e += NTM) {
    const int j = e / (C0 + 1), col = e % (C0 + 1);
    double sum = 0.0;
    for (int w = 0; w < 8; ++w) sum += red[(w * CW + j) * 8 + col];
    part[(int64_t)blockIdx.x * ne + e] = sum;
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
  const int U = sweep1_rows(pool);
  const int gpt = pool <= U ? U / pool : 1;
  int S = 4;                          // stages: as many as fit, up to 4
  while (S > 0 && s1_layout(U, gpt, S).total > MAX_SMEM) --S;
  if (S == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = s1_layout(U, gpt, S).total;
  cudaError_t e = prepare(bwd_sweep1_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_sweep1_kernel<<<nblk, NTM, smem, static_cast<cudaStream_t>(stream)>>>(
      p2, R / U, U, pool, S, vec2, dpooled, idx, gi3, W3, q3, partA, partu);
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
  const size_t smem =
      sizeof(float) * (S3_STAGES * (TR * CW + C0MAX * TR) +
                       2 * 32 * b_stride(CW) + C0MAX * CW + 4 * CW +
                       2 * S3_GROUP) +
      S3_STAGES * sizeof(uint64_t);
  cudaError_t e = prepare(bwd_sweep3_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_sweep3_kernel<<<nblk, NTM, smem, static_cast<cudaStream_t>(stream)>>>(
      x, C0, N, R / TR, W1, vec, mq, M2, part);
  return static_cast<int>(cudaGetLastError());
}
