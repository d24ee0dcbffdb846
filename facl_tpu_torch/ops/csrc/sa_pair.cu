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
// Bounds on the card (R = 2,621,440 rows at the main path). sweep1 (B3a)
// is bound by bytes (it reads p2 and writes q3, 671 MB each; dy3 has one
// nonzero per (group, channel), so its products are taken sparsely): it
// streams tiles by TMA and builds q3 from row bitmaps of each tile's
// entries (see there).
//
// layer12 (B2a; in 6xTF32, see there), gram_pool (B2b), sweep2 (B3b) and
// sweep3 (B3c) run their 64-wide products on tensor cores in 3xTF32
// (sa_mma.cuh; f32-level accuracy). Their bounds there: layer12 ~0.30 ms
// by operations (x in, p2 out: 272 B a row, 0.21 ms), gram_pool ~0.63 ms
// by operations (~97 GFLOP of products, three TF32 passes each at 495
// TFLOP/s, plus its CUDA-core work), sweep2 ~0.61 ms by bytes (x, p2, q3
// in and mq out: 784 B a row), sweep3 ~0.21 ms by bytes (x and mq in: 272
// B a row); on CUDA cores in f32 they would be bound at 0.36, 1.48, 1.18
// and 0.38 ms. What holds them above that on mma.sync: each warp reads
// its A and B fragments from shared memory (hi and lo), ~640 KB per
// gram_pool tile against 128 B a clock, and the per-(group, column) pool
// and the ReLU/split passes are CUDA-core work between barriers that the
// products do not overlap. The designs keep what they can off that path:
// one TMA bulk copy per row tile, several tiles in flight; operands used
// by several warps (W3, M3, M2, gi2 * W2^T, h2 in gram_pool, h1 and dy2 in
// sweep2, h1 and dy1 in sweep3) split into hi/lo once; the pool reduced
// from the accumulators (no p3 tile in shared memory); sweep2's mq leaving
// by a TMA bulk store; layer12's h1 made in registers as its A fragments.
// layer12 computes h1, and B3b and B3c recompute it, with h1_tile's op
// chain (h1_pair and h1_rows in sa_mma.cuh), and the split products move
// no ReLU mask: masks come from the CUDA-core chains only.
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
// Each sweep has an f32 entry point (facl_sa_*) and a bf16 one
// (facl_sa_*_bf16, compute_dtype bfloat16): x, p2, q3, mq and B2b's
// max/min stored as bf16, results rounded to bf16 at the TPU kernels'
// cast points (the bf16 twins in ops/sa_pair.py). The f32 kernels come
// first (fwd_layer12_kernel, fwd_gram_pool_kernel<LP>, bwd_sweep1_kernel,
// bwd_sweep2_kernel, bwd_sweep3_kernel); the five bf16 sweeps are kernels
// of their own below them (fwd_layer12_bf16_kernel<XC>,
// fwd_gram_pool_bf16_kernel<LP>, bwd_sweep2_bf16_kernel,
// bwd_sweep1_bf16_kernel, bwd_sweep3_bf16_kernel): bf16 operands, products
// on bf16 tensor cores (mma.sync m16n8k16, B3a's dense one as wgmma).
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
// x rows r0.. of a tile, channel-major: xs[c * TR + i] = x[b, c, n] for
// row r0 + i = b*N + n, by threads tid of nth (where a tile crosses a
// cloud boundary, or x is not staged by TMA).
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

// ---------------------------------------------------------------------
// B2 sweep A: x -> p1 -> h1 -> p2 = h1 W2 + b2, plus per-block sums of p2
// and p2^2. part: (blocks, 2, 64) float64 = [sum p2 | sum p2^2].
//
// p2 feeds the layer-2 ReLU decisions (h2 = relu(p2 mul2 + shift2)) of
// every later sweep, so its error decides which rows sit on which side of
// zero, and a padded row (the centroid repeated, most rows of random
// clouds) repeats each decision up to K times. 3xTF32, as the other sweeps
// run their products, is f32-accurate on average but up to ~4x off an f32
// product (its pieces are not exact, and the tensor cores' accumulation
// truncates): on the main path's clouds it flipped a padded row's
// decision that float64 and f32 keep, 125 rows at once (chip_ablate.py
// precision). So h1 W2 runs in 6xTF32 (sa_mma.cuh): h1 and W2 split
// exactly into three TF32 pieces, six products down to 2^-22 of each
// term, each 8-wide k step summed apart and added to the accumulators in
// f32 with rounding: more accurate than an f32 product.
//
// Bound on the card at the main path: 0.30 ms by operations (the six
// passes, 129 GFLOP of TF32 at 495 TFLOP/s, and ~2.7 GFLOP on CUDA cores
// at 67); bytes alone (x in, p2 out: 272 B a row) would take 0.21 ms. A
// tile-per-block design is held back by shared memory (an h1 tile
// written, split, and read back as fragments by every warp next to W2's)
// and by block barriers between those phases. So h1 never touches shared
// memory: each warp computes the h1 values of its own A fragments in
// registers with h1_tile's op chain (h1_pair in sa_mma.cuh; B3b, B3c and
// B6 recompute h1 with the same chain, so the ReLU masks agree bit for
// bit) and splits them; W2's three pieces are split once per block. The
// warps are independent: warp w of the block walks its own 64-row tiles
// as four 16-row slices (16 x 64 of p2 in its accumulators), its x tile
// arriving by TMA (one bulk copy per channel when N % TR == 0) into its
// own two stages, one tile ahead; where a tile crosses a cloud boundary
// the warp reads its rows itself. No barrier runs in the loop. b2 is
// added in the accumulators, and p2 leaves from them as 8-byte stores
// that fill whole 32-byte sectors (no staging tile: it would cost shared
// memory traffic and a barrier for the one copy). The sums of p2 and
// p2^2 are reduced from the accumulators by shuffles that leave each lane
// two columns' pairs (summed in f32 within a tile, carried in float64),
// and the 16 warps' partials are summed in order at the end. 512 threads,
// one block per SM; 128 registers with 8 bytes of spill (the k loop
// unrolled by 2: rolled, it spills none and runs ~5% slower).
constexpr int L12_WARPS = NTM / 32;

// One step of a sum over lanes that halves what each lane keeps: the lane
// with bit m set keeps hi (plus its partner's), the other lo.
__device__ __forceinline__ void halve(float& lo, float& hi, int lane, int m) {
  const bool up = lane & m;
  const float send = up ? lo : hi;
  lo = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, m);
}

__global__ void __launch_bounds__(NTM, 1)
fwd_layer12_kernel(const float* __restrict__ x, int C0, int64_t N,
                   int64_t ntiles, const float* __restrict__ W1,
                   const float* __restrict__ vec1, const float* __restrict__ W2,
                   const float* __restrict__ b2, float* __restrict__ p2,
                   double* __restrict__ part) {
  constexpr int STAGE = C0MAX * TR;
  constexpr int WB = 32 * b_stride(CW);
  extern __shared__ __align__(128) float smt[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* const Wp[3] = {smt, smt + WB, smt + 2 * WB};  // W2 in 3 pieces
  float* W1s = smt + 3 * WB;                    // C0MAX * CW
  float* v = W1s + C0MAX * CW;                  // b1 | mul1 | shift1 | b2
  float* stage = v + 4 * CW + warp * 2 * STAGE;   // this warp's two x tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       v + 4 * CW + L12_WARPS * 2 * STAGE) + 2 * warp;
  const bool xbulk = N % TR == 0;     // x is 16-byte aligned (the wrapper)
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * L12_WARPS + warp;
  const int64_t nw = static_cast<int64_t>(gridDim.x) * L12_WARPS;
  const int64_t count = ntiles > gw ? (ntiles - 1 - gw) / nw + 1 : 0;
  auto fetch = [&](int64_t i) {             // lane 0: x of the warp's tile i
    const int64_t r0 = (gw + i * nw) * TR, b = r0 / N, n = r0 - b * N;
    uint64_t* bar = &bars[i & 1];
    mbar_expect(bar, C0 * TR * sizeof(float));
    for (int c = 0; c < C0; ++c)
      bulk_load(stage + (i & 1) * STAGE + c * TR, x + (b * C0 + c) * N + n,
                TR * sizeof(float), bar);
  };

  if (lane == 0 && xbulk) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    for (int64_t i = 0; i < 2 && i < count; ++i) fetch(i);
  }
  load_b_split3(Wp, W2, CW, CW, 1);
  copy_block(W1s, W1, C0 * CW);
  copy_block(v, vec1, 3 * CW);
  copy_block(v + 3 * CW, b2, CW);
  __syncthreads();

  // Sums of p2 and p2^2 of columns 8 g + 2 t (+1): [s, ss, s', ss'].
  double run[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t i = 0; i < count; ++i) {
    const int64_t r0 = (gw + i * nw) * TR;
    const float* X = stage + (i & 1) * STAGE;
    if (xbulk) {
      mbar_wait(&bars[i & 1], static_cast<uint32_t>((i >> 1) & 1));
    } else {
      __syncwarp();
      load_x_rows(x, C0, N, r0, stage + (i & 1) * STAGE, lane, 32);
      __syncwarp();
    }
    float tile[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sl = 0; sl < TR / 16; ++sl) {
      const int ra = 16 * sl + g;           // the lane's rows ra, ra + 8
      float xa[C0MAX - 1], xb[C0MAX - 1];
#pragma unroll
      for (int k = 0; k < C0MAX - 1; ++k)
        if (k < C0) {
          xa[k] = X[k * TR + ra];
          xb[k] = X[k * TR + ra + 8];
        }
      if (sl == TR / 16 - 1) {              // the stage is read: refill
        __syncwarp();
        if (lane == 0 && xbulk && i + 2 < count) fetch(i + 2);
      }
      // h1 W2 for rows ra, ra + 8 (and the slice's others) and all 64
      // columns: the A fragment of step kb is h1 at columns 8 kb + 2t
      // (+1), made here.
      float c[8][4];
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) zero4(c[nj]);
#pragma unroll 2
      for (int kb = 0; kb < 8; ++kb) {
        const int col = 8 * kb + 2 * t;
        float2 ha, hb;
        h1_pair(xa, xb, C0, W1s, v, col, ha, hb);
        const Split3 s[4] = {split3(ha.x), split3(hb.x), split3(ha.y),
                             split3(hb.y)};
        FragA3 a;
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) a.v[q][r] = s[r].v[q];
        // Each step's six products summed apart, then added in f32 with
        // rounding (the tensor cores' own accumulation truncates).
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          float d[4];
          zero4(d);
          mma6(d, a, frag_b3_paired(Wp, b_stride(CW), 8 * nj, kb, lane));
#pragma unroll
          for (int r = 0; r < 4; ++r) c[nj][r] = __fadd_rn(c[nj][r], d[r]);
        }
      }
      // p2 = acc + b2 -> global (rows ra, ra + 8); per column j of the
      // lane, its two rows summed: vs[2 j] (p2), vs[2 j + 1] (p2^2).
      float* out = p2 + (r0 + ra) * CW + 2 * t;
      float vs[32];
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const float2 bb = ld2(v + 3 * CW + 8 * nj + 2 * t);
        const float2 u = make_float2(__fadd_rn(c[nj][0], bb.x),
                                     __fadd_rn(c[nj][1], bb.y));
        const float2 w = make_float2(__fadd_rn(c[nj][2], bb.x),
                                     __fadd_rn(c[nj][3], bb.y));
        st2r(out + 8 * nj, u);
        st2r(out + 8 * CW + 8 * nj, w);
        vs[4 * nj] = u.x + w.x;
        vs[4 * nj + 1] = fmaf(u.x, u.x, w.x * w.x);
        vs[4 * nj + 2] = u.y + w.y;
        vs[4 * nj + 3] = fmaf(u.y, u.y, w.y * w.y);
      }
      // Over the eight g lanes: each exchange halves the values a lane
      // keeps, so lane (g, t) ends with n-tile g's: vs[0..3].
#pragma unroll
      for (int q = 0; q < 16; ++q) halve(vs[q], vs[16 + q], lane, 16);
#pragma unroll
      for (int q = 0; q < 8; ++q) halve(vs[q], vs[8 + q], lane, 8);
#pragma unroll
      for (int q = 0; q < 4; ++q) halve(vs[q], vs[4 + q], lane, 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) tile[q] += vs[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) run[q] += tile[q];
  }

  // The 16 warps' partials summed in order: staged in the (idle) stage
  // area, then one thread per output.
  __syncthreads();
  double* red = reinterpret_cast<double*>(v + 4 * CW);   // (warps, 2, CW)
  const int col = 8 * g + 2 * t;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    red[(warp * 2 + (q & 1)) * CW + col + (q >> 1)] = run[q];
  __syncthreads();
  if (threadIdx.x < 2 * CW) {
    const int q = threadIdx.x / CW, cl = threadIdx.x % CW;
    double a = 0.0;
    for (int w = 0; w < L12_WARPS; ++w) a += red[(w * 2 + q) * CW + cl];
    part[(int64_t)blockIdx.x * 2 * CW + threadIdx.x] = a;
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
  float* Hh = smt + GP_STAGES * TR * CW;      // h2, split: hi
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
    mbar_expect(bar, TR * CW * sizeof(float));
    bulk_load(stage + (i % GP_STAGES) * TR * CW, p2 + tile_at(i) * TR * CW,
              TR * CW * sizeof(float), bar);
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
  int stage, w3t, out, part, vec, h2, bits, info, lists, key, bars, total;
};

__host__ __device__ inline S1Layout s1_layout(int U, int gpt, int S) {
  const int E = gpt * C3W;
  S1Layout l;
  l.stage = (U * CW + E) * 4 + E * 4;
  l.w3t = S * l.stage;
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
  const S1Layout ly = s1_layout(U, gpt, S);
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
    float* st = reinterpret_cast<float*>(smb + s * ly.stage);
    const int64_t t = tile_at(i), g0 = upt > 1 ? t / upt : t * gpt;
    mbar_expect(&bars[s], ly.stage);
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
    const float* P = reinterpret_cast<const float*>(smb + s * ly.stage);
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
      if (split)
        st2r(part + (sl * 8 + k - tk) * CW + 2 * lane, acc);
      else
        st2r(out + r * CW + 2 * lane, acc);
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
      st2r(out + r * CW + 2 * lane, acc);
    }
    fence_async_smem();
    __syncthreads();
    if (threadIdx.x == io)
      bulk_store(q3 + t * U * CW, out, U * CW * 4);
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
__global__ void __launch_bounds__(NTM, 1)
bwd_sweep2_kernel(const float* __restrict__ x, int C0, int64_t N,
                  int64_t ntiles, const float* __restrict__ W1,
                  const float* __restrict__ vec, const float* __restrict__ p2,
                  const float* __restrict__ q3, const float* __restrict__ M3,
                  const float* __restrict__ W2, float* __restrict__ mq,
                  double* __restrict__ partA, double* __restrict__ partG,
                  double* __restrict__ partu, double* __restrict__ partc) {
  constexpr int STAGE = TR * CW + C0MAX * TR;      // p2 | x
  constexpr int WB = 32 * b_stride(CW);            // a 64x64 paired B
  extern __shared__ __align__(128) float smt[];
  float* stage = smt;                       // 2 x STAGE, as TMA lands them
  float* Q = stage + 2 * STAGE;             // q3 (TR, CW), by TMA
  float* H2 = stage + 2 * STAGE + TR * CW;  // (TR, LDT): h2; then mq
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
  constexpr uint32_t ES = sizeof(float);
  auto fetch = [&](int64_t i) {             // thread 0: p2 and x of tile i
    uint64_t* bar = &bars[i & 1];
    float* S = stage + (i & 1) * STAGE;
    const int64_t r0 = row0(i);
    mbar_expect(bar, TR * CW * ES + (xbulk ? C0 * TR * ES : 0));
    bulk_load(S, p2 + r0 * CW, TR * CW * ES, bar);
    if (xbulk) {
      const int64_t b = r0 / N, n = r0 - b * N;
      for (int c = 0; c < C0; ++c)
        bulk_load(S + TR * CW + c * TR, x + (b * C0 + c) * N + n, TR * ES,
                  bar);
    }
  };
  auto fetch_q3 = [&](int64_t i) {        // thread 0: q3 of tile i
    mbar_expect(&bars[2], TR * CW * ES);
    bulk_load(Q, q3 + row0(i) * CW, TR * CW * ES, &bars[2]);
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
              hv.x > 0.f ? __fsub_rn(__fsub_rn(qv.x, c[nj][2 * h]), rc3[cc])
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
      float* M = H2;
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
          st2r(M + r * CW + cc, o);
        }
    }
    fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) bulk_store(mq + r0 * CW, H2, TR * CW * ES);

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
  constexpr uint32_t ES = sizeof(float);
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
    mbar_expect(&bars[s], TR * CW * ES + (xbulk ? C0 * TR * ES : 0));
    bulk_load(S, mq + r0 * CW, TR * CW * ES, &bars[s]);
    if (xbulk) {
      const int64_t b = r0 / N, n = r0 - b * N;
      for (int c = 0; c < C0; ++c)
        bulk_load(S + TR * CW + c * TR, x + (b * C0 + c) * N + n, TR * ES,
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
        qv[nj][hf] =
            ld2(Q + (m0 + g + 8 * hf) * CW + 32 * nh + 8 * nj + 2 * t);
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
        cv[1] =
            (mk >> 8) ? __fsub_rn(q.y, __fadd_rn(cv[1], rc2[cc + 1])) : 0.f;
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

// =====================================================================
// The bf16 forms of B2a, B2b, B3a, B3b and B3c: kernels of their own,
// built for Hopper's bf16 tensor cores (sa_mma.cuh, "bf16 tensor cores").
// Every operand a product reads is bf16 in shared memory (padded (rows,
// LDB) tiles, fragments by ldmatrix; B3a's wgmma operands in core-matrix
// tiles) or in registers (B2a's and B3c's h1, made there as A
// fragments), and every product runs as mma.sync m16n8k16 bf16 (B3a:
// wgmma m64n64k16) with f32 accumulation; no TF32 pass and no hi/lo
// split. One block per SM. Per-block partials in float64, summed in a
// fixed order: runs are bit-identical.

// ---------------------------------------------------------------------
// B2 sweep A at bf16 (facl_sa_fwd_layer12_bf16). Replaces
// facl_tpu/ops/pallas/sa_pair.py::_make_pair_layer12_kernel (:121,
// pallas_call :634) at compute_dtype bfloat16: p1 = bf16(x bf16(W1)) +
// bf16(b1) summed in f32, h1 = relu(bf16(p1 mul1 + shift1)), p2 =
// bf16(h1 bf16(W2)) + bf16(b2) summed in f32 and stored as bf16; per
// block the sums of p2 and p2^2, taken before that rounding (the twin:
// ops/sa_pair.py::sa_fwd_layer12_bf16_plain). part: (blocks, 2, 64)
// float64 = [sum p2 | sum p2^2].
//
// Bound on the card at the main path (R = 2,621,440 rows): 0.106 ms by
// bytes (x in, p2 out: 136 B a row). The products are 21.5 GFLOP (0.022
// ms at the bf16 rate), but h1's chain, about a dozen CUDA-core
// instructions a value for 168 M values, is work of the same order as the
// byte stream: the design gives the CUDA cores' instruction slots to it
// and lets the memory traffic run beside it. The form this replaces (the f32 design
// at bf16) ran each 8-wide k step as a TF32 product into zeroed registers
// added with rounding (as many FADDs as h1 has instructions), reread W2
// as f32 fragments, stored p2 in 4-byte pieces and spilled. Here each of
// the 16 warps walks its own 32-row steps, two 16-row slices at once,
// with no block barrier in the loop:
//  - x (channel-major) arrives by cp.async in 16-byte pieces of 8 rows
//    into the warp's own four stages, three steps in flight (read row by
//    row where a cloud's length is not a multiple of 8);
//  - h1 is made in registers as the A fragments of mma.sync m16n8k16 (C
//    of two n-tiles is A of a k16 step) by h1_pre_bf16's chain, four rows
//    at a time, so that a column pair's parameters (a record of bf16(W1)'s
//    rows, bf16(b1), mul1 and shift1, read by 16-byte loads) serve four
//    rows; its ReLU is a 16-bit integer max on the packed pair (relu_packed's
//    values but at a NaN: a half <= 0, or -0, becomes +0);
//  - h1 bf16(W2) accumulates in place in f32 over four k16 steps,
//    bf16(W2)'s B fragments by ldmatrix from a padded tile, each serving
//    both slices;
//  - p2 = bf16(acc) + bf16(b2) (rounded two values at a time) is staged
//    by stmatrix in the warp's padded tile and leaves in 16-byte stores,
//    four whole rows a warp instruction;
//  - the sums of p2 and p2^2 are taken over the lane's four rows, then
//    over the eight g lanes by shuffles that halve what each lane keeps
//    (f32 within a step), carried in float64 across steps; the 16 warps'
//    partials are added in order at the end, so runs are bit-identical.
// XC (4 or 7) bounds C0, so that the main path's C0 = 4 keeps 16 x values
// in registers. 512 threads, one block per SM, 116 KB of shared memory.
constexpr int L12B_NT = 512;
constexpr int L12B_WARPS = L12B_NT / 32;
constexpr int L12B_ROWS = 32;                   // rows of a warp's step
constexpr int L12B_STAGES = 4;                  // x stages of a warp
constexpr int L12B_XS = C0MAX * L12B_ROWS;      // bf16 values of an x stage
// A column pair's parameters (floats): bf16(W1)'s row k at 2 k (zero at
// k >= C0), bf16(b1) at 16, mul1 at 18, shift1 at 20.
constexpr int L12B_PP = 24;

// h1_pre_bf16's chain, then the ReLU, for NR rows (x values xr[r]) at the
// column pair of parameter record P: h[r] the packed pair of row r. The
// first product starts the sum where h1_pre_bf16 adds it to +0: the two
// differ only in the sign of a zero sum, which the ReLU makes +0 either
// way.
template <int NR, int XC>
__device__ __forceinline__ void h1_bf16_rows(const float (&xr)[NR][XC],
                                             int C0, const float* P,
                                             uint32_t (&h)[NR]) {
  float2 a[NR];
  const float4 w0 = *reinterpret_cast<const float4*>(P);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    a[r] = make_float2(__fmul_rn(xr[r][0], w0.x), __fmul_rn(xr[r][0], w0.y));
    if (C0 > 1) {
      a[r].x = __fadd_rn(a[r].x, __fmul_rn(xr[r][1], w0.z));
      a[r].y = __fadd_rn(a[r].y, __fmul_rn(xr[r][1], w0.w));
    }
  }
#pragma unroll
  for (int k = 2; k < XC; k += 2) {
    if (k >= C0) break;
    const float4 w = *reinterpret_cast<const float4*>(P + 2 * k);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      a[r].x = __fadd_rn(a[r].x, __fmul_rn(xr[r][k], w.x));
      a[r].y = __fadd_rn(a[r].y, __fmul_rn(xr[r][k], w.y));
      if (k + 1 < XC && k + 1 < C0) {
        a[r].x = __fadd_rn(a[r].x, __fmul_rn(xr[r][k + 1], w.z));
        a[r].y = __fadd_rn(a[r].y, __fmul_rn(xr[r][k + 1], w.w));
      }
    }
  }
  const float4 bm = *reinterpret_cast<const float4*>(P + 2 * C0MAX);
  const float2 sh = *reinterpret_cast<const float2*>(P + 2 * C0MAX + 4);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float2 ra = unpack_bf16(pack_bf16(a[r].x, a[r].y));
    h[r] = __vmaxs2(
        pack_bf16(__fadd_rn(__fmul_rn(__fadd_rn(ra.x, bm.x), bm.z), sh.x),
                  __fadd_rn(__fmul_rn(__fadd_rn(ra.y, bm.y), bm.w), sh.y)),
        0u);
  }
}

template <int XC>
__global__ void __launch_bounds__(L12B_NT, 1)
fwd_layer12_bf16_kernel(const __nv_bfloat16* __restrict__ x, int C0,
                        int64_t N, int64_t R, const float* __restrict__ W1,
                        const float* __restrict__ vec1,
                        const float* __restrict__ W2,
                        const float* __restrict__ b2,
                        __nv_bfloat16* __restrict__ p2,
                        double* __restrict__ part) {
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smb[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf* Ws = reinterpret_cast<bf*>(smb);                  // bf16(W2) [k][n]
  bf* stg = Ws + CW * LDB + warp * L12B_ROWS * LDB;     // the warp's p2 rows
  bf* xst = Ws + CW * LDB + L12B_WARPS * L12B_ROWS * LDB +
            warp * L12B_STAGES * L12B_XS;               // and x stages
  float* prm = reinterpret_cast<float*>(
      Ws + CW * LDB + L12B_WARPS * (L12B_ROWS * LDB + L12B_STAGES * L12B_XS));
  float* b2s = prm + CW / 2 * L12B_PP;                  // bf16(b2)
  // The warp's 32-row steps, strided over all warps of the grid.
  const int64_t nsteps = R / L12B_ROWS;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * L12B_WARPS + warp;
  const int64_t nw = static_cast<int64_t>(gridDim.x) * L12B_WARPS;
  const int64_t count = nsteps > gw ? (nsteps - 1 - gw) / nw + 1 : 0;
  // x in 16-byte copies of 8 rows (one cloud: N % 8 == 0), else by loads.
  const bool xvec = N % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto fetch = [&](int64_t i) {     // the warp's copies of its step i
    if (i < count) {
      bf* X = xst + (i % L12B_STAGES) * L12B_XS;    // (C0MAX, 32) channel-major
      const int64_t r0 = (gw + i * nw) * L12B_ROWS;
      if (xvec) {
        for (int e = lane; e < C0 * (L12B_ROWS / 8); e += 32) {
          const int c = e / (L12B_ROWS / 8), h = e % (L12B_ROWS / 8);
          const int64_t r = r0 + 8 * h, b = r / N, n = r - b * N;
          cp_async16(X + c * L12B_ROWS + 8 * h, x + (b * C0 + c) * N + n);
        }
      } else {
        for (int e = lane; e < C0 * L12B_ROWS; e += 32) {
          const int c = e / L12B_ROWS, j = e % L12B_ROWS;
          const int64_t r = r0 + j, b = r / N, n = r - b * N;
          X[c * L12B_ROWS + j] = x[(b * C0 + c) * N + n];
        }
      }
    }
    cp_async_commit();
  };

  for (int i = 0; i < L12B_STAGES - 1; ++i) fetch(i);
  for (int e = threadIdx.x; e < CW * CW; e += L12B_NT)
    Ws[(e >> 6) * LDB + (e & 63)] = __float2bfloat16_rn(W2[e]);
  for (int e = threadIdx.x; e < CW / 2 * L12B_PP; e += L12B_NT) {
    const int q = e % L12B_PP, col = 2 * (e / L12B_PP) + (q & 1);
    const int k = q >> 1;     // a row of W1; C0MAX: b1, +1 mul1, +2 shift1
    float val = 0.f;
    if (k < C0)
      val = rb(W1[k * CW + col]);
    else if (k == C0MAX)
      val = rb(vec1[col]);
    else if (k > C0MAX && k <= C0MAX + 2)
      val = vec1[(k - C0MAX) * CW + col];
    prm[e] = val;
  }
  for (int e = threadIdx.x; e < CW; e += L12B_NT) b2s[e] = rb(b2[e]);
  __syncthreads();

  // Sums of p2 and p2^2 of columns 8 g + 2 t (+1): [s, ss, s', ss'].
  double run[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t i = 0; i < count; ++i) {
    cp_async_wait<L12B_STAGES - 2>();
    __syncwarp();
    fetch(i + L12B_STAGES - 1);
    const bf* X = xst + (i % L12B_STAGES) * L12B_XS;
    const int64_t r0 = (gw + i * nw) * L12B_ROWS;
    // The lane's rows 8 r + g: g, g + 8 of slice 0 (r = 0, 1), of slice 1
    // (r = 2, 3).
    float xr[4][XC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < XC; ++k)
        xr[r][k] = k < C0 ? to_f(X[k * L12B_ROWS + 8 * r + g]) : 0.f;
    // h1 bf16(W2) for both slices: the A fragment of slice s at k16 step
    // kk is h1 at its rows g, g + 8 and columns 16 kk + 8 jj + 2t (+1).
    float c[2][8][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) zero4(c[s][nj]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t h[4];
        h1_bf16_rows<4, XC>(xr, C0, prm + (8 * kk + 4 * jj + t) * L12B_PP,
                            h);
        a[0][2 * jj] = h[0];
        a[0][2 * jj + 1] = h[1];
        a[1][2 * jj] = h[2];
        a[1][2 * jj + 1] = h[3];
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4t(b, b_rows_at(Ws, 16 * np, 16 * kk, lane));
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          mma_bf16(c[s][2 * np], a[s], b[0], b[1]);
          mma_bf16(c[s][2 * np + 1], a[s], b[2], b[3]);
        }
      }
    }
    // p2 = bf16(acc) + bf16(b2), staged by n-tile pairs (stmatrix: slice
    // s's rows, columns 16 q..); the lane's sums over its four rows, per
    // column 8 nj + 2t (+1): vs[4 nj ..] = [s, ss, s', ss'].
    float vs[32];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t st[2][4];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int nj = 2 * q + jn;
        const float2 bb = ld2(b2s + 8 * nj + 2 * t);
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 f = unpack_bf16(
                pack_bf16(c[s][nj][2 * h], c[s][nj][2 * h + 1]));
            const float2 u = make_float2(__fadd_rn(f.x, bb.x),
                                         __fadd_rn(f.y, bb.y));
            st[s][2 * jn + h] = pack_bf16(u.x, u.y);
            float* v = vs + 4 * nj;
            if (s == 0 && h == 0) {
              v[0] = u.x;
              v[1] = __fmul_rn(u.x, u.x);
              v[2] = u.y;
              v[3] = __fmul_rn(u.y, u.y);
            } else {
              v[0] = __fadd_rn(v[0], u.x);
              v[1] = fmaf(u.x, u.x, v[1]);
              v[2] = __fadd_rn(v[2], u.y);
              v[3] = fmaf(u.y, u.y, v[3]);
            }
          }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s)            // a_rows_at's addresses
        stsm4(stg + (16 * s + (lane & 15)) * LDB + 16 * q + ((lane >> 4) << 3),
              st[s]);
    }
    // Over the eight g lanes (as the f32 form): lane (g, t) ends with
    // n-tile g's vs[0..3].
#pragma unroll
    for (int q = 0; q < 16; ++q) halve(vs[q], vs[16 + q], lane, 16);
#pragma unroll
    for (int q = 0; q < 8; ++q) halve(vs[q], vs[8 + q], lane, 8);
#pragma unroll
    for (int q = 0; q < 4; ++q) halve(vs[q], vs[4 + q], lane, 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) run[q] += vs[q];
    // The staged rows leave in 16-byte stores: four whole rows a warp
    // instruction.
    __syncwarp();
    bf* out = p2 + r0 * CW;
#pragma unroll
    for (int q = 0; q < L12B_ROWS / 4; ++q) {
      const int r = 4 * q + (lane >> 3), cl = (lane & 7) * 8;
      *reinterpret_cast<uint4*>(out + r * CW + cl) =
          *reinterpret_cast<const uint4*>(stg + r * LDB + cl);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The 16 warps' partials summed in order (staged over W2 and the rows).
  double* red = reinterpret_cast<double*>(smb);           // (warps, 2, CW)
  const int col = 8 * g + 2 * t;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    red[(warp * 2 + (q & 1)) * CW + col + (q >> 1)] = run[q];
  __syncthreads();
  if (threadIdx.x < 2 * CW) {
    const int q = threadIdx.x / CW, cl = threadIdx.x % CW;
    double a = 0.0;
    for (int w = 0; w < L12B_WARPS; ++w) a += red[(w * 2 + q) * CW + cl];
    part[(int64_t)blockIdx.x * 2 * CW + threadIdx.x] = a;
  }
}

// ---------------------------------------------------------------------
// B2 sweep B at bf16 (facl_sa_fwd_gram_pool_bf16). Replaces
// facl_tpu/ops/pallas/sa_pair.py::_make_gram_pool_sweep (:179,
// pallas_call :660) at compute_dtype bfloat16: h2 = relu(bf16(p2 mul2 +
// shift2)); per block Gram(h2) and colsum(h2); p3 = bf16(h2 bf16(W3)) +
// bf16(b3), summed in f32; per (pool group, channel) the max and min of
// p3, stored as bf16, with the first in-group row of each (the twin:
// ops/sa_pair.py::sa_fwd_gram_pool_bf16_plain).
//
// Bound on the card at the main path (R = 2,621,440 rows): 0.168 ms by
// operations (97 GFLOP of products at the bf16 rate, 0.098 ms, and the
// CUDA-core h2 pass and pool, 0.070 ms); bytes (p2 in, the pooled rows
// out) take 0.14 ms. The form this replaces was the f32 design carrying
// bf16 values as floats: TF32 m16n8k8 products (half the bf16 rate,
// twice the fragment bytes), hi/lo tiles with a zero lo half, 220 KB of
// shared memory and three block barriers a tile. Here p2 arrives by TMA (one
// bulk copy a tile, four in flight); all 512 threads turn a tile into h2
// (bf16) in one of two padded tiles, so one barrier a tile suffices: a
// warp that has finished tile i's products goes on to tile
// i + 1's pass while others still read tile i's h2. Each of the 16
// warps then takes p3^T = W3^T h2^T for the channels 16 w.. over all 64
// rows (W3^T's bf16 fragments held in registers for the whole sweep,
// h2's read by ldmatrix), so that a channel's 64 rows sit in the four
// lanes of one t group, 16 a lane: each (group, channel) max and min is
// reduced from the accumulators inside one warp, mostly within lanes,
// with two shuffle steps (pool_tile_t: the exact first-row rule of the
// f32 form; a pool group of 128 rows spans two tiles walked in order, the
// running max and min in `run`); and a (16, 16) block of Gram(h2), the
// column sums taken from the same fragments. Every rounding to bf16
// converts two values at once (cvt.rn.bf16x2: a third of the cost of
// one at a time on this card). 57 KB of shared memory; 512 threads.
constexpr int GPB_NT = 512;        // 16 warps, 16 channels each
constexpr int GPB_STAGES = 4;       // p2 tiles in flight

// Per (pool group, channel) max and min of one tile's p3 = bf16(acc) +
// b3 (b3 rounded, the sum in f32) with the first in-group row of each,
// from the accumulators of p3^T (channels as the product's rows): lane
// (g, t) holds channel ch0 + 8 hh + g at the tile's rows 8 j + 2t + e in
// c[j][2 hh + e]. A group of 2^LP rows spans, in a lane, 2^(LP - 3) of
// its j (LP > 3) and both e (LP > 0), and the t bits
// below LP - 1 across lanes (two at most): its max and min are reduced
// over the lane's values, then over those lanes; then the first row
// holding each (the smallest, as pool_tile). pool > TR (upt > 1, LP ==
// 6): a group spans upt tiles walked in order, the running max and min in
// run. Max and min stored as bf16.
template <int LP>
__device__ __forceinline__ void pool_tile_t(const float c[8][4], int ch0,
                                            const float* b3s, int64_t tile,
                                            int upt, float* run,
                                            __nv_bfloat16* mx,
                                            __nv_bfloat16* mn, int* imx,
                                            int* imn) {
  constexpr int JS = LP > 3 ? 1 << (LP - 3) : 1;       // j of a group
  constexpr int ES = LP > 0 ? 2 : 1;                   // e of a group
  constexpr int TB = LP > 2 ? 2 : (LP > 1 ? 1 : 0);    // t bits of a group
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int* irun = reinterpret_cast<int*>(run + 2 * C3W);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ch = ch0 + 8 * hh + g;
    const float bias = b3s[ch];
    float v[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 u =
          unpack_bf16(pack_bf16(c[j][2 * hh], c[j][2 * hh + 1]));
      v[j][0] = __fadd_rn(u.x, bias);
      v[j][1] = __fadd_rn(u.y, bias);
    }
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += JS)
#pragma unroll
      for (int e0 = 0; e0 < 2; e0 += ES) {
        float m = v[j0][e0], n = m;
#pragma unroll
        for (int jj = 0; jj < JS; ++jj)
#pragma unroll
          for (int ee = 0; ee < ES; ++ee) {
            m = fmaxf(m, v[j0 + jj][e0 + ee]);
            n = fminf(n, v[j0 + jj][e0 + ee]);
          }
#pragma unroll
        for (int b = 0; b < TB; ++b) {
          m = fmaxf(m, __shfl_xor_sync(FULL, m, 1 << b));
          n = fminf(n, __shfl_xor_sync(FULL, n, 1 << b));
        }
        int jm = TR, jn = TR;
#pragma unroll
        for (int jj = JS - 1; jj >= 0; --jj)
#pragma unroll
          for (int ee = ES - 1; ee >= 0; --ee) {
            const int r = 8 * (j0 + jj) + 2 * t + e0 + ee;
            if (v[j0 + jj][e0 + ee] == m) jm = r;
            if (v[j0 + jj][e0 + ee] == n) jn = r;
          }
#pragma unroll
        for (int b = 0; b < TB; ++b) {
          jm = min(jm, __shfl_xor_sync(FULL, jm, 1 << b));
          jn = min(jn, __shfl_xor_sync(FULL, jn, 1 << b));
        }
        if ((t & ((1 << TB) - 1)) != 0) continue;
        const int base = ((8 * j0 + 2 * t + e0) >> LP) << LP;
        const int grp = base >> LP;                // group within the tile
        if (upt == 1) {
          const int64_t o = (tile * (TR >> LP) + grp) * C3W + ch;
          mx[o] = __float2bfloat16_rn(m);
          mn[o] = __float2bfloat16_rn(n);
          imx[o] = jm - base;
          imn[o] = jn - base;
        } else {                                  // LP == 6: one group
          const int jt = static_cast<int>(tile % upt);
          if (jt == 0 || m > run[ch]) {
            run[ch] = m;
            irun[ch] = jm + jt * TR;
          }
          if (jt == 0 || n < run[C3W + ch]) {
            run[C3W + ch] = n;
            irun[C3W + ch] = jn + jt * TR;
          }
          if (jt == upt - 1) {
            const int64_t o = (tile / upt) * C3W + ch;
            mx[o] = __float2bfloat16_rn(run[ch]);
            mn[o] = __float2bfloat16_rn(run[C3W + ch]);
            imx[o] = irun[ch];
            imn[o] = irun[C3W + ch];
          }
        }
      }
  }
}

template <int LP>
__global__ void __launch_bounds__(GPB_NT, 1)
fwd_gram_pool_bf16_kernel(const __nv_bfloat16* __restrict__ p2,
                          int64_t ntiles, int upt,
                          const float* __restrict__ vec2,
                          const float* __restrict__ W3,
                          const float* __restrict__ b3,
                          double* __restrict__ partG,
                          double* __restrict__ partc,
                          __nv_bfloat16* __restrict__ mx,
                          __nv_bfloat16* __restrict__ mn,
                          int* __restrict__ imx, int* __restrict__ imn) {
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smb[];
  bf* stage = reinterpret_cast<bf*>(smb);       // GPB_STAGES x (TR, CW): p2
  bf* H2 = stage + GPB_STAGES * TR * CW;        // 2 x (TR, LDB): h2
  float* v2 = reinterpret_cast<float*>(H2 + 2 * TR * LDB);  // mul2 | shift2
  float* b3s = v2 + 2 * CW;                     // bf16(b3)
  float* run = b3s + C3W;                       // 4 x C3W (pool > TR)
  uint64_t* bars = reinterpret_cast<uint64_t*>(run + 4 * C3W);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mw = warp & 3, nw = warp >> 2;  // Gram rows 16 mw.., cols 16 nw..
  const int n0 = 16 * warp;                     // p3's channels
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
    uint64_t* bar = &bars[i % GPB_STAGES];
    mbar_expect(bar, TR * CW * sizeof(bf));
    bulk_load(stage + (i % GPB_STAGES) * TR * CW, p2 + tile_at(i) * TR * CW,
              TR * CW * sizeof(bf), bar);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < GPB_STAGES; ++s) mbar_init(&bars[s]);
    for (int64_t i = 0; i < GPB_STAGES && i < count; ++i) fetch(i);
  }
  // bf16(W3)^T's A fragments (channels n0.., k steps kk).
  uint32_t wa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* w = W3 + (16 * kk + 2 * t) * C3W + n0 + g;
    wa[kk][0] = pack_bf16(w[0], w[C3W]);
    wa[kk][1] = pack_bf16(w[8], w[C3W + 8]);
    wa[kk][2] = pack_bf16(w[8 * C3W], w[9 * C3W]);
    wa[kk][3] = pack_bf16(w[8 * C3W + 8], w[9 * C3W + 8]);
  }
  for (int i = threadIdx.x; i < 2 * CW; i += GPB_NT) v2[i] = vec2[i];
  for (int i = threadIdx.x; i < C3W; i += GPB_NT) b3s[i] = rb(b3[i]);
  __syncthreads();

  double G[2][4] = {};        // rows 16 mw + g (+8), cols 16 nw + 8 nj + 2t
  double ch[2] = {0.0, 0.0};  // nw == 0: channels 16 mw + g, + 8
  for (int64_t i = 0; i < count; ++i) {
    const int64_t tile = tile_at(i);
    bf* H = H2 + (i & 1) * TR * LDB;
    mbar_wait(&bars[i % GPB_STAGES],
              static_cast<uint32_t>((i / GPB_STAGES) & 1));
    {   // h2 = relu(bf16(p2 mul2 + shift2)), eight values a step
      relu_rows_bf16(stage + (i % GPB_STAGES) * TR * CW, v2, H, threadIdx.x,
                     GPB_NT);
    }
    __syncthreads();
    if (threadIdx.x == 0 && i + GPB_STAGES < count) fetch(i + GPB_STAGES);

    {   // Gram(h2) = h2^T h2 for the warp's block; nw == 0: column sums
      float c[2][4];
      zero4(c[0]);
      zero4(c[1]);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4], b[4];
        ldsm4t(a, a_cols_at(H, 16 * mw, 16 * kk, lane));
        ldsm4t(b, b_rows_at(H, 16 * nw, 16 * kk, lane));
        if (nw == 0) {
          const float2 u0 = unpack_bf16(a[0]), u1 = unpack_bf16(a[1]);
          const float2 u2 = unpack_bf16(a[2]), u3 = unpack_bf16(a[3]);
          s0 += (u0.x + u0.y) + (u2.x + u2.y);
          s1 += (u1.x + u1.y) + (u3.x + u3.y);
        }
        mma_bf16(c[0], a, b[0], b[1]);
        mma_bf16(c[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) G[nj][q] += c[nj][q];
      ch[0] += s0;
      ch[1] += s1;
    }

    {   // p3^T = bf16(W3)^T h2^T for the channels n0.. (+ b3 in the pool)
      float c[8][4];            // [rows 8 j..][.]
#pragma unroll
      for (int j = 0; j < 8; ++j) zero4(c[j]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm4(b, b_cols_at(H, 16 * np, 16 * kk, lane));
          mma_bf16(c[2 * np], wa[kk], b[0], b[1]);
          mma_bf16(c[2 * np + 1], wa[kk], b[2], b[3]);
        }
      pool_tile_t<LP>(c, n0, b3s, tile, upt, run, mx, mn, imx, imn);
    }
  }

  double* pg = partG + (int64_t)blockIdx.x * CW * CW;
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pg[(16 * mw + g + 8 * (q >> 1)) * CW + 16 * nw + 8 * nj + 2 * t +
         (q & 1)] = G[nj][q];
  if (nw == 0) {
    const double a = sum_over_t(ch[0]), b = sum_over_t(ch[1]);
    if (t == 0) {
      partc[(int64_t)blockIdx.x * CW + 16 * mw + g] = a;
      partc[(int64_t)blockIdx.x * CW + 16 * mw + g + 8] = b;
    }
  }
}

// ---------------------------------------------------------------------
// B3 sweep 2 (slim) at bf16 (facl_sa_bwd_sweep2_bf16). Replaces
// facl_tpu/ops/pallas/sa_pair.py::_make_sweep2_slim_kernel (:404,
// pallas_call :800) at compute_dtype bfloat16: h1 recomputed from x by
// the bf16 chain (h1_pair<true>, B2a's and B3c's: the ReLU masks agree
// bit for bit); h2 = relu(bf16(p2 mul2 + shift2)); dy2 = [h2 > 0] (q3 -
// bf16(h2 bf16(M3)) - rc3); q2 = bf16(bf16(bf16(dy2) bf16(gi2))
// bf16(W2)^T); mq = [h1 > 0] q2, stored bf16; per block A2 = bf16(dy2)^T
// h1, G1 = h1^T h1, u2 = sum dy2 (before its rounding), ch1 = sum h1 (the
// twin: ops/sa_pair.py::sa_bwd_sweep2_bf16_plain).
//
// Bound on the card at the main path: 0.307 ms by bytes (x, p2, q3 in,
// mq out: 392 B a row). The form this replaces (the f32 design, TF32
// products, hi/lo tiles, five block barriers a tile) moved 0.53 TB/s.
// Here the rows go where they are used: a step is 128 rows, warp w owns
// rows 16 w.. of it, and everything that is per row stays in that warp's
// registers in the mma fragment layouts. p2, q3 and x arrive by cp.async
// (16-byte copies into padded tiles, three steps in flight); the warp
// makes h1 in the accumulator layout (h1_pair) and writes it to a bf16
// tile, keeps its ReLU mask as 32 bits; makes h2's A fragments from p2's
// (ldmatrix, the chain) and h2's mask alike; h2 M3 (B by ldmatrix from
// bf16(M3)); dy2 in the accumulator layout, written as bf16 to a tile and
// turned in registers into q2's A fragments (C of two n-tiles is A of a
// k16 step); q2; mq stored through the warp's own p2 rows in 16-byte
// copies. u2 and ch1 are summed from registers (a halving shuffle tree).
// A2 and G1 contract over the rows, so they run on the tiles: warp w takes
// a (16, 32) block of each, over step i - 1's h1 and dy2 tiles while the
// row passes write step i's (two of each, so one barrier a step
// suffices, and one warp's products run beside another's row passes).
// Every rounding to bf16 converts two values at once (cvt.rn.bf16x2).
// 256 threads; 208 KB of shared memory.
constexpr int S2B_NT = 256;
constexpr int S2B_ROWS = 128;                   // rows a step, 16 a warp
constexpr int S2B_STAGES = 3;
constexpr int S2B_TILE = S2B_ROWS * LDB;        // a padded (128, 64) tile
constexpr int S2B_STAGE = 2 * S2B_TILE + C0MAX * S2B_ROWS;  // p2 | q3 | x

__device__ __forceinline__ void st32(__nv_bfloat16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A2 += bf16(dy2)^T h1 and G1 += h1^T h1 over the 64 rows h.. of a step
// (tiles Hb = h1, Db = bf16(dy2)), summed in f32 and carried in float64,
// for the warp's (16, 32) block: rows (channels) 16 mt + g (+8), columns
// 32 nh + 8 nj + 2t (+1).
__device__ __forceinline__ void s2b_products(const __nv_bfloat16* Hb,
                                             const __nv_bfloat16* Db, int h,
                                             int mt, int nh, int lane,
                                             double (&dA)[4][4],
                                             double (&dG)[4][4]) {
  float ca[4][4], cg[4][4];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    zero4(ca[nj]);
    zero4(cg[nj]);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k0 = h + 16 * kk;
    uint32_t ad[4], ah[4], b[2][4];
    ldsm4t(ad, a_cols_at(Db, 16 * mt, k0, lane));
    ldsm4t(ah, a_cols_at(Hb, 16 * mt, k0, lane));
    ldsm4t(b[0], b_rows_at(Hb, 32 * nh, k0, lane));
    ldsm4t(b[1], b_rows_at(Hb, 32 * nh + 16, k0, lane));
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const uint32_t b0 = b[nj >> 1][2 * (nj & 1)];
      const uint32_t b1 = b[nj >> 1][2 * (nj & 1) + 1];
      mma_bf16(ca[nj], ad, b0, b1);
      mma_bf16(cg[nj], ah, b0, b1);
    }
  }
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dA[nj][q] += ca[nj][q];
      dG[nj][q] += cg[nj][q];
    }
}

__global__ void __launch_bounds__(S2B_NT, 1)
bwd_sweep2_bf16_kernel(const __nv_bfloat16* __restrict__ x, int C0,
                       int64_t N, int64_t R, const float* __restrict__ W1,
                       const float* __restrict__ vec,
                       const __nv_bfloat16* __restrict__ p2,
                       const __nv_bfloat16* __restrict__ q3,
                       const float* __restrict__ M3,
                       const float* __restrict__ W2,
                       __nv_bfloat16* __restrict__ mq,
                       double* __restrict__ partA, double* __restrict__ partG,
                       double* __restrict__ partu,
                       double* __restrict__ partc) {
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smb[];
  bf* stage = reinterpret_cast<bf*>(smb);     // S2B_STAGES x [p2 | q3 | x]
  bf* H1 = stage + S2B_STAGES * S2B_STAGE;    // 2 x (128, LDB): h1
  bf* DY = H1 + 2 * S2B_TILE;                 // 2 x (128, LDB): bf16(dy2)
  bf* Ms = DY + 2 * S2B_TILE;                 // bf16(M3) [k][n], (64, LDB)
  bf* W2s = Ms + CW * LDB;                    // bf16(W2) [n][k], (64, LDB)
  float* W1s = reinterpret_cast<float*>(W2s + CW * LDB);   // C0MAX x CW
  // b1 | mul1 | shift1 | mul2 | shift2 | rc3 | gi2 (b1, gi2 rounded)
  float* v = W1s + C0MAX * CW;
  const float* mul2 = v + 3 * CW;
  const float* shift2 = v + 4 * CW;
  const float* rc3 = v + 5 * CW;
  const float* gi2 = v + 6 * CW;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t nsteps = (R + S2B_ROWS - 1) / S2B_ROWS;
  const int64_t count =
      nsteps > blockIdx.x ? (nsteps - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto row0 = [&](int64_t i) {
    return (blockIdx.x + i * gridDim.x) * S2B_ROWS;
  };
  // x in 16-byte copies of 8 rows (one cloud: N % 8 == 0), else by loads.
  const bool xvec = N % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto fetch = [&](int64_t i) {   // every thread: its copies of step i
    if (i < count) {
      bf* S = stage + (i % S2B_STAGES) * S2B_STAGE;
      const int64_t r0 = row0(i);
      const int nr = R - r0 < S2B_ROWS ? static_cast<int>(R - r0) : S2B_ROWS;
      for (int e = threadIdx.x; e < nr * 8; e += S2B_NT) {
        const int r = e >> 3, c = (e & 7) << 3;
        cp_async16(S + r * LDB + c, p2 + (r0 + r) * CW + c);
        cp_async16(S + S2B_TILE + r * LDB + c, q3 + (r0 + r) * CW + c);
      }
      bf* X = S + 2 * S2B_TILE;               // (C0MAX, 128) channel-major
      if (xvec) {
        const int nc = nr >> 3;
        for (int e = threadIdx.x; e < C0 * nc; e += S2B_NT) {
          const int c = e / nc, j = e - c * nc;
          const int64_t r = r0 + 8 * j, b = r / N, n = r - b * N;
          cp_async16(X + c * S2B_ROWS + 8 * j, x + (b * C0 + c) * N + n);
        }
      } else {
        for (int e = threadIdx.x; e < C0 * nr; e += S2B_NT) {
          const int c = e / nr, j = e - c * nr;
          const int64_t r = r0 + j, b = r / N, n = r - b * N;
          X[c * S2B_ROWS + j] = x[(b * C0 + c) * N + n];
        }
      }
    }
    cp_async_commit();
  };

  for (int i = 0; i < S2B_STAGES - 1; ++i) fetch(i);
  for (int e = threadIdx.x; e < CW * CW; e += S2B_NT) {
    const int r = e >> 6, c = e & 63;
    Ms[r * LDB + c] = __float2bfloat16_rn(M3[e]);
    W2s[r * LDB + c] = __float2bfloat16_rn(W2[e]);
  }
  for (int e = threadIdx.x; e < C0 * CW; e += S2B_NT) W1s[e] = rb(W1[e]);
  for (int e = threadIdx.x; e < 7 * CW; e += S2B_NT)
    v[e] = e < CW || e >= 6 * CW ? rb(vec[e]) : vec[e];
  for (int e = threadIdx.x; e < 4 * S2B_TILE / 8; e += S2B_NT)
    reinterpret_cast<uint4*>(H1)[e] = make_uint4(0u, 0u, 0u, 0u);

  const int rw = 16 * warp;                   // the warp's rows in a step
  const int mt = warp & 3, nh = warp >> 2;    // its block of A2 and G1
  double dA[4][4] = {}, dG[4][4] = {};
  double du[2] = {0.0, 0.0}, dc[2] = {0.0, 0.0};  // columns 8 g + 2t (+1)
  for (int64_t i = 0; i < count; ++i) {
    cp_async_wait<S2B_STAGES - 2>();
    __syncthreads();
    fetch(i + S2B_STAGES - 1);
    const int64_t r0 = row0(i);
    bf* S = stage + (i % S2B_STAGES) * S2B_STAGE;
    bf* Hb = H1 + (i & 1) * S2B_TILE;
    bf* Db = DY + (i & 1) * S2B_TILE;
    // The warp's rows (all 16 or none, R % 64 == 0). Rows past R (the
    // last step's second tile) write zeros to the h1 and dy2 tiles (their
    // masks cleared), so the products may read all 128 rows.
    const bool live = r0 + rw < R;
    // h1 by the bf16 chain, rows rw + g (+8), columns 8 j + 2t (+1):
    // written as bf16; its mask, bit 4 j + 2 h + e; its column sums.
    const bf* X = S + 2 * S2B_TILE;
    float xa[C0MAX - 1], xb[C0MAX - 1];
#pragma unroll
    for (int k = 0; k < C0MAX - 1; ++k)
      if (k < C0) {
        xa[k] = to_f(X[k * S2B_ROWS + rw + g]);
        xb[k] = to_f(X[k * S2B_ROWS + rw + g + 8]);
      }
    uint32_t m1 = 0;
    float sc[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      float2 ha, hb;
      h1_pair<true>(xa, xb, C0, W1s, v, col, ha, hb);
      if (!live) ha = hb = make_float2(0.f, 0.f);
      st32(Hb + (rw + g) * LDB + col, pack_bf16(ha.x, ha.y));
      st32(Hb + (rw + g + 8) * LDB + col, pack_bf16(hb.x, hb.y));
      m1 |= ((ha.x > 0.f ? 1u : 0u) | (ha.y > 0.f ? 2u : 0u) |
             (hb.x > 0.f ? 4u : 0u) | (hb.y > 0.f ? 8u : 0u)) << (4 * j);
      sc[2 * j] = ha.x + hb.x;
      sc[2 * j + 1] = ha.y + hb.y;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) halve(sc[q], sc[8 + q], lane, 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) halve(sc[q], sc[4 + q], lane, 8);
#pragma unroll
    for (int q = 0; q < 2; ++q) halve(sc[q], sc[2 + q], lane, 4);
    dc[0] += sc[0];
    dc[1] += sc[1];

    // h2's A fragments from p2's, k steps kk, and its ReLU mask in the
    // accumulators' places (bit 4 j + 2 h + e, as m1).
    uint32_t ha2[4][4], m2 = 0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm4(ha2[kk], a_rows_at(S, rw, 16 * kk, lane));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int cc = 16 * kk + 8 * (q >> 1) + 2 * t;
        const float2 p = unpack_bf16(ha2[kk][q]);
        float2 f;
        uint32_t bits;
        ha2[kk][q] = relu_packed(
            pack_bf16(__fadd_rn(__fmul_rn(p.x, mul2[cc]), shift2[cc]),
                      __fadd_rn(__fmul_rn(p.y, mul2[cc + 1]),
                                shift2[cc + 1])),
            f, bits);
        m2 |= bits << (8 * kk + 2 * q);
      }
    }
    if (!live) m2 = 0;
    // h2 bf16(M3): n-tiles j, all 64 columns.
    float c[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) zero4(c[j]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4t(b, b_rows_at(Ms, 16 * np, 16 * kk, lane));
        mma_bf16(c[2 * np], ha2[kk], b[0], b[1]);
        mma_bf16(c[2 * np + 1], ha2[kk], b[2], b[3]);
      }
    // dy2 = [h2 > 0] (q3 - bf16(h2 M3) - rc3) in the accumulators'
    // places: bf16(dy2) to the tile, q2's A fragments bf16(bf16(dy2)
    // gi2) (n-tiles 2 kk and 2 kk + 1 are k step kk), u2's sums.
    const bf* Q = S + S2B_TILE;
    uint32_t qa[4][4];
    float su[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = 8 * j + 2 * t;
      const float2 rc = ld2(rc3 + cc), gk = ld2(gi2 + cc);
      su[2 * j] = su[2 * j + 1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rw + g + 8 * h;
        const float2 qv = unpack_bf16(ld32(Q + r * LDB + cc));
        const uint32_t mb = m2 >> (4 * j + 2 * h);
        const float2 hm =
            unpack_bf16(pack_bf16(c[j][2 * h], c[j][2 * h + 1]));
        const float dx =
            (mb & 1u) ? __fsub_rn(__fsub_rn(qv.x, hm.x), rc.x) : 0.f;
        const float dy =
            (mb & 2u) ? __fsub_rn(__fsub_rn(qv.y, hm.y), rc.y) : 0.f;
        su[2 * j] += dx;
        su[2 * j + 1] += dy;
        const uint32_t d = pack_bf16(dx, dy);
        st32(Db + r * LDB + cc, d);
        const float2 dd = unpack_bf16(d);
        qa[j >> 1][2 * (j & 1) + h] =
            pack_bf16(__fmul_rn(dd.x, gk.x), __fmul_rn(dd.y, gk.y));
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) halve(su[q], su[8 + q], lane, 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) halve(su[q], su[4 + q], lane, 8);
#pragma unroll
    for (int q = 0; q < 2; ++q) halve(su[q], su[2 + q], lane, 4);
    du[0] += su[0];
    du[1] += su[1];

    // q2 = qa bf16(W2)^T; mq = [h1 > 0] bf16(q2), staged in the warp's
    // own (read) p2 rows, then stored in 16-byte rows.
#pragma unroll
    for (int j = 0; j < 8; ++j) zero4(c[j]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4(b, b_cols_at(W2s, 16 * np, 16 * kk, lane));
        mma_bf16(c[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(c[2 * np + 1], qa[kk], b[2], b[3]);
      }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        st32(S + (rw + g + 8 * h) * LDB + 8 * j + 2 * t,
             pack_bf16(c[j][2 * h], c[j][2 * h + 1]) &
                 keep_halves(m1 >> (4 * j + 2 * h)));
      }
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 16 * 8; e += 32) {
      if (!live) break;
      const int r = rw + (e >> 3), cl = (e & 7) << 3;
      *reinterpret_cast<uint4*>(mq + (r0 + r) * CW + cl) =
          *reinterpret_cast<const uint4*>(S + r * LDB + cl);
    }
    // A2 and G1 of the step before (its tiles are complete: barrier;
    // zeros at i == 0): one warp's products run beside another's row
    // passes.
    for (int h = 0; h < S2B_ROWS; h += TR)
      s2b_products(H1 + ((i - 1) & 1) * S2B_TILE,
                   DY + ((i - 1) & 1) * S2B_TILE, h, mt, nh, lane, dA, dG);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int h = 0; h < S2B_ROWS; h += TR)      // the last step's
    s2b_products(H1 + ((count - 1) & 1) * S2B_TILE,
                 DY + ((count - 1) & 1) * S2B_TILE, h, mt, nh, lane, dA,
                 dG);

  double* pa = partA + (int64_t)blockIdx.x * CW * CW;
  double* pg = partG + (int64_t)blockIdx.x * CW * CW;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = (16 * mt + g + 8 * (q >> 1)) * CW + 32 * nh + 8 * nj +
                    2 * t + (q & 1);
      pa[o] = dA[nj][q];
      pg[o] = dG[nj][q];
    }
  // u2 and ch1: the eight warps' sums in order (staged in the idle stages).
  double* red = reinterpret_cast<double*>(smb);    // (warps, 2, CW)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    red[(warp * 2) * CW + 8 * g + 2 * t + e] = du[e];
    red[(warp * 2 + 1) * CW + 8 * g + 2 * t + e] = dc[e];
  }
  __syncthreads();
  if (threadIdx.x < 2 * CW) {
    const int q = threadIdx.x / CW, cl = threadIdx.x % CW;
    double a = 0.0;
    for (int w = 0; w < S2B_NT / 32; ++w) a += red[(w * 2 + q) * CW + cl];
    (q == 0 ? partu : partc)[(int64_t)blockIdx.x * CW + cl] = a;
  }
}

// ---------------------------------------------------------------------
// B3 sweep 1 at bf16 (facl_sa_bwd_sweep1_bf16). Replaces
// facl_tpu/ops/pallas/sa_pair.py::_make_sweep1_pair_kernel (:252,
// pallas_call :772) at compute_dtype bfloat16: h2 = relu(bf16(p2 mul2 +
// shift2)); dy3 = dpooled at each live entry's argmax row; per block A3 =
// dy3^T h2 and u3 = sum dy3; q3 = bf16(D bf16(W3)^T), D = bf16(dy3
// bf16(gi3)), stored bf16 (the twin: ops/sa_pair.py::
// sa_bwd_sweep1_bf16_plain).
//
// Bound on the card at the main path: 0.219 ms by bytes (p2 in, q3 out,
// dpooled and idx in). The form this replaces (the f32 design at bf16)
// built q3 sparsely from row bitmaps, a task scan and split rows with
// four block barriers a tile, and was no faster than at f32. Here q3 is
// the TPU kernel's dense product, on tensor cores: a tile's D (64 rows x
// 256 channels) holds one value per (group, channel), at its argmax row,
// so the argmax layout's skew (most channels on a group's first row)
// costs a dense product nothing. D is a bf16 tile in shared memory that
// stays zero but at the tile's entries: each entry is written by the one
// thread that owns its (group, channel), which clears the entry it wrote
// there two tiles before (O(entries) a tile, no zeroing pass). The
// product is wgmma m64n64k16 (D and bf16(W3) both by descriptor, f32
// accumulators): D's fragments built in registers instead (a compare of
// each value's row) held 64 registers live across the asynchronous
// product and spilled, and mma.sync ran the product at a fraction of the
// bf16 rate. The block's warps take four roles, on neighbouring tiles at
// once:
//  - warp 15 (the producer) keeps up to four tiles of p2, dpooled and idx
//    in flight by TMA (each stage refilled once its readers are done:
//    mbarriers full and empty), and stores each tile's q3 from its
//    staging tile in 16-byte rows (mbarriers ready and free), so no
//    other warp waits on a global memory operation;
//  - warps 0-3 (one warpgroup) issue tile i's sixteen k16 steps (the
//    whole 64 x 64 q3 tile), form half of tile i + 1's h2 (bf16, padded)
//    from its p2 while the tensor cores run them, then round q3 in pairs
//    into a padded staging tile;
//  - warps 4-6 form the other half of tile i + 1's h2;
//  - warps 7-14 write tile i + 1's entries (into D, and as (row, dpooled)
//    words for A3), then add tile i's A3 and u3 on CUDA cores (a thread a
//    channel, one 64-wide FMA row per live entry, 64 f32 sums carried as
//    the f32 form carries them).
// Warps 0-14 meet at one barrier a tile (D, h2, the A3 words and the
// staging tile double-buffered). Every rounding to bf16 converts two
// values at once. 512 threads (a 17th warp would cap every thread at 96
// registers: five warps on one of the SM's four register files; the row
// warps' 64 A3 sums then spilled).
constexpr int S1B_MT = 128;         // the q3 warpgroup (warps 0-3)
constexpr int S1B_HT = 96;          // the h2 warps (4-6)
constexpr int S1B_RT = C3W;         // the row warps (7-14), one a channel
constexpr int S1B_CT = S1B_MT + S1B_HT + S1B_RT;  // the compute warps
constexpr int S1B_NT = S1B_CT + 32; // and the producer warp (15)
constexpr int S1B_STAGES = 4;       // row tiles in flight, at most
constexpr uint16_t S1B_NONE = 0xffffu;   // no entry written

// Byte offsets of the bf16 sweep 1's shared memory for U rows, gpt pool
// groups and S stages a tile: S x [p2 (U, CW) | dpooled (E) | idx (E)],
// bf16(W3) and two D tiles (wgmma operands, core_k256), and two of each
// of: the D positions each entry wrote (E) u16, A3's words (E) u32, h2
// and q3 (U, LDB) bf16; mul2 | shift2 | bf16(gi3); the mbarriers (full
// and empty a stage, ready and free a staging tile).
struct S1BLayout {
  int stage, w3, dt, pos, a3e, h2, q3, vec, bars, total;
};

__host__ __device__ inline S1BLayout s1b_layout(int U, int gpt, int S) {
  const int E = gpt * C3W;
  S1BLayout l;
  l.stage = U * CW * 2 + E * 2 + E * 4;
  l.w3 = (S * l.stage + 1023) & ~1023;
  l.dt = l.w3 + CW * C3W * 2;
  l.pos = l.dt + 2 * TR * C3W * 2;
  l.a3e = l.pos + 2 * E * 2;
  l.h2 = l.a3e + 2 * E * 4;
  l.q3 = l.h2 + 2 * U * LDB * 2;
  l.vec = l.q3 + 2 * U * LDB * 2;
  l.bars = l.vec + (2 * CW + C3W) * 4;
  l.total = l.bars + (2 * S + 4) * 8;
  return l;
}

// Element (r, k) of a (64, 256) bf16 wgmma operand, K-major, without
// swizzle: 8 x 8 core matrices of 128 contiguous bytes (8 rows, 8 k
// each), the next 8 k at +128 bytes (LBO), the next 8 rows at +4096 (SBO).
__device__ __forceinline__ int core_k256(int r, int k) {
  return ((r >> 3) * (C3W / 8) + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7);
}
constexpr uint32_t K256_LBO = 128, K256_SBO = C3W / 8 * 128;

// A wgmma matrix descriptor (no swizzle) of the operand at smem.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem) {
  return static_cast<uint64_t>((smem_addr(smem) >> 4) & 0x3fffu) |
         static_cast<uint64_t>((K256_LBO >> 4) & 0x3fffu) << 16 |
         static_cast<uint64_t>((K256_SBO >> 4) & 0x3fffu) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Pins a register's value at this point of the program: wgmma writes its
// accumulators asynchronously, between the issue and the wait.
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d += A B for the warpgroup, A (64 x 16) and B (16 x 64) bf16 by
// descriptor, d (64 x 64, f32) in mma.sync's C layout: warp w of the
// group holds rows 16 w + g (+8), n-tile j in d[4 j ..].
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                uint64_t adesc,
                                                uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(1));
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// An mbarrier of n arrivals a phase, and one arrival.
__device__ __forceinline__ void mbar_init_n(uint64_t* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(n)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__global__ void __launch_bounds__(S1B_NT, 1)
bwd_sweep1_bf16_kernel(const __nv_bfloat16* __restrict__ p2,
                       int64_t ntiles, int U, int pool, int S,
                       const float* __restrict__ vec2,
                       const __nv_bfloat16* __restrict__ dpooled,
                       const int* __restrict__ idx,
                       const float* __restrict__ gi3,
                       const float* __restrict__ W3,
                       __nv_bfloat16* __restrict__ q3,
                       double* __restrict__ partA,
                       double* __restrict__ partu) {
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smb[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // Groups per tile (pool <= U) or tiles per group (pool > U = TR).
  const int gpt = pool <= U ? U / pool : 1;
  const int upt = pool > U ? pool / U : 1;
  const int E = gpt * C3W;
  const S1BLayout ly = s1b_layout(U, gpt, S);
  bf* W3s = reinterpret_cast<bf*>(smb + ly.w3);
  bf* Ds = reinterpret_cast<bf*>(smb + ly.dt);             // 2 x (64, 256)
  uint16_t* dpos = reinterpret_cast<uint16_t*>(smb + ly.pos);
  uint32_t* a3es = reinterpret_cast<uint32_t*>(smb + ly.a3e);
  bf* H2 = reinterpret_cast<bf*>(smb + ly.h2);
  bf* Qs = reinterpret_cast<bf*>(smb + ly.q3);
  float* v = reinterpret_cast<float*>(smb + ly.vec);   // mul2|shift2|gi3
  uint64_t* full = reinterpret_cast<uint64_t*>(smb + ly.bars);
  uint64_t* empty = full + S;         // 15 arrivals: the compute warps
  uint64_t* ready = empty + S;        // 4 arrivals: the q3 warps
  uint64_t* freed = ready + 2;        // 1 arrival: the producer

  const int64_t count =
      ntiles > blockIdx.x ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto tile_at = [&](int64_t i) { return blockIdx.x + i * gridDim.x; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init_n(&full[s], 1);
      mbar_init_n(&empty[s], S1B_CT / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init_n(&ready[b], S1B_MT / 32);
      mbar_init_n(&freed[b], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int e = threadIdx.x; e < 2 * CW; e += S1B_NT) v[e] = vec2[e];
  for (int e = threadIdx.x; e < C3W; e += S1B_NT) v[2 * CW + e] = rb(gi3[e]);
  for (int e = threadIdx.x; e < CW * C3W; e += S1B_NT)
    W3s[core_k256(e / C3W, e % C3W)] = __float2bfloat16_rn(W3[e]);
  for (int e = threadIdx.x; e < 2 * TR * C3W / 8; e += S1B_NT)
    reinterpret_cast<uint4*>(Ds)[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = threadIdx.x; e < 2 * E; e += S1B_NT) dpos[e] = S1B_NONE;
  fence_async_smem();                 // wgmma reads them by the async proxy
  __syncthreads();

  if (warp == S1B_CT / 32) {
    // The producer: tile k + S into tile k's stage once its readers are
    // done; tile k - 1's q3 out of its staging tile once it is written.
    auto fetch = [&](int64_t i, int s) {
      bf* st = reinterpret_cast<bf*>(smb + s * ly.stage);
      const int64_t tl = tile_at(i), g0 = upt > 1 ? tl / upt : tl * gpt;
      mbar_expect(&full[s], ly.stage);
      bulk_load(st, p2 + tl * U * CW, U * CW * 2, &full[s]);
      bulk_load(st + U * CW, dpooled + g0 * C3W, E * 2, &full[s]);
      bulk_load(st + U * CW + E, idx + g0 * C3W, E * 4, &full[s]);
    };
    auto store_q3 = [&](int64_t k) {
      mbar_wait(&ready[k & 1], static_cast<uint32_t>((k >> 1) & 1));
      const bf* Q = Qs + (k & 1) * U * LDB;
      bf* dst = q3 + tile_at(k) * U * CW;
      for (int e = lane; e < U * 8; e += 32) {
        const int r = e >> 3, c = (e & 7) << 3;
        *reinterpret_cast<uint4*>(dst + r * CW + c) =
            *reinterpret_cast<const uint4*>(Q + r * LDB + c);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&freed[k & 1]);
    };
    if (lane == 0)
      for (int i = 0; i < S && i < count; ++i) fetch(i, i);
    for (int64_t k = 0; k < count; ++k) {
      if (lane == 0 && k + S < count) {
        const int s = static_cast<int>(k % S);
        mbar_wait(&empty[s], static_cast<uint32_t>((k / S) & 1));
        fetch(k + S, s);
      }
      __syncwarp();
      if (k > 0) store_q3(k - 1);
    }
    if (count > 0) store_q3(count - 1);
    return;
  }

  // Tile k's h2 = relu(bf16(p2 mul2 + shift2)) into buffer k & 1, eight
  // values a step: steps q0.. q1 by thread tid of nth.
  auto h2_pass = [&](int64_t k, int q0, int q1, int tid, int nth) {
    const int s = static_cast<int>(k % S);
    const bf* P = reinterpret_cast<const bf*>(smb + s * ly.stage);
    bf* Hb = H2 + (k & 1) * U * LDB;
    mbar_wait(&full[s], static_cast<uint32_t>((k / S) & 1));
    for (int q = q0 + tid; q < q1; q += nth) {
      const int r = q >> 3, cb = (q & 7) << 3;
      const uint4 u = *reinterpret_cast<const uint4*>(P + r * CW + cb);
      const uint32_t in[4] = {u.x, u.y, u.z, u.w};
      uint32_t o[4];
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const float2 pv = unpack_bf16(in[z]);
        const int cc = cb + 2 * z;
        float2 f;
        uint32_t bits;
        o[z] = relu_packed(
            pack_bf16(__fadd_rn(__fmul_rn(pv.x, v[cc]), v[CW + cc]),
                      __fadd_rn(__fmul_rn(pv.y, v[cc + 1]),
                                v[CW + cc + 1])),
            f, bits);
      }
      *reinterpret_cast<uint4*>(Hb + r * LDB + cb) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  };
  // A compute warp is done reading tile k's stage.
  auto release = [&](int64_t k) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[k % S]);
  };
  const int h2q = U * 4;              // h2 steps of the q3 warpgroup
  if (threadIdx.x >= S1B_MT && threadIdx.x < S1B_MT + S1B_HT) {
    // The h2 warps: tile i + 1's h2 while tile i's product runs.
    const int ht = threadIdx.x - S1B_MT;
    if (count > 0) {
      h2_pass(0, h2q, U * 8, ht, S1B_HT);
      release(0);
    }
    named_sync(1, S1B_CT);
    for (int64_t i = 0; i < count; ++i) {
      if (i + 1 < count) {
        h2_pass(i + 1, h2q, U * 8, ht, S1B_HT);
        release(i + 1);
      }
      named_sync(1, S1B_CT);
    }
    return;
  }

  if (threadIdx.x < S1B_MT) {
    // The q3 warpgroup: q3 = D bf16(W3)^T, its warp wr the rows
    // 16 wr + g (+8), all 64 columns.
    const int wr = warp;
    const uint64_t bdesc = wgmma_desc(W3s);
    if (count > 0) {
      h2_pass(0, 0, h2q, threadIdx.x, S1B_MT);
      release(0);
    }
    named_sync(1, S1B_CT);            // tile 0's D, A3 words and h2 are in
    for (int64_t i = 0; i < count; ++i) {
      const int b = static_cast<int>(i & 1);
      float d[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        d[q] = 0.f;
        pin(d[q]);
      }
      const uint64_t adesc = wgmma_desc(Ds + b * TR * C3W);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)      // + two core matrices of k a step
        wgmma_m64n64k16(d, adesc + 16 * kk, bdesc + 16 * kk);
      wgmma_commit();
      if (i + 1 < count) {
        h2_pass(i + 1, 0, h2q, threadIdx.x, S1B_MT);
        release(i + 1);
      }
      wgmma_wait_all();
#pragma unroll
      for (int q = 0; q < 32; ++q) pin(d[q]);
      // q3 rounded in pairs into the staging tile (once the producer has
      // stored tile i - 2 from it).
      if (i >= 2)
        mbar_wait(&freed[b], static_cast<uint32_t>(((i - 2) >> 1) & 1));
      bf* Qb = Qs + b * U * LDB;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wr + 8 * h + g;
        if (r < U)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(Qb + r * LDB + 8 * j + 2 * t) =
                pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ready[b]);
      named_sync(1, S1B_CT);
    }
    return;
  }

  // The row warps: thread ac owns channel ac of A3 (all 64 columns) and u3.
  const int ac = threadIdx.x - S1B_MT - S1B_HT;
  // Tile k's entries, two channels a thread (the same ones every tile):
  // each one's tile row (key) or DEAD; D's value bf16(dpooled bf16(gi3))
  // written at (key, channel) of D's buffer k & 1, after clearing what
  // this thread wrote there for tile k - 2; A3's word (key << 16 |
  // dpooled's bf16 bits).
  auto entries = [&](int64_t k) {
    const int s = static_cast<int>(k % S), b = static_cast<int>(k & 1);
    const int j = upt > 1 ? static_cast<int>(tile_at(k) % upt) : 0;
    const bf* DP = reinterpret_cast<const bf*>(smb + s * ly.stage) + U * CW;
    const int* IX = reinterpret_cast<const int*>(DP + E);
    bf* Db = Ds + b * TR * C3W;
    uint16_t* pb = dpos + b * E;
    uint32_t* ae = a3es + b * E;
    mbar_wait(&full[s], static_cast<uint32_t>((k / S) & 1));
    for (int p = ac; p < E / 2; p += S1B_RT) {
      const int e = 2 * p, gi = e / C3W, c = e % C3W;
      const int2 rr = *reinterpret_cast<const int2*>(IX + e);
      const uint32_t dw = *reinterpret_cast<const uint32_t*>(DP + e);
      const float2 dv = unpack_bf16(dw);
      const uint32_t val = pack_bf16(__fmul_rn(dv.x, v[2 * CW + c]),
                                     __fmul_rn(dv.y, v[2 * CW + c + 1]));
      const uint32_t old = *reinterpret_cast<const uint32_t*>(pb + e);
      uint32_t pos = 0u, w[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = q ? rr.y : rr.x;
        const int lr = upt > 1 ? r - j * U : gi * pool + r;
        const int key = r < pool && lr >= 0 && lr < U ? lr : DEAD;
        const uint32_t was = (old >> (16 * q)) & 0xffffu;
        if (was != S1B_NONE) Db[was] = __float2bfloat16_rn(0.f);
        const uint32_t at =
            key != DEAD ? static_cast<uint32_t>(core_k256(key, c + q))
                        : S1B_NONE;
        if (key != DEAD)
          reinterpret_cast<uint16_t*>(Db)[at] =
              static_cast<uint16_t>(val >> (16 * q));
        pos |= at << (16 * q);
        w[q] = (static_cast<uint32_t>(key) << 16) |
               ((dw >> (16 * q)) & 0xffffu);
      }
      *reinterpret_cast<uint32_t*>(pb + e) = pos;
      *reinterpret_cast<uint2*>(ae + e) = make_uint2(w[0], w[1]);
    }
    fence_async_smem();               // D is read by wgmma (async proxy)
  };
  float a3[64] = {};
  double u3 = 0.0;
  if (count > 0) {
    entries(0);
    release(0);
  }
  named_sync(1, S1B_CT);
  for (int64_t i = 0; i < count; ++i) {
    if (i + 1 < count) {
      entries(i + 1);
      release(i + 1);
    }
    // A3 += dy3^T h2 and u3 over tile i's live entries.
    const int b = static_cast<int>(i & 1);
    const uint32_t* ae = a3es + b * E;
    const bf* Hb = H2 + b * U * LDB;
    float su = 0.f;
    for (int gi = 0; gi < gpt; ++gi) {
      const uint32_t w = ae[gi * C3W + ac];
      const int k = static_cast<int>(w >> 16);
      if (k != DEAD) {
        const float dv = __uint_as_float(w << 16);
        const uint4* hrow = reinterpret_cast<const uint4*>(Hb + k * LDB);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const uint4 u = hrow[q];
          const uint32_t hw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int z = 0; z < 4; ++z) {
            const float2 h = unpack_bf16(hw[z]);
            a3[8 * q + 2 * z] = fmaf(dv, h.x, a3[8 * q + 2 * z]);
            a3[8 * q + 2 * z + 1] = fmaf(dv, h.y, a3[8 * q + 2 * z + 1]);
          }
        }
        su += dv;
      }
    }
    u3 += su;
    named_sync(1, S1B_CT);
  }

  double* pa = partA + ((int64_t)blockIdx.x * C3W + ac) * CW;
#pragma unroll
  for (int q = 0; q < 32; ++q)
    *reinterpret_cast<double2*>(pa + 2 * q) =
        make_double2(a3[2 * q], a3[2 * q + 1]);
  partu[(int64_t)blockIdx.x * C3W + ac] = u3;
}

// ---------------------------------------------------------------------
// B3 sweep 3 at bf16 (facl_sa_bwd_sweep3_bf16). Replaces
// facl_tpu/ops/pallas/sa_pair.py::_make_sweep3_pair_kernel (:461,
// pallas_call :835) at compute_dtype bfloat16: h1 recomputed from x by the
// bf16 chain (h1_pre_bf16, h1_pair<true>'s: the forward's masks bit for
// bit); dy1 =
// bf16([h1 > 0] (mq - (bf16(h1 bf16(M2)) + rc2))); per block [A1 | u1] =
// dy1^T [x | 1] (the twin: ops/sa_pair.py::sa_bwd_sweep3_bf16_plain).
//
// Bound on the card at the main path: 0.106 ms by bytes (x and mq in: 136
// B a row). The form this replaces (the f32 design at bf16) ran TF32
// m16n8k8 products on f32 hi/lo tiles whose lo half was zero, with h1
// through a shared tile and dy1^T's fragments gathered by shuffles. Here
// every warp works alone on 16-row steps, so the loop has no block
// barrier: its mq rows (padded, stride LDB) and x rows arrive by cp.async
// into its own three stages, two steps in flight. The warp makes h1 for
// its rows g, g + 8 in registers (h1_pre_bf16), each k16 step's A
// fragment as it goes (C of two n-tiles is A of a k16 step), and runs h1
// bf16(M2) as mma.sync m16n8k16 bf16, bf16(M2)'s B fragments by ldmatrix
// from a padded tile; dy1 is formed in the accumulators' places (mq's
// fragments by ldmatrix) and rounded in pairs; [A1 | u1] = dy1^T [x | 1 |
// 0] is one more m16n8k16 product per 16 channels, its A fragments dy1
// transposed in registers by movmatrix.trans, its B [x | 1 | 0] read as
// bf16 pairs of the staged channel-major x, accumulated in f32 over the
// warp's steps; the 16 warps' sums are added in order, in float64, at
// the end. h1's CUDA-core chain is most of the work and its latency wants
// warps: 512 threads (bf16(M2)'s fragments held in registers instead
// allowed 256, and h1 ran at about half this rate).
constexpr int S3B_NT = 512;
constexpr int S3B_WARPS = S3B_NT / 32;
constexpr int S3B_STAGES = 3;
constexpr int S3B_STAGE = 16 * LDB + C0MAX * 16;   // bf16: mq | x

__device__ __forceinline__ uint32_t transpose8x8(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(d)
               : "r"(a));
  return d;
}

__global__ void __launch_bounds__(S3B_NT, 1)
bwd_sweep3_bf16_kernel(const __nv_bfloat16* __restrict__ x, int C0,
                       int64_t N, int64_t R, const float* __restrict__ W1,
                       const float* __restrict__ vec,
                       const __nv_bfloat16* __restrict__ mq,
                       const float* __restrict__ M2,
                       double* __restrict__ part) {
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smb[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf* stage = reinterpret_cast<bf*>(smb) + warp * S3B_STAGES * S3B_STAGE;
  bf* Ms = reinterpret_cast<bf*>(smb) + S3B_WARPS * S3B_STAGES * S3B_STAGE;
  float* W1s = reinterpret_cast<float*>(Ms + CW * LDB);   // bf16(M2) [k][n]
  float* v = W1s + C0MAX * CW;              // bf16(b1) | mul1 | shift1 | rc2
  const float* rc2 = v + 3 * CW;
  // The warp's 16-row steps, strided over all warps of the grid.
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * S3B_WARPS + warp;
  const int64_t nw = static_cast<int64_t>(gridDim.x) * S3B_WARPS;
  const int64_t count = R / 16 > gw ? (R / 16 - 1 - gw) / nw + 1 : 0;
  // x in 16-byte copies of 8 rows (one cloud: N % 8 == 0), else by loads.
  const bool xvec = N % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto fetch = [&](int64_t i) {     // the warp's copies of its step i
    if (i < count) {
      bf* Sg = stage + (i % S3B_STAGES) * S3B_STAGE;
      const int64_t r0 = (gw + i * nw) * 16;
      for (int e = lane; e < 16 * 8; e += 32) {
        const int r = e >> 3, c = (e & 7) << 3;
        cp_async16(Sg + r * LDB + c, mq + (r0 + r) * CW + c);
      }
      bf* X = Sg + 16 * LDB;                // (C0MAX, 16) channel-major
      if (xvec) {
        if (lane < 2 * C0) {
          const int c = lane >> 1, h = lane & 1;
          const int64_t r = r0 + 8 * h, b = r / N, n = r - b * N;
          cp_async16(X + c * 16 + 8 * h, x + (b * C0 + c) * N + n);
        }
      } else {
        for (int e = lane; e < C0 * 16; e += 32) {
          const int c = e >> 4, j = e & 15;
          const int64_t r = r0 + j, b = r / N, n = r - b * N;
          X[c * 16 + j] = x[(b * C0 + c) * N + n];
        }
      }
    }
    cp_async_commit();
  };

  for (int i = 0; i < S3B_STAGES - 1; ++i) fetch(i);
  for (int e = threadIdx.x; e < C0 * CW; e += S3B_NT) W1s[e] = rb(W1[e]);
  for (int e = threadIdx.x; e < 4 * CW; e += S3B_NT)
    v[e] = e < CW ? rb(vec[e]) : vec[e];
  for (int e = threadIdx.x; e < CW * CW; e += S3B_NT)
    Ms[(e >> 6) * LDB + (e & 63)] = __float2bfloat16_rn(M2[e]);
  __syncthreads();

  // [A1 | u1]: channels 16 mt + g (+8), columns 2t (+1) of [x | 1 | 0].
  float acc[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) zero4(acc[mt]);
  for (int64_t i = 0; i < count; ++i) {
    cp_async_wait<S3B_STAGES - 2>();
    __syncwarp();
    fetch(i + S3B_STAGES - 1);
    const bf* Sg = stage + (i % S3B_STAGES) * S3B_STAGE;
    const bf* X = Sg + 16 * LDB;
    float xa[C0MAX - 1], xb[C0MAX - 1];
#pragma unroll
    for (int k = 0; k < C0MAX - 1; ++k)
      if (k < C0) {
        xa[k] = to_f(X[k * 16 + g]);
        xb[k] = to_f(X[k * 16 + g + 8]);
      }
    // h1 bf16(M2): h1 (rows g, g + 8, columns 8 j + 2t (+1)) made by the
    // bf16 chain (h1_pre_bf16, then the ReLU on the packed pair) as each
    // k16 step's A fragment; its mask, bit 4 j + 2 h + e.
    float c[8][4];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) zero4(c[nj]);
    uint32_t m1 = 0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int jc = 2 * kk + jj;
        uint32_t pa, pb, ma, mbit;
        float2 f;
        h1_pre_bf16(xa, xb, C0, W1s, v, 8 * jc + 2 * t, pa, pb);
        a[2 * jj] = relu_packed(pa, f, ma);
        a[2 * jj + 1] = relu_packed(pb, f, mbit);
        m1 |= (ma | (mbit << 2)) << (4 * jc);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4t(b, b_rows_at(Ms, 16 * np, 16 * kk, lane));
        mma_bf16(c[2 * np], a, b[0], b[1]);
        mma_bf16(c[2 * np + 1], a, b[2], b[3]);
      }
    }
    // dy1 = bf16([h1 > 0] (mq - (bf16(h1 M2) + rc2))) in the accumulators'
    // places (rows g + 8 h, columns 8 nj + 2t (+1)), mq's by ldmatrix.
    uint32_t qf[4][4], dy[8][2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldsm4(qf[kk], a_rows_at(Sg, 0, 16 * kk, lane));
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const float2 rc = ld2(rc2 + 8 * nj + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 qv = unpack_bf16(qf[nj >> 1][2 * (nj & 1) + h]);
        const float2 hm =
            unpack_bf16(pack_bf16(c[nj][2 * h], c[nj][2 * h + 1]));
        const uint32_t mk = m1 >> (4 * nj + 2 * h);
        dy[nj][h] = pack_bf16(
            (mk & 1u) ? __fsub_rn(qv.x, __fadd_rn(hm.x, rc.x)) : 0.f,
            (mk & 2u) ? __fsub_rn(qv.y, __fadd_rn(hm.y, rc.y)) : 0.f);
      }
    }
    // [A1 | u1] += dy1^T [x | 1 | 0] over the 16 rows: A (channel, row)
    // is dy1 transposed (movmatrix), B (row, column g) x's pairs of rows.
    uint32_t b0 = 0u, b1 = 0u;
    if (g < C0) {
      b0 = *reinterpret_cast<const uint32_t*>(X + g * 16 + 2 * t);
      b1 = *reinterpret_cast<const uint32_t*>(X + g * 16 + 8 + 2 * t);
    } else if (g == C0) {
      b0 = b1 = 0x3f803f80u;              // bf16 1.0, twice
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const uint32_t a[4] = {
          transpose8x8(dy[2 * mt][0]), transpose8x8(dy[2 * mt + 1][0]),
          transpose8x8(dy[2 * mt][1]), transpose8x8(dy[2 * mt + 1][1])};
      mma_bf16(acc[mt], a, b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The eight warps' partials summed in order (staged in the stages).
  double* red = reinterpret_cast<double*>(smb);    // (warps, CW, 8)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      red[(warp * CW + 16 * mt + g + 8 * (q >> 1)) * 8 + 2 * t + (q & 1)] =
          acc[mt][q];
  __syncthreads();
  const int ne = CW * (C0 + 1);
  for (int e = threadIdx.x; e < ne; e += S3B_NT) {
    const int jc = e / (C0 + 1), col = e % (C0 + 1);
    double sum = 0.0;
    for (int w = 0; w < S3B_WARPS; ++w) sum += red[(w * CW + jc) * 8 + col];
    part[(int64_t)blockIdx.x * ne + e] = sum;
  }
}

// Every launcher: grid = nblk persistent blocks over R / 64 row tiles;
// returns cudaGetLastError() (0 on success). Each sweep has an f32 entry
// point (facl_sa_*) and a bf16 one (facl_sa_*_bf16: x, p2, q3, mq and
// B2b's max/min stored as bf16), the two explicit specialisations of its
// launcher: <false> launches the f32 kernel, <true> the bf16 one.
template <bool BF>
int launch_fwd_layer12(const void* x, int B, int C0, int N, const float* W1,
                       const float* vec1, const float* W2, const float* b2,
                       void* p2, double* part, int nblk, void* stream);
template <bool BF>
int launch_fwd_gram_pool(const void* p2, int64_t R, int pool,
                         const float* vec2, const float* W3, const float* b3,
                         double* partG, double* partc, void* mx, void* mn,
                         int* imx, int* imn, int nblk, void* stream);
template <bool BF>
int launch_bwd_sweep1(const void* p2, int64_t R, int pool, const float* vec2,
                      const void* dpooled, const int* idx, const float* gi3,
                      const float* W3, void* q3, double* partA, double* partu,
                      int nblk, void* stream);
template <bool BF>
int launch_bwd_sweep2(const void* x, int B, int C0, int N, const float* W1,
                      const float* vec, const void* p2, const void* q3,
                      const float* M3, const float* W2, void* mq,
                      double* partA, double* partG, double* partu,
                      double* partc, int nblk, void* stream);
template <bool BF>
int launch_bwd_sweep3(const void* x, int B, int C0, int N, const float* W1,
                      const float* vec, const void* mq, const float* M2,
                      double* part, int nblk, void* stream);

// The f32 entry points.
template <>
int launch_fwd_layer12<false>(const void* x, int B, int C0, int N,
                              const float* W1, const float* vec1,
                              const float* W2, const float* b2, void* p2,
                              double* part, int nblk, void* stream) {
  const int64_t R = (int64_t)B * N;
  if (bad_shape(C0, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (3 * 32 * b_stride(CW) + C0MAX * CW + 4 * CW +
                       L12_WARPS * 2 * C0MAX * TR) +
      L12_WARPS * 2 * sizeof(uint64_t);
  cudaError_t e = prepare(fwd_layer12_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_layer12_kernel<<<nblk, NTM, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), C0, N, R / TR, W1, vec1, W2, b2,
      static_cast<float*>(p2), part);
  return static_cast<int>(cudaGetLastError());
}

template <>
int launch_fwd_gram_pool<false>(const void* p2, int64_t R, int pool,
                                const float* vec2, const float* W3,
                                const float* b3, double* partG, double* partc,
                                void* mx, void* mn, int* imx, int* imn,
                                int nblk, void* stream) {
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
      static_cast<const float*>(p2), R / TR, upt, vec2, W3, b3, partG, partc,
      static_cast<float*>(mx), static_cast<float*>(mn), imx, imn);
  return static_cast<int>(cudaGetLastError());
}

template <>
int launch_bwd_sweep1<false>(const void* p2, int64_t R, int pool,
                             const float* vec2, const void* dpooled,
                             const int* idx, const float* gi3,
                             const float* W3, void* q3, double* partA,
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
      static_cast<const float*>(p2), R / U, U, pool, S, vec2,
      static_cast<const float*>(dpooled), idx, gi3, W3,
      static_cast<float*>(q3), partA, partu);
  return static_cast<int>(cudaGetLastError());
}

template <>
int launch_bwd_sweep2<false>(const void* x, int B, int C0, int N,
                             const float* W1, const float* vec, const void* p2,
                             const void* q3, const float* M3, const float* W2,
                             void* mq, double* partA, double* partG,
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
  bwd_sweep2_kernel<<<nblk, NTM, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), C0, N, R / TR, W1, vec,
      static_cast<const float*>(p2), static_cast<const float*>(q3), M3, W2,
      static_cast<float*>(mq), partA, partG, partu, partc);
  return static_cast<int>(cudaGetLastError());
}

template <>
int launch_bwd_sweep3<false>(const void* x, int B, int C0, int N,
                             const float* W1, const float* vec, const void* mq,
                             const float* M2, double* part, int nblk,
                             void* stream) {
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
      static_cast<const float*>(x), C0, N, R / TR, W1, vec,
      static_cast<const float*>(mq), M2, part);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 entry points launch the bf16 designs (kernels of their own).
template <>
int launch_fwd_layer12<true>(const void* x, int B, int C0, int N,
                             const float* W1, const float* vec1,
                             const float* W2, const float* b2, void* p2,
                             double* part, int nblk, void* stream) {
  using T = __nv_bfloat16;
  const int64_t R = (int64_t)B * N;
  if (bad_shape(C0, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(T) * (CW * LDB + L12B_WARPS * (L12B_ROWS * LDB +
                                            L12B_STAGES * L12B_XS)) +
      sizeof(float) * (CW / 2 * L12B_PP + CW);
  decltype(&fwd_layer12_bf16_kernel<4>) kern =
      C0 <= 4 ? fwd_layer12_bf16_kernel<4>
              : fwd_layer12_bf16_kernel<C0MAX - 1>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<nblk, L12B_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), C0, N, R, W1, vec1, W2, b2,
      static_cast<T*>(p2), part);
  return static_cast<int>(cudaGetLastError());
}

template <>
int launch_fwd_gram_pool<true>(const void* p2, int64_t R, int pool,
                               const float* vec2, const float* W3,
                               const float* b3, double* partG, double* partc,
                               void* mx, void* mn, int* imx, int* imn,
                               int nblk, void* stream) {
  using T = __nv_bfloat16;
  if (bad_pool(R, pool)) return static_cast<int>(cudaErrorInvalidValue);
  const int upt = pool > TR ? pool / TR : 1;
  int lp = 0;
  while ((1 << lp) < pool && lp < 6) ++lp;      // log2(min(pool, TR))
  const size_t smem = sizeof(T) * (GPB_STAGES * TR * CW + 2 * TR * LDB) +
                      sizeof(float) * (2 * CW + 5 * C3W) +
                      GPB_STAGES * sizeof(uint64_t);
  decltype(&fwd_gram_pool_bf16_kernel<0>) kern;
  switch (lp) {
    case 0: kern = fwd_gram_pool_bf16_kernel<0>; break;
    case 1: kern = fwd_gram_pool_bf16_kernel<1>; break;
    case 2: kern = fwd_gram_pool_bf16_kernel<2>; break;
    case 3: kern = fwd_gram_pool_bf16_kernel<3>; break;
    case 4: kern = fwd_gram_pool_bf16_kernel<4>; break;
    case 5: kern = fwd_gram_pool_bf16_kernel<5>; break;
    default: kern = fwd_gram_pool_bf16_kernel<6>; break;
  }
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<nblk, GPB_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p2), R / TR, upt, vec2, W3, b3, partG, partc,
      static_cast<T*>(mx), static_cast<T*>(mn), imx, imn);
  return static_cast<int>(cudaGetLastError());
}

template <>
int launch_bwd_sweep2<true>(const void* x, int B, int C0, int N,
                            const float* W1, const float* vec, const void* p2,
                            const void* q3, const float* M3, const float* W2,
                            void* mq, double* partA, double* partG,
                            double* partu, double* partc, int nblk,
                            void* stream) {
  using T = __nv_bfloat16;
  const int64_t R = (int64_t)B * N;
  if (bad_shape(C0, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(T) * (S2B_STAGES * S2B_STAGE + 4 * S2B_TILE + 2 * CW * LDB) +
      sizeof(float) * (C0MAX * CW + 7 * CW);
  cudaError_t e = prepare(bwd_sweep2_bf16_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_sweep2_bf16_kernel<<<nblk, S2B_NT, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), C0, N, R, W1, vec,
      static_cast<const T*>(p2), static_cast<const T*>(q3), M3, W2,
      static_cast<T*>(mq), partA, partG, partu, partc);
  return static_cast<int>(cudaGetLastError());
}

template <>
int launch_bwd_sweep1<true>(const void* p2, int64_t R, int pool,
                            const float* vec2, const void* dpooled,
                            const int* idx, const float* gi3,
                            const float* W3, void* q3, double* partA,
                            double* partu, int nblk, void* stream) {
  using T = __nv_bfloat16;
  if (bad_pool(R, pool)) return static_cast<int>(cudaErrorInvalidValue);
  const int U = sweep1_rows(pool);
  const int gpt = pool <= U ? U / pool : 1;
  int S = S1B_STAGES;                 // stages: as many as fit
  while (S > 0 && s1b_layout(U, gpt, S).total > MAX_SMEM) --S;
  if (S == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = s1b_layout(U, gpt, S).total;
  cudaError_t e = prepare(bwd_sweep1_bf16_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_sweep1_bf16_kernel<<<nblk, S1B_NT, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p2), R / U, U, pool, S, vec2,
      static_cast<const T*>(dpooled), idx, gi3, W3, static_cast<T*>(q3),
      partA, partu);
  return static_cast<int>(cudaGetLastError());
}

template <>
int launch_bwd_sweep3<true>(const void* x, int B, int C0, int N,
                            const float* W1, const float* vec, const void* mq,
                            const float* M2, double* part, int nblk,
                            void* stream) {
  using T = __nv_bfloat16;
  const int64_t R = (int64_t)B * N;
  if (bad_shape(C0, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(T) * (S3B_WARPS * S3B_STAGES * S3B_STAGE +
                                   CW * LDB) +
                      sizeof(float) * (C0MAX * CW + 4 * CW);
  cudaError_t e = prepare(bwd_sweep3_bf16_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_sweep3_bf16_kernel<<<nblk, S3B_NT, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), C0, N, R, W1, vec,
      static_cast<const T*>(mq), M2, part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FACL_SA_ENTRY(name, sfx, bf, params, args)            \
  extern "C" int facl_sa_##name##sfx params {                 \
    return launch_##name<bf> args;                            \
  }
#define FACL_SA_ENTRIES(name, params, args) \
  FACL_SA_ENTRY(name, , false, params, args) \
  FACL_SA_ENTRY(name, _bf16, true, params, args)

FACL_SA_ENTRIES(fwd_layer12,
                (const void* x, int B, int C0, int N, const float* W1,
                 const float* vec1, const float* W2, const float* b2,
                 void* p2, double* part, int nblk, void* stream),
                (x, B, C0, N, W1, vec1, W2, b2, p2, part, nblk, stream))
FACL_SA_ENTRIES(fwd_gram_pool,
                (const void* p2, int64_t R, int pool, const float* vec2,
                 const float* W3, const float* b3, double* partG,
                 double* partc, void* mx, void* mn, int* imx, int* imn,
                 int nblk, void* stream),
                (p2, R, pool, vec2, W3, b3, partG, partc, mx, mn, imx, imn,
                 nblk, stream))
FACL_SA_ENTRIES(bwd_sweep1,
                (const void* p2, int64_t R, int pool, const float* vec2,
                 const void* dpooled, const int* idx, const float* gi3,
                 const float* W3, void* q3, double* partA, double* partu,
                 int nblk, void* stream),
                (p2, R, pool, vec2, dpooled, idx, gi3, W3, q3, partA, partu,
                 nblk, stream))
FACL_SA_ENTRIES(bwd_sweep2,
                (const void* x, int B, int C0, int N, const float* W1,
                 const float* vec, const void* p2, const void* q3,
                 const float* M3, const float* W2, void* mq, double* partA,
                 double* partG, double* partu, double* partc, int nblk,
                 void* stream),
                (x, B, C0, N, W1, vec, p2, q3, M3, W2, mq, partA, partG,
                 partu, partc, nblk, stream))
FACL_SA_ENTRIES(bwd_sweep3,
                (const void* x, int B, int C0, int N, const float* W1,
                 const float* vec, const void* mq, const float* M2,
                 double* part, int nblk, void* stream),
                (x, B, C0, N, W1, vec, mq, M2, part, nblk, stream))
