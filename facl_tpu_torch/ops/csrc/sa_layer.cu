// B7a: the layer sweep of sa_impl="hybrid2"'s four-sweep forward, p = h W
// + b written (R, 64) with per-block sums of p and p^2, run twice a step:
//   x -> p1   (affine == 0): h = x, row-major (R, cin), 1 <= cin <= 7;
//   p1 -> p2  (affine == 1): h = relu(p1 mul1 + shift1), p1 (R, 64).
// Replaces facl_tpu/ops/pallas/sa_fwd.py::_make_layer_sweep (:65,
// pallas_call :189) at f32 (facl_sa_fwd_layer) and at compute_dtype
// bfloat16 (facl_sa_fwd_layer_bf16: x, p1 and p2 stored as bf16, W and b
// rounded to bf16, p = bf16(h bf16(W)) + bf16(b) summed in f32 for its
// moments before it is stored rounded; h = relu(bf16(p1 mul1 + shift1))).
// vec = [b | mul | shift] (3 x 64 f32); part: (blocks, 2, 64) float64 =
// [sum p | sum p^2], summed by the caller in a fixed order.
//
// Bounds on the card at the main path (R = 2,621,440 rows): every form by
// bytes. x -> p1 reads 2 C0 (bf16) or 4 C0 bytes a row and writes 128 or
// 256: 0.106 / 0.213 ms. p1 -> p2 reads and writes 64-wide rows: 0.200 /
// 0.401 ms; its product, 21.5 GFLOP, takes 0.022 ms at the bf16 tensor
// cores' rate and 0.32 ms on the f32 CUDA cores.
//
// Design: one 512-thread block an SM whose 16 warps walk their own row
// steps (strided over all warps of the grid) with no block barrier in the
// loop, so that one warp's copies overlap another's compute: each warp's
// input arrives by cp.async into its own stages, two steps ahead (x -> p1:
// three), and its output leaves in 16-byte evict-first stores that fill
// whole sectors.
// (The tile kernel this replaces, a 64-row tile a block with barriers
// between its load, product and store, ran at 2-7x these bounds.) The
// sums of p and p^2 are taken in f32 over the lane's rows of a step, then
// over the lanes holding the same columns by shuffles that halve what each
// lane keeps (f32), carried in float64 across steps; the 16 warps'
// partials are added in order at the end: runs are bit-identical.
//  - x -> p1 (layer_x_kernel<BF, C0>): a pure stream. A lane owns one
//    16-byte piece of a row (8 bf16 or 4 f32 columns) and keeps W's rows
//    and b for it in registers; p is the k-order FMA chain from +0 (at
//    bf16 each product exact in f32), then + b (at bf16 after rounding the
//    sum): the tile kernel's arithmetic, so p1 is its bit for bit.
//  - p1 -> p2 at bf16 (layer_p_bf16_kernel): each warp step is 32 rows,
//    two 16-row slices, on mma.sync m16n8k16 bf16. The staged p1 rows
//    (unpadded, 16-byte chunks XOR-swizzled by row) are read by ldmatrix
//    as A fragments and turned into h1 in registers, two values at a time
//    (the affine in f32, one rounding to bf16, the ReLU as a 16-bit integer
//    max: relu_packed's values but at a NaN); bf16(W2)'s B fragments come
//    by ldmatrix from a padded tile loaded once a block. p2 = bf16(acc) +
//    bf16(b2) in f32: its sums are taken from that unrounded value, and it
//    is stored rounded, staged by stmatrix into the step's own stage.
//  - p1 -> p2 at f32 (layer_p_f32_kernel): the exact k-order f32 FMA
//    chain on the CUDA cores, as the tile kernel summed it: p2 decides the
//    layer-2 ReLU masks of every later sweep, a padded row repeating each
//    decision up to K times, so its sums stay f32's own (6xTF32 on the
//    tensor cores, B2a's way, is the other that keeps them; 3xTF32 is not).
//    Each warp step is 16 rows; the staged p1 tile (stride 68 floats)
//    becomes h1 in place, then a lane computes a 4-row x 8-column tile:
//    per 4 k one 16-byte load of h1 a row and two of W2 a k, 12 shared
//    loads for 128 FMAs (the tile kernel: 2 for 1).
#include <cstdint>
#include "common.cuh"
#include "sa_mma.cuh"

namespace {

constexpr int LY_NT = 512;                 // threads: 16 warps
constexpr int LY_WARPS = LY_NT / 32;
constexpr int LY_STAGES = 3;               // a warp's p1 stages
constexpr int LX_STAGES = 4;               // a warp's x stages
constexpr int LX_ROWS = 32;                // rows of a step: x -> p1
constexpr int LX_XS = LX_ROWS * C0MAX;     // elements of an x stage
constexpr int LPB_ROWS = 32;               // p1 -> p2 at bf16
constexpr int LPB_STAGE = LPB_ROWS * CW;   // bf16 values of a stage
constexpr int LPF_ROWS = 16;               // p1 -> p2 at f32
constexpr int LPF_LD = 68;                 // its stage stride (floats)
constexpr int LPF_STAGE = LPF_ROWS * LPF_LD;

template <bool BF>
using RowT = typename Row<BF>::T;

// One step of a sum over lanes that halves what each lane keeps: the lane
// with bit m set keeps hi (plus its partner's), the other lo.
__device__ __forceinline__ void halve(float& lo, float& hi, int lane, int m) {
  const bool up = lane & m;
  const float send = up ? lo : hi;
  lo = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, m);
}

// A warp's steps of a sweep of nsteps, strided over all warps of the grid:
// the warp's step i is gw + i nw.
struct Walk {
  int64_t gw, nw, count;
};

__device__ __forceinline__ Walk warp_walk(int64_t nsteps) {
  const int64_t gw =
      static_cast<int64_t>(blockIdx.x) * LY_WARPS + (threadIdx.x >> 5);
  const int64_t nw = static_cast<int64_t>(gridDim.x) * LY_WARPS;
  return Walk{gw, nw, nsteps > gw ? (nsteps - 1 - gw) / nw + 1 : 0};
}

// The block's partials: each lane's run = [s, ss, s', ss'] of columns col,
// col + 1, the 16 warps' added in order into part[blockIdx.x] (2, 64).
// red: 2 x 16 x 64 doubles of shared memory that no thread reads any more.
__device__ __forceinline__ void block_sums(const double run[4], int col,
                                           double* red,
                                           double* __restrict__ part) {
  const int warp = threadIdx.x >> 5;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q)
    red[(warp * 2 + (q & 1)) * CW + col + (q >> 1)] = run[q];
  __syncthreads();
  if (threadIdx.x < 2 * CW) {
    const int q = threadIdx.x / CW, cl = threadIdx.x % CW;
    double a = 0.0;
    for (int w = 0; w < LY_WARPS; ++w) a += red[(w * 2 + q) * CW + cl];
    part[static_cast<int64_t>(blockIdx.x) * 2 * CW + threadIdx.x] = a;
  }
}

// A lane's sums of NC columns o[c] over its rows: v[2 c] (p), v[2 c + 1]
// (p^2).
template <int NC>
__device__ __forceinline__ void add_sums(float* v, const float* o,
                                         bool first) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (first) {
      v[2 * c] = o[c];
      v[2 * c + 1] = __fmul_rn(o[c], o[c]);
    } else {
      v[2 * c] = __fadd_rn(v[2 * c], o[c]);
      v[2 * c + 1] = fmaf(o[c], o[c], v[2 * c + 1]);
    }
  }
}

// 16-byte row stores, evict-first (st.global.cs): no sweep reads a row
// back before it has left the L2.
__device__ __forceinline__ void store_piece(float* dst, const float* o) {
  __stcs(reinterpret_cast<float4*>(dst),
         make_float4(o[0], o[1], o[2], o[3]));
}
__device__ __forceinline__ void store_piece(__nv_bfloat16* dst,
                                            const float* o) {
  __stcs(reinterpret_cast<uint4*>(dst),
         make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                    pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7])));
}

// ---------------------------------------------------------------------
// x -> p1. A 32-row step's x (64 C0 or 128 C0 bytes) arrives by cp.async
// into the warp's stage; lane (rq, j) computes the 16-byte piece j of rows
// rq + RPI q: NC columns, NC j.. .
template <bool BF, int C0>
__global__ void __launch_bounds__(LY_NT, 1)
layer_x_kernel(const RowT<BF>* __restrict__ x, int64_t R,
               const float* __restrict__ W, const float* __restrict__ vec,
               RowT<BF>* __restrict__ p, double* __restrict__ part) {
  using T = RowT<BF>;
  constexpr int NC = BF ? 8 : 4;            // columns of a lane's piece
  constexpr int LPR = CW / NC;              // lanes a row: 8 or 16
  constexpr int RPI = 32 / LPR;             // rows a warp store: 4 or 2
  constexpr int EPP = 16 / sizeof(T);       // elements of a 16-byte copy
  constexpr int PIECES = LX_ROWS * C0 / EPP;
  extern __shared__ __align__(128) unsigned char smx[];
  const int lane = threadIdx.x & 31;
  const int j = lane % LPR, rq = lane / LPR;
  T* xst = reinterpret_cast<T*>(smx) + (threadIdx.x >> 5) * LX_STAGES * LX_XS;
  const Walk wk = warp_walk(R / LX_ROWS);
  auto fetch = [&](int64_t i) {             // the warp's copies of step i
    if (i < wk.count) {
      const T* src = x + (wk.gw + i * wk.nw) * LX_ROWS * C0;
      T* dst = xst + (i % LX_STAGES) * LX_XS;
      for (int e = lane; e < PIECES; e += 32)
        cp_async16(dst + e * EPP, src + e * EPP);
    }
    cp_async_commit();
  };
  for (int i = 0; i < LX_STAGES - 1; ++i) fetch(i);
  float w[C0][NC], b[NC];                   // W's rows, b (bf16 at BF)
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int k = 0; k < C0; ++k) w[k][c] = rb_if<BF>(W[k * CW + NC * j + c]);
    b[c] = rb_if<BF>(vec[NC * j + c]);
  }

  double run[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t i = 0; i < wk.count; ++i) {
    cp_async_wait<LX_STAGES - 2>();
    __syncwarp();
    fetch(i + LX_STAGES - 1);
    const T* X = xst + (i % LX_STAGES) * LX_XS;
    T* out = p + (wk.gw + i * wk.nw) * LX_ROWS * CW + NC * j;
    float v[2 * NC];
#pragma unroll
    for (int q = 0; q < LX_ROWS / RPI; ++q) {
      const int r = rq + RPI * q;
      float xr[C0];
#pragma unroll
      for (int k = 0; k < C0; ++k) xr[k] = to_f(X[r * C0 + k]);
      float o[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < C0; ++k) acc = fmaf(xr[k], w[k][c], acc);
        o[c] = acc;
      }
      if constexpr (BF) {           // rb(acc), two values at a time
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          const float2 f = unpack_bf16(pack_bf16(o[c], o[c + 1]));
          o[c] = f.x;
          o[c + 1] = f.y;
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) o[c] = __fadd_rn(o[c], b[c]);
      add_sums<NC>(v, o, q == 0);
      store_piece(out + static_cast<int64_t>(r) * CW, o);
    }
    // Over the lanes of piece j (the row bits of the lane): each keeps two
    // of its columns' [s, ss].
    if constexpr (BF) {
#pragma unroll
      for (int q = 0; q < 8; ++q) halve(v[q], v[8 + q], lane, 16);
#pragma unroll
      for (int q = 0; q < 4; ++q) halve(v[q], v[4 + q], lane, 8);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) halve(v[q], v[4 + q], lane, 16);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) run[q] += v[q];
  }
  cp_async_wait<0>();
  const int col = BF ? NC * j + 4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1)
                     : NC * j + 2 * ((lane >> 4) & 1);
  block_sums(run, col, reinterpret_cast<double*>(smx), part);
}

// ---------------------------------------------------------------------
// p1 -> p2 at bf16 on mma.sync m16n8k16. The place of 16-byte chunk c
// (0..7) of row r of a (rows, 64) bf16 stage: chunks XOR-swizzled by the
// row, so that the eight rows an ldmatrix or stmatrix phase touches fall
// in eight different bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * CW + 8 * (c ^ (r & 7));
}

__global__ void __launch_bounds__(LY_NT, 1)
layer_p_bf16_kernel(const __nv_bfloat16* __restrict__ p1, int64_t R,
                    const float* __restrict__ W2,
                    const float* __restrict__ vec,
                    __nv_bfloat16* __restrict__ p2,
                    double* __restrict__ part) {
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smb[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf* Ws = reinterpret_cast<bf*>(smb);                  // bf16(W2) [k][n]
  float* prm = reinterpret_cast<float*>(Ws + CW * LDB);  // mul1|shift1|b2
  bf* stages = reinterpret_cast<bf*>(prm + 3 * CW) +
               warp * LY_STAGES * LPB_STAGE;
  const Walk wk = warp_walk(R / LPB_ROWS);
  auto fetch = [&](int64_t i) {             // the warp's copies of step i
    if (i < wk.count) {
      const bf* src = p1 + (wk.gw + i * wk.nw) * LPB_ROWS * CW;
      bf* dst = stages + (i % LY_STAGES) * LPB_STAGE;
#pragma unroll
      for (int q = 0; q < LPB_ROWS * CW / 8 / 32; ++q) {
        const int e = lane + 32 * q, r = e >> 3, c = e & 7;
        cp_async16(dst + swz(r, c), src + r * CW + 8 * c);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < LY_STAGES - 1; ++i) fetch(i);
  for (int e = threadIdx.x; e < CW * CW; e += LY_NT)
    Ws[(e >> 6) * LDB + (e & 63)] = __float2bfloat16_rn(W2[e]);
  for (int e = threadIdx.x; e < CW; e += LY_NT) {
    prm[e] = vec[CW + e];                   // mul1
    prm[CW + e] = vec[2 * CW + e];          // shift1
    prm[2 * CW + e] = rb(vec[e]);           // bf16(b2)
  }
  __syncthreads();

  // Sums of p2 and p2^2 of columns 8 g + 2 t (+1): [s, ss, s', ss'].
  double run[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t i = 0; i < wk.count; ++i) {
    cp_async_wait<LY_STAGES - 2>();
    __syncwarp();
    fetch(i + LY_STAGES - 1);
    bf* S = stages + (i % LY_STAGES) * LPB_STAGE;
    // h1 bf16(W2) for both 16-row slices: the A fragment of slice s at
    // k16 step kk is h1 at its rows g, g + 8 and columns 16 kk + 8 (q / 2)
    // + 2t (+1), made from p1's by the affine, one rounding and the ReLU.
    float c[2][8][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) zero4(c[s][nj]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        ldsm4(a[s], S + swz(16 * s + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cc = 16 * kk + 8 * (q >> 1) + 2 * t;
          const float2 u = unpack_bf16(a[s][q]);
          const float2 m = ld2(prm + cc), sh = ld2(prm + CW + cc);
          a[s][q] = __vmaxs2(pack_bf16(__fadd_rn(__fmul_rn(u.x, m.x), sh.x),
                                       __fadd_rn(__fmul_rn(u.y, m.y), sh.y)),
                             0u);
        }
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
    __syncwarp();                 // every lane's p1 fragments are read
    // p2 = bf16(acc) + bf16(b2), staged by n-tile pairs (stmatrix: slice
    // s's rows, columns 16 q..) over the step's p1; the lane's sums over
    // its four rows, per column 8 nj + 2t (+1): vs[4 nj ..] = [s, ss, s',
    // ss'].
    float vs[32];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t st[2][4];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int nj = 2 * q + jn;
        const float2 bb = ld2(prm + 2 * CW + 8 * nj + 2 * t);
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 f = unpack_bf16(
                pack_bf16(c[s][nj][2 * h], c[s][nj][2 * h + 1]));
            const float2 u = make_float2(__fadd_rn(f.x, bb.x),
                                         __fadd_rn(f.y, bb.y));
            st[s][2 * jn + h] = pack_bf16(u.x, u.y);
            const float o[2] = {u.x, u.y};
            add_sums<2>(vs + 4 * nj, o, s == 0 && h == 0);
          }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s)             // a_rows_at's rows and chunks
        stsm4(S + swz(16 * s + (lane & 15), 2 * q + (lane >> 4)), st[s]);
    }
    // Over the eight g lanes: lane (g, t) ends with n-tile g's vs[0..3].
#pragma unroll
    for (int q = 0; q < 16; ++q) halve(vs[q], vs[16 + q], lane, 16);
#pragma unroll
    for (int q = 0; q < 8; ++q) halve(vs[q], vs[8 + q], lane, 8);
#pragma unroll
    for (int q = 0; q < 4; ++q) halve(vs[q], vs[4 + q], lane, 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) run[q] += vs[q];
    // The staged rows leave in 16-byte stores: four whole rows a warp
    // store.
    __syncwarp();
    bf* out = p2 + (wk.gw + i * wk.nw) * LPB_ROWS * CW;
#pragma unroll
    for (int q = 0; q < LPB_ROWS / 4; ++q) {
      const int r = 4 * q + (lane >> 3), ch = lane & 7;
      __stcs(reinterpret_cast<uint4*>(out + r * CW + 8 * ch),
             *reinterpret_cast<const uint4*>(S + swz(r, ch)));
    }
  }
  cp_async_wait<0>();
  block_sums(run, 8 * g + 2 * t, reinterpret_cast<double*>(smb), part);
}

// ---------------------------------------------------------------------
// p1 -> p2 at f32 on the CUDA cores: lane (rg, cg) = (lane / 8, lane % 8)
// owns rows rg + 4 i (i < 4) of a 16-row step and columns 4 cg.. and 32 +
// 4 cg.., summed in k order by FMAs from +0.
__global__ void __launch_bounds__(LY_NT, 1)
layer_p_f32_kernel(const float* __restrict__ p1, int64_t R,
                   const float* __restrict__ W2,
                   const float* __restrict__ vec, float* __restrict__ p2,
                   double* __restrict__ part) {
  extern __shared__ __align__(128) float smf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, cg = lane & 7;
  float* Ws = smf;                          // W2 [k][n]
  float* prm = Ws + CW * CW;                // b2 | mul1 | shift1
  float* stages = prm + 3 * CW + warp * LY_STAGES * LPF_STAGE;
  const Walk wk = warp_walk(R / LPF_ROWS);
  auto fetch = [&](int64_t i) {             // the warp's copies of step i
    if (i < wk.count) {
      const float* src = p1 + (wk.gw + i * wk.nw) * LPF_ROWS * CW;
      float* dst = stages + (i % LY_STAGES) * LPF_STAGE;
#pragma unroll
      for (int q = 0; q < LPF_ROWS * CW / 4 / 32; ++q) {
        const int e = lane + 32 * q, r = e >> 4, c = e & 15;
        cp_async16(dst + r * LPF_LD + 4 * c, src + r * CW + 4 * c);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < LY_STAGES - 1; ++i) fetch(i);
  for (int e = threadIdx.x; e < CW * CW; e += LY_NT) Ws[e] = W2[e];
  for (int e = threadIdx.x; e < 3 * CW; e += LY_NT) prm[e] = vec[e];
  __syncthreads();
  // The lane's piece of the h1 pass (columns 4 (lane % 16)..) and its b2.
  const int hc = 4 * (lane & 15);
  const float4 m1 = *reinterpret_cast<const float4*>(prm + CW + hc);
  const float4 s1 = *reinterpret_cast<const float4*>(prm + 2 * CW + hc);
  float b2[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) b2[c] = prm[(c >> 2) * 32 + 4 * cg + (c & 3)];

  double run[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t i = 0; i < wk.count; ++i) {
    cp_async_wait<LY_STAGES - 2>();
    __syncwarp();
    fetch(i + LY_STAGES - 1);
    float* H = stages + (i % LY_STAGES) * LPF_STAGE;
    // h1 = relu(p1 mul1 + shift1) in place (sa_tile.cuh's relu_affine).
#pragma unroll
    for (int q = 0; q < LPF_ROWS / 2; ++q) {
      float4* h = reinterpret_cast<float4*>(H + ((lane >> 4) + 2 * q) *
                                                LPF_LD + hc);
      float4 u = *h;
      u.x = relu_affine(u.x, m1.x, s1.x);
      u.y = relu_affine(u.y, m1.y, s1.y);
      u.z = relu_affine(u.z, m1.z, s1.z);
      u.w = relu_affine(u.w, m1.w, s1.w);
      *h = u;
    }
    __syncwarp();
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 2
    for (int k4 = 0; k4 < CW / 4; ++k4) {
      float4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(H + (rg + 4 * r) * LPF_LD +
                                                4 * k4);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const float* wr = Ws + (4 * k4 + kq) * CW + 4 * cg;
        const float4 w0 = *reinterpret_cast<const float4*>(wr);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + 32);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float hv = kq == 0 ? a[r].x : kq == 1 ? a[r].y
                         : kq == 2 ? a[r].z : a[r].w;
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(hv, wv[c], acc[r][c]);
        }
      }
    }
    // p2 = acc + b2, stored from the registers (two 16-byte pieces a row);
    // the lane's sums over its four rows, per column c: v[2 c], v[2 c + 1].
    float* out = p2 + (wk.gw + i * wk.nw) * LPF_ROWS * CW + 4 * cg;
    float v[16];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float o[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) o[c] = __fadd_rn(acc[r][c], b2[c]);
      add_sums<8>(v, o, r == 0);
      store_piece(out + (rg + 4 * r) * CW, o);
      store_piece(out + (rg + 4 * r) * CW + 32, o + 4);
    }
    // Over the four rg lanes: each keeps two of its columns' [s, ss].
#pragma unroll
    for (int q = 0; q < 8; ++q) halve(v[q], v[8 + q], lane, 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) halve(v[q], v[4 + q], lane, 8);
#pragma unroll
    for (int q = 0; q < 4; ++q) run[q] += v[q];
  }
  cp_async_wait<0>();
  block_sums(run, 32 * ((lane >> 4) & 1) + 4 * cg + 2 * ((lane >> 3) & 1),
             reinterpret_cast<double*>(smf), part);
}

// -- launchers ---------------------------------------------------------

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool BF, int C0>
int launch_x(const RowT<BF>* x, int64_t R, const float* W, const float* vec,
             RowT<BF>* p, double* part, int nblk, cudaStream_t st) {
  const size_t smem = sizeof(RowT<BF>) * LY_WARPS * LX_STAGES * LX_XS;
  cudaError_t e = prepare(layer_x_kernel<BF, C0>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  layer_x_kernel<BF, C0><<<nblk, LY_NT, smem, st>>>(x, R, W, vec, p, part);
  return static_cast<int>(cudaGetLastError());
}

int launch_p(const __nv_bfloat16* p1, int64_t R, const float* W2,
             const float* vec, __nv_bfloat16* p2, double* part, int nblk,
             cudaStream_t st) {
  const size_t smem = sizeof(__nv_bfloat16) * CW * LDB +
                      sizeof(float) * 3 * CW +
                      sizeof(__nv_bfloat16) * LY_WARPS * LY_STAGES *
                          LPB_STAGE;
  cudaError_t e = prepare(layer_p_bf16_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  layer_p_bf16_kernel<<<nblk, LY_NT, smem, st>>>(p1, R, W2, vec, p2, part);
  return static_cast<int>(cudaGetLastError());
}

int launch_p(const float* p1, int64_t R, const float* W2, const float* vec,
             float* p2, double* part, int nblk, cudaStream_t st) {
  const size_t smem = sizeof(float) * (CW * CW + 3 * CW +
                                       LY_WARPS * LY_STAGES * LPF_STAGE);
  cudaError_t e = prepare(layer_p_f32_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  layer_p_f32_kernel<<<nblk, LY_NT, smem, st>>>(p1, R, W2, vec, p2, part);
  return static_cast<int>(cudaGetLastError());
}

// affine == 1: p1 -> p2 (cin == 64); affine == 0: x -> p1 (1 <= cin <= 7).
// One 512-thread block an SM (nblk); in and p 16-byte aligned (cp.async
// and 16-byte stores).
template <bool BF>
int launch_layer(const RowT<BF>* in, int64_t R, int cin, int affine,
                 const float* W, const float* vec, RowT<BF>* p, double* part,
                 int nblk, void* stream) {
  if (R % TR != 0 || nblk < 1 || !aligned16(in) || !aligned16(p) ||
      (affine ? cin != CW : cin < 1 || cin > C0MAX - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (affine) return launch_p(in, R, W, vec, p, part, nblk, st);
#define LX_LAUNCH(C) return launch_x<BF, C>(in, R, W, vec, p, part, nblk, st)
  switch (cin) {
    case 1: LX_LAUNCH(1);
    case 2: LX_LAUNCH(2);
    case 3: LX_LAUNCH(3);
    case 4: LX_LAUNCH(4);
    case 5: LX_LAUNCH(5);
    case 6: LX_LAUNCH(6);
    default: LX_LAUNCH(7);
  }
#undef LX_LAUNCH
}

}  // namespace

// nblk persistent blocks; returns cudaGetLastError() (0 on success). The
// _bf16 entry point takes the row tensors as bf16 and the same f32
// parameters.
using bf16_t = __nv_bfloat16;

extern "C" int facl_sa_fwd_layer(const float* in, int64_t R, int cin,
                                 int affine, const float* W, const float* vec,
                                 float* p, double* part, int nblk,
                                 void* stream) {
  return launch_layer<false>(in, R, cin, affine, W, vec, p, part, nblk,
                             stream);
}

extern "C" int facl_sa_fwd_layer_bf16(const bf16_t* in, int64_t R, int cin,
                                      int affine, const float* W,
                                      const float* vec, bf16_t* p,
                                      double* part, int nblk, void* stream) {
  return launch_layer<true>(in, R, cin, affine, W, vec, p, part, nblk,
                            stream);
}
