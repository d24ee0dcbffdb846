// B1: fused kNN + ball-query selection and channel-major gather, and
// B4: the same selection without the gather.
//
// B1 replaces the TPU kernel facl_tpu/ops/pallas/select.py::_select_gather
// (pallas_call at select.py:302, kernel body _make_select_kernel :51),
// reached on the main path through select_gather_knn_ball (:330). B4
// replaces select.py::select_knn_ball (pallas_call :258), the same kernel
// body with gather_channels=0: here one template, the gather switched off
// at compile time (kGather = false), so the two select bit-identical
// index sets.
//
// Per (cloud b, centroid s < S): squared distances of the N points to
// point s as c2 - 2ab + p2 clamped at 0 (select.py:66-79); keys are the
// f32 bit patterns, INT_MAX outside the ball (d == r^2 is kept, :82-85);
// the exact K-th smallest key by bisection on the key value; ties go to
// the smaller point index (:119-140). The selected in-radius points are
// written in ascending index order with centroid padding at the tail —
// the TPU kernel's order (:195-212) — and all C channels are gathered
// into (B, C, S, K), not re-centred.
//
// What bounds it on the card: bytes. The work is ~N*S*(9 flops + 31
// compare passes) per cloud, far below the f32 rate, while the gathered
// output (B*C*S*K floats) is the only large traffic. Design: one block
// per cloud keeps the cloud's xyz and |p|^2 in shared memory; one warp per
// centroid holds the N keys in registers (32 per lane, N <= 1024), counts
// with warp reductions during the bisection, and compacts the selection
// with ballots and prefix popcounts — no sort, no (S, N) matrix in device
// memory. Output rows are written as K consecutive floats per channel.
//
// The distance uses explicitly rounded multiplies and adds in a fixed
// order, so it is bit-identical to the plain PyTorch twin
// (facl_tpu_torch/ops/select.py::select_gather_plain) and the selection
// and gather agree exactly.
#include <cstdint>
#include "common.cuh"

namespace {

constexpr int kIntMax = 0x7fffffff;
constexpr int kMaxJ = 32;          // keys per lane: N <= 32 * 32
constexpr int kThreads = 256;

template <bool kGather>
__global__ void __launch_bounds__(kThreads)
select_gather_kernel(const float* __restrict__ pts, int N, int C, int S,
                     int K, float radius_sq, float* __restrict__ grouped,
                     int* __restrict__ idx_out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  float* sp2 = sz + N;
  int* sidx = reinterpret_cast<int*>(sp2 + N);   // (warps, K)

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned full = 0xffffffffu;
  const unsigned lt = (1u << lane) - 1u;
  const float* P = pts + static_cast<int64_t>(b) * N * C;

  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float x = P[n * C], y = P[n * C + 1], z = P[n * C + 2];
    sx[n] = x;
    sy[n] = y;
    sz[n] = z;
    sp2[n] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                       __fmul_rn(z, z));
  }
  __syncthreads();

  int* myidx = sidx + warp * K;
  const int nj = (N + 31) / 32;
  for (int s = warp; s < S; s += nwarps) {
    const float cx = sx[s], cy = sy[s], cz = sz[s], c2 = sp2[s];
    int w[kMaxJ];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int n = j * 32 + lane;
      int key = kIntMax;
      if (j < nj && n < N) {
        const float ab = __fadd_rn(
            __fadd_rn(__fmul_rn(cx, sx[n]), __fmul_rn(cy, sy[n])),
            __fmul_rn(cz, sz[n]));
        float d = __fadd_rn(__fsub_rn(c2, __fmul_rn(2.0f, ab)), sp2[n]);
        d = fmaxf(d, 0.0f);
        if (d <= radius_sq) key = __float_as_int(d);
      }
      w[j] = key;
    }

    // Smallest t with #{w <= t} >= K (t = INT_MAX when fewer than K
    // points are in the ball). Padding keys never count: mid < INT_MAX.
    int lo = 0, hi = kIntMax;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) cnt += (w[j] <= mid);
      cnt = __reduce_add_sync(full, cnt);
      if (cnt >= K) hi = mid; else lo = mid + 1;
    }
    const int t = lo;
    int nless = 0;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) nless += (w[j] < t);
    nless = __reduce_add_sync(full, nless);
    const int take_ties = K - nless;
    const bool t_valid = t < kIntMax;

    // Points in ascending index order: round j holds n = 32*j + lane.
    int tie_base = 0, sel_base = 0;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      if (j < nj) {
        const bool tie = t_valid && (w[j] == t);
        const unsigned tb = __ballot_sync(full, tie);
        const int tie_rank = tie_base + __popc(tb & lt);
        tie_base += __popc(tb);
        const bool sel = (w[j] < t) || (tie && tie_rank < take_ties);
        const unsigned sb = __ballot_sync(full, sel);
        if (sel) myidx[sel_base + __popc(sb & lt)] = j * 32 + lane;
        sel_base += __popc(sb);
      }
    }
    for (int q = sel_base + lane; q < K; q += 32) myidx[q] = s;
    __syncwarp();

    for (int q = lane; q < K; q += 32) {
      const int i = myidx[q];
      if (idx_out) idx_out[(static_cast<int64_t>(b) * S + s) * K + q] = i;
      if (kGather)
        for (int c = 0; c < C; ++c)
          grouped[((static_cast<int64_t>(b) * C + c) * S + s) * K + q] =
              P[static_cast<int64_t>(i) * C + c];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int facl_select_gather(const float* pts, int B, int N, int C,
                                  int S, int K, float radius_sq,
                                  float* grouped, int* idx, void* stream) {
  if (N > 32 * kMaxJ || K > N || S > N || C < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * static_cast<size_t>(N) * sizeof(float) +
                      (kThreads / 32) * static_cast<size_t>(K) * sizeof(int);
  select_gather_kernel<true><<<B, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      pts, N, C, S, K, radius_sq, grouped, idx);
  return static_cast<int>(cudaGetLastError());
}

// B4: idx (B, S, K) only; pts (B, N, C) with xyz in channels 0:3.
extern "C" int facl_select_knn_ball(const float* pts, int B, int N, int C,
                                    int S, int K, float radius_sq, int* idx,
                                    void* stream) {
  if (N > 32 * kMaxJ || K > N || S > N || C < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * static_cast<size_t>(N) * sizeof(float) +
                      (kThreads / 32) * static_cast<size_t>(K) * sizeof(int);
  select_gather_kernel<false><<<B, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      pts, N, C, S, K, radius_sq, nullptr, idx);
  return static_cast<int>(cudaGetLastError());
}
