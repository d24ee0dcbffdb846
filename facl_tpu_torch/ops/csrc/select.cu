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
// f32 bit patterns, out of the ball above every key (d == r^2 is kept,
// :82-85); t = the exact K-th smallest key; every key below t is taken,
// and the ties at t go to the smaller point index (:119-140). The selected
// in-radius points are written in ascending index order with centroid
// padding at the tail — the TPU kernel's order (:195-212) — and all C
// channels are gathered into (B, C, S, K), not re-centred.
//
// What bounds it on the card: bytes (the gathered output, B*C*S*K floats,
// and idx, B*S*K ints). Design:
//  - Work units are (cloud, 16 centroids): a 256-thread block stages the
//    cloud (N x C floats, coalesced) and its (x, y, z, |p|^2) in shared
//    memory, and each of its 8 warps takes two centroids; the grid (at
//    the main path 640 x 4 blocks) runs in several full waves.
//  - A warp holds its centroid's N keys in registers, ceil(N/32) a lane
//    (a template on 4, 8, 16 or 32), and counts the in-ball keys first.
//    With at most K in the ball the answer is every in-ball point (what
//    the K-th-key rule gives there), and no selection runs.
//  - Otherwise an exact radix select of the K-th key over the bits in
//    which the candidates differ: the candidates' range (first [0, r^2],
//    then the min and max of a bin's keys, by warp reductions) gives the
//    highest differing bit; the next (up to) 8 bits below it are counted
//    in a per-warp 256-bin shared-memory histogram (integer atomics, so
//    counts are exact and the result deterministic); one scan finds the
//    bin holding the K-th key, whose keys are the next candidates. It
//    ends when they are one value (t, with the number of ties to take),
//    or, once a bin holds at most 32 keys, by ranking them one a lane.
//    Real clouds (most of a ball's points near its rim) take one or two
//    passes where the bisection it replaces took 31 dependent steps.
//  - Compaction by ballots and prefix popcounts (the tie rule as before);
//    then a lane per selected point writes its index and its channels,
//    read from the staged cloud (one 16-byte read at C = 4), each store
//    128 contiguous bytes of a row.
//
// The distance uses explicitly rounded multiplies and adds in a fixed
// order, so it is bit-identical to the plain PyTorch twin
// (facl_tpu_torch/ops/select.py::select_gather_plain) and the selection
// and gather agree exactly.
#include <cstdint>
#include "common.cuh"

namespace {

constexpr unsigned kOut = 0xffffffffu;   // key of a point out of the ball
constexpr unsigned FULL = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCPB = 16;                 // centroids per block
constexpr int kBins = 256;               // radix histogram, per warp
constexpr size_t kStageMax = 96 * 1024;  // stage the cloud up to this

// Inclusive sum over a warp's lanes.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// The k-th smallest (1-based) of the warp's in-ball keys w (k < their
// count; rbits = the bits of r^2, above every in-ball key): t, take = k
// less the number of keys below t (the ties at t to select), and ties =
// the number of keys equal to t where the last pass counted them (else
// -1). The candidates of a pass are the keys in [lo, hi].
template <int NJ>
__device__ __forceinline__ void select_kth(const unsigned (&w)[NJ], int k,
                                           unsigned rbits, int* hist,
                                           int lane, unsigned& t, int& take,
                                           int& ties) {
  unsigned lo = 0u, hi = rbits;        // every in-ball key
  ties = -1;
  for (;;) {
    if (lo == hi) {
      t = lo;
      take = k;
      return;
    }
    // The candidates are the keys in [lo, hi]; they share the bits above
    // hb. Count the (up to) 8 bits below it.
    const int hb = 31 - __clz(lo ^ hi);
    const int sh = max(hb - 7, 0);
    const unsigned dmask = (2u << (hb - sh)) - 1u;
    *reinterpret_cast<int4*>(hist + 8 * lane) = make_int4(0, 0, 0, 0);
    *reinterpret_cast<int4*>(hist + 8 * lane + 4) = make_int4(0, 0, 0, 0);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (w[j] - lo <= hi - lo) atomicAdd(&hist[(w[j] >> sh) & dmask], 1);
    __syncwarp();
    const int4 ha = *reinterpret_cast<const int4*>(hist + 8 * lane);
    const int4 hc = *reinterpret_cast<const int4*>(hist + 8 * lane + 4);
    const int h[8] = {ha.x, ha.y, ha.z, ha.w, hc.x, hc.y, hc.z, hc.w};
    int tot = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += h[i];
    const int incl = warp_scan(tot, lane);
    const int L = __ffs(__ballot_sync(FULL, incl >= k)) - 1;
    int bin = 0, before = incl - tot, nbin = 0;
    if (lane == L) {                   // the first bin reaching k
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (before + h[i] >= k) {
          bin = 8 * lane + i;
          nbin = h[i];
          break;
        }
        before += h[i];
      }
    }
    bin = __shfl_sync(FULL, bin, L);
    k -= __shfl_sync(FULL, before, L);
    ties = __shfl_sync(FULL, nbin, L);  // if the bin's keys are one value
    const unsigned high = (lo >> (hb + 1)) << (hb + 1);   // hb <= 30
    const unsigned base = high | (static_cast<unsigned>(bin) << sh);
    if (sh == 0) {
      t = base;
      take = k;
      return;
    }
    const unsigned span = (1u << sh) - 1u;
    if (ties <= 32) {
      // A bin of at most 32 keys: listed one a lane (in the histogram's
      // place) and ranked against each other by shuffles.
      const unsigned lt = (1u << lane) - 1u;
      int pos = 0;
      __syncwarp();                    // hist read
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bool c = w[j] - base <= span;
        const unsigned cb = __ballot_sync(FULL, c);
        if (c) hist[pos + __popc(cb & lt)] = static_cast<int>(w[j]);
        pos += __popc(cb);
      }
      __syncwarp();
      const unsigned key =
          lane < ties ? static_cast<unsigned>(hist[lane]) : kOut;
      int less = 0, eq = 0;
      for (int m = 0; m < ties; m += 2) {   // lanes past the list: kOut
        const unsigned o = __shfl_sync(FULL, key, m);
        const unsigned p = __shfl_sync(FULL, key, m + 1);
        less += (o < key) + (p < key);
        eq += (o == key) + (p == key && m + 1 < ties);
      }
      const int Lt = __ffs(__ballot_sync(
                         FULL, lane < ties && less < k && k <= less + eq)) -
                     1;
      t = __shfl_sync(FULL, key, Lt);
      take = k - __shfl_sync(FULL, less, Lt);
      ties = __shfl_sync(FULL, eq, Lt);
      return;
    }
    // The bin's keys: their min and max are the next pass's range.
    lo = kOut;
    hi = 0u;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bool c = w[j] - base <= span;
      lo = min(lo, c ? w[j] : kOut);
      hi = max(hi, c ? w[j] : 0u);
    }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    __syncwarp();                      // hist read before the next clear
  }
}

template <int NJ, bool kGather>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ pts, int N, int C, int S, int K,
              float radius_sq, int staged, float* __restrict__ grouped,
              int* __restrict__ idx_out) {
  extern __shared__ __align__(16) int smi[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Kp = (K + 3) & ~3;
  int* hist = smi + warp * kBins;                       // (warps, bins)
  int* myidx = smi + kWarps * kBins + warp * Kp;        // (warps, Kp)
  float4* sp = reinterpret_cast<float4*>(smi + kWarps * (kBins + Kp));
  float* Ps = reinterpret_cast<float*>(sp + N);         // (N, C) if staged

  const int groups = (S + kCPB - 1) / kCPB;
  const int b = blockIdx.x / groups;
  const int s0 = (blockIdx.x - b * groups) * kCPB;
  const float* P = pts + static_cast<int64_t>(b) * N * C;
  if (staged) {
    const int n4 = (reinterpret_cast<uintptr_t>(P) & 15) ? 0 : N * C / 4;
    for (int e = threadIdx.x; e < n4; e += kThreads)
      reinterpret_cast<float4*>(Ps)[e] =
          reinterpret_cast<const float4*>(P)[e];
    for (int e = 4 * n4 + threadIdx.x; e < N * C; e += kThreads)
      Ps[e] = P[e];
    __syncthreads();
  }
  const float* src = staged ? Ps : P;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float x = src[n * C], y = src[n * C + 1], z = src[n * C + 2];
    sp[n] = make_float4(x, y, z,
                        __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                  __fmul_rn(z, z)));
  }
  __syncthreads();

  const unsigned lt = (1u << lane) - 1u;
  const int nj = (N + 31) / 32;
  const int s_end = min(S, s0 + kCPB);
  for (int s = s0 + warp; s < s_end; s += kWarps) {
    const float4 cp = sp[s];
    unsigned w[NJ];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = j * 32 + lane;
      unsigned key = kOut;
      if (n < N) {
        const float4 q = sp[n];
        const float ab = __fadd_rn(
            __fadd_rn(__fmul_rn(cp.x, q.x), __fmul_rn(cp.y, q.y)),
            __fmul_rn(cp.z, q.z));
        float d = __fadd_rn(__fsub_rn(cp.w, __fmul_rn(2.0f, ab)), q.w);
        d = fmaxf(d, 0.0f);
        if (d <= radius_sq) key = __float_as_uint(d);
      }
      w[j] = key;
      cnt += key != kOut;
    }
    cnt = __reduce_add_sync(FULL, cnt);

    // Points in ascending index order: round j holds n = 32*j + lane.
    int sel_base = 0;
    if (cnt <= K) {
      // At most K in the ball: every in-ball point (what t = the K-th
      // key gives there).
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const bool sel = w[j] != kOut;
          const unsigned sb = __ballot_sync(FULL, sel);
          if (sel) myidx[sel_base + __popc(sb & lt)] = j * 32 + lane;
          sel_base += __popc(sb);
        }
      }
    } else {
      unsigned t;
      int take, ties;
      select_kth(w, K, __float_as_uint(radius_sq), hist, lane, t, take,
                 ties);
      // Every tie taken (the usual case): the keys up to t.
      const unsigned tsel = take == ties ? t : t - 1u;
      int tie_base = 0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj && take == ties) {
          const bool sel = w[j] <= tsel;
          const unsigned sb = __ballot_sync(FULL, sel);
          if (sel) myidx[sel_base + __popc(sb & lt)] = j * 32 + lane;
          sel_base += __popc(sb);
        } else if (j < nj) {
          const bool tie = w[j] == t;
          const unsigned tb = __ballot_sync(FULL, tie);
          const int tie_rank = tie_base + __popc(tb & lt);
          tie_base += __popc(tb);
          const bool sel = w[j] < t || (tie && tie_rank < take);
          const unsigned sb = __ballot_sync(FULL, sel);
          if (sel) myidx[sel_base + __popc(sb & lt)] = j * 32 + lane;
          sel_base += __popc(sb);
        }
      }
    }
    for (int q = sel_base + lane; q < K; q += 32) myidx[q] = s;
    __syncwarp();

    // A lane per selected point: its index, then its channels to their
    // rows (a warp's store: 128 contiguous bytes of one row). With C = 4
    // and the cloud staged, the point's row is one 16-byte read (points
    // ~N / in-ball count apart: a scalar read per channel of the
    // interleaved rows would fall on few banks).
    const int64_t row = static_cast<int64_t>(b) * S + s;
    float* out =
        kGather ? grouped + (static_cast<int64_t>(b) * C * S + s) * K
                : nullptr;
    const int64_t plane = static_cast<int64_t>(S) * K;
    for (int q = lane; q < K; q += 32) {
      const int i = myidx[q];
      if (idx_out) idx_out[row * K + q] = i;
      if (!kGather) continue;
      if (staged && C == 4) {
        const float4 v = reinterpret_cast<const float4*>(Ps)[i];
        out[q] = v.x;
        out[plane + q] = v.y;
        out[2 * plane + q] = v.z;
        out[3 * plane + q] = v.w;
      } else {
        for (int c = 0; c < C; ++c) out[c * plane + q] = src[i * C + c];
      }
    }
    __syncwarp();
  }
}

template <bool kGather>
int launch(const float* pts, int B, int N, int C, int S, int K,
           float radius_sq, float* grouped, int* idx, void* stream) {
  if (N < 1 || N > 1024 || K < 1 || K > N || S < 1 || S > N || C < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t base =
      sizeof(int) * kWarps * (kBins + ((K + 3) & ~3)) + sizeof(float4) * N;
  const size_t cloud = sizeof(float) * static_cast<size_t>(N) * C;
  const int staged = kGather && base + cloud <= kStageMax;
  const size_t smem = base + (staged ? cloud : 0);
  const int nj = (N + 31) / 32;
  decltype(&select_kernel<4, kGather>) kern =
      nj <= 4 ? select_kernel<4, kGather>
      : nj <= 8 ? select_kernel<8, kGather>
      : nj <= 16 ? select_kernel<16, kGather>
                 : select_kernel<32, kGather>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = B * ((S + kCPB - 1) / kCPB);
  kern<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, N, C, S, K, radius_sq, staged, grouped, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B1: grouped (B, C, S, K) and, where idx is given, idx (B, S, K);
// pts (B, N, C) with xyz in channels 0:3.
extern "C" int facl_select_gather(const float* pts, int B, int N, int C,
                                  int S, int K, float radius_sq,
                                  float* grouped, int* idx, void* stream) {
  return launch<true>(pts, B, N, C, S, K, radius_sq, grouped, idx, stream);
}

// B4: idx (B, S, K) only.
extern "C" int facl_select_knn_ball(const float* pts, int B, int N, int C,
                                    int S, int K, float radius_sq, int* idx,
                                    void* stream) {
  return launch<false>(pts, B, N, C, S, K, radius_sq, nullptr, idx, stream);
}
