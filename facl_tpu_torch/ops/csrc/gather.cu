// B5: batched row gather and its transpose, the scatter-add.
//
// Replaces the TPU kernels of facl_tpu/ops/pallas/gather.py:
//   gather_rows      (pallas_call :72)  out[b, r] = table[b, idx[b, r]]
//   scatter_add_rows (pallas_call :126) out[b, i] = sum over the r with
//                    idx[b, r] == i of g[b, r]; the VJP of gather_rows
//                    (gather_rows_vjp :144) and of the fused select+gather
//                    (select.py:352-360)
// The TPU builds one-hot matrices in VMEM and rides the MXU; a GPU reads
// and writes rows directly.
//
// What bounds them on the card: bytes. The gather moves idx (4 B) and one
// C-float row in and out per output row; the scatter reads idx and g once
// and writes the (B, N, C) table.
//
// gather_kernel: one thread per output float, neighbouring threads on
// neighbouring addresses of the output; a copy, so bit-exact.
// scatter_kernel: one block per cloud, a counting sort of the rows by
// point in shared memory: count each point's rows, scan the counts, place
// the row numbers in ascending order (one warp, 32 rows at a time, equal
// points ranked by lane), then the thread of each point sums its rows in
// that order. Every sum is taken in one fixed order (ascending r), so the
// result is deterministic and equals a sequential loop over the rows; the
// only atomics are the integer counts.
#include <cstdint>
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
              int N, int R, int C, int64_t total, float* __restrict__ out) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = e / C;               // b * R + r
    const int c = static_cast<int>(e - row * C);
    const int64_t b = row / R;
    out[e] = table[(b * N + idx[row]) * C + c];
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ idx, const float* __restrict__ g,
               int N, int R, int C, float* __restrict__ out) {
  extern __shared__ int sm[];
  int* first = sm;               // N + 1: first slot of each point's rows
  int* fill = first + N + 1;     // N: slots taken so far
  int* rows = fill + N;          // R: row numbers grouped by point
  const int64_t b = blockIdx.x;
  const int* I = idx + b * R;
  const float* Gb = g + b * static_cast<int64_t>(R) * C;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i <= N; i += blockDim.x) first[i] = 0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) fill[i] = 0;
  __syncthreads();
  // 1. Rows per point (integer counts: the order of the atomics does not
  //    change them). Indices outside [0, N) are skipped.
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int i = I[r];
    if (i >= 0 && i < N) atomicAdd(&first[i + 1], 1);
  }
  __syncthreads();
  // 2. first[i] = sum of the counts below i: one warp, each lane a
  //    contiguous segment, then a shuffle scan over the lanes' totals.
  if (threadIdx.x < 32) {
    const int seg = (N + 31) / 32, lo = 1 + lane * seg;
    const int hi = lo + seg < N + 1 ? lo + seg : N + 1;
    int run = 0;
    for (int i = lo; i < hi; ++i) run += first[i];
    int incl = run;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    run = incl - run;                        // exclusive: rows before lo
    for (int i = lo; i < hi; ++i) {
      run += first[i];
      first[i] = run;
    }
  }
  __syncthreads();
  // 3. Place the row numbers, ascending, into each point's slots: one warp
  //    walks the rows 32 at a time; lanes holding the same point take
  //    consecutive slots in lane (= row) order.
  if (threadIdx.x < 32) {
    const unsigned lt = (1u << lane) - 1u;
    for (int r0 = 0; r0 < R; r0 += 32) {
      const int r = r0 + lane;
      int i = r < R ? I[r] : -1;
      if (i >= N) i = -1;
      const unsigned peers = __match_any_sync(0xffffffffu, i);
      int slot = 0;
      if (i >= 0) slot = first[i] + fill[i] + __popc(peers & lt);
      __syncwarp();
      if (i >= 0) {
        rows[slot] = r;
        if ((peers & lt) == 0) fill[i] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // 4. Each point's thread sums its rows in ascending order.
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float* o = out + (b * N + i) * C;
    for (int c = 0; c < C; ++c) {
      float acc = 0.f;
      for (int j = first[i]; j < first[i + 1]; ++j)
        acc += Gb[static_cast<int64_t>(rows[j]) * C + c];
      o[c] = acc;
    }
  }
}

}  // namespace

// table (B, N, C), idx (B, R) int32 in [0, N) -> out (B, R, C).
extern "C" int facl_gather_rows(const float* table, const int* idx, int B,
                                int N, int R, int C, float* out, int nblk,
                                void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_kernel<<<nblk, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, idx, N, R, C, static_cast<int64_t>(B) * R * C, out);
  return static_cast<int>(cudaGetLastError());
}

// idx (B, R) int32 in [0, N), g (B, R, C) -> out (B, N, C).
extern "C" int facl_scatter_add_rows(const int* idx, const float* g, int B,
                                     int N, int R, int C, float* out,
                                     void* stream) {
  const size_t smem = sizeof(int) * (2 * static_cast<size_t>(N) + 1 +
                                     static_cast<size_t>(R));
  if (B < 1 || N < 1 || R < 1 || C < 1 || smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  scatter_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, g, N, R, C, out);
  return static_cast<int>(cudaGetLastError());
}
