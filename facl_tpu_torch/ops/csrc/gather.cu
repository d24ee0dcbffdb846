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
// C-float row out per output row and reads each cloud's table once; the
// scatter reads idx and g once and writes the (B, N, C) table.
//
// gather_kernel: several blocks per cloud, each stages the cloud's table
// in shared memory with one bulk asynchronous copy (TMA, completing on an
// mbarrier) while its threads load their indices; then one thread per
// output row copies the row from shared memory with a 16-byte load and a
// streaming 16-byte store (C % 4 == 0; a scalar loop otherwise). 32-bit
// offsets inside a cloud, no division per element. A copy, so bit-exact.
//
// scatter_kernel: one block per cloud. (0) The cloud's idx and g arrive
// in shared memory by bulk copies, g while the rows are sorted. (1) Each
// warp walks its contiguous slice of rows in order and ranks every row
// among the earlier rows of its point in the slice (the lanes that hold
// one point found by match.any or by one ballot per bit of the point,
// ranked by lane), counting the rows per (point, warp). (2) One exclusive
// scan of the counts in (point, warp) order, a thread per point, gives
// every warp its first slot in each point's run. (3) Every row goes to
// its slot plus its rank: each point's rows end in ascending row order (a
// stable counting sort). (4) The sorted list is cut into equal spans, one
// per thread; each thread sums the runs inside its span serially (rows in
// ascending order); a run that crosses span ends is finished by the
// thread where it starts, which adds the partial sums of the following
// spans left to right. So the padded centroids that own almost all rows
// of a cloud spread over all threads, and every sum has one order fixed
// by (rows per point, block size): the result is deterministic. (5) The
// (N, C) output, staged in shared memory, is written with 16-byte stores.
#include <cstdint>
#include "common.cuh"

namespace {

constexpr int kThreads = 256;              // gather_kernel
constexpr int kSThreads = 512;             // scatter_kernel
constexpr int kWarps = kSThreads / 32;
constexpr int kGatherRows = 1024;          // output rows per gather block
constexpr int kPerThread = kGatherRows / kThreads;
// Dynamic shared memory a block may take: Hopper's 227 KB less 1 KB kept
// for the kernels' static shared variables.
constexpr size_t kMaxSmem = 226 * 1024;
// The scatter stages g only while two blocks still fit on an SM (228 KB,
// 1 KB of it reserved per block, ~0.1 KB of static variables).
constexpr size_t kStageG = 112 * 1024;
constexpr size_t kGatherStage = 48 * 1024; // tables staged up to this size

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// The scatter's shared layout before g (N points, R rows, C channels), in
// words, each region on 16 bytes: idx (R words, at least 4 a thread: the
// span partials take its room after the sort) | sorted rows (R) | counts
// (16 warps' 16-bit counts a point: 8 words a point), whose room takes
// the output (N x C floats) after the sort. ops/gather.py::scatter_smem
// mirrors this layout.
__host__ __device__ inline int idx_words(int R) {
  return pad4(R) > 4 * kSThreads ? pad4(R) : 4 * kSThreads;
}
__host__ __device__ inline int scatter_words(int N, int R, int C) {
  return idx_words(R) + pad4(R) + pad4(N * (C > 8 ? C : 8));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (bytes & 15) == 0;
}

// One-shot staging barrier: thread 0 initialises it; the caller syncs.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Thread 0: expect `bytes` on the barrier (its one arrival).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// TMA 1-D bulk copy global -> shared, completing `bytes` on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Every thread: wait for phase 0 of the barrier to complete.
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 4, at most 1 MB) from global to shared with
// the block: where both ends allow it, thread 0 puts the bytes on `bar`
// (initialised, its phase 0 not yet complete) and issues one bulk copy,
// and stage returns true (wait with mbar_wait0); otherwise the threads
// copy 4-byte words, visible after the next __syncthreads.
__device__ bool stage(void* dst, const void* src, size_t bytes,
                      uint64_t* bar) {
  if (aligned16(src, bytes)) {
    if (threadIdx.x == 0) {
      mbar_expect(bar, static_cast<uint32_t>(bytes));
      bulk_load(dst, src, static_cast<uint32_t>(bytes), bar);
    }
    return true;
  }
  const int* s = static_cast<const int*>(src);
  int* d = static_cast<int*>(dst);
  for (size_t k = threadIdx.x; k < bytes / 4; k += blockDim.x) d[k] = s[k];
  return false;
}

// out[b, r] = table[b, idx[b, r]]; blockIdx.x = b * chunks + chunk, each
// chunk kGatherRows rows. VEC: C % 4 == 0 and table, out 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
              int N, int R, int C, int chunks, bool staged,
              float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int b = blockIdx.x / chunks;
  const int r0 = (blockIdx.x - b * chunks) * kGatherRows;
  const int nr = min(kGatherRows, R - r0);
  const float* T = table + static_cast<size_t>(b) * N * C;
  const int* I = idx + static_cast<size_t>(b) * R + r0;
  float* O = out + (static_cast<size_t>(b) * R + r0) * C;

  const float* tab = T;
  bool bulk = false;
  if (staged) {
    if (threadIdx.x == 0) mbar_init(&bar);
    __syncthreads();
    bulk = stage(smem, T, static_cast<size_t>(N) * C * 4, &bar);
    tab = reinterpret_cast<const float*>(smem);
  }
  int rows[kPerThread];                    // indices load during the copy
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int k = u * kThreads + threadIdx.x;
    rows[u] = k < nr ? __ldcs(I + k) : 0;
  }
  if (staged) {
    __syncthreads();                       // the word-copy path
    if (bulk) mbar_wait0(&bar);
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int k = u * kThreads + threadIdx.x;
    if (k >= nr) break;
    const float* s = tab + rows[u] * C;
    float* d = O + k * C;
    if (VEC) {
      for (int c = 0; c < C; c += 4)
        __stcs(reinterpret_cast<float4*>(d + c),
               *reinterpret_cast<const float4*>(s + c));
    } else {
      for (int c = 0; c < C; ++c) __stcs(d + c, s[c]);
    }
  }
}

// Index of the 16-bit count of (point i, warp w): point-major, 16 counts
// (8 words) a point; warps 2k and 2k + 1 share the point's word k ^ s,
// s = bits 2-4 of i. The lanes of one warp (w fixed) that update distinct
// points then hit distinct banks for distinct i mod 32, and so do the
// lanes of the scan, each reading its own point's k-th word.
static_assert(kWarps == 16, "slot() packs 16 warps' counts in 8 words");
__device__ __forceinline__ int slot(int i, int w) {
  return (i << 4) | (w ^ (((i >> 2) & 7) << 1));
}

// The lanes whose point equals this lane's (i in [0, N), or -1: no
// lanes), nbits = the bits of N - 1. Where the lanes hold few runs of
// equal points (the padded neighbourhoods), match.any finds them; its
// cost grows with the number of distinct points, so otherwise one ballot
// per bit of the point does, at a fixed cost.
__device__ __forceinline__ unsigned peers_of(int i, int nbits, int lane) {
  const int prev = __shfl_up_sync(0xffffffffu, i, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != i);
  unsigned peers = __ballot_sync(0xffffffffu, i >= 0);
  if (__popc(heads) <= 8) return peers & __match_any_sync(0xffffffffu, i);
  for (int k = 0; k < nbits; ++k) {
    const bool on = (i >> k) & 1;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    peers &= on ? bal : ~bal;
  }
  return peers;
}

// The counts, in (point, warp) order, replaced by their exclusive prefix
// sums; returns the total. Thread t takes point t (then t + kSThreads,
// ...): it sums the point's 16 counts, one block scan of those sums gives
// the point's first slot, and the thread writes the point's 16 prefixes
// back. wsum: kWarps + 1 ints.
__device__ int scan_counts(unsigned* cntw, int N, int* wsum) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  int carry = 0;
  for (int base = 0; base < N; base += kSThreads) {
    const int p = base + t, s = (p >> 2) & 7;
    unsigned wd[8];
    int tot = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      wd[k] = p < N ? cntw[p * 8 + (k ^ s)] : 0u;
      tot += static_cast<int>((wd[k] & 0xffffu) + (wd[k] >> 16));
    }
    int x = tot;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) wsum[w] = x;
    __syncthreads();
    if (w == 0) {
      const int v = lane < kWarps ? wsum[lane] : 0;
      int z = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, z, d);
        if (lane >= d) z += y;
      }
      if (lane < kWarps) wsum[lane] = z - v;
      if (lane == kWarps - 1) wsum[kWarps] = z;
    }
    __syncthreads();
    if (p < N) {
      unsigned run = static_cast<unsigned>(carry + wsum[w] + x - tot);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const unsigned lo = run;
        run += wd[k] & 0xffffu;
        cntw[p * 8 + (k ^ s)] = lo | (run << 16);
        run += wd[k] >> 16;
      }
    }
    carry += wsum[kWarps];
    __syncthreads();                       // wsum is rewritten next round
  }
  return carry;
}

// Channels [c0, c0 + 4) of row r of g (nc of them; the rest 0).
template <bool VEC>
__device__ __forceinline__ float4 load_row(const float* g, int r, int C,
                                           int c0, int nc) {
  const float* p = g + r * C + c0;
  if (VEC) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], nc > 1 ? p[1] : 0.f, nc > 2 ? p[2] : 0.f,
                     nc > 3 ? p[3] : 0.f);
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

__device__ __forceinline__ void put(float* sout, int p, int C, int c0,
                                    int nc, const float4& v) {
  float* d = sout + p * C + c0;
  d[0] = v.x;
  if (nc > 1) d[1] = v.y;
  if (nc > 2) d[2] = v.z;
  if (nc > 3) d[3] = v.w;
}

// One block per cloud. STAGE_G: g is copied to shared memory (it fits),
// arriving while the rows are sorted; otherwise its rows are read from
// global memory in sorted order. VEC: C % 4 == 0 and g, out 16-byte
// aligned. The sorted list holds (point << 16) | row: the layout's size
// limit (kMaxSmem) keeps N below 2^13 and R below 2^15.
template <bool STAGE_G, bool VEC>
__global__ void __launch_bounds__(kSThreads, 2)
scatter_kernel(const int* __restrict__ idx, const float* __restrict__ g,
               int N, int R, int C, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];     // idx, g
  __shared__ int wsum[kWarps + 1];
  int* sidx = reinterpret_cast<int*>(smem);
  float4* part = reinterpret_cast<float4*>(smem);  // after the sort
  int* rows = sidx + idx_words(R);         // sorted (point << 16) | row
  unsigned* cntw = reinterpret_cast<unsigned*>(rows + pad4(R));
  auto* cnt = reinterpret_cast<unsigned short*>(cntw);
  float* sout = reinterpret_cast<float*>(cntw);    // after the sort
  float* sg = reinterpret_cast<float*>(sidx + scatter_words(N, R, C));
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const size_t b = blockIdx.x;
  const float* G = g + b * R * C;
  float* O = out + b * N * C;

  // 0. Stage idx (and g, waited for only before the sums); zero the
  //    counts meanwhile.
  if (t == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  __syncthreads();
  const size_t ib = static_cast<size_t>(R) * 4;
  const bool ibulk = stage(sidx, idx + b * R, ib, &bar[0]);
  const bool gbulk = STAGE_G && stage(sg, G, ib * C, &bar[1]);
  for (int k = t; k < N * 8; k += kSThreads) cntw[k] = 0u;
  __syncthreads();
  if (ibulk) mbar_wait0(&bar[0]);

  // 1. Rank each row among its point's rows in the warp's contiguous
  //    slice, in row order: the lanes that hold one point find each other
  //    (peers_of); the lowest reads and advances the (point, warp) count,
  //    the others take the next ranks by lane.
  //    The rank goes to the upper half of the row's idx word (-1 where the
  //    index lies outside [0, N): skipped).
  const int slice = (R + kWarps - 1) / kWarps;
  const int lo = min(R, w * slice), hi = min(R, lo + slice);
  const unsigned below = (1u << lane) - 1u;
  const int nbits = N > 1 ? 32 - __clz(N - 1) : 0;
  for (int r0 = lo; r0 < hi; r0 += 32) {
    const int r = r0 + lane;
    int i = r < hi ? sidx[r] : -1;
    if (static_cast<unsigned>(i) >= static_cast<unsigned>(N)) i = -1;
    const unsigned peers = peers_of(i, nbits, lane);
    const bool lead = i >= 0 && (peers & below) == 0;
    const int a = lead ? slot(i, w) : 0;
    const int first = lead ? cnt[a] : 0;
    const int at = __shfl_sync(0xffffffffu, first, __ffs(peers) - 1);
    if (lead) cnt[a] = static_cast<unsigned short>(first + __popc(peers));
    if (r < hi)
      sidx[r] = i < 0 ? -1 : i | ((at + __popc(peers & below)) << 16);
    __syncwarp();
  }
  __syncthreads();
  // 2. First slot of each (point, warp): one scan in (point, warp) order.
  const int M = scan_counts(cntw, N, wsum);
  // 3. Place each row at its (point, warp) slot plus its rank: every
  //    point's rows end in ascending row order (a stable counting sort).
  for (int r = lo + lane; r < hi; r += 32) {
    const int v = sidx[r];
    if (v < 0) continue;
    const int i = v & 0xffff;
    rows[cnt[slot(i, w)] + (v >> 16)] = (i << 16) | r;
  }
  __syncthreads();

  // 4. Sum the runs of the sorted list, 4 channels at a time. Thread t
  //    takes the span [t * span, (t + 1) * span) and sums each run in it
  //    in order; the partial sum of a run that began before the span goes
  //    to part[t], and the run that goes on past the span's end is
  //    finished by this thread, which adds the next spans' parts in order.
  for (int k = t; k < N * C; k += kSThreads) sout[k] = 0.f;
  if (gbulk) mbar_wait0(&bar[1]);
  const float* src = STAGE_G ? sg : G;
  // An odd span: the lanes of a warp, reading their spans' j-th entries
  // at once, meet distinct banks where the sorted rows run consecutively
  // (the padded neighbourhoods), in the list and in g.
  const int span = ((M + kSThreads - 1) / kSThreads) | 1;
  const int s0 = min(M, t * span), s1 = min(M, s0 + span);
  const bool cont = s0 > 0 && s0 < s1 &&
                    (rows[s0 - 1] >> 16) == (rows[s0] >> 16);
  const int next = s1 < M ? rows[s1] >> 16 : -1;  // the point after it
  for (int c0 = 0; c0 < C; c0 += 4) {
    const int nc = min(4, C - c0);
    __syncthreads();                 // sout zeroed; last chunk's parts read
    int cur = -1;                    // the point of the current run
    bool lead_run = true;            // it is the span's first run
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = s0; j < s1; ++j) {
      const int e = rows[j];
      const int p = e >> 16;
      const float4 v = load_row<VEC>(src, e & 0xffff, C, c0, nc);
      if (p == cur) {
        add4(acc, v);
        continue;
      }
      if (cur >= 0) {                // a run ends inside the span
        if (lead_run && cont) part[t] = acc;
        else put(sout, cur, C, c0, nc, acc);
        lead_run = false;
      }
      cur = p;
      acc = v;
    }
    int own = -1;
    if (cur >= 0) {                  // the span's last run
      if (lead_run && cont) part[t] = acc;
      else if (next == cur) own = cur;
      else put(sout, cur, C, c0, nc, acc);
    }
    __syncthreads();
    if (own >= 0) {
      for (int u = t + 1; u < kSThreads; ++u) {
        add4(acc, part[u]);
        const int end = (u + 1) * span;
        if (end >= M || (rows[end] >> 16) != own) break;
      }
      put(sout, own, C, c0, nc, acc);
    }
  }
  __syncthreads();

  // 5. Write the cloud's (N, C) output.
  if (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(sout);
    float4* o4 = reinterpret_cast<float4*>(O);
    for (int k = t; k < N * C / 4; k += kSThreads) o4[k] = s4[k];
  } else {
    for (int k = t; k < N * C; k += kSThreads) O[k] = sout[k];
  }
}

// Allow up to kMaxSmem of dynamic shared memory and prefer shared memory
// over L1, once per kernel and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

bool is_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool STAGE_G, bool VEC>
cudaError_t launch_scatter(const int* idx, const float* g, int B, int N,
                           int R, int C, float* out, size_t smem,
                           cudaStream_t stream) {
  static bool done[64] = {};
  const cudaError_t e = allow_smem(scatter_kernel<STAGE_G, VEC>, done);
  if (e != cudaSuccess) return e;
  scatter_kernel<STAGE_G, VEC><<<B, kSThreads, smem, stream>>>(idx, g, N,
                                                               R, C, out);
  return cudaGetLastError();
}

}  // namespace

// table (B, N, C), idx (B, R) int32 in [0, N) -> out (B, R, C).
extern "C" int facl_gather_rows(const float* table, const int* idx, int B,
                                int N, int R, int C, float* out,
                                void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1 ||
      static_cast<int64_t>(N) * C > INT32_MAX ||
      static_cast<int64_t>(R) * C > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (R + kGatherRows - 1) / kGatherRows;
  if (static_cast<int64_t>(B) * chunks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(B * chunks);
  const size_t bytes = static_cast<size_t>(N) * C * 4;
  const bool staged = bytes <= kGatherStage;
  const size_t smem = staged ? bytes : 0;
  const bool vec = C % 4 == 0 && is_aligned16(table) && is_aligned16(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    gather_kernel<true><<<blocks, kThreads, smem, s>>>(table, idx, N, R, C,
                                                       chunks, staged, out);
  else
    gather_kernel<false><<<blocks, kThreads, smem, s>>>(table, idx, N, R, C,
                                                        chunks, staged, out);
  return static_cast<int>(cudaGetLastError());
}

// idx (B, R) int32 in [0, N), g (B, R, C) -> out (B, N, C). Fails with
// cudaErrorInvalidValue where the layout does not fit kMaxSmem
// (ops/gather.py raises ValueError before it gets here).
extern "C" int facl_scatter_add_rows(const int* idx, const float* g, int B,
                                     int N, int R, int C, float* out,
                                     void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1 ||
      static_cast<int64_t>(N) * (C > 8 ? C : 8) > (1 << 26) ||
      static_cast<int64_t>(R) * C > (1 << 26))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t base = 4 * static_cast<size_t>(scatter_words(N, R, C));
  const size_t with_g = base + 4 * static_cast<size_t>(pad4(R * C));
  if (base > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = C % 4 == 0 && is_aligned16(g) && is_aligned16(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (with_g <= kStageG)
    e = vec ? launch_scatter<true, true>(idx, g, B, N, R, C, out, with_g, s)
            : launch_scatter<true, false>(idx, g, B, N, R, C, out, with_g, s);
  else
    e = vec ? launch_scatter<false, true>(idx, g, B, N, R, C, out, base, s)
            : launch_scatter<false, false>(idx, g, B, N, R, C, out, base, s);
  return static_cast<int>(e);
}
