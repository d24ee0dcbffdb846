// Tile helpers shared by the SA sweep kernels (sa_pair.cu, sa_2sweep.cu):
// a persistent block of NT threads walks 64-row tiles held in shared
// memory, with register-tiled 64-wide products (thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j). Every sweep that recomputes h1 from x
// sums x W1 in k order (sa_mma.cuh's h1_rows and h1_pair), so its ReLU
// masks agree bit for bit with the forward's.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int TR = 64;      // rows per tile
constexpr int CW = 64;      // trunk width C1 = C2
constexpr int C3W = 256;    // top width C3
constexpr int LD = 65;      // padded stride of 64-wide row tiles
constexpr int C0MAX = 8;    // input channels

__device__ __forceinline__ float relu_affine(float p, float mul,
                                             float shift) {
  // The plain version's chain: relu((p * mul) + shift), each op rounded.
  return fmaxf(__fadd_rn(__fmul_rn(p, mul), shift), 0.0f);
}

__device__ __forceinline__ void copy_vec(float* dst, const float* src,
                                         int n) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

// h = relu(p * mul + shift) for a (TR, 64) tile of a stored residual.
__device__ __forceinline__ void load_h_tile(const float* __restrict__ p,
                                            int64_t r0, const float* mul,
                                            const float* shift, float* hs) {
  for (int e = threadIdx.x; e < TR * CW; e += NT) {
    const int r = e / CW, c = e % CW;
    hs[r * LD + c] = relu_affine(p[(r0 + r) * CW + c], mul[c], shift[c]);
  }
}

__device__ __forceinline__ void store_tile(const float* src, int64_t r0,
                                           float* __restrict__ dst) {
  for (int e = threadIdx.x; e < TR * CW; e += NT) {
    const int r = e / CW, c = e % CW;
    dst[(r0 + r) * CW + c] = src[r * LD + c];
  }
}

// acc[i][j] = sum_k A[r][k] * (scale ? scale[k] : 1) * Bm[k][c] for
// r = ty + 16 i, c = tx + 16 j; A is a (TR, LD) tile, Bm (64, 64).
__device__ __forceinline__ void mm64(const float* A, const float* Bm,
                                     const float* scale, float acc[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < CW; ++k) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty + 16 * i) * LD + k];
      if (scale) a[i] = __fmul_rn(a[i], scale[k]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = Bm[k * CW + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r L[r][a] * Rm[r][b], a = ty + 16 i, b = tx + 16 j.
__device__ __forceinline__ void acc_atb(const float* L, const float* Rm,
                                        float acc[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int r = 0; r < TR; ++r) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = L[r * LD + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = Rm[r * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

__device__ __forceinline__ void add_patch(double run[4][4],
                                          const float tile[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) run[i][j] += tile[i][j];
}

__device__ __forceinline__ void zero_patch(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ void write_patch(const double acc[4][4],
                                            double* __restrict__ out) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(ty + 16 * i) * CW + tx + 16 * j] = acc[i][j];
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Pool groups: whole groups per tile (pool divides TR) or whole tiles
// per group (TR divides pool).
inline bool bad_pool(int64_t R, int pool) {
  return pool < 1 || R % TR != 0 || R % pool != 0 ||
         (TR % pool != 0 && pool % TR != 0);
}

inline bool bad_shape(int C0, int64_t R) {
  return C0 < 1 || C0 > C0MAX - 1 || R % TR != 0;
}

}  // namespace
