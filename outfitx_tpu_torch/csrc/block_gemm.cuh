// Block-level building blocks of the float32 kernels (sm_90a): a matrix
// product of shared-memory tiles done by all threads of a block, a guarded
// tile loader, the masked row softmax, and the float <-> element conversions.
//
// block_gemm computes C (+)= A B for one block, float32 throughout:
//   C  row-major (M, N), row stride ldc, in shared memory;
//   A  row-major (M, K), row stride lda, in shared memory;
//   B  (K, N): row-major with row stride ldb, or, with BColMajor, stored as
//      (N, K) row-major (so B = stored^T, as K in Q K^T); it may lie in
//      shared or in global memory (weights are read straight from global
//      memory: they are shared by every block and stay in L2).
// M and N are multiples of 4: scalar FMAs on the CUDA cores, a 4 x 4
// micro-tile a thread (full float32, no TF32). The function does not
// synchronise: the caller puts __syncthreads() between the writes of A, B,
// C and the call, and after it. Shared tiles pad each row by kRowPad
// elements, which spreads the rows of a micro-tile over the banks.
//
// The bfloat16 kernels run on the tensor cores through hopper_gemm.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bg {

constexpr int kRowPad = 8;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr size_t align128(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Copy `cols` columns of `rows_valid` rows from global memory (row stride
// gld elements) into a shared tile (row stride sld), 16 bytes per access,
// and zero rows [rows_valid, rows_total). cols * sizeof(T), gld * sizeof(T)
// and the source pointer are multiples of 16 bytes.
template <typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, int sld,
                                          const T* __restrict__ src,
                                          size_t gld, int rows_valid,
                                          int rows_total, int cols) {
  constexpr int kPer = 16 / sizeof(T);
  const int per_row = cols / kPer;
  for (int c = threadIdx.x; c < rows_total * per_row; c += blockDim.x) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * kPer;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * gld + col);
    *reinterpret_cast<uint4*>(dst + r * sld + col) = val;
  }
}

// ---- float32: scalar FMAs, 4 x 4 outputs a thread -----------------------
template <bool BColMajor>
__device__ __forceinline__ void block_gemm(float* C, int ldc, const float* A,
                                           int lda, const float* B, int ldb,
                                           int M, int N, int K,
                                           bool accumulate) {
  const int tiles_n = N / 4;
  const int tasks = (M / 4) * tiles_n;
  for (int task = threadIdx.x; task < tasks; task += blockDim.x) {
    const int r0 = (task / tiles_n) * 4;
    const int c0 = (task % tiles_n) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = accumulate ? C[(r0 + i) * ldc + c0 + j] : 0.f;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(r0 + i) * lda + k];
      if (BColMajor) {
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = B[static_cast<size_t>(c0 + j) * ldb + k];
      } else {
        const float4 bv =
            *reinterpret_cast<const float4*>(B + static_cast<size_t>(k) * ldb + c0);
        b[0] = bv.x; b[1] = bv.y; b[2] = bv.z; b[3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(r0 + i) * ldc + c0 + j] = acc[i][j];
  }
}

// Masked row softmax of one score row by one warp, as the set-attention
// kernel does it: scale, where-SET the key-padding and causal masks to -1e9
// (a fully masked row becomes uniform, not NaN), float32 max / exp / sum,
// probabilities rounded to T. `row` holds n_keys raw scores and is
// overwritten; `prob` gets n_keys probabilities and zeros up to n_cols (it
// may alias `row` when T is float). pad points at this batch row's mask
// bytes; q_index is the query's position for the causal mask.
template <typename T>
__device__ __forceinline__ void softmax_row(float* row, T* prob,
                                            const uint8_t* __restrict__ pad,
                                            int n_keys, int n_cols,
                                            int q_index, float scale,
                                            int causal) {
  const int lane = threadIdx.x & 31;
  constexpr float kNeg = -1e9f;
  float m = -INFINITY;
  for (int j = lane; j < n_keys; j += 32) {
    float s = row[j] * scale;
    if (pad[j]) s = kNeg;
    if (causal && j > q_index) s = kNeg;
    row[j] = s;
    m = fmaxf(m, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sum = 0.f;
  for (int j = lane; j < n_keys; j += 32) {
    const float e = expf(row[j] - m);
    row[j] = e;
    sum += e;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  for (int j = lane; j < n_keys; j += 32) prob[j] = from_f32<T>(row[j] / sum);
  for (int j = n_keys + lane; j < n_cols; j += 32) prob[j] = from_f32<T>(0.f);
}

template <typename T>
__device__ __forceinline__ void zero_row(T* prob, int n_cols) {
  for (int j = (threadIdx.x & 31); j < n_cols; j += 32) prob[j] = from_f32<T>(0.f);
}

}  // namespace bg
