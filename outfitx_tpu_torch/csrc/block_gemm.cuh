// Block-level building blocks shared by the tower kernels (sm_90a):
// a matrix product of shared-memory tiles done by all threads of a block,
// a guarded tile loader, and the float <-> element conversions.
//
// block_gemm computes C (+)= A B for one block:
//   C  float, row-major (M, N), row stride ldc, in shared memory;
//   A  T, row-major (M, K), row stride lda, in shared memory;
//   B  T, (K, N): row-major with row stride ldb, or, with BColMajor,
//      stored as (N, K) row-major (so B = stored^T, as K in Q K^T); it may
//      lie in shared or in global memory (weights are read straight from
//      global memory: they are shared by every block and stay in L2).
// M, N and K are multiples of 16. Accumulation is float32 in both forms:
//   T = __nv_bfloat16: nvcuda::wmma m16n16k16 on the tensor cores; a warp
//     owns a strip of 16 x (16 NT) outputs, so one A fragment feeds NT
//     products; accumulators pass through C between calls;
//   T = float: scalar FMAs on the CUDA cores, a 4 x 4 micro-tile a thread
//     (full float32, no TF32).
// The function does not synchronise: the caller puts __syncthreads()
// between the writes of A, B, C and the call, and after it.
//
// Alignment the wmma form needs (the callers' layouts keep it): every tile
// origin 32-byte aligned, row strides a multiple of 16 bytes. Shared tiles
// pad each row by kRowPad elements, which keeps both and spreads the rows of
// a fragment over the banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

// ---- bfloat16: tensor cores through wmma --------------------------------
template <bool BColMajor, int NT>
__device__ __forceinline__ void block_gemm(float* C, int ldc,
                                           const __nv_bfloat16* A, int lda,
                                           const __nv_bfloat16* B, int ldb,
                                           int M, int N, int K,
                                           bool accumulate) {
  using namespace nvcuda;
  using BLayout =
      typename std::conditional<BColMajor, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int tiles_n = N / 16;
  const int strips_n = (tiles_n + NT - 1) / NT;
  const int tasks = (M / 16) * strips_n;
  for (int task = warp; task < tasks; task += n_warps) {
    const int r0 = (task / strips_n) * 16;
    const int t0 = (task % strips_n) * NT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t0 + t < tiles_n) {
        if (accumulate)
          wmma::load_matrix_sync(acc[t], C + r0 * ldc + (t0 + t) * 16, ldc,
                                 wmma::mem_row_major);
        else
          wmma::fill_fragment(acc[t], 0.f);
      }
    }
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + r0 * lda + k, lda);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (t0 + t < tiles_n) {
          const int c0 = (t0 + t) * 16;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
          const __nv_bfloat16* bp =
              BColMajor ? B + static_cast<size_t>(c0) * ldb + k
                        : B + static_cast<size_t>(k) * ldb + c0;
          wmma::load_matrix_sync(b, bp, ldb);
          wmma::mma_sync(acc[t], a, b, acc[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t0 + t < tiles_n)
        wmma::store_matrix_sync(C + r0 * ldc + (t0 + t) * 16, acc[t], ldc,
                                wmma::mem_row_major);
    }
  }
}

// ---- float32: scalar FMAs, 4 x 4 outputs a thread -----------------------
template <bool BColMajor, int NT>
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
