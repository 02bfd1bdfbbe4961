// Fused attention block (QKV projection + masked attention + out-projection)
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel outfitx_tpu/ops/attn_block.py:_attn_block_kernel
// and computes what it computes. For each batch row and each head j in order:
//   q, k, v = y W[:, i, head j] for i = 0, 1, 2: float32 accumulation, rounded
//             to y's dtype, THEN the bias (in that dtype) added in that dtype
//   S = q k^T * scale               float32
//   S[:, t] = -1e9 where key t is pad, then S[s, t] = -1e9 where t > s when
//             causal: where-SET, so a fully masked row is uniform, not NaN
//   P = softmax(S) in float32, rounded to y's dtype
//   ctx = P v                       float32 accumulation, rounded to y's dtype
//   out (+)= ctx Wo[head j rows]    float32 accumulation, NOT rounded: the
//             output is float32 whatever the input, summed over the heads in
//             the order 0..H-1. The out-projection bias stays with the caller.
// Inputs, contiguous: y (B, L, d); wqkv (d, 3, d); bqkv (3, d); wo (d, d) as
// (in, out); all of one dtype, float or bfloat16; pad (B, L) bytes, nonzero =
// pad; out (B, L, d) float32. L <= 64, d a multiple of 64, Dh = d / H a
// multiple of 16 up to 128. In bfloat16 the wrapper also hands in a scratch
// tensor (B, L, d) of y's dtype for ctx.
//
// What bounds it on an H100. At the text tower (B = 2048, L = 64, d = 768,
// H = 12, bf16): 464 GFLOP for q, k, v, 26 for the attention, 155 for the
// out-projection, 645 GFLOP against 0.6 GB read and written, so the bound is
// 0.65 ms of tensor-core time: bound by operations.
//
// Design. The TPU grid runs the heads one after another and carries the
// float32 sum in the output block; CUDA blocks run in no order, so here ONE
// block of 256 threads owns a tile of batch rows (64 / round16(L) of them, 64
// token rows in all) and loops over the heads itself: the order of the
// float32 sum over the heads is fixed and no atomics are needed. Token rows
// of a batch row are padded to a multiple of 16 in shared memory only (their
// probabilities are zero and they are never stored); nothing is padded in
// global memory, and none of the TPU kernel's lane padding, tile search or
// weight re-layout is needed.
//
// bfloat16 (the towers' dtype), attn_block_bf16_kernel. Per head: q, k and v
// are three bg::stream_gemm products over K = d (y rows and weight tiles
// copied into shared memory with cp.async, two chunks in flight, wmma on the
// tensor cores, accumulators in registers), rounded and biased into shared
// memory; scores, the row softmax (one warp a row) and P v stay in shared
// memory; ctx, rounded, goes to the scratch tensor at its head's columns.
// After the last head the block multiplies ITS rows of ctx (still in L2) by
// Wo, 64 output columns at a time, again with bg::stream_gemm over K = d:
// the float32 sum runs over the heads in the order 0..H-1 in one chain, and
// each output element is written once (no read-modify-write per head). 108 KB
// of shared memory at Dh = 64, so two blocks share an SM.
//
// float32, attn_block_f32_kernel: the same arithmetic with scalar FMAs
// (bg::block_gemm), y streamed through shared memory in chunks of 64
// columns, the weights read in place, and the output summed in global memory
// by the block that owns the rows, head after head (head 0 stores, the
// others add). Making the bfloat16 kernel faster (wgmma, TMA, q, k and v in
// one product, ctx kept in shared memory where it fits) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;   // token rows a block owns
constexpr int kYChunk = 64;    // columns of y per projection step
constexpr int kOutChunk = 64;  // output columns per out-projection step

// ---- float32 --------------------------------------------------------------
// Shared memory of one block. M = kMaxRows token rows.
//   y    (M, kYChunk + pad)
//   qkv  3 x (M, Dh + pad): q, k, v accumulate here and are biased in place;
//        qkv[0] later holds ctx
//   s    (M, Lp + pad) scores, then P in place
//   o    (M, kOutChunk + pad)
struct F32Layout {
  int ldy, ldh, lds, ldo;
  size_t y, qkv, s, o, total, head;  // head: elements of one (M, ldh)
  __host__ __device__ F32Layout(int Lp, int Dh) {
    ldy = kYChunk + bg::kRowPad;
    ldh = Dh + bg::kRowPad;
    lds = Lp + bg::kRowPad;
    ldo = kOutChunk + bg::kRowPad;
    head = static_cast<size_t>(kMaxRows) * ldh;
    y = 0;
    qkv = y + bg::align128(sizeof(float) * kMaxRows * ldy);
    s = qkv + bg::align128(sizeof(float) * 3 * head);
    o = s + bg::align128(sizeof(float) * kMaxRows * lds);
    total = o + bg::align128(sizeof(float) * kMaxRows * ldo);
  }
};

__global__ void __launch_bounds__(kThreads)
    attn_block_f32_kernel(const float* __restrict__ y,
                          const float* __restrict__ wqkv,
                          const float* __restrict__ bqkv,
                          const float* __restrict__ wo,
                          const uint8_t* __restrict__ pad,
                          float* __restrict__ out, int B, int L, int d, int H,
                          int Dh, float scale, int causal) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int Lp = bg::round16(L);
  const int TB = kMaxRows / Lp;  // batch rows per block
  const int M = TB * Lp;         // token rows per block, a multiple of 16
  const F32Layout lay(Lp, Dh);
  float* sy = reinterpret_cast<float*>(smem + lay.y);
  float* sqkv = reinterpret_cast<float*>(smem + lay.qkv);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* so = reinterpret_cast<float*>(smem + lay.o);
  const size_t head = lay.head;

  const int b0 = blockIdx.x * TB;
  const int warp = threadIdx.x / 32;

  for (int j = 0; j < H; ++j) {
    // q, k, v of head j: y streamed in chunks of kYChunk columns.
    for (int k0 = 0; k0 < d; k0 += kYChunk) {
      constexpr int per_row = kYChunk / 4;
      for (int c = threadIdx.x; c < M * per_row; c += kThreads) {
        const int r = c / per_row;
        const int col = (c - r * per_row) * 4;
        const int e = r / Lp;
        const int i = r - e * Lp;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < L && b0 + e < B)
          val = *reinterpret_cast<const float4*>(
              y + (static_cast<size_t>(b0 + e) * L + i) * d + k0 + col);
        *reinterpret_cast<float4*>(sy + r * lay.ldy + col) = val;
      }
      __syncthreads();
      for (int i = 0; i < 3; ++i)
        bg::block_gemm<false, 2>(
            sqkv + i * head, lay.ldh, sy, lay.ldy,
            wqkv + static_cast<size_t>(k0) * 3 * d + i * d + j * Dh, 3 * d, M,
            Dh, kYChunk, k0 > 0);
      __syncthreads();
    }
    // The bias (float32 needs no rounding in between).
    for (int e = threadIdx.x; e < 3 * M * Dh; e += kThreads) {
      const int i = e / (M * Dh);
      const int rc = e - i * (M * Dh);
      const int r = rc / Dh;
      const int c = rc - r * Dh;
      sqkv[i * head + r * lay.ldh + c] += bqkv[i * d + j * Dh + c];
    }
    __syncthreads();
    // Scores of each batch row: q k^T, k read column-major.
    for (int e = 0; e < TB; ++e)
      bg::block_gemm<true, 1>(ss + e * Lp * lay.lds, lay.lds,
                              sqkv + e * Lp * lay.ldh, lay.ldh,
                              sqkv + head + e * Lp * lay.ldh, lay.ldh, Lp, Lp,
                              Dh, false);
    __syncthreads();
    for (int r = warp; r < M; r += kThreads / 32) {
      const int e = r / Lp;
      const int i = r - e * Lp;
      if (i < L && b0 + e < B)
        bg::softmax_row<float>(ss + r * lay.lds, ss + r * lay.lds,
                               pad + static_cast<size_t>(b0 + e) * L, L, Lp, i,
                               scale, causal);
      else
        bg::zero_row<float>(ss + r * lay.lds, Lp);
    }
    __syncthreads();
    // ctx = P v into q's place (q is done with).
    for (int e = 0; e < TB; ++e)
      bg::block_gemm<false, 1>(sqkv + e * Lp * lay.ldh, lay.ldh,
                               ss + e * Lp * lay.lds, lay.lds,
                               sqkv + 2 * head + e * Lp * lay.ldh, lay.ldh, Lp,
                               Dh, Lp, false);
    __syncthreads();
    // out (+)= ctx Wo[head j rows], kOutChunk columns at a time.
    for (int n0 = 0; n0 < d; n0 += kOutChunk) {
      bg::block_gemm<false, 1>(so, lay.ldo, sqkv, lay.ldh,
                               wo + static_cast<size_t>(j) * Dh * d + n0, d, M,
                               kOutChunk, Dh, false);
      __syncthreads();
      for (int e = threadIdx.x; e < M * kOutChunk; e += kThreads) {
        const int r = e / kOutChunk;
        const int c = e - r * kOutChunk;
        const int eb = r / Lp;
        const int i = r - eb * Lp;
        if (i < L && b0 + eb < B) {
          float* dst = out + (static_cast<size_t>(b0 + eb) * L + i) * d + n0 + c;
          const float part = so[r * lay.ldo + c];
          *dst = j == 0 ? part : *dst + part;
        }
      }
      __syncthreads();
    }
  }
}

cudaError_t launch_f32(const void* y, const void* wqkv, const void* bqkv,
                       const void* wo, const void* pad, void* out, int B,
                       int L, int d, int H, float scale, int causal,
                       cudaStream_t stream) {
  const int Dh = d / H;
  const int Lp = bg::round16(L);
  const F32Layout lay(Lp, Dh);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_block_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.total));
  if (err != cudaSuccess) return err;
  const int TB = kMaxRows / Lp;
  const int blocks = (B + TB - 1) / TB;
  attn_block_f32_kernel<<<blocks, kThreads, lay.total, stream>>>(
      static_cast<const float*>(y), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(wo),
      static_cast<const uint8_t*>(pad), static_cast<float*>(out), B, L, d, H,
      Dh, scale, causal);
  return cudaGetLastError();
}

// ---- bfloat16 -------------------------------------------------------------
//   stage_a, stage_b  bg::stream_gemm's staging (N up to max(Dh, kOutChunk))
//   c    (M, NB + pad) float32, NB = max(Dh, kOutChunk): a product's result
//   qkv  3 x (M, Dh + pad) bfloat16
//   s    (M, Lp + pad) float32 scores;  p  (M, Lp + pad) bfloat16
struct Bf16Layout {
  int ldh, lds, ldc;
  size_t stage_a, stage_b, c, qkv, s, p, total, head;
  __host__ __device__ Bf16Layout(int Lp, int Dh) {
    using bf16 = __nv_bfloat16;
    const int nb = Dh > kOutChunk ? Dh : kOutChunk;
    ldh = Dh + bg::kRowPad;
    lds = Lp + bg::kRowPad;
    ldc = nb + bg::kRowPad;
    head = static_cast<size_t>(kMaxRows) * ldh;
    stage_a = 0;
    stage_b = stage_a + bg::stream_stage_a_bytes(kMaxRows);
    c = stage_b + bg::stream_stage_b_bytes(nb);
    qkv = c + bg::align128(sizeof(float) * kMaxRows * ldc);
    s = qkv + bg::align128(sizeof(bf16) * 3 * head);
    p = s + bg::align128(sizeof(float) * kMaxRows * lds);
    total = p + bg::align128(sizeof(bf16) * kMaxRows * lds);
  }
};

__global__ void __launch_bounds__(kThreads)
    attn_block_bf16_kernel(const __nv_bfloat16* __restrict__ y,
                           const __nv_bfloat16* __restrict__ wqkv,
                           const __nv_bfloat16* __restrict__ bqkv,
                           const __nv_bfloat16* __restrict__ wo,
                           const uint8_t* __restrict__ pad,
                           __nv_bfloat16* ctx, float* __restrict__ out, int B,
                           int L, int d, int H, int Dh, float scale,
                           int causal) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int Lp = bg::round16(L);
  const int TB = kMaxRows / Lp;
  const int M = TB * Lp;
  const Bf16Layout lay(Lp, Dh);
  bf16* stage_a = reinterpret_cast<bf16*>(smem + lay.stage_a);
  bf16* stage_b = reinterpret_cast<bf16*>(smem + lay.stage_b);
  float* sc = reinterpret_cast<float*>(smem + lay.c);
  bf16* sqkv = reinterpret_cast<bf16*>(smem + lay.qkv);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  bf16* sp = reinterpret_cast<bf16*>(smem + lay.p);
  const size_t head = lay.head;

  const int b0 = blockIdx.x * TB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Token row r of the tile -> its row in (B L, d), or -1 for a padded row.
  auto global_row = [=](int r) -> long long {
    const int e = r / Lp;
    const int i = r - e * Lp;
    return (i < L && b0 + e < B) ? static_cast<long long>(b0 + e) * L + i : -1;
  };
  auto y_row = [=](int r) -> const bf16* {
    const long long g = global_row(r);
    return g < 0 ? nullptr : y + g * d;
  };
  auto ctx_row = [=](int r) -> const bf16* {
    const long long g = global_row(r);
    return g < 0 ? nullptr : ctx + g * d;
  };

  for (int j = 0; j < H; ++j) {
    for (int i = 0; i < 3; ++i) {
      bg::stream_gemm<2, 2, false>(sc, lay.ldc, false, nullptr, 0, y_row,
                                   wqkv + i * d + j * Dh, 3 * static_cast<size_t>(d),
                                   stage_a, stage_b, M, Dh, d);
      __syncthreads();
      // Round to bfloat16, then add the bias in bfloat16 (a warp a row).
      bf16* dst = sqkv + i * head;
      const bf16* bias = bqkv + i * d + j * Dh;
      for (int r = warp; r < M; r += kThreads / 32) {
        for (int c = lane; c < Dh; c += 32) {
          const bf16 rounded = __float2bfloat16_rn(sc[r * lay.ldc + c]);
          dst[r * lay.ldh + c] = __float2bfloat16_rn(
              __bfloat162float(rounded) + __bfloat162float(bias[c]));
        }
      }
      __syncthreads();
    }
    for (int e = 0; e < TB; ++e)
      bg::block_gemm<true, 1>(ss + e * Lp * lay.lds, lay.lds,
                              sqkv + e * Lp * lay.ldh, lay.ldh,
                              sqkv + head + e * Lp * lay.ldh, lay.ldh, Lp, Lp,
                              Dh, false);
    __syncthreads();
    for (int r = warp; r < M; r += kThreads / 32) {
      const long long g = global_row(r);
      if (g >= 0)
        bg::softmax_row<bf16>(ss + r * lay.lds, sp + r * lay.lds,
                              pad + (g / L) * L, L, Lp, r % Lp, scale, causal);
      else
        bg::zero_row<bf16>(sp + r * lay.lds, Lp);
    }
    __syncthreads();
    for (int e = 0; e < TB; ++e)
      bg::block_gemm<false, 1>(sc + e * Lp * lay.ldc, lay.ldc,
                               sp + e * Lp * lay.lds, lay.lds,
                               sqkv + 2 * head + e * Lp * lay.ldh, lay.ldh, Lp,
                               Dh, Lp, false);
    __syncthreads();
    // ctx, rounded, to its head's columns of the scratch tensor.
    for (int r = warp; r < M; r += kThreads / 32) {
      const long long g = global_row(r);
      if (g < 0) continue;
      for (int c = lane; c < Dh; c += 32)
        ctx[g * d + j * Dh + c] = __float2bfloat16_rn(sc[r * lay.ldc + c]);
    }
    __syncthreads();
  }

  // out = ctx Wo over K = d: the heads in the order 0..H-1, one chain.
  for (int n0 = 0; n0 < d; n0 += kOutChunk) {
    bg::stream_gemm<2, 2, false>(sc, lay.ldc, false, nullptr, 0, ctx_row,
                                 wo + n0, static_cast<size_t>(d), stage_a,
                                 stage_b, M, kOutChunk, d);
    __syncthreads();
    for (int r = warp; r < M; r += kThreads / 32) {
      const long long g = global_row(r);
      if (g < 0) continue;
      for (int c = lane; c < kOutChunk; c += 32)
        out[g * d + n0 + c] = sc[r * lay.ldc + c];
    }
    __syncthreads();
  }
}

cudaError_t launch_bf16(const void* y, const void* wqkv, const void* bqkv,
                        const void* wo, const void* pad, void* ctx, void* out,
                        int B, int L, int d, int H, float scale, int causal,
                        cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (ctx == nullptr) return cudaErrorInvalidValue;
  const int Dh = d / H;
  const int Lp = bg::round16(L);
  const Bf16Layout lay(Lp, Dh);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_block_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.total));
  if (err != cudaSuccess) return err;
  const int TB = kMaxRows / Lp;
  const int blocks = (B + TB - 1) / TB;
  attn_block_bf16_kernel<<<blocks, kThreads, lay.total, stream>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wo),
      static_cast<const uint8_t*>(pad), static_cast<bf16*>(ctx),
      static_cast<float*>(out), B, L, d, H, Dh, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; ctx: scratch
// (B, L, d) of bfloat16 for dtype 1, unused for dtype 0.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int attn_block(const void* y, const void* wqkv, const void* bqkv,
                          const void* wo, const void* pad, void* ctx, void* out,
                          int B, int L, int d, int H, float scale, int causal,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || L > kMaxRows || H < 1 || d < 64 || d % 64 || d % H)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dh = d / H;
  if (Dh % 16 || Dh > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_f32(y, wqkv, bqkv, wo, pad, out, B, L, d, H, scale, causal, s);
  if (dtype == 1)
    return launch_bf16(y, wqkv, bqkv, wo, pad, ctx, out, B, L, d, H, scale,
                       causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
