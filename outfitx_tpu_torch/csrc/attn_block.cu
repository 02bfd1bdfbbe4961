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
// multiple of 16 up to 128. In bfloat16 the wrapper also hands in two
// scratch tensors of y's dtype, qkv (B L, 3 d) and ctx (B, L, d).
//
// What bounds it on an H100. At the text tower (B = 2048, L = 64, d = 768,
// H = 12, bf16): 464 GFLOP for q, k, v, 26 for the attention, 155 for the
// out-projection, 645 GFLOP against 0.6 GB read and written, so the bound is
// 0.65 ms of tensor-core time: bound by operations.
//
// bfloat16 (the towers' dtype) runs three phases, below: the QKV product
// and the out-projection through hg::gemm (hopper_gemm.cuh, persistent
// warp-specialised wgmma with TMA), and the attention of each (batch row,
// head) in one warpgroup's registers. q|k|v (B L, 3 d) and ctx (B, L, d)
// hand over through device memory: 0.8 GB each way at the text tower, about
// 0.5 ms of memory time. The earlier fused design kept them on chip but
// re-read the weights for every 64 token rows (about 19 GB through L2 per
// launch), and a block cannot hold a 128-row tile's float32 out-projection
// accumulators (128 x 768 x 4 bytes) in registers; the two GEMMs' tiles and
// the attention read about 8 GB through L2 per launch. The whole range the
// wrapper takes (L <= 64, d a multiple of 64 up to 1536, Dh a multiple of 16
// up to 128, causal or not) runs this design: no second bfloat16 kernel.
//
// float32 (the correctness route; no main path on the card runs it),
// attn_block_f32_kernel: ONE block of 256 threads owns a tile of batch rows
// (64 / round16(L) of them, 64 token rows in all) and loops over the heads
// itself, so the order of the float32 sum over the heads is fixed and no
// atomics are needed; token rows are padded to a multiple of 16 in shared
// memory only. Scalar FMAs (bg::block_gemm), y streamed through shared
// memory in chunks of 64 columns, the weights read in place, and the output
// summed in global memory by the block that owns the rows, head after head
// (head 0 stores, the others add).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_gemm.cuh"
#include "hopper_gemm.cuh"

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
        bg::block_gemm<false>(
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
      bg::block_gemm<true>(ss + e * Lp * lay.lds, lay.lds,
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
      bg::block_gemm<false>(sqkv + e * Lp * lay.ldh, lay.ldh,
                            ss + e * Lp * lay.lds, lay.lds,
                            sqkv + 2 * head + e * Lp * lay.ldh, lay.ldh, Lp,
                            Dh, Lp, false);
    __syncthreads();
    // out (+)= ctx Wo[head j rows], kOutChunk columns at a time.
    for (int n0 = 0; n0 < d; n0 += kOutChunk) {
      bg::block_gemm<false>(so, lay.ldo, sqkv, lay.ldh,
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
// Three phases on the stream, one C call:
//   1. qkv = y Wqkv through hg::gemm; the epilogue rounds each sum to
//      bfloat16 and then adds the bfloat16 bias in bfloat16, into the
//      scratch tensor qkv (B L, 3 d);
//   2. attn_core_kernel: one block of one warpgroup per (batch row, head)
//      loads the head's q, k and v tiles (64 token rows each) by TMA and
//      keeps the attention in registers (below); ctx, rounded, goes to the
//      scratch tensor ctx (B L, d) at the head's columns;
//   3. out = ctx Wo through hg::gemm over K = d, float32 stored as it is:
//      the sum over the heads 0..H-1 is one chain of the products over K,
//      and each output element is written once.

// Phase 1's epilogue: bfloat16(acc), then + bias in bfloat16 (the store
// rounds the sum to bfloat16).
struct AttnQkvEpi {
  using Out = __nv_bfloat16;
  const __nv_bfloat16* bias;
  __device__ __forceinline__ void operator()(int c, float& v0, float& v1) const {
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + c));
    v0 = __bfloat162float(__float2bfloat16_rn(v0)) + b.x;
    v1 = __bfloat162float(__float2bfloat16_rn(v1)) + b.y;
  }
};

// Phase 3's epilogue: the float32 sums as they are.
struct AttnOutEpi {
  using Out = float;
  __device__ __forceinline__ void operator()(int, float&, float&) const {}
};

// Phase 2. One block of one warpgroup a (batch row, head). It loads the
// head's q, k and v tiles by TMA and computes, for the 64 query rows from
// the batch row's first token on (rows past L belong to the next batch row
// or read as zeros, and are never stored):
//   S = q k^T   wgmma m64n64k16 from shared memory, both K-major, DH / 16
//               steps; keys past L are left out (-inf before the softmax,
//               so P is exactly 0 there), pad and causal keys where-set to
//               -1e9 after the scale
//   softmax     on the accumulator fragments: a thread holds 16 scores of
//               each of two rows, the row's other 48 lie in the 3 other
//               threads of its quad (two shuffles); P rounded to bfloat16
//   ctx = P v   wgmma m64nNPVk16 with P as the register A operand (the
//               accumulator layout of S is the A fragment layout, packed in
//               pairs) and v N-major from shared memory, 4 steps over keys;
//               columns past DH are computed and not stored.
// The head's tiles are DH columns wide, read as NB boxes of 64 columns. A
// persistent variant that loaded the next item while computing this one
// measured 17% slower at the text tower (PERF.md): the blocks that
// share an SM already overlap one another's loads.
template <int DH>
struct CoreSmem {
  static constexpr int kNB = (DH + 63) / 64;
  static constexpr int kBytes = 3 * kNB * hg::kBoxBytes + 8 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(128)
    attn_core_kernel(const __grid_constant__ CUtensorMap map_qkv,
                     const uint8_t* __restrict__ pad,
                     __nv_bfloat16* __restrict__ ctx, int L, int d, int H,
                     float scale, int causal) {
  constexpr int NB = CoreSmem<DH>::kNB;
  constexpr int NPV = DH <= 64 ? 64 : 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;
  uint8_t* sk = smem + NB * hg::kBoxBytes;
  uint8_t* sv = smem + 2 * NB * hg::kBoxBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 3 * NB * hg::kBoxBytes);

  const int b = blockIdx.x / H;
  const int j = blockIdx.x - b * H;
  const int row0 = b * L;
  if (threadIdx.x == 0) {
    hg::mbar_init(bar, 1);
    hg::mbar_init_fence();
    hg::mbar_expect_tx(bar, 3 * NB * hg::kBoxBytes);
    for (int i = 0; i < 3; ++i)
      for (int box = 0; box < NB; ++box)
        hg::tma_load(smem + (i * NB + box) * hg::kBoxBytes, &map_qkv,
                     i * d + j * DH + 64 * box, row0, bar);
  }
  __syncthreads();
  hg::mbar_wait(bar, 0);

  float s[32];
  hg::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const int off = (ks / 4) * hg::kBoxBytes + (ks % 4) * 32;
    hg::wgmma_ss<64, 0>(s, hg::desc_kmajor(sq + off), hg::desc_kmajor(sk + off),
                        ks != 0);
  }
  hg::wgmma_commit();
  hg::wgmma_wait<0>();
  hg::fence_regs<32>(s);

  const int lane = threadIdx.x % 32;
  const int rq = (threadIdx.x / 32) * 16 + lane / 4;  // and rq + 8
  const uint8_t* prow = pad + static_cast<size_t>(b) * L;
  constexpr float kNeg = -1e9f;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int t = (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
    const int h = (i % 4) / 2;
    float v = -INFINITY;
    if (t < L) {
      v = s[i] * scale;
      if (prow[t]) v = kNeg;
      if (causal && t > rq + 8 * h) v = kNeg;
    }
    s[i] = v;
    mx[h] = fmaxf(mx[h], v);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i % 4) / 2;
    s[i] = expf(s[i] - mx[h]);
    sum[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 8 * kk + 2 * q;
      const int h = q % 2;
      pa[kk][q] = hg::pack_bf16(s[i] / sum[h], s[i + 1] / sum[h]);
    }

  float o[NPV / 2];
  hg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hg::wgmma_rs<NPV, 1>(o, pa[kk], hg::desc_nmajor(sv + 2048 * kk), kk != 0);
  hg::wgmma_commit();
  hg::wgmma_wait<0>();
  hg::fence_regs<NPV / 2>(o);

#pragma unroll
  for (int g = 0; g < NPV / 8; ++g) {
    const int col = g * 8 + (lane % 4) * 2;
    if (col >= DH) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = rq + 8 * h;
      if (t < L)
        *reinterpret_cast<__nv_bfloat162*>(
            ctx + static_cast<size_t>(row0 + t) * d + j * DH + col) =
            __floats2bfloat162_rn(o[4 * g + 2 * h], o[4 * g + 2 * h + 1]);
    }
  }
}

template <int DH>
cudaError_t launch_core(const CUtensorMap& map, const uint8_t* pad,
                        __nv_bfloat16* ctx, int B, int L, int d, int H,
                        float scale, int causal, cudaStream_t stream) {
  const int smem = CoreSmem<DH>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_core_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_core_kernel<DH><<<B * H, 128, smem, stream>>>(map, pad, ctx, L, d, H,
                                                      scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* y, const void* wqkv, const void* bqkv,
                        const void* wo, const void* pad, void* qkv, void* ctx,
                        void* out, int B, int L, int d, int H, float scale,
                        int causal, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (qkv == nullptr || ctx == nullptr) return cudaErrorInvalidValue;
  const int rows = B * L;
  cudaError_t err = hg::gemm(y, d, wqkv, 3 * d, qkv, 3 * d, rows, 3 * d, d,
                             AttnQkvEpi{static_cast<const bf16*>(bqkv)}, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  if (!hg::tensor_map(&map, qkv, rows, 3 * d, 3 * d, 64))
    return cudaErrorInvalidValue;
  const uint8_t* p = static_cast<const uint8_t*>(pad);
  bf16* c = static_cast<bf16*>(ctx);
  switch (d / H) {
    case 16: err = launch_core<16>(map, p, c, B, L, d, H, scale, causal, stream); break;
    case 32: err = launch_core<32>(map, p, c, B, L, d, H, scale, causal, stream); break;
    case 48: err = launch_core<48>(map, p, c, B, L, d, H, scale, causal, stream); break;
    case 64: err = launch_core<64>(map, p, c, B, L, d, H, scale, causal, stream); break;
    case 80: err = launch_core<80>(map, p, c, B, L, d, H, scale, causal, stream); break;
    case 96: err = launch_core<96>(map, p, c, B, L, d, H, scale, causal, stream); break;
    case 112: err = launch_core<112>(map, p, c, B, L, d, H, scale, causal, stream); break;
    case 128: err = launch_core<128>(map, p, c, B, L, d, H, scale, causal, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return hg::gemm(ctx, d, wo, d, out, d, rows, d, d, AttnOutEpi{}, stream);
}

}  // namespace

// Dynamic shared memory of the attention phase's block at head width dh,
// for build reports (0 for a width it does not take).
extern "C" int attn_block_core_smem_bytes(int dh) {
  if (dh < 16 || dh > 128 || dh % 16) return 0;
  return dh <= 64 ? CoreSmem<64>::kBytes : CoreSmem<128>::kBytes;
}

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; qkv (B L,
// 3 d) and ctx (B, L, d): bfloat16 scratch for dtype 1, unused for dtype 0.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int attn_block(const void* y, const void* wqkv, const void* bqkv,
                          const void* wo, const void* pad, void* qkv, void* ctx,
                          void* out, int B, int L, int d, int H, float scale,
                          int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || L > kMaxRows || H < 1 || d < 64 || d % 64 || d % H)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dh = d / H;
  if (Dh % 16 || Dh > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_f32(y, wqkv, bqkv, wo, pad, out, B, L, d, H, scale, causal, s);
  if (dtype == 1)
    return launch_bf16(y, wqkv, bqkv, wo, pad, qkv, ctx, out, B, L, d, H,
                       scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
