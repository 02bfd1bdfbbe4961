// Masked multi-head set attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel outfitx_tpu/ops/attention.py:_mha_kernel and
// computes what it computes, per (batch row b, head h):
//   S = Q K^T * (1/sqrt(Dh))          float32 accumulation
//   S[:, j] = -1e9 where key j is pad  a where-SET, never -inf, so a row whose
//   S[i, j] = -1e9 where j > i         keys are all masked gets uniform
//                                      weights (as in JAX), not NaN
//   P = softmax(S) in float32 (subtract max, exp, divide)
//   P is rounded to the input dtype before P V (as _mha_kernel does)
//   O = P V                            float32 accumulation, written in the
//                                      input dtype
// Inputs: q, k, v, out contiguous (B, H, L, Dh) of float or bfloat16;
// pad (B, L) of bytes (torch.bool), nonzero = pad. Dh <= 128 and a multiple
// of 8, so every (b, h) slab is a whole number of 16-byte vectors. L <= 64
// takes the set-attention kernel below; 64 < L <= 256 (the frozen towers:
// 196 patches, 77 causal text tokens) takes the query-tiled kernel at the end
// of this file, which needs Dh a multiple of 16.
//
// What bounds it on an H100. The main serving path calls it at
// (B, H, L, Dh) = (8, 16, 17, 96): 1.7 MB in and out, below a microsecond of
// memory time, so the launch bounds it. At the throughput shape B = 4096 it
// moves q, k, v and out in bf16, about 856 MB, which is about 0.26 ms at
// 3.35 TB/s, against 4*B*H*L*L*Dh = 7.3 GFLOP, about 7 us of bf16
// tensor-core time: memory-bound by a factor of about 35.
//
// Design. One block of 128 threads per (b, h); blocks share nothing (the TPU
// kernel's batch tile is a VMEM sizing choice with no counterpart here). The
// block loads Q, K and V with 16-byte vector loads into shared memory as
// float32 (the bf16 -> f32 widening is exact), keeps the whole L x L score
// block in shared memory, and does the two small products with scalar FMAs
// on the CUDA cores: Q and K rows are padded by one float so the score loop
// reads no two rows from one bank, and P V reads V as float4. At L = 17 the
// products are too small for a 64-row wgmma tile. The kernel reads each input
// byte once and writes each output byte once, which is what the memory bound
// asks for. Making it fast (several heads per block, mma.sync, fewer
// shared-memory reads per FMA) is later work.
//
// Tower lengths (64 < L <= 256). Q, K, V widened to float32 plus the L x L
// scores pass the 227 KB a block can have (about 307 KB at L = 196, Dh = 64),
// so the long kernel tiles the QUERIES, 32 rows at a time. All L keys and
// all L values of a (b, h) lie in shared memory in the input dtype and the
// (32, L) float32 scores beside them; one block of 256 threads walks the
// query tiles of its (b, h), so K and V are read once. Where K and V do not
// both fit (float32 at the largest L and Dh) a block takes one query tile
// and loads the values into the keys' place. Every key of a row is present, so the softmax is
// the same one-pass max / exp / sum as above and P is rounded to the input
// dtype before P V: no online softmax, same arithmetic as the short kernel.
// The two products go through bg::block_gemm (block_gemm.cuh): wmma on the
// tensor cores for bfloat16, scalar FMAs for float32. At (2048, 12, 196, 64)
// in bf16 the function moves 2.47 GB (0.74 ms at 3.35 TB/s) against
// 242 GFLOP (0.24 ms): bound by bytes. Each input byte is read once and each
// output byte written once; the row softmax and the products' shared-memory
// traffic, not the bytes, take most of the kernel's time (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_gemm.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kOutVec = 8;  // outputs per thread in P V: one 16-byte bf16 store
constexpr float kNeg = -1e9f;
static_assert(kOutVec == 8, "the P V loop reads V as two float4 per row");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Widen one (L, Dh) slab of T into float shared memory, 16 bytes per load,
// with a row stride of `stride` floats. A 16-byte chunk never crosses a row,
// since Dh is a multiple of 8.
template <typename T>
__device__ __forceinline__ void load_slab(const T* __restrict__ src,
                                          float* __restrict__ dst, int L,
                                          int Dh, int stride) {
  constexpr int kPer = 16 / sizeof(T);
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  for (int c = threadIdx.x; c < L * Dh / kPer; c += kThreads) {
    const uint4 raw = src4[c];
    const T* e = reinterpret_cast<const T*>(&raw);
    const int row = c * kPer / Dh;
    float* out = dst + row * stride + (c * kPer - row * Dh);
#pragma unroll
    for (int t = 0; t < kPer; ++t) out[t] = to_f32(e[t]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    masked_mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const uint8_t* __restrict__ pad, T* __restrict__ out,
                          int H, int L, int Dh, float scale, int causal) {
  // Q and K rows are padded to Dh + 1 floats: the score loop reads
  // element d of several rows at once, and an unpadded stride of Dh (a
  // multiple of 32 at Dh = 96) would put all of them in one bank.
  extern __shared__ float4 smem4[];
  const int qk_stride = Dh + 1;
  float* sv = reinterpret_cast<float*>(smem4);  // (L, Dh), 16-byte aligned
  float* sq = sv + L * Dh;                      // (L, Dh + 1)
  float* sk = sq + L * qk_stride;               // (L, Dh + 1)
  float* sp = sk + L * qk_stride;               // (L, L) scores, then P

  const int bh = blockIdx.x;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * L * Dh;
  const uint8_t* prow = pad + static_cast<size_t>(b) * L;

  load_slab(q + base, sq, L, Dh, qk_stride);
  load_slab(k + base, sk, L, Dh, qk_stride);
  load_slab(v + base, sv, L, Dh, Dh);
  __syncthreads();

  // Scores, with the key mask and the causal mask set, not added.
  for (int e = threadIdx.x; e < L * L; e += kThreads) {
    const int i = e / L;
    const int j = e - i * L;
    const float* qi = sq + i * qk_stride;
    const float* kj = sk + j * qk_stride;
    float s = 0.f;
    for (int d = 0; d < Dh; ++d) s = fmaf(qi[d], kj[d], s);
    s *= scale;
    if (prow[j]) s = kNeg;
    if (causal && j > i) s = kNeg;
    sp[e] = s;
  }
  __syncthreads();

  // Row softmax: one warp per query row, two keys per lane (L <= 64).
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < L; i += kWarps) {
    float* row = sp + i * L;
    const bool has0 = lane < L;
    const bool has1 = lane + 32 < L;
    const float s0 = has0 ? row[lane] : -INFINITY;
    const float s1 = has1 ? row[lane + 32] : -INFINITY;
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = has0 ? expf(s0 - m) : 0.f;
    const float e1 = has1 ? expf(s1 - m) : 0.f;
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    // Round P to the input dtype before P V, as the TPU kernel does.
    if (has0) row[lane] = to_f32(from_f32<T>(e0 / sum));
    if (has1) row[lane + 32] = to_f32(from_f32<T>(e1 / sum));
  }
  __syncthreads();

  // O = P V: each thread writes kOutVec consecutive outputs of one row.
  const int groups = Dh / kOutVec;
  for (int e = threadIdx.x; e < L * groups; e += kThreads) {
    const int i = e / groups;
    const int d0 = (e - i * groups) * kOutVec;
    float acc[kOutVec];
#pragma unroll
    for (int t = 0; t < kOutVec; ++t) acc[t] = 0.f;
    const float* pi = sp + i * L;
    for (int j = 0; j < L; ++j) {
      const float p = pi[j];
      const float4* vj = reinterpret_cast<const float4*>(sv + j * Dh + d0);
      const float4 lo = vj[0];
      const float4 hi = vj[1];
      acc[0] = fmaf(p, lo.x, acc[0]);
      acc[1] = fmaf(p, lo.y, acc[1]);
      acc[2] = fmaf(p, lo.z, acc[2]);
      acc[3] = fmaf(p, lo.w, acc[3]);
      acc[4] = fmaf(p, hi.x, acc[4]);
      acc[5] = fmaf(p, hi.y, acc[5]);
      acc[6] = fmaf(p, hi.z, acc[6]);
      acc[7] = fmaf(p, hi.w, acc[7]);
    }
    alignas(16) T res[kOutVec];
#pragma unroll
    for (int t = 0; t < kOutVec; ++t) res[t] = from_f32<T>(acc[t]);
    uint4* dst = reinterpret_cast<uint4*>(out + base + i * Dh + d0);
    const uint4* src = reinterpret_cast<const uint4*>(res);
#pragma unroll
    for (int w = 0; w < static_cast<int>(kOutVec * sizeof(T) / 16); ++w)
      dst[w] = src[w];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pad, void* out, int B, int H, int L, int Dh,
                   int causal, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(L) * Dh +
                       2 * static_cast<size_t>(L) * (Dh + 1) +
                       static_cast<size_t>(L) * L) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_mha_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // Same rounding as the reference: 1/sqrt(Dh) in double, then to float.
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
  masked_mha_fwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(pad),
      static_cast<T*>(out), H, L, Dh, scale, causal);
  return cudaGetLastError();
}

// ---- 64 < L <= 256: query-tiled --------------------------------------------

constexpr int kLongThreads = 256;
constexpr int kQTile = 32;

// The most dynamic shared memory a block can have on sm_90.
constexpr size_t kMaxSmem = 227 * 1024;

// Shared-memory layout of the long kernel, used by the kernel and by the
// launch: K (Lp, Dh + pad) of T; V the same, in a buffer of its own where
// both fit (`resident`), else in K's place once the scores are formed; Q
// (kQTile, Dh + pad) of T, later the float32 output tile in the same place;
// scores (kQTile, Lp + pad) float32; P (kQTile, Lp + pad) of T, which for
// float is the score buffer.
template <typename T>
struct LongLayout {
  int lp, ldt, lds;
  bool resident;
  size_t k, v, qo, s, p, total;
  __host__ __device__ LongLayout(int L, int Dh) {
    lp = bg::round16(L);
    ldt = Dh + bg::kRowPad;
    lds = lp + bg::kRowPad;
    const size_t slab = bg::align128(sizeof(T) * lp * ldt);
    const size_t rest =
        bg::align128(sizeof(float) * kQTile * ldt) +
        bg::align128(sizeof(float) * kQTile * lds) +
        (sizeof(T) == sizeof(float) ? 0 : bg::align128(sizeof(T) * kQTile * lds));
    resident = 2 * slab + rest <= kMaxSmem;
    k = 0;
    v = resident ? slab : 0;
    qo = v + slab;
    s = qo + bg::align128(sizeof(float) * kQTile * ldt);
    p = s + bg::align128(sizeof(float) * kQTile * lds);
    total = qo + rest;
  }
};

// With K and V resident a block takes every query tile of its (b, h) in
// turn and reads K and V once; otherwise a block takes one query tile and
// loads K, then V in its place.
template <typename T>
__global__ void __launch_bounds__(kLongThreads)
    masked_mha_fwd_long_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v,
                               const uint8_t* __restrict__ pad,
                               T* __restrict__ out, int H, int L, int Dh,
                               float scale, int causal) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const LongLayout<T> lay(L, Dh);
  T* sk = reinterpret_cast<T*>(smem + lay.k);
  T* sv = reinterpret_cast<T*>(smem + lay.v);
  T* sq = reinterpret_cast<T*>(smem + lay.qo);
  float* so = reinterpret_cast<float*>(smem + lay.qo);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  T* sp = sizeof(T) == sizeof(float) ? reinterpret_cast<T*>(smem + lay.s)
                                     : reinterpret_cast<T*>(smem + lay.p);

  const int q_tiles = (L + kQTile - 1) / kQTile;
  const int bh = lay.resident ? blockIdx.x : blockIdx.x / q_tiles;
  const int first = lay.resident ? 0 : blockIdx.x - bh * q_tiles;
  const int last = lay.resident ? q_tiles : first + 1;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * L * Dh;
  const uint8_t* prow = pad + static_cast<size_t>(b) * L;
  const int warp = threadIdx.x / 32;

  if (lay.resident) {
    bg::load_tile(sk, lay.ldt, k + base, Dh, L, lay.lp, Dh);
    bg::load_tile(sv, lay.ldt, v + base, Dh, L, lay.lp, Dh);
  }
  for (int tile = first; tile < last; ++tile) {
    const int q0 = tile * kQTile;
    const int nq = min(kQTile, L - q0);
    bg::load_tile(sq, lay.ldt, q + base + static_cast<size_t>(q0) * Dh, Dh, nq,
                  kQTile, Dh);
    if (!lay.resident) bg::load_tile(sk, lay.ldt, k + base, Dh, L, lay.lp, Dh);
    __syncthreads();
    // S = Q K^T: K is stored (L, Dh), the product's B read column-major.
    bg::block_gemm<true, 2>(ss, lay.lds, sq, lay.ldt, sk, lay.ldt, kQTile,
                            lay.lp, Dh, false);
    __syncthreads();
    // Not resident: the keys are done with, the values take their place.
    if (!lay.resident) bg::load_tile(sv, lay.ldt, v + base, Dh, L, lay.lp, Dh);
    for (int i = warp; i < kQTile; i += kLongThreads / 32) {
      if (i < nq)
        bg::softmax_row<T>(ss + i * lay.lds, sp + i * lay.lds, prow, L, lay.lp,
                           q0 + i, scale, causal);
      else
        bg::zero_row<T>(sp + i * lay.lds, lay.lp);
    }
    __syncthreads();
    // O = P V into the place Q had.
    bg::block_gemm<false, 1>(so, lay.ldt, sp, lay.lds, sv, lay.ldt, kQTile, Dh,
                             lay.lp, false);
    __syncthreads();
    for (int e = threadIdx.x; e < nq * Dh; e += kLongThreads) {
      const int i = e / Dh;
      const int d = e - i * Dh;
      out[base + static_cast<size_t>(q0 + i) * Dh + d] =
          bg::from_f32<T>(so[i * lay.ldt + d]);
    }
    // The next tile's Q goes where this tile's output lies.
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_long(const void* q, const void* k, const void* v,
                        const void* pad, void* out, int B, int H, int L,
                        int Dh, int causal, cudaStream_t stream) {
  const LongLayout<T> lay(L, Dh);
  const cudaError_t err = cudaFuncSetAttribute(
      masked_mha_fwd_long_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.total));
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
  const int q_tiles = (L + kQTile - 1) / kQTile;
  const int blocks = B * H * (lay.resident ? 1 : q_tiles);
  masked_mha_fwd_long_kernel<T><<<blocks, kLongThreads, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(pad),
      static_cast<T*>(out), H, L, Dh, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* pad, void* out, int B, int H, int L, int Dh,
                     int causal, cudaStream_t stream) {
  if (L <= 64) return launch<T>(q, k, v, pad, out, B, H, L, Dh, causal, stream);
  if (L > 256 || Dh % 16) return cudaErrorInvalidValue;
  return launch_long<T>(q, k, v, pad, out, B, H, L, Dh, causal, stream);
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int masked_mha_fwd(const void* q, const void* k, const void* v,
                              const void* pad, void* out, int B, int H, int L,
                              int Dh, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, pad, out, B, H, L, Dh, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, pad, out, B, H, L, Dh, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
