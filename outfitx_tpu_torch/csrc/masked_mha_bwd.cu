// Masked multi-head set attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel outfitx_tpu/ops/attention.py:_mha_bwd_kernel
// and computes what it computes, per (batch row b, head h), from the
// forward's inputs q, k, v, the key mask and the output cotangent g:
//   S  = Q K^T * scale, masked as the forward does (where-set to -1e9)
//   P  = softmax(S) in float32, kept in float32
//   dV = Pb^T G        Pb = P rounded to the input dtype
//   dP = G V^T         float32
//   dS = P o (dP - rowsum(dP o P))
//   dSb = dS * scale, rounded to the input dtype
//   dQ = dSb K,  dK = dSb^T Q
// every product accumulated in float32 and dQ, dK, dV written in the input
// dtype. A masked key j of a row with any unmasked key has P[:, j] == 0.0
// exactly (exp(-1e9 - max) underflows), so its dK and dV are exactly 0. A
// fully masked row has uniform P, as in the forward, and its backward
// follows that P.
// Inputs: q, k, v, g, dq, dk, dv contiguous (B, H, L, Dh) of float or
// bfloat16; pad (B, L) of bytes (torch.bool), nonzero = pad. L <= 64,
// Dh <= 128 and a multiple of 8.
//
// What bounds it on an H100. The training path calls it at (B, H, L, Dh) =
// (3072, 16, 17, 96) in bf16: it reads q, k, v and g and writes dq, dk and
// dv, 7 x 160.4 MB = 1.12 GB, about 0.34 ms at 3.35 TB/s, against
// 10*B*H*L*L*Dh = 13.6 GFLOP, about 14 us of bf16 tensor-core time: bound by
// memory by a factor of about 24.
//
// Design. One block of 128 threads per (b, h), as in the forward. The block
// widens Q, K, V and G into float shared memory with 16-byte loads, rows
// padded to Dh + 1 floats so that the dot-product loops (which read one
// element of several rows at once) hit distinct banks. S and dP are formed
// in one pass over the L x L pairs; one warp per query row then does the
// softmax, the row sum of dP o P (one float32 reduction across the warp, as
// the forward's softmax), dS, and the two roundings. The three output
// products read P or dS from shared memory as a broadcast and the Q, K or G
// column with consecutive threads on consecutive floats. Everything is
// scalar FMAs on the CUDA cores; each input byte is read once and each
// output byte written once. At L = 64, Dh = 128 the block holds
// 4*64*129*4 + 2*64*64*4 = 164,864 bytes of shared memory. Making it fast
// (mma.sync or wgmma, several heads per block) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e9f;

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

// Widen one (L, Dh) slab of T into float shared memory with a row stride of
// `stride` floats, 16 bytes per global load (Dh is a multiple of 8, so a
// 16-byte chunk never crosses a row).
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
    masked_mha_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const uint8_t* __restrict__ pad, T* __restrict__ dq,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int L,
                          int Dh, float scale, int causal) {
  extern __shared__ float smem[];
  const int st = Dh + 1;
  float* sq = smem;         // (L, Dh + 1)
  float* sk = sq + L * st;  // (L, Dh + 1)
  float* sv = sk + L * st;  // (L, Dh + 1)
  float* sg = sv + L * st;  // (L, Dh + 1)
  float* sp = sg + L * st;  // (L, L): S, then P, then P rounded to T
  float* sd = sp + L * L;   // (L, L): dP, then dS * scale rounded to T

  const int bh = blockIdx.x;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * L * Dh;
  const uint8_t* prow = pad + static_cast<size_t>(b) * L;

  load_slab(q + base, sq, L, Dh, st);
  load_slab(k + base, sk, L, Dh, st);
  load_slab(v + base, sv, L, Dh, st);
  load_slab(g + base, sg, L, Dh, st);
  __syncthreads();

  // S (masks set, not added) and dP = G V^T, one pass over the pairs.
  for (int e = threadIdx.x; e < L * L; e += kThreads) {
    const int i = e / L;
    const int j = e - i * L;
    const float* qi = sq + i * st;
    const float* kj = sk + j * st;
    const float* gi = sg + i * st;
    const float* vj = sv + j * st;
    float s = 0.f;
    float dp = 0.f;
    for (int d = 0; d < Dh; ++d) {
      s = fmaf(qi[d], kj[d], s);
      dp = fmaf(gi[d], vj[d], dp);
    }
    s *= scale;
    if (prow[j]) s = kNeg;
    if (causal && j > i) s = kNeg;
    sp[e] = s;
    sd[e] = dp;
  }
  __syncthreads();

  // Per query row, one warp, two keys per lane (L <= 64): P, then
  // dS = P o (dP - rowsum(dP o P)), then the roundings of P and dS * scale.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < L; i += kWarps) {
    float* srow = sp + i * L;
    float* drow = sd + i * L;
    const bool has0 = lane < L;
    const bool has1 = lane + 32 < L;
    const float s0 = has0 ? srow[lane] : -INFINITY;
    const float s1 = has1 ? srow[lane + 32] : -INFINITY;
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
    const float p0 = e0 / sum;
    const float p1 = e1 / sum;
    const float dp0 = has0 ? drow[lane] : 0.f;
    const float dp1 = has1 ? drow[lane + 32] : 0.f;
    float rs = dp0 * p0 + dp1 * p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, o);
    if (has0) {
      srow[lane] = to_f32(from_f32<T>(p0));
      drow[lane] = to_f32(from_f32<T>(p0 * (dp0 - rs) * scale));
    }
    if (has1) {
      srow[lane + 32] = to_f32(from_f32<T>(p1));
      drow[lane + 32] = to_f32(from_f32<T>(p1 * (dp1 - rs) * scale));
    }
  }
  __syncthreads();

  // dQ[i, d] = sum_j dSb[i, j] K[j, d]
  for (int e = threadIdx.x; e < L * Dh; e += kThreads) {
    const int i = e / Dh;
    const int d = e - i * Dh;
    const float* di = sd + i * L;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(di[j], sk[j * st + d], acc);
    dq[base + e] = from_f32<T>(acc);
  }
  // dK[j, d] = sum_i dSb[i, j] Q[i, d];  dV[j, d] = sum_i Pb[i, j] G[i, d]
  for (int e = threadIdx.x; e < L * Dh; e += kThreads) {
    const int j = e / Dh;
    const int d = e - j * Dh;
    float acc_k = 0.f;
    float acc_v = 0.f;
    for (int i = 0; i < L; ++i) {
      acc_k = fmaf(sd[i * L + j], sq[i * st + d], acc_k);
      acc_v = fmaf(sp[i * L + j], sg[i * st + d], acc_v);
    }
    dk[base + e] = from_f32<T>(acc_k);
    dv[base + e] = from_f32<T>(acc_v);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const void* pad, void* dq, void* dk, void* dv, int B, int H,
                   int L, int Dh, int causal, cudaStream_t stream) {
  const size_t smem = (4 * static_cast<size_t>(L) * (Dh + 1) +
                       2 * static_cast<size_t>(L) * L) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_mha_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // Same rounding as the reference: 1/sqrt(Dh) in double, then to float.
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
  masked_mha_bwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const uint8_t*>(pad), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), H, L, Dh, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int masked_mha_bwd(const void* q, const void* k, const void* v,
                              const void* g, const void* pad, void* dq,
                              void* dk, void* dv, int B, int H, int L, int Dh,
                              int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, g, pad, dq, dk, dv, B, H, L, Dh, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, pad, dq, dk, dv, B, H, L, Dh,
                                 causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
