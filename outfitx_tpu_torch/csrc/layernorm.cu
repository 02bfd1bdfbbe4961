// Row LayerNorm for Hopper (sm_90a).
//
// Replaces the Pallas kernel outfitx_tpu/ops/layernorm.py:_ln_kernel and
// computes what it computes, per row of x (rows, d):
//   xf   = float(x)
//   mean = sum(xf) / d
//   xc   = xf - mean
//   var  = sum(xc * xc) / d          the centred form, not E[x^2] - mean^2
//   y    = (xc * rsqrt(var + eps)) * scale + bias      all in float32
//   out  = y rounded to x's dtype
// x and out are float32 or bfloat16; scale and bias are float32 (the models
// keep their parameters in float32 and stream bfloat16 activations). eps is
// an argument: the TPU kernel is fixed at 1e-5, the SigLIP towers use 1e-6.
//
// What bounds it on an H100: bytes. A row is read once and written once
// (0.43 GB at 69,632 x 1536 bfloat16, 0.128 ms at 3.35 TB/s) against a few
// operations per element. The plain PyTorch version makes seven passes over
// float32 copies of the tensor; the whole gain is to make one.
//
// Design. The TPU kernel tiles (256, d) rows into VMEM and reduces along the
// lanes of each row; nothing of that tiling is carried over. Here a warp
// owns a row and keeps it in registers: each lane loads 16-byte vectors
// (8 bfloat16 or 4 float32 values), lane after lane on neighbouring
// addresses, at most 64 values a lane, so d up to 2048 when d is a multiple
// of the vector width. Two butterfly shuffles reduce the sum and then the
// centred sum of squares straight from the registers, so the variance is the
// two-pass one and a constant row gives exactly `bias`. A block is 8 warps,
// 8 rows; no shared memory, no block synchronisation. The product with scale
// and the sum with bias are kept as two roundings (no fused multiply-add), as
// the plain version rounds them. Any other d (a ragged tail, d > 2048) takes
// the scalar kernel: the same warp per row, three passes over the row, which
// stays in L1 between them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPerLane = 64;  // float32 registers that hold a lane's share

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One 16-byte vector of T as float32 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  }
};

// (xc * rstd) * scale + bias with the plain version's three roundings.
__device__ __forceinline__ float affine(float xc, float rstd, float s,
                                        float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(xc, rstd), s), b);
}

// A warp per row, the row in registers: kIters vectors a lane.
template <typename T, int kIters>
__global__ void __launch_bounds__(kThreads)
    layernorm_vec_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ out,
                         int rows, int d, float eps) {
  constexpr int kN = Vec<T>::kN;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a warp leaves as a whole
  const int n_vec = d / kN;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* outr = out + static_cast<size_t>(row) * d;

  float v[kIters][kN];
  float sum = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = lane + 32 * it;
    if (c < n_vec) {
      Vec<T>::load(xr + c * kN, v[it]);
#pragma unroll
      for (int j = 0; j < kN; ++j) sum += v[it][j];
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(d);

  float sq = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    if (lane + 32 * it < n_vec) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        v[it][j] -= mean;
        sq += v[it][j] * v[it][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);

#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = lane + 32 * it;
    if (c < n_vec) {
      float y[kN];
#pragma unroll
      for (int j = 0; j < kN; j += 4) {
        const float4 s = *reinterpret_cast<const float4*>(scale + c * kN + j);
        const float4 b = *reinterpret_cast<const float4*>(bias + c * kN + j);
        y[j] = affine(v[it][j], rstd, s.x, b.x);
        y[j + 1] = affine(v[it][j + 1], rstd, s.y, b.y);
        y[j + 2] = affine(v[it][j + 2], rstd, s.z, b.z);
        y[j + 3] = affine(v[it][j + 3], rstd, s.w, b.w);
      }
      Vec<T>::store(outr + c * kN, y);
    }
  }
}

// A warp per row, any d: three passes over the row, one element a lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    layernorm_any_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ out,
                         int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* outr = out + static_cast<size_t>(row) * d;

  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum += to_f32(xr[c]);
  const float mean = warp_sum(sum) / static_cast<float>(d);
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float xc = to_f32(xr[c]) - mean;
    sq += xc * xc;
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);
  for (int c = lane; c < d; c += 32)
    outr[c] = from_f32<T>(affine(to_f32(xr[c]) - mean, rstd, scale[c], bias[c]));
}

template <typename T, int kIters>
cudaError_t launch_vec(const void* x, const float* scale, const float* bias,
                       void* out, int rows, int d, float eps, int blocks,
                       cudaStream_t stream) {
  layernorm_vec_kernel<T, kIters><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), rows, d,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias,
                   void* out, int rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kMaxIters = kMaxPerLane / kN;
  const int blocks = (rows + kWarps - 1) / kWarps;
  const int iters = (d / kN + 31) / 32;
  if (d % kN == 0 && iters <= kMaxIters) {
    if (iters <= 1)
      return launch_vec<T, 1>(x, scale, bias, out, rows, d, eps, blocks, stream);
    if (iters <= 2)
      return launch_vec<T, 2>(x, scale, bias, out, rows, d, eps, blocks, stream);
    if (iters <= 4)
      return launch_vec<T, 4>(x, scale, bias, out, rows, d, eps, blocks, stream);
    if (iters <= 8)
      return launch_vec<T, 8>(x, scale, bias, out, rows, d, eps, blocks, stream);
    return launch_vec<T, kMaxIters>(x, scale, bias, out, rows, d, eps, blocks,
                                    stream);
  }
  layernorm_any_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), rows, d,
      eps);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. x and out: (rows, d) of dtype (0 = float32,
// 1 = bfloat16), contiguous and 16-byte aligned; scale and bias: (d,)
// float32, 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int layernorm(const void* x, const void* scale, const void* bias,
                         void* out, int rows, int d, float eps, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 0) return launch<float>(x, sc, bi, out, rows, d, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, sc, bi, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
