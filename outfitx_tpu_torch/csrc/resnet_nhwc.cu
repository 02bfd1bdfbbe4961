// The ResNet-18 image tower's passes outside cuDNN, NHWC (sm_90a).
//
// Replaces no TPU kernel. The JAX tower leaves the input's normalisation,
// BatchNorm, the residual add, ReLU and the max-pool to XLA, which fuses
// them into the convolutions' neighbours; eager PyTorch fuses nothing. The
// port's tower runs NHWC from its input to the global pool (cuDNN's own
// layout on sm_90, so it converts nothing), each frozen BatchNorm folded
// into its convolution's weight and a float32 bias
// (models/towers/resnet.py), and these three kernels are the only passes
// left outside cuDNN:
//
//   resnet_normalize  uint8 images (N, C, H, W) -> (x * (1 / 255) - mean)
//                     / std in float32, rounded once to T, NHWC. That is
//                     the normaliser's arithmetic as PyTorch runs it on the
//                     card (a division by a host scalar is a product with
//                     its reciprocal there), so the result equals
//                     normalise-then-cast bit for bit.
//   resnet_bias_act   out = relu((y + bias) + residual) over an NHWC y, the
//                     residual optional, in float32 and rounded once: a
//                     convolution's whole epilogue in one pass, in place.
//   resnet_stem_pool  the stem's epilogue and its 3x3/2 max-pool (padding
//                     1) in one pass: the window's max of y, + bias, relu.
//                     Rounding and relu do not decrease, so this equals
//                     pooling the epilogue's output, and the stem's
//                     (N, 112, 112, 64) epilogue output, the tower's largest
//                     tensor, is never written (PyTorch's max-pool on the
//                     card also writes int64 indices, four times the
//                     output's bytes).
//
// What bounds them on an H100: bytes. A few operations an element against
// 2 bytes read and written. Each thread owns 16-byte vectors (8 bfloat16
// or 4 float32 channels), neighbouring threads on neighbouring channels
// and pixels, so loads and stores are whole 128-byte lines; the per-channel
// bias is read through the read-only cache. No shared memory, no
// synchronisation, a grid-stride loop. The pool reads each of its window's
// 9 vectors; the windows of neighbouring threads overlap, so a line is
// fetched from device memory about once and the rest from L1 and L2. The
// sums are kept as separate float32 roundings (no fused multiply-add), as
// the plain versions round them.
//
// The normaliser's and the epilogue's kernels have "elementwise" in their
// names, so a profile's kernel kinds count them with the elementwise
// passes they replace; the stem's pool counts apart, as PyTorch's
// max-pool did.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

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

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

int blocks_for(int64_t items) {
  const int64_t b = (items + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    normalize_elementwise_kernel(const uint8_t* __restrict__ x,
                     const float* __restrict__ mean,
                     const float* __restrict__ stdev, T* __restrict__ out,
                     int64_t pixels, int64_t hw, int c) {
  const float inv = 1.0f / 255.0f;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       p < pixels; p += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t b = p / hw;
    const uint8_t* src = x + b * c * hw + (p - b * hw);
    T* dst = out + p * c;
    for (int k = 0; k < c; ++k) {
      const float v = __fmul_rn(static_cast<float>(src[k * hw]), inv);
      dst[k] = from_f32<T>(
          __fdiv_rn(__fsub_rn(v, __ldg(mean + k)), __ldg(stdev + k)));
    }
  }
}

// y and out may be one tensor (the epilogue runs in place).
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    bias_act_elementwise_kernel(const T* y, const float* __restrict__ bias,
                    const T* __restrict__ res, T* out, int64_t vecs, int c) {
  constexpr int kN = Vec<T>::kN;
  const int cv = c / kN;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < vecs; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const float* b = bias + static_cast<int>(i % cv) * kN;
    float a[kN], r[kN];
    Vec<T>::load(y + i * kN, a);
    if (kResidual) Vec<T>::load(res + i * kN, r);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float t = __fadd_rn(a[j], __ldg(b + j));
      if (kResidual) t = __fadd_rn(t, r[j]);
      a[j] = relu(t);
    }
    Vec<T>::store(out + i * kN, a);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stem_pool_kernel(const T* __restrict__ y, const float* __restrict__ bias,
                     T* __restrict__ out, int h, int w, int c, int oh, int ow,
                     int64_t vecs) {
  constexpr int kN = Vec<T>::kN;
  const int cv = c / kN;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < vecs; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int g = static_cast<int>(i % cv);
    const int64_t p = i / cv;  // the output pixel
    const int ox = static_cast<int>(p % ow);
    const int64_t q = p / ow;
    const int oy = static_cast<int>(q % oh);
    const int64_t img = q / oh;
    float m[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) m[j] = -INFINITY;
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = 2 * oy - 1 + dy;
      if (iy < 0 || iy >= h) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int ix = 2 * ox - 1 + dx;
        if (ix < 0 || ix >= w) continue;
        float v[kN];
        Vec<T>::load(y + ((img * h + iy) * w + ix) * c + g * kN, v);
#pragma unroll
        for (int j = 0; j < kN; ++j)
          if (v[j] > m[j] || isnan(v[j])) m[j] = v[j];  // NaN wins, as in PyTorch
      }
    }
    const float* b = bias + g * kN;
#pragma unroll
    for (int j = 0; j < kN; ++j) m[j] = relu(__fadd_rn(m[j], __ldg(b + j)));
    Vec<T>::store(out + p * c + g * kN, m);
  }
}

template <typename T>
int normalize_launch(const void* x, const float* mean, const float* stdev,
                     void* out, int64_t n, int c, int64_t hw,
                     cudaStream_t s) {
  const int64_t pixels = n * hw;
  normalize_elementwise_kernel<T><<<blocks_for(pixels), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(x), mean, stdev, static_cast<T*>(out),
      pixels, hw, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bias_act_launch(const void* y, const float* bias, const void* res,
                    void* out, int64_t numel, int c, cudaStream_t s) {
  const int64_t vecs = numel / Vec<T>::kN;
  const T* yt = static_cast<const T*>(y);
  T* o = static_cast<T*>(out);
  if (res != nullptr)
    bias_act_elementwise_kernel<T, true><<<blocks_for(vecs), kThreads, 0, s>>>(
        yt, bias, static_cast<const T*>(res), o, vecs, c);
  else
    bias_act_elementwise_kernel<T, false><<<blocks_for(vecs), kThreads, 0, s>>>(
        yt, bias, nullptr, o, vecs, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int stem_pool_launch(const void* y, const float* bias, void* out, int64_t n,
                     int h, int w, int c, int oh, int ow, cudaStream_t s) {
  const int64_t vecs = n * oh * ow * (c / Vec<T>::kN);
  stem_pool_kernel<T><<<blocks_for(vecs), kThreads, 0, s>>>(
      static_cast<const T*>(y), bias, static_cast<T*>(out), h, w, c, oh, ow,
      vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, bound with ctypes. dtype: 0 = float32, 1 = bfloat16 (of the
// activations; the images are uint8, mean, std and bias float32). Every
// tensor is contiguous in the layout named and 16-byte aligned; c is a
// multiple of the vector width (8 bfloat16, 4 float32) except in
// resnet_normalize. Each returns the cudaError_t of its launch.

// x (n, c, hw) uint8 -> out (n, hw, c).
extern "C" int resnet_normalize(const void* x, const void* mean,
                                const void* stdev, void* out, long long n,
                                int c, long long hw, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || c < 1 || hw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* m = static_cast<const float*>(mean);
  const float* sd = static_cast<const float*>(stdev);
  if (dtype == 0) return normalize_launch<float>(x, m, sd, out, n, c, hw, s);
  if (dtype == 1)
    return normalize_launch<__nv_bfloat16>(x, m, sd, out, n, c, hw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y, out (and res, or null) (numel / c, c); bias (c,).
extern "C" int resnet_bias_act(const void* y, const void* bias,
                               const void* res, void* out, long long numel,
                               int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (numel < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0 && c % 4 == 0)
    return bias_act_launch<float>(y, b, res, out, numel, c, s);
  if (dtype == 1 && c % 8 == 0)
    return bias_act_launch<__nv_bfloat16>(y, b, res, out, numel, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y (n, h, w, c) -> out (n, oh, ow, c); bias (c,).
extern "C" int resnet_stem_pool(const void* y, const void* bias, void* out,
                                long long n, int h, int w, int c, int oh,
                                int ow, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0 && c % 4 == 0)
    return stem_pool_launch<float>(y, b, out, n, h, w, c, oh, ow, s);
  if (dtype == 1 && c % 8 == 0)
    return stem_pool_launch<__nv_bfloat16>(y, b, out, n, h, w, c, oh, ow, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
