// Fused transformer MLP of the frozen towers, for Hopper (sm_90a).
//
// Replaces the Pallas kernel outfitx_tpu/ops/mlp.py:_mlp_kernel and computes
// what it computes, per row of x:
//   mid = act(x W1 + b1)     float32 accumulation, bias added in float32,
//                            activation in float32, then rounded to x's dtype
//   out = mid W2 + b2        float32 accumulation, bias added in float32,
//                            rounded to x's dtype
// act is quick_gelu (x sigmoid(1.702 x)), gelu_tanh (the tanh form) or gelu
// (the erf form), the two forms as jax.nn.gelu has them. Inputs: x (rows, d),
// w1 (d, d_mlp), b1 (d_mlp), w2 (d_mlp, d), b2 (d), all of one dtype (float
// or bfloat16; the wrapper casts weights and biases to x's dtype first, as
// the TPU wrapper does), contiguous; d and d_mlp multiples of 16, d <= 768.
//
// What bounds it on an H100. At the vision tower (401,408 rows, 768 -> 3072
// -> 768, bf16) it does 3.79 TFLOP against 1.24 GB of x and out: 3.8 ms of
// tensor-core time against 0.37 ms of memory time, bound by operations. The
// (rows, d_mlp) mid tensor, 2.5 GB each way, never reaches device memory.
//
// Design. The TPU kernel keeps both weight matrices and a (512, d_mlp) mid
// tile in VMEM; a block here has 227 KB. So a block of 256 threads owns 32
// rows: x (32, d) in shared memory in the input dtype, a float32 output
// accumulator (32, d) beside it, and it walks d_mlp in chunks of 128 columns:
//   mid_c = act(x W1[:, c] + b1[c])       (32, 128), rounded to x's dtype
//   acc  += mid_c W2[c, :]                float32, chunk after chunk
// which is the TPU kernel's arithmetic with the sum over d_mlp taken in
// chunk order. The weights (9.4 MB in bf16) are read from global memory by
// every block and stay in L2. In bfloat16 the products go through
// bg::stream_gemm: the weight tiles are copied into shared memory with
// cp.async, two chunks in flight, and multiplied on the tensor cores (wmma)
// with the accumulators in registers. In float32 they go through
// bg::block_gemm's scalar FMAs with the weights read in place. Rows need no
// padding in global memory: the tail block loads zeros and stores only its
// valid rows. Making it faster (wgmma, TMA, more rows per block so that the
// weights are read less often) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr int kChunk = 128;
constexpr int kMaxD = 768;

enum Act { kQuickGelu = 0, kGeluTanh = 1, kGelu = 2 };

__device__ __forceinline__ float activate(float x, int act) {
  if (act == kQuickGelu) return x / (1.f + expf(-1.702f * x));
  if (act == kGeluTanh) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// x (kRows, d + pad) of T; acc (kRows, d + pad) float32; mid (kRows,
// kChunk + pad) float32; for bfloat16 also mid rounded, (kRows, kChunk + pad)
// of T, and bg::stream_gemm's weight staging (float32 rounds mid in place and
// reads the weights in place).
template <typename T>
struct Layout {
  int ldx, ldm;
  size_t x, acc, mid, midt, stage, total;
  __host__ __device__ explicit Layout(int d) {
    const bool is_float = sizeof(T) == sizeof(float);
    ldx = d + bg::kRowPad;
    ldm = kChunk + bg::kRowPad;
    x = 0;
    acc = x + bg::align128(sizeof(T) * kRows * ldx);
    mid = acc + bg::align128(sizeof(float) * kRows * ldx);
    midt = mid + bg::align128(sizeof(float) * kRows * ldm);
    stage = is_float ? midt : midt + bg::align128(sizeof(T) * kRows * ldm);
    total = is_float ? stage : stage + bg::stream_stage_b_bytes(kChunk);
  }
};

// The activation of one (kRows, cw) chunk: smid + b1 -> act -> T. A warp a
// row, a lane a column: no index division.
template <typename T>
__device__ __forceinline__ void activate_chunk(const float* smid, T* smidt,
                                               int ldm, const T* b1c, int cw,
                                               int act) {
  for (int r = threadIdx.x / 32; r < kRows; r += kThreads / 32) {
    for (int c = threadIdx.x % 32; c < cw; c += 32) {
      const float pre = smid[r * ldm + c] + bg::to_f32(b1c[c]);
      smidt[r * ldm + c] = bg::from_f32<T>(activate(pre, act));
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_rows(const float* sacc, int ldx,
                                           const T* b2, T* out, int n_rows,
                                           int d) {
  for (int r = threadIdx.x / 32; r < n_rows; r += kThreads / 32) {
    for (int c = threadIdx.x % 32; c < d; c += 32)
      out[static_cast<size_t>(r) * d + c] =
          bg::from_f32<T>(sacc[r * ldx + c] + bg::to_f32(b2[c]));
  }
}

__global__ void __launch_bounds__(kThreads)
    mlp_fused_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w1,
                          const __nv_bfloat16* __restrict__ b1,
                          const __nv_bfloat16* __restrict__ w2,
                          const __nv_bfloat16* __restrict__ b2,
                          __nv_bfloat16* __restrict__ out, int rows, int d,
                          int d_mlp, int act) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const Layout<bf16> lay(d);
  bf16* sx = reinterpret_cast<bf16*>(smem + lay.x);
  float* sacc = reinterpret_cast<float*>(smem + lay.acc);
  float* smid = reinterpret_cast<float*>(smem + lay.mid);
  bf16* smidt = reinterpret_cast<bf16*>(smem + lay.midt);
  bf16* stage_b = reinterpret_cast<bf16*>(smem + lay.stage);

  const int row0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, rows - row0);
  bg::load_tile(sx, lay.ldx, x + static_cast<size_t>(row0) * d, d, n_rows,
                kRows, d);
  __syncthreads();

  for (int c0 = 0; c0 < d_mlp; c0 += kChunk) {
    const int cw = min(kChunk, d_mlp - c0);
    bg::stream_gemm<2, 1, true>(smid, lay.ldm, false, sx, lay.ldx, bg::NoRows{},
                                w1 + c0, d_mlp, nullptr, stage_b, kRows, cw, d);
    __syncthreads();
    activate_chunk(smid, smidt, lay.ldm, b1 + c0, cw, act);
    __syncthreads();
    for (int n0 = 0; n0 < d; n0 += kChunk)
      bg::stream_gemm<2, 1, true>(sacc + n0, lay.ldx, c0 > 0, smidt, lay.ldm,
                                  bg::NoRows{}, w2 + static_cast<size_t>(c0) * d + n0,
                                  d, nullptr, stage_b, kRows, min(kChunk, d - n0), cw);
    __syncthreads();
  }
  store_rows(sacc, lay.ldx, b2, out + static_cast<size_t>(row0) * d, n_rows, d);
}

__global__ void __launch_bounds__(kThreads)
    mlp_fused_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2, float* __restrict__ out,
                         int rows, int d, int d_mlp, int act) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const Layout<float> lay(d);
  float* sx = reinterpret_cast<float*>(smem + lay.x);
  float* sacc = reinterpret_cast<float*>(smem + lay.acc);
  float* smid = reinterpret_cast<float*>(smem + lay.mid);

  const int row0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, rows - row0);
  bg::load_tile(sx, lay.ldx, x + static_cast<size_t>(row0) * d, d, n_rows,
                kRows, d);
  __syncthreads();

  for (int c0 = 0; c0 < d_mlp; c0 += kChunk) {
    const int cw = min(kChunk, d_mlp - c0);
    bg::block_gemm<false, 2>(smid, lay.ldm, sx, lay.ldx, w1 + c0, d_mlp,
                             kRows, cw, d, false);
    __syncthreads();
    activate_chunk(smid, smid, lay.ldm, b1 + c0, cw, act);
    __syncthreads();
    bg::block_gemm<false, 2>(sacc, lay.ldx, smid, lay.ldm,
                             w2 + static_cast<size_t>(c0) * d, d, kRows, d, cw,
                             c0 > 0);
    __syncthreads();
  }
  store_rows(sacc, lay.ldx, b2, out + static_cast<size_t>(row0) * d, n_rows, d);
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, const void* x, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* out,
                   int rows, int d, int d_mlp, int act, cudaStream_t stream) {
  const size_t smem = Layout<T>(d).total;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (rows + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), rows, d, d_mlp, act);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; act: 0 =
// quick_gelu, 1 = gelu_tanh, 2 = gelu. Returns the cudaError_t of the launch.
extern "C" int mlp_fused(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out, int rows,
                         int d, int d_mlp, int act, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 16 || d > kMaxD || d % 16 || d_mlp < 16 || d_mlp % 16 ||
      act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(mlp_fused_f32_kernel, x, w1, b1, w2, b2, out, rows, d,
                         d_mlp, act, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(mlp_fused_bf16_kernel, x, w1, b1, w2, b2, out,
                                 rows, d, d_mlp, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
