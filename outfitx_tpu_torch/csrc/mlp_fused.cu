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
// tensor-core time against 0.37 ms of memory time, bound by operations.
//
// bfloat16 design: two passes of hg::gemm (hopper_gemm.cuh), the persistent
// warp-specialised wgmma GEMM with TMA loads and stores:
//   pass 1  mid = act(x W1 + b1)  the bias, the activation and the rounding
//                                 in the epilogue, on the accumulators
//   pass 2  out = mid W2 + b2     the bias and the rounding in the epilogue
// The mid tensor goes through device memory, in chunks of rows that the
// wrapper's scratch holds (mid_rows). Keeping the whole MLP in one block, as
// the TPU kernel does in VMEM, does not fit here: a 128-row block's float32
// output accumulator (128 x 768 x 4 = 393 KB) is larger than the register
// file, so such a block holds at most about 64 rows and re-reads both weight
// matrices (9.4 MB) every 64 rows. The mid round trip costs 2 x 2.47 GB at
// the vision rows, about 1.5 ms of memory time, spread over two passes that
// are bound by the tensor cores; the GEMM's tiles read about 44 GB through
// L2 per launch at those rows, where the earlier one-block kernel read
// 118 GB.
//
// float32 (the correctness route; no main path on the card runs it): a
// block of 256 threads owns 32 rows, x (32, d) and a float32 accumulator
// (32, d) in shared memory, and walks d_mlp in chunks of 128 columns:
//   mid_c = act(x W1[:, c] + b1[c])       (32, 128)
//   acc  += mid_c W2[c, :]                chunk after chunk
// through bg::block_gemm's scalar FMAs with the weights read in place from
// L2. Rows need no padding in global memory: the tail block loads zeros and
// stores only its valid rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_gemm.cuh"
#include "hopper_gemm.cuh"

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

// The bfloat16 epilogue's forms of the same functions: x sigmoid(z) as
// x / (1 + exp(-z)) with the fast exponential and division (2 ulps of
// float32; the tanh form through 0.5 (1 + tanh(u)) = sigmoid(2 u)). They
// differ from activate() far below the bfloat16 rounding that follows.
__device__ __forceinline__ float activate_fast(float x, int act) {
  if (act == kQuickGelu) return __fdividef(x, 1.f + __expf(-1.702f * x));
  if (act == kGeluTanh) {
    const float u2 = 1.5957691216057308f * (x + 0.044715f * x * x * x);
    return __fdividef(x, 1.f + __expf(-u2));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// float32: x (kRows, d + pad), the accumulator acc (kRows, d + pad) and one
// chunk of mid (kRows, kChunk + pad), all float32 in shared memory.
struct Layout {
  int ldx, ldm;
  size_t x, acc, mid, total;
  __host__ __device__ explicit Layout(int d) {
    ldx = d + bg::kRowPad;
    ldm = kChunk + bg::kRowPad;
    x = 0;
    acc = x + bg::align128(sizeof(float) * kRows * ldx);
    mid = acc + bg::align128(sizeof(float) * kRows * ldx);
    total = mid + bg::align128(sizeof(float) * kRows * ldm);
  }
};

// The activation of one (kRows, cw) chunk in place: smid + b1 -> act. A
// warp a row, a lane a column: no index division.
__device__ __forceinline__ void activate_chunk(float* smid, int ldm,
                                               const float* b1c, int cw,
                                               int act) {
  for (int r = threadIdx.x / 32; r < kRows; r += kThreads / 32) {
    for (int c = threadIdx.x % 32; c < cw; c += 32)
      smid[r * ldm + c] = activate(smid[r * ldm + c] + b1c[c], act);
  }
}

__device__ __forceinline__ void store_rows(const float* sacc, int ldx,
                                           const float* b2, float* out,
                                           int n_rows, int d) {
  for (int r = threadIdx.x / 32; r < n_rows; r += kThreads / 32) {
    for (int c = threadIdx.x % 32; c < d; c += 32)
      out[static_cast<size_t>(r) * d + c] = sacc[r * ldx + c] + b2[c];
  }
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
  const Layout lay(d);
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
    bg::block_gemm<false>(smid, lay.ldm, sx, lay.ldx, w1 + c0, d_mlp,
                          kRows, cw, d, false);
    __syncthreads();
    activate_chunk(smid, lay.ldm, b1 + c0, cw, act);
    __syncthreads();
    bg::block_gemm<false>(sacc, lay.ldx, smid, lay.ldm,
                          w2 + static_cast<size_t>(c0) * d, d, kRows, d, cw,
                          c0 > 0);
    __syncthreads();
  }
  store_rows(sacc, lay.ldx, b2, out + static_cast<size_t>(row0) * d, n_rows, d);
}

cudaError_t launch_f32(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int rows,
                       int d, int d_mlp, int act, cudaStream_t stream) {
  const size_t smem = Layout(d).total;
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_fused_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (rows + kRows - 1) / kRows;
  mlp_fused_f32_kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), rows, d, d_mlp,
      act);
  return cudaGetLastError();
}

// ---- bfloat16: two passes of hg::gemm -------------------------------------
// Pass 1's epilogue: mid = bfloat16(act(acc + b1)), bias and activation in
// float32. The activation is a template argument: with it a runtime value,
// the compiler evaluated all three forms for every element.
template <int Act>
struct MlpMidEpi {
  using Out = __nv_bfloat16;
  const __nv_bfloat16* b1;
  __device__ __forceinline__ void operator()(int c, float& v0, float& v1) const {
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(b1 + c));
    v0 = activate_fast(v0 + b.x, Act);
    v1 = activate_fast(v1 + b.y, Act);
  }
};

// Pass 2's epilogue: out = bfloat16(acc + b2), the bias in float32.
struct MlpOutEpi {
  using Out = __nv_bfloat16;
  const __nv_bfloat16* b2;
  __device__ __forceinline__ void operator()(int c, float& v0, float& v1) const {
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(b2 + c));
    v0 += b.x;
    v1 += b.y;
  }
};

template <int Act>
cudaError_t pass1(const void* x, int d, const void* w1, const void* b1,
                  void* mid, int d_mlp, int n, cudaStream_t stream) {
  return hg::gemm(x, d, w1, d_mlp, mid, d_mlp, n, d_mlp, d,
                  MlpMidEpi<Act>{static_cast<const __nv_bfloat16*>(b1)}, stream);
}

// Rows in chunks of mid_rows (the scratch's height): pass 1 of a chunk
// writes mid, pass 2 reads it back.
cudaError_t launch_bf16(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* out, void* mid,
                        int mid_rows, int rows, int d, int d_mlp, int act,
                        cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (mid == nullptr || mid_rows < 1) return cudaErrorInvalidValue;
  for (int r0 = 0; r0 < rows; r0 += mid_rows) {
    const int n = min(mid_rows, rows - r0);
    const bf16* xc = static_cast<const bf16*>(x) + static_cast<size_t>(r0) * d;
    cudaError_t err =
        act == kQuickGelu  ? pass1<kQuickGelu>(xc, d, w1, b1, mid, d_mlp, n, stream)
        : act == kGeluTanh ? pass1<kGeluTanh>(xc, d, w1, b1, mid, d_mlp, n, stream)
                           : pass1<kGelu>(xc, d, w1, b1, mid, d_mlp, n, stream);
    if (err != cudaSuccess) return err;
    err = hg::gemm(mid, d_mlp, w2, d,
                   static_cast<bf16*>(out) + static_cast<size_t>(r0) * d, d, n,
                   d, d_mlp, MlpOutEpi{static_cast<const bf16*>(b2)}, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; act: 0 =
// quick_gelu, 1 = gelu_tanh, 2 = gelu; mid: bfloat16 scratch (mid_rows,
// d_mlp) for dtype 1, unused for dtype 0. Returns the cudaError_t of the
// launches.
extern "C" int mlp_fused(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out, void* mid,
                         int mid_rows, int rows, int d, int d_mlp, int act,
                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 16 || d > kMaxD || d % 16 || d_mlp < 16 || d_mlp % 16 ||
      act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_f32(x, w1, b1, w2, b2, out, rows, d, d_mlp, act, s);
  if (dtype == 1)
    return launch_bf16(x, w1, b1, w2, b2, out, mid, mid_rows, rows, d, d_mlp,
                       act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
