// The ResNet-18 image tower's passes outside cuDNN, NHWC (sm_90a).
//
// Replaces no TPU kernel. The JAX tower leaves the input's normalisation,
// the stem, BatchNorm, the residual add, ReLU and the max-pool to XLA,
// which fuses them into the convolutions and their neighbours; eager
// PyTorch fuses nothing. The port's tower runs NHWC from its input to the
// global pool (cuDNN's own layout on sm_90, so it converts nothing), each
// frozen BatchNorm folded into its convolution's weight and a float32 bias
// (models/towers/resnet.py); these kernels are the passes left outside
// cuDNN, and the stem:
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
//                     pooling the epilogue's output. The float32 tower's
//                     stem (cuDNN's convolution, then this) on the card.
//   resnet_stem_conv_pool
//                     the bfloat16 stem whole: the 7x7/2 convolution at
//                     C = 3 (padding 3), each sum rounded once to bfloat16,
//                     the 3x3/2 max-pool (padding 1) of those, + bias,
//                     relu, rounded once: resnet_stem_pool's rounding
//                     points over cuDNN's convolution, in place of cuDNN's
//                     sm80 kernel (C = 3 padded to 8, about 4% of the bf16
//                     peak), its input-padding pass and resnet_stem_pool.
//                     Only the pooled (N, H/4, W/4, 64) output reaches
//                     device memory; the (N, H/2, W/2, 64) map never does.
//
// What bounds the first three on an H100: bytes. A few operations an
// element against 2 bytes read and written. Each thread owns 16-byte
// vectors (8 bfloat16 or 4 float32 channels), neighbouring threads on
// neighbouring channels and pixels, so loads and stores are whole 128-byte
// lines; the per-channel bias is read through the read-only cache. No
// shared memory, no synchronisation, a grid-stride loop. The pool reads
// each of its window's 9 vectors; the windows of neighbouring threads
// overlap, so a line is fetched from device memory about once and the rest
// from L1 and L2. The sums are kept as separate float32 roundings (no fused
// multiply-add), as the plain versions round them.
//
// What bounds the stem: operations. At 224 x 224 it does 112 * 112 * 64 *
// 147 * 2 = 236 MFLOP an image against 301 KB read and 401 KB written,
// about 340 operations a byte, above the card's 295; 5,600 images take
// 1.34 ms at the bf16 peak, and their bytes 1.17 ms. Its design (the stem
// section below) is an implicit GEMM on wgmma with the im2col done in
// registers and the pool in registers.
//
// The normaliser's and the epilogue's kernels have "elementwise" in their
// names, so a profile's kernel kinds count them with the elementwise
// passes they replace; the stem's pool counts apart, as PyTorch's max-pool
// did, and the stem as the convolution it replaces ("conv").

#include "hopper_gemm.cuh"

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

// ---- the stem ----------------------------------------------------------
// resnet_stem_conv_pool. The convolution is an implicit GEMM: M the conv
// output's pixels of one row, N the 64 channels, K the 7 x 7 x 3 patch laid
// out as 7 kernel rows of kRowK = 22 (a zero column, then the row's 21
// (kx, c) values: column 22 ky + 1 + 3 kx + c), 154 zero-padded to
// kK = 160, 10 k16 steps of wgmma m64n64k16 with float32 sums. The weight
// (64, 160), folded and packed by the wrapper, stays in shared memory as
// the B operand (K-major, three 64-column boxes of TMA's 128-byte swizzle).
// A, the patches, is never written anywhere: each thread loads its
// fragment of A straight from the input rows in shared memory into the
// registers wgmma reads it from. With 22 columns a kernel row, every
// register pair of A is two neighbouring channels of one input row, at an
// even element, so one 32-bit load fills it.
//
// Work. A block walks whole images (blockIdx.x, + gridDim.x), top to
// bottom, so no input row is read twice and no conv row is computed twice.
// Its producer warp streams the image's input rows (iy = -3 .. 2 oh + 1,
// the padding rows copied from a zero row in device memory) by bulk copy
// into a ring of kRing rows; each row goes into two slots, s and s + kRing,
// so the seven rows of any conv row lie in consecutive slots. Each of the
// two consumer warpgroups owns 28 pooled columns (4 warps of 7) and
// computes one m64 tile a conv row. A warp's 16 rows of the tile are the
// 15 conv columns 2 px0 - 1 .. 2 px0 + 13 its 7 pooled columns read (row i
// the column 2 (px0 + i) - 1, row i + 8 the next; row 15 unused), so a
// thread holds the left and centre columns of its pooled column and takes
// the right one from the thread 4 lanes on. The sums are rounded to
// bfloat16 and pooled across in registers; down, the max of an even conv
// row waits in registers for the odd row after it, and the odd row's for
// the next even one. A finished pooled row gets + bias and relu, is
// rounded and leaves through a small staging buffer in 16-byte stores.
// 2 x 64 M rows cover 112 conv columns (87.5% of the products used); K is
// 154 of 160.
//
// What paces it is not the tensor cores (the products of a conv row are
// about a sixth of a warpgroup's time on it; m64n64k16 from registers runs
// at 870-960 TFLOP/s on an H100 SXM when fed) but the instructions around
// them: the barrier waits, the loads of A, the epilogue, issued by warps
// that wait on each other's results. So two blocks share an SM (at most
// 112 registers a thread), four consumer warpgroups to fill each other's
// gaps, and a row goes back to the producer with one arrival a warp.
//
// Input rows must be whole 16-byte units (W a multiple of 8) and fit a
// slot (W <= 224); the wrapper checks both. A non-finite input value meets
// a zero weight in the K padding of a neighbouring column, and so reaches
// one more output column than in cuDNN's convolution; the tower's inputs
// are the normaliser's, always finite.
namespace stem {

constexpr int kCout = 64;
constexpr int kRowK = 22;
constexpr int kK = 160;
constexpr int kSteps = kK / 16;
constexpr int kMaxW = 224;
// A slot: kLead zero elements, the row (3 W <= 672 elements), zeros. The
// row's pixel ix, channel c is element kLead + 3 ix + c; A's element
// (conv column ox, K column 22 ky + jj) is element 6 ox + jj + kLead - 10
// of kernel row ky's slot (pixel 2 ox - 3 + kx, channel c, jj = 1 + 3 kx
// + c), so conv column -1 reads from element 0 and conv column 112 ends
// before element 704. K columns 154-159 (zero weights) read kernel row 7's
// first elements: a row of the ring, finite.
constexpr int kLead = 16;
constexpr int kSlotBytes = 1408;
constexpr int kRing = 16;
constexpr int kBlocksPerSm = 2;
constexpr int kPoolCols = 28;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;
constexpr int kWBoxBytes = 64 * 64 * 2;
// A warp's staging buffer: its 7 pooled pixels' 128 bytes, 144 bytes apart
// (the quad of threads of one pixel writes 16 bytes; 144 spreads a warp's
// 7 pixels over all banks).
constexpr int kStagePixel = 144;
constexpr int kStageBytes = 1024;

struct Smem {
  static constexpr int kRingOff = 3 * kWBoxBytes;
  static constexpr int kStageOff = kRingOff + 2 * kRing * kSlotBytes;
  static constexpr int kBarOff = kStageOff + 8 * kStageBytes;
  // The weight's boxes, the ring, the staging buffers, barriers, room to
  // align to 1024: about 79 KB, two blocks an SM.
  static constexpr int kBytes = kBarOff + (2 * kRing + 1) * 8 + 1024;
};

// A 32-bit load from shared memory; volatile, so it stays after the
// barrier wait that guards it.
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// One conv row's fragment of A. bq: the byte address of the thread's conv
// column's first element in kernel row 0's slot, + 4 q. K columns 8 t +
// 2 q, + 1 (t = 2 s + half) lie in kernel row ky0 = 8 t / 22 at column
// 8 t % 22 + 2 q, or, where bit t of `cross` is set, one row on, 22
// columns back.
__device__ __forceinline__ void gather(uint32_t (&a)[kSteps][4], uint32_t bq,
                                       uint32_t cross) {
  const uint32_t bx = bq + kSlotBytes - 2 * kRowK;
#pragma unroll
  for (int t = 0; t < 2 * kSteps; ++t) {
    const uint32_t p = ((cross >> t) & 1 ? bx : bq) + 8 * t / kRowK * kSlotBytes +
                       2 * (8 * t % kRowK + kLead - 10);
    a[t / 2][2 * (t % 2)] = lds32(p);
    a[t / 2][2 * (t % 2) + 1] = lds32(p + 12);  // row i + 8: one column on
  }
}

// The larger of two bfloat16 pairs, lane by lane; a NaN wins, as in
// PyTorch's max-pool.
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// A conv row's sums rounded to bfloat16, then the max over each pooled
// column's three conv columns (the left one absent at pooled column 0).
__device__ __forceinline__ void pool_across(const float* acc, bool left,
                                            uint32_t* hm) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const uint32_t l = hg::pack_bf16(acc[4 * g], acc[4 * g + 1]);
    const uint32_t c = hg::pack_bf16(acc[4 * g + 2], acc[4 * g + 3]);
    const uint32_t r = __shfl_down_sync(0xffffffffu, l, 4);
    hm[g] = max_bf16x2(c, r);
    if (left) hm[g] = max_bf16x2(hm[g], l);
  }
}

// Keeps A's registers live until the products that read them are done.
__device__ __forceinline__ void fence_a(uint32_t (&a)[kSteps][4]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[s][j])::"memory");
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    stem_conv_pool_kernel(const __grid_constant__ CUtensorMap map_w,
                          const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ zeros,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int64_t n, int h,
                          int w, int oh, int ph, int pw) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* wbuf = smem;
  uint8_t* ring = smem + Smem::kRingOff;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem::kBarOff);
  uint64_t* empty = full + kRing;
  uint64_t* wbar = empty + kRing;
  const int tiles = (pw + kPoolCols - 1) / kPoolCols;  // 1 or 2
  const int rows = 2 * oh + 5;                         // iy = -3 .. 2 oh + 1
  const int row_bytes = 6 * w;

  for (int i = threadIdx.x; i < 2 * kRing * kSlotBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      hg::mbar_init(&full[s], 1);
      hg::mbar_init(&empty[s], 4 * tiles);  // every consumer warp arrives
    }
    hg::mbar_init(wbar, 1);
    hg::mbar_init_fence();
  }
  hg::fence_async_smem();  // the zeros, before any bulk copy into the ring
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      hg::mbar_expect_tx(wbar, 3 * kWBoxBytes);
      for (int kb = 0; kb < 3; ++kb)
        hg::tma_load(wbuf + kb * kWBoxBytes, &map_w, 64 * kb, 0, wbar);
      uint32_t g = 0;
      for (int64_t img = blockIdx.x; img < n; img += gridDim.x)
        for (int v = 0; v < rows; ++v, ++g) {
          const int s = g % kRing;
          hg::mbar_wait(&empty[s], ((g / kRing) & 1) ^ 1);
          const int iy = v - 3;
          const __nv_bfloat16* src =
              iy >= 0 && iy < h ? x + (img * h + iy) * (3 * static_cast<int64_t>(w))
                                : zeros;
          hg::mbar_expect_tx(&full[s], 2 * row_bytes);
          hg::bulk_load(ring + s * kSlotBytes + 2 * kLead, src, row_bytes, &full[s]);
          hg::bulk_load(ring + (s + kRing) * kSlotBytes + 2 * kLead, src, row_bytes,
                        &full[s]);
        }
    }
    return;
  }
  const int wg = threadIdx.x / 128;
  if (wg >= tiles) return;
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int i = lane / 4, q = lane % 4;
  const int px0 = kPoolCols * wg + 7 * warp;  // the warp's first pooled column
  const int col = 2 * (px0 + i) - 1;           // A row i's conv column
  const int valid = min(7, pw - px0);          // pooled columns the warp writes
  uint8_t* stage = smem + Smem::kStageOff + (threadIdx.x / 32) * kStageBytes;
  const uint32_t lane_base = hg::smem_u32(ring) + 12 * col + 4 * q;
  uint32_t cross = 0;
#pragma unroll
  for (int t = 0; t < 2 * kSteps; ++t)
    cross |= static_cast<uint32_t>(8 * t % kRowK + 2 * q >= kRowK) << t;
  hg::mbar_wait(wbar, 0);

  float acc[32];
  uint32_t run[8], prev[8];
  uint32_t g0 = 0;  // the ring's count of rows before this image's first
  for (int64_t img = blockIdx.x; img < n; img += gridDim.x, g0 += rows) {
    __nv_bfloat16* out_img = out + img * ph * pw * kCout;
    for (int oy = 0; oy < oh; ++oy) {
      for (int v = oy == 0 ? 0 : 2 * oy + 5; v <= 2 * oy + 6; ++v) {
        const uint32_t g = g0 + v;
        hg::mbar_wait(&full[g % kRing], (g / kRing) & 1);
      }
      uint32_t a[kSteps][4];
      gather(a, lane_base + (g0 + 2 * oy) % kRing * kSlotBytes, cross);
      hg::wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        hg::wgmma_rs<64, 0>(acc, a[s],
                            hg::desc_kmajor(wbuf + s / 4 * kWBoxBytes + 32 * (s % 4)),
                            s != 0);
      hg::wgmma_commit();
      // The products hold A's values, so every lane's loads are done: the
      // rows no later conv row reads go back to the producer.
      __syncwarp();
      if (lane == 0)
        for (int v = 2 * oy, done = oy == oh - 1 ? rows : 2 * oy + 2; v < done; ++v)
          hg::mbar_arrive(&empty[(g0 + v) % kRing]);
      hg::wgmma_wait<0>();
      hg::fence_regs<32>(acc);
      fence_a(a);

      uint32_t hm[8];
      pool_across(acc, col >= 0, hm);
      // Down: pooled row py takes conv rows 2 py - 1, 2 py and 2 py + 1.
      const bool even = (oy & 1) == 0;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        if (even) {
          run[g] = oy == 0 ? hm[g] : max_bf16x2(prev[g], hm[g]);
        } else {
          run[g] = max_bf16x2(run[g], hm[g]);
          prev[g] = hm[g];
        }
      }
      if (even && oy != oh - 1) continue;
      if (i < 7) {
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const float lo = __uint_as_float(run[g] << 16);
          const float hi = __uint_as_float(run[g] & 0xffff0000u);
          *reinterpret_cast<uint32_t*>(stage + i * kStagePixel + 16 * g + 4 * q) =
              hg::pack_bf16(relu(__fadd_rn(lo, __ldg(bias + 8 * g + 2 * q))),
                            relu(__fadd_rn(hi, __ldg(bias + 8 * g + 2 * q + 1))));
        }
      }
      __syncwarp();
      __nv_bfloat16* dst = out_img + (static_cast<int64_t>(oy / 2) * pw + px0) * kCout;
      for (int c = lane; c < 8 * valid; c += 32)
        *reinterpret_cast<uint4*>(dst + 8 * c) =
            *reinterpret_cast<const uint4*>(stage + c / 8 * kStagePixel + c % 8 * 16);
      __syncwarp();
    }
  }
}

int stem_conv_pool_launch(const void* x, const void* weight, const void* zeros,
                          const float* bias, void* out, int64_t n, int h,
                          int w, cudaStream_t s) {
  CUtensorMap map_w;
  if (w % 8 || w > kMaxW ||
      !hg::tensor_map(&map_w, weight, kCout, kK, kK, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int oh = (h - 1) / 2 + 1, ow = (w - 1) / 2 + 1;
  const int ph = (oh - 1) / 2 + 1, pw = (ow - 1) / 2 + 1;
  const cudaError_t err = cudaFuncSetAttribute(
      stem_conv_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = kBlocksPerSm * static_cast<int64_t>(hg::sm_count());
  stem_conv_pool_kernel<<<static_cast<int>(n < blocks ? n : blocks), kThreads,
                          Smem::kBytes, s>>>(
      map_w, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(zeros), bias,
      static_cast<__nv_bfloat16*>(out), n, h, w, oh, ph, pw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stem

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

// x (n, h, w, 3) bfloat16 -> out (n, ph, pw, 64) bfloat16, the stem whole
// (see the stem section); weight (64, 160) bfloat16, the folded weight in
// the kernel's K order; zeros 6 w bytes of zeros, 16-byte aligned; bias
// (64,) float32. w a multiple of 8, at most 224.
extern "C" int resnet_stem_conv_pool(const void* x, const void* weight,
                                     const void* zeros, const void* bias,
                                     void* out, long long n, int h, int w,
                                     void* stream) {
  if (n < 1 || h < 1 || w < 8) return static_cast<int>(cudaErrorInvalidValue);
  return stem::stem_conv_pool_launch(x, weight, zeros,
                                     static_cast<const float*>(bias), out, n, h,
                                     w, static_cast<cudaStream_t>(stream));
}
