// Masked multi-head set attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel outfitx_tpu/ops/attention.py:_mha_kernel and
// computes what it computes, per (batch row b, head h):
//   S = Q K^T * (1/sqrt(Dh))          float32 accumulation
//   S[:, j] = -1e9 where key j is pad  a where-SET, never -inf, so a row whose
//   S[i, j] = -1e9 where j > i         keys are all masked gets uniform
//                                      weights (as in JAX), not NaN
//   P = softmax(S) in float32 (subtract max, exp, divide), one pass
//   P is rounded to the input dtype before P V (as _mha_kernel does)
//   O = P V                            float32 accumulation, written in the
//                                      input dtype
// Inputs: q, k, v, out contiguous (B, H, L, Dh) of float or bfloat16;
// pad (B, L) of bytes (torch.bool), nonzero = pad. 1 <= L <= 256; Dh <= 128
// and a multiple of 8 (16 above L = 64).
//
// What bounds it on an H100: bytes. The function reads q, k, v and writes
// out once: at the set transformer's throughput shape (4096, 16, 17, 96) in
// bfloat16 that is 856 MB, 0.255 ms at 3.35 TB/s, against 7.3 GFLOP (7 us of
// tensor-core time); at the SigLIP vision tower's (2048, 12, 196, 64) it is
// 2.47 GB, 0.736 ms, against 242 GFLOP (0.24 ms).
//
// bfloat16 with Dh a multiple of 16 (every main path) works on tiles of 64
// query rows of the flat (B H L, Dh) arrays, where each (b, h) slab is L
// consecutive rows, so one 64-row TMA box (128-byte swizzle) covers several
// slabs. P V is wgmma with V from shared memory, and the output leaves the
// accumulator fragments as bfloat16 pairs. By length (dispatch_tiles):
//   L <= 32   masked_mha_fwd_packed_kernel: floor(64 / L) consecutive slabs
//             in one tile (3 at L = 17: 51 of 64 rows, 21,846 blocks at
//             B = 4096 instead of 65,536 of 17 rows). S only within each
//             slab, summed in order over d on the CUDA cores as the plain
//             version's _scores sums it, and each row's softmax over the
//             tree of torch.softmax's warp softmax (below, why that
//             matters); P goes into a swizzled tile (0 off the row's slab)
//             for wgmma_ss.
//   L > 32    masked_mha_fwd_long_tile_kernel: one slab a tile, ceil(L / 64)
//             query tiles against all L keys at once: S by wgmma_ss at N =
//             64, 128 or 256 with K as the K-major B operand, the softmax on
//             the accumulator fragments with two quad shuffles, one pass
//             with no rescaling, so P rounds where _mha_kernel rounds it; P
//             packed to bfloat16 is the register A operand of wgmma_rs. A
//             block walks the query tiles of its (b, h) with K and V loaded
//             once, and loads the next tile's Q while it finishes this one.
//             Key rows past L belong to the next slab or are TMA's zeros:
//             -inf, so P is exactly 0 there.
// Rows past the tensor are TMA's zeros and never stored. Q and K columns
// past Dh are TMA's zeros, so S takes all the columns of its boxes; P V
// computes 64 or 128 columns and stores Dh. The inputs must be finite: P V
// multiplies P = 0 by the V rows of the tile's other slabs and of the next
// slab, and 0 * Inf is NaN, so an Inf in one (b, h) slab's V would turn its
// neighbours' rows to NaN, where the plain version keeps slabs apart.
//
// float32 (the correctness route; no main path on the card runs it) and
// bfloat16 at a Dh that is not a multiple of 16 keep the scalar designs:
// L <= 64 one block of 128 threads per (b, h) with Q, K, V widened to
// float32 in shared memory and both products as scalar FMAs; float32 above
// L = 64 tiles the queries, 32 rows at a time, with every key and value of
// the (b, h) in shared memory and the products as bg::block_gemm's scalar
// FMAs (block_gemm.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_gemm.cuh"
#include "hopper_gemm.cuh"

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

// Same rounding as the reference: 1/sqrt(Dh) in double, then to float.
inline float softmax_scale(int Dh) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
}

// ---- float32, or bfloat16 at Dh % 16 != 0; L <= 64 ------------------------

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
cudaError_t launch_short(const void* q, const void* k, const void* v,
                         const void* pad, void* out, int B, int H, int L,
                         int Dh, int causal, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(L) * Dh +
                       2 * static_cast<size_t>(L) * (Dh + 1) +
                       static_cast<size_t>(L) * L) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_mha_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  masked_mha_fwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(pad),
      static_cast<T*>(out), H, L, Dh, softmax_scale(Dh), causal);
  return cudaGetLastError();
}

// ---- float32, 64 < L <= 256: query-tiled ------------------------------------

constexpr int kLongThreads = 256;
constexpr int kQTile = 32;

// The most dynamic shared memory a block can have on sm_90.
constexpr size_t kMaxSmem = 227 * 1024;

// Shared-memory layout of the long float32 kernel, used by the kernel and by
// the launch: K (Lp, Dh + pad); V the same, in a buffer of its own where both
// fit (`resident`), else in K's place once the scores are formed; Q
// (kQTile, Dh + pad), later the output tile in the same place; scores, then
// P in place, (kQTile, Lp + pad).
struct LongLayout {
  int lp, ldt, lds;
  bool resident;
  size_t k, v, qo, s, total;
  __host__ __device__ LongLayout(int L, int Dh) {
    lp = bg::round16(L);
    ldt = Dh + bg::kRowPad;
    lds = lp + bg::kRowPad;
    const size_t slab = bg::align128(sizeof(float) * lp * ldt);
    const size_t rest = bg::align128(sizeof(float) * kQTile * ldt) +
                        bg::align128(sizeof(float) * kQTile * lds);
    resident = 2 * slab + rest <= kMaxSmem;
    k = 0;
    v = resident ? slab : 0;
    qo = v + slab;
    s = qo + bg::align128(sizeof(float) * kQTile * ldt);
    total = qo + rest;
  }
};

// With K and V resident a block takes every query tile of its (b, h) in
// turn and reads K and V once; otherwise a block takes one query tile and
// loads K, then V in its place.
__global__ void __launch_bounds__(kLongThreads)
    masked_mha_fwd_long_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const uint8_t* __restrict__ pad,
                               float* __restrict__ out, int H, int L, int Dh,
                               float scale, int causal) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const LongLayout lay(L, Dh);
  float* sk = reinterpret_cast<float*>(smem + lay.k);
  float* sv = reinterpret_cast<float*>(smem + lay.v);
  float* sqo = reinterpret_cast<float*>(smem + lay.qo);
  float* ss = reinterpret_cast<float*>(smem + lay.s);

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
    bg::load_tile(sqo, lay.ldt, q + base + static_cast<size_t>(q0) * Dh, Dh, nq,
                  kQTile, Dh);
    if (!lay.resident) bg::load_tile(sk, lay.ldt, k + base, Dh, L, lay.lp, Dh);
    __syncthreads();
    // S = Q K^T: K is stored (L, Dh), the product's B read column-major.
    bg::block_gemm<true>(ss, lay.lds, sqo, lay.ldt, sk, lay.ldt, kQTile,
                         lay.lp, Dh, false);
    __syncthreads();
    // Not resident: the keys are done with, the values take their place.
    if (!lay.resident) bg::load_tile(sv, lay.ldt, v + base, Dh, L, lay.lp, Dh);
    for (int i = warp; i < kQTile; i += kLongThreads / 32) {
      if (i < nq)
        bg::softmax_row<float>(ss + i * lay.lds, ss + i * lay.lds, prow, L,
                               lay.lp, q0 + i, scale, causal);
      else
        bg::zero_row<float>(ss + i * lay.lds, lay.lp);
    }
    __syncthreads();
    // O = P V into the place Q had.
    bg::block_gemm<false>(sqo, lay.ldt, ss, lay.lds, sv, lay.ldt, kQTile, Dh,
                          lay.lp, false);
    __syncthreads();
    for (int e = threadIdx.x; e < nq * Dh; e += kLongThreads) {
      const int i = e / Dh;
      const int d = e - i * Dh;
      out[base + static_cast<size_t>(q0 + i) * Dh + d] = sqo[i * lay.ldt + d];
    }
    // The next tile's Q goes where this tile's output lies.
    __syncthreads();
  }
}

cudaError_t launch_long_f32(const void* q, const void* k, const void* v,
                            const void* pad, void* out, int B, int H, int L,
                            int Dh, int causal, cudaStream_t stream) {
  const LongLayout lay(L, Dh);
  const cudaError_t err = cudaFuncSetAttribute(
      masked_mha_fwd_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.total));
  if (err != cudaSuccess) return err;
  const int q_tiles = (L + kQTile - 1) / kQTile;
  const int blocks = B * H * (lay.resident ? 1 : q_tiles);
  masked_mha_fwd_long_kernel<<<blocks, kLongThreads, lay.total, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(pad),
      static_cast<float*>(out), H, L, Dh, softmax_scale(Dh), causal);
  return cudaGetLastError();
}

// ---- bfloat16, Dh a multiple of 16 -------------------------------------------

constexpr int kTile = 64;  // query rows of a tile: wgmma's M

// Byte offset of element (r, c) of a (64, 64) bfloat16 tile in the 128-byte
// swizzle that TMA writes and the wgmma descriptors name: row r at r * 128,
// its 16-byte chunks permuted by r % 8.
__device__ __forceinline__ int swizzled(int r, int c) {
  const int byte = 2 * c;
  return r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
}

// ---- L <= 32: slabs packed into a tile ---------------------------------------
//
// A block takes `slabs` (>= 2) consecutive (b, h) slabs, slabs * L <= 64
// rows of the flat arrays, with Q, K and V by TMA. The scores and the
// softmax repeat the plain version's float32 arithmetic step for step: S is
// summed over d in order on the CUDA cores, as its _scores sums it
// (bfloat16 products are exact in float32), only within each slab (slabs *
// L * L dots, not 64 x 64), and each row's softmax as torch.softmax's warp
// softmax takes it, key j in lane j, max and sum by its butterfly. Rows with
// few keys need this: a sum in another order moves S or the row's sum by an
// ulp, P near 1 then flips a bfloat16 ulp, and the output moves by 2^-8 |v|,
// beyond the bfloat16 check's limit (a wgmma S did that at (4096, 16, 17,
// 96) causal; cuBLAS's float32 product, which sums in another order below
// L = 16, at (4096, 16, 9, 96)). The butterfly is PyTorch's and not
// documented: a release that sums another way can fail that check on
// rounding alone. A thread scores a unit of one key against four query rows
// (four running sums, the bfloat16 operands widened in registers); the
// scores wait in shared memory in Q's and K's place for the row softmax, a
// thread a row. P (bfloat16) goes into a swizzled (64, 64) tile, keys of
// another slab and rows past the tile left 0, and O = P V is one wgmma_ss
// per k16 step, whose sums run in another order than the plain version's.
constexpr int kPackedL = 32;  // the longest slab packed: two to a tile

// Index of score (r, j) in the (64, 64) float32 score block: the 4-float
// groups of row r permuted by r % 8, so that 8 threads reading 8 rows'
// same group hit 8 bank groups.
__device__ __forceinline__ int score_at(int r, int j) {
  return r * kTile + (j ^ ((r & 7) << 2));
}
constexpr int kUnitRows = 4;
constexpr int kMaxUnits = 4;  // units a thread: at most 64 * 8 / 128 (L = 32)

template <int NB>
struct PackedLayout {
  // Q, K, V: NB boxes of (64 rows, 64 columns) each, Q and K adjacent; once
  // they are read, the float32 (64, 64) scores take their first 16 KB and
  // the P tile the next 8 KB where there are (NB = 2), else its own place.
  static constexpr int kBox = NB * hg::kBoxBytes;
  static constexpr int kScores = 4 * kTile * kTile;
  static constexpr int kQ = 0, kK = kBox, kV = 2 * kBox;
  static constexpr int kP = 2 * kBox >= kScores + hg::kBoxBytes ? kScores : 3 * kBox;
  static constexpr int kEnd = kP == kScores ? 3 * kBox : 3 * kBox + hg::kBoxBytes;
  static constexpr int kBytes = kEnd + 8 + 1024;
  static_assert(2 * kBox >= kScores, "the scores fit Q and K");
};

// Eight bfloat16 of 16-byte chunk `chunk` (8 columns) of row r of a tile of
// NB swizzled (64, 64) boxes, as float32.
__device__ __forceinline__ void chunk_f32(const uint8_t* tile, int r, int chunk,
                                          float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(
      tile + (chunk >> 3) * hg::kBoxBytes + r * 128 + (((chunk & 7) ^ (r & 7)) << 4));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    f[2 * t] = __uint_as_float(w[t] << 16);
    f[2 * t + 1] = __uint_as_float(w[t] & 0xFFFF0000u);
  }
}

template <int NB>
__global__ void __launch_bounds__(128)
    masked_mha_fwd_packed_kernel(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const uint8_t* __restrict__ pad,
                                 __nv_bfloat16* __restrict__ out, int BH,
                                 int H, int L, int Dh, int slabs, float scale,
                                 int causal) {
  using Lay = PackedLayout<NB>;
  constexpr int NPV = NB == 1 ? 64 : 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint8_t* sq = smem + Lay::kQ;
  const uint8_t* sk = smem + Lay::kK;
  uint8_t* sv = smem + Lay::kV;
  uint8_t* sp = smem + Lay::kP;
  float* ss = reinterpret_cast<float*>(smem + Lay::kQ);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Lay::kEnd);

  const int slab0 = blockIdx.x * slabs;
  const int live = min(slabs, BH - slab0);  // the tile's slabs
  const int rows = live * L;
  const int row0 = slab0 * L;
  if (threadIdx.x == 0) {
    hg::mbar_init(bar, 1);
    hg::mbar_init_fence();
    hg::mbar_expect_tx(bar, 3 * Lay::kBox);
    const CUtensorMap* maps[3] = {&map_q, &map_k, &map_v};
    for (int i = 0; i < 3; ++i)
      for (int cb = 0; cb < NB; ++cb)
        hg::tma_load(smem + i * Lay::kBox + cb * hg::kBoxBytes, maps[i],
                     64 * cb, row0, bar);
  }
  __syncthreads();
  hg::mbar_wait(bar, 0);

  // Scores of each (row i, key j) of a slab, with the key mask and the
  // causal mask set, not added. Unit u is key j = u % L against rows
  // 4 g .. 4 g + 3 of slab sl, (sl, g) = divmod(u / L, ng): neighbouring
  // threads read neighbouring key rows and the same query rows.
  const int ng = (L + kUnitRows - 1) / kUnitRows;
  const int n_units = live * L * ng;
  float sreg[kMaxUnits][kUnitRows];
#pragma unroll
  for (int t = 0; t < kMaxUnits; ++t) {
    const int u = threadIdx.x + 128 * t;
    if (u < n_units) {
      const int j = u % L;
      const int sl = u / L / ng;
      const int i0 = (u / L - sl * ng) * kUnitRows;
      const int kr = sl * L + j;
      int qr[kUnitRows];
#pragma unroll
      for (int m = 0; m < kUnitRows; ++m) qr[m] = sl * L + min(i0 + m, L - 1);
      float acc[kUnitRows] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < Dh / 8; ++c) {
        float y[8];
        chunk_f32(sk, kr, c, y);
#pragma unroll
        for (int m = 0; m < kUnitRows; ++m) {
          float x[8];
          chunk_f32(sq, qr[m], c, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[m] = fmaf(x[e], y[e], acc[m]);
        }
      }
      const bool padded = pad[static_cast<size_t>((slab0 + sl) / H) * L + j];
#pragma unroll
      for (int m = 0; m < kUnitRows; ++m) {
        float v = acc[m] * scale;
        if (padded) v = kNeg;
        if (causal && j > i0 + m) v = kNeg;
        sreg[t][m] = v;
      }
    }
  }
  __syncthreads();  // Q and K are read: the scores and P take their place
  for (int c = threadIdx.x; c < hg::kBoxBytes / 16; c += 128)
    reinterpret_cast<uint4*>(sp)[c] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int t = 0; t < kMaxUnits; ++t) {
    const int u = threadIdx.x + 128 * t;
    if (u < n_units) {
      const int j = u % L;
      const int sl = u / L / ng;
      const int i0 = (u / L - sl * ng) * kUnitRows;
#pragma unroll
      for (int m = 0; m < kUnitRows; ++m)
        if (i0 + m < L) ss[score_at(sl * L + i0 + m, j)] = sreg[t][m];
    }
  }
  __syncthreads();

  // Row softmax, a thread a row: max, exp and divide in float32 as the
  // plain version's warp softmax does them, and the sum over the same tree:
  // its butterfly over 32 lanes, key j in lane j (zeros past L, which leave
  // every partial sum unchanged), adds slot j + o into slot j for o = 16, 8,
  // 4, 2, 1. P rounded to bfloat16 into the row's slab columns of the P tile.
  for (int r = threadIdx.x; r < rows; r += 128) {
    const float4* row = reinterpret_cast<const float4*>(ss + r * kTile);
    float e[32];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 v = row[c ^ (r & 7)];
      e[4 * c] = v.x, e[4 * c + 1] = v.y, e[4 * c + 2] = v.z, e[4 * c + 3] = v.w;
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) m = j < L ? fmaxf(m, e[j]) : m;
#pragma unroll
    for (int j = 0; j < 32; ++j) e[j] = j < L ? expf(e[j] - m) : 0.f;
    float t[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) t[j] = e[j] + e[j + 16];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < o; ++j) t[j] = t[j] + t[j + o];
    const int lo = r / L * L;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j < L)
        *reinterpret_cast<__nv_bfloat16*>(sp + swizzled(r, lo + j)) =
            __float2bfloat16_rn(e[j] / t[0]);
  }
  hg::fence_async_smem();  // P, written by the threads, is read by wgmma
  __syncthreads();

  float o[NPV / 2];
  hg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hg::wgmma_ss<NPV, 1>(o, hg::desc_kmajor(sp + 32 * kk),
                         hg::desc_nmajor(sv + 2048 * kk), kk != 0);
  hg::wgmma_commit();
  hg::wgmma_wait<0>();
  hg::fence_regs<NPV / 2>(o);

  const int lane = threadIdx.x % 32;
  const int rq = (threadIdx.x / 32) * 16 + lane / 4;  // and rq + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rq + 8 * h;
    if (r >= rows) continue;
    __nv_bfloat16* dst = out + static_cast<size_t>(row0 + r) * Dh;
#pragma unroll
    for (int g = 0; g < NPV / 8; ++g) {
      const int col = g * 8 + (lane % 4) * 2;
      if (col < Dh)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(o[4 * g + 2 * h], o[4 * g + 2 * h + 1]);
    }
  }
}

// ---- L > 32: query tiles against all keys ------------------------------------
//
// One slab a tile from L = 33 on (score width 64 up to L = 64, then 128 and
// 256). A block takes one (b, h) slab and walks all its query tiles with K
// and V loaded once (faster than a block a tile with K and V re-read through
// L2); the next tile's Q loads while this one finishes. Shared memory: Q, NB boxes of (64 rows, 64 columns); K,
// NB column boxes of NK rows each (K-major B operand of S, N = NK); V, NK /
// 64 chunks of NB boxes of (64 rows, 64 columns) (N-major B operand of P V,
// the column boxes kBoxBytes apart); three mbarriers: Q, K, V; the key
// table, a byte a key: 0 kept, 1 pad, 2 past L.
template <int NB, int NK>
struct LongTileLayout {
  static constexpr int kQ = NB * hg::kBoxBytes;
  static constexpr int kKV = NB * NK * 128;
  static constexpr int kBytes = kQ + 2 * kKV + 3 * 8 + NK + 1024;
};

// e^x for x <= 0 (or -inf) by the SFU's 2^x, within a few float32 ulps of
// expf; with P = e * (1 / sum) (not a division), P's bfloat16 rounding may
// differ from the plain version's by an ulp where P lies on a rounding
// edge. Over L > 64 keys P is small, and the card's check holds.
__device__ __forceinline__ float exp_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// One warpgroup. A thread holds, of each accumulator tile, rows rq and
// rq + 8 and in every 8-column group g the columns 8 g + 2 (lane % 4) + {0,
// 1}: element i is column (i / 4) * 8 + 2 (lane % 4) + i % 2 of row rq +
// 8 ((i % 4) / 2). A row's other columns lie in the 3 other threads of its
// quad, so the max and the sum take two shuffles each.
template <int NB, int NK>
__global__ void __launch_bounds__(128)
    masked_mha_fwd_long_tile_kernel(const __grid_constant__ CUtensorMap map_q,
                                    const __grid_constant__ CUtensorMap map_k,
                                    const __grid_constant__ CUtensorMap map_v,
                                    const uint8_t* __restrict__ pad,
                                    __nv_bfloat16* __restrict__ out, int H,
                                    int L, int Dh, float scale, int causal) {
  using W = LongTileLayout<NB, NK>;
  constexpr int NPV = NB == 1 ? 64 : 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;
  uint8_t* sk = sq + W::kQ;
  uint8_t* sv = sk + W::kKV;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sv + W::kKV);
  uint8_t* keys = reinterpret_cast<uint8_t*>(bar + 3);

  const int q_tiles = (L + kTile - 1) / kTile;
  const int bh = blockIdx.x;
  const int row0 = bh * L;
  const uint8_t* prow = pad + static_cast<size_t>(bh / H) * L;
  for (int c = threadIdx.x; c < NK; c += 128)
    keys[c] = c < L ? (prow[c] != 0) : 2;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) hg::mbar_init(&bar[i], 1);
    hg::mbar_init_fence();
    hg::mbar_expect_tx(&bar[0], W::kQ);
    for (int cb = 0; cb < NB; ++cb)
      hg::tma_load(sq + cb * hg::kBoxBytes, &map_q, 64 * cb, row0, &bar[0]);
    hg::mbar_expect_tx(&bar[1], W::kKV);
    for (int cb = 0; cb < NB; ++cb)
      for (int c = 0; c < NK / 64; ++c)
        hg::tma_load(sk + cb * NK * 128 + c * hg::kBoxBytes, &map_k, 64 * cb,
                     row0 + 64 * c, &bar[1]);
    hg::mbar_expect_tx(&bar[2], W::kKV);
    for (int c = 0; c < NK / 64; ++c)
      for (int cb = 0; cb < NB; ++cb)
        hg::tma_load(sv + (c * NB + cb) * hg::kBoxBytes, &map_v, 64 * cb,
                     row0 + 64 * c, &bar[2]);
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int rq = (threadIdx.x / 32) * 16 + lane / 4;  // and rq + 8
  for (int tile = 0; tile < q_tiles; ++tile) {
    hg::mbar_wait(&bar[0], tile & 1);
    hg::mbar_wait(&bar[1], 0);
    float s[NK / 2];
    hg::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * NB; ++ks)
      hg::wgmma_ss<NK, 0>(
          s, hg::desc_kmajor(sq + (ks / 4) * hg::kBoxBytes + (ks % 4) * 32),
          hg::desc_kmajor(sk + (ks / 4) * NK * 128 + (ks % 4) * 32), ks != 0);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs<NK / 2>(s);
    if (tile + 1 < q_tiles) {
      // Q is read: the next tile's queries load while this one finishes.
      __syncthreads();
      if (threadIdx.x == 0) {
        hg::mbar_expect_tx(&bar[0], W::kQ);
        for (int cb = 0; cb < NB; ++cb)
          hg::tma_load(sq + cb * hg::kBoxBytes, &map_q, 64 * cb,
                       row0 + kTile * (tile + 1), &bar[0]);
      }
    }

    // Scale, then where-set the pad and causal keys to -1e9; keys past L
    // (the next slab's rows, or TMA's zeros) are -inf, so P is exactly 0
    // there.
    const int i0 = tile * kTile + rq;  // the query positions i0 and i0 + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int g = 0; g < NK / 8; ++g) {
      const uint16_t pair =
          *reinterpret_cast<const uint16_t*>(keys + 8 * g + (lane % 4) * 2);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * g + (lane % 4) * 2 + e;
        const int key = (pair >> (8 * e)) & 0xFF;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * g + 2 * h + e;
          float v = -INFINITY;
          if (key < 2) {
            v = key ? kNeg : s[i] * scale;
            if (causal && c > i0 + 8 * h) v = kNeg;
          }
          s[i] = v;
          mx[h] = fmaxf(mx[h], v);
        }
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      const int h = (i % 4) / 2;
      s[i] = exp_neg(s[i] - mx[h]);
      sum[h] += s[i];
    }
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      inv[h] = 1.f / sum[h];  // at least 1: the row's max contributes e^0
    }
    // P rounded to bfloat16, packed as the A fragments of k16 steps.
    uint32_t pa[NK / 16][4];
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kk + 2 * q;
        const int h = q % 2;
        pa[kk][q] = hg::pack_bf16(s[i] * inv[h], s[i + 1] * inv[h]);
      }

    hg::mbar_wait(&bar[2], 0);
    float o[NPV / 2];
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      hg::wgmma_rs<NPV, 1>(
          o, pa[kk],
          hg::desc_nmajor(sv + (kk / 4) * NB * hg::kBoxBytes + (kk % 4) * 2048),
          kk != 0);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs<NPV / 2>(o);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 8 * h;
      if (i >= L) continue;
      __nv_bfloat16* dst = out + static_cast<size_t>(row0 + i) * Dh;
#pragma unroll
      for (int g = 0; g < NPV / 8; ++g) {
        const int col = g * 8 + (lane % 4) * 2;
        if (col < Dh)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(o[4 * g + 2 * h], o[4 * g + 2 * h + 1]);
      }
    }
  }
}

template <int NB>
cudaError_t launch_packed(const CUtensorMap* maps, const void* pad, void* out,
                          int BH, int H, int L, int Dh, int slabs, int causal,
                          cudaStream_t stream) {
  const int smem = PackedLayout<NB>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      masked_mha_fwd_packed_kernel<NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  masked_mha_fwd_packed_kernel<NB><<<(BH + slabs - 1) / slabs, 128, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const uint8_t*>(pad),
      static_cast<__nv_bfloat16*>(out), BH, H, L, Dh, slabs, softmax_scale(Dh),
      causal);
  return cudaGetLastError();
}

template <int NB, int NK>
cudaError_t launch_long_tile(const CUtensorMap* maps, const void* pad,
                             void* out, int BH, int H, int L, int Dh,
                             int causal, cudaStream_t stream) {
  const int smem = LongTileLayout<NB, NK>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      masked_mha_fwd_long_tile_kernel<NB, NK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  masked_mha_fwd_long_tile_kernel<NB, NK><<<BH, 128, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const uint8_t*>(pad),
      static_cast<__nv_bfloat16*>(out), H, L, Dh, softmax_scale(Dh), causal);
  return cudaGetLastError();
}

// The tile plan by length: up to L = 32, floor(64 / L) slabs a tile on the
// packed kernel; above, one slab a tile on the query-tile kernel, with a
// score block 64 (L <= 64), 128 or 256 keys wide.
cudaError_t dispatch_tiles(const void* q, const void* k, const void* v,
                           const void* pad, void* out, int B, int H, int L,
                           int Dh, int causal, cudaStream_t stream) {
  const int BH = B * H;
  const uint64_t rows = static_cast<uint64_t>(BH) * L;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!hg::tensor_map(&maps[i], src[i], rows, Dh, Dh, 64))
      return cudaErrorInvalidValue;
  const bool wide = Dh > 64;
  if (L <= kPackedL) {
    const int slabs = kTile / L;
    return wide ? launch_packed<2>(maps, pad, out, BH, H, L, Dh, slabs, causal, stream)
                : launch_packed<1>(maps, pad, out, BH, H, L, Dh, slabs, causal, stream);
  }
  if (L <= kTile)
    return wide ? launch_long_tile<2, 64>(maps, pad, out, BH, H, L, Dh, causal, stream)
                : launch_long_tile<1, 64>(maps, pad, out, BH, H, L, Dh, causal, stream);
  if (L <= 128)
    return wide ? launch_long_tile<2, 128>(maps, pad, out, BH, H, L, Dh, causal, stream)
                : launch_long_tile<1, 128>(maps, pad, out, BH, H, L, Dh, causal, stream);
  return wide ? launch_long_tile<2, 256>(maps, pad, out, BH, H, L, Dh, causal, stream)
              : launch_long_tile<1, 256>(maps, pad, out, BH, H, L, Dh, causal, stream);
}

}  // namespace

// Dynamic shared memory of the bfloat16 tile kernels at head width dh and
// score width keys (32: the packed kernel), for build reports (0 for a plan
// they do not take).
extern "C" int masked_mha_fwd_smem_bytes(int dh, int keys) {
  if (dh < 16 || dh > 128 || dh % 16) return 0;
  const bool wide = dh > 64;
  switch (keys) {
    case 32: return wide ? PackedLayout<2>::kBytes : PackedLayout<1>::kBytes;
    case 64: return wide ? LongTileLayout<2, 64>::kBytes : LongTileLayout<1, 64>::kBytes;
    case 128: return wide ? LongTileLayout<2, 128>::kBytes : LongTileLayout<1, 128>::kBytes;
    case 256: return wide ? LongTileLayout<2, 256>::kBytes : LongTileLayout<1, 256>::kBytes;
    default: return 0;
  }
}

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. bfloat16 at
// Dh a multiple of 16 takes the tile kernels, the rest the scalar ones.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int masked_mha_fwd(const void* q, const void* k, const void* v,
                              const void* pad, void* out, int B, int H, int L,
                              int Dh, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || L < 1 || L > 256 || Dh < 8 || Dh > 128 || Dh % 8 ||
      (L > 64 && Dh % 16) || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && Dh % 16 == 0)
    return static_cast<int>(dispatch_tiles(q, k, v, pad, out, B, H, L, Dh, causal, s));
  if (L <= 64)
    return dtype == 0
               ? launch_short<float>(q, k, v, pad, out, B, H, L, Dh, causal, s)
               : launch_short<__nv_bfloat16>(q, k, v, pad, out, B, H, L, Dh, causal, s);
  return launch_long_f32(q, k, v, pad, out, B, H, L, Dh, causal, s);
}
