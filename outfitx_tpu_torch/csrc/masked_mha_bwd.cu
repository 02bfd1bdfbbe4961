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
// What bounds it on an H100: bytes. The training path calls it at (B, H, L,
// Dh) = (3072, 16, 17, 96) in bfloat16: it reads q, k, v and g and writes
// dq, dk and dv, 7 x 160.4 MB = 1.12 GB, about 0.34 ms at 3.35 TB/s,
// against 10*B*H*L*L*Dh = 13.6 GFLOP, about 14 us of bf16 tensor-core time.
//
// bfloat16 with Dh a multiple of 16 (every main path) takes the tile kernel,
// masked_mha_bwd_tile_kernel, on hopper_gemm.cuh. It works on tiles of 64
// rows of the flat (B H L, Dh) arrays, where each (b, h) slab is L
// consecutive rows: a tile packs floor(64 / L) consecutive slabs (3 at
// L = 17, 51 of 64 rows; one from L = 33 on), and Q, K, G and V arrive as
// one 64-row TMA box per 32 columns (64-byte swizzle; rows past the tensor
// and columns past Dh are TMA's zeros). The bf16 check holds P and dS to
// their last bit: Pb feeds dV directly and dSb feeds dQ and dK, and where a
// row keeps few keys one bfloat16 flip of either moves an output by 2^-8 of
// an O(1) value, beyond the check's limit (a wgmma S failed the forward's
// check so; a wgmma dP failed this one at (4096, 16, 9|13|17, 96)). So a
// tile repeats the plain version's float32 arithmetic up to the roundings
// and leaves to the tensor cores only the products that round once:
//   - S and dP on the CUDA cores, summed over d in order as the plain
//     version's _scores sums them (bfloat16 products are exact in float32),
//     only within each slab; the masks set by the slab-local index. A unit
//     of 3 keys by 3 rows reuses each widened chunk (kUnitKeys);
//   - per row, four threads: the softmax over torch.softmax's warp tree (64
//     slots with zeros past L: t[j] = e[j] + e[j + 32], then the butterfly
//     at 16, 8, 4, 2, 1; up to L = 32 the upper half is 0 and the 32-slot
//     form gives the same sums), exp and true division; rowsum(dP o P) over
//     the same tree, the products rounded first (ops/attention.py
//     _tree_sum); dS = P o (dP - rowsum), then dS * scale;
//   - Pb and dSb go into swizzled (64, 64) bfloat16 tiles, 0 for every key
//     outside the row's slab, so that every product's sum stays inside its
//     slab: dV = Pb^T G, dQ = dSb K, dK = dSb^T Q by wgmma (the tiles read
//     M-major as the transposed A where needed), float32 accumulators;
//   - each output waits, rounded, in the place of the input its product
//     read and leaves by one bulk copy of rows * Dh contiguous values.
// S and dP take V's place once V is read; with up to 32 keys a row of
// them is 128 bytes, as a tile row, and Pb and dSb are written over them.
// Several blocks an SM hide each other's loads and serial phases, so the
// footprint is kept small: 32-column boxes hold Dh = 96 in 12 KB an input
// (64-column boxes would take 16), a block 53 KB and 128 registers a
// thread, four blocks an SM. A block walks tiles t, t + grid, ...; the next
// tile loads as soon as the copies have read the outputs. The inputs must be finite:
// the products multiply the zeros of the Pb and dSb tiles by other slabs'
// rows (0 * Inf is NaN), as in the forward.
//
// bfloat16 at Dh = 8 and L <= 32 (the set transformer over resnet_sbert
// embeddings, d_embed 128 over 16 heads, in CP/CIR training and in the
// original-CP step) takes the narrow-head kernel,
// masked_mha_bwd_narrow_kernel<L> (narrow_mha.cuh). What bounds it is
// bytes: at (3072, 16, 17, 8) q, k, v, g, dq, dk and dv are 7 x 13.37 MB =
// 93.6 MB, 27.9 us at 3.35 TB/s, against about 1.1 GFLOP, of which S, dP
// and the softmax (float32, in order) run on the CUDA cores. A 64-row tile
// of the tile kernel holds 3 such slabs and a 32-column box at Dh = 8 would
// be three quarters zeros, so the route streams groups of 128 / L slabs (7
// at L = 17) by bulk copies into a persistent block of 128 threads, a
// thread a query row repeating the plain version's float32 arithmetic up to
// the roundings of P and dS (S and dP in order over d, expf, the 64-slot
// tree, true division, the rounded products' tree); S and dP stay on the
// CUDA cores in order over d (a tensor-core S or dP failed the bf16 check,
// above). dQ, dK and dV, which round once, run on mma.sync after one
// barrier, a warp a slab. The kernel is instantiated for each L (buckets of
// 8 to 32 keys with L at run time were 39% slower at L = 17 on an H100); the
// walk and its launch are narrow_mha.cuh's, shared with the forward.
//
// float32 (the correctness route; no main path on the card runs it) and
// bfloat16 at a Dh % 16 != 0 outside the narrow route (Dh = 24, 40, ...,
// and Dh = 8 at 33 <= L <= 64) keep the scalar design: one
// block of 128 threads per (b, h) widens Q, K, V and G into float shared
// memory, rows padded to Dh + 1 floats so that the dot-product loops (which
// read one element of several rows at once) hit distinct banks; S and dP
// in one pass over the L x L pairs; one warp per query row does the softmax,
// the row sum of dP o P, dS and the two roundings; the three output products
// read P or dS as a broadcast. All scalar FMAs on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "narrow_mha.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e9f;

// Same rounding as the reference: 1/sqrt(Dh) in double, then to float.
inline float softmax_scale(int Dh) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
}

// ---- float32, or bfloat16 at Dh % 16 != 0 off the narrow route -------------

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
cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          const void* g, const void* pad, void* dq, void* dk,
                          void* dv, int B, int H, int L, int Dh, int causal,
                          cudaStream_t stream) {
  const size_t smem = (4 * static_cast<size_t>(L) * (Dh + 1) +
                       2 * static_cast<size_t>(L) * L) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_mha_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  masked_mha_bwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const uint8_t*>(pad), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), H, L, Dh, softmax_scale(Dh),
      causal);
  return cudaGetLastError();
}

// ---- bfloat16, Dh a multiple of 16: packed tiles ------------------------------

constexpr int kTile = 64;  // rows of a tile: wgmma's M

// Byte offset of element (r, c) of a (64, 64) bfloat16 tile in the 128-byte
// swizzle that TMA writes and the wgmma descriptors name: row r at r * 128,
// its 16-byte chunks permuted by r % 8.
__device__ __forceinline__ int swizzled(int r, int c) {
  const int byte = 2 * c;
  return r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
}

// Index of (row r, slab-local key j) in a float32 (64, SLOTS) score block:
// the 4-float groups of row r permuted by r % 8, so that 8 threads reading
// 8 rows' same group hit 8 bank groups.
template <int SLOTS>
__device__ __forceinline__ int score_at(int r, int j) {
  return r * SLOTS + (j ^ ((r & 7) << 2));
}

// Eight bfloat16 of 16-byte chunk `chunk` (8 columns) of row r of an input
// tile, as float32. The tile is (64 rows, 32 columns) boxes in the 64-byte
// swizzle: row r at r * 64 bytes of its box, its 16-byte chunks permuted by
// (r / 2) % 4 (neighbouring rows' same chunk lands on distinct banks).
__device__ __forceinline__ void chunk_f32(const uint8_t* tile, int r, int chunk,
                                          float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(
      tile + (chunk >> 2) * hg::kBox64Bytes + r * 64 +
      (((chunk & 3) ^ ((r >> 1) & 3)) << 4));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    f[2 * t] = __uint_as_float(w[t] << 16);
    f[2 * t + 1] = __uint_as_float(w[t] & 0xFFFF0000u);
  }
}

// The sum of a row's SLOTS slots over torch.softmax's warp tree (two
// elements a lane, then the butterfly): t[j] = x[j] + x[j + 32] where
// SLOTS = 64, then t[j] += t[j + o] for o = 16, 8, 4, 2, 1. Slots past the
// row's length hold 0, so up to 32 keys SLOTS = 32 gives the same sums. The
// four threads of a quad share a row: thread q holds the slots j with
// j % 16 in [4 q, 4 q + 4), slot 16 a + 4 q + i at x[4 a + i]. Every
// addition is the tree's own, with its operands: the steps at 32 and 16
// stay in a thread, 8 and 4 take a shuffle, 2 and 1 end in thread 0 of
// the quad, which hands the sum to the others.
template <int SLOTS>
__device__ __forceinline__ float quad_tree_sum(const float* x) {
  float t[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (SLOTS == 64)
      t[i] = (x[i] + x[8 + i]) + (x[4 + i] + x[12 + i]);
    else
      t[i] = x[i] + x[4 + i];
  }
#pragma unroll
  for (int o = 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = t[i] + __shfl_xor_sync(0xffffffffu, t[i], o);
  const float sum = (t[0] + t[2]) + (t[1] + t[3]);
  return __shfl_sync(0xffffffffu, sum, (threadIdx.x % 32) & ~3);
}

// A score unit: kUnitKeys consecutive keys of a slab against kUnitRows
// consecutive query rows, S and dP both, each float32 sum over d in order.
// A widened chunk of a key row serves kUnitRows rows and a widened query
// chunk kUnitKeys keys; larger units leave more of a tile's threads idle
// and hold more registers. At L = 17, 3 x 3 gives 108 units a tile, and the
// kernel keeps to 128 registers a thread, four blocks an SM at Dh = 96.
constexpr int kUnitKeys = 3;
constexpr int kUnitRows = 3;

// Score units a thread takes at most, over the lengths a softmax width
// serves (L <= 32 packed for SLOTS = 32, 33..64 one slab a tile else).
template <int SLOTS>
__host__ __device__ constexpr int max_units() {
  int most = 0;
  for (int L = SLOTS == 32 ? 1 : 33; L <= SLOTS; ++L) {
    const int slabs = kTile / L > 1 ? kTile / L : 1;
    const int units = slabs * ((L + kUnitKeys - 1) / kUnitKeys) *
                      ((L + kUnitRows - 1) / kUnitRows);
    const int per = (units + kThreads - 1) / kThreads;
    most = per > most ? per : most;
  }
  return most;
}

// Shared memory of the tile kernel: Q, K, G and V, NB boxes of (64 rows, 32
// columns) each (64-byte swizzle: Dh = 96 takes 12 KB an input, where
// 64-column boxes would take 16); from V's place on (V is read only for
// dP), the float32 (64, SLOTS) blocks of S and dP. With SLOTS = 32 a block
// row is 128 bytes, as a bfloat16 tile row, so a row's threads write Pb
// over its S row and dSb over its dP row; with SLOTS = 64 the two tiles
// follow. One mbarrier.
template <int NB, int SLOTS>
struct TileLayout {
  static constexpr int kBox = NB * hg::kBox64Bytes;  // one input's 64 rows
  static constexpr int kQ = 0, kK = kBox, kG = 2 * kBox, kV = 3 * kBox;
  static constexpr int kStage = 4 * kBox;
  static constexpr int kScores = 4 * kTile * SLOTS;  // one float32 block
  static constexpr int kS = kV, kDP = kV + kScores;
  static constexpr int kWork = 2 * kScores > kBox ? 2 * kScores : kBox;
  static constexpr int kP = SLOTS == 32 ? kS : kV + kWork;
  static constexpr int kDS = SLOTS == 32 ? kDP : kP + hg::kBoxBytes;
  static constexpr int kBar = SLOTS == 32 ? kV + kWork : kDS + hg::kBoxBytes;
  static constexpr int kBytes = kBar + 8 + 1024;
};

// Writes a (64, NO) accumulator tile's rows below `rows` and columns below
// Dh as bfloat16 into a plain row-major (rows, Dh) buffer in shared memory,
// from which one bulk copy stores it. A thread holds rows rq and rq + 8 and,
// in every 8-column group g, the columns 8 g + 2 (lane % 4) + {0, 1}.
template <int NO>
__device__ __forceinline__ void stage_tile(uint8_t* buf, const float* acc,
                                           int rows, int Dh, int rq, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rq + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int g = 0; g < NO / 8; ++g) {
      const int col = g * 8 + (lane % 4) * 2;
      if (col < Dh)
        *reinterpret_cast<uint32_t*>(buf + 2 * (r * Dh + col)) =
            hg::pack_bf16(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
    }
  }
}

// One warpgroup a block; a block walks tiles t, t + grid, ... NB: 32-column
// boxes an input row (Dh <= 32 NB), the products' N = 32 NB. SLOTS: 32 up to
// L = 32 (packed slabs), else 64 (one slab a tile).
template <int NB, int SLOTS>
__global__ void __launch_bounds__(kThreads)
    masked_mha_bwd_tile_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_g,
                               const uint8_t* __restrict__ pad,
                               __nv_bfloat16* __restrict__ dq,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int BH, int H,
                               int L, int Dh, int slabs, float scale,
                               int causal) {
  using Lay = TileLayout<NB, SLOTS>;
  constexpr int NO = 32 * NB;  // output columns computed
  constexpr int kUnits = max_units<SLOTS>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint8_t* sq = smem + Lay::kQ;
  const uint8_t* sk = smem + Lay::kK;
  const uint8_t* sg = smem + Lay::kG;
  const uint8_t* sv = smem + Lay::kV;
  float* ss = reinterpret_cast<float*>(smem + Lay::kS);
  float* sdp = reinterpret_cast<float*>(smem + Lay::kDP);
  uint8_t* sp = smem + Lay::kP;
  uint8_t* sds = smem + Lay::kDS;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::kBar);

  const int tiles = (BH + slabs - 1) / slabs;
  const int tid = threadIdx.x;
  auto load = [&](int tile) {
    const CUtensorMap* maps[4] = {&map_q, &map_k, &map_g, &map_v};
    hg::mbar_expect_tx(full, Lay::kStage);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
        hg::tma_load(smem + i * Lay::kBox + cb * hg::kBox64Bytes, maps[i], 32 * cb,
                     tile * slabs * L, full);
  };
  if (tid == 0) {
    hg::mbar_init(full, 1);
    hg::mbar_init_fence();
    if (blockIdx.x < tiles) load(blockIdx.x);
  }
  __syncthreads();

  const int lane = tid % 32;
  const int rq = (tid / 32) * 16 + lane / 4;  // accumulator rows rq, rq + 8
  const int kg = (L + kUnitKeys - 1) / kUnitKeys;  // key groups of a slab
  const int ng = (L + kUnitRows - 1) / kUnitRows;  // row groups of a slab
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, phase ^= 1) {
    const int slab0 = tile * slabs;
    const int live = min(slabs, BH - slab0);  // the tile's slabs
    const int rows = live * L;
    const int row0 = slab0 * L;
    hg::mbar_wait(full, phase);

    // S and dP of each (row i, key j) of a slab, summed over d in order,
    // S with the key mask and the causal mask set by the slab-local index.
    // Unit u takes keys j0 .. j0 + 2 against rows i0 .. i0 + 2 of slab sl
    // (neighbouring threads the next keys of the same rows); past L it
    // repeats the last key or row and drops the sums. The sums wait in
    // registers until V, whose place they take, is read.
    const int n_units = live * ng * kg;
    float sreg[kUnits][kUnitRows][kUnitKeys], preg[kUnits][kUnitRows][kUnitKeys];
#pragma unroll
    for (int t = 0; t < kUnits; ++t) {
      const int u = tid + kThreads * t;
      if (u >= n_units) continue;
      const int j0 = u % kg * kUnitKeys;
      const int sl = u / kg / ng;
      const int i0 = (u / kg - sl * ng) * kUnitRows;
      int kr[kUnitKeys], qr[kUnitRows];
#pragma unroll
      for (int n = 0; n < kUnitKeys; ++n) kr[n] = sl * L + min(j0 + n, L - 1);
#pragma unroll
      for (int m = 0; m < kUnitRows; ++m) qr[m] = sl * L + min(i0 + m, L - 1);
      float as[kUnitRows][kUnitKeys] = {}, ap[kUnitRows][kUnitKeys] = {};
      for (int c = 0; c < Dh / 8; ++c) {
        float y[kUnitKeys][8], x[8];
#pragma unroll
        for (int n = 0; n < kUnitKeys; ++n) chunk_f32(sk, kr[n], c, y[n]);
#pragma unroll
        for (int m = 0; m < kUnitRows; ++m) {
          chunk_f32(sq, qr[m], c, x);
#pragma unroll
          for (int n = 0; n < kUnitKeys; ++n)
#pragma unroll
            for (int e = 0; e < 8; ++e) as[m][n] = fmaf(x[e], y[n][e], as[m][n]);
        }
#pragma unroll
        for (int n = 0; n < kUnitKeys; ++n) chunk_f32(sv, kr[n], c, y[n]);
#pragma unroll
        for (int m = 0; m < kUnitRows; ++m) {
          chunk_f32(sg, qr[m], c, x);
#pragma unroll
          for (int n = 0; n < kUnitKeys; ++n)
#pragma unroll
            for (int e = 0; e < 8; ++e) ap[m][n] = fmaf(x[e], y[n][e], ap[m][n]);
        }
      }
      const uint8_t* prow = pad + static_cast<size_t>((slab0 + sl) / H) * L;
#pragma unroll
      for (int n = 0; n < kUnitKeys; ++n) {
        const int j = j0 + n;
        const bool padded = prow[min(j, L - 1)];
#pragma unroll
        for (int m = 0; m < kUnitRows; ++m) {
          float sc = as[m][n] * scale;
          if (padded) sc = kNeg;
          if (causal && j > i0 + m) sc = kNeg;
          sreg[t][m][n] = sc;
          preg[t][m][n] = ap[m][n];
        }
      }
    }
    __syncthreads();  // V is read: S and dP take its place
#pragma unroll
    for (int t = 0; t < kUnits; ++t) {
      const int u = tid + kThreads * t;
      if (u >= n_units) continue;
      const int j0 = u % kg * kUnitKeys;
      const int sl = u / kg / ng;
      const int i0 = (u / kg - sl * ng) * kUnitRows;
#pragma unroll
      for (int m = 0; m < kUnitRows; ++m)
#pragma unroll
        for (int n = 0; n < kUnitKeys; ++n)
          if (i0 + m < L && j0 + n < L) {
            const int at = score_at<SLOTS>(sl * L + i0 + m, j0 + n);
            ss[at] = sreg[t][m][n];
            sdp[at] = preg[t][m][n];
          }
    }
    __syncthreads();

    // Four threads a row (the slots of quad_tree_sum), two rows a thread,
    // as the plain version computes it: the softmax as torch.softmax's warp
    // softmax takes it (key j in slot j, zeros past L; max, exp, the tree
    // sum, true division); rowsum(dP o P) over the same tree, the products
    // rounded first; dS = P o (dP - rowsum), then dS * scale. Pb and dSb go
    // rounded into the row's slab columns of their tiles, 0 elsewhere and in
    // rows past the live slabs.
    {
      constexpr int kGroups = SLOTS / 16;  // four-slot groups a thread holds
      const int q = tid % 4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = tid / 4 + 32 * half;
        const bool lv = r < rows;
        float e[4 * kGroups], d[4 * kGroups], x[4 * kGroups];
#pragma unroll
        for (int a = 0; a < kGroups; ++a) {
          const int c = (4 * a + q) ^ (r & 7);
          const float4 sa = reinterpret_cast<const float4*>(ss + r * SLOTS)[c];
          const float4 da = reinterpret_cast<const float4*>(sdp + r * SLOTS)[c];
          e[4 * a] = sa.x, e[4 * a + 1] = sa.y, e[4 * a + 2] = sa.z, e[4 * a + 3] = sa.w;
          d[4 * a] = da.x, d[4 * a + 1] = da.y, d[4 * a + 2] = da.z, d[4 * a + 3] = da.w;
        }
        bool key[4 * kGroups];  // slot 16 a + 4 q + i of a live row is a key
#pragma unroll
        for (int s = 0; s < 4 * kGroups; ++s)
          key[s] = lv && 16 * (s / 4) + 4 * q + s % 4 < L;
        float m = -INFINITY;
#pragma unroll
        for (int s = 0; s < 4 * kGroups; ++s)
          if (key[s]) m = fmaxf(m, e[s]);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
#pragma unroll
        for (int s = 0; s < 4 * kGroups; ++s) e[s] = key[s] ? expf(e[s] - m) : 0.f;
        const float sum = quad_tree_sum<SLOTS>(e);
#pragma unroll
        for (int s = 0; s < 4 * kGroups; ++s) {
          e[s] = key[s] ? e[s] / sum : 0.f;  // P
          x[s] = key[s] ? __fmul_rn(d[s], e[s]) : 0.f;
        }
        const float rs = quad_tree_sum<SLOTS>(x);
#pragma unroll
        for (int s = 0; s < 4 * kGroups; ++s)  // dS * scale
          d[s] = key[s] ? __fmul_rn(__fmul_rn(e[s], __fsub_rn(d[s], rs)), scale) : 0.f;
        if constexpr (SLOTS == 32) {
          // Pb and dSb rows lie over this row's S and dP, read above by the
          // quad: zero them, then place the slab's keys from column lo on.
          __syncwarp();
          const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
          reinterpret_cast<uint4*>(sp + r * 128)[2 * q] = zero;
          reinterpret_cast<uint4*>(sp + r * 128)[2 * q + 1] = zero;
          reinterpret_cast<uint4*>(sds + r * 128)[2 * q] = zero;
          reinterpret_cast<uint4*>(sds + r * 128)[2 * q + 1] = zero;
          __syncwarp();
          const int lo = r / L * L;
#pragma unroll
          for (int s = 0; s < 4 * kGroups; ++s) {
            const int j = 16 * (s / 4) + 4 * q + s % 4;
            if (key[s]) {
              *reinterpret_cast<__nv_bfloat16*>(sp + swizzled(r, lo + j)) =
                  __float2bfloat16_rn(e[s]);
              *reinterpret_cast<__nv_bfloat16*>(sds + swizzled(r, lo + j)) =
                  __float2bfloat16_rn(d[s]);
            }
          }
        } else {
          // One slab a tile: key j is column j, four columns a group.
#pragma unroll
          for (int a = 0; a < kGroups; ++a) {
            const int at = swizzled(r, 16 * a + 4 * q);
            *reinterpret_cast<uint2*>(sp + at) =
                make_uint2(hg::pack_bf16(e[4 * a], e[4 * a + 1]),
                           hg::pack_bf16(e[4 * a + 2], e[4 * a + 3]));
            *reinterpret_cast<uint2*>(sds + at) =
                make_uint2(hg::pack_bf16(d[4 * a], d[4 * a + 1]),
                           hg::pack_bf16(d[4 * a + 2], d[4 * a + 3]));
          }
        }
      }
    }
    hg::fence_async_smem();  // Pb and dSb, written by the threads, go to wgmma
    __syncthreads();

    // dV = Pb^T G (the Pb tile read M-major, G N-major), dQ = dSb K (the
    // dSb tile K-major, K N-major), dK = dSb^T Q (the tile M-major, Q
    // N-major), one after another; each output waits in the place of the
    // input its product has read, and leaves by one bulk copy.
    float acc[NO / 2];
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hg::wgmma_ss<NO, 1, 1>(acc, hg::desc_nmajor(sp + 2048 * kk),
                             hg::desc_nmajor64(sg + 1024 * kk), kk != 0);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs<NO / 2>(acc);
    stage_tile<NO>(smem + Lay::kG, acc, rows, Dh, rq, lane);
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hg::wgmma_ss<NO, 1>(acc, hg::desc_kmajor(sds + 32 * kk),
                          hg::desc_nmajor64(sk + 1024 * kk), kk != 0);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs<NO / 2>(acc);
    stage_tile<NO>(smem + Lay::kK, acc, rows, Dh, rq, lane);
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hg::wgmma_ss<NO, 1, 1>(acc, hg::desc_nmajor(sds + 2048 * kk),
                             hg::desc_nmajor64(sq + 1024 * kk), kk != 0);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs<NO / 2>(acc);
    stage_tile<NO>(smem + Lay::kQ, acc, rows, Dh, rq, lane);
    hg::fence_async_smem();  // the staged outputs go to the bulk copies
    __syncthreads();

    // The three outputs leave; once the copies have read their places, the
    // next tile loads.
    if (tid == 0) {
      const size_t at = static_cast<size_t>(row0) * Dh;
      const int bytes = 2 * rows * Dh;
      hg::bulk_store(dv + at, smem + Lay::kG, bytes);
      hg::bulk_store(dq + at, smem + Lay::kK, bytes);
      hg::bulk_store(dk + at, smem + Lay::kQ, bytes);
      hg::tma_store_commit();
      if (tile + gridDim.x < tiles) {
        hg::tma_store_wait_read();
        load(tile + gridDim.x);
      }
    }
  }
  // Shared memory must outlive the copies that read it.
  if (tid == 0) hg::tma_store_wait_read();
}

template <int NB, int SLOTS>
cudaError_t launch_tiles(const CUtensorMap* maps, const void* pad, void* dq,
                         void* dk, void* dv, int BH, int H, int L, int Dh,
                         int causal, cudaStream_t stream) {
  const auto kernel = masked_mha_bwd_tile_kernel<NB, SLOTS>;
  const int smem = TileLayout<NB, SLOTS>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // The blocks the card holds at once, asked once: the grid walks the tiles.
  static const int resident = [&] {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    return (per_sm > 0 ? per_sm : 1) * hg::sm_count();
  }();
  const int slabs = kTile / L > 1 ? kTile / L : 1;
  const int tiles = (BH + slabs - 1) / slabs;
  kernel<<<tiles < resident ? tiles : resident, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const uint8_t*>(pad),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), BH, H, L, Dh, slabs, softmax_scale(Dh),
      causal);
  return cudaGetLastError();
}

// The tile plan: floor(64 / L) slabs a tile (one from L = 33 on), one to
// four 32-column boxes a row, the 32- or 64-slot softmax tree.
cudaError_t dispatch_tiles(const void* q, const void* k, const void* v,
                           const void* g, const void* pad, void* dq, void* dk,
                           void* dv, int B, int H, int L, int Dh, int causal,
                           cudaStream_t stream) {
  const int BH = B * H;
  const uint64_t rows = static_cast<uint64_t>(BH) * L;
  CUtensorMap maps[4];
  const void* src[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i)
    if (!hg::tensor_map(&maps[i], src[i], rows, Dh, Dh, kTile, 2, 64))
      return cudaErrorInvalidValue;
  const bool packed = L <= 32;
  switch ((Dh + 31) / 32) {
    case 1:
      return packed ? launch_tiles<1, 32>(maps, pad, dq, dk, dv, BH, H, L, Dh, causal, stream)
                    : launch_tiles<1, 64>(maps, pad, dq, dk, dv, BH, H, L, Dh, causal, stream);
    case 2:
      return packed ? launch_tiles<2, 32>(maps, pad, dq, dk, dv, BH, H, L, Dh, causal, stream)
                    : launch_tiles<2, 64>(maps, pad, dq, dk, dv, BH, H, L, Dh, causal, stream);
    case 3:
      return packed ? launch_tiles<3, 32>(maps, pad, dq, dk, dv, BH, H, L, Dh, causal, stream)
                    : launch_tiles<3, 64>(maps, pad, dq, dk, dv, BH, H, L, Dh, causal, stream);
    default:
      return packed ? launch_tiles<4, 32>(maps, pad, dq, dk, dv, BH, H, L, Dh, causal, stream)
                    : launch_tiles<4, 64>(maps, pad, dq, dk, dv, BH, H, L, Dh, causal, stream);
  }
}

// ---- bfloat16 at Dh = 8, L <= 32: narrow heads ---------------------------------
//
// Groups of 128 / L slabs walked by a block (narrow_mha.cuh). Q, K, V and G
// of a group arrive by four bulk copies into a stage. Then a thread a query
// row, with the slab's K and V rows read as broadcasts: S and dP summed over
// d in order, P over the 64-slot tree with true division, rowsum(dP o P)
// over the same tree with the products rounded first, dS = P o (dP -
// rowsum); Pb = bfloat16(P) and dSb = bfloat16(dS * scale) go into the
// group's two blocks. After a barrier each warp takes slabs' dQ = dSb K,
// dV = Pb^T G and dK = dSb^T Q by mma.sync (K, G and Q rows straight from
// the stage), float32 sums, and stores the rows' bfloat16 pairs. Blocks of
// 128 threads, four an SM, were the fastest of the sizes tried (128 and 256
// threads, one to eight blocks an SM) on an H100 at (3072, 16, 17, 8).
constexpr int kNarrowThreads = 128;
constexpr int kNarrowMinBlocks = 4;

template <int L>
__global__ void __launch_bounds__(kNarrowThreads, kNarrowMinBlocks)
    masked_mha_bwd_narrow_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ g,
                                 const uint8_t* __restrict__ pad,
                                 __nv_bfloat16* __restrict__ dq,
                                 __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv, int BH, int H,
                                 float scale, int causal) {
  using P = nm::Plan<L, kNarrowThreads, 4, 2>;
  extern __shared__ __align__(16) uint8_t narrow_smem[];
  uint8_t* pb = narrow_smem + P::kBlocks;  // (R, kBlockRow): Pb
  uint8_t* dsb = pb + P::kRows * P::kBlockRow;  // (R, kBlockRow): dSb
  const __nv_bfloat16* const in[4] = {q, k, v, g};
  nm::walk<L, kNarrowThreads, 4, 2>(
      narrow_smem, in, pad, BH, H, causal,
      [&](const uint8_t* span, int sl, int i, uint32_t masked) {  // query row i
        const int r = sl * L + i;
        float qr[nm::kDh], gr[nm::kDh], s[L], dp[L];
        nm::widen8(span + 16 * r, qr);
        nm::widen8(span + 3 * P::kIn + 16 * r, gr);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          float kr[nm::kDh], vr[nm::kDh];
          nm::widen8(span + P::kIn + 16 * (sl * L + j), kr);
          nm::widen8(span + 2 * P::kIn + 16 * (sl * L + j), vr);
          float a = 0.f, b = 0.f;
#pragma unroll
          for (int d = 0; d < nm::kDh; ++d) {
            a = fmaf(qr[d], kr[d], a);
            b = fmaf(gr[d], vr[d], b);
          }
          s[j] = nm::masked_score(masked, j, __fmul_rn(a, scale));
          dp[j] = b;
        }
        float m = s[0];
#pragma unroll
        for (int j = 1; j < L; ++j) m = fmaxf(m, s[j]);
#pragma unroll
        for (int j = 0; j < L; ++j) s[j] = expf(__fsub_rn(s[j], m));
        nm::div_row<L>(s, nm::tree_sum<L, false>(s));  // P
        float x[L];
#pragma unroll
        for (int j = 0; j < L; ++j) x[j] = __fmul_rn(dp[j], s[j]);
        const float rs = nm::tree_sum<L, true>(x);
#pragma unroll
        for (int j = 0; j < L; ++j)  // dS * scale
          dp[j] = __fmul_rn(__fmul_rn(s[j], __fsub_rn(dp[j], rs)), scale);
        nm::store_block_row<L>(pb + r * P::kBlockRow, s);
        nm::store_block_row<L>(dsb + r * P::kBlockRow, dp);
      },
      [&](const uint8_t* span, int w, int first) {
        const size_t row0 = static_cast<size_t>(first + w) * L;
        const uint8_t* zero = narrow_smem + P::kZero;
        nm::slab_mma<L, P::kBlockRow, false>(
            dsb, span + P::kIn, w * L, zero,
            [&](int row, int n, float v0, float v1) { nm::store_pair(dq, row0 + row, n, v0, v1); });
        nm::slab_mma<L, P::kBlockRow, true>(
            pb, span + 3 * P::kIn, w * L, zero,
            [&](int row, int n, float v0, float v1) { nm::store_pair(dv, row0 + row, n, v0, v1); });
        nm::slab_mma<L, P::kBlockRow, true>(
            dsb, span, w * L, zero,
            [&](int row, int n, float v0, float v1) { nm::store_pair(dk, row0 + row, n, v0, v1); });
      });
}

cudaError_t dispatch_narrow(const void* q, const void* k, const void* v, const void* g,
                            const void* pad, void* dq, void* dk, void* dv, int BH, int H,
                            int L, int causal, cudaStream_t stream) {
  return nm::by_length(L, [&](auto len) {
    constexpr int kL = decltype(len)::value;
    return nm::launch<kL, kNarrowThreads, nm::Plan<kL, kNarrowThreads, 4, 2>::kBytes,
                      masked_mha_bwd_narrow_kernel<kL>>(
        BH, stream, static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(pad),
        static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), BH, H, softmax_scale(nm::kDh), causal);
  });
}

}  // namespace

// Dynamic shared memory of the bfloat16 tile kernel at head width dh and
// softmax width slots (32: L <= 32, 64: above), for build reports (0 for a
// plan it does not take).
extern "C" int masked_mha_bwd_smem_bytes(int dh, int slots) {
  if (dh < 16 || dh > 128 || dh % 16 || (slots != 32 && slots != 64)) return 0;
  const int boxes = (dh + 31) / 32;
  if (slots == 32)
    return boxes == 1 ? TileLayout<1, 32>::kBytes
         : boxes == 2 ? TileLayout<2, 32>::kBytes
         : boxes == 3 ? TileLayout<3, 32>::kBytes : TileLayout<4, 32>::kBytes;
  return boxes == 1 ? TileLayout<1, 64>::kBytes
       : boxes == 2 ? TileLayout<2, 64>::kBytes
       : boxes == 3 ? TileLayout<3, 64>::kBytes : TileLayout<4, 64>::kBytes;
}

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. bfloat16 at
// Dh a multiple of 16 takes the tile kernel, at Dh = 8 and L <= 32 the
// narrow kernel, the rest the scalar one. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int masked_mha_bwd(const void* q, const void* k, const void* v,
                              const void* g, const void* pad, void* dq,
                              void* dk, void* dv, int B, int H, int L, int Dh,
                              int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || L < 1 || L > 64 || Dh < 8 || Dh > 128 || Dh % 8 ||
      dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && Dh % 16 == 0)
    return static_cast<int>(
        dispatch_tiles(q, k, v, g, pad, dq, dk, dv, B, H, L, Dh, causal, s));
  if (dtype == 1 && Dh == nm::kDh && L <= nm::kMaxL)
    return static_cast<int>(
        dispatch_narrow(q, k, v, g, pad, dq, dk, dv, B * H, H, L, causal, s));
  if (dtype == 0)
    return launch_scalar<float>(q, k, v, g, pad, dq, dk, dv, B, H, L, Dh, causal, s);
  return launch_scalar<__nv_bfloat16>(q, k, v, g, pad, dq, dk, dv, B, H, L, Dh,
                                       causal, s);
}
