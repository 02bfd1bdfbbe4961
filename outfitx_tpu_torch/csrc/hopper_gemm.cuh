// Hopper (sm_90a) building blocks of the bfloat16 tower kernels: TMA tensor
// maps, mbarriers, wgmma, and one persistent warp-specialised GEMM mainloop
// with an epilogue hook. Written in inline PTX; no CUTLASS or CuTe.
//
// The GEMM computes, for a row-major A (M, K) and a row-major B (K, N), both
// bfloat16 in device memory, C = A B with float32 sums, and hands every pair
// of neighbouring columns of C, in registers, to the epilogue functor:
//   epi(col, v0, v1)       transforms the pair in place (bias, activation);
//   Epi::Out               C's type in device memory: bfloat16 (rounded to
//                          nearest) or float.
// C then leaves through shared memory by TMA stores (the epilogue, below).
// B keeps the (in, out) layout of the JAX weights, so wgmma reads it N-major
// (its transpose bit).
//
// Design. One block per SM walks output tiles of kBM x BN (BN = 128 or 256)
// in the order n fastest, so the blocks in flight at one time share a few A
// row panels and the whole of B in L2. Warpgroup 0 is the producer: one
// thread keeps kStages K-slices of A and B in flight with TMA
// (cp.async.bulk.tensor, 128-byte swizzle), each stage guarded by a "full"
// mbarrier that the copies complete and an "empty" one that the consumers
// arrive on. Warpgroups 1 and 2 are the consumers: each owns 64 rows of the
// tile and runs wgmma m64nBNk16 on the stage's tiles with its accumulators
// (BN / 2 floats a thread) in registers, keeping one group of products in
// flight while it frees the stage before. After the tile's last K-slice it
// runs the epilogue while the producer already loads the next tile, and its
// TMA stores drain while it runs the next tile's products: stored straight
// from registers, C's writes stalled the consumers. setmaxnreg moves
// registers from the producer to the consumers.
//
// Shared-memory layouts, as TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B
// and as the wgmma descriptors name them (layout type 1, 128-byte swizzle):
//   A tile (kBM rows, kBK = 64 columns): row r at r * 128 bytes, K-major;
//     8-row groups 1024 bytes apart (SBO); a k16 step is +32 bytes.
//   B tile (kBK rows of K, BN columns): BN / 64 boxes of (64 K rows, 64
//     columns), 8 KB each, N-major; 8-row groups of K 1024 bytes apart (SBO),
//     the 64-column boxes kBoxBytes apart (LBO); a k16 step is +2048 bytes.
// Every tile starts on a 1024-byte boundary, as the swizzle needs.
//
// Rows past M and columns past K or N are read as zeros by TMA and not
// written by its stores. Requirements (the C entries check them): K and N multiples of 8,
// every base 16-byte aligned, row strides multiples of 16 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hg {

constexpr int kBM = 128;
constexpr int kBK = 64;
constexpr int kStages = 4;
constexpr int kBoxBytes = 64 * 64 * 2;  // one (64, 64) bfloat16 box
constexpr int kGemmThreads = 384;       // producer + two consumer warpgroups

// ---- host: tensor maps ----------------------------------------------------
// cuTensorMapEncodeTiled lives in libcuda; it is looked up in the copy the
// process has already loaded, so nothing links against it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A tensor map of a row-major matrix (rows, cols) of bfloat16 (elem 2) or
// float (elem 4), row stride ld elements, moved in boxes of (box_rows,
// `swizzle` bytes of columns) with the 128-byte (or 64-byte) swizzle;
// out-of-bounds elements read as zero and are not written. False if it
// cannot be made.
inline bool tensor_map(CUtensorMap* map, const void* base, uint64_t rows,
                       uint64_t cols, uint64_t ld, uint32_t box_rows,
                       int elem = 2, int swizzle = 128) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 || (ld * elem) % 16 ||
      (swizzle != 128 && swizzle != 64))
    return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(swizzle / elem), box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map,
            elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// ---- device: barriers, TMA, wgmma -----------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spins until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// One box from shared memory into a 2-D tensor map (the async proxy reads
// the box; rows and columns outside the tensor are not written).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int col,
                                          int row, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(col), "r"(row), "r"(smem_u32(src))
      : "memory");
}
// A contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from shared into global memory, by the bulk-copy engine; completes in the
// thread's bulk group like tma_store.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1..15) over `threads` threads, e.g. one warpgroup.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int Regs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs));
}
template <int Regs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

// Shared-memory matrix descriptor; layout 1 is the 128-byte swizzle, 2 the
// 64-byte one. K-major tiles leave LBO at 16 bytes (unused); N-major tiles
// name the stride of their column boxes (LBO) and of 8-row groups (SBO).
__device__ __forceinline__ uint64_t smem_desc(const void* tile, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout = 1) {
  const uint32_t addr = smem_u32(tile);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile) {
  return smem_desc(tile, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_nmajor(const void* tile) {
  return smem_desc(tile, kBoxBytes, 1024);
}
// N-major tile of (64 rows, 32 columns) boxes in the 64-byte swizzle, as
// TMA writes them with CU_TENSOR_MAP_SWIZZLE_64B: row r at r * 64 bytes,
// 8-row groups 512 bytes apart, boxes kBox64Bytes apart; a k16 step is
// +1024 bytes.
constexpr int kBox64Bytes = 64 * 32 * 2;
__device__ __forceinline__ uint64_t desc_nmajor64(const void* tile) {
  return smem_desc(tile, kBox64Bytes, 512, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma m64nNk16, bfloat16 in, float32 accumulators d (N / 2 a thread).
// ss: A and B from shared memory; rs: A from registers, in the accumulator
// layout of a (64, 16) tile packed two bfloat16 a register. TransB = 1 reads
// B N-major; TransA = 1 reads a shared-memory A M-major (the transpose of a
// K-major tile: its descriptor is an N-major one, a k16 step +2048 bytes),
// else K-major. scale_d = 0 overwrites d.

template <int TransB, int TransA>
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %20, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB),
        "n"(TransA));
}

template <int TransB, int TransA>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB),
        "n"(TransA));
}

template <int TransB, int TransA>
__device__ __forceinline__ void wgmma_ss_n96(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, %52, %51;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB),
        "n"(TransA));
}

template <int TransB, int TransA>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB),
        "n"(TransA));
}

template <int TransB, int TransA>
__device__ __forceinline__ void wgmma_ss_n256(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %132, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB),
        "n"(TransA));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TransB));
}

template <int N, int TransB, int TransA = 0>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 96 || N == 128 || N == 256, "wgmma_ss: N");
  if constexpr (N == 32) wgmma_ss_n32<TransB, TransA>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 64) wgmma_ss_n64<TransB, TransA>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 96) wgmma_ss_n96<TransB, TransA>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_ss_n128<TransB, TransA>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 256) wgmma_ss_n256<TransB, TransA>(d, desc_a, desc_b, scale_d);
}

template <int N, int TransB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N");
  if constexpr (N == 64) wgmma_rs_n64<TransB>(d, a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_rs_n128<TransB>(d, a, desc_b, scale_d);
}

// ---- the GEMM --------------------------------------------------------------
// The epilogue writes C through shared memory: each consumer warpgroup has a
// buffer of two 8 KB boxes (64 rows of 128 bytes, 128-byte swizzle), so C
// leaves in chunks of 128 (bfloat16) or 64 (float) columns, each chunk two
// TMA stores. The stores drain while the warpgroup goes on with the next
// tile; it waits for them only before it writes its buffer again.
template <int BN>
struct GemmSmem {
  static constexpr int kA = kBM * kBK * 2;
  static constexpr int kB = kBK * BN * 2;
  static constexpr int kStage = kA + kB;
  static constexpr int kOut = 2 * kBoxBytes;  // a consumer's store buffer
  // Stages, two store buffers, 2 kStages barriers, room to align to 1024.
  static constexpr int kBytes = kStages * kStage + 2 * kOut + 2 * kStages * 8 + 1024;
};

// Hands every pair of a consumer's (64, BN) accumulator tile to epi, writes
// the result into the warpgroup's buffer in the swizzled layout the store
// map reads, and stores it chunk by chunk. A thread holds, for rows r and
// r + 8, the columns 8 g + 2 q, + 1 of every 8-column group g (q = lane % 4):
// the four threads of a quad write one 16-byte unit of a 128-byte row, and
// the swizzle spreads a warp's eight rows over all banks.
template <int BN, typename Epi>
__device__ __forceinline__ void epilogue(const float* acc, uint8_t* buf,
                                         const CUtensorMap* map_c, int row0,
                                         int col0, int half, const Epi& epi) {
  using Out = typename Epi::Out;
  constexpr int kElem = sizeof(Out);
  constexpr int kBoxCols = 128 / kElem;
  constexpr int kChunkCols = 2 * kBoxCols;
  const int t = threadIdx.x % 128;
  const int q = t % 4;
  const int r = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int ch = 0; ch < BN / kChunkCols; ++ch) {
    // The buffer is free once this warpgroup's last stores have read it.
    if (t == 0) tma_store_wait_read();
    named_sync(1 + half, 128);
#pragma unroll
    for (int gg = 0; gg < kChunkCols / 8; ++gg) {
      const int g = ch * (kChunkCols / 8) + gg;
      const int box = gg / (kBoxCols / 8);
      const int byte = (8 * (gg % (kBoxCols / 8)) + 2 * q) * kElem;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        float v0 = acc[4 * g + 2 * h], v1 = acc[4 * g + 2 * h + 1];
        epi(col0 + 8 * g + 2 * q, v0, v1);
        uint8_t* dst = buf + box * kBoxBytes + row * 128 +
                       (((byte / 16) ^ (row % 8)) * 16) + byte % 16;
        if constexpr (kElem == 2)
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      }
    }
    fence_async_smem();
    named_sync(1 + half, 128);
    if (t == 0) {
      tma_store(map_c, col0 + ch * kChunkCols, row0, buf);
      tma_store(map_c, col0 + ch * kChunkCols + kBoxCols, row0, buf + kBoxBytes);
      tma_store_commit();
    }
  }
}

template <int BN, typename Epi>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_c, int M, int N, int K,
                const Epi epi) {
  using S = GemmSmem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* out_buf = smem + kStages * S::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_buf + 2 * S::kOut);
  uint64_t* empty = full + kStages;

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + kBM - 1) / kBM * n_tiles;
  const int k_blocks = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread arrives
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kBM;
        const int n0 = tile % n_tiles * BN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sa = smem + stage * S::kStage;
          mbar_expect_tx(&full[stage], S::kStage);
          tma_load(sa, &map_a, kb * kBK, m0, &full[stage]);
#pragma unroll
          for (int i = 0; i < BN / 64; ++i)
            tma_load(sa + S::kA + i * kBoxBytes, &map_b, n0 + 64 * i, kb * kBK,
                     &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int half = wg - 1;  // rows [64 half, 64 half + 64) of the tile
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * kBM;
      const int n0 = tile % n_tiles * BN;
      int prev = 0;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* sa = smem + stage * S::kStage + half * 64 * 128;
        const uint8_t* sb = smem + stage * S::kStage + S::kA;
        wgmma_fence();
        fence_regs<BN / 2>(acc);
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k)
          wgmma_ss<BN, 1>(acc, desc_kmajor(sa + 32 * k),
                          desc_nmajor(sb + 2048 * k), (kb | k) != 0);
        wgmma_commit();
        fence_regs<BN / 2>(acc);
        if (kb > 0) {
          wgmma_wait<1>();
          mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      mbar_arrive(&empty[prev]);
      epilogue<BN>(acc, out_buf + half * S::kOut, &map_c, m0 + 64 * half, n0,
                   half, epi);
    }
    // Shared memory must outlive the stores that read it.
    if (threadIdx.x % 128 == 0) tma_store_wait_read();
  }
}

template <int BN, typename Epi>
cudaError_t launch_gemm(const CUtensorMap& map_a, const CUtensorMap& map_b,
                        const CUtensorMap& map_c, int M, int N, int K,
                        const Epi& epi, cudaStream_t stream) {
  const int smem = GemmSmem<BN>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<BN, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kBM - 1) / kBM * ((N + BN - 1) / BN);
  const int sms = sm_count();
  gemm_kernel<BN, Epi><<<tiles < sms ? tiles : sms, kGemmThreads, smem,
                         stream>>>(map_a, map_b, map_c, M, N, K, epi);
  return cudaGetLastError();
}

// C = epi(A B): A (M, K) with row stride lda and B (K, N) with row stride
// ldb, bfloat16; C (M, N) of Epi::Out with row stride ldc; all in device
// memory. 256 columns a tile where N takes them whole, else 128 and a
// ragged edge. Returns the launch's error (cudaErrorInvalidValue if a tensor
// map cannot be made).
template <typename Epi>
cudaError_t gemm(const void* a, int lda, const void* b, int ldb, void* c,
                 int ldc, int M, int N, int K, const Epi& epi,
                 cudaStream_t stream) {
  CUtensorMap map_a, map_b, map_c;
  if (M < 1 || N < 8 || K < 8 || N % 8 || K % 8 ||
      !tensor_map(&map_a, a, M, K, lda, kBM) ||
      !tensor_map(&map_b, b, K, N, ldb, kBK) ||
      !tensor_map(&map_c, c, M, N, ldc, 64, sizeof(typename Epi::Out)))
    return cudaErrorInvalidValue;
  if (N % 256 == 0)
    return launch_gemm<256>(map_a, map_b, map_c, M, N, K, epi, stream);
  return launch_gemm<128>(map_a, map_b, map_c, M, N, K, epi, stream);
}

}  // namespace hg

// Dynamic shared memory of the GEMM at a tile width of bn columns (256 or
// 128), for build reports; every kernel library that includes this header
// exports it.
extern "C" int hopper_gemm_smem_bytes(int bn) {
  return bn == 256 ? hg::GemmSmem<256>::kBytes : hg::GemmSmem<128>::kBytes;
}
