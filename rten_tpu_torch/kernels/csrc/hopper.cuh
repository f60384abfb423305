// Hopper building blocks shared by the prefill kernels (quant_matmul.cu,
// flash_attention.cu, quant_matmul_w8a8.cu, matmul_fused.cu) and the decode
// kernels: mbarriers, TMA tile loads and their tensor maps, 1-D bulk copies
// and the proxy fence before reusing their destination, the global timer,
// the producer loop of a TMA ring,
// cp.async with zero fill, warpgroup MMA (wgmma) with the A operand in
// registers or in shared memory (bf16, int8; B K-major or MN-major), the
// int8 -> bf16 conversion of an A fragment, and the rank-order sum of a
// split-K cluster's partials. PTX as the ISA documents it for sm_90a.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (the driver call is fetched at run time)

#include <type_traits>

#include "common.cuh"

namespace rt {
namespace {

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and to the
// other blocks of the cluster.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and announce `bytes` of TMA traffic that completes the phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA ----------------------------------------------------------------

// The 2-D box at (c0 = column, c1 = row) of `map` into shared memory; its
// bytes complete the transaction count of `bar`. Elements past the tensor's
// edge arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's earlier generic-proxy accesses to shared memory before
// the bulk copies it issues next (a destination written again).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The card's global timer, in ns (for measurement builds of a kernel).
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Bring a tensor map (a kernel parameter) into the TMA unit's cache ahead
// of its first load.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no link against libcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of a row-major [rows, cols] matrix (`ld` bytes between rows,
// a multiple of 16) read in boxes of box_rows x box_cols elements, each
// box row 128 bytes or less, stored in shared memory with the 128-byte
// swizzle (16-byte chunk c of box row r lands at chunk c ^ (r % 8)).
inline cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t cols,
                                 uint64_t rows, uint64_t ld, uint32_t box_cols, uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- cp.async -------------------------------------------------------------

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// 4 bytes (one f32), or 4 zero bytes when !valid: for rows whose width is
// not a multiple of 16 bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 8 bytes, or 8 zero bytes when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// A piece of `bytes` (16, 8, 4, 2 or 1; the source and destination aligned
// to it) from global to shared memory, or zero bytes when !valid: cp.async
// from 4 bytes up (in the caller's commit group), a plain load and store
// below, which a barrier then publishes like the rest. For rows narrower
// than 16 bytes, or rows whose start is not 16-byte aligned.
__device__ __forceinline__ void copy_piece(void* dst, const void* src, bool valid, int bytes) {
  if (bytes == 16) {
    cp_async16(dst, src, valid);
  } else if (bytes == 8) {
    cp_async8(dst, src, valid);
  } else if (bytes == 4) {
    cp_async4(dst, src, valid);
  } else if (bytes == 2) {
    *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : uint16_t{0};
  } else {
    *static_cast<uint8_t*>(dst) = valid ? *static_cast<const uint8_t*>(src) : uint8_t{0};
  }
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (.noinc: the arrival is one of those the barrier was initialised to count).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep a register live (and unmoved) across an asynchronous wgmma: the
// compiler does not know the instruction reads or writes it after issue.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// Shared-memory matrix descriptor of a K-major operand tile written by TMA
// with the 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes
// apart (SBO), the leading offset unused (1), layout type 1 (128B). A step
// of 16 bf16 along K inside the 128-byte row adds 32 bytes to the start.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Both operands from shared memory (SS), sums in place, always accumulated
// (the caller zeroes them): int8 m64nNk32 (both K-major, the only layout
// int8 takes; a k32 step is 32 bytes, +2 on a sw128_desc), and bf16
// m64n128k16 / m64n256k16 with A K-major and B MN-major (the transpose-B
// bit; a k16 step is 16 rows of B, +128 on a sw128_mn_desc).
__device__ __forceinline__ void wgmma_ss_s8_n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_s8_n128(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_bf16_n128_tb(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_bf16_n256_tb(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Shared-memory matrix descriptor of an MN-major operand tile (B of a
// row-major [K, N] matrix, N contiguous) written by TMA with the 128-byte
// swizzle in boxes of 64 bf16 columns (128 bytes) by the tile's K rows:
// inside a box a swizzle atom is 8 K rows of 128 bytes, the next 8 rows
// 1024 bytes on (SBO); the next 64 columns, the next box, `box_bytes` on
// (LBO); layout type 1 (128B). A step of 16 K rows adds 2048 bytes.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* tile, uint32_t box_bytes) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((box_bytes >> 4) & 0x3FFF) << 16) | (64ull << 32) |
         (1ull << 62);
}

// Two int8 (the low 16 bits of w; byte 0 is the lower k) as a bf16 pair,
// byte 0 in the low half: each byte, offset to unsigned by the XOR, becomes
// the low mantissa byte of 2^23 (one byte permute), one subtraction removes
// 2^23 + 128, and the f32's upper half is the bf16 (exact: |v| <= 128 has 8
// significant bits).
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w) {
  const uint32_t u = w ^ 0x8080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// ---- the TMA ring and the split-K cluster ---------------------------------

// The producer of a ring of STAGES stages: for each of K steps begin ..
// n_steps - 1, wait until the consumers have freed the stage (its "empty"
// phase), announce `stage_bytes` on its "full" mbarrier and issue
// load(stage, step, full): the TMA box loads that complete that phase. One
// thread runs it.
template <int STAGES, typename Load>
__device__ __forceinline__ void ring_produce(int begin, int n_steps, uint64_t* full, uint64_t* empty,
                                             unsigned stage_bytes, const Load& load) {
  for (int i = begin; i < n_steps; ++i) {
    const int st = i % STAGES;
    mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[st], stage_bytes);
    load(st, i, &full[st]);
  }
}

__device__ __forceinline__ float4 add4(const float4& x, const float4& y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}
__device__ __forceinline__ int4 add4(const int4& x, const int4& y) {
  return make_int4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

// The sum over the cluster's ranks 0..n_split-1, in that order, of the four
// values at `piece` in each rank's shared memory (every rank's load in
// flight first): this block's own four through a plain shared-memory load,
// the other ranks' through distributed shared memory; the block's own four
// when it is alone. `piece` must be a shared-memory pointer the compiler
// can see as one (see smem_align), or every load goes the distributed way.
template <int MAX_CLUSTER, typename V>
__device__ __forceinline__ V cluster_sum4(cooperative_groups::cluster_group& cluster, const V* piece, int n_split,
                                          int rank) {
  if (n_split == 1) return *piece;
  V part[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q) {
    if (q < n_split) part[q] = q == rank ? *piece : *cluster.map_shared_rank(piece, q);
  }
  V sum = part[0];
#pragma unroll
  for (int q = 1; q < MAX_CLUSTER; ++q) {
    if (q < n_split) sum = add4(sum, part[q]);
  }
  return sum;
}

// The epilogue activation with its code fixed at compile time (ACT 0 none,
// 1 gelu, 2 relu; 3 stands for codes 3-5, the out-of-line activate_exp),
// so that an epilogue loop carries no per-element dispatch on the code.
template <int ACT>
__device__ __forceinline__ float activate_t(float v, int act) {
  if constexpr (ACT == 0) {
    return v;
  } else if constexpr (ACT == 1) {
    return activate(v, 1);
  } else if constexpr (ACT == 2) {
    return fmaxf(v, 0.f);
  } else {
    return activate_exp(v, act);
  }
}

// body(std::integral_constant<int, ACT>) for the activation code `act`: one
// copy of an epilogue loop per ACT of activate_t, chosen once.
template <typename Body>
__device__ __forceinline__ void with_activation(int act, const Body& body) {
  switch (act) {
    case 0:
      body(std::integral_constant<int, 0>{});
      break;
    case 1:
      body(std::integral_constant<int, 1>{});
      break;
    case 2:
      body(std::integral_constant<int, 2>{});
      break;
    default:
      body(std::integral_constant<int, 3>{});
  }
}

// A cluster barrier where the block has partners, a block barrier where it
// is alone (the cluster barrier also fences the block's global writes).
__device__ __forceinline__ void cluster_or_block_sync(cooperative_groups::cluster_group& cluster, int n_split) {
  if (n_split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
}

// `raw` (dynamic shared memory) rounded up to a 1024-byte boundary, the
// 128-byte swizzle's atom, by pointer arithmetic on the shared array: the
// compiler keeps seeing shared memory, so reads and writes through the
// result are shared-memory instructions, not generic ones (an integer
// round trip through uintptr_t would lose that).
__device__ __forceinline__ unsigned char* smem_align(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// Four neighbouring outputs (row, col .. col + 3) of a row-major [*, n] f32
// or bf16 matrix, one 16- or 8-byte store where the row allows it, else
// one by one up to the ragged N edge.
__device__ __forceinline__ void store_row4(void* out, int bf16, int n, int row, int col, const float (&v)[4]) {
  const size_t o = (size_t)row * n + col;
  if (col + 3 < n && (n & 3) == 0) {
    if (bf16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 w;
      w.x = *reinterpret_cast<const unsigned*>(&lo);
      w.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) = w;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < n) store_act(out, bf16, o + j, v[j]);
}

// The most clusters of `split` blocks of `kernel` (THREADS threads, SMEM
// bytes of dynamic shared memory) the device holds at once, or minus a
// CUDA error: the host plans split-K within it.
template <typename Kernel>
int max_active_clusters(Kernel kernel, int threads, int smem, bool& smem_allowed, int split) {
  cudaError_t e = allow_smem(kernel, smem, smem_allowed);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Launch `kernel` on a grid of `grid` blocks as clusters of `split` along x
// (a plain launch when split is 1).
template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel kernel, dim3 grid, int threads, int smem, int split, cudaStream_t st,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace
}  // namespace rt
