// Hopper's asynchronous machinery, for kernels that feed warpgroup
// products (wgmma) from a ring of shared-memory stages filled by the
// Tensor Memory Accelerator (TMA): tensor maps encoded on the host,
// mbarrier full / empty pairs, 2-D bulk-tensor loads, matrix descriptors of
// 128-byte-swizzled K-major tiles, the products themselves and the
// register hand-over between producer and consumer warpgroups (setmaxnreg).
// sm_90a only.  Kernel C's bf16x3 core (matmul.cu) is built on it, and so
// is the producer of kernel A's and D's tile-64 ring (ring_wgmma.cuh).
//
// The shared-memory tile a 2-D load writes with CU_TENSOR_MAP_SWIZZLE_128B
// and a box 64 bf16 wide is what a K-major wgmma operand of layout type 1
// (128-byte swizzle) reads: rows of 128 bytes, 8-row groups 1024 bytes
// apart (the stride byte offset), the 16-byte pieces of row r at piece
// index XOR (r % 8).  Each tile starts on a 1024-byte boundary, so the
// descriptor's base offset is 0, and the k16 step s of a 64-wide tile is
// the descriptor whose start address is 32 s bytes further on.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Host: tensor maps.
// ---------------------------------------------------------------------------

using TensorMapEncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime, so the
// library links without -lcuda.  nullptr where libcuda lacks it.
inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found)
#endif
            != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<TensorMapEncodeTiled>(p);
  }();
  return fn;
}

// A 2-D map of a row-major matrix (rows, cols) of `type` at base with rows
// `row_bytes` apart: boxes of box_rows x box_cols elements with `swizzle`
// (a box row no wider than its span), elements past the matrix read as
// zero.  base and row_bytes must be multiples of 16.  Returns 0, the
// CUresult of a failed encoding, or -1 without the encoder.
inline int tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                         const void* base, uint64_t rows, uint64_t cols,
                         uint64_t row_bytes, uint32_t box_cols,
                         uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return (int)encode(map, type, 2, const_cast<void*>(base), dims, strides,
                     box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The bf16 map of kernel C's operands: boxes box_rows x 64 elements,
// 128-byte swizzle.
inline int tensor_map_bf16(CUtensorMap* map, const void* base, uint64_t rows,
                           uint64_t cols, uint64_t row_bytes,
                           uint32_t box_rows) {
  return tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rows,
                       cols, row_bytes, 64, box_rows,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------------------
// Device: mbarriers and bulk-tensor loads.
// ---------------------------------------------------------------------------

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread, before any other uses the barrier; then mbar_init_fence and
// a block-wide barrier.
__device__ inline void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(arrivals) : "memory");
}
__device__ inline void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of the bulk copies that complete on
// this barrier's current phase.
__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A barrier starts
// in phase 0, so waiting on parity 1 first passes at once: a producer
// waits on its empty barriers with the parity its consumers wait on the
// full ones, flipped.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
}

// Box (x, y) of `map` (x: the element column, y: the row) into dst, its
// bytes counted on bar.  map must live in kernel parameter space
// (__grid_constant__).
__device__ inline void tma_load_2d(void* dst, const CUtensorMap* map,
                                   uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

__device__ inline void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---------------------------------------------------------------------------
// Device: warpgroup products on 128-byte-swizzled K-major tiles.
// ---------------------------------------------------------------------------

// The descriptor of the K-major tile at p (1024-byte aligned, rows of 128
// bytes): stride byte offset 1024 (the next 8 rows), leading byte offset
// unused by this layout (16), layout type 1.  Add 2 for each k16 step.
__device__ inline uint64_t gmma_desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)1 << 16)
       | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ inline void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// At most N of this warpgroup's product groups still running.
template <int N>
__device__ inline void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the fences
// and waits above.
template <int R>
__device__ inline void gmma_pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A.B^T, m64n128k16, bf16 in, f32 sums, both operands K-major
// through their descriptors.  Thread t of the warpgroup holds, for j < 16,
// d[4 j], d[4 j + 1] at row 16 (t / 32) + (t % 32) / 4, columns
// 8 j + 2 (t % 4) and + 1, and d[4 j + 2], d[4 j + 3] 8 rows further.
__device__ inline void gmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                        uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Registers a thread: all four warps of a warpgroup run it together, in
// one branch per role that never rejoins the others.
template <int R>
__device__ inline void regs_raise() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ inline void regs_lower() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

}  // namespace
