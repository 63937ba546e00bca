// Kernel C: the pairwise product out[i, j] = sum_d q[i, d] * c[j, d], f32,
// (m, n) row-major.
//
// Replaces polars_matmul_tpu/kernels/matmul.py:46 (_mm_kernel, run by the
// pallas_call at matmul.py:101): the TPU kernel walks a grid (M/bm, N/bn,
// K/bk) with K innermost, in order on one core, and carries each (bm, bn)
// sum in a VMEM scratch accumulator from one K step to the next; the
// caller pads q and c to whole blocks first.  Here a block owns whole
// output tiles and a loop over the features inside the block takes the
// place of the K grid axis; the sums stay in registers.  Rows past m or n
// read as zero and outputs past the edge are not written, so q and c are
// never padded.  Output offsets are 64-bit: m * n passes 2^31 at 50,000 x
// 50,000.
//
// What bounds it on the H100: the products.  At the canonical 1000 x
// 10,000 x 256 shape "highest" is 5.1 GFLOP, 0.076 ms at the 67 TFLOP/s
// f32 peak, against 0.015 ms to read the inputs and write the 40 MB
// output once at 3.35 TB/s; bf16x3's three bf16 products are 0.0155 ms at
// 989 TFLOP/s, level with the bytes.  At 8192 x 65,536 x 768 the products
// take 12.3 ms (f32) or 2.50 ms (bf16x3) and the 2.15 GB output 0.64 ms.
// A few queries against 65,536 x 768 are bound by bytes instead: c is
// 201 MB, 0.060 ms.
//
// Two cores, chosen by the caller; make_plan picks each call's launch:
//
// - "highest" (precision "default", "high", "highest"): f32 FFMA on the CUDA
//   cores, the exact tier (one fmaf a feature, in feature order, so its sums
//   are the old kernel's bit for bit).  A block of 128 threads owns a
//   16 R x 64 output tile, each thread R x 8 of it (rows ty + 16 i, columns
//   tx + 8 j): R = 8 (128 rows, two blocks an SM at 254 registers a
//   thread), or 2 or 4 where m <= 32 or 64, so that a few queries do not
//   pay for 128 rows.  The rows stream through a ring of kFStages stages of
//   kFK features, filled by 16-byte cp.async.cg straight from the rows,
//   neighbouring threads on neighbouring pieces (no register staging, no
//   transposing stores: the old kernel staged 8 features a barrier through
//   registers).  Fragments are read back as float4 along the features (q's
//   R rows at once, c's 8 in two halves): at R = 8, 16 shared loads feed
//   256 FMAs.  A staged row is kFLd floats (144 bytes), so the 8
//   consecutive rows a quarter-warp reads fall on distinct 16-byte banks
//   and the rows a quarter-warp shares are one broadcast.  One barrier a
//   stage.  Blocks take tiles in grouped order (tile_at): kGroup row tiles
//   of q share c's tiles in L2, where the old plain row order read all of c
//   once per 128 rows of q.  The 64-wide tile was chosen by measurement
//   (PERF.md): at the canonical shape its 1256 tiles fill 4.8 waves of 264
//   blocks where 128-wide ones filled 2.4, and it was no slower at 8192 x
//   65,536 x 768.  Rows not 16-byte aligned (dim % 4 != 0) take 4-byte
//   copies.
//
// - "bf16x3" (precision "bf16x3", "bf16c"): three bf16 products with f32
//   sums, qh.ch into one accumulator and qh.cl + ql.ch into another,
//   summed last (the grouping of kernels/matmul.py::pallas_matmul_plain).
//   Above kMmaMaxM queries, on Hopper's warpgroup path (tma_ring.cuh):
//   * split_pad_kernel splits q and c once a call, one launch for both,
//     into bf16 [hi | lo] rows (hi rounds in IEEE bit space, lo = x - hi
//     rounded to nearest even: kernels/fused_topk.py::split_hi_lo) padded
//     with zeros to dp, a multiple of 64 features, so each row is whole
//     128-byte boxes whatever dim is (rows 4 dp bytes apart, as the TMA
//     wants).  The old kernel split each q row once per 128 rows of c.
//   * matmul_wgmma_kernel is persistent (one block an SM walks 128 x 128
//     output tiles in grouped order) and warp-specialised: a producer
//     warp issues TMA loads of 64-feature boxes of q's hi and lo rows and
//     c's into a ring of shared-memory stages (128-byte swizzle, mbarrier
//     full / empty pairs) and hands its registers to the two consumer
//     warpgroups (setmaxnreg), which each own 64 rows of the q tile and
//     run three wgmma.mma_async m64n128k16 a k16 step with both operands
//     read from shared memory.  The producer runs a whole ring ahead
//     across tiles, so one tile's stores overlap the next one's loads.
//   At m <= kMmaMaxM against a large c the call is bound by c's bytes,
//   which the split pass and the product move three times, and the old
//   kernel's body (matmul_mma_kernel: mma.sync m16n8k16, each value split
//   as it is staged, c read once) is faster there, so it stays for those
//   calls where its blocks fill their last wave (make_plan).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

// The cores, in the order of kernels/matmul.py's CORES.
enum Core : int { kHighest = 0, kBf16x3 = 1 };

// Row tiles of the A operand one group of consecutive tile ids spans.
constexpr int kGroup = 8;

// Tile t of a tiles_a x tiles_b grid in grouped order: groups of kGroup
// rows of A tiles (the last may be shorter), each walked down its rows
// first, then along B.  Consecutive ids share a few A tiles and a few B
// tiles.
__device__ inline void tile_at(int t, int tiles_a, int tiles_b, int& ta,
                               int& tb) {
  const int span = kGroup * tiles_b;
  const int g = t / span, r = t - g * span;
  const int first = g * kGroup;
  const int rows = tiles_a - first < kGroup ? tiles_a - first : kGroup;
  ta = first + r % rows;
  tb = r / rows;
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return 0;
  return sms;
}

// ---------------------------------------------------------------------------
// "highest": f32 FFMA fed by a cp.async ring.
// ---------------------------------------------------------------------------

constexpr int kFThreads = 128;            // 16 x 8 threads
constexpr int kFBlocks = 2;               // blocks an SM asked of ptxas
constexpr int kFN = 64;                   // output columns (c rows) a tile
constexpr int kFK = 32;                   // features a stage
constexpr int kFStages = 3;               // stages of the ring
constexpr int kFLd = kFK + 4;             // a staged row, floats

// Output rows (q) a tile: 16 R for R rows a thread.  The smallest of 32,
// 64 and 128 that holds m, so a few queries do not pay for 128 rows.
inline int f32_rows(int m) { return m <= 32 ? 32 : m <= 64 ? 64 : 128; }

// Dynamic shared memory of the ring for FM rows of q a tile: q's rows,
// then c's, each stage.
constexpr int f32_smem(int fm) {
  return kFStages * (fm + kFN) * kFLd * (int)sizeof(float);
}

__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ inline void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One copy into stage st: features k0 + p.. (kPer of them) of tile row r
// (q's FM rows row0.. first, then c's col0..), zero past m, n or dim (a
// copy of no bytes from q).
template <bool VEC, int FM>
__device__ inline void f32_copy(float* st, const float* __restrict__ q,
                                const float* __restrict__ c, int m, int n,
                                int dim, int row0, int col0, int k0, int r,
                                int p) {
  const bool is_q = r < FM;
  const int row = is_q ? row0 + r : col0 + r - FM;
  const bool in = row < (is_q ? m : n) && k0 + p < dim;
  const float* from = in ? (is_q ? q : c) + (size_t)row * dim + k0 + p : q;
  if constexpr (VEC)
    cp_async16(st + r * kFLd + p, from, in ? 16 : 0);
  else
    cp_async4(st + r * kFLd + p, from, in ? 4 : 0);
}

// Start copying features [k0, k0 + kFK) of the tile's rows into stage st.
// Neighbouring threads copy neighbouring pieces of a row, so a warp reads
// whole 32-byte sectors.  The 4-byte form (rows not 16-byte aligned) is
// a rolled loop: unrolled, its addresses spill.
template <bool VEC, int FM>
__device__ inline void f32_stage(float* st, const float* __restrict__ q,
                                 const float* __restrict__ c, int m, int n,
                                 int dim, int row0, int col0, int k0) {
  constexpr int kPer = VEC ? 4 : 1;           // features a copy
  constexpr int kCopies = kFK / kPer;         // copies a row
  constexpr int kRows = kFThreads / kCopies;  // rows a pass of the block
  static_assert((FM + kFN) % kRows == 0, "whole passes");
  const int r0 = threadIdx.x / kCopies, p = kPer * (threadIdx.x % kCopies);
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < (FM + kFN) / kRows; ++i)
      f32_copy<VEC, FM>(st, q, c, m, n, dim, row0, col0, k0, r0 + i * kRows,
                        p);
  } else {
#pragma unroll 1
    for (int i = 0; i < (FM + kFN) / kRows; ++i)
      f32_copy<VEC, FM>(st, q, c, m, n, dim, row0, col0, k0, r0 + i * kRows,
                        p);
  }
}

// Four consecutive features of a staged row: one 16-byte shared load.
__device__ inline void load4(float (&v)[4], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// R rows a thread: a 16 R x 64 output tile, each thread rows ty + 16 i
// (i < R) by columns tx + 8 j (j < 8).
template <bool VEC, int R>
__global__ void __launch_bounds__(kFThreads, kFBlocks)
matmul_f32_kernel(const float* __restrict__ q, const float* __restrict__ c,
                  float* __restrict__ out, int m, int n, int dim,
                  int tiles_a, int tiles_b) {
  constexpr int FM = 16 * R, kCols = kFN / 8;
  constexpr int kStage = (FM + kFN) * kFLd;
  extern __shared__ __align__(16) float fsm[];
  int ta, tb;
  tile_at(blockIdx.x, tiles_a, tiles_b, ta, tb);
  const int row0 = ta * FM, col0 = tb * kFN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = 4 * warp + (lane >> 3);   // rows ty + 16 i
  const int tx = lane & 7;                 // columns tx + 8 j
  float acc[R][kCols];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const int steps = (dim + kFK - 1) / kFK;
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < steps)
      f32_stage<VEC, FM>(fsm + s * kStage, q, c, m, n, dim, row0, col0,
                         s * kFK);
    cp_async_commit();
  }
  int rd = 0, wr = kFStages - 1;
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kFStages - 2>();   // this thread's copies of stage kt
    // Everyone's copies landed, and everyone is done with stage kt - 1,
    // which is the one refilled next.
    __syncthreads();
    if (kt + kFStages - 1 < steps)
      f32_stage<VEC, FM>(fsm + wr * kStage, q, c, m, n, dim, row0, col0,
                         (kt + kFStages - 1) * kFK);
    cp_async_commit();
    wr = wr == kFStages - 1 ? 0 : wr + 1;
    const float* As = fsm + rd * kStage + ty * kFLd;
    const float* Bs = fsm + rd * kStage + (FM + tx) * kFLd;
    rd = rd == kFStages - 1 ? 0 : rd + 1;
#pragma unroll
    for (int kk = 0; kk < kFK; kk += 4) {
      float a[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i) load4(a[i], As + 16 * i * kFLd + kk);
#pragma unroll
      for (int jq = 0; jq < kCols / 4; ++jq) {   // four columns at a time
        float b[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          load4(b[j], Bs + 8 * (4 * jq + j) * kFLd + kk);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][4 * jq + j] = fmaf(a[i][e], b[j][e], acc[i][4 * jq + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
    float* o = out + (size_t)r * n;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = col0 + tx + 8 * j;
      if (col < n) o[col] = acc[i][j];
    }
  }
}

// The instantiation for R rows a thread.
template <int R>
int launch_f32(const float* q, const float* c, float* out, int m, int n,
               int dim, int blocks, cudaStream_t stream) {
  const bool vec = dim % 4 == 0 && aligned(q, 16) && aligned(c, 16);
  auto kernel = vec ? matmul_f32_kernel<true, R> : matmul_f32_kernel<false, R>;
  constexpr int smem = f32_smem(16 * R);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, kFThreads, smem, stream>>>(q, c, out, m, n, dim,
                                              cdiv(m, 16 * R), cdiv(n, kFN));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "bf16x3": the split, then TMA + wgmma.
// ---------------------------------------------------------------------------

// Features of a split row's hi (and of its lo) half: dim rounded up to
// whole 64-feature boxes.
inline int padded_dim(int dim) { return (dim + 63) / 64 * 64; }

// x = hi + lo, both bf16 bits: hi rounds in IEEE bit space (+0x8000, clear
// the low 16 bits), lo = x - hi (exact in f32) rounded to nearest even.
__device__ inline void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x8000u) & 0xFFFF0000u;
  hi = h >> 16;
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(x - __uint_as_float(h)));
}

// Rows [0, m) of out are q's, [m, m + n) c's, each dp hi then dp lo bf16
// values; four features an item, zero past dim.
__global__ void __launch_bounds__(256)
split_pad_kernel(const float* __restrict__ q, const float* __restrict__ c,
                 uint16_t* __restrict__ out, int m, int n, int dim, int dp,
                 bool vec) {
  const int per_row = dp / 4;
  const size_t items = (size_t)(m + n) * per_row;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < items;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e / per_row), f = 4 * (int)(e % per_row);
    const float* src = r < m ? q + (size_t)r * dim
                             : c + (size_t)(r - m) * dim;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec && f < dim) {
      v = *reinterpret_cast<const float4*>(src + f);
    } else {
      if (f < dim) v.x = src[f];
      if (f + 1 < dim) v.y = src[f + 1];
      if (f + 2 < dim) v.z = src[f + 2];
      if (f + 3 < dim) v.w = src[f + 3];
    }
    uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
    split(v.x, h0, l0);
    split(v.y, h1, l1);
    split(v.z, h2, l2);
    split(v.w, h3, l3);
    uint16_t* row = out + (size_t)r * 2 * dp;
    *reinterpret_cast<uint2*>(row + f) =
        make_uint2(h0 | h1 << 16, h2 | h3 << 16);
    *reinterpret_cast<uint2*>(row + dp + f) =
        make_uint2(l0 | l1 << 16, l2 | l3 << 16);
  }
}

constexpr int kWgBM = 128;         // q rows a tile: two warpgroups of 64
constexpr int kWgBN = 128;         // c rows a tile
constexpr int kWgBK = 64;          // features a stage (one 128-byte box)
constexpr int kWgStages = 3;       // stages of the ring
constexpr int kWgThreads = 384;    // two consumer warpgroups, a producer
constexpr int kWgBox = kWgBK * 2;  // bytes of a box row
constexpr int kWgA = kWgBM * kWgBox;           // q's hi (or lo) box
constexpr int kWgB = kWgBN * kWgBox;           // c's
constexpr int kWgStage = 2 * (kWgA + kWgB);
constexpr int kWgSmem = kWgStages * kWgStage + 1024;   // + alignment

// Rows of both maps are split rows: hi at columns [0, dp), lo at
// [dp, 2 dp).
__global__ void __launch_bounds__(kWgThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap c_map,
                    float* __restrict__ out, int m, int n, int dp,
                    bool out_vec) {
  constexpr int BN = kWgBN, NS = kWgStages;
  extern __shared__ unsigned char wsm_raw[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS];
  unsigned char* wsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wsm_raw) + 1023) & ~(uintptr_t)1023);
  const int tiles_a = (m + kWgBM - 1) / kWgBM;
  const int tiles_b = (n + BN - 1) / BN;
  const int tiles = tiles_a * tiles_b, kblocks = dp / kWgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);   // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();
  // Warp-uniform as far as the compiler can tell (a shuffle of lane 0's):
  // the products may then sit in the consumers' branch unserialised.
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (wg == 2) {   // the producer: one thread issues every load
    regs_lower<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&c_map);
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int ta, tb;
        tile_at(t, tiles_a, tiles_b, ta, tb);
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);   // the consumers freed stage s
          unsigned char* st = wsm + s * kWgStage;
          mbar_expect_tx(&full[s], kWgStage);
          const int x = kb * kWgBK;
          tma_load_2d(st, &q_map, &full[s], x, ta * kWgBM);
          tma_load_2d(st + kWgA, &q_map, &full[s], dp + x, ta * kWgBM);
          tma_load_2d(st + 2 * kWgA, &c_map, &full[s], x, tb * BN);
          tma_load_2d(st + 2 * kWgA + kWgB, &c_map, &full[s], dp + x,
                      tb * BN);
          if (++s == NS) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {   // the consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64)
    regs_raise<232>();
    const int wt = threadIdx.x & 127, lane = wt & 31;
    const int r16 = 16 * (wt >> 5) + (lane >> 2);   // row in the 64
    const int c2 = 2 * (lane & 3);                  // column in the 8
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int ta, tb;
      tile_at(t, tiles_a, tiles_b, ta, tb);
      float acc1[BN / 2], acc2[BN / 2];   // qh.ch; qh.cl + ql.ch
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) { acc1[i] = 0.f; acc2[i] = 0.f; }
      gmma_pin(acc1);
      gmma_pin(acc2);
      int held = -1;   // the stage whose products may still run
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[s], ph);
        const unsigned char* st = wsm + s * kWgStage;
        const uint64_t ah = gmma_desc_sw128(st + wg * 64 * kWgBox);
        const uint64_t al = gmma_desc_sw128(st + kWgA + wg * 64 * kWgBox);
        const uint64_t bh = gmma_desc_sw128(st + 2 * kWgA);
        const uint64_t bl = gmma_desc_sw128(st + 2 * kWgA + kWgB);
        gmma_fence();
#pragma unroll
        for (int k = 0; k < kWgBK / 16; ++k) {   // +32 bytes a k16 step
          gmma_ss_m64n128k16(acc1, ah + 2 * k, bh + 2 * k);
          gmma_ss_m64n128k16(acc2, ah + 2 * k, bl + 2 * k);
          gmma_ss_m64n128k16(acc2, al + 2 * k, bh + 2 * k);
        }
        gmma_commit();
        gmma_wait<1>();   // the previous stage's products are done
        if (held >= 0) mbar_arrive(&empty[held]);
        held = s;
        if (++s == NS) { s = 0; ph ^= 1; }
      }
      gmma_wait<0>();
      gmma_pin(acc1);
      gmma_pin(acc2);
      if (held >= 0) mbar_arrive(&empty[held]);

      // Every value is formed outside the edge tests: an accumulator read
      // under a branch that depends on the thread serialises the products.
      const int a0 = ta * kWgBM + 64 * wg + r16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = a0 + 8 * h;
        const bool in = a < m;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int b = tb * BN + 8 * j + c2;
          const float v0 = acc1[4 * j + 2 * h] + acc2[4 * j + 2 * h];
          const float v1 = acc1[4 * j + 2 * h + 1] + acc2[4 * j + 2 * h + 1];
          float* o = out + (size_t)a * n + b;
          if (in && out_vec && b + 1 < n) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            if (in && b < n) o[0] = v0;
            if (in && b + 1 < n) o[1] = v1;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// "bf16x3" at m <= kMmaMaxM: the old kernel's body, mma.sync on operands
// split as they are staged.
// ---------------------------------------------------------------------------

// Up to this many queries (one row of 128 x 128 blocks) the old body may
// beat the split pass and the wgmma product (PERF.md, "PR 17 — small m").
constexpr int kMmaMaxM = 128;

constexpr int kMmThreads = 256;   // 8 warps
constexpr int kMmBM = 128;        // output rows per block (q rows)
constexpr int kMmBN = 128;        // output columns per block (c rows)
constexpr int kHK = 16;           // features per stage (one k16)
constexpr int kHP = kHK + 8;      // bf16 row stride: conflict-free reads

// Four features [k, k + 4) of row r of a (rows, dim) f32 operand, zero past
// the row count and the dim.  The vector form needs dim % 4 == 0 and a
// 16-byte aligned operand.
__device__ inline float4 ldg4(const float* __restrict__ src, int r, int rows,
                              int k, int dim, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= rows || k >= dim) return v;
  const float* p = src + (size_t)r * dim + k;
  if (vec) return *reinterpret_cast<const float4*>(p);
  v.x = p[0];
  if (k + 1 < dim) v.y = p[1];
  if (k + 2 < dim) v.z = p[2];
  if (k + 3 < dim) v.w = p[3];
  return v;
}

__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Split four features of staging row r into the hi and lo tiles (row
// stride kHP bf16; k is a multiple of 4, so each half is one 8-byte store).
__device__ inline void stage_split(uint16_t* hi, uint16_t* lo, float4 v,
                                   int r, int k) {
  uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
  split(v.x, h0, l0);
  split(v.y, h1, l1);
  split(v.z, h2, l2);
  split(v.w, h3, l3);
  *reinterpret_cast<uint2*>(hi + r * kHP + k) =
      make_uint2(h0 | h1 << 16, h2 | h3 << 16);
  *reinterpret_cast<uint2*>(lo + r * kHP + k) =
      make_uint2(l0 | l1 << 16, l2 | l3 << 16);
}

// A block owns one 128 x 128 output tile (blockIdx.y: q's, .x: c's);
// eight warps each a 64 x 32 piece; stages of 16 features, two of each
// operand half.
__global__ void __launch_bounds__(kMmThreads)
matmul_mma_kernel(const float* __restrict__ q, const float* __restrict__ c,
                  float* __restrict__ out, int m, int n, int dim, bool vec,
                  bool out_vec) {
  constexpr int kTile = kMmBM * kHP;   // kMmBM == kMmBN
  __shared__ __align__(16) uint16_t Ah[2][kTile], Al[2][kTile];
  __shared__ __align__(16) uint16_t Bh[2][kTile], Bl[2][kTile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2;   // output rows [64 wm, 64 wm + 64)
  const int wn = warp & 3;    // output columns [32 wn, 32 wn + 32)
  const int row0 = blockIdx.y * kMmBM, col0 = blockIdx.x * kMmBN;
  // Staging: two vectors of four features per operand and thread.
  int sr[2], sk[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = tid + s * kMmThreads;
    sr[s] = e >> 2;
    sk[s] = (e & 3) * 4;
  }
  float acc1[4][4][4], acc2[4][4][4];   // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int f = 0; f < 4; ++f) { acc1[i][j][f] = 0.f; acc2[i][j][f] = 0.f; }

  float4 ra[2], rb[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    ra[s] = ldg4(q, row0 + sr[s], m, sk[s], dim, vec);
    rb[s] = ldg4(c, col0 + sr[s], n, sk[s], dim, vec);
    stage_split(Ah[0], Al[0], ra[s], sr[s], sk[s]);
    stage_split(Bh[0], Bl[0], rb[s], sr[s], sk[s]);
  }
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < dim; k0 += kHK) {
    const bool more = k0 + kHK < dim;
    if (more) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        ra[s] = ldg4(q, row0 + sr[s], m, k0 + kHK + sk[s], dim, vec);
        rb[s] = ldg4(c, col0 + sr[s], n, k0 + kHK + sk[s], dim, vec);
      }
    }
    // Fragments (mma.m16n8k16 .row.col): A rows g and g + 8, features
    // 2 tig (+1) and 2 tig + 8 (+1); B column g, the same features.
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int o = (64 * wm + 16 * mt + g) * kHP + 2 * tig;
      ah[mt][0] = ld32(Ah[buf] + o);
      ah[mt][1] = ld32(Ah[buf] + o + 8 * kHP);
      ah[mt][2] = ld32(Ah[buf] + o + 8);
      ah[mt][3] = ld32(Ah[buf] + o + 8 * kHP + 8);
      al[mt][0] = ld32(Al[buf] + o);
      al[mt][1] = ld32(Al[buf] + o + 8 * kHP);
      al[mt][2] = ld32(Al[buf] + o + 8);
      al[mt][3] = ld32(Al[buf] + o + 8 * kHP + 8);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int o = (32 * wn + 8 * nt + g) * kHP + 2 * tig;
      const uint32_t bh0 = ld32(Bh[buf] + o), bh1 = ld32(Bh[buf] + o + 8);
      const uint32_t bl0 = ld32(Bl[buf] + o), bl1 = ld32(Bl[buf] + o + 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        mma_bf16(acc1[mt][nt], ah[mt], bh0, bh1);
        mma_bf16(acc2[mt][nt], ah[mt], bl0, bl1);
        mma_bf16(acc2[mt][nt], al[mt], bh0, bh1);
      }
    }
    // The other buffers were last read before the previous barrier.
    if (more) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        stage_split(Ah[buf ^ 1], Al[buf ^ 1], ra[s], sr[s], sk[s]);
        stage_split(Bh[buf ^ 1], Bl[buf ^ 1], rb[s], sr[s], sk[s]);
      }
    }
    __syncthreads();
    buf ^= 1;
  }

  // Accumulator layout: fragments 0, 1 at (row g, columns 2 tig, 2 tig + 1),
  // 2, 3 at row g + 8.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 64 * wm + 16 * mt + g + 8 * h;
      if (r >= m) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = col0 + 32 * wn + 8 * nt + 2 * tig;
        const float v0 = acc1[mt][nt][2 * h] + acc2[mt][nt][2 * h];
        const float v1 = acc1[mt][nt][2 * h + 1] + acc2[mt][nt][2 * h + 1];
        float* o = out + (size_t)r * n + col;
        if (out_vec && col < n) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (col < n) o[0] = v0;
          if (col + 1 < n) o[1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------------------
// The launch plan.
// ---------------------------------------------------------------------------

// The kernel a plan runs.
enum Body : int { kFfma = 0, kWgmma = 1, kMma = 2 };

// The launch kernel C makes: q rows and c rows a tile, the body, the
// group of q tiles of the tile order (1: the mma body's plain grid), ring
// stages, blocks, dynamic shared memory bytes.  The one place its
// geometry is worked out.
struct Plan {
  int bm, bn, body, group, stages, blocks, smem;
};

// The plan for (m, n, dim) in `core` on this card; false for arguments
// the kernel does not take.
bool make_plan(int m, int n, int dim, int core, Plan& p) {
  if (m <= 0 || n <= 0 || dim <= 0) return false;
  if (core == kHighest) {
    const int fm = f32_rows(m);
    const long long tiles = (long long)cdiv(m, fm) * cdiv(n, kFN);
    if (tiles > INT_MAX) return false;
    p = {fm, kFN, kFfma, kGroup, kFStages, (int)tiles, f32_smem(fm)};
    return true;
  }
  if (core != kBf16x3) return false;
  const int sms = device_sms();
  if (sms <= 0) return false;
  // The old body runs a block an SM at a time, so it pays for whole waves:
  // it wins where its one row of blocks fills its last wave at least 5/6
  // full, and loses to wgmma's per-tile speed where that wave is short.
  const int mma_blocks = cdiv(n, kMmBN);
  if (m <= kMmaMaxM && 6LL * mma_blocks >= 5LL * cdiv(mma_blocks, sms) * sms) {
    p = {kMmBM, kMmBN, kMma, 1, 2, mma_blocks, 0};
    return true;
  }
  const long long tiles = (long long)cdiv(m, kWgBM) * cdiv(n, kWgBN);
  if (tiles > INT_MAX) return false;
  p = {kWgBM, kWgBN, kWgmma, kGroup, kWgStages,
       tiles < sms ? (int)tiles : sms, kWgSmem};
  return true;
}

int launch_wgmma(const uint16_t* split, float* out, int m, int n, int dim,
                 const Plan& p, cudaStream_t stream) {
  const int dp = padded_dim(dim);
  const uint64_t row_bytes = (uint64_t)dp * 2 * sizeof(uint16_t);
  CUtensorMap q_map, c_map;
  int rc = tensor_map_bf16(&q_map, split, m, 2 * (uint64_t)dp, row_bytes,
                           p.bm);
  if (rc == 0)
    rc = tensor_map_bf16(&c_map, split + (size_t)m * 2 * dp, n,
                         2 * (uint64_t)dp, row_bytes, p.bn);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (e != cudaSuccess) return (int)e;
  matmul_wgmma_kernel<<<p.blocks, kWgThreads, p.smem, stream>>>(
      q_map, c_map, out, m, n, dp, n % 2 == 0 && aligned(out, 8));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch kernel C makes for (m, n, dim) in `core` (make_plan), into
// plan[0..6]: q rows a tile, c rows a tile, the body (0 the f32 ring, 1
// TMA + wgmma on split operands, 2 mma.sync splitting as it stages), the
// group of q tiles, ring stages, blocks, dynamic shared memory bytes.
// Returns 0, or -1 for arguments the kernel does not take.
int pmm_matmul_plan(int m, int n, int dim, int core, int* plan) {
  Plan p;
  if (!make_plan(m, n, dim, core, p)) return -1;
  const int v[7] = {p.bm, p.bn, p.body, p.group, p.stages, p.blocks, p.smem};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return 0;
}

// out (m, n) f32 = q (m, dim) f32 . c (n, dim)^T f32, all row-major and
// dense, on `stream`: the "highest" core.  Returns 0 on success, a
// cudaError_t after a refused launch, or -1 for arguments the kernel does
// not take.
int pmm_matmul_highest(const float* q, const float* c, float* out, int m,
                       int n, int dim, void* stream) {
  Plan p;
  if (!make_plan(m, n, dim, kHighest, p)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.bm) {
    case 32: return launch_f32<2>(q, c, out, m, n, dim, p.blocks, s);
    case 64: return launch_f32<4>(q, c, out, m, n, dim, p.blocks, s);
    default: return launch_f32<8>(q, c, out, m, n, dim, p.blocks, s);
  }
}

// The split operands of the "bf16x3" core's wgmma body: out is (m + n,
// 2 dp) bf16, dp = dim rounded up to a multiple of 64; rows [0, m) hold
// q's [hi | lo], [m, m + n) c's, zero past dim.  Returns as
// pmm_matmul_highest.
int pmm_split_pad(const float* q, const float* c, uint16_t* out, int m,
                  int n, int dim, void* stream) {
  if (m <= 0 || n <= 0 || dim <= 0 || (long long)m + n > INT_MAX) return -1;
  const int dp = padded_dim(dim);
  const bool vec = dim % 4 == 0 && aligned(q, 16) && aligned(c, 16);
  const long long items = ((long long)m + n) * (dp / 4);
  const int sms = device_sms();
  if (sms <= 0) return -1;
  const long long want = (items + 255) / 256;
  const int blocks = want < 16LL * sms ? (int)want : 16 * sms;
  split_pad_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      q, c, out, m, n, dim, dp, vec);
  return (int)cudaGetLastError();
}

// out (m, n) f32, the "bf16x3" core, in the body of the plan: the mma
// body reads q and c; the wgmma body reads split, pmm_split_pad's buffer
// of the same (m, n, dim), 16-byte aligned.  Returns as
// pmm_matmul_highest.
int pmm_matmul_bf16x3(const float* q, const float* c, const uint16_t* split,
                      float* out, int m, int n, int dim, void* stream) {
  Plan p;
  if (!make_plan(m, n, dim, kBf16x3, p)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.body == kWgmma)
    return split != nullptr && aligned(split, 16)
               ? launch_wgmma(split, out, m, n, dim, p, s) : -1;
  const bool vec = dim % 4 == 0 && aligned(q, 16) && aligned(c, 16);
  matmul_mma_kernel<<<dim3(p.blocks, cdiv(m, kMmBM)), kMmThreads, 0, s>>>(
      q, c, out, m, n, dim, vec, n % 2 == 0 && aligned(out, 8));
  return (int)cudaGetLastError();
}

}  // extern "C"
