// Staging and score tiles shared by kernel A (fused_topk.cu) and kernel D
// (floor.cu): one TM x kTN tile of epilogue scores, Q.C^T in one of the
// tensor-core cores, computed into shared memory.  Kernel D measures what
// kernel A's staging and products cost without its selection, so both
// include these very functions; only kernel D instantiates the two decodes
// of the int4 experiment (kInt4Rint, kInt4Raw).
//
// The cores ("bf16x3" three bf16 products of [hi | lo] halves, streamed
// through the ring below by kernels A and D; scores_bf16x3, the per-tile
// staging it replaced, stays as the reference chip_smoke.py holds the ring
// to; "bf16c", "int8c", "int4c" a stored corpus whose raw
// bytes stream through a ring across tiles and become bf16 as they are
// read out, two products qh.c + ql.c; "highest" the f32 corpus through the
// same ring, kernel A only) and the int4 layout are described at the top
// of fused_topk.cu; the ring below.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTN = 64;         // corpus rows per tile (8 per warp in mma)
constexpr int kBK = 32;         // features per shared-memory chunk
constexpr int kBKP = kBK + 8;   // bf16 row stride: conflict-free fragments
constexpr size_t kMaxSmem = 232448;     // a block's dynamic shared memory
constexpr size_t kSmemPerSm = 233472;   // an SM's (228 KB)
constexpr size_t kSmemPerBlock = 1024;  // reserved by each resident block

// The cores, in the order of kernels/fused_topk.py's CORES, then the two
// decodes of the int4 experiment (kernels/floor.py's CORES): "int4-rint"
// reads bytes b = 16 hi + lo and decodes them in float, "int4-raw" feeds
// each byte as it is to both nibble positions (wrong on purpose: a free
// unpack).  Both keep the int4c layout.  kBf16x3W is kernel A's bf16x3 with
// 64 features a ring position (fused_topk.cu's ring_core picks it).
enum Core : int { kHighest = 0, kBf16x3 = 1, kBf16c = 2, kInt8c = 3,
                  kInt4c = 4, kInt4Rint = 5, kInt4Raw = 6, kBf16x3W = 7 };

// Cores whose corpus rows are the bf16 [hi | lo] halves: bf16x3's.
__host__ __device__ constexpr bool hilo_core(int core) {
  return core == kBf16x3 || core == kBf16x3W;
}

// Cores whose bytes hold two features each (the int4c layout).
__host__ __device__ constexpr bool packed_core(int core) {
  return core == kInt4c || core == kInt4Rint || core == kInt4Raw;
}

// Cores whose corpus streams through the ring (stored as it is read).
__host__ __device__ constexpr bool stored_core(int core) {
  return core != kHighest && !hilo_core(core);
}

// Bytes of one element of a bf16-or-byte ring core's corpus row (the unit
// of c_ld): bf16 for bf16c and bf16x3's [hi | lo], one for the int8 forms.
__host__ __device__ constexpr int ring_elem_bytes(int core) {
  return core == kBf16c || hilo_core(core) ? 2 : 1;
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Shared memory of the per-tile bf16x3 operand tiles of scores_bf16x3 (the
// ring's cores': ring_bytes).
__host__ __device__ inline size_t operand_bytes(int tm, int core) {
  return 2 * (size_t)(tm + kTN) * kBKP * sizeof(uint16_t);  // hi, lo
}

// The gate of a walk's selection.  A walk asks it whether a score of query
// row r could enter the row's carry (vote; St is the walk's score tiles,
// which the carry follows in shared memory), and takes the barrier before
// the selection through it (fire): false skips the selection of the tile
// (of the step, on ring_wgmma.cuh's walk).  NoGate, kernel D's, votes
// nothing and fires on a plain barrier, so a walk without a gate keeps its
// code; kernel A's gate is CarryGate (fused_topk.cu).
struct NoGate {
  static constexpr bool kGated = false;
  __device__ bool vote(const float*, int, float) const { return false; }
  __device__ bool fire(bool, int) const {
    __syncthreads();
    return true;
  }
};

// Epilogue for one score: scale row (int8c / int4c: scale != null) and
// bias row, then the mask by select (a NaN dot product on a masked row
// must not reach the selection), -inf past the corpus end.  The product
// and the sum round apart, as in the plain version; a dead row's -inf
// bias meets a finite d * scale.
__device__ inline float epilogue(float d, int gn, int n,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ cb,
                                 const uint8_t* __restrict__ mask) {
  if (gn >= n) return -INFINITY;
  const float p = scale != nullptr ? __fmul_rn(d, scale[gn]) : d;
  const float s = __fadd_rn(p, cb[gn]);
  return (mask != nullptr && mask[gn] == 0) ? -INFINITY : s;
}

__device__ inline void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                uint32_t a2, uint32_t a3, uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ inline uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [r0, r0 + rows) x features [k0, k0 + BK) of a bf16 [hi | lo]
// operand into shared memory (row stride BK + 8), zero past the row count
// and the dim.  The element-wise form takes any dim; the vector form
// moves 8 bf16 (16 bytes) per load and needs dim % 8 == 0 and 16-byte
// aligned operands.
template <int BK = kBK>
__device__ inline void load_tile(const uint16_t* __restrict__ src,
                                 uint16_t* hi, uint16_t* lo, int r0,
                                 int r_end, int k0, int dim, size_t ld,
                                 int rows) {
  for (int e = threadIdx.x; e < rows * BK; e += kThreads) {
    const int r = e / BK, kk = e % BK;
    const int gr = r0 + r, gk = k0 + kk;
    uint16_t h = 0, l = 0;
    if (gr < r_end && gk < dim) {
      h = src[gr * ld + gk];
      l = src[gr * ld + dim + gk];
    }
    hi[r * (BK + 8) + kk] = h;
    lo[r * (BK + 8) + kk] = l;
  }
}

template <int BK = kBK>
__device__ inline void load_tile_vec(const uint16_t* __restrict__ src,
                                     uint16_t* hi, uint16_t* lo, int r0,
                                     int r_end, int k0, int dim, size_t ld,
                                     int rows) {
  constexpr int kV = BK / 8;   // 16-byte vectors per row chunk
  for (int e = threadIdx.x; e < rows * kV; e += kThreads) {
    const int r = e / kV, kk = (e % kV) * 8;
    const int gr = r0 + r, gk = k0 + kk;
    uint4 h = make_uint4(0, 0, 0, 0), l = h;
    if (gr < r_end && gk < dim) {
      h = *reinterpret_cast<const uint4*>(src + gr * ld + gk);
      l = *reinterpret_cast<const uint4*>(src + gr * ld + dim + gk);
    }
    *reinterpret_cast<uint4*>(hi + r * (BK + 8) + kk) = h;
    *reinterpret_cast<uint4*>(lo + r * (BK + 8) + kk) = l;
  }
}

// Score tile of the bf16x3 core into St (epilogue applied), staged per
// tile: the reference of chip_smoke.py (no kernel instantiates it).  The
// ring (ring_products) keeps its k slots and its order of products, so
// both give the same scores bit for bit.
template <int TM>
__device__ inline void scores_bf16x3(const uint16_t* __restrict__ q,
                                     const uint16_t* __restrict__ c,
                                     const float* __restrict__ cb,
                                     const uint8_t* __restrict__ mask,
                                     uint16_t* Qh, uint16_t* Ql,
                                     uint16_t* Ch, uint16_t* Cl, float* St,
                                     int row0, int n0, int m, int n,
                                     int dim, bool vec) {
  constexpr int MT = TM / 16;   // m16 tiles per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const size_t ld = 2 * (size_t)dim;   // [hi | lo] row stride
  float acc1[MT][4], acc2[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) { acc1[t][j] = 0.f; acc2[t][j] = 0.f; }

  for (int k0 = 0; k0 < dim; k0 += kBK) {
    if (vec) {
      load_tile_vec(q, Qh, Ql, row0, m, k0, dim, ld, TM);
      load_tile_vec(c, Ch, Cl, n0, n, k0, dim, ld, kTN);
    } else {
      load_tile(q, Qh, Ql, row0, m, k0, dim, ld, TM);
      load_tile(c, Ch, Cl, n0, n, k0, dim, ld, kTN);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      const int bo = (8 * warp + g) * kBKP + ks + 2 * tig;
      const uint32_t bh0 = ld32(Ch + bo), bh1 = ld32(Ch + bo + 8);
      const uint32_t bl0 = ld32(Cl + bo), bl1 = ld32(Cl + bo + 8);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int ao = (16 * t + g) * kBKP + ks + 2 * tig;
        const uint32_t ah0 = ld32(Qh + ao), ah1 = ld32(Qh + ao + 8 * kBKP);
        const uint32_t ah2 = ld32(Qh + ao + 8);
        const uint32_t ah3 = ld32(Qh + ao + 8 * kBKP + 8);
        const uint32_t al0 = ld32(Ql + ao), al1 = ld32(Ql + ao + 8 * kBKP);
        const uint32_t al2 = ld32(Ql + ao + 8);
        const uint32_t al3 = ld32(Ql + ao + 8 * kBKP + 8);
        mma_bf16(acc1[t], ah0, ah1, ah2, ah3, bh0, bh1);
        mma_bf16(acc2[t], ah0, ah1, ah2, ah3, bl0, bl1);
        mma_bf16(acc2[t], al0, al1, al2, al3, bh0, bh1);
      }
    }
    __syncthreads();
  }
  // Accumulator layout: d0, d1 at (row g, cols 2 tig, 2 tig + 1), d2, d3
  // at row g + 8.
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 16 * t + g + (j >= 2 ? 8 : 0);
      const int col = 8 * warp + 2 * tig + (j & 1);
      St[r * (kTN + 1) + col] =
          epilogue(acc1[t][j] + acc2[t][j], n0 + col, n, nullptr, cb, mask);
    }
}

// ---------------------------------------------------------------------------
// The stored cores (bf16c, int8c, the int4 family): a ring of raw bytes.
//
// A block walks the (tile, k-chunk) positions of its whole split.  Each
// position's corpus bytes, 64 rows x ring_row_bytes as they are stored (2
// bytes a feature for bf16c, 1 for int8, half for int4: each packed byte
// is copied once), go by 16-byte cp.async copies into one stage of a ring
// in shared memory, as many positions ahead of the products as the ring
// has stages less one, and straight across tile boundaries: while the
// block selects on tile t, the first chunks of tile t + 1 are in flight.
// Bytes become bf16 only as they are read out of the ring, straight into
// the mma B fragments (warp w reads corpus rows 8w .. 8w + 7, so each byte
// is decoded once a block), by bit operations that are exact for these
// small integers.
//
// bf16x3 streams the prepared [hi | lo] rows as they are: a position's hi
// piece and lo piece of the same features go into one stage, each row's
// hi bytes then its lo bytes, and nothing is decoded.  Its products are
// the per-tile core's (scores_bf16x3): per k16, qh.ch into acc1, then
// qh.cl and ql.ch into acc2, with that core's k slots, so its scores are
// that core's bit for bit; its fragments come by ldmatrix, 16 bytes of 8
// rows at a time, so its rows are an odd number of 16-byte units apart.
//
// The query tile is staged once, before the walk, where it fits beside the
// ring (batch 8 at dim 768: 48 KB); otherwise the query columns that meet
// a stage's bytes ride in that stage.  ring_plan picks the stages and the
// query's place for each launch.
//
// k order.  The 16 k slots of an m16n8k16 product may hold any 16 features
// as long as the A and B fragments agree, and the products of small
// integers are exact in any order.  A thread's B slots (2 tig, 2 tig + 1)
// and (2 tig + 8, 2 tig + 9) hold four consecutive stored features, one
// 8-byte (bf16c) or 4-byte (int8) load; for int4, one 4-byte load holds
// two k16 products' slots: bytes (4 tig, 4 tig + 1), then (4 tig + 2,
// 4 tig + 3), each pair's low nibbles in the first slot pair and its high
// nibbles in the second.  The query columns follow the ring's order: the
// features in order for bf16c and int8; for int4, each 16 stored bytes
// meet 32 columns, their 16 low-nibble features then their 16 high ones.
// ---------------------------------------------------------------------------

// Corpus bytes a row that one stage holds, and the most stages, for query
// tile TM (chosen by measurement on the H100: PERF.md).  A 16-row query
// tile is mostly resident, so its stages hold corpus bytes alone (256 a
// row; int4 128); taller tiles carry their query columns too (64 or 32 of
// them, hi and lo), so two blocks an SM still fit beside the carry at
// k = 100.  ring_plan takes as many stages as keep two blocks an SM.
// bf16x3 holds 32 features a row (4 bytes a feature, hi and lo), kBf16x3W
// 64, in up to four stages.
// The f32 core (kernel A's f32_plan) holds 32 features a row at query
// tile 64, 16 at 32, 8 at 16 (whose stages hold 256 corpus rows): two
// blocks an SM fit beside the carry up to k = 113, 256 and 635.
__host__ __device__ constexpr int ring_row_bytes(int tm, int core) {
  return core == kHighest ? 2 * tm
       : hilo_core(core) ? (core == kBf16x3W ? 256 : 128)
       : tm == 16 ? (packed_core(core) ? 128 : 256)
       : (core == kBf16c ? 4 : packed_core(core) ? 1 : 2) * (tm == 32 ? 32
                                                                       : 16);
}
__host__ __device__ constexpr int ring_stages(int tm, int core) {
  return hilo_core(core) || tm == 16 ? 4 : tm == 32 ? 3 : 2;
}

// A row stride of an odd number of `unit`s: the 8 rows a 4-byte fragment
// load reads (16-byte units) or the 4 rows each half-warp of an 8-byte one
// reads (32-byte units) fall on distinct banks.  bf16c's fragments are
// 8-byte loads, int8's 4-byte ones, bf16x3's ldmatrix rows of 16 bytes
// (8 rows a phase: 16-byte units).
__host__ __device__ constexpr int odd_units(int bytes, int unit) {
  return (bytes / unit) % 2 ? bytes : bytes + unit;
}

// Byte stride of a stage's corpus rows.
__host__ __device__ constexpr int ring_row_stride(int tm, int core) {
  return odd_units(ring_row_bytes(tm, core), core == kBf16c ? 32 : 16);
}

// Query columns that one stage's corpus bytes meet.
__host__ __device__ constexpr int ring_cols(int tm, int core) {
  return core == kHighest || hilo_core(core) ? ring_row_bytes(tm, core) / 4
       : core == kBf16c ? ring_row_bytes(tm, core) / 2
       : packed_core(core) ? 2 * ring_row_bytes(tm, core)
                           : ring_row_bytes(tm, core);
}

// bf16 stride of query rows of `cols` columns: an odd number of 32-byte
// units for the 8-byte fragment loads, of 16-byte units for bf16x3's
// ldmatrix rows.
__host__ __device__ constexpr int query_stride(int cols, int core) {
  return odd_units(2 * cols, hilo_core(core) ? 16 : 32) / 2;
}

// Ring positions (chunks) a corpus row of row_bytes takes.
__host__ __device__ inline int ring_chunks(int tm, int core, int row_bytes) {
  return (row_bytes + ring_row_bytes(tm, core) - 1) / ring_row_bytes(tm, core);
}

// Bytes of one stage: the corpus rows, and the query columns (hi, lo) when
// the query is not resident.
__host__ __device__ inline size_t ring_stage_bytes(int tm, int core,
                                                   bool q_resident) {
  return (size_t)kTN * ring_row_stride(tm, core)
       + (q_resident
              ? 0
              : 4 * (size_t)tm * query_stride(ring_cols(tm, core), core));
}

// Shared memory of the staging: the ring of `stages`, then the resident
// query tile.
__host__ __device__ inline size_t ring_bytes(int tm, int core, int chunks,
                                             bool q_resident, int stages) {
  return stages * ring_stage_bytes(tm, core, q_resident)
       + (q_resident
              ? 4 * (size_t)tm *
                    query_stride(chunks * ring_cols(tm, core), core)
              : 0);
}

inline int smem_blocks(size_t bytes) {
  return (int)(kSmemPerSm / (bytes + kSmemPerBlock));
}

// A ring: its stages (0 where none fits), whether the query tile is
// resident, and the kernel's shared memory.
struct RingPlan {
  int stages;
  bool q_resident;
  size_t bytes;
};

// The ring beside `rest` bytes of the kernel's other shared memory: two
// blocks an SM where any plan keeps them, then the most stages, then the
// query tile resident where it fits.  A 64-row query tile always rides
// the ring (resident, its stages' few corpus bytes a row would make every
// position mostly overhead), so its products know the query's stride.
inline RingPlan ring_plan(int tm, int core, int chunks, size_t rest) {
  RingPlan best{0, false, 0};
  int best_key = -1;
  for (int res = tm == 64 ? 0 : 1; res >= 0; --res)
    for (int s = ring_stages(tm, core); s >= 2; --s) {
      const size_t b = ring_bytes(tm, core, chunks, res != 0, s) + rest;
      if (b > kMaxSmem) continue;
      const int blocks = smem_blocks(b) < 2 ? smem_blocks(b) : 2;
      const int key = 100 * blocks + 10 * s + res;
      if (key > best_key) {
        best_key = key;
        best = RingPlan{s, res != 0, b};
      }
    }
  return best;
}

// The cp.async copies need 16-byte aligned operands and rows (and whole
// 8-feature query pieces); anything else stages byte by byte.
inline bool ring_aligned(const void* qp, const void* cp, int dim,
                         size_t row_bytes) {
  return dim % 8 == 0 && row_bytes % 16 == 0 && aligned(qp, 16) &&
         aligned(cp, 16);
}

__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(bytes) : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// At most n groups still in flight (n < ring_stages - 1).
__device__ inline void cp_async_wait_for(int n) {
  if (n >= 2)
    cp_async_wait<2>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes); matrix i lands in ri as an mma
// fragment (thread t: row t / 4, elements 2 (t % 4) and 2 (t % 4) + 1).
__device__ inline void ldsm_x4(const void* p, uint32_t& r0, uint32_t& r1,
                               uint32_t& r2, uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

__device__ inline uint2 lds64(const uint16_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ inline uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16x2 of x - c, exact here.
__device__ inline uint32_t bf16x2_sub(uint32_t x, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(c), "r"(0xBF80BF80u), "r"(x));   // c * -1 + x
  return d;
}

// The signed bytes b0, b1 in the low bytes of the 16-bit halves of s, as
// bf16x2: bits 0x4300 | (b & 127) are 128 + (b & 127), less 128 or, with
// the sign bit, 256.
__device__ inline uint32_t i8_bf16x2(uint32_t s) {
  return bf16x2_sub((s & 0x007F007Fu) | 0x43004300u,
                    (s & 0x00800080u) | 0x43004300u);
}

// The four signed bytes of w as bf16x2 pairs: (byte 0, 1) and (2, 3).
__device__ inline void i8x4_bf16(uint32_t w, uint32_t& b01, uint32_t& b23) {
  b01 = i8_bf16x2(__byte_perm(w, 0, 0x4140));
  b23 = i8_bf16x2(__byte_perm(w, 0, 0x4342));
}

// The four signed bytes of w as floats: 2^23 + (v + 128) built in the
// bits, less 2^23 + 128.
__device__ inline void i8x4_float(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// The low nibble of each 16-bit half of x, signed, as bf16x2: bits 0x4300
// | (v + 8) are 136 + v, less 136.
__device__ inline uint32_t nibbles_bf16x2(uint32_t x) {
  return bf16x2_sub((x & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
}

// B fragments of the int4 family from four stored bytes: (lo_a, hi_a) the
// low and high positions of bytes 0 and 1, (lo_b, hi_b) of bytes 2 and 3.
template <int CORE>
__device__ inline void decode_packed(uint32_t w, uint32_t& lo_a,
                                     uint32_t& hi_a, uint32_t& lo_b,
                                     uint32_t& hi_b) {
  if constexpr (CORE == kInt4c) {
    const uint32_t p01 = __byte_perm(w, 0, 0x4140);   // bytes 0, 1 apart
    const uint32_t p23 = __byte_perm(w, 0, 0x4342);
    lo_a = nibbles_bf16x2(p01);
    hi_a = nibbles_bf16x2(p01 >> 4);
    lo_b = nibbles_bf16x2(p23);
    hi_b = nibbles_bf16x2(p23 >> 4);
  } else if constexpr (CORE == kInt4Raw) {   // the byte in both places
    i8x4_bf16(w, lo_a, lo_b);
    hi_a = lo_a;
    hi_b = lo_b;
  } else {   // kInt4Rint: b = 16 hi + lo, hi = rint(b / 16), both exact
    float f[4], hi[4], lo[4];
    i8x4_float(w, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = rintf(f[i] * 0.0625f);
      lo[i] = f[i] - 16.f * hi[i];
    }
    lo_a = bf16x2(lo[0], lo[1]);
    hi_a = bf16x2(hi[0], hi[1]);
    lo_b = bf16x2(lo[2], lo[3]);
    hi_b = bf16x2(hi[2], hi[3]);
  }
}

// The feature that query column `col` of chunk kc holds (8 columns from a
// multiple of 8 hold 8 consecutive features).  int4 layout (quantize_int4):
// in each ck-wide feature chunk, byte j holds feature j low and j + ck/2
// high; inv_half = 1 / (ck / 2) finds a byte's chunk without an integer
// division (the producer runs it while the products' sums are live).
template <int TM, int CORE>
__device__ inline int ring_feature(int kc, int col, int ck, float inv_half) {
  if constexpr (packed_core(CORE)) {
    const int b = kc * ring_row_bytes(TM, CORE) + (col / 32) * 16;
    const int half = ck / 2, w = col % 32;
    int t = __float2int_rz(__int2float_rn(b) * inv_half);   // b / half +- 1
    t += (t + 1) * half <= b ? 1 : 0;
    t -= t * half > b ? 1 : 0;
    return t * ck + (b - t * half) + (w >= 16 ? half + w - 16 : w);
  } else {
    return kc * ring_cols(TM, CORE) + col;
  }
}

// Stage corpus rows [n0, n0 + 64), bytes [b0, b0 + ring_row_bytes) of
// each, zero past row n and past row_bytes.  vec: 16-byte cp.async copies;
// otherwise byte by byte, loaded and stored here.  bf16x3: the position's
// features come from both halves of the [hi | lo] row, bytes [b0 / 2,
// b0 / 2 + RB / 2) of each half, hi first, zero past the half's end.
template <int TM, int CORE>
__device__ inline void ring_corpus(unsigned char* dst,
                                   const unsigned char* __restrict__ c,
                                   size_t ld, int row_bytes, int n0, int n,
                                   int b0, bool vec) {
  constexpr int RB = ring_row_bytes(TM, CORE);
  constexpr int RS = ring_row_stride(TM, CORE);
  if constexpr (hilo_core(CORE)) {
    constexpr int kHalf = RB / 2;          // a piece's bytes
    const int half = row_bytes / 2, f0 = b0 / 2;
    if (vec) {
      constexpr int kV = RB / 16;
      for (int e = threadIdx.x; e < kTN * kV; e += kThreads) {
        const int r = e / kV, o = (e % kV) * 16;
        const int gr = n0 + r, fo = f0 + o % kHalf;
        const bool in = gr < n && fo < half;   // whole 8-feature pieces
        cp_async16(dst + r * RS + o,
                   in ? c + (size_t)gr * ld + (o < kHalf ? 0 : half) + fo : c,
                   in ? 16 : 0);
      }
      return;
    }
    for (int e = threadIdx.x; e < kTN * RB; e += kThreads) {
      const int r = e / RB, o = e % RB;
      const int gr = n0 + r, fo = f0 + o % kHalf;
      dst[r * RS + o] = gr < n && fo < half
          ? c[(size_t)gr * ld + (o < kHalf ? 0 : half) + fo] : 0;
    }
    return;
  }
  if (vec) {
    constexpr int kV = RB / 16;
    for (int e = threadIdx.x; e < kTN * kV; e += kThreads) {
      const int r = e / kV, o = (e % kV) * 16;
      const int gr = n0 + r, b = b0 + o;
      const bool in = gr < n && b < row_bytes;   // whole 16-byte pieces
      cp_async16(dst + r * RS + o, in ? c + (size_t)gr * ld + b : c,
                 in ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTN * RB; e += kThreads) {
    const int r = e / RB, o = e % RB;
    const int gr = n0 + r, b = b0 + o;
    dst[r * RS + o] = gr < n && b < row_bytes ? c[(size_t)gr * ld + b] : 0;
  }
}

// Stage the query columns of chunk kc of rows [row0, row0 + TM) into Qh /
// Ql (row stride qs, from column 0), zero past row m and feature dim.
template <int TM, int CORE>
__device__ inline void ring_query(uint16_t* Qh, uint16_t* Ql, int qs,
                                  const uint16_t* __restrict__ q, int row0,
                                  int m, int dim, int ck, float inv_half,
                                  int kc, bool vec) {
  constexpr int QC = ring_cols(TM, CORE);
  const size_t ld = 2 * (size_t)dim;   // [hi | lo] row stride
  if (vec) {
    constexpr int kP = QC / 8;   // 8-column pieces a row
    for (int e = threadIdx.x; e < TM * kP; e += kThreads) {
      const int r = e / kP, col = (e % kP) * 8;
      const int f = ring_feature<TM, CORE>(kc, col, ck, inv_half);
      const int gr = row0 + r;
      const bool in = gr < m && f < dim;   // whole 8-feature pieces
      const uint16_t* src = in ? q + gr * ld + f : q;
      cp_async16(Qh + r * qs + col, src, in ? 16 : 0);
      cp_async16(Ql + r * qs + col, in ? src + dim : q, in ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < TM * QC; e += kThreads) {
    const int r = e / QC, col = e % QC;
    const int f = ring_feature<TM, CORE>(kc, col, ck, inv_half);
    const int gr = row0 + r;
    const bool in = gr < m && f < dim;
    Qh[r * qs + col] = in ? q[gr * ld + f] : (uint16_t)0;
    Ql[r * qs + col] = in ? q[gr * ld + dim + f] : (uint16_t)0;
  }
}

// The products of one stage: qh.c into acc1, ql.c into acc2.  Qh / Ql
// point at the stage's first query column, row stride QS where it is known
// at compile time (nonzero), else qs_rt.
template <int TM, int CORE, int QS>
__device__ inline void ring_products(const unsigned char* cs,
                                     const uint16_t* Qh, const uint16_t* Ql,
                                     int qs_rt, float (&acc1)[TM / 16][4],
                                     float (&acc2)[TM / 16][4]) {
  constexpr int MT = TM / 16;   // m16 tiles per warp
  constexpr int RB = ring_row_bytes(TM, CORE);
  constexpr int RS = ring_row_stride(TM, CORE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const unsigned char* row = cs + (8 * warp + g) * RS
                           + 4 * tig * (CORE == kBf16c ? 2 : 1);
  const int qs = QS ? QS : qs_rt;
  const uint16_t* qh = Qh + g * qs + 4 * tig;
  const uint16_t* ql = Ql + g * qs + 4 * tig;
  // A taller query tile has MT independent products a step already; its
  // steps unrolled in full would hold every step's A fragments at once.
  constexpr int kUnroll = MT == 1 ? 8 : MT == 2 ? 2 : 1;
  if constexpr (hilo_core(CORE)) {
    // scores_bf16x3's k slots: (2 tig, 2 tig + 1) and (2 tig + 8, 2 tig + 9)
    // hold those features of the k16, and its products in its order.  Each
    // fragment comes from ldmatrix: lane l names row l % 8 (A: l % 16) of
    // one 8 x 8 matrix, 16 bytes; B's four are ch and cl at k 0-7 and 8-15.
    const unsigned char* bp = cs + (8 * warp + (lane & 7)) * RS
                            + ((lane >> 3) & 1) * 16 + (lane >> 4) * (RB / 2);
    const int ao = (lane & 15) * qs + (lane >> 4) * 8;
#pragma unroll kUnroll
    for (int s = 0; s < RB / 64; ++s) {   // 32 bytes of hi, 32 of lo
      uint32_t bh0, bh1, bl0, bl1;
      ldsm_x4(bp + 32 * s, bh0, bh1, bl0, bl1);
      // qh's fragments, then ql's: each accumulator still takes qh.cl
      // before ql.ch, and one tile's fragments are live at a time.
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        uint32_t a0, a1, a2, a3;
        ldsm_x4(Qh + 16 * t * qs + 16 * s + ao, a0, a1, a2, a3);
        mma_bf16(acc1[t], a0, a1, a2, a3, bh0, bh1);
        mma_bf16(acc2[t], a0, a1, a2, a3, bl0, bl1);
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        uint32_t a0, a1, a2, a3;
        ldsm_x4(Ql + 16 * t * qs + 16 * s + ao, a0, a1, a2, a3);
        mma_bf16(acc2[t], a0, a1, a2, a3, bh0, bh1);
      }
    }
  } else if constexpr (packed_core(CORE)) {
#pragma unroll kUnroll
    for (int s = 0; s < RB / 16; ++s) {   // 16 bytes: 32 columns
      uint32_t lo_a, hi_a, lo_b, hi_b;
      decode_packed<CORE>(*reinterpret_cast<const uint32_t*>(row + 16 * s),
                          lo_a, hi_a, lo_b, hi_b);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int o = 16 * t * qs + 32 * s;
        uint2 l0 = lds64(qh + o), l1 = lds64(qh + o + 8 * qs);
        uint2 h0 = lds64(qh + o + 16), h1 = lds64(qh + o + 8 * qs + 16);
        mma_bf16(acc1[t], l0.x, l1.x, h0.x, h1.x, lo_a, hi_a);
        mma_bf16(acc1[t], l0.y, l1.y, h0.y, h1.y, lo_b, hi_b);
        l0 = lds64(ql + o), l1 = lds64(ql + o + 8 * qs);
        h0 = lds64(ql + o + 16), h1 = lds64(ql + o + 8 * qs + 16);
        mma_bf16(acc2[t], l0.x, l1.x, h0.x, h1.x, lo_a, hi_a);
        mma_bf16(acc2[t], l0.y, l1.y, h0.y, h1.y, lo_b, hi_b);
      }
    }
  } else {
    constexpr int kStep = CORE == kBf16c ? 32 : 16;   // bytes a k16 product
#pragma unroll kUnroll
    for (int s = 0; s < RB / kStep; ++s) {
      uint32_t b0, b1;
      if constexpr (CORE == kBf16c) {
        const uint2 w = *reinterpret_cast<const uint2*>(row + kStep * s);
        b0 = w.x;
        b1 = w.y;
      } else {
        i8x4_bf16(*reinterpret_cast<const uint32_t*>(row + kStep * s), b0,
                  b1);
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int o = 16 * t * qs + 16 * s;
        const uint2 h0 = lds64(qh + o), h1 = lds64(qh + o + 8 * qs);
        mma_bf16(acc1[t], h0.x, h1.x, h0.y, h1.y, b0, b1);
        const uint2 l0 = lds64(ql + o), l1 = lds64(ql + o + 8 * qs);
        mma_bf16(acc2[t], l0.x, l1.x, l0.y, l1.y, b0, b1);
      }
    }
  }
}

// Walk tiles [t_begin, t_end) of a stored core through the ring: each
// tile's epilogue scores go to St (TM x (kTN + 1)), then, after a barrier,
// on_tile(t, n0) runs (n0 the tile's first corpus row); the next tile's
// scores wait for a barrier after it.  Listed (LISTED): tile t is kernel
// tile list[t / tn_tiles] * tn_tiles + t % tn_tiles, an id outside the
// layout_tiles naming no rows (never read).  c_ld is the corpus row stride
// in elements (bf16c, bf16x3) or bytes; ck the int4 feature chunk; stages
// and q_resident the host's ring_plan.  `gate` (NoGate: none) votes on each
// score as it is written and may skip on_tile at the barrier.  Ends after
// a barrier with no copy in flight.
template <int TM, int CORE, bool LISTED, typename OnTile,
          typename Gate = NoGate>
__device__ inline void ring_walk(const uint16_t* __restrict__ q,
                                 const void* __restrict__ cp,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ cb,
                                 const uint8_t* __restrict__ mask,
                                 const int* __restrict__ list,
                                 int layout_tiles, int tn_tiles,
                                 unsigned char* smem, float* St, int row0,
                                 int m, int n, int dim, int c_ld, int ck,
                                 int t_begin, int t_end, int stages,
                                 bool q_resident, bool vec,
                                 OnTile&& on_tile,
                                 const Gate& gate = Gate{}) {
  constexpr int RB = ring_row_bytes(TM, CORE);
  constexpr int RS = ring_row_stride(TM, CORE), QC = ring_cols(TM, CORE);
  constexpr int MT = TM / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const unsigned char* c = static_cast<const unsigned char*>(cp);
  const size_t ld = (size_t)c_ld * ring_elem_bytes(CORE);
  const int row_bytes = (int)ld, chunks = ring_chunks(TM, CORE, row_bytes);
  // ring_plan never keeps a 64-row query tile resident; the bf16x3 walk
  // needs the registers that knowing so at compile time frees (ptxas spilled
  // without it; the stored cores' tile-64 ring walks keep their code).
  if constexpr (hilo_core(CORE) && TM == 64) q_resident = false;
  const int qs = query_stride(q_resident ? chunks * QC : QC, CORE);
  const size_t stage = ring_stage_bytes(TM, CORE, q_resident);
  uint16_t* Qr = reinterpret_cast<uint16_t*>(smem + stages * stage);
  const float inv_half = packed_core(CORE) ? 1.f / (ck / 2) : 0.f;
  // The first corpus row of tile t (list entry t / tn_tiles, tile t %
  // tn_tiles of it when listed), or -1 where its listed id names no rows.
  auto first_row = [&](int t, int entry, int sub) -> int {
    if constexpr (LISTED) {
      const int lt = list[entry];
      if (lt < 0 || lt >= layout_tiles) return -1;
      return (lt * tn_tiles + sub) * kTN;
    }
    return t * kTN;
  };
  // The producer: the next position's tile (its list entry and tile in
  // it, kept without divisions) and chunk, into stage `to`.
  int it = t_begin, ikc = 0;
  int ie = LISTED ? t_begin / tn_tiles : 0;
  int isub = LISTED ? t_begin - ie * tn_tiles : 0;
  auto produce = [&](int to) {
    const int n0 = it < t_end ? first_row(it, ie, isub) : -1;
    if (n0 >= 0) {
      unsigned char* st = smem + to * stage;
      ring_corpus<TM, CORE>(st, c, ld, row_bytes, n0, n, ikc * RB, vec);
      if (!q_resident) {
        uint16_t* qh = reinterpret_cast<uint16_t*>(st + kTN * RS);
        ring_query<TM, CORE>(qh, qh + TM * qs, qs, q, row0, m, dim, ck,
                             inv_half, ikc, vec);
      }
    }
    cp_async_commit();   // one group a position, empty or not
    if (++ikc == chunks) {
      ikc = 0;
      ++it;
      if (LISTED && ++isub == tn_tiles) {
        isub = 0;
        ++ie;
      }
    }
  };
  if (q_resident)   // joins position 0's group
    for (int kc = 0; kc < chunks; ++kc)
      ring_query<TM, CORE>(Qr + kc * QC, Qr + TM * qs + kc * QC, qs, q, row0,
                           m, dim, ck, inv_half, kc, vec);
  for (int i = 0; i < stages - 1; ++i) produce(i);

  int st = 0;   // the consumer's stage
  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = LISTED ? first_row(t, t / tn_tiles, t % tn_tiles)
                          : first_row(t, 0, 0);
    float acc1[MT][4], acc2[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) { acc1[i][j] = 0.f; acc2[i][j] = 0.f; }
    for (int kc = 0; kc < chunks; ++kc) {
      cp_async_wait_for(stages - 2);   // this position's copies landed
      __syncthreads();          // everyone's; the stage refilled next is read
      produce(st == 0 ? stages - 1 : st - 1);   // stages - 1 positions ahead
      const unsigned char* cs = smem + st * stage;
      st = st == stages - 1 ? 0 : st + 1;
      if (n0 < 0) continue;
      const uint16_t* qh = q_resident
          ? Qr + kc * QC : reinterpret_cast<const uint16_t*>(cs + kTN * RS);
      ring_products<TM, CORE, TM == 64 ? query_stride(QC, CORE) : 0>(
          cs, qh, qh + TM * qs, qs, acc1, acc2);
    }
    if (n0 < 0) continue;
    // Accumulator layout: d0, d1 at (row g, cols 2 tig, 2 tig + 1), d2, d3
    // at row g + 8.  The epilogue's (see epilogue()), with each thread's
    // two columns' scale, bias and mask read once (bf16c and bf16x3 have
    // no scale row).
    constexpr bool kScaled = CORE != kBf16c && !hilo_core(CORE);
    float sc[2], bias[2];
    bool dead[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gn = n0 + 8 * warp + 2 * tig + e;
      dead[e] = gn >= n || (mask != nullptr && mask[gn] == 0);
      sc[e] = !kScaled || dead[e] ? 1.f : scale[gn];
      bias[e] = dead[e] ? 0.f : cb[gn];
    }
    // The gate votes once a row on the larger of its two scores (fmaxf
    // drops a NaN, which beats nothing).
    bool vote = false;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * i + g + (j >= 2 ? 8 : 0);
        const int col = 8 * warp + 2 * tig + (j & 1);
        const float d = acc1[i][j] + acc2[i][j];
        const float p = kScaled ? __fmul_rn(d, sc[j & 1]) : d;
        s[j] = dead[j & 1] ? -INFINITY : __fadd_rn(p, bias[j & 1]);
        St[r * (kTN + 1) + col] = s[j];
      }
      if constexpr (Gate::kGated)
        vote |= gate.vote(St, 16 * i + g, fmaxf(s[0], s[1])) |
                gate.vote(St, 16 * i + g + 8, fmaxf(s[2], s[3]));
    }
    if (!gate.fire(vote, 1)) continue;
    on_tile(t, n0);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace
