// Kernel A's stored cores (bf16c, int8c, int4c) at query tile 64: a ring
// of raw corpus bytes and query columns filled by the Tensor Memory
// Accelerator (TMA) as producer, warpgroup products (wgmma.mma_async,
// sm_90a) as consumer.  Kernel D's stored cores (int8c and the int4
// family) take it there too wherever its tail fits beside two stages
// (floor.cu, floor_plan).  The 16- and 32-row query tiles keep
// tile_scores.cuh's mma.sync consumer (ring_walk), and so does bf16x3 at
// every tile (fused_topk.cu, wgmma_core).
//
// The operands swap.  The corpus rows are wgmma's M side and the queries
// its N side: each of the block's two warpgroups owns two 64-row kernel
// tiles a step (a stage holds four, 256 corpus rows) and decodes their
// rows from the ring's raw bytes straight into register A fragments, as
// ring_products does for mma.sync's B fragments; the 64-row query tile is
// the B operand, read by the tensor cores from shared memory through
// matrix descriptors, so no warp loads it.  m64n64k16 keeps qh.c and ql.c
// in two accumulators of 32 floats a thread a tile, summed last.
//
// Why 256 corpus rows a stage.  The query columns ride the ring (64 rows
// of 768 [hi | lo] features do not fit beside the carry), so each stage
// loads 4 bytes a query feature for its corpus rows; a stage of R rows
// loads 1/R of the query tile a corpus row.  R is bounded by the
// accumulators: 2 x 64 x R floats over 256 threads, 128 registers a
// thread at R = 256, which leaves one block an SM (255 registers a
// thread, __launch_bounds__(256, 1)).  Two blocks an SM at R = 128 loaded
// twice the query bytes and measured slower on the H100 (PERF.md).
//
// The producer.  The block's first thread issues a position's 2-D
// bulk-tensor loads (wg_load): one 64-row corpus box a kernel tile of the
// step (none for a tile without rows) and one query box a k16 step for
// the hi and the lo halves each, and one arrive.expect_tx on the stage's
// full barrier carries the bytes they bring.  The consumers wait on the
// full barrier's parity; once wgmma.wait_group has covered a stage's
// products, each warpgroup's first thread arrives on the stage's empty
// barrier (two arrivals), and the producer refills the stage when that
// completes: stages - 1 positions in flight, and no block barrier on the
// ring's path.  The maps' out-of-bounds fill zeroes rows past n or m,
// bytes past the row and features past dim (wg_maps).  A launch the loads
// cannot take (ring_aligned false: unaligned rows or operands) fills the
// same layout byte by byte, every thread at once (wg_fill), and signals
// the full barrier after fence.proxy.async and a block barrier.
//
// The stage (its base 1024-byte aligned): 256 corpus rows at the box
// pitch, 64 bytes (int8, and bf16c's 32 columns) or 32 (int4), as the
// 2-D load writes them with the 64- or 32-byte swizzle (wg_swizzle), which
// puts the 8 rows of a fragment load on distinct banks; then the hi boxes
// and the lo boxes of the query, one a k16 step: 64 rows of 16 bf16 (32
// bytes) with the 32-byte swizzle, which the B descriptor reads as its
// layout type 3 (wg_desc).
//
// k order.  The B operand's k slot j of step s is column j of step s's
// box, the feature wg_feature gives for column 16 s + j (features in
// order for bf16c and int8; for int4, each 16 stored bytes meet two
// steps, their 16 low nibbles' features then their 16 high ones').  A
// thread's A slots are (2 tig, 2 tig + 1) and (2 tig + 8, 2 tig + 9) of
// rows g and g + 8 of its warp's 16: stored features 2 tig, 2 tig + 1,
// 2 tig + 8 and 2 tig + 9 of the step, two 2-byte loads a row for int8
// (one per slot pair, the bytes decoded together), two 4-byte loads for
// bf16c; for int4 the same two 2-byte loads give both steps of the 16
// bytes, low nibbles then high.

#pragma once

#include "tile_scores.cuh"
#include "tma_ring.cuh"

namespace {

constexpr int kWgTM = 64;          // query rows: the wgmma N side
constexpr int kWgTPW = 2;          // kernel tiles a warpgroup takes a step
constexpr int kWgTiles = 2 * kWgTPW;        // kernel tiles a step
constexpr int kWgRows = kWgTiles * kTN;     // corpus rows a stage
constexpr int kWgBlocks = 1;       // blocks an SM (255 registers a thread)
constexpr int kWgStages = 8;       // the most stages
constexpr int kWgAlign = 1024;     // a stage's alignment
constexpr int kWgBox = kWgTM * 32;  // a query box: 64 rows x 16 bf16

// The query columns one stage meets: 64 (bf16c 32: its rows take a
// swizzle's 64 bytes, and a ring of two of its stages at 64 columns would
// not fit beside the tallest carry, k = 128), and the corpus bytes a row
// they take (bf16c 2 a column, int8 1, int4 half), which is the corpus
// box's width and the row pitch in the stage.
__host__ __device__ constexpr int wg_cols(int core) {
  return core == kBf16c ? 32 : 64;
}
__host__ __device__ constexpr int wg_row_bytes(int core) {
  return core == kBf16c ? 2 * wg_cols(core)
       : packed_core(core) ? wg_cols(core) / 2 : wg_cols(core);
}
__host__ __device__ constexpr int wg_steps(int core) {
  return wg_cols(core) / 16;
}

// Where byte b of row r of a box whose rows are `span` bytes (32, 64 or
// 128) lands, as a 2-D load with that span's swizzle writes the box from
// an aligned base (CU_TENSOR_MAP_SWIZZLE_32B / 64B / 128B): the box's
// bytes in order, each 16-byte piece's index XORed with bits 7 and up of
// its offset (one bit for 32, two for 64, three for 128).
__host__ __device__ constexpr int wg_swizzle(int span, int r, int b) {
  return r * span + (b ^ ((((r * span) >> 7) & (span / 16 - 1)) << 4));
}

// A stage: the step's 256 corpus rows, then the hi and the lo query boxes.
__host__ __device__ inline size_t wg_stage_bytes(int core) {
  return (size_t)kWgRows * wg_row_bytes(core)
       + 2 * (size_t)wg_steps(core) * kWgBox;
}

// A ring of `stages` stages in a block's shared memory: room to align its
// first stage, the stages, then a full and an empty barrier for each of
// the most stages.
__host__ __device__ inline size_t wg_ring_bytes(int core, int stages) {
  return kWgAlign + stages * wg_stage_bytes(core)
       + 2 * kWgStages * sizeof(uint64_t);
}

// Shared memory after the ring: a score tile a kernel tile of the step,
// the carry, the merge lists.
__host__ __device__ inline size_t wg_tail_bytes(int k) {
  return kWgTiles * (size_t)kWgTM * (kTN + 1) * sizeof(float)
       + 2 * (size_t)kWgTM * k * sizeof(float)
       + 2 * (size_t)kWarps * kTN * sizeof(float);
}

// The ring at this k: the most stages that fit beside the tail (0 where
// none does).  The query tile is never resident.
inline RingPlan wg_plan(int core, int k) {
  for (int s = kWgStages; s >= 2; --s) {
    const size_t b = wg_ring_bytes(core, s) + wg_tail_bytes(k);
    if (b <= kMaxSmem) return RingPlan{s, false, b};
  }
  return RingPlan{0, false, 0};
}

// The ring's first stage (the first 1024-byte boundary of the block's
// shared memory), its barriers (full, then empty) and what follows them.
__device__ inline unsigned char* wg_ring(unsigned char* smem) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + kWgAlign - 1)
      & ~(uintptr_t)(kWgAlign - 1));
}
__device__ inline uint64_t* wg_bars(unsigned char* smem, int core,
                                    int stages) {
  return reinterpret_cast<uint64_t*>(wg_ring(smem)
                                     + stages * wg_stage_bytes(core));
}
__device__ inline float* wg_tail(unsigned char* smem, int core, int stages) {
  return reinterpret_cast<float*>(wg_bars(smem, core, stages)
                                  + 2 * kWgStages);
}

// The feature that query column `col` of chunk kc holds (ring_feature's
// order at this stage width); 16 columns from a multiple of 16 hold 16
// consecutive features.
template <int CORE>
__device__ inline int wg_feature(int kc, int col, int ck, float inv_half) {
  if constexpr (packed_core(CORE)) {
    const int b = kc * wg_row_bytes(CORE) + (col / 32) * 16;
    const int half = ck / 2, w = col % 32;
    int t = __float2int_rz(__int2float_rn(b) * inv_half);   // b / half +- 1
    t += (t + 1) * half <= b ? 1 : 0;
    t -= t * half > b ? 1 : 0;
    return t * ck + (b - t * half) + (w >= 16 ? half + w - 16 : w);
  } else {
    return kc * wg_cols(CORE) + col;
  }
}

// The first corpus rows of a step's kernel tiles (-1: a tile that stages
// and selects nothing).
struct WgStep {
  int n0[kWgTiles];
};

// A launch's tensor maps (kernel parameters, __grid_constant__): the
// corpus codes and the hi and lo halves of the prepared queries.
struct WgMaps {
  CUtensorMap c, qh, ql;
};

// The maps of a launch whose operands ring_aligned passes: the corpus as
// n rows of ld bytes (uint8; bf16c's as uint16), 64-row boxes of a
// stage's row bytes with their swizzle; the queries' [hi | lo] rows (4 dim
// bytes apart) as two m x dim bf16 matrices, boxes of 64 rows x 16
// columns with the 32-byte swizzle.  Returns 0, the CUresult of a failed
// encoding, or -1 without the encoder.
inline int wg_maps(WgMaps& maps, int core, const void* qp, const void* cp,
                   int m, int n, int dim, size_t ld) {
  const int rb = wg_row_bytes(core), eb = core == kBf16c ? 2 : 1;
  int rc = tensor_map_2d(
      &maps.c,
      eb == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      cp, n, ld / eb, ld, rb / eb, kTN,
      rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  const uint16_t* q = static_cast<const uint16_t*>(qp);
  for (int h = 0; h < 2 && rc == 0; ++h)
    rc = tensor_map_2d(h ? &maps.ql : &maps.qh,
                       CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q + h * dim, m, dim,
                       4 * (uint64_t)dim, 16, kWgTM,
                       CU_TENSOR_MAP_SWIZZLE_32B);
  return rc;
}

// The producer's loads of chunk kc of `step` into stage `st`, their bytes
// on `full` (one thread).
template <int CORE>
__device__ inline void wg_load(unsigned char* st, uint64_t* full,
                               const WgMaps& maps, const WgStep& step,
                               int row0, int kc, int ck, float inv_half) {
  constexpr int RB = wg_row_bytes(CORE), kSteps = wg_steps(CORE);
  constexpr int kEb = CORE == kBf16c ? 2 : 1;
  uint32_t bytes = 2 * kSteps * kWgBox;
#pragma unroll
  for (int j = 0; j < kWgTiles; ++j)
    bytes += step.n0[j] >= 0 ? kTN * RB : 0;
  mbar_expect_tx(full, bytes);
#pragma unroll
  for (int j = 0; j < kWgTiles; ++j)
    if (step.n0[j] >= 0)
      tma_load_2d(st + j * kTN * RB, &maps.c, full, kc * (RB / kEb),
                  step.n0[j]);
  unsigned char* qb = st + kWgRows * RB;
  // wg_feature of column 16 s: int4's steps 2u and 2u + 1 are the low and
  // high nibbles of the 16 bytes at 16 u.
  const int f0 = wg_feature<CORE>(kc, 0, ck, inv_half);
  const int f1 = packed_core(CORE) ? wg_feature<CORE>(kc, 32, ck, inv_half)
                                   : 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int f = packed_core(CORE) ? (s < 2 ? f0 : f1) + (s & 1) * (ck / 2)
                                    : f0 + 16 * s;
    tma_load_2d(qb + s * kWgBox, &maps.qh, full, f, row0);
    tma_load_2d(qb + (kSteps + s) * kWgBox, &maps.ql, full, f, row0);
  }
}

// The same stage byte by byte (every thread): rows [n0[j], n0[j] + 64) of
// each tile j with rows, bytes [kc RB, kc RB + RB) of each, zero past row
// n and row_bytes; the query boxes of rows [row0, row0 + 64), zero past
// row m and feature dim.
template <int CORE>
__device__ inline void wg_fill(unsigned char* st,
                               const unsigned char* __restrict__ c,
                               size_t ld, int row_bytes, const WgStep& step,
                               int n, const uint16_t* __restrict__ q,
                               int row0, int m, int dim, int kc, int ck,
                               float inv_half) {
  constexpr int RB = wg_row_bytes(CORE), kSteps = wg_steps(CORE);
#pragma unroll
  for (int j = 0; j < kWgTiles; ++j) {
    const int n0 = step.n0[j];
    if (n0 < 0) continue;
    unsigned char* d = st + j * kTN * RB;
    for (int e = threadIdx.x; e < kTN * RB; e += kThreads) {
      const int r = e / RB, o = e % RB;
      const int gr = n0 + r, b = kc * RB + o;
      d[wg_swizzle(RB, r, o)] =
          gr < n && b < row_bytes ? c[(size_t)gr * ld + b] : 0;
    }
  }
  uint16_t* qb = reinterpret_cast<uint16_t*>(st + kWgRows * RB);
  const size_t qld = 2 * (size_t)dim;   // [hi | lo] row stride
  for (int e = threadIdx.x; e < kSteps * kWgTM * 16; e += kThreads) {
    const int s = e / (kWgTM * 16), r = e / 16 % kWgTM, w = e % 16;
    const int f = wg_feature<CORE>(kc, 16 * s, ck, inv_half) + w;
    const int gr = row0 + r;
    const bool in = gr < m && f < dim;
    const int o = (s * kWgBox + wg_swizzle(32, r, 2 * w)) / 2;
    qb[o] = in ? q[gr * qld + f] : (uint16_t)0;
    qb[kSteps * kWgBox / 2 + o] = in ? q[gr * qld + dim + f] : (uint16_t)0;
  }
}

// The descriptor of a query box at p (64 rows of 32 bytes, 32-byte
// swizzle, 256-byte aligned): K-major, layout type 3, stride byte offset
// 256 (the next 8 rows), leading byte offset unused by this layout (16).
__device__ inline uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)1 << 16)
       | ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// d += A.B^T, m64n64k16, bf16 in, f32 sums; A from registers, B (K-major)
// through its descriptor.
__device__ inline void wgmma_m64n64k16(float (&d)[32], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

__device__ inline uint32_t lds16x2(const unsigned char* p, int second) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(p)
       | ((uint32_t)*reinterpret_cast<const uint16_t*>(p + second) << 16);
}

// A warpgroup's A fragments of one stage: kWgTPW tiles x k16 steps.
template <int CORE>
using WgFrags = uint32_t[kWgTPW][wg_steps(CORE)][4];

// Decode warpgroup wg's kWgTPW tiles of stage `st` into A fragments.  A
// thread's rows g and g + 8 share their swizzle (wg_swizzle's offset of
// byte b is row + (b ^ x)), and the bytes of one load stay inside a
// 16-byte piece.
template <int CORE>
__device__ inline void wg_decode(const unsigned char* st, int wg,
                                 WgFrags<CORE>& a) {
  constexpr int RB = wg_row_bytes(CORE), kSteps = wg_steps(CORE);
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < kWgTPW; ++j) {
    const int r = kTN * (kWgTPW * wg + j) + 16 * wq + g;
    const int x = wg_swizzle(RB, r, 0) - r * RB;
    const unsigned char* r0 = st + r * RB;
    const unsigned char* r8 = r0 + 8 * RB;
#pragma unroll
    for (int s = 0; s < kSteps; s += packed_core(CORE) ? 2 : 1) {
      uint32_t(&v)[4] = a[j][s];
      if constexpr (CORE == kBf16c) {   // elements 2 tig.. at 4-byte loads
        const int b0 = (32 * s + 4 * tig) ^ x;
        const int b1 = (32 * s + 16 + 4 * tig) ^ x;
        v[0] = *reinterpret_cast<const uint32_t*>(r0 + b0);
        v[1] = *reinterpret_cast<const uint32_t*>(r8 + b0);
        v[2] = *reinterpret_cast<const uint32_t*>(r0 + b1);
        v[3] = *reinterpret_cast<const uint32_t*>(r8 + b1);
      } else if constexpr (packed_core(CORE)) {   // 16 bytes: steps s, s + 1
        uint32_t(&y)[4] = a[j][s + 1];
        const int b = (8 * s + 2 * tig) ^ x;
        decode_packed<CORE>(lds16x2(r0 + b, 8), v[0], y[0], v[2], y[2]);
        decode_packed<CORE>(lds16x2(r8 + b, 8), v[1], y[1], v[3], y[3]);
      } else {
        const int b = (16 * s + 2 * tig) ^ x;
        i8x4_bf16(lds16x2(r0 + b, 8), v[0], v[2]);
        i8x4_bf16(lds16x2(r8 + b, 8), v[1], v[3]);
      }
    }
  }
}

// The products of one stage from its A fragments and its query boxes at
// qb (hi, then lo): qh.c into acc1[j], ql.c into acc2[j] for tile j,
// issued as one group and not waited for.
template <int CORE>
__device__ inline void wg_issue(const WgFrags<CORE>& a,
                                const unsigned char* qb,
                                float (&acc1)[kWgTPW][32],
                                float (&acc2)[kWgTPW][32]) {
  constexpr int kSteps = wg_steps(CORE);
  gmma_fence();   // the fragments written above
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int j = 0; j < kWgTPW; ++j) {
      const uint32_t(&x)[4] = a[j][s];
      wgmma_m64n64k16(acc1[j], x[0], x[1], x[2], x[3],
                      wg_desc(qb + s * kWgBox));
      wgmma_m64n64k16(acc2[j], x[0], x[1], x[2], x[3],
                      wg_desc(qb + (kSteps + s) * kWgBox));
    }
  gmma_commit();
}

__device__ inline void wg_pin_all(float (&acc1)[kWgTPW][32],
                                  float (&acc2)[kWgTPW][32]) {
#pragma unroll
  for (int j = 0; j < kWgTPW; ++j) {
    gmma_pin(acc1[j]);
    gmma_pin(acc2[j]);
  }
}

// Walk tiles [t_begin, t_end) kWgTiles at a time through the ring:
// warpgroup w scores tiles t + kWgTPW w + j into St + (kWgTPW w + j) * 64 *
// (kTN + 1) (64 x (kTN + 1), the layout select_tile reads), then, after a
// barrier, on_step(step) runs (the tiles' first corpus rows, -1 where a
// tile is past t_end or its listed id names no rows); the next step's
// scores wait for a barrier after it.  `smem` is the block's shared
// memory, the ring at its first 1024-byte boundary (wg_ring); `maps` the
// launch's tensor maps where vec (wg_maps), else unread.  Listed and the
// other arguments as in ring_walk; the query tile always rides the ring.
// `gate` (NoGate: none) votes on each score of the step's live tiles and
// may skip on_step at the barrier: one decision a step, for its four
// tiles.  Ends after a barrier with no load in flight.
template <int CORE, bool LISTED, typename OnStep, typename Gate = NoGate>
__device__ inline void wg_walk(const WgMaps& maps,
                               const uint16_t* __restrict__ q,
                               const void* __restrict__ cp,
                               const float* __restrict__ scale,
                               const float* __restrict__ cb,
                               const uint8_t* __restrict__ mask,
                               const int* __restrict__ list,
                               int layout_tiles, int tn_tiles,
                               unsigned char* smem, float* St, int row0,
                               int m, int n, int dim, int c_ld, int ck,
                               int t_begin, int t_end, int stages, bool vec,
                               OnStep&& on_step, const Gate& gate = Gate{}) {
  constexpr int RB = wg_row_bytes(CORE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  const bool lead = (threadIdx.x & 127) == 0;   // a warpgroup's first
  const unsigned char* c = static_cast<const unsigned char*>(cp);
  const size_t ld = (size_t)c_ld * (CORE == kBf16c ? 2 : 1);
  const int row_bytes = (int)ld, chunks = (row_bytes + RB - 1) / RB;
  const size_t stage = wg_stage_bytes(CORE);
  const float inv_half = packed_core(CORE) ? 1.f / (ck / 2) : 0.f;
  unsigned char* ring = wg_ring(smem);
  uint64_t* full = wg_bars(smem, CORE, stages);
  uint64_t* empty = full + kWgStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);   // a warpgroup's first thread each
    }
    mbar_init_fence();
    if (vec) {
      tma_prefetch_map(&maps.c);
      tma_prefetch_map(&maps.qh);
      tma_prefetch_map(&maps.ql);
    }
  }
  __syncthreads();
  // The step of tiles [t, t + kWgTiles), tile t being tile `sub` of list
  // entry `entry` when listed (the rest follow without divisions).
  auto step_at = [&](int t, int entry, int sub) {
    WgStep st;
#pragma unroll
    for (int j = 0; j < kWgTiles; ++j) {
      int n0 = -1;
      if (t + j < t_end) {
        if constexpr (LISTED) {
          const int lt = list[entry];
          if (lt >= 0 && lt < layout_tiles) n0 = (lt * tn_tiles + sub) * kTN;
          if (++sub == tn_tiles) {
            sub = 0;
            ++entry;
          }
        } else {
          n0 = (t + j) * kTN;
        }
      }
      st.n0[j] = n0;
    }
    return st;
  };
  // The producer: the next position's step (its first tile, that tile's
  // list entry and tile in it) and chunk, into stage ps of fill parity
  // pph.  Waits for the stage's empty barrier (a fresh one passes at parity
  // 1), then loads it (one thread) or fills it (every thread).
  int it = t_begin, ikc = 0;
  int ie = LISTED ? t_begin / tn_tiles : 0;
  int isub = LISTED ? t_begin - ie * tn_tiles : 0;
  int ps = 0;
  uint32_t pph = 0;
  auto produce = [&]() {
    if (it >= t_end) return;
    unsigned char* st = ring + ps * stage;
    if (vec) {
      if (threadIdx.x == 0) {
        mbar_wait(&empty[ps], pph ^ 1);
        wg_load<CORE>(st, &full[ps], maps, step_at(it, ie, isub), row0, ikc,
                      ck, inv_half);
      }
    } else {
      mbar_wait(&empty[ps], pph ^ 1);
      wg_fill<CORE>(st, c, ld, row_bytes, step_at(it, ie, isub), n, q, row0,
                    m, dim, ikc, ck, inv_half);
      // the writes visible to the tensor cores' reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (threadIdx.x == 0) mbar_arrive(&full[ps]);
    }
    if (++ps == stages) {
      ps = 0;
      pph ^= 1;
    }
    if (++ikc == chunks) {
      ikc = 0;
      it += kWgTiles;
      if (LISTED) {
        isub += kWgTiles;
        while (isub >= tn_tiles) {
          isub -= tn_tiles;
          ++ie;
        }
      }
    }
  };
  for (int i = 0; i < stages - 1; ++i) produce();

  int cs = 0;   // the consumer's stage and its fill parity
  uint32_t cph = 0;
  for (int t = t_begin; t < t_end; t += kWgTiles) {
    // Both warpgroups run the products of every step (a tile past the
    // split or off the list scores stale bytes and is not selected): the
    // wgmma path stays uniform across the block, which ptxas needs to keep
    // the products asynchronous.
    float acc1[kWgTPW][32], acc2[kWgTPW][32];
#pragma unroll
    for (int j = 0; j < kWgTPW; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) { acc1[j][i] = 0.f; acc2[j][i] = 0.f; }
    wg_pin_all(acc1, acc2);
    int held = -1;   // the stage whose products may still run
    for (int kc = 0; kc < chunks; ++kc) {
      mbar_wait(&full[cs], cph);   // this position's bytes landed
      const unsigned char* st = ring + cs * stage;
      WgFrags<CORE> frag;
      gmma_wait<0>();   // the last stage's products: fragments, stage free
      if (held >= 0 && lead) mbar_arrive(&empty[held]);
      wg_decode<CORE>(st, wg, frag);
      wg_issue<CORE>(frag, st + kWgRows * RB, acc1, acc2);
      held = cs;
      if (++cs == stages) {
        cs = 0;
        cph ^= 1;
      }
      produce();   // the stage just freed, while this one's products run
    }
    gmma_wait<0>();
    wg_pin_all(acc1, acc2);
    if (lead) mbar_arrive(&empty[held]);
    __syncthreads();   // the last step's selection is done with St, Cv
    const WgStep step = LISTED ? step_at(t, t / tn_tiles, t % tn_tiles)
                               : step_at(t, 0, 0);
    // Accumulator layout (m64n64): d[4i + 2h + e] at corpus row 16 wq + g +
    // 8h of the tile, query column 8i + 2 tig + e.  The epilogue's (see
    // epilogue()), each thread's two rows' scale, bias and mask read once,
    // stored transposed: St row = query, column = corpus row.  Written for
    // every tile, selected only where it has rows (a tile without rows
    // scores -inf, which votes for nothing).
    bool vote = false;
#pragma unroll
    for (int j = 0; j < kWgTPW; ++j) {
      const int n0 = wg ? step.n0[kWgTPW + j] : step.n0[j];
      float* S = St + (kWgTPW * wg + j) * kWgTM * (kTN + 1);
      float sc[2], bias[2];
      bool dead[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gn = n0 + 16 * wq + g + 8 * h;
        dead[h] = n0 < 0 || gn >= n || (mask != nullptr && mask[gn] == 0);
        sc[h] = CORE == kBf16c || dead[h] ? 1.f : scale[gn];
        bias[h] = dead[h] ? 0.f : cb[gn];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float s[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int qr = 8 * i + 2 * tig + (e & 1);
          const int col = 16 * wq + g + 8 * h;
          const float d = acc1[j][4 * i + e] + acc2[j][4 * i + e];
          const float p = CORE == kBf16c ? d : __fmul_rn(d, sc[h]);
          s[e] = dead[h] ? -INFINITY : __fadd_rn(p, bias[h]);
          S[qr * (kTN + 1) + col] = s[e];
        }
        // One vote a query row, on the larger of its two scores.
        if constexpr (Gate::kGated)
          vote |= gate.vote(St, 8 * i + 2 * tig, fmaxf(s[0], s[2])) |
                  gate.vote(St, 8 * i + 2 * tig + 1, fmaxf(s[1], s[3]));
      }
    }
    int live = 0;
#pragma unroll
    for (int j = 0; j < kWgTiles; ++j) live += step.n0[j] >= 0 ? 1 : 0;
    if (!gate.fire(vote, live)) continue;
    on_step(step);
  }
  __syncthreads();
}

}  // namespace
