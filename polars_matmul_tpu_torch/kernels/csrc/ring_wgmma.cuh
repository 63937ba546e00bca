// Kernel A's stored cores (bf16c, int8c, int4c) at query tile 64: the ring
// of raw corpus bytes (tile_scores.cuh) as producer, warpgroup products
// (wgmma.mma_async, sm_90a) as consumer.  Kernel D's stored cores (int8c
// and the int4 family) take it there too wherever its tail fits beside two
// stages (floor.cu, floor_plan).  The 16- and 32-row query tiles keep
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
// copies 4 bytes a query feature for its corpus rows; a stage of R rows
// copies 1/R of the query tile a corpus row.  R is bounded by the
// accumulators: 2 x 64 x R floats over 256 threads, 128 registers a
// thread at R = 256, which leaves one block an SM (255 registers a
// thread, __launch_bounds__(256, 1)).  Two blocks an SM at R = 128 copied
// twice the query bytes and measured slower on the H100 (PERF.md).
//
// The query columns of a stage are stored as 8-row x 16-byte core matrices
// (no swizzle): core matrix (row group rg, column group cg) at byte
// (rg * QC / 8 + cg) * 128, row r % 8 of it at 16 (r % 8); each 16-byte
// cp.async of the producer is one core-matrix row.  A k16 step s reads
// column groups 2s and 2s + 1: start 256 s bytes, leading byte offset
// (the next 8 columns) 128, stride byte offset (the next 8 rows) 16 QC.
//
// k order.  The B operand's k slot j of step s is query column 16 s + j,
// which holds the feature ring_feature gives (features in order for bf16c
// and int8; for int4, each 16 stored bytes meet 32 columns, their 16 low
// nibbles then their 16 high ones).  A thread's A slots are (2 tig,
// 2 tig + 1) and (2 tig + 8, 2 tig + 9) of rows g and g + 8 of its warp's
// 16: stored features 2 tig, 2 tig + 1, 2 tig + 8 and 2 tig + 9 of the
// step, two 2-byte loads a row for int8 (one per slot pair, the bytes
// decoded together), two 4-byte loads for bf16c; for int4 the same two
// 2-byte loads give both steps of the 16 bytes, low nibbles then high.

#pragma once

#include "tile_scores.cuh"

namespace {

constexpr int kWgTM = 64;          // query rows: the wgmma N side
constexpr int kWgTPW = 2;          // kernel tiles a warpgroup takes a step
constexpr int kWgTiles = 2 * kWgTPW;        // kernel tiles a step
constexpr int kWgRows = kWgTiles * kTN;     // corpus rows a stage
constexpr int kWgBlocks = 1;       // blocks an SM (255 registers a thread)
constexpr int kWgStages = 8;       // the most stages

// The query columns one stage meets: 64 (bf16c 48: a ring of two of its
// wider stages still fits beside the tallest carry, k = 128), and the
// corpus bytes a row they take (bf16c 2 a column, int8 1, int4 half); the
// row stride (an odd number of 16-byte units: the 8 rows of a fragment
// load fall on distinct banks).  Chosen by measurement on the H100
// (PERF.md): wider stages cost fewer barriers a byte.
__host__ __device__ constexpr int wg_cols(int core) {
  return core == kBf16c ? 48 : 64;
}
__host__ __device__ constexpr int wg_row_bytes(int core) {
  return core == kBf16c ? 2 * wg_cols(core)
       : packed_core(core) ? wg_cols(core) / 2 : wg_cols(core);
}
__host__ __device__ constexpr int wg_row_stride(int core) {
  return odd_units(wg_row_bytes(core), 16);
}

// A stage: the step's 256 corpus rows, then the hi and lo query columns
// (64 rows each, core matrices).
__host__ __device__ inline size_t wg_stage_bytes(int core) {
  return (size_t)kWgRows * wg_row_stride(core)
       + 2 * (size_t)kWgTM * wg_cols(core) * sizeof(uint16_t);
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
    const size_t b = s * wg_stage_bytes(core) + wg_tail_bytes(k);
    if (b <= kMaxSmem) return RingPlan{s, false, b};
  }
  return RingPlan{0, false, 0};
}

// Element offset of query (row, column) in a stage's hi or lo columns.
__host__ __device__ constexpr int wg_query_offset(int core, int r, int col) {
  return ((r >> 3) * (wg_cols(core) >> 3) + (col >> 3)) * 64 + (r & 7) * 8
       + (col & 7);
}

// The feature that query column `col` of chunk kc holds (ring_feature's
// order at this stage width).
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

// Stage rows [n0[j], n0[j] + 64) of each tile j of the step into stage rows
// [64 j, 64 j + 64), bytes [b0, b0 + wg_row_bytes) of each, zero past row n
// and past row_bytes.
template <int CORE>
__device__ inline void wg_corpus(unsigned char* dst,
                                 const unsigned char* __restrict__ c,
                                 size_t ld, int row_bytes, const WgStep& step,
                                 int n, int b0, bool vec) {
  constexpr int RB = wg_row_bytes(CORE), RS = wg_row_stride(CORE);
  if (vec) {   // 16-byte pieces, spread over every thread
    constexpr int kV = RB / 16;
    for (int e = threadIdx.x; e < kWgRows * kV; e += kThreads) {
      const int r = e / kV, o = (e % kV) * 16, j = r / kTN;
      int n0 = step.n0[0];
#pragma unroll
      for (int i = 1; i < kWgTiles; ++i) n0 = j == i ? step.n0[i] : n0;
      if (n0 < 0) continue;
      const int gr = n0 + r % kTN, b = b0 + o;
      const bool in = gr < n && b < row_bytes;   // whole 16-byte pieces
      cp_async16(dst + r * RS + o, in ? c + (size_t)gr * ld + b : c,
                 in ? 16 : 0);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kWgTiles; ++j) {   // byte by byte
    const int n0 = step.n0[j];
    if (n0 < 0) continue;
    unsigned char* d = dst + j * kTN * RS;
    for (int e = threadIdx.x; e < kTN * RB; e += kThreads) {
      const int r = e / RB, o = e % RB;
      const int gr = n0 + r, b = b0 + o;
      d[r * RS + o] = gr < n && b < row_bytes ? c[(size_t)gr * ld + b] : 0;
    }
  }
}

// Stage the query columns of chunk kc of rows [row0, row0 + 64) into Qh /
// Ql as core matrices, zero past row m and feature dim.
template <int CORE>
__device__ inline void wg_query(uint16_t* Qh, uint16_t* Ql,
                                const uint16_t* __restrict__ q, int row0,
                                int m, int dim, int ck, float inv_half,
                                int kc, bool vec) {
  constexpr int QC = wg_cols(CORE);
  const size_t ld = 2 * (size_t)dim;   // [hi | lo] row stride
  if (vec) {
    constexpr int kP = QC / 8;   // 8-column pieces a row
    for (int e = threadIdx.x; e < kWgTM * kP; e += kThreads) {
      const int r = e / kP, col = (e % kP) * 8;
      const int f = wg_feature<CORE>(kc, col, ck, inv_half);
      const int gr = row0 + r;
      const bool in = gr < m && f < dim;   // whole 8-feature pieces
      const uint16_t* src = in ? q + gr * ld + f : q;
      const int o = wg_query_offset(CORE, r, col);
      cp_async16(Qh + o, src, in ? 16 : 0);
      cp_async16(Ql + o, in ? src + dim : q, in ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < kWgTM * QC; e += kThreads) {
    const int r = e / QC, col = e % QC;
    const int f = wg_feature<CORE>(kc, col, ck, inv_half);
    const int gr = row0 + r;
    const bool in = gr < m && f < dim;
    const int o = wg_query_offset(CORE, r, col);
    Qh[o] = in ? q[gr * ld + f] : (uint16_t)0;
    Ql[o] = in ? q[gr * ld + dim + f] : (uint16_t)0;
  }
}

// The matrix descriptor of a no-swizzle K-major operand at p: leading
// byte offset lbo (the next 8 k columns), stride byte offset sbo (the next
// 8 rows).
__device__ inline uint64_t wg_desc(const void* p, uint32_t lbo,
                                   uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF)
       | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
       | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ inline void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator accesses across the wgmma
// fences and waits.
__device__ inline void wg_pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
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

// At most n cp.async groups still in flight (n < kWgStages).
__device__ inline void wg_cp_wait(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// A warpgroup's A fragments of one stage: kWgTPW tiles x k16 steps.
template <int CORE>
using WgFrags = uint32_t[kWgTPW][wg_cols(CORE) / 16][4];

// Decode this warpgroup's kWgTPW tiles of a stage (`rows` points at its
// first corpus row in the stage) into A fragments.
template <int CORE>
__device__ inline void wg_decode(const unsigned char* rows,
                                 WgFrags<CORE>& a) {
  constexpr int RS = wg_row_stride(CORE), kSteps = wg_cols(CORE) / 16;
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < kWgTPW; ++j) {
    const unsigned char* r0 = rows + (kTN * j + 16 * wq + g) * RS;
    const unsigned char* r8 = r0 + 8 * RS;
#pragma unroll
    for (int s = 0; s < kSteps; s += packed_core(CORE) ? 2 : 1) {
      uint32_t(&x)[4] = a[j][s];
      if constexpr (CORE == kBf16c) {   // elements 2 tig.. at 4-byte loads
        x[0] = *reinterpret_cast<const uint32_t*>(r0 + 32 * s + 4 * tig);
        x[1] = *reinterpret_cast<const uint32_t*>(r8 + 32 * s + 4 * tig);
        x[2] = *reinterpret_cast<const uint32_t*>(r0 + 32 * s + 16 + 4 * tig);
        x[3] = *reinterpret_cast<const uint32_t*>(r8 + 32 * s + 16 + 4 * tig);
      } else if constexpr (packed_core(CORE)) {   // 16 bytes: steps s, s + 1
        uint32_t(&y)[4] = a[j][s + 1];
        decode_packed<CORE>(lds16x2(r0 + 8 * s + 2 * tig, 8), x[0], y[0],
                            x[2], y[2]);
        decode_packed<CORE>(lds16x2(r8 + 8 * s + 2 * tig, 8), x[1], y[1],
                            x[3], y[3]);
      } else {
        i8x4_bf16(lds16x2(r0 + 16 * s + 2 * tig, 8), x[0], x[2]);
        i8x4_bf16(lds16x2(r8 + 16 * s + 2 * tig, 8), x[1], x[3]);
      }
    }
  }
}

// The products of one stage from its A fragments: qh.c into acc1[j], ql.c
// into acc2[j] for tile j, issued as one group and not waited for.
template <int CORE>
__device__ inline void wg_issue(const WgFrags<CORE>& a, const uint16_t* Qh,
                                const uint16_t* Ql, float (&acc1)[kWgTPW][32],
                                float (&acc2)[kWgTPW][32]) {
  constexpr int QC = wg_cols(CORE), kSteps = QC / 16;
  constexpr uint32_t kLbo = 128, kSbo = 16 * QC;
  wg_fence();   // the fragments written above
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int j = 0; j < kWgTPW; ++j) {
      const uint32_t(&x)[4] = a[j][s];
      wgmma_m64n64k16(acc1[j], x[0], x[1], x[2], x[3],
                      wg_desc(Qh + 16 * 8 * s, kLbo, kSbo));
      wgmma_m64n64k16(acc2[j], x[0], x[1], x[2], x[3],
                      wg_desc(Ql + 16 * 8 * s, kLbo, kSbo));
    }
  wg_commit();
}

// This warpgroup's product groups all done.
__device__ inline void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ inline void wg_pin_all(float (&acc1)[kWgTPW][32],
                                  float (&acc2)[kWgTPW][32]) {
#pragma unroll
  for (int j = 0; j < kWgTPW; ++j) {
    wg_pin(acc1[j]);
    wg_pin(acc2[j]);
  }
}

// Walk tiles [t_begin, t_end) kWgTiles at a time through the ring:
// warpgroup w scores tiles t + kWgTPW w + j into St + (kWgTPW w + j) * 64 *
// (kTN + 1) (64 x (kTN + 1), the layout select_tile reads), then, after a
// barrier, on_step(step) runs (the tiles' first corpus rows, -1 where a
// tile is past t_end or its listed id names no rows); the next step's
// scores wait for a barrier after it.  Listed and the other arguments as
// in ring_walk; the query tile always rides the ring.  `gate` (NoGate:
// none) votes on each score of the step's live tiles and may skip on_step
// at the barrier: one decision a step, for its four tiles.  Ends after a
// barrier with no copy in flight.
template <int CORE, bool LISTED, typename OnStep, typename Gate = NoGate>
__device__ inline void wg_walk(const uint16_t* __restrict__ q,
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
  constexpr int RB = wg_row_bytes(CORE), RS = wg_row_stride(CORE);
  constexpr int QC = wg_cols(CORE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  const unsigned char* c = static_cast<const unsigned char*>(cp);
  const size_t ld = (size_t)c_ld * (CORE == kBf16c ? 2 : 1);
  const int row_bytes = (int)ld, chunks = (row_bytes + RB - 1) / RB;
  const size_t stage = wg_stage_bytes(CORE);
  const float inv_half = packed_core(CORE) ? 1.f / (ck / 2) : 0.f;
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
  // The producer: the next position's step (its first tile's list entry
  // and tile in it) and chunk, into stage `to`.
  int it = t_begin, ikc = 0;
  int ie = LISTED ? t_begin / tn_tiles : 0;
  int isub = LISTED ? t_begin - ie * tn_tiles : 0;
  auto produce = [&](int to) {
    if (it < t_end) {
      unsigned char* st = smem + to * stage;
      wg_corpus<CORE>(st, c, ld, row_bytes, step_at(it, ie, isub), n,
                      ikc * RB, vec);
      uint16_t* qh = reinterpret_cast<uint16_t*>(st + kWgRows * RS);
      wg_query<CORE>(qh, qh + kWgTM * QC, q, row0, m, dim, ck, inv_half,
                     ikc, vec);
    }
    cp_async_commit();   // one group a position, empty or not
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
  // A stage's products run on through the next position's barrier (the
  // wait for them comes before the next decode): the stage is refilled one
  // barrier later, so the ring runs stages - 2 positions ahead (a ring of
  // two waits for each stage's products at once).
  const bool defer = stages > 2;
  const int ahead = defer ? stages - 2 : stages - 1;
  for (int i = 0; i < ahead; ++i) produce(i);

  int st = 0, pst = ahead;   // the consumer's stage, the producer's
  for (int t = t_begin; t < t_end; t += kWgTiles) {
    const WgStep step = LISTED ? step_at(t, t / tn_tiles, t % tn_tiles)
                               : step_at(t, 0, 0);
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
    for (int kc = 0; kc < chunks; ++kc) {
      wg_cp_wait(ahead - 1);   // this position's copies landed
      // and are visible to the tensor cores' reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();   // everyone's; the stage refilled next is done with
      const unsigned char* cs = smem + st * stage;
      st = st == stages - 1 ? 0 : st + 1;
      const uint16_t* qh =
          reinterpret_cast<const uint16_t*>(cs + kWgRows * RS);
      WgFrags<CORE> frag;
      wg_wait_all();   // the last stage's products: their fragments free
      wg_decode<CORE>(cs + wg * kWgTPW * kTN * RS, frag);
      wg_issue<CORE>(frag, qh, qh + kWgTM * QC, acc1, acc2);
      produce(pst);   // while this stage's products run
      pst = pst == stages - 1 ? 0 : pst + 1;
      if (!defer) wg_wait_all();
    }
    wg_wait_all();
    wg_pin_all(acc1, acc2);
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
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace
