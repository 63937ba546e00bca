// Kernel D: kernel A's staging and score tiles without its selection, then
// either a per-tile row-max sum or an L-level packed stack selection over
// every score.
//
// Replaces three Pallas kernels of the JAX package's experiment tools, the
// TPU's attribution kit:
// - tools/exp_floor.py::_kernel_ab (:55, measure_ab :108): the bf16x3
//   product + bias, then levels = 0 (a per-tile row-max sum: the product
//   and epilogue alone) or 1, 4 or 5 stack levels with global group ids;
// - tools/exp_b256.py::_kernel_build (:94, measure_build :151): the int8c
//   product + scale | bias, then levels = 0 or a segmented-gstack-style
//   build (the stacks reset every 16,384 columns), with or without posu
//   (the raw score bits, no order transform);
// - tools/exp_int4.py::_kernel_mm (:82, measure :136): the product against
//   an int8 corpus or an int4 one decoded three ways (nibbles; a 16 hi +
//   lo repack decoded in float; the raw bytes, wrong on purpose), scale |
//   bias, one stack level with tile-local group ids.
//
// What it computes.  The scores s[r, col] are kernel A's: the same
// functions (tile_scores.cuh, ring_wgmma.cuh), the same staging, the same
// epilogue.  levels = 0: out[r, :] = the sum over tn-wide corpus tiles of
// int32(max over the tile of s[r, .]), truncated toward zero.  levels >= 1:
// u = the order-preserving int of the score bits (the raw bits with posu),
// p = (u & ~127) | id(col), and each (row, lane = col % 128) cell keeps a
// descending stack of L packed values, from INT32_MIN, through the max /
// min chain of the TPU kernels, so level i is the cell's i-th largest
// value.  id(col) is 127 - col / 128 (global), 127 - (col % seg) / 128 with
// the stacks reset at every seg-column segment (segmented; seg =
// (16384 / tn) tn, the TPU kernel's tiles per segment), or (col % tn) / 128
// (tile-local).  out[r, :] is level 0, of the last segment when segmented.
//
// What changes from the TPU.  The TPU walks the corpus in order on one
// core with the stacks in VMEM.  Here block (x, y) owns query rows
// [x TM, x TM + TM) and corpus split y, with kernel A's tiles of 64 corpus
// rows, its query tile and its splits; tn only defines the levels = 0
// tiles and the ids.  A 64-column tile lies inside one 128-column group,
// so one id serves the whole tile, and it covers half of the 128 lanes.
// Each cell (row, lane) belongs to one thread for the whole walk: thread
// t owns lanes 64 h + t % 64 (h = 0, 1) of rows t / 64 + 4 i, i < TM / 4,
// so a tile gives each thread one score a row of its half (a warp reads 32
// neighbouring columns of a score row: no bank conflict), and no barrier
// guards a stack.  Up to reg_max levels live in registers (2 TM / 4 x L a
// thread); deeper stacks in shared memory ([level][row][lane]: TM x 128 x
// L ints, 160 KB at TM = 64 and L = 5; the wrapper narrows the query tile
// where they would not fit).  A segment's reset is each thread's own, in
// walk order.  levels = 0 keeps each thread's column maxima of its rows in
// registers and reduces a row's across its 64 threads (shuffles, then
// atomicMax) only where a tn-row tile ends.  The splits combine exactly
// and in any order: int32
// atomicMax of level 0 into out (only splits that reach the last segment,
// when segmented), and every split writes its stacks to levels_out, so
// that no level can be elided and each can be checked.  levels = 0 keeps
// kernel A's splits too, although they need not cut on tn-row tiles: a
// block flushes the partial maximum of each tn-row tile it ends with
// atomicMax (of order-preserving ints) into levels_out, (m, tiles), and
// the last block of a query tile to finish (a counter per query tile)
// sums that tile's rows.
//
// The consumers are kernel A's.  bf16x3 streams its [hi | lo] rows through
// kernel A's ring into mma.sync (tile_scores.cuh::ring_walk, 32 or 64
// features a position by kernel A's ring_core rule applied to D's own
// shared memory), so its scores are the per-tile core's bit for bit.  The
// stored cores (int8c and the int4 family) at query tile 64 run the
// warpgroup consumer (ring_wgmma.cuh::wg_walk: four 64-row tiles a step,
// one score tile each, taken in walk order) wherever D's tail fits beside
// two of its stages; elsewhere they run the mma.sync ring.  On a wgmma
// step with the stacks in shared memory, tiles j and j + 2 fall on the
// same lanes: a thread loads each of its cells' levels once, inserts both
// scores, and stores them once.
//
// What bounds it on the H100: the bytes of the corpus (int8 and int4 at
// batch 8) or the bf16 products (batch 256, the bf16x3 floor at 1024
// queries), as for kernel A, plus, for levels >= 1, the selection: about
// 2 L + 5 integer operations a score, and for stacks in shared memory L
// loads and stores (on a wgmma step, L of each for two scores).  Kernel A
// minus kernel D at levels = 0 is kernel A's selection cost, and D at L
// minus D at levels = 0 is what an L-level stack selection would cost
// instead.

#include "ring_wgmma.cuh"
#include "tile_scores.cuh"

#include <type_traits>

namespace {

constexpr int kLanes = 128;
constexpr int kINT32_MIN = -2147483647 - 1;
constexpr int kMaxLevels = 16;
constexpr int kSegmentRows = kLanes * kLanes;   // 16,384

// The group-id rules, in the order of kernels/floor.py's IDS.
enum Ids : int { kGlobal = 0, kSegmented = 1, kTileLocal = 2 };

// The consumers, in the order of kernels/floor.py's CONSUMERS.
enum Consumer : int { kRing = 0, kWgmma = 1 };

// The most stack levels held in registers (kernels/floor.py's reg_max),
// chosen on the H100: one beside the warpgroup consumer's 128 accumulator
// registers (two spilled 104-232 B), two on the mma.sync ring at query
// tile 16 and at 32 but for the int4 family (one spilled 4-8 B within its
// 128 registers), none on the tile-64 ring (184-214 registers left one
// block an SM: 1.7-1.8 x slower than the stacks in shared memory at two).
__host__ __device__ constexpr int reg_max(int tm, int core, int consumer) {
  return consumer == kWgmma ? 1
       : tm == 64 || (tm == 32 && packed_core(core)) ? 0 : 2;
}

// Stack levels held in registers: all of them up to reg_max, else 0 (the
// stacks in shared memory, or levels = 0).
__host__ __device__ constexpr int reg_levels(int tm, int core, int levels,
                                             int consumer) {
  return levels >= 1 && levels <= reg_max(tm, core, consumer) ? levels : 0;
}

// Shared memory after the staging: the score tiles (one, or a wgmma
// step's four), then the stacks when they are in shared memory.
__host__ __device__ inline size_t floor_tail_bytes(int tm, int core,
                                                   int levels, int consumer) {
  const size_t tiles = consumer == kWgmma ? kWgTiles : 1;
  const size_t stacks = levels == 0 || reg_levels(tm, core, levels, consumer)
                            ? 0 : (size_t)levels * tm * kLanes * sizeof(int);
  return tiles * tm * (kTN + 1) * sizeof(float) + stacks;
}

// A launch's plan: its consumer, the core its ring streams (kBf16x3W for
// bf16x3's 64-feature positions), the ring's stages and kernel's shared
// memory (stages 0 where nothing fits), and the levels in registers.
struct FloorPlan {
  int consumer;
  int core;
  RingPlan ring;
  int reg;
};

// The warpgroup consumer where a stored core at query tile 64 fits its
// tail beside two stages (the most stages that fit); else the mma.sync
// ring (ring_plan), bf16x3 at 64 features a position where that ring
// keeps two blocks an SM at query tiles 16 and 64 (kernel A's ring_core).
inline FloorPlan floor_plan(int tm, int core, int levels, int c_ld) {
  if (tm == kWgTM && stored_core(core)) {
    const size_t tail = floor_tail_bytes(tm, core, levels, kWgmma);
    for (int s = kWgStages; s >= 2; --s) {
      const size_t b = wg_ring_bytes(core, s) + tail;
      if (b <= kMaxSmem)
        return FloorPlan{kWgmma, core, RingPlan{s, false, b},
                         reg_levels(tm, core, levels, kWgmma)};
    }
  }
  const size_t rest = floor_tail_bytes(tm, core, levels, kRing);
  int rc = core;
  if (core == kBf16x3 && tm != 32) {
    const RingPlan wide = ring_plan(
        tm, kBf16x3W, ring_chunks(tm, kBf16x3W, 2 * c_ld), rest);
    if (wide.stages > 0 && smem_blocks(wide.bytes) >= 2) rc = kBf16x3W;
  }
  const RingPlan ring = ring_plan(
      tm, rc, ring_chunks(tm, rc, c_ld * ring_elem_bytes(rc)), rest);
  return FloorPlan{kRing, rc, ring, reg_levels(tm, core, levels, kRing)};
}

// Blocks an SM the compiler plans for: two on the mma.sync ring, as kernel
// A's (at most 128 registers a thread), except where one is all that fits:
// the warpgroup consumer (its accumulators alone take 128) and a stored
// core's tile-64 ring (deep stacks).
template <int TM, int CORE, int CONSUMER>
__host__ __device__ constexpr int floor_min_blocks() {
  return CONSUMER == kWgmma || (TM == 64 && stored_core(CORE)) ? 1 : 2;
}

// The order-preserving int of f32 bits, and back (an involution).
__device__ inline int ordered(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

// FORM: kMaxima (levels = 0: each thread's running column maxima in
// registers), kShared (the stacks in shared memory), or the levels held in
// registers (1, 2).
constexpr int kMaxima = -1, kShared = 0;

template <int TM, int CORE, int CONSUMER, int FORM>
__global__ void __launch_bounds__(kThreads,
                                  floor_min_blocks<TM, CORE, CONSUMER>())
floor_stacks_kernel(const __grid_constant__ WgMaps maps,
                    const uint16_t* __restrict__ qp,
                    const void* __restrict__ cp,
                    const float* __restrict__ scale,
                    const float* __restrict__ cb, int* __restrict__ out,
                    int* __restrict__ levels_out, int* __restrict__ done,
                    int m, int n, int dim,
                    int c_ld, int levels, int tn, int ids, int seg,
                    bool posu, int splits, int tiles_per_split, bool vec,
                    int stages, bool q_resident) {
  constexpr bool kWg = CONSUMER == kWgmma;
  static_assert(!kWg || (TM == kWgTM && stored_core(CORE)),
                "the warpgroup consumer takes a stored core at tile 64");
  constexpr int kTiles = kWg ? kWgTiles : 1;   // score tiles a step
  static_assert(kWgTiles == 4, "a wgmma step's parities are 0, 1, 0, 1");
  constexpr int kCells = TM * kLanes;
  constexpr int kRows = TM / 4;   // a thread's rows in each lane half
  constexpr int REG = FORM > 0 ? FORM : 0;   // levels in registers
  extern __shared__ __align__(16) unsigned char smem[];
  float* St = kWg ? wg_tail(smem, CORE, stages)
                  : reinterpret_cast<float*>(
                        smem + ring_bytes(TM, CORE,
                                          ring_chunks(TM, CORE,
                                                      c_ld * ring_elem_bytes(
                                                          CORE)),
                                          q_resident, stages));
  int* stack = reinterpret_cast<int*>(St + kTiles * TM * (kTN + 1));
  __shared__ bool last_block;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TM;
  const int rows_valid = min(TM, m - row0);
  const int split = blockIdx.y;
  const int n_tiles = (n + kTN - 1) / kTN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  // This thread's cells: column col of each tile, rows r0 + 4 i, in the
  // lane half of tiles of parity p = (t - t_begin) % 2, (p ^ half0).
  const int col = tid & 63, r0 = tid >> 6, half0 = t_begin & 1;
  int* own = stack + r0 * kLanes + col;   // + 64 half + 4 i 128 + l kCells
  int rg[2][kRows][REG > 0 ? REG : 1];     // the register stacks
  float rmax[FORM == kMaxima ? kRows : 1];   // levels = 0: column maxima

  auto reset_own = [&]() {
    if constexpr (REG > 0) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int l = 0; l < REG; ++l) rg[p][i][l] = kINT32_MIN;
    } else {
      for (int l = 0; l < levels; ++l)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            own[l * kCells + 4 * i * kLanes + 64 * h] = kINT32_MIN;
    }
  };
  if constexpr (FORM == kMaxima) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) rmax[i] = -INFINITY;
  } else {
    reset_own();
  }

  auto group_id = [&](int n0) {
    return ids == kGlobal     ? 127 - (n0 >> 7)
         : ids == kSegmented ? 127 - ((n0 % seg) >> 7)
                             : (n0 % tn) >> 7;
  };
  // This thread's packed value of row r of a score tile (first corpus row
  // n0), or INT32_MIN (inserts nothing) where n0 < 0 or its column lies
  // past the corpus.
  auto packed = [&](const float* S, int n0, int r, int id) -> int {
    if (n0 < 0 || col >= n - n0) return kINT32_MIN;
    const int bits = __float_as_int(S[r * (kTN + 1) + col]);
    const int u = posu ? bits : ordered(bits);
    return (u & ~127) | id;
  };
  // A segmented stack restarts at every seg-th column.
  auto resets = [&](int t, int n0) {
    return ids == kSegmented && t != t_begin && n0 % seg == 0;
  };
  // Tile t's scores (S) into the register stacks of parity P.
  auto insert_regs = [&](auto pc, const float* S, int n0) {
    constexpr int P = decltype(pc)::value;
    if constexpr (REG > 0) {
      const int id = group_id(n0);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        int v = packed(S, n0, r0 + 4 * i, id);
#pragma unroll
        for (int l = 0; l < REG; ++l) {
          const int s = rg[P][i][l];
          rg[P][i][l] = max(s, v);
          v = min(s, v);
        }
      }
    }
  };
  // A tile's scores (S, first corpus row n0) into the shared-memory stacks
  // of parity p.
  auto insert_shared = [&](const float* S, int n0, int p) {
    const int id = group_id(n0);
    int* cell = own + 64 * (p ^ half0);
#pragma unroll 4
    for (int i = 0; i < kRows; ++i, cell += 4 * kLanes) {
      int v = packed(S, n0, r0 + 4 * i, id);
      for (int l = 0; l < levels; ++l) {
        const int s = cell[l * kCells];
        cell[l * kCells] = max(s, v);
        v = min(s, v);
      }
    }
  };
  // Tiles a (first corpus row na) and then b (nb; -1: none) of parity p
  // into the shared-memory stacks, each level loaded and stored once;
  // fresh: the stacks restart first.
  auto insert_pair = [&](const float* Sa, int na, const float* Sb, int nb,
                         int p, bool fresh) {
    const int ida = group_id(na), idb = group_id(nb);
    int* cell = own + 64 * (p ^ half0);
#pragma unroll 4
    for (int i = 0; i < kRows; ++i, cell += 4 * kLanes) {
      int a = packed(Sa, na, r0 + 4 * i, ida);
      int b = packed(Sb, nb, r0 + 4 * i, idb);
      for (int l = 0; l < levels; ++l) {
        const int s = fresh ? kINT32_MIN : cell[l * kCells];
        const int s1 = max(s, a);
        a = min(s, a);
        cell[l * kCells] = max(s1, b);
        b = min(s1, b);
      }
    }
  };
  // levels = 0: tile t's scores (S) join this thread's column maxima of
  // the JAX tile [j tn, j tn + tn); where it or this block's range ends,
  // each row's maximum (a warp holds 32 of its 64 columns) leaves by
  // atomicMax (of order-preserving ints).  The flush is uniform across the
  // block, so its shuffles are too.
  auto take_max = [&](int t, int n0, const float* S) {
    if constexpr (FORM == kMaxima) {
      if (col < n - n0)
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          rmax[i] = fmaxf(rmax[i], S[(r0 + 4 * i) * (kTN + 1) + col]);
      if ((n0 + kTN) % tn != 0 && t != t_end - 1) return;
      const int tile = n0 / tn, n_tn = (n + tn - 1) / tn;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float v = rmax[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
        rmax[i] = -INFINITY;
        const int r = r0 + 4 * i;
        if (lane == 0 && r < rows_valid)
          atomicMax(levels_out + (size_t)(row0 + r) * n_tn + tile,
                    ordered(__float_as_int(v)));
      }
    }
  };

  if constexpr (kWg) {
    // The int4 family reads the experiment's layout: one chunk of the
    // whole row (ck = dim).  A step's tiles t0 + j are of parity j % 2
    // (steps start kWgTiles apart from t_begin).
    wg_walk<CORE, false>(
        maps, qp, cp, scale, cb, nullptr, nullptr, 0, 1, smem, St, row0, m,
        n, dim, c_ld, dim, t_begin, t_end, stages, vec,
        [&](const WgStep& step) {
          const int t0 = step.n0[0] / kTN;
          if constexpr (FORM == kMaxima) {
#pragma unroll
            for (int j = 0; j < kWgTiles; ++j)
              if (step.n0[j] >= 0)
                take_max(t0 + j, step.n0[j], St + j * TM * (kTN + 1));
          } else {
            // The step's reset, if any (at most one: seg spans 128 tiles).
            int jr = kWgTiles;
#pragma unroll
            for (int j = kWgTiles - 1; j >= 0; --j)
              if (step.n0[j] >= 0 && resets(t0 + j, step.n0[j])) jr = j;
            if constexpr (REG > 0) {
              auto take = [&](auto pc, int j) {
                if (j == jr) reset_own();
                insert_regs(pc, St + j * TM * (kTN + 1), step.n0[j]);
              };
              take(std::integral_constant<int, 0>{}, 0);
              take(std::integral_constant<int, 1>{}, 1);
              take(std::integral_constant<int, 0>{}, 2);
              take(std::integral_constant<int, 1>{}, 3);
            } else {
              // Tiles j and j + 2: the same lanes.  A reset drops the
              // stacks and the tiles before it.
              const bool fresh = jr < kWgTiles;
#pragma unroll 1
              for (int j = 0; j < 2; ++j)
                insert_pair(St + j * TM * (kTN + 1),
                            !fresh || jr <= j ? step.n0[j] : -1,
                            St + (j + 2) * TM * (kTN + 1),
                            !fresh || jr <= j + 2 ? step.n0[j + 2] : -1, j,
                            fresh);
            }
          }
        });
  } else {
    // The int4 family reads the experiment's layout: one chunk of the
    // whole row (ck = dim).
    ring_walk<TM, CORE, false>(
        qp, cp, scale, cb, nullptr, nullptr, 0, 0, smem, St, row0, m, n,
        dim, c_ld, dim, t_begin, t_end, stages, q_resident, vec,
        [&](int t, int n0) {
          if constexpr (FORM == kMaxima) {
            take_max(t, n0, St);
          } else {
            if (resets(t, n0)) reset_own();
            const int p = (t - t_begin) & 1;
            if constexpr (REG > 0) {
              if (p)
                insert_regs(std::integral_constant<int, 1>{}, St, n0);
              else
                insert_regs(std::integral_constant<int, 0>{}, St, n0);
            } else {
              insert_shared(St, n0, p);
            }
          }
        });
  }

  if constexpr (FORM != kMaxima) {
    const int last_col = min(n, t_end * kTN) - 1;
    const bool reaches = ids != kSegmented || last_col / seg == (n - 1) / seg;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int l0 = 64 * (p ^ half0) + col;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + 4 * i;
        if (r >= rows_valid) continue;
        const size_t row = (size_t)(row0 + r);
        int* dst = levels_out + (row * splits + split) * levels * kLanes + l0;
        if constexpr (REG > 0) {
#pragma unroll
          for (int l = 0; l < REG; ++l) dst[l * kLanes] = rg[p][i][l];
          if (reaches) atomicMax(out + row * kLanes + l0, rg[p][i][0]);
        } else {
          const int* cell = stack + r * kLanes + l0;
          for (int l = 0; l < levels; ++l) dst[l * kLanes] = cell[l * kCells];
          if (reaches) atomicMax(out + row * kLanes + l0, cell[0]);
        }
      }
    }
  } else {
    // The last block of this query tile to finish sums its tile maxima.
    __threadfence();
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(done + blockIdx.x, 1) == splits - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    const int n_tn = (n + tn - 1) / tn;
    for (int r = warp; r < rows_valid; r += kWarps) {
      const int* maxima = levels_out + (size_t)(row0 + r) * n_tn;
      unsigned sum = 0;   // wraps as the int32 sum of the TPU kernel
      for (int j = lane; j < n_tn; j += 32)
        sum += (unsigned)__float2int_rz(
            __int_as_float(ordered(__ldcg(maxima + j))));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int l = lane; l < kLanes; l += 32)
        out[(size_t)(row0 + r) * kLanes + l] = (int)sum;
    }
  }
}

// Calls f(TM, CORE, CONSUMER, FORM) as integral constants for a plan at
// these levels that has an instantiation, or returns -1.
template <typename F>
int dispatch(int tm, const FloorPlan& plan, int levels, F&& f) {
  // Register stacks of up to reg_max levels; a stored core takes the
  // tile-64 ring only with stacks too deep for the warpgroup consumer.
  auto by_reg = [&](auto tmc, auto cc, auto kc) -> int {
    constexpr int TM = decltype(tmc)::value, CORE = decltype(cc)::value;
    constexpr int C = decltype(kc)::value;
    constexpr bool kDeepOnly = C == kRing && TM == 64 && stored_core(CORE);
    constexpr int kMost = kDeepOnly ? 0 : reg_max(TM, CORE, C);
    if constexpr (C == kWgmma && !(TM == kWgTM && stored_core(CORE))) {
      return -1;
    } else {
      if (levels == 0) {
        if constexpr (kDeepOnly) return -1;
        else return f(tmc, cc, kc, std::integral_constant<int, kMaxima>{});
      }
      switch (plan.reg) {
        case 0: return f(tmc, cc, kc, std::integral_constant<int, kShared>{});
        case 1:
          if constexpr (kMost >= 1)
            return f(tmc, cc, kc, std::integral_constant<int, 1>{});
          else return -1;
        case 2:
          if constexpr (kMost >= 2)
            return f(tmc, cc, kc, std::integral_constant<int, 2>{});
          else return -1;
        default: return -1;
      }
    }
  };
  auto by_consumer = [&](auto tmc, auto cc) -> int {
    return plan.consumer == kWgmma
               ? by_reg(tmc, cc, std::integral_constant<int, kWgmma>{})
               : by_reg(tmc, cc, std::integral_constant<int, kRing>{});
  };
  auto by_core = [&](auto tmc) -> int {
    constexpr int TM = decltype(tmc)::value;
    switch (plan.core) {
      case kBf16x3:
        return by_consumer(tmc, std::integral_constant<int, kBf16x3>{});
      case kBf16x3W:
        if constexpr (TM == 32) return -1;
        else return by_consumer(tmc, std::integral_constant<int, kBf16x3W>{});
      case kInt8c:
        return by_consumer(tmc, std::integral_constant<int, kInt8c>{});
      case kInt4c:
        return by_consumer(tmc, std::integral_constant<int, kInt4c>{});
      case kInt4Rint:
        return by_consumer(tmc, std::integral_constant<int, kInt4Rint>{});
      case kInt4Raw:
        return by_consumer(tmc, std::integral_constant<int, kInt4Raw>{});
      default: return -1;
    }
  };
  switch (tm) {
    case 16: return by_core(std::integral_constant<int, 16>{});
    case 32: return by_core(std::integral_constant<int, 32>{});
    case 64: return by_core(std::integral_constant<int, 64>{});
    default: return -1;
  }
}

// The kernel of a plan, its shared memory set; 0 or a cudaError_t, -1
// where the plan does not fit.
template <int TM, int CORE, int CONSUMER, int REG>
int prepare(const FloorPlan& plan) {
  if (plan.ring.stages == 0 || plan.ring.bytes > kMaxSmem) return -1;
  return (int)cudaFuncSetAttribute(
      floor_stacks_kernel<TM, CORE, CONSUMER, REG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.ring.bytes);
}

inline bool valid_core(int core) {
  return core == kBf16x3 || core == kInt8c || packed_core(core);
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t after a refused launch, the
// CUresult of a tensor map that failed to encode (the warpgroup
// consumer), or -1 for arguments the kernel does not take.  qp is bf16
// (m, 2 dim) [hi | lo]; cp is bf16 (n, 2 dim) [hi | lo] for kBf16x3, int8 (n, dim) codes for
// kInt8c, int8 (n, dim / 2) bytes for the int4 family (byte j: feature j
// low, feature j + dim / 2 high); c_ld is cp's row stride in elements.
// scale is the (n,) scale row (null for kBf16x3), cb the (n,) bias row.
// out is (m, 128) int32.  levels >= 1: out set by the caller to
// INT32_MIN, levels_out (m, splits, levels, 128) int32, done unused.
// levels = 0: levels_out the (m, ceil(n / tn)) tile maxima as
// order-preserving ints, set by the caller to INT32_MIN, and done
// (ceil(m / tm),) int32 counters set to 0.  ids is an Ids rule, posu
// nonzero for the raw score bits.  Split s covers the kernel's 64-row
// tiles [s tiles_per_split, (s + 1) tiles_per_split).
int pmm_floor_stacks(const void* qp, const void* cp, const float* scale,
                     const float* cb, int* out, int* levels_out, int* done,
                     int m,
                     int n, int dim, int c_ld, int core, int levels, int tn,
                     int ids, int posu, int splits, int tiles_per_split,
                     int tm, void* stream) {
  if (m <= 0 || n <= 0 || dim <= 0 || splits <= 0 || tiles_per_split <= 0 ||
      levels < 0 || levels > kMaxLevels || tn <= 0 || tn % kLanes != 0 ||
      ids < kGlobal || ids > kTileLocal)
    return -1;
  if ((long long)splits * tiles_per_split * kTN < n) return -1;
  if (levels == 0 && done == nullptr) return -1;
  // The ids fit the low 7 bits: at most 128 global groups, tn-row tiles
  // of at most 128 groups.
  if (levels > 0 && ids == kGlobal && (n + kLanes - 1) / kLanes > kLanes)
    return -1;
  if (levels > 0 && ids != kGlobal && tn > kSegmentRows) return -1;
  if (!valid_core(core)) return -1;
  const long long want_ld = core == kBf16x3 ? 2LL * dim
                          : core == kInt8c  ? (long long)dim : dim / 2;
  if (c_ld != want_ld || (packed_core(core) && dim % 2 != 0)) return -1;
  if ((core == kBf16x3) != (scale == nullptr)) return -1;
  const int seg = tn <= kSegmentRows ? kSegmentRows / tn * tn : tn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FloorPlan plan = floor_plan(tm, core, levels, c_ld);
  return dispatch(tm, plan, levels, [&](auto tmc, auto cc, auto kc,
                                        auto rc) {
    constexpr int TM = decltype(tmc)::value, CORE = decltype(cc)::value;
    constexpr int C = decltype(kc)::value, REG = decltype(rc)::value;
    const int err = prepare<TM, CORE, C, REG>(plan);
    if (err != 0) return err;
    const size_t row_bytes = (size_t)c_ld * ring_elem_bytes(CORE);
    const bool vec = ring_aligned(qp, cp, dim, row_bytes);
    WgMaps maps{};   // read by the warpgroup consumer's loads only
    if (C == kWgmma && vec) {
      const int rc = wg_maps(maps, CORE, qp, cp, m, n, dim, row_bytes);
      if (rc != 0) return rc;
    }
    dim3 grid((m + TM - 1) / TM, splits);
    floor_stacks_kernel<TM, CORE, C, REG>
        <<<grid, kThreads, plan.ring.bytes, s>>>(
            maps, static_cast<const uint16_t*>(qp), cp, scale, cb, out,
            levels_out, done, m, n, dim, c_ld, levels, tn, ids, seg,
            posu != 0, splits, tiles_per_split, vec, plan.ring.stages,
            plan.ring.q_resident);
    return (int)cudaGetLastError();
  });
}

// Blocks of the (tm, core, levels) launch that one SM of the current
// device holds at corpus row stride c_ld (pmm_floor_stacks's); negative on
// an error, -1 for arguments it does not take.
int pmm_floor_blocks_per_sm(int tm, int core, int levels, int c_ld) {
  if (levels < 0 || levels > kMaxLevels || c_ld <= 0 || !valid_core(core))
    return -1;
  const FloorPlan plan = floor_plan(tm, core, levels, c_ld);
  return dispatch(tm, plan, levels, [&](auto tmc, auto cc, auto kc,
                                        auto rc) {
    constexpr int TM = decltype(tmc)::value, CORE = decltype(cc)::value;
    constexpr int C = decltype(kc)::value, REG = decltype(rc)::value;
    const int err = prepare<TM, CORE, C, REG>(plan);
    if (err != 0) return err > 0 ? -err : err;
    int blocks = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, floor_stacks_kernel<TM, CORE, C, REG>, kThreads,
        plan.ring.bytes);
    return e == cudaSuccess ? blocks : -(int)e;
  });
}

// The (tm, core, levels) launch's plan at corpus row stride c_ld into
// out[7]: consumer (Consumer), the core its ring streams (Core), stages,
// bytes a stage, query resident (0 / 1), shared memory, levels in
// registers.  Returns 0, or -1 where nothing fits or for arguments the
// kernel does not take.
int pmm_floor_plan(int tm, int core, int levels, int c_ld, int* out) {
  if (levels < 0 || levels > kMaxLevels || c_ld <= 0 || !valid_core(core) ||
      (tm != 16 && tm != 32 && tm != 64))
    return -1;
  const FloorPlan plan = floor_plan(tm, core, levels, c_ld);
  out[0] = plan.consumer;
  out[1] = plan.core;
  out[2] = plan.ring.stages;
  out[3] = (int)(plan.consumer == kWgmma
                     ? wg_stage_bytes(plan.core)
                     : ring_stage_bytes(tm, plan.core, plan.ring.q_resident));
  out[4] = plan.ring.q_resident ? 1 : 0;
  out[5] = (int)plan.ring.bytes;
  out[6] = plan.reg;
  return plan.ring.stages > 0 ? 0 : -1;
}

}  // extern "C"
