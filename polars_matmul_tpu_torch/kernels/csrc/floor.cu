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
// functions (tile_scores.cuh), the same staging, the same epilogue.
// levels = 0: out[r, :] = the sum over tn-wide corpus tiles of
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
// so one id serves the whole tile, and it covers half of the 128 lanes:
// each thread takes cells (row, column) of the tile, one score per cell,
// and runs the whole chain for it on the stacks in shared memory
// ([level][row][lane]: TM x 128 x L ints, 160 KB at TM = 64 and L = 5, so
// occupancy falls as L grows; the wrapper narrows the query tile where
// they would not fit).  The splits combine exactly and in any order: int32
// atomicMax of level 0 into out (only splits that reach the last segment,
// when segmented), and every split writes its stacks to levels_out, so
// that no level can be elided and each can be checked.  levels = 0 keeps
// kernel A's splits too, although they need not cut on tn-row tiles: a
// block flushes the partial maximum of each tn-row tile it ends with
// atomicMax (of order-preserving ints) into levels_out, (m, tiles), and
// the last block of a query tile to finish (a counter per query tile)
// sums that tile's rows.
//
// What bounds it on the H100: the bytes of the corpus (int8 and int4 at
// batch 8) or the bf16 products (batch 256, the bf16x3 floor at 1024
// queries), as for kernel A, plus, for levels >= 1, the selection: about
// 2 L + 5 integer operations and L shared-memory loads and stores a score.
// The design keeps kernel A's staging as it is, so that kernel A minus
// kernel D at levels = 0 is kernel A's selection cost, and D at L minus D
// at levels = 0 is what an L-level stack selection would cost instead.

#include "tile_scores.cuh"

#include <type_traits>

namespace {

constexpr int kLanes = 128;
constexpr int kINT32_MIN = -2147483647 - 1;
constexpr int kMaxLevels = 16;
constexpr int kSegmentRows = kLanes * kLanes;   // 16,384
constexpr size_t kMaxSmem = 232448;             // a block's dynamic limit

// The group-id rules, in the order of kernels/floor.py's IDS.
enum Ids : int { kGlobal = 0, kSegmented = 1, kTileLocal = 2 };

// Shared memory: the operand tiles, the score tile, then the stacks
// (levels >= 1) or each row's running tile max (levels = 0).
__host__ __device__ inline size_t floor_smem_bytes(int tm, int core,
                                                   int levels) {
  const size_t work = levels > 0
      ? (size_t)levels * tm * kLanes * sizeof(int)
      : (size_t)tm * sizeof(float);
  return operand_bytes(tm, core) + (size_t)tm * (kTN + 1) * sizeof(float)
       + work;
}

// The order-preserving int of f32 bits, and back (an involution).
__device__ inline int ordered(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

template <int TM, int CORE>
__global__ void __launch_bounds__(kThreads)
floor_stacks_kernel(const uint16_t* __restrict__ qp,
                    const void* __restrict__ cp,
                    const float* __restrict__ scale,
                    const float* __restrict__ cb, int* __restrict__ out,
                    int* __restrict__ levels_out, int* __restrict__ done,
                    int m, int n, int dim,
                    int c_ld, int levels, int tn, int ids, int seg,
                    bool posu, int splits, int tiles_per_split, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* St = reinterpret_cast<float*>(smem + operand_bytes(TM, CORE));
  int* stack = reinterpret_cast<int*>(St + TM * (kTN + 1));
  float* tile_max = reinterpret_cast<float*>(stack);   // levels = 0
  __shared__ bool last_block;
  constexpr int kCells = TM * kLanes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TM;
  const int rows_valid = min(TM, m - row0);
  const int split = blockIdx.y;
  const int n_tiles = (n + kTN - 1) / kTN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if (levels > 0) {
    for (int e = tid; e < levels * kCells; e += kThreads)
      stack[e] = kINT32_MIN;
  } else {
    for (int r = tid; r < TM; r += kThreads) tile_max[r] = -INFINITY;
  }
  // The score functions synchronise before they return, so these writes
  // (and a segment's reset below) are seen by every thread in time.

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * kTN;
    if (levels > 0 && ids == kSegmented && t != t_begin && n0 % seg == 0) {
      for (int e = tid; e < levels * kCells; e += kThreads)
        stack[e] = kINT32_MIN;
    }
    if constexpr (CORE == kBf16x3) {
      uint16_t* Qh = reinterpret_cast<uint16_t*>(smem);
      uint16_t* Ql = Qh + TM * kBKP;
      uint16_t* Ch = Ql + TM * kBKP;
      uint16_t* Cl = Ch + kTN * kBKP;
      scores_bf16x3<TM>(qp, static_cast<const uint16_t*>(cp), cb, nullptr,
                        Qh, Ql, Ch, Cl, St, row0, n0, m, n, dim, vec);
    } else {
      constexpr int BKP = stored_bk(TM) + 8;
      uint16_t* Qh = reinterpret_cast<uint16_t*>(smem);
      uint16_t* Ql = Qh + TM * BKP;
      uint16_t* Cs = Ql + TM * BKP;
      // The int4 family reads the experiment's layout: one chunk of the
      // whole row (ck = dim).
      scores_stored<TM, CORE>(qp, cp, scale, cb, nullptr, Qh, Ql, Cs, St,
                              row0, n0, m, n, dim, (size_t)c_ld, dim, vec);
    }
    __syncthreads();
    const int cols = min(kTN, n - n0);
    if (levels > 0) {
      const int id = ids == kGlobal     ? 127 - (n0 >> 7)
                   : ids == kSegmented ? 127 - ((n0 % seg) >> 7)
                                       : (n0 % tn) >> 7;
      int* base = stack + (n0 & (kLanes - 1));
      for (int e = tid; e < rows_valid * kTN; e += kThreads) {
        const int r = e / kTN, c = e % kTN;
        if (c >= cols) continue;
        const int bits = __float_as_int(St[r * (kTN + 1) + c]);
        const int u = posu ? bits : ordered(bits);
        int p = (u & ~127) | id;
        int* cell = base + r * kLanes + c;
        for (int i = 0; i < levels; ++i) {
          const int s = cell[i * kCells];
          cell[i * kCells] = max(s, p);
          p = min(s, p);
        }
      }
    } else {
      // The row maxima join those of the JAX tile [j tn, j tn + tn); its
      // partial maxima leave where it or this block's range ends.
      const bool flush = (n0 + kTN) % tn == 0 || t == t_end - 1;
      const int tile = n0 / tn, n_tn = (n + tn - 1) / tn;
      for (int r = warp; r < rows_valid; r += kWarps) {
        const float* row = St + r * (kTN + 1);
        float v = fmaxf(lane < cols ? row[lane] : -INFINITY,
                        32 + lane < cols ? row[32 + lane] : -INFINITY);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
        if (lane == 0) {
          const float mx = fmaxf(tile_max[r], v);
          tile_max[r] = flush ? -INFINITY : mx;
          if (flush)
            atomicMax(levels_out + (size_t)(row0 + r) * n_tn + tile,
                      ordered(__float_as_int(mx)));
        }
      }
    }
    __syncthreads();
  }

  if (levels > 0) {
    const int last_col = min(n, t_end * kTN) - 1;
    const bool reaches = ids != kSegmented || last_col / seg == (n - 1) / seg;
    for (int e = tid; e < rows_valid * levels * kLanes; e += kThreads) {
      const int r = e / (levels * kLanes);
      const int i = (e / kLanes) % levels, l = e % kLanes;
      const int v = stack[i * kCells + r * kLanes + l];
      const size_t row = (size_t)(row0 + r);
      levels_out[((row * splits + split) * levels + i) * kLanes + l] = v;
      if (i == 0 && reaches) atomicMax(out + row * kLanes + l, v);
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

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <int TM, int CORE>
int launch(const void* qp, const void* cp, const float* scale,
           const float* cb, int* out, int* levels_out, int* done, int m,
           int n,
           int dim, int c_ld, int levels, int tn, int ids, int seg,
           bool posu, int splits, int tiles_per_split, cudaStream_t stream) {
  const size_t bytes = floor_smem_bytes(TM, CORE, levels);
  if (bytes > kMaxSmem) return -1;
  auto kern = floor_stacks_kernel<TM, CORE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // Vector loads: 16 bytes of bf16, 8 bytes of int8 codes or packed bytes
  // (whole 8-byte runs a nibble half: dim / 2 a multiple of 8).
  const uintptr_t c_align = CORE == kBf16x3 ? 16 : 8;
  const bool vec = dim % 8 == 0 && (!packed_core(CORE) || dim % 16 == 0) &&
                   aligned(qp, 16) && aligned(cp, c_align);
  dim3 grid((m + TM - 1) / TM, splits);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const uint16_t*>(qp), cp, scale, cb, out, levels_out, done,
      m, n, dim, c_ld, levels, tn, ids, seg, posu, splits, tiles_per_split,
      vec);
  return (int)cudaGetLastError();
}

// Blocks of kernel<TM, CORE> one SM holds at these levels, or a negative
// cudaError_t (-1 where the shared memory cannot fit).
template <int TM, int CORE>
int occupancy(int levels) {
  const size_t bytes = floor_smem_bytes(TM, CORE, levels);
  if (bytes > kMaxSmem) return -1;
  auto kern = floor_stacks_kernel<TM, CORE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      kThreads, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Calls f(TM, CORE) with both as integral constants, or returns -1.
template <typename F>
int dispatch(int tm, int core, F&& f) {
  auto by_core = [&](auto tmc) -> int {
    switch (core) {
      case kBf16x3: return f(tmc, std::integral_constant<int, kBf16x3>{});
      case kInt8c: return f(tmc, std::integral_constant<int, kInt8c>{});
      case kInt4c: return f(tmc, std::integral_constant<int, kInt4c>{});
      case kInt4Rint:
        return f(tmc, std::integral_constant<int, kInt4Rint>{});
      case kInt4Raw: return f(tmc, std::integral_constant<int, kInt4Raw>{});
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

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t after a refused launch, or -1 for
// arguments the kernel does not take.  qp is bf16 (m, 2 dim) [hi | lo];
// cp is bf16 (n, 2 dim) [hi | lo] for kBf16x3, int8 (n, dim) codes for
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
  if (core != kBf16x3 && core != kInt8c && !packed_core(core)) return -1;
  const long long want_ld = core == kBf16x3 ? 2LL * dim
                          : core == kInt8c  ? (long long)dim : dim / 2;
  if (c_ld != want_ld || (packed_core(core) && dim % 2 != 0)) return -1;
  if ((core == kBf16x3) != (scale == nullptr)) return -1;
  const int seg = tn <= kSegmentRows ? kSegmentRows / tn * tn : tn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(tm, core, [&](auto tmc, auto cc) {
    return launch<decltype(tmc)::value, decltype(cc)::value>(
        qp, cp, scale, cb, out, levels_out, done, m, n, dim, c_ld, levels, tn,
        ids, seg, posu != 0, splits, tiles_per_split, s);
  });
}

// Blocks of the (tm, core) kernel that one SM of the current device holds
// at these levels; negative on an error, -1 for arguments it does not
// take.
int pmm_floor_blocks_per_sm(int tm, int core, int levels) {
  if (levels < 0 || levels > kMaxLevels) return -1;
  return dispatch(tm, core, [&](auto tmc, auto cc) {
    return occupancy<decltype(tmc)::value, decltype(cc)::value>(levels);
  });
}

}  // extern "C"
