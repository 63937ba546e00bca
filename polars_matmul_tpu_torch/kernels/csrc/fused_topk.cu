// Kernel A: fused Q.C^T -> metric epilogue -> per-split running top-k.
//
// Replaces polars_matmul_tpu/kernels/fused_topk.py::_kernel (the dense-grid
// pallas_call at fused_topk.py:2177) in five cores: "bf16x3" (three bf16
// products, f32 accumulation, fused_topk.py:1258-1270), "highest" (f32,
// :1294-1295), and the quantized-storage cores "bf16c", "int8c" and
// "int4c" (:1271-1293) with their scale | bias epilogue (:1301-1314);
// then the mask by select and the running top-k carry with lowest-index
// ties.  The TPU's gpop/gstack/extract selections all return this exact
// top-k; kernel A plus kernel B (topk_merge.cu) compute it directly.
//
// What changes from the TPU: the TPU walks the corpus axis of its grid in
// order on one core and carries the top-k in VMEM across grid steps.  Here
// blocks run in parallel, so the corpus is cut into `splits` ranges.  Block
// (x, y) owns query rows [x*TM, x*TM+TM) and corpus split y; it walks its
// range tile by tile (TN rows each), keeps a sorted (value desc, index asc)
// carry of k entries per query row in shared memory, and writes that
// carry to partial[m][splits][k].  Kernel B merges the splits.  The
// (m, n) score matrix never leaves the chip: a block holds one TM x TN
// score tile in shared memory at a time.
//
// Probed search (the same _kernel through PrefetchScalarGridSpec at
// fused_topk.py:2162, use_tiles=True): the TPU's index maps read corpus
// block tiles[i, j] at grid step (i, j), so unlisted tiles never leave
// HBM.  Here a block reads the list of its query rows (list row
// row0 / block_rows) and walks list positions instead of corpus tiles:
// position t is kernel tile tiles[b][t / tn_tiles] * tn_tiles +
// t % tn_tiles, read once per tile outside the product's loops, and the
// splits cut the p * tn listed rows.  Everything else is the dense walk.
// The list is ascending, so each split still covers ascending rows and
// kernel B's lowest-index ties hold unchanged.  A probed request reads
// only the listed rows (p / n_tiles of the corpus bytes per list); the
// rows are contiguous runs of tn, so the loads are the dense walk's.
//
// The two cores:
// - "bf16x3" runs on the tensor cores: mma.sync m16n8k16 bf16 with an f32
//   accumulator, three products per tile (qh.ch, qh.cl, ql.ch), the
//   counterpart of the TPU's three bf16 MXU passes.  Products of bf16
//   values are exact in f32; hh and (hl + lh) accumulate apart and are
//   summed last, the grouping of the TPU kernel.  Warp w owns corpus
//   columns [8w, 8w+8) of the tile for every query row of the block.
// - "highest" runs on CUDA cores: f32 FMA on a (TM/16) x 4 register
//   micro-tile per thread.  TF32 would not hold f32 semantics.
// - "bf16c", "int8c", "int4c": the corpus is stored as one bf16 half,
//   int8 codes, or int8 bytes of two signed nibbles.  Staging converts it
//   to a bf16 tile in shared memory (integers up to 256 are exact in
//   bf16), and two mma.sync per k-step give qh.c and ql.c in two
//   accumulators, summed last (the grouping of fused_topk.py:1292-1293).
//   int8c / int4c then compute s = d * scale + bias with the scale and
//   bias rows of the (2, n) operand (scale = 1/|codes| for cosine, the
//   dequant scale otherwise), rounded as two separate operations, not one
//   FMA, so the plain PyTorch version gives the same bits; bf16c adds the
//   bias row.  int4 layout (quantize_int4): in each ck-wide feature chunk,
//   byte j holds feature j (low nibble) and feature j + ck/2 (high).  ck
//   is a multiple of 128, so 8 features from a multiple of 8 are one
//   nibble half of 8 consecutive bytes: one 8-byte load.  Corpus rows are
//   not padded: int8 codes are dim bytes a row, int4 rows dpp/2 bytes
//   (dpp = dim padded as feature_geometry says, the padding nibbles
//   zero).
//
// What bounds it on the H100: at the 1000 x 10000 x 256 canonical shape
// the bf16x3 product is 7.7 G multiply-adds, about 0.02 ms of bf16 tensor
// core time at the published peak, so the product is not the limit; the
// tile loads (16-byte loads where dim % 8 == 0, but no cp.async or TMA
// pipeline yet) and the selection are.  The selection looks only at the
// tile scores that beat the row's current k-th value (strict >, so a later
// index never displaces an equal earlier one), which after the first tiles
// of a split is a small fraction of them.  A few are inserted one by one,
// each a warp-wide count and shift of the sorted carry; many (the first
// tiles of a split) are sorted in the warp and merged into the carry in
// one pass.  "highest" is bound by the f32 FMA rate (67 TFLOP/s peak).
//
// The quantized cores serve corpora too large for f32.  At the 10M x 768
// north-star shape a batch-8 int8 request must read 7.68 GB of codes plus
// 80 MB of scale | bias: 2.3 ms of HBM at 3.35 TB/s, so the loads bound it
// and storing fewer bits is the design's answer (a quarter of f32's
// bytes, an eighth for int4).  The loads are plain 8- or 16-byte loads
// (where dim % 8 == 0), converted to bf16 in registers on the way into
// shared memory, with no cp.async or TMA pipeline yet: each step waits
// for its loads, so the bytes a step stages set the rate, and the stored
// cores stage 128 features a step (64 for the 64-row query tile), with
// all of a thread's loads issued before any is used.  At batch 256 the
// two bf16 products (7.9 TFLOP) bound it: each 64-row query tile reads
// the corpus again, which L2 does not hold.
//
// Ragged edges: query rows >= m, corpus rows >= n and features >= dim are
// handled by the kernel's own bounds; nothing needs padding.  A carry slot
// that nothing filled holds (-inf, INT32_MAX).
//
// The staging and score-tile functions (the tensor-core cores, the
// epilogue, the int4 layout) live in tile_scores.cuh, shared with kernel
// D (floor.cu), which measures them without the selection.

#include "tile_scores.cuh"

#include <type_traits>

namespace {

constexpr int kINT32_MAX = 0x7fffffff;

__host__ __device__ inline size_t smem_bytes(int tm, int k, int core) {
  return operand_bytes(tm, core)
       + (size_t)tm * (kTN + 1) * sizeof(float)              // score tile
       + 2 * (size_t)tm * k * sizeof(float)                  // carry
       + 2 * (size_t)kWarps * kTN * sizeof(float);           // merge lists
}

// Insert (v, id) into the sorted carry row (value desc, index asc) of
// length k.  Every entry already there has a lower index, so v goes after
// the entries >= v.  Caller guarantees v > cv[k-1].  Whole warp calls.
__device__ inline void carry_insert(float* cv, int* ci, int k, float v,
                                    int id, int lane) {
  int cnt = 0;
  for (int j = lane; j < k; j += 32) cnt += (cv[j] >= v) ? 1 : 0;
  const int pos = __reduce_add_sync(0xffffffffu, cnt);
  // Shift [pos, k-2] up by one, highest block of 32 first: each block is
  // read completely before it is written, and the one element it writes
  // past its end was already moved by the block above.
  for (int base = ((k - 2) / 32) * 32; base >= 0 && base + 31 >= pos;
       base -= 32) {
    const int j = base + lane;
    const bool mv = j >= pos && j <= k - 2;
    float tv = 0.f;
    int ti = 0;
    if (mv) { tv = cv[j]; ti = ci[j]; }
    __syncwarp();
    if (mv) { cv[j + 1] = tv; ci[j + 1] = ti; }
    __syncwarp();
  }
  if (lane == 0) { cv[pos] = v; ci[pos] = id; }
  __syncwarp();
}

__device__ inline bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Sort 64 (value, index) pairs, element lane in (v0, i0) and element
// 32 + lane in (v1, i1), best first: a bitonic network over the warp.
__device__ inline void warp_sort64(float& v0, int& i0, float& v1, int& i1,
                                   int lane) {
#pragma unroll 1
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {   // size 64: element lane against 32 + lane
        if (better(v1, i1, v0, i0)) {
          const float tv = v0; v0 = v1; v1 = tv;
          const int ti = i0; i0 = i1; i1 = ti;
        }
        continue;
      }
      const bool lower = (lane & stride) == 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& v = r ? v1 : v0;
        int& i = r ? i1 : i0;
        const bool up = ((r * 32 + lane) & size) == 0;
        const float pv = __shfl_xor_sync(0xffffffffu, v, stride);
        const int pi = __shfl_xor_sync(0xffffffffu, i, stride);
        if (better(v, i, pv, pi) != (lower == up)) { v = pv; i = pi; }
      }
    }
  }
}

// Number of carry entries >= v (the carry is sorted descending).
__device__ inline int count_ge(const float* cv, int k, float v) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cv[mid] >= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Number of list entries > v (the list is sorted descending).
__device__ inline int count_gt(const float* lv, int cnt, float v) {
  int lo = 0, hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lv[mid] > v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merge many candidates of one tile row at once: sort them, then place
// every carry entry and every candidate at its merged position (carry
// entries win ties: their indices are lower).  Entries pushed to k or
// beyond drop out.  Whole warp calls; lv/li are the warp's 64-entry lists.
// Out of line: its registers stay out of the product's budget.
__device__ __noinline__ void carry_merge(float* cv, int* ci, int k, float s0,
                                   float s1, bool c0, bool c1, int cnt,
                                   int n0, int lane, float* lv, int* li) {
  float v0 = c0 ? s0 : -INFINITY, v1 = c1 ? s1 : -INFINITY;
  int i0 = c0 ? n0 + lane : kINT32_MAX, i1 = c1 ? n0 + 32 + lane : kINT32_MAX;
  warp_sort64(v0, i0, v1, i1, lane);
  lv[lane] = v0; li[lane] = i0;
  lv[32 + lane] = v1; li[32 + lane] = i1;
  __syncwarp();
  // Candidate positions against the carry as it is before the merge.
  const int np0 = lane < cnt ? lane + count_ge(cv, k, v0) : k;
  const int np1 = 32 + lane < cnt ? 32 + lane + count_ge(cv, k, v1) : k;
  // Carry entries only move up: highest block of 32 first, each block
  // read completely before it is written.
  for (int base = ((k - 1) / 32) * 32; base >= 0; base -= 32) {
    const int p = base + lane;
    float v = 0.f;
    int id = 0, np = k;
    if (p < k) { v = cv[p]; id = ci[p]; np = p + count_gt(lv, cnt, v); }
    __syncwarp();
    if (np < k) { cv[np] = v; ci[np] = id; }
    __syncwarp();
  }
  if (np0 < k) { cv[np0] = v0; ci[np0] = i0; }
  if (np1 < k) { cv[np1] = v1; ci[np1] = i1; }
  __syncwarp();
}

// Merge one TM x TN score tile into the carries: one warp per query row.
// Few candidates (scores above the row's k-th value) are inserted one by
// one in index order; many are merged at once (carry_merge), which costs
// a sort of the 64 plus one pass over the carry.
template <int TM>
__device__ inline void select_tile(const float* St, float* Cv, int* Ci,
                                   float* lv, int* li, int k, int n0,
                                   int rows_valid, int warp, int lane) {
  const int k_blocks = (k + 31) / 32;
  for (int r = warp; r < rows_valid; r += kWarps) {
    float* cv = Cv + (size_t)r * k;
    int* ci = Ci + (size_t)r * k;
    const float s0 = St[r * (kTN + 1) + lane];
    const float s1 = St[r * (kTN + 1) + 32 + lane];
    const float kth = cv[k - 1];
    const bool c0 = s0 > kth, c1 = s1 > kth;
    const int cnt = __popc(__ballot_sync(0xffffffffu, c0)) +
                    __popc(__ballot_sync(0xffffffffu, c1));
    if (cnt * k_blocks > 32) {
      carry_merge(cv, ci, k, s0, s1, c0, c1, cnt, n0, lane, lv, li);
      continue;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float s = half ? s1 : s0;
      unsigned bal = __ballot_sync(0xffffffffu, s > cv[k - 1]);
      while (bal) {
        const int src = __ffs(bal) - 1;
        const float v = __shfl_sync(0xffffffffu, s, src);
        carry_insert(cv, ci, k, v, n0 + 32 * half + src, lane);
        // Later lanes have higher indices; drop those the raised k-th
        // value now beats or ties.
        bal &= ~((2u << src) - 1u);
        bal &= __ballot_sync(0xffffffffu, s > cv[k - 1]);
      }
    }
  }
}

// Score tile of the f32 core into St (epilogue applied).
template <int TM>
__device__ inline void scores_f32(const float* __restrict__ q,
                                  const float* __restrict__ c,
                                  const float* __restrict__ cb,
                                  const uint8_t* __restrict__ mask,
                                  float* Qs, float* Cs, float* St, int row0,
                                  int n0, int m, int n, int dim) {
  constexpr int RM = TM / 16;   // query rows per thread
  const int tid = threadIdx.x;
  const int tx = tid & 15;      // corpus columns tx + 16 j
  const int ty = tid >> 4;      // query rows ty + 16 i
  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < dim; k0 += kBK) {
    for (int e = tid; e < TM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      Qs[r * kBK + kk] = (gr < m && gk < dim) ? q[(size_t)gr * dim + gk]
                                              : 0.f;
    }
    for (int e = tid; e < kTN * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int gn = n0 + r, gk = k0 + kk;
      Cs[r * (kBK + 1) + kk] = (gn < n && gk < dim)
                                   ? c[(size_t)gn * dim + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float qv[RM], cv[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty + 16 * i) * kBK + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) cv[j] = Cs[(tx + 16 * j) * (kBK + 1) + kk];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      St[(ty + 16 * i) * (kTN + 1) + col] =
          epilogue(acc[i][j], n0 + col, n, nullptr, cb, mask);
    }
}

// LISTED instantiates the probed walk apart from the dense one: sharing one
// instantiation moved the dense cores' register allocation and slowed
// some of them by up to 13 % on the H100 (PERF.md).
template <int TM, int CORE, bool LISTED>
__global__ void __launch_bounds__(kThreads)
fused_topk_partial_kernel(const void* __restrict__ qp,
                          const void* __restrict__ cp,
                          const float* __restrict__ scale,
                          const float* __restrict__ cb,
                          const uint8_t* __restrict__ mask,
                          const int* __restrict__ tiles,
                          float* __restrict__ part_v,
                          int* __restrict__ part_i,
                          int m, int n, int dim, int c_ld, int ck, int k,
                          int splits, int tiles_per_split, int p,
                          int tn_tiles, int block_rows, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* St = reinterpret_cast<float*>(smem + operand_bytes(TM, CORE));
  float* Cv = St + TM * (kTN + 1);
  int* Ci = reinterpret_cast<int*>(Cv + (size_t)TM * k);
  float* Lv = reinterpret_cast<float*>(Ci + (size_t)TM * k);
  int* Li = reinterpret_cast<int*>(Lv + kWarps * kTN);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TM;
  const int rows_valid = min(TM, m - row0);
  const int split = blockIdx.y;
  // Dense: kernel tile t is corpus rows [64 t, 64 t + 64).  Listed: t is a
  // position in this query block's list, tn_tiles kernel tiles per layout
  // tile, and the layout tile comes from the list (read once per tile,
  // outside the product's loops).
  const int* list = LISTED ? tiles + (size_t)(row0 / block_rows) * p
                           : nullptr;
  const int n_tiles = LISTED ? p * tn_tiles : (n + kTN - 1) / kTN;
  const int layout_tiles =
      LISTED ? (n + tn_tiles * kTN - 1) / (tn_tiles * kTN) : 0;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  for (int e = tid; e < TM * k; e += kThreads) {
    Cv[e] = -INFINITY;
    Ci[e] = kINT32_MAX;
  }

  for (int t = t_begin; t < t_end; ++t) {
    int kt = t;
    if constexpr (LISTED) {
      const int lt = list[t / tn_tiles];
      // An id outside the corpus names no rows (never read out of bounds).
      if (lt < 0 || lt >= layout_tiles) continue;
      kt = lt * tn_tiles + t % tn_tiles;
    }
    const int n0 = kt * kTN;
    if constexpr (CORE == kBf16x3) {
      uint16_t* Qh = reinterpret_cast<uint16_t*>(smem);
      uint16_t* Ql = Qh + TM * kBKP;
      uint16_t* Ch = Ql + TM * kBKP;
      uint16_t* Cl = Ch + kTN * kBKP;
      scores_bf16x3<TM>(static_cast<const uint16_t*>(qp),
                        static_cast<const uint16_t*>(cp), cb, mask, Qh, Ql,
                        Ch, Cl, St, row0, n0, m, n, dim, vec);
    } else if constexpr (CORE == kHighest) {
      float* Qs = reinterpret_cast<float*>(smem);
      float* Cs = Qs + TM * kBK;
      scores_f32<TM>(static_cast<const float*>(qp),
                     static_cast<const float*>(cp), cb, mask, Qs, Cs, St,
                     row0, n0, m, n, dim);
    } else {
      constexpr int BKP = stored_bk(TM) + 8;
      uint16_t* Qh = reinterpret_cast<uint16_t*>(smem);
      uint16_t* Ql = Qh + TM * BKP;
      uint16_t* Cs = Ql + TM * BKP;
      scores_stored<TM, CORE>(static_cast<const uint16_t*>(qp), cp, scale,
                              cb, mask, Qh, Ql, Cs, St, row0, n0, m, n, dim,
                              (size_t)c_ld, ck, vec);
    }
    __syncthreads();
    select_tile<TM>(St, Cv, Ci, Lv + warp * kTN, Li + warp * kTN, k, n0,
                    rows_valid, warp, lane);
    __syncthreads();
  }

  for (int e = tid; e < rows_valid * k; e += kThreads) {
    const int r = e / k, j = e % k;
    const size_t o = ((size_t)(row0 + r) * splits + split) * k + j;
    part_v[o] = Cv[e];
    part_i[o] = Ci[e];
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <int TM, int CORE, bool LISTED>
int launch(const void* qp, const void* cp, const float* scale,
           const float* cb, const uint8_t* mask, const int* tiles,
           float* part_v, int* part_i, int m, int n, int dim, int c_ld,
           int ck, int k, int splits, int tiles_per_split, int p,
           int tn_tiles, int block_rows, cudaStream_t stream) {
  const size_t bytes = smem_bytes(TM, k, CORE);
  auto kern = fused_topk_partial_kernel<TM, CORE, LISTED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // Vector loads: 16 bytes of bf16, 8 bytes of int8 codes or packed
  // nibbles.
  const uintptr_t c_align = (CORE == kInt8c || CORE == kInt4c) ? 8 : 16;
  const bool vec = CORE != kHighest && dim % 8 == 0 && aligned(qp, 16) &&
                   aligned(cp, c_align);
  dim3 grid((m + TM - 1) / TM, splits);
  kern<<<grid, kThreads, bytes, stream>>>(
      qp, cp, scale, cb, mask, tiles, part_v, part_i, m, n, dim, c_ld, ck, k,
      splits, tiles_per_split, p, tn_tiles, block_rows, vec);
  return (int)cudaGetLastError();
}

// Blocks of kernel<TM, CORE, LISTED> one SM holds at this k (its registers
// and shared memory), or a negative cudaError_t.
template <int TM, int CORE, bool LISTED>
int occupancy(int k) {
  const size_t bytes = smem_bytes(TM, k, CORE);
  auto kern = fused_topk_partial_kernel<TM, CORE, LISTED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      kThreads, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Calls f(TM, CORE, LISTED) with all three as integral constants, or
// returns -1.
template <typename F>
int dispatch(int tm, int core, bool listed, F&& f) {
  auto by_listed = [&](auto tmc, auto cc) -> int {
    return listed ? f(tmc, cc, std::true_type{})
                  : f(tmc, cc, std::false_type{});
  };
  auto by_core = [&](auto tmc) -> int {
    switch (core) {
      case kHighest:
        return by_listed(tmc, std::integral_constant<int, kHighest>{});
      case kBf16x3:
        return by_listed(tmc, std::integral_constant<int, kBf16x3>{});
      case kBf16c: return by_listed(tmc, std::integral_constant<int, kBf16c>{});
      case kInt8c: return by_listed(tmc, std::integral_constant<int, kInt8c>{});
      case kInt4c: return by_listed(tmc, std::integral_constant<int, kInt4c>{});
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
// arguments the kernel does not take.  core is a Core: qp is f32 (rows,
// dim) for kHighest and bf16 (rows, 2*dim) [hi | lo] otherwise; cp is
// f32 (rows, dim), bf16 (rows, 2*dim) [hi | lo] for kBf16x3, bf16 (rows,
// dim) for kBf16c, int8 (rows, dim) for kInt8c, int8 (rows, c_ld) packed
// nibbles for kInt4c, with c_ld its row stride and ck its feature chunk.
// scale is the (n,) scale row for kInt8c / kInt4c and null otherwise; cb
// the (n,) bias row; mask may be null.
//
// tiles, if not null, is the probed search's (n_lists, p) int32 list of
// layout tiles of tn rows (tn a multiple of 64): query row r walks the
// tiles of list row r / block_rows, in list order, and the splits cut the
// p * tn listed rows.  Every query row must be on a list, and with more
// than one list, block_rows must be a whole number of tm-row tiles.
int pmm_fused_topk_partial(const void* qp, const void* cp, const float* scale,
                           const float* cb, const uint8_t* mask,
                           const int* tiles, float* part_v, int* part_i,
                           int m, int n, int dim, int c_ld, int ck, int k,
                           int splits, int tiles_per_split, int tm, int core,
                           int n_lists, int p, int tn, int block_rows,
                           void* stream) {
  if (m <= 0 || n <= 0 || dim <= 0 || k <= 0 || splits <= 0 ||
      tiles_per_split <= 0)
    return -1;
  long long rows = n;
  if (tiles != nullptr) {
    if (n_lists <= 0 || p <= 0 || tn <= 0 || tn % kTN != 0 ||
        block_rows <= 0 || (long long)n_lists * block_rows < m ||
        (n_lists > 1 && block_rows % tm != 0))
      return -1;
    rows = (long long)p * tn;
  }
  if ((long long)splits * tiles_per_split * kTN < rows) return -1;
  const bool quant = core == kInt8c || core == kInt4c;
  if (quant != (scale != nullptr)) return -1;
  if (core == kInt4c &&
      (ck <= 0 || ck % 128 != 0 || 2LL * c_ld < dim || c_ld % (ck / 2) != 0))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(tm, core, tiles != nullptr, [&](auto tmc, auto cc,
                                                  auto lc) {
    return launch<decltype(tmc)::value, decltype(cc)::value,
                  decltype(lc)::value>(
        qp, cp, scale, cb, mask, tiles, part_v, part_i, m, n, dim, c_ld, ck,
        k, splits, tiles_per_split, p, tiles != nullptr ? tn / kTN : 0,
        block_rows, s);
  });
}

// Blocks of the (tm, core, listed) kernel that one SM of the current
// device holds at this k; negative on an error, -1 for arguments it does
// not take.
int pmm_fused_topk_blocks_per_sm(int tm, int k, int core, int listed) {
  if (k <= 0) return -1;
  return dispatch(tm, core, listed != 0, [&](auto tmc, auto cc, auto lc) {
    return occupancy<decltype(tmc)::value, decltype(cc)::value,
                     decltype(lc)::value>(k);
  });
}

}  // extern "C"
