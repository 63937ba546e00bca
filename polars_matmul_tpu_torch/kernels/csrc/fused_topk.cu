// Kernel A: fused Q.C^T -> metric epilogue -> per-split running top-k.
//
// Replaces polars_matmul_tpu/kernels/fused_topk.py::_kernel (the dense-grid
// pallas_call at fused_topk.py:2177) in the modes the exact f32 main path
// runs: the "bf16x3" core (three bf16 products, f32 accumulation) and the
// "highest" core (f32), the f32 epilogue (additive bias row, mask by
// select), and the running top-k carry with lowest-index ties.  The TPU's
// gpop/gstack/extract selections all return this exact top-k; kernel A
// plus kernel B (topk_merge.cu) compute it directly.
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
// The two cores:
// - "bf16x3" runs on the tensor cores: mma.sync m16n8k16 bf16 with an f32
//   accumulator, three products per tile (qh.ch, qh.cl, ql.ch), the
//   counterpart of the TPU's three bf16 MXU passes.  Products of bf16
//   values are exact in f32; hh and (hl + lh) accumulate apart and are
//   summed last, the grouping of the TPU kernel.  Warp w owns corpus
//   columns [8w, 8w+8) of the tile for every query row of the block.
// - "highest" runs on CUDA cores: f32 FMA on a (TM/16) x 4 register
//   micro-tile per thread.  TF32 would not hold f32 semantics.
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
// Ragged edges: query rows >= m, corpus rows >= n and features >= dim are
// handled by the kernel's own bounds; nothing needs padding.  A carry slot
// that nothing filled holds (-inf, INT32_MAX).

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
constexpr int kINT32_MAX = 0x7fffffff;

// Shared memory: the operand tiles, then the score tile and the carry.
__host__ __device__ inline size_t operand_bytes(int tm, bool bf16x3) {
  return bf16x3
      ? 2 * (size_t)(tm + kTN) * kBKP * sizeof(uint16_t)      // hi, lo
      : ((size_t)tm * kBK + (size_t)kTN * (kBK + 1)) * sizeof(float);
}

__host__ __device__ inline size_t smem_bytes(int tm, int k, bool bf16x3) {
  return operand_bytes(tm, bf16x3)
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

// Epilogue for one score: bias row, then the mask by select (a NaN dot
// product on a masked row must not reach the selection), -inf past the
// corpus end.
__device__ inline float epilogue(float d, int gn, int n,
                                 const float* __restrict__ cb,
                                 const uint8_t* __restrict__ mask) {
  if (gn >= n) return -INFINITY;
  const float s = d + cb[gn];
  return (mask != nullptr && mask[gn] == 0) ? -INFINITY : s;
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

// Stage rows [r0, r0 + rows) x features [k0, k0 + kBK) of a bf16 [hi | lo]
// operand into shared memory, zero past the row count and the dim.  The
// element-wise form takes any dim; the vector form moves 8 bf16 (16 bytes)
// per load and needs dim % 8 == 0 and 16-byte aligned operands.
__device__ inline void load_tile(const uint16_t* __restrict__ src,
                                 uint16_t* hi, uint16_t* lo, int r0,
                                 int r_end, int k0, int dim, size_t ld,
                                 int rows) {
  for (int e = threadIdx.x; e < rows * kBK; e += kThreads) {
    const int r = e / kBK, kk = e % kBK;
    const int gr = r0 + r, gk = k0 + kk;
    uint16_t h = 0, l = 0;
    if (gr < r_end && gk < dim) {
      h = src[gr * ld + gk];
      l = src[gr * ld + dim + gk];
    }
    hi[r * kBKP + kk] = h;
    lo[r * kBKP + kk] = l;
  }
}

__device__ inline void load_tile_vec(const uint16_t* __restrict__ src,
                                     uint16_t* hi, uint16_t* lo, int r0,
                                     int r_end, int k0, int dim, size_t ld,
                                     int rows) {
  constexpr int kV = kBK / 8;   // 16-byte vectors per row chunk
  for (int e = threadIdx.x; e < rows * kV; e += kThreads) {
    const int r = e / kV, kk = (e % kV) * 8;
    const int gr = r0 + r, gk = k0 + kk;
    uint4 h = make_uint4(0, 0, 0, 0), l = h;
    if (gr < r_end && gk < dim) {
      h = *reinterpret_cast<const uint4*>(src + gr * ld + gk);
      l = *reinterpret_cast<const uint4*>(src + gr * ld + dim + gk);
    }
    *reinterpret_cast<uint4*>(hi + r * kBKP + kk) = h;
    *reinterpret_cast<uint4*>(lo + r * kBKP + kk) = l;
  }
}

// Score tile of the bf16x3 core into St (epilogue applied).
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
          epilogue(acc1[t][j] + acc2[t][j], n0 + col, n, cb, mask);
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
          epilogue(acc[i][j], n0 + col, n, cb, mask);
    }
}

template <int TM, bool BF16X3>
__global__ void __launch_bounds__(kThreads)
fused_topk_partial_kernel(const void* __restrict__ qp,
                          const void* __restrict__ cp,
                          const float* __restrict__ cb,
                          const uint8_t* __restrict__ mask,
                          float* __restrict__ part_v,
                          int* __restrict__ part_i,
                          int m, int n, int dim, int k, int splits,
                          int tiles_per_split, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* St = reinterpret_cast<float*>(smem + operand_bytes(TM, BF16X3));
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
  const int n_tiles = (n + kTN - 1) / kTN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  for (int e = tid; e < TM * k; e += kThreads) {
    Cv[e] = -INFINITY;
    Ci[e] = kINT32_MAX;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * kTN;
    if (BF16X3) {
      uint16_t* Qh = reinterpret_cast<uint16_t*>(smem);
      uint16_t* Ql = Qh + TM * kBKP;
      uint16_t* Ch = Ql + TM * kBKP;
      uint16_t* Cl = Ch + kTN * kBKP;
      scores_bf16x3<TM>(static_cast<const uint16_t*>(qp),
                        static_cast<const uint16_t*>(cp), cb, mask, Qh, Ql,
                        Ch, Cl, St, row0, n0, m, n, dim, vec);
    } else {
      float* Qs = reinterpret_cast<float*>(smem);
      float* Cs = Qs + TM * kBK;
      scores_f32<TM>(static_cast<const float*>(qp),
                     static_cast<const float*>(cp), cb, mask, Qs, Cs, St,
                     row0, n0, m, n, dim);
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

template <int TM, bool BF16X3>
int launch(const void* qp, const void* cp, const float* cb,
           const uint8_t* mask, float* part_v, int* part_i, int m, int n,
           int dim, int k, int splits, int tiles_per_split,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(TM, k, BF16X3);
  auto kern = fused_topk_partial_kernel<TM, BF16X3>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const bool vec = BF16X3 && dim % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(qp) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(cp) & 15) == 0;
  dim3 grid((m + TM - 1) / TM, splits);
  kern<<<grid, kThreads, bytes, stream>>>(qp, cp, cb, mask, part_v, part_i,
                                          m, n, dim, k, splits,
                                          tiles_per_split, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t after a refused launch, or -1 for
// arguments the kernel does not take.  bf16x3 != 0: qp and cp are bf16
// (rows, 2*dim) [hi | lo]; else f32 (rows, dim).  mask may be null.
int pmm_fused_topk_partial(const void* qp, const void* cp, const float* cb,
                           const uint8_t* mask, float* part_v, int* part_i,
                           int m, int n, int dim, int k, int splits,
                           int tiles_per_split, int tm, int bf16x3,
                           void* stream) {
  if (m <= 0 || n <= 0 || dim <= 0 || k <= 0 || splits <= 0 ||
      tiles_per_split <= 0)
    return -1;
  if ((long long)splits * tiles_per_split * kTN < n) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PMM_LAUNCH(TM_)                                                    \
  return bf16x3 ? launch<TM_, true>(qp, cp, cb, mask, part_v, part_i, m, \
                                    n, dim, k, splits, tiles_per_split, s) \
                : launch<TM_, false>(qp, cp, cb, mask, part_v, part_i, m, \
                                     n, dim, k, splits, tiles_per_split, s)
  switch (tm) {
    case 16: PMM_LAUNCH(16);
    case 32: PMM_LAUNCH(32);
    case 64: PMM_LAUNCH(64);
    default: return -1;
  }
#undef PMM_LAUNCH
}

}  // extern "C"
