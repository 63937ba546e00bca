// Staging and score tiles shared by kernel A (fused_topk.cu) and kernel D
// (floor.cu): one TM x kTN tile of epilogue scores, Q.C^T in one of the
// tensor-core cores, computed into shared memory.  Kernel D measures what
// kernel A's staging and products cost without its selection, so both
// include these very functions; only kernel D instantiates the two decodes
// of the int4 experiment (kInt4Rint, kInt4Raw).
//
// The cores ("bf16x3" three bf16 products of [hi | lo] halves; "bf16c",
// "int8c", "int4c" a stored corpus converted to bf16 while staged, two
// products qh.c + ql.c) and the int4 layout are described at the top of
// fused_topk.cu.

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

// The cores, in the order of kernels/fused_topk.py's CORES, then the two
// decodes of the int4 experiment (kernels/floor.py's CORES): "int4-rint"
// reads bytes b = 16 hi + lo and decodes them in float, "int4-raw" feeds
// each byte as it is to both nibble positions (wrong on purpose: a free
// unpack).  Both keep the int4c layout.
enum Core : int { kHighest = 0, kBf16x3 = 1, kBf16c = 2, kInt8c = 3,
                  kInt4c = 4, kInt4Rint = 5, kInt4Raw = 6 };

// Cores whose bytes hold two features each (int4_byte's layout).
__host__ __device__ constexpr bool packed_core(int core) {
  return core == kInt4c || core == kInt4Rint || core == kInt4Raw;
}

// Features a stored-corpus core stages per step.  Its corpus rows are
// narrow (32 features are 32 bytes of int8, 16 of int4), and each step
// waits for its loads, so a wide step keeps more bytes in flight.  The
// 64-row query tile takes 64, so that two blocks still fit an SM.  (int4
// at 256 features, the int8 step's bytes, measured slower on the H100:
// PERF.md.)
__host__ __device__ constexpr int stored_bk(int tm) {
  return tm == 64 ? 64 : 128;
}

// Shared memory: the operand tiles, then the score tile and the carry.
__host__ __device__ inline size_t operand_bytes(int tm, int core) {
  if (core == kHighest)
    return ((size_t)tm * kBK + (size_t)kTN * (kBK + 1)) * sizeof(float);
  if (core == kBf16x3)
    return 2 * (size_t)(tm + kTN) * kBKP * sizeof(uint16_t);  // hi, lo
  return (size_t)(2 * tm + kTN) * (stored_bk(tm) + 8)        // qh, ql, c
       * sizeof(uint16_t);
}

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
          epilogue(acc1[t][j] + acc2[t][j], n0 + col, n, nullptr, cb, mask);
    }
}

__device__ inline uint16_t bf16_bits(int v) {
  return __bfloat16_as_ushort(__int2bfloat16_rn(v));   // exact for |v| <= 256
}

__device__ inline int nibble(uint32_t byte, bool high) {
  return (int)(((high ? byte >> 4 : byte) & 0xFu) ^ 8u) - 8;
}

// Byte of feature f in an int4 row (quantize_int4's layout: in each
// ck-wide chunk, byte j holds feature j low and feature j + ck/2 high),
// and whether it is the high nibble.  Eight features from a multiple of 8
// share their nibble half and sit in 8 consecutive bytes (ck/2 is a
// multiple of 64).
__device__ inline size_t int4_byte(int f, int ck, bool& high) {
  const int t = f / ck, j = f - t * ck, half = ck / 2;
  high = j >= half;
  return (size_t)t * half + (high ? j - half : j);
}

// The bf16 bits of one stored byte's feature in the two decodes only
// kernel D instantiates (high: the feature is the byte's high nibble
// position).  int4-rint decodes in float, as the experiment does: hi =
// rint(b / 16), lo = b - 16 hi, both exact.  int4-raw is the byte itself.
template <int CORE>
__device__ inline uint16_t decode_byte(uint32_t byte, bool high) {
  if (CORE == kInt4Rint) {
    const float b = (float)(int8_t)byte;
    const float hi = rintf(b * 0.0625f);
    return __bfloat16_as_ushort(
        __float2bfloat16_rn(high ? hi : b - 16.f * hi));
  }
  return bf16_bits((int)(int8_t)byte);
}

// Stage corpus rows [r0, r0 + kTN) x features [k0, k0 + BK) of a
// stored-corpus core as bf16 into Cs (row stride BK + 8), zero past the
// row count and the dim.  ld is the row stride in elements (bf16c) or
// bytes (int8c and the int4 family); ck is the int4 feature chunk.  The
// vector form issues all of a thread's loads (8 values each) before it
// converts any, and needs dim % 8 == 0 and aligned operands (int4 rows
// must hold whole 8-byte runs: ck / 2 a multiple of 8).
template <int CORE, int BK>
__device__ inline void load_corpus(const void* __restrict__ src,
                                   uint16_t* Cs, int r0, int r_end, int k0,
                                   int dim, size_t ld, int ck, bool vec) {
  constexpr int BKP = BK + 8;
  if (vec) {
    constexpr int kV = BK / 8;
    constexpr int kPer = kTN * kV / kThreads;   // vectors per thread
    static_assert(kTN * kV % kThreads == 0, "whole vectors per thread");
    uint4 raw[kPer];
    bool high[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int gr = r0 + e / kV, gk = k0 + (e % kV) * 8;
      raw[i] = make_uint4(0, 0, 0, 0);
      high[i] = false;
      if (gr < r_end && gk < dim) {
        if (CORE == kBf16c) {
          raw[i] = *reinterpret_cast<const uint4*>(
              static_cast<const uint16_t*>(src) + gr * ld + gk);
        } else {
          const size_t b = packed_core(CORE) ? int4_byte(gk, ck, high[i])
                                             : (size_t)gk;
          const uint2 w = *reinterpret_cast<const uint2*>(
              static_cast<const uint8_t*>(src) + gr * ld + b);
          raw[i].x = w.x;
          raw[i].y = w.y;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kV, kk = (e % kV) * 8;
      uint4 out = raw[i];
      if (CORE != kBf16c) {
        const uint32_t w[2] = {raw[i].x, raw[i].y};
        uint16_t h[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const uint32_t byte = (w[b >> 2] >> (8 * (b & 3))) & 0xFFu;
          if constexpr (CORE == kInt4Rint || CORE == kInt4Raw) {
            h[b] = k0 + kk + b < dim ? decode_byte<CORE>(byte, high[i])
                                     : (uint16_t)0;
          } else {
            const int v = CORE == kInt8c ? (int)(int8_t)byte
                                         : nibble(byte, high[i]);
            h[b] = k0 + kk + b < dim ? bf16_bits(v) : (uint16_t)0;
          }
        }
        out = make_uint4(h[0] | (uint32_t)h[1] << 16,
                         h[2] | (uint32_t)h[3] << 16,
                         h[4] | (uint32_t)h[5] << 16,
                         h[6] | (uint32_t)h[7] << 16);
      }
      *reinterpret_cast<uint4*>(Cs + r * BKP + kk) = out;
    }
    return;
  }
  for (int e = threadIdx.x; e < kTN * BK; e += kThreads) {
    const int r = e / BK, kk = e % BK;
    const int gr = r0 + r, gk = k0 + kk;
    uint16_t h = 0;
    if (gr < r_end && gk < dim) {
      if (CORE == kBf16c) {
        h = static_cast<const uint16_t*>(src)[gr * ld + gk];
      } else {
        bool hi = false;
        const size_t b = packed_core(CORE) ? int4_byte(gk, ck, hi)
                                           : (size_t)gk;
        const uint8_t byte = static_cast<const uint8_t*>(src)[gr * ld + b];
        if constexpr (CORE == kInt4Rint || CORE == kInt4Raw)
          h = decode_byte<CORE>(byte, hi);
        else
          h = bf16_bits(CORE == kInt8c ? (int)(int8_t)byte
                                       : nibble(byte, hi));
      }
    }
    Cs[r * BKP + kk] = h;
  }
}

// Score tile of a stored-corpus core (bf16c, int8c, the int4 family) into
// St (epilogue applied): qh.c and ql.c in two accumulators, summed last.
template <int TM, int CORE>
__device__ inline void scores_stored(const uint16_t* __restrict__ q,
                                     const void* __restrict__ c,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ cb,
                                     const uint8_t* __restrict__ mask,
                                     uint16_t* Qh, uint16_t* Ql,
                                     uint16_t* Cs, float* St, int row0,
                                     int n0, int m, int n, int dim,
                                     size_t c_ld, int ck, bool vec) {
  constexpr int MT = TM / 16;   // m16 tiles per warp
  constexpr int BK = stored_bk(TM), BKP = BK + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const size_t ld = 2 * (size_t)dim;   // queries: [hi | lo] row stride
  float acc1[MT][4], acc2[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) { acc1[t][j] = 0.f; acc2[t][j] = 0.f; }

  for (int k0 = 0; k0 < dim; k0 += BK) {
    load_corpus<CORE, BK>(c, Cs, n0, n, k0, dim, c_ld, ck, vec);
    if (vec)
      load_tile_vec<BK>(q, Qh, Ql, row0, m, k0, dim, ld, TM);
    else
      load_tile<BK>(q, Qh, Ql, row0, m, k0, dim, ld, TM);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      const int bo = (8 * warp + g) * BKP + ks + 2 * tig;
      const uint32_t b0 = ld32(Cs + bo), b1 = ld32(Cs + bo + 8);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int ao = (16 * t + g) * BKP + ks + 2 * tig;
        mma_bf16(acc1[t], ld32(Qh + ao), ld32(Qh + ao + 8 * BKP),
                 ld32(Qh + ao + 8), ld32(Qh + ao + 8 * BKP + 8), b0, b1);
        mma_bf16(acc2[t], ld32(Ql + ao), ld32(Ql + ao + 8 * BKP),
                 ld32(Ql + ao + 8), ld32(Ql + ao + 8 * BKP + 8), b0, b1);
      }
    }
    __syncthreads();
  }
  const float* sc = CORE == kBf16c ? nullptr : scale;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 16 * t + g + (j >= 2 ? 8 : 0);
      const int col = 8 * warp + 2 * tig + (j & 1);
      St[r * (kTN + 1) + col] =
          epilogue(acc1[t][j] + acc2[t][j], n0 + col, n, sc, cb, mask);
    }
}

}  // namespace
