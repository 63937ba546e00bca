// Kernel C: the pairwise product out[i, j] = sum_d q[i, d] * c[j, d], f32,
// (m, n) row-major.
//
// Replaces polars_matmul_tpu/kernels/matmul.py:46 (_mm_kernel, run by the
// pallas_call at matmul.py:101): the TPU kernel walks a grid (M/bm, N/bn,
// K/bk) with K innermost, in order on one core, and carries each (bm, bn)
// sum in a VMEM scratch accumulator from one K step to the next; the
// caller pads q and c to whole blocks first.  Here blocks run in parallel
// and in no order, so a block owns one 128 x 128 output tile outright and
// a loop over the features inside the block takes the place of the K grid
// axis; the sum stays in registers.  The kernel masks the ragged edges
// itself (rows past m or n, features past dim read as zero, outputs past
// the edge are not written), so nothing is padded.
//
// Two cores, one kernel body, chosen by a template argument:
// - "highest" (precision "default", "high", "highest"): f32 FFMA on the
//   CUDA cores.  Shared-memory tiles of 128 rows x 8 features of Q and C,
//   stored feature-major, two of each (the next stage is read into
//   registers while the current one is multiplied); each thread holds an
//   8 x 8 register tile of the output.
// - "bf16x3" (precision "bf16x3", "bf16c"): each f32 value is split into
//   bf16 hi + lo while it is staged (hi rounds in IEEE bit space, lo = x -
//   hi rounded to bf16: the split of kernels/fused_topk.py::split_hi_lo),
//   and three mma.sync m16n8k16 bf16 products with f32 accumulators give
//   qh.ch and qh.cl + ql.ch apart, summed last: the arithmetic of kernel
//   A's bf16x3 core (fused_topk.cu).  Eight warps each own a 64 x 32
//   piece of the tile; stages of 16 features, two of each operand half.
//
// What bounds it on the H100: the products.  At the canonical 1000 x
// 10,000 x 256 shape "highest" is 5.1 GFLOP, 0.076 ms at the 67 TFLOP/s
// f32 peak, against 0.015 ms to read the inputs and write the 40 MB
// output once at 3.35 TB/s; bf16x3's three bf16 products are 0.0155 ms at
// 989 TFLOP/s, level with the bytes.  mma.sync reaches only part of the
// tensor cores' peak (wgmma and a TMA pipeline are for a later change),
// and each 128-row block of one operand reads the other once, which L2
// mostly serves.  Output offsets are 64-bit: m * n passes 2^31 at 50,000 x
// 50,000.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kBM = 128;        // output rows per block (q rows)
constexpr int kBN = 128;        // output columns per block (c rows)
constexpr int kFK = 8;          // "highest": features per stage
constexpr int kFP = kBM + 4;    // its padded row of one feature
constexpr int kHK = 16;         // "bf16x3": features per stage (one k16)
constexpr int kHP = kHK + 8;    // its bf16 row stride: conflict-free reads

// The cores, in the order of kernels/matmul.py's CORES.
enum Core : int { kHighest = 0, kBf16x3 = 1 };

// Four features [k, k + 4) of row r of a (rows, dim) f32 operand, zero past
// the row count and the dim.  The vector form needs dim % 4 == 0 and a
// 16-byte aligned operand.
__device__ inline float4 load4(const float* __restrict__ src, int r, int rows,
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

// ---------------------------------------------------------------------------
// "highest": f32 FFMA.
// ---------------------------------------------------------------------------

// Store four features of staging row r, transposed: feature-major.
__device__ inline void store_t(float (*t)[kFP], float4 v, int r, int k) {
  t[k][r] = v.x;
  t[k + 1][r] = v.y;
  t[k + 2][r] = v.z;
  t[k + 3][r] = v.w;
}

__device__ inline void unpack4(float* dst, float4 v) {
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ inline void tile_highest(const float* __restrict__ q,
                                    const float* __restrict__ c,
                                    float* __restrict__ out, int m, int n,
                                    int dim, bool vec, bool out_vec) {
  __shared__ __align__(16) float As[2][kFK][kFP];
  __shared__ __align__(16) float Bs[2][kFK][kFP];
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // output columns 4 tx + j and 64 + 4 tx + j
  const int ty = tid >> 4;   // output rows 4 ty + i and 64 + 4 ty + i
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int lr = tid >> 1, lk = (tid & 1) * 4;   // the staging row, feature
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra = load4(q, row0 + lr, m, lk, dim, vec);
  float4 rb = load4(c, col0 + lr, n, lk, dim, vec);
  store_t(As[0], ra, lr, lk);
  store_t(Bs[0], rb, lr, lk);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < dim; k0 += kFK) {
    const bool more = k0 + kFK < dim;
    if (more) {
      ra = load4(q, row0 + lr, m, k0 + kFK + lk, dim, vec);
      rb = load4(c, col0 + lr, n, k0 + kFK + lk, dim, vec);
    }
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[8], b[8];
      unpack4(a, *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]));
      unpack4(a + 4,
              *reinterpret_cast<const float4*>(&As[buf][kk][64 + 4 * ty]));
      unpack4(b, *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]));
      unpack4(b + 4,
              *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + 4 * tx]));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (more) {
      store_t(As[buf ^ 1], ra, lr, lk);
      store_t(Bs[buf ^ 1], rb, lr, lk);
    }
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + 64 * h + 4 * tx;
      float* o = out + (size_t)r * n + col;
      const float* v = acc[i] + 4 * h;
      if (out_vec && col < n) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) o[j] = v[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// "bf16x3": three bf16 products on the tensor cores.
// ---------------------------------------------------------------------------

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

// x = hi + lo, both bf16 bits: hi rounds in IEEE bit space (+0x8000, clear
// the low 16 bits), lo = x - hi (exact in f32) rounded to nearest even.
__device__ inline void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x8000u) & 0xFFFF0000u;
  hi = h >> 16;
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(x - __uint_as_float(h)));
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

__device__ inline void tile_bf16x3(const float* __restrict__ q,
                                   const float* __restrict__ c,
                                   float* __restrict__ out, int m, int n,
                                   int dim, bool vec, bool out_vec) {
  constexpr int kTile = kBM * kHP;   // kBM == kBN
  __shared__ __align__(16) uint16_t Ah[2][kTile], Al[2][kTile];
  __shared__ __align__(16) uint16_t Bh[2][kTile], Bl[2][kTile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2;   // output rows [64 wm, 64 wm + 64)
  const int wn = warp & 3;    // output columns [32 wn, 32 wn + 32)
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  // Staging: two vectors of four features per operand and thread.
  int sr[2], sk[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = tid + s * kThreads;
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
    ra[s] = load4(q, row0 + sr[s], m, sk[s], dim, vec);
    rb[s] = load4(c, col0 + sr[s], n, sk[s], dim, vec);
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
        ra[s] = load4(q, row0 + sr[s], m, k0 + kHK + sk[s], dim, vec);
        rb[s] = load4(c, col0 + sr[s], n, k0 + kHK + sk[s], dim, vec);
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

template <int CORE>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const float* __restrict__ q, const float* __restrict__ c,
              float* __restrict__ out, int m, int n, int dim, bool vec,
              bool out_vec) {
  if constexpr (CORE == kHighest)
    tile_highest(q, c, out, m, n, dim, vec, out_vec);
  else
    tile_bf16x3(q, c, out, m, n, dim, vec, out_vec);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" {

// out (m, n) f32 = q (m, dim) f32 . c (n, dim)^T f32, all row-major and
// dense, on `stream`.  core is a Core.  Returns 0 on success, a
// cudaError_t after a refused launch, or -1 for arguments the kernel does
// not take.
int pmm_matmul(const float* q, const float* c, float* out, int m, int n,
               int dim, int core, void* stream) {
  if (m <= 0 || n <= 0 || dim <= 0) return -1;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return -1;
  const bool vec = dim % 4 == 0 && aligned(q, 16) && aligned(c, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (core) {
    case kHighest:
      matmul_kernel<kHighest><<<grid, kThreads, 0, s>>>(
          q, c, out, m, n, dim, vec, n % 4 == 0 && aligned(out, 16));
      break;
    case kBf16x3:
      matmul_kernel<kBf16x3><<<grid, kThreads, 0, s>>>(
          q, c, out, m, n, dim, vec, n % 2 == 0 && aligned(out, 8));
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
