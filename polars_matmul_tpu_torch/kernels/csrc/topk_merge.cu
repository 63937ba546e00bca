// Kernel B: merge the per-split top-k lists of kernel A into the final
// (m, k) result.
//
// Replaces the finishing step of polars_matmul_tpu/kernels/fused_topk.py:
// the in-kernel k-pop of "gpop" (_gpop_finish, fused_topk.py:922) and the
// panel finish outside the kernel for "gstack" (_gstack_decode :752 with
// _chunked_top_k :643).  On the TPU one core saw the whole corpus in
// order, so the last grid step could finish the selection; on Hopper the
// corpus is split across blocks (fused_topk.cu), and this second pass
// merges the splits.  It is exact: the output is the top-k of the union of
// the lists, ordered by (value desc, index asc), with INT32_MAX as the index
// of every -inf value.
//
// What bounds it on the H100: it reads at most m * splits * k (value,
// index) pairs (1000 x 16 x 10 x 8 bytes = 1.3 MB at the canonical k=10)
// and pops k times per row, each pop a 5-step warp arg-max; it is latency-
// bound and small beside kernel A.  The design gives each query row one
// warp and each lane up to L lists (list s on lane s % 32), with the head
// and the next entry of every list in registers: a pop moves the next
// entry up and starts the load of the one after, so no pop waits on device
// memory unless one list wins twice in a row.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kINT32_MAX = 0x7fffffff;
constexpr int kMaxSplits = 1024;

__device__ inline bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <int L>
__global__ void __launch_bounds__(kWarps * 32)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ out_v,
                  int* __restrict__ out_i, int m, int splits, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= m) return;   // whole warp leaves together; no block barrier
  const float* pv = part_v + (size_t)row * splits * k;
  const int* pi = part_i + (size_t)row * splits * k;

  // List lane + 32 t: head (hv, hi) at position pos, next entry (nv, ni).
  float hv[L], nv[L];
  int hi[L], ni[L], pos[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    const int s = lane + 32 * t;
    const size_t o = (size_t)s * k;
    const bool live = s < splits;
    hv[t] = live ? pv[o] : -INFINITY;
    hi[t] = live ? pi[o] : kINT32_MAX;
    nv[t] = live && k > 1 ? pv[o + 1] : -INFINITY;
    ni[t] = live && k > 1 ? pi[o + 1] : kINT32_MAX;
    pos[t] = 0;
  }
  // This lane's best head.
  float bv = -INFINITY;
  int bi = kINT32_MAX, bt = 0;
#pragma unroll
  for (int t = 0; t < L; ++t)
    if (better(hv[t], hi[t], bv, bi)) { bv = hv[t]; bi = hi[t]; bt = t; }

  int r = 0;
  for (; r < k; ++r) {
    float wv = bv;
    int wi = bi, wl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
      const int ol = __shfl_xor_sync(0xffffffffu, wl, off);
      if (better(ov, oi, wv, wi) || (ov == wv && oi == wi && ol < wl)) {
        wv = ov; wi = oi; wl = ol;
      }
    }
    if (wv == -INFINITY) break;   // every remaining entry is -inf
    if (lane == 0) {
      out_v[(size_t)row * k + r] = wv;
      out_i[(size_t)row * k + r] = wi;
    }
    if (lane == wl) {
#pragma unroll
      for (int t = 0; t < L; ++t) {
        if (t == bt) {
          hv[t] = nv[t];
          hi[t] = ni[t];
          const int p = ++pos[t] + 1;
          const size_t o = (size_t)(lane + 32 * t) * k + p;
          nv[t] = p < k ? pv[o] : -INFINITY;
          ni[t] = p < k ? pi[o] : kINT32_MAX;
        }
      }
      bv = -INFINITY;
      bi = kINT32_MAX;
#pragma unroll
      for (int t = 0; t < L; ++t)
        if (better(hv[t], hi[t], bv, bi)) { bv = hv[t]; bi = hi[t]; bt = t; }
    }
  }
  for (int j = r + lane; j < k; j += 32) {
    out_v[(size_t)row * k + j] = -INFINITY;
    out_i[(size_t)row * k + j] = kINT32_MAX;
  }
}

template <int L>
int launch(const float* part_v, const int* part_i, float* out_v, int* out_i,
           int m, int splits, int k, cudaStream_t stream) {
  dim3 grid((m + kWarps - 1) / kWarps);
  topk_merge_kernel<L><<<grid, kWarps * 32, 0, stream>>>(
      part_v, part_i, out_v, out_i, m, splits, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t after a refused launch, or -1 for
// arguments the kernel does not take.
int pmm_topk_merge(const float* part_v, const int* part_i, float* out_v,
                   int* out_i, int m, int splits, int k, void* stream) {
  if (m <= 0 || k <= 0 || splits <= 0 || splits > kMaxSplits) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lists = (splits + 31) / 32;   // lists per lane
#define PMM_MERGE(L_) \
  return launch<L_>(part_v, part_i, out_v, out_i, m, splits, k, s)
  if (lists <= 1) PMM_MERGE(1);
  if (lists <= 2) PMM_MERGE(2);
  if (lists <= 4) PMM_MERGE(4);
  if (lists <= 8) PMM_MERGE(8);
  if (lists <= 16) PMM_MERGE(16);
  PMM_MERGE(32);
#undef PMM_MERGE
}

}  // extern "C"
