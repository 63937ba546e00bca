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
// What bounds it on the H100: it reads m * splits * k (value, index) pairs
// and writes m * k (1000 x 16 x 10 x 8 bytes = 1.3 MB at the canonical
// k=10, 0.0004 ms at 3.35 TB/s), so a launch's latency and its dependent
// steps are what cost time.  The design keeps every step parallel:
//
// - Each list is already sorted, so the top k of two lists is a rank
//   merge: entry x of list a lands at x + (entries of b ordered before
//   it), entry y of b at y + (entries of a ordered before or equal to it),
//   and slots past k are dropped.  The kernel computes it on the merge
//   path: the k outputs of a pair go in runs of 2 (k <= 32) or 4, one
//   thread a run; a binary search of log2(k) steps in shared memory finds
//   how many of the run's predecessors come from a (co_rank), and the run
//   is merged from there.  A pair costs k outputs and k / run searches,
//   where a search per entry would cost 2k searches.  Every thread works
//   at once; a round halves the lists, and log2(lists) rounds leave one.
//   An odd list rises to the next round as it is.  There is no chain of k
//   dependent pops.
// - A block loads a row's lists once, with eight loads in flight a thread,
//   into shared memory (two buffers, the second half the first: the rounds
//   go back and forth).  Past what the buffers hold, the block takes the
//   lists in passes and carries the running result into the next pass as
//   one more list.  Rows of few entries (the canonical 16 lists of 10)
//   share a block, a few rows a block, as long as the blocks still give
//   every SM two: fewer, fuller blocks cost less than one block a row.
//   The host picks the rows a block (fused_topk.merge_plan).
// - At batches too small to fill the card (m below about half the SMs),
//   a row's lists split into groups, one block each; each block writes its
//   group's k-list to scratch, and the row's last block to arrive (a
//   per-row counter, after __threadfence) merges the group lists.  The
//   host picks the groups (fused_topk.merge_plan) and hands in scratch
//   allocated through torch; the counters are zeroed here on the stream.
// - k = 1 skips the tree: one warp per row takes the best head by a shuffle
//   reduction.  One list (splits = 1) runs no round: load, then store.
//
// Ties: every comparison is on the key (value desc, index asc), and each
// -inf entry takes the index INT32_MAX as it is loaded, so a list's -inf
// tail is one run of equal keys whatever indices it came with; equal keys
// take a's entry first, so each keeps a slot of its own.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kINT32_MAX = 0x7fffffff;
constexpr int kMaxSplits = 1024;
constexpr int kMaxThreads = 512;
constexpr int kMinThreads = 128;
// Entries a thread loads at once.
constexpr int kLoads = 8;
constexpr int kBestWarps = 8;
// Dynamic shared memory a block may take for its two buffers: two blocks
// an SM fit at the most.
constexpr int kSmemBudget = 96 * 1024;
constexpr int kMaxDevices = 64;

struct __align__(8) Entry {
  float v;
  int i;
};

__device__ __forceinline__ Entry make_entry(float v, int i) {
  return Entry{v, v == -INFINITY ? kINT32_MAX : i};
}

// a comes before b in the output order.
__device__ __forceinline__ bool before(Entry a, Entry b) {
  return a.v > b.v || (a.v == b.v && a.i < b.i);
}

// `count` consecutive (value, index) pairs into dst, kLoads loads in
// flight a thread.  __ldcg reads through L2: the group lists of a grouped
// launch were written by other blocks of the same launch.
__device__ void load_entries(Entry* dst, const float* __restrict__ v,
                             const int* __restrict__ idx, int count) {
  const int t = blockDim.x;
  for (int e0 = threadIdx.x; e0 < count; e0 += kLoads * t) {
    float a[kLoads];
    int b[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * t;
      if (e < count) {
        a[u] = __ldcg(v + e);
        b[u] = __ldcg(idx + e);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * t;
      if (e < count) dst[e] = make_entry(a[u], b[u]);
    }
  }
}

// Outputs one thread writes in a round: a run of the merge path (shorter
// runs measured faster: more threads search at once).
__host__ __device__ inline int run_len(int k) { return k <= 32 ? 2 : 4; }

// Entries of a among the first d entries of the merge of a and b (a's entry
// first on equal keys): the merge path's split at diagonal d, by binary
// search over the candidates [max(0, d - k), min(d, k)].
__device__ __forceinline__ int co_rank(const Entry* a, const Entry* b, int d,
                                       int k) {
  int lo = max(0, d - k), hi = min(d, k);
  while (lo < hi) {
    const int i = (lo + hi) >> 1;
    if (before(b[d - i - 1], a[i]))
      hi = i;
    else
      lo = i + 1;
  }
  return lo;
}

// One round, over `rows` rows of cnt lists of k each (row r's at src + r
// cnt k): lists 2p and 2p + 1 of a row merge into its list p in dst (row
// r's at dst + r ceil(cnt / 2) k), truncated to k; an odd last list is
// copied up.  A pair's k outputs go in runs of run_len(k): each thread
// finds where its run starts on the merge path, then merges the run.
__device__ void merge_round(const Entry* src, Entry* dst, int rows, int cnt,
                            int k) {
  const int run = run_len(k);
  const int pairs = cnt >> 1, runs = (k + run - 1) / run;
  const int work = pairs * runs;
  const int per_row = work + (cnt & 1) * k;
  for (int w = threadIdx.x; w < rows * per_row; w += blockDim.x) {
    const int r = w / per_row;
    const int u = w - r * per_row;
    const Entry* in = src + r * cnt * k;
    Entry* out = dst + r * ((cnt + 1) >> 1) * k;
    if (u >= work) {
      const int x = u - work;
      out[pairs * k + x] = in[(cnt - 1) * k + x];
      continue;
    }
    const int p = u / runs;
    int d = (u - p * runs) * run;
    const int end = min(k, d + run);
    const Entry* a = in + 2 * p * k;
    const Entry* b = a + k;
    out += p * k;
    // i + j = d < end <= k: both heads lie inside their lists.
    int i = co_rank(a, b, d, k), j = d - i;
    Entry ea = a[i], eb = b[j];
    for (;;) {
      const bool take_a = !before(eb, ea);
      out[d] = take_a ? ea : eb;
      if (++d == end) break;
      if (take_a)
        ea = a[++i];
      else
        eb = b[++j];
    }
  }
}

// `rows` rows of cnt lists of k in x down to one list each; returns the
// buffer that holds them (row r's in entries [r k, (r + 1) k)).
__device__ Entry* merge_tree(Entry* x, Entry* y, int rows, int cnt, int k) {
  while (cnt > 1) {
    merge_round(x, y, rows, cnt, k);
    __syncthreads();
    Entry* t = x;
    x = y;
    y = t;
    cnt = (cnt + 1) >> 1;
  }
  return x;
}

// The top k of each of `rows` rows of n consecutive lists of k (values v,
// indices idx).  One row may take passes of at most cap lists; from the
// second pass on the running result rides along as list 0.  Several rows
// fit x in one pass.  Returns the buffer whose first rows * k entries hold
// the results.
__device__ const Entry* reduce_lists(Entry* x, Entry* y,
                                     const float* __restrict__ v,
                                     const int* __restrict__ idx, int rows,
                                     int n, int k, int cap) {
  if (rows > 1) {
    load_entries(x, v, idx, rows * n * k);
    __syncthreads();
    return merge_tree(x, y, rows, n, k);
  }
  const Entry* acc = nullptr;
  for (int done = 0; done < n;) {
    int slots = 0;
    if (acc != nullptr) {
      if (acc != x)
        for (int e = threadIdx.x; e < k; e += blockDim.x) x[e] = acc[e];
      slots = 1;
    }
    const int take = min(cap - slots, n - done);
    load_entries(x + slots * k, v + (size_t)done * k, idx + (size_t)done * k,
                 take * k);
    __syncthreads();
    acc = merge_tree(x, y, 1, slots + take, k);
    done += take;
  }
  return acc;
}

__device__ void store_entries(const Entry* src, float* __restrict__ v,
                              int* __restrict__ idx, int k) {
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const Entry s = src[e];
    v[e] = s.v;
    idx[e] = s.i;
  }
}

// With one group a row, block b takes rows [b rows, (b + 1) rows) and
// writes their results.  With several, block b takes group b % groups of
// row b / groups, lists [g per, min(splits, (g + 1) per)); its group list
// goes to scratch, and the row's last block merges the group lists.
__global__ void __launch_bounds__(kMaxThreads)
topk_merge_tree_kernel(const float* __restrict__ part_v,
                       const int* __restrict__ part_i,
                       float* __restrict__ out_v, int* __restrict__ out_i,
                       float* __restrict__ group_v, int* __restrict__ group_i,
                       int* __restrict__ arrivals, int m, int splits, int k,
                       int rows, int groups, int per, int cap) {
  extern __shared__ Entry smem[];
  __shared__ int last;
  Entry* x = smem;
  Entry* y = smem + cap * k;
  if (groups == 1) {
    const int row = blockIdx.x * rows;
    const int n = min(rows, m - row);
    const size_t in = (size_t)row * splits * k;
    const Entry* acc = reduce_lists(x, y, part_v + in, part_i + in, n,
                                    splits, k, cap);
    store_entries(acc, out_v + (size_t)row * k, out_i + (size_t)row * k,
                  n * k);
    return;
  }
  const int row = blockIdx.x / groups;
  const int g = blockIdx.x - row * groups;
  const int l0 = g * per;
  const size_t in = ((size_t)row * splits + l0) * k;
  const Entry* acc = reduce_lists(x, y, part_v + in, part_i + in, 1,
                                  min(per, splits - l0), k, cap);
  const size_t mine = ((size_t)row * groups + g) * k;
  store_entries(acc, group_v + mine, group_i + mine, k);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals + row, 1) == groups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t first = (size_t)row * groups * k;
  acc = reduce_lists(x, y, group_v + first, group_i + first, 1, groups, k,
                     cap);
  store_entries(acc, out_v + (size_t)row * k, out_i + (size_t)row * k, k);
}

// k = 1: one warp per row, the best of the row's heads.
__global__ void __launch_bounds__(kBestWarps * 32)
topk_merge_best_kernel(const float* __restrict__ part_v,
                       const int* __restrict__ part_i,
                       float* __restrict__ out_v, int* __restrict__ out_i,
                       int m, int splits) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kBestWarps + (threadIdx.x >> 5);
  if (row >= m) return;   // whole warp leaves together; no block barrier
  const size_t base = (size_t)row * splits;
  Entry best{-INFINITY, kINT32_MAX};
  for (int s = lane; s < splits; s += 32) {
    const Entry e = make_entry(part_v[base + s], part_i[base + s]);
    if (before(e, best)) best = e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Entry o;
    o.v = __shfl_xor_sync(0xffffffffu, best.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, best.i, off);
    if (before(o, best)) best = o;
  }
  if (lane == 0) {
    out_v[row] = best.v;
    out_i[row] = best.i;
  }
}

// Bytes of the two buffers: x holds a pass's cap lists of k, y what round
// one leaves of them (rows rows of cap / rows lists, halved, each).
inline size_t smem_bytes(int cap, int rows, int k) {
  const int row_lists = cap / rows;
  return (size_t)(cap + rows * ((row_lists + 1) / 2)) * k * sizeof(Entry);
}

int launch(const float* part_v, const int* part_i, float* out_v, int* out_i,
           void* scratch, int m, int splits, int k, int groups, int rows,
           cudaStream_t stream) {
  if (m <= 0 || k <= 0 || splits <= 0 || splits > kMaxSplits || groups < 1 ||
      groups > splits || rows < 1 || (groups > 1 && rows > 1) ||
      (groups > 1 && scratch == nullptr) ||
      (long long)m * groups > 0x7fffffffLL)
    return -1;
  if (k == 1) {
    topk_merge_best_kernel<<<(m + kBestWarps - 1) / kBestWarps,
                             kBestWarps * 32, 0, stream>>>(
        part_v, part_i, out_v, out_i, m, splits);
    return (int)cudaGetLastError();
  }
  const int per = (splits + groups - 1) / groups;
  if ((groups - 1) * per >= splits) return -1;   // an empty group
  // Lists a pass holds: all of a block's (its rows', a group's, or the
  // group lists), or with one row as many as the budget takes (at least
  // two: k <= 1024 always fits).  Several rows a block take one pass.
  int cap = rows > 1 ? rows * splits : per > groups ? per : groups;
  while (rows == 1 && cap > 2 &&
         smem_bytes(cap, rows, k) > (size_t)kSmemBudget)
    --cap;
  if (smem_bytes(cap, rows, k) > (size_t)kSmemBudget) return -1;
  // A thread a run of round one's pairs (an odd list's entries one each),
  // and a pass's lists in one load of kLoads entries a thread.
  const int run = run_len(k);
  const int lists = rows > 1 ? splits : cap;
  const int items =
      rows * (lists / 2 * ((k + run - 1) / run) + lists % 2 * k);
  const int loads = (cap * k + kLoads - 1) / kLoads;
  int threads = ((items > loads ? items : loads) + 31) / 32 * 32;
  threads = threads < kMinThreads ? kMinThreads
            : threads > kMaxThreads ? kMaxThreads : threads;
  const size_t smem = smem_bytes(cap, rows, k);
  cudaError_t err;
  if (smem > 48 * 1024) {
    // Once a device, outside any graph capture that follows a first call.
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || !raised[dev]) {
      err = cudaFuncSetAttribute(topk_merge_tree_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBudget);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) raised[dev] = true;
    }
  }
  int* arrivals = nullptr;
  float* group_v = nullptr;
  int* group_i = nullptr;
  if (groups > 1) {
    // Scratch: m counters (rounded up to 16 bytes), then the group lists'
    // values and indices (fused_topk.merge_scratch_ints).
    arrivals = static_cast<int*>(scratch);
    group_v = reinterpret_cast<float*>(arrivals + (m + 3) / 4 * 4);
    group_i = reinterpret_cast<int*>(group_v + (size_t)m * groups * k);
    err = cudaMemsetAsync(arrivals, 0, (size_t)m * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = groups > 1 ? m * groups : (m + rows - 1) / rows;
  topk_merge_tree_kernel<<<blocks, threads, smem, stream>>>(
      part_v, part_i, out_v, out_i, group_v, group_i, arrivals, m, splits, k,
      rows, groups, per, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One block a row.  Returns 0 on success, a cudaError_t after a refused
// launch, or -1 for arguments the kernel does not take.
int pmm_topk_merge(const float* part_v, const int* part_i, float* out_v,
                   int* out_i, int m, int splits, int k, void* stream) {
  return launch(part_v, part_i, out_v, out_i, nullptr, m, splits, k, 1, 1,
                static_cast<cudaStream_t>(stream));
}

// The launch shape fused_topk.merge_plan picks: `groups` blocks a row, with
// `scratch` of fused_topk.merge_scratch_ints(m, groups, k) int32 words on
// the device, or `rows` rows a block (one of the two is 1).
int pmm_topk_merge_plan(const float* part_v, const int* part_i, float* out_v,
                        int* out_i, void* scratch, int m, int splits, int k,
                        int groups, int rows, void* stream) {
  return launch(part_v, part_i, out_v, out_i, scratch, m, splits, k, groups,
                rows, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
