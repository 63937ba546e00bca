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
// The cores:
// - "bf16x3" (the default precision) runs on the tensor cores: three bf16
//   products per k-step (qh.ch, qh.cl, ql.ch) with f32 accumulators, the
//   counterpart of the TPU's three bf16 MXU passes.  Products of bf16
//   values are exact in f32; hh and (hl + lh) accumulate apart and are
//   summed last, the grouping of the TPU kernel.  Its prepared [hi | lo]
//   corpus rows stream through the ring of the stored cores (below), a
//   position's hi and lo pieces of the same 32 or 64 features (ring_core)
//   in one stage, into
//   mma.sync at every query tile (warp w owns corpus columns [8w, 8w+8) of
//   the tile, with the k slots and product order of the per-tile core it
//   replaced, so the scores are that core's bit for bit; wgmma_core says
//   why tile 64 is not the warpgroup consumer's).
// - "highest" (the TPU kernel's f32 product, fused_topk.py:1294-1295, the
//   else branch of :1257-1296) runs on CUDA cores: f32 FMA on register
//   tiles of 4 query x 4 corpus rows a thread, fed by the ring of raw f32
//   corpus bytes (fused_topk_f32_kernel, below).
//   TF32 would not hold f32 semantics.
// - "bf16c", "int8c", "int4c": the corpus is stored as one bf16 half,
//   int8 codes, or int8 bytes of two signed nibbles, and streams through
//   a ring of raw bytes (below) that is decoded to bf16 as it is read
//   (integers up to 256 are exact in bf16); two products per k-step
//   (mma.sync, or wgmma at query tile 64) give qh.c and ql.c in two
//   accumulators, summed last (the grouping of
//   fused_topk.py:1292-1293).  int8c / int4c then compute s = d * scale +
//   bias with the scale and bias rows of the (2, n) operand (scale =
//   1/|codes| for cosine, the dequant scale otherwise), rounded as two
//   separate operations, not one FMA, so the plain PyTorch version gives
//   the same bits; bf16c adds the bias row.  int4 layout (quantize_int4):
//   in each ck-wide feature chunk, byte j holds feature j (low nibble) and
//   feature j + ck/2 (high); ck is a multiple of 128.  Corpus rows are not
//   padded: int8 codes are dim bytes a row, int4 rows dpp/2 bytes (dpp =
//   dim padded as feature_geometry says, the padding nibbles zero).
//
// What bounds it on the H100: at the 1000 x 10000 x 256 canonical shape
// the bf16x3 product is 7.7 G multiply-adds, about 0.02 ms of bf16 tensor
// core time at the published peak, so the product is not the limit; the
// staging and the selection are.  Staged per tile, each 32-feature chunk
// of the query tile and 64 corpus rows was loaded, waited for, multiplied
// and waited for again, the whole query tile copied anew for every corpus
// tile, and each warp re-read every A fragment of the query from shared
// memory; now the ring keeps copies in flight across tiles and stages the
// query once a block where it fits (PERF.md has the times; the fragments
// are still re-read per warp).  The selection looks only at the tile
// scores that beat the row's current threshold (strict >, so a later
// index never displaces an equal earlier one).  Up to k = 16 they are
// inserted into the sorted carry (or, asked for, kept in per-lane cells
// of the bucket selection); up to kAppendMaxK they are appended to a
// slack and compacted into the carry in batches; above it they are
// appended to an unsorted buffer of 2k entries whose threshold a radix
// select raises, sorted once at the split's end (the selection's section
// below says why).
//
// "highest" needs 5.1 G f32 FMA at the canonical shape, 0.076 ms at the
// 67 TFLOP/s FMA peak.  The per-tile core it replaced staged each tile with
// plain loads and a barrier, copied the whole query tile again for every
// corpus tile, and read shared memory for every product (0.5 FMA a byte
// at query tile 64).  Now the corpus streams through the ring across
// steps, the query tile is staged once a block where it fits, and each
// thread's 16-byte reads feed a 4 x 4 register tile.  What bounds it now
// (PERF.md, H100): the products alone (the selection taken out) run at
// 46 % of the FMA peak at 256 queries x 2M x 256, held by the shared
// memory the tiles read and the ring writes and by a barrier a position
// (a 4 x 8 tile read less and ran no faster; 32 features a position at
// query tile 64 beat 16; an 8 x 8 tile spills at two blocks an SM), and
// the selection, on the same warps, takes about a third of the canonical
// k=10 time and about half at k >= 100.
//
// The stored cores serve corpora too large for f32.  At the 10M x 768
// north-star shape a batch-8 int8 request must read 7.68 GB of codes plus
// 80 MB of scale | bias: 2.3 ms of HBM at 3.35 TB/s, so the bytes bound
// it, and storing fewer of them is the first answer (a quarter of f32's
// bytes, an eighth for int4).  The second is keeping enough of them in
// flight.  A block's loads used to land before its products and its
// selection ran, so only other blocks overlapped them, and int4 moved its
// packed bytes twice.  Now each block (fused_topk_stored_kernel) streams
// its whole split through an asynchronous ring in shared memory
// (tile_scores.cuh::ring_walk): cp.async copies of the raw stored bytes,
// each byte once, run a few stages ahead of the products and straight
// across tile boundaries, so the next tile's first chunks load while this
// tile is selected; the bytes are decoded to bf16 only as the products
// read them; a small batch's query tile is staged once a block, not once
// a tile.
//
// At batch 256 (query tile 64: m > 32, k <= 128) the two bf16 products
// (7.9 TFLOP at 10M x 768, 8 ms at the bf16 peak) were the bound the
// stored cores could not approach on mma.sync: with a warp owning 8 corpus
// columns, every warp re-read the whole 64-row [hi | lo] query tile from
// shared memory for each tile.  Tile 64 now has its own consumer
// (fused_topk_wgmma_kernel, ring_wgmma.cuh): two warpgroups, each decoding
// two 64-row corpus tiles a step into wgmma's register A operand; the
// query tile as the B operand, read by the tensor cores through matrix
// descriptors, so no warp loads it.  Its ring is Hopper's: one thread
// issues 2-D bulk-tensor (TMA) loads of the raw corpus bytes and the
// query columns, full and empty mbarriers hand each stage between that
// producer and the two warpgroups, stages - 1 positions ahead, with no
// block barrier on the ring's path.  The query columns ride the ring (64
// query rows x 768 features do not fit beside the carry), so each stage
// of 256 corpus rows loads as many query bytes as int8 corpus bytes, and
// each 64-row query tile reads the corpus again: 61 GB at 10M x 768 int8,
// batch 256.  PERF.md has what bounds it.
// Batches of up to 32 queries and k > 128 keep the mma.sync consumer
// (query tiles 16 and 32), bound by bytes.
//
// Ragged edges: query rows >= m, corpus rows >= n and features >= dim are
// handled by the kernel's own bounds; nothing needs padding.  A carry slot
// that nothing filled holds (-inf, INT32_MAX).
//
// The staging and score-tile functions (the tensor-core cores, the ring,
// the epilogue, the int4 decode) live in tile_scores.cuh, shared with
// kernel D (floor.cu), which measures them without the selection.

#include "ring_wgmma.cuh"
#include "tile_scores.cuh"

#include <type_traits>

// This file is compiled twice: as itself, and as the body of
// fused_topk_gstack.cu (PMM_GSTACK_UNIT), which instantiates the gstack
// selection's kernels, and nothing else, in a compiler process of their
// own (the build runs one a source, all at once).  There they launch
// through pmm_fused_topk_gstack_launch (arguments as launch_kernel's,
// with tm, core and listed, on the instantiation gstack_kernel_of picks).
extern "C" int pmm_fused_topk_gstack_launch(
    const void* qp, const void* cp, const float* scale, const float* cb,
    const uint8_t* mask, const int* tiles, float* part_v, int* part_i, int m,
    int n, int dim, int c_ld, int ck, int k, int splits, int tiles_per_split,
    int p, int tn_tiles, int block_rows, int tm, int core, int listed,
    int prune, int* gate_count, int* sel_count, int* flags, void* stream);
// The same for the stack selection of a dense scan, instantiated in
// fused_topk_stack.cu (PMM_STACK_UNIT) where stack_built: it has no
// counters and no re-walk.
extern "C" int pmm_fused_topk_stack_launch(
    const void* qp, const void* cp, const float* scale, const float* cb,
    const uint8_t* mask, float* part_v, int* part_i, int m, int n, int dim,
    int c_ld, int ck, int k, int splits, int tiles_per_split, int tm,
    int core, int prune, int* gate_count, void* stream);
// The same for the gstack selection above kAppendMaxK, instantiated in
// fused_topk_gstack_big.cu (PMM_GSTACK_BIG_UNIT) on gstack_big_plan's
// depth.
extern "C" int pmm_fused_topk_gstack_big_launch(
    const void* qp, const void* cp, const float* scale, const float* cb,
    const uint8_t* mask, const int* tiles, float* part_v, int* part_i, int m,
    int n, int dim, int c_ld, int ck, int k, int splits, int tiles_per_split,
    int p, int tn_tiles, int block_rows, int tm, int core, int listed,
    int prune, int* gate_count, int* sel_count, int* flags, void* stream);

namespace {

constexpr int kINT32_MAX = 0x7fffffff;

// ---------------------------------------------------------------------------
// The selection and carry.
//
// Each query row keeps a carry of k entries in shared memory, sorted by
// (value desc, index asc), ready to write out.  Its k-th value is the
// row's threshold: a tile's score is a candidate only if it beats it
// (strict >, so a later index never displaces an equal earlier one, and
// NaN and -inf never enter).  One warp takes a row's turn on each tile.
//
// k up to kInsertMaxK inserts the candidates one by one (select_tile): a
// warp-wide count and shift of the carry each, or, for many, a sort of
// the tile's 64 and one merge pass.  Above it, each is O(k / 32) a
// candidate or O(k) a tile, and at the canonical shape a sixth to a
// quarter of a split's scores are candidates.  There the candidates are
// appended (append_tile): a ballot and a prefix count place them at the
// end of the row's unsorted slack, with no search and no shift.  When the
// slack cannot take a tile's candidates, the slack and the tile are
// compacted at once (compact_row): 128 keys at a time sorted in registers
// by a bitonic network, then merged into the carry by bitonic merges of
// carry chunks in registers, which raises the threshold.  At the end of
// the split the slack is compacted once more.  The order is decided on
// exact 64-bit keys (sel_key), so the carry is the insertion's bit for
// bit, and nothing needs re-running.
//
// Above kAppendMaxK the sorted carry itself is the cost: each candidate
// passed through a 128-key sort and merges over every chunk of the carry,
// about 90 compare-exchanges of 64-bit keys at k = 512.  There the radix
// selection (radix_tile) keeps no order during the walk.  A row's
// candidates are appended, as sel_keys, to an unsorted buffer of 2k
// entries, and the row's threshold is one word.  When the buffer cannot
// take a tile's candidates, radix_select finds the k-th best buffered key
// exactly (one histogram pass a kRadixBits-bit digit, from the top, until
// the digit's bucket holds exactly the entries still wanted), keeps the k
// entries at or above it and raises the threshold to its value; the
// tile's scores are then filtered again.  Ties stay exact: buffered
// indices are below the tile's, and the key carries the index.  At the
// split's end one more select leaves k entries, and one bitonic sort
// orders them (radix_finish).  Each candidate costs an append and a few
// histogram reads, whatever k is.
//
// The bucket selection (SEL kBucket, k up to kInsertMaxK, on request) is
// the port of the TPU kernel's _select_bucket (fused_topk.py:1083, with
// _bucket_top3 :995 and _merge_narrow :1024).  There one pass over a tile
// keeps each lane class's best two, merges those into the carry, and a
// class's third best, where it could belong in the top-k, sends the whole
// tile through the exact extraction again.  On this card a tile's scores
// are gone once the next tile is scored, so a re-run would mean scoring
// it again; what bounds a selection here is the warp-wide work each
// candidate costs (a count and a shift of the carry, a ballot a half
// tile), not a pass over the tile.  So the bucket keeps its cells across
// tiles, and nothing it pushes out is lost.  A cell is a (query row,
// class) pair, the class being a lane (columns lane and 32 + lane of
// every tile), and lives in that lane's registers: the best two (value,
// index) of the row's scores in the class that beat the row's threshold,
// the carry's k-th value when the window began.  Updating it takes no
// shuffle and no barrier.  What a cell pushes out goes to the row's
// overflow list, in the merge lists' place (kTN / rows-a-warp entries).
// A window ends when the overflow cannot take a tile's pushes, or at the
// split's end: the carry, the cells and the overflow merge as sel_keys by
// k extraction steps of the warp's best key (bucket_merge, the port of
// _merge_narrow), which raises the threshold.  Every score that
// beats the window's threshold is in a cell or in the overflow when the
// window ends, so the carry is the insertion's, bit for bit, without a
// re-run; NaN never passes the strict >.  The first tile of a split fills
// every cell (two scores a lane), so the second ends the first window.
// The cells take 4 R registers a thread (R = TM / kWarps query rows a
// warp): the bucket is built where they fit (bucket_tile).  What bounds
// it here (PERF.md, H100): a window's threshold is stale, so more scores
// pass than the insertion takes (at 2M x 256 batch 8 k=10, about 55
// overflow entries and 3.6 windows a row and split), and the cells cost
// the walks registers; what it saves is the insertion's ballots a row
// and tile.  It came out level with the insertion or 1-9 % slower but in
// a few cells of the highest core at query tile 16 (1-2 % faster), so
// selection="auto" keeps the insertion.
//
// The gstack selection (SEL kGstack, k up to kAppendMaxK, on request) is
// the port of the TPU kernel's gstack build and its pop finish
// (_gstack_update fused_topk.py:608, _gstack_fast_levels :726, the
// detector of _gstack_decode :752, _gpop_finish :922).  There each (row,
// lane class) cell keeps its best L entries across the corpus, one pop
// finish takes the top k, and a cell whose deepest entry is among them
// may have dropped a winner, so the whole corpus is extracted again.
// Here a block walks one split, so the split is the segment: each (row,
// column of the 64-column tile) cell keeps its best `levels` sel_keys
// across the split, sorted, in shared memory (gstack_tile; a score enters
// only if it beats the row's bound and then its cell's deepest entry, one
// compare each, with no ballot, append or barrier); at the split's end
// k pops of the warp's best cell head write the split's list
// (gstack_finish), and a row fires when a pop takes some cell's deepest
// entry.  A block with a fired row sets its flag, and the launch that
// follows (the exact selection's kernel on the same grid, every block
// with a clear flag returning at once) walks that split again exactly, so
// the lists are the insertion's or the slack's bit for bit on every
// input.  gstack_levels sets the depth from the cost of a re-walk.
//
// Above kAppendMaxK (SEL kGstackBig, the port of the JAX kernel's big-k
// gstack: _bigk_depth :539 and the same build, detector and finish, with
// _chunked_top_k :643) a cell sees one score a tile, so stacks as deep as
// the split is long never drop one: gstack_big_plan takes that depth
// wherever it fits (the host's gstack_geometry cuts the splits to it), and
// then nothing can fire and no re-walk is launched.  The row bound is one
// warp min-reduction (gstack_big_tile says why it is exact).
//
// Each kernel is built once a selection it can take (SEL: kInsert,
// kAppend, kRadix, kBucket, kGstack), so that none carries another's code
// and registers.
//
// The slack lives in the block's own output rows, part_v / part_i[row]
// [split][0, slack_entries(k)) (k entries a row, unused until the carry
// is written out, L2-resident in practice): the shared memory plans leave
// no room for one at the canonical query tile 64, k = 100, without losing
// two blocks an SM (PERF.md).  Shared memory keeps the insertion's
// layout: the score tile, the carry, then 2 kWarps kTN words for the
// insertion's merge lists, of which the slack's counts take TM.
//
// The radix selection keeps the same bytes: after the score tile, each
// row's threshold and buffer count (2 TM words), then the row's first k
// buffer entries as 64-bit keys in the carry's 8 k bytes, then each
// warp's digit counts (kRadixWords words) in the merge lists' place.  The
// buffer's other k entries are the row's output slots, part_v / part_i
// holding a key's high and low words, which the split's end overwrites
// once every survivor is in shared memory.
// ---------------------------------------------------------------------------

// The largest k that inserts; larger k appends (chosen by measurement on
// the H100, PERF.md).
constexpr int kInsertMaxK = 16;
// The largest k that appends to the slack; larger k takes the radix
// selection (chosen by measurement on the H100, PERF.md).  A full buffer
// holds at least k entries only from k = 64 on (2k - 64 >= k).
constexpr int kAppendMaxK = 128;
static_assert(kAppendMaxK >= 63, "the radix selection needs k >= 64");
// Slack entries a row at most.
constexpr int kSlackMax = 192;
// The radix select's digit, and the words of a warp's counts: two 16-bit
// counts a word (a row buffers at most 2048 entries).
constexpr int kRadixBits = 7;
constexpr int kRadixWords = (1 << kRadixBits) / 2;

// kGstackBig is the gstack selection above kAppendMaxK: the launch's alt
// asks for it as kGstack.
enum Selection { kInsert = 0, kAppend = 1, kRadix = 2, kBucket = 3,
                 kGstack = 4, kGstackBig = 5, kStack = 6 };

// Whether SEL is either gstack selection.
__host__ __device__ constexpr bool gstack_sel(int sel) {
  return sel == kGstack || sel == kGstackBig;
}

// Whether SEL's threshold is a word a row (the carry gate's WORD).
__host__ __device__ constexpr bool word_bound(int sel) {
  return sel == kRadix || gstack_sel(sel) || sel == kStack;
}

__host__ __device__ constexpr int selection(int k) {
  return k <= kInsertMaxK ? kInsert : k <= kAppendMaxK ? kAppend : kRadix;
}

// The query tiles a core's walk takes the bucket selection at: the cells
// take 4 TM / kWarps registers a thread, which the mma.sync ring finds at
// query tiles 16 and 32 and the f32 walk at 16; at 32 the f32 walk and at
// 64 both walks spilled (PERF.md has ptxas's figures), and the warpgroup
// consumer's accumulators take 128.
__host__ __device__ constexpr bool bucket_tile(int tm, int core) {
  return tm <= (core == kHighest ? 16 : 32);
}

// Whether a launch that asks for the bucket selection takes it: k up to
// kInsertMaxK where bucket_tile; elsewhere it keeps selection(k).
__host__ __device__ constexpr bool bucket_built(int tm, int core, int k) {
  return k <= kInsertMaxK && bucket_tile(tm, core) &&
         !(stored_core(core) && tm == kWgTM);
}

// Slack entries of a row at this k: with a tile's 64 scores they fill two
// batches of 128 keys (k >= kSlackMax) or one (k >= 64), else the row's
// k output slots.  Chosen by measurement on the H100 (PERF.md): at k =
// 100 a slack of 100 (two batches a compaction, the second mostly empty)
// cost more than one of 64; at k = 512 a slack of 64 cost more than one
// of 192.
__host__ __device__ constexpr int slack_entries(int k) {
  return k >= kSlackMax ? kSlackMax : k >= 64 ? 64 : k;
}

// Shared memory after the staging: the score tile, the carry, the merge
// lists (the slack's counts).
__host__ __device__ inline size_t tail_bytes(int tm, int k) {
  return (size_t)tm * (kTN + 1) * sizeof(float)              // score tile
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
// Out of line: its registers stay out of the product's budget.  COPY 1 is
// the warpgroup kernels' own copy: ptxas fits an out-of-line function's
// registers to all its callers, and sharing one with them cost the
// listed bf16x3 ring at query tile 16 a spill on the H100.
template <int COPY>
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

// The inserting selection of one TM x TN score tile (k <= kInsertMaxK):
// one warp per query row.  Few candidates are inserted one by one in
// index order; many are merged at once (carry_merge<COPY>), which costs a
// sort of the 64 plus one pass over the carry.
template <int TM, int COPY = 0>
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
      carry_merge<COPY>(cv, ci, k, s0, s1, c0, c1, cnt, n0, lane, lv, li);
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

// The order of the selection as one 64-bit key, the greater the better:
// the high word holds the value's orderable bits, -0.0 taken as +0.0 (so
// the order is the float compare's), the low word ~(2 index + [the value
// is -0.0]), so the lower index wins a tie and the key gives back the
// value's bits.  Real entries' keys are distinct and above kEmptyKey, the
// key of an empty slot (-inf, INT32_MAX).  fused_topk.select_keys is the
// host's mirror.
__device__ inline uint64_t sel_key(float v, int i) {
  uint32_t u = __float_as_uint(v);
  const uint32_t nz = u == 0x80000000u;
  if (nz) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)u << 32) | (uint32_t)~(2u * (uint32_t)i + nz);
}

constexpr uint64_t kEmptyKey = 0x007fffff00000001ull;

__device__ inline float key_value(uint64_t key) {
  const uint32_t h = (uint32_t)(key >> 32);
  uint32_t u = (h & 0x80000000u) ? (h & 0x7fffffffu) : ~h;
  if (u == 0u && ((uint32_t)key & 1u) == 0u) u = 0x80000000u;   // -0.0
  return __uint_as_float(u);
}

__device__ inline int key_index(uint64_t key) {
  return (int)(~(uint32_t)key >> 1);
}

// One stage of a bitonic network over 32 E keys, key e * 32 + lane in
// a[e]: keys x and x ^ STRIDE compare; where x & SIZE is clear the block
// runs best first (the key whose x has the STRIDE bit clear keeps the
// greater), elsewhere worst first.
template <int E, int SIZE, int STRIDE>
__device__ __forceinline__ void key_stage(uint64_t (&a)[E], int lane) {
  if constexpr (STRIDE >= 32) {   // two of the lane's registers
    constexpr int R = STRIDE / 32;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((e & R) != 0) continue;
      const bool best_first = ((e * 32) & SIZE) == 0;
      const uint64_t x = a[e], y = a[e + R];
      const bool swap = best_first ? x < y : y < x;
      a[e] = swap ? y : x;
      a[e + R] = swap ? x : y;
    }
  } else {   // one register of two lanes
    const bool low = (lane & STRIDE) == 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool best_first = ((e * 32 + lane) & SIZE) == 0;
      const uint64_t y = __shfl_xor_sync(0xffffffffu, a[e], STRIDE);
      const bool greater = low == best_first;
      a[e] = (a[e] > y) == greater ? a[e] : y;
    }
  }
}

// Stages STRIDE, STRIDE / 2, ..., 1 of the network: with SIZE above 32 E,
// a bitonic sequence of 32 E keys sorted best first.
template <int E, int SIZE, int STRIDE>
__device__ __forceinline__ void key_merge(uint64_t (&a)[E], int lane) {
  if constexpr (STRIDE > 0) {
    key_stage<E, SIZE, STRIDE>(a, lane);
    key_merge<E, SIZE, STRIDE / 2>(a, lane);
  }
}

// Sort 32 E keys best first (blocks of SIZE and up).
template <int E, int SIZE = 2>
__device__ __forceinline__ void key_sort(uint64_t (&a)[E], int lane) {
  if constexpr (SIZE <= 32 * E) {
    key_merge<E, SIZE, SIZE / 2>(a, lane);
    key_sort<E, SIZE * 2>(a, lane);
  }
}

// Merge the sorted keys a (32 E, best first, empty slots last) into the
// carry row (cv, ci) of k sorted entries, keeping the best k.  From the
// first entry the best key beats, chunk by chunk of 32 E entries: the
// chunk, reversed after a, is a bitonic sequence; its better half, sorted,
// goes back in the chunk's place and its worse half goes on to the next
// chunk.  Whole warp calls.
template <int E>
__device__ inline void merge_into_carry(float* cv, int* ci, int k,
                                        uint64_t (&a)[E], int lane) {
  constexpr int P = 32 * E;
  const uint64_t top = __shfl_sync(0xffffffffu, a[0], 0);
  if (top == kEmptyKey) return;
  int pos = 0, hi = k;   // the entries better than every key stay
  while (pos < hi) {
    const int mid = (pos + hi) >> 1;
    if (sel_key(cv[mid], ci[mid]) > top) pos = mid + 1; else hi = mid;
  }
  for (; pos < k; pos += P) {
    uint64_t b[E];   // the chunk, reversed
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = pos + P - 1 - (e * 32 + lane);
      b[e] = p < k ? sel_key(cv[p], ci[p]) : kEmptyKey;
    }
    __syncwarp();   // every read of the chunk before its writes
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint64_t x = a[e], y = b[e];
      a[e] = x > y ? x : y;
      b[e] = x > y ? y : x;
    }
    key_merge<E, 2 * P, P / 2>(a, lane);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = pos + e * 32 + lane;
      if (p < k) {
        cv[p] = key_value(a[e]);
        ci[p] = key_index(a[e]);
      }
    }
    // The worse half holds real keys while the carry below is full.
    bool real = false;
#pragma unroll
    for (int e = 0; e < E; ++e) real |= b[e] != kEmptyKey;
    if (pos + P >= k || !__any_sync(0xffffffffu, real)) break;
    key_merge<E, 2 * P, P / 2>(b, lane);
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] = b[e];
  }
  __syncwarp();
}

// The keys of a compaction, 32 E of them: with `tile`, the tile's
// candidates (c0, c1: scores s0, s1 of corpus rows n0 + lane and n0 + 32 +
// lane) as keys lane and 32 + lane, then the slack's nb entries (sv, si);
// empty slots after.
template <int E>
__device__ __forceinline__ void compact_keys(uint64_t (&a)[E],
                                             const float* sv, const int* si,
                                             int nb, bool tile, float s0,
                                             float s1, bool c0, bool c1,
                                             int n0, int lane) {
  const int base = tile ? 64 : 0;   // the slack's first key
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int x = e * 32 + lane;
    if (e < 2 && tile) {
      a[e] = (e ? c1 : c0) ? sel_key(e ? s1 : s0, n0 + x) : kEmptyKey;
    } else {
      const int j = x - base;
      a[e] = j >= 0 && j < nb ? sel_key(sv[j], si[j]) : kEmptyKey;
    }
  }
}

// Keys a lane of a compaction batch: 4 (batches of 128 keys), but 2 (of
// 64) in the int4 core's walk at query tile 32, where ptxas found no
// registers for 4 beside the walk's (it spilled).
__host__ __device__ constexpr int compact_lanes(int tm, int core) {
  return core == kInt4c && tm == 32 ? 2 : 4;
}

// Compact a row: the tile's candidates (with `tile`) and the slack's nb
// entries, in batches of 32 E keys (E a lane: the tile and the slack's
// first 32 E - 64 entries, then the slack's next 32 E), each sorted in
// registers and merged into the carry.  Whole warp calls.  Inline, at
// few keys a lane: as a call, ptxas saved the walk's live registers
// around it, and with 8 keys a lane it spilled.
template <int E>
__device__ __forceinline__ void compact_row(float* cv, int* ci, int k,
                                            const float* sv, const int* si,
                                            int nb, bool tile, float s0,
                                            float s1, bool c0, bool c1,
                                            int n0, int lane) {
  int first = 0;   // the batch's first slack entry
#pragma unroll 1
  for (;;) {
    uint64_t a[E];
    const int take = tile ? 32 * E - 64 : 32 * E;
    compact_keys<E>(a, sv + first, si + first, min(nb - first, take), tile,
                    s0, s1, c0, c1, n0, lane);
    key_sort<E>(a, lane);
    merge_into_carry<E>(cv, ci, k, a, lane);
    first += take;
    tile = false;
    if (first >= nb) break;
  }
}

// The appending selection's state: the carries (TM x k values at Cv, then
// TM x k indices), then, in the insertion's merge lists' place, each
// row's slack count; the slack of query row r is its output row's first
// slack_entries(k) slots.  The kernels pass Cv and their arguments, and
// everything else is derived here, so the walk keeps none of it live.
template <int TM>
__device__ inline int* carry_ids(float* Cv, int k) {
  return reinterpret_cast<int*>(Cv + (size_t)TM * k);
}
template <int TM>
__device__ inline int* slack_counts(float* Cv, int k) {
  return carry_ids<TM>(Cv, k) + (size_t)TM * k;
}

// The appending selection of one TM x kTN score tile (k > kInsertMaxK):
// one warp per query row.  A row's candidates go to the end of its slack;
// when the slack cannot take them, the slack and the tile compact into
// the carry at once.  part_v, part_i, row0, splits, split: the kernel's
// output and the block's place in it.  The slack's place, its count and
// the carry's indices are derived where they are used: held across the
// row loop they cost the walks registers they do not have.
template <int TM, int E>
__device__ inline void append_tile(const float* St, float* Cv, int k, int n0,
                                   int rows_valid, int warp, int lane,
                                   float* part_v, int* part_i, int row0,
                                   int splits, int split) {
  for (int r = warp; r < rows_valid; r += kWarps) {
    float* cv = Cv + (size_t)r * k;
    const float s0 = St[r * (kTN + 1) + lane];
    const float s1 = St[r * (kTN + 1) + 32 + lane];
    const float kth = cv[k - 1];
    const bool c0 = s0 > kth, c1 = s1 > kth;
    const unsigned b0 = __ballot_sync(0xffffffffu, c0);
    const unsigned b1 = __ballot_sync(0xffffffffu, c1);
    const int cnt = __popc(b0) + __popc(b1);
    if (cnt == 0) continue;
    int* count = slack_counts<TM>(Cv, k) + r;
    const size_t o = ((size_t)(row0 + r) * splits + split) * k;
    const int nb = *count;
    if (nb + cnt > slack_entries(k)) {
      compact_row<E>(cv, carry_ids<TM>(Cv, k) + (size_t)r * k, k,
                     part_v + o, part_i + o, nb, true, s0, s1, c0, c1, n0,
                     lane);
      if (lane == 0) *count = 0;
    } else {
      const unsigned below = (1u << lane) - 1u;
      if (c0) {
        const size_t j = o + nb + __popc(b0 & below);
        part_v[j] = s0;
        part_i[j] = n0 + lane;
      }
      if (c1) {
        const size_t j = o + nb + __popc(b0) + __popc(b1 & below);
        part_v[j] = s1;
        part_i[j] = n0 + 32 + lane;
      }
      if (lane == 0) *count = nb + cnt;
    }
    __syncwarp();
  }
}

// The appending selection's end of a split, after the walk's last
// barrier: compact what each row's slack still holds, then a barrier
// before the carries are written out over it.
template <int TM, int E>
__device__ inline void flush_slack(float* Cv, int k, int rows_valid, int warp,
                                   int lane, float* part_v, int* part_i,
                                   int row0, int splits, int split) {
  for (int r = warp; r < rows_valid; r += kWarps) {
    const int nb = slack_counts<TM>(Cv, k)[r];
    const size_t o = ((size_t)(row0 + r) * splits + split) * k;
    if (nb > 0)
      compact_row<E>(Cv + (size_t)r * k,
                     carry_ids<TM>(Cv, k) + (size_t)r * k, k, part_v + o,
                     part_i + o, nb, false, 0.f, 0.f, false, false, 0, lane);
  }
  __syncthreads();
}

// The radix selection's state (the section's head has the layout): Cv is
// the word after the score tile.
static_assert(kRadixWords == 64, "radix_select's scan reads 2 words a lane");
template <int TM>
__device__ inline int* radix_counts(float* Cv) {
  return reinterpret_cast<int*>(Cv + TM);
}
template <int TM>
__device__ inline uint64_t* radix_keys(float* Cv) {
  return reinterpret_cast<uint64_t*>(Cv + 2 * TM);
}
template <int TM>
__device__ inline unsigned* radix_hist(float* Cv, int k, int warp) {
  return reinterpret_cast<unsigned*>(radix_keys<TM>(Cv) + (size_t)TM * k) +
         warp * kRadixWords;
}

// Entry j of a row's buffer: its first k in shared memory (key), the rest
// in the row's output slots (gv, gi: the key's high and low words).
__device__ __forceinline__ uint64_t buffered(const uint64_t* key,
                                             const unsigned* gv,
                                             const int* gi, int k, int j) {
  if (j < k) return key[j];
  return ((uint64_t)gv[j - k] << 32) | (uint32_t)gi[j - k];
}

__device__ __forceinline__ void buffer(uint64_t* key, unsigned* gv, int* gi,
                                       int k, int j, uint64_t x) {
  if (j < k) {
    key[j] = x;
  } else {
    gv[j - k] = (unsigned)(x >> 32);
    gi[j - k] = (int)(uint32_t)x;
  }
}

// Entries a lane reads at once in radix_select: loads in flight, since
// the buffer's second half lives in L2.
constexpr int kRadixBatch = 8;

// Whether a walk's select takes its lean form (one loop over the buffer,
// every pass on 64-bit keys): the int4 core's at query tile 32, where
// ptxas found no registers for the two loops and the high-word passes
// beside the walk's (it spilled).
__host__ __device__ constexpr bool radix_lean(int tm, int core) {
  return core == kInt4c && tm == 32;
}

// Calls f(x, j) on each entry j of [j0, j1) of a row's buffer (j0 = 0,
// j1 <= k: shared memory; j0 = k: the output slots), B a lane loaded
// before any is used.  Whole warp calls; f runs on every lane, with j >=
// j1 for no entry.
template <int B, typename F>
__device__ __forceinline__ void each_buffered(const uint64_t* key,
                                              const unsigned* gv,
                                              const int* gi, int k, int j0,
                                              int j1, int lane, F&& f) {
  for (int jb = j0; jb < j1; jb += 32 * B) {
    uint64_t x[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int j = jb + 32 * b + lane;
      x[b] = j < j1 ? buffered(key, gv, gi, k, j) : 0ull;
    }
#pragma unroll
    for (int b = 0; b < B; ++b) f(x[b], jb + 32 * b + lane);
  }
}

// The k-th best of a row's nb >= k buffered keys, exactly: digits of
// kRadixBits bits from the top, one pass over the entries a digit, each
// counting the digits of the entries that match the digits found so far
// (two 16-bit counts a word of the warp's hist); the digit whose bucket
// holds the k-th is kept, until that bucket holds exactly the entries
// still wanted.  A pass whose digit lies in the high word reads and
// shifts that word alone.  Then the k entries at or above those digits
// move, in buffer order, to the row's first k places (shared memory), and
// the least of them is returned.  Whole warp calls.  Inline: as a call,
// ptxas kept the walk's registers across it, and spilled.  (Counts in
// registers, 4-bit digits, took more passes and more integer work an
// entry, and were slower on the H100.)  LEAN: radix_lean.
template <bool LEAN>
__device__ __forceinline__ uint64_t radix_select(uint64_t* key, unsigned* gv,
                                                 int* gi, int k, int nb,
                                                 unsigned* hist, int lane) {
  uint64_t prefix = 0;   // the digits found, in place
  int top = 64;          // the bits at and above top are found
  int want = k;          // the rank of the k-th among the matching entries
  const int ns = nb < k ? nb : k;   // the entries in shared memory
  for (;;) {
    const int width = top < kRadixBits ? top : kRadixBits;
    const int shift = top - width;
    const unsigned mask = (1u << width) - 1u;
    hist[lane] = 0u;
    hist[lane + 32] = 0u;
    __syncwarp();
    auto add = [&](unsigned d) {
      atomicAdd(hist + (d >> 1), 1u << ((d & 1u) * 16));
    };
    if constexpr (LEAN) {
      const uint64_t pre = top == 64 ? 0ull : prefix >> top;
      each_buffered<kRadixBatch>(key, gv, gi, k, 0, nb, lane,
                                 [&](uint64_t x, int j) {
        if (j < nb && (top == 64 || (x >> top) == pre))
          add((unsigned)(x >> shift) & mask);
      });
    } else if (shift >= 32) {   // the digit and the bits above: high word
      const int s = shift - 32, t = top - 32;
      const unsigned pre = t < 32 ? (unsigned)(prefix >> 32) >> t : 0u;
      auto count = [&](uint64_t x, int j) {
        const unsigned h = (unsigned)(x >> 32);
        if (j < nb && (top == 64 || (t < 32 ? h >> t : 0u) == pre))
          add((h >> s) & mask);
      };
      each_buffered<kRadixBatch>(key, gv, gi, k, 0, ns, lane, count);
      each_buffered<kRadixBatch>(key, gv, gi, k, k, nb, lane, count);
    } else {
      const uint64_t pre = prefix >> top;
      auto count = [&](uint64_t x, int j) {
        if (j < nb && (x >> top) == pre) add((unsigned)(x >> shift) & mask);
      };
      each_buffered<kRadixBatch>(key, gv, gi, k, 0, ns, lane, count);
      each_buffered<kRadixBatch>(key, gv, gi, k, k, nb, lane, count);
    }
    __syncwarp();
    // Lane L holds digits 4L .. 4L + 3; from the top digit down, the
    // bucket that holds the want-th entry.
    const unsigned w0 = hist[2 * lane], w1 = hist[2 * lane + 1];
    const int c0 = w0 & 0xffffu, c1 = w0 >> 16, c2 = w1 & 0xffffu,
              c3 = w1 >> 16;
    const int mine = c0 + c1 + c2 + c3;
    int upto = mine;   // this lane's digits and every greater one
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_down_sync(0xffffffffu, upto, off);
      if (lane + off < 32) upto += v;
    }
    int above = upto - mine, d = 0, cnt = 0;
    const bool here = above < want && want <= upto;
    if (here) {
      if (above + c3 >= want) {
        d = 3; cnt = c3;
      } else if (above + c3 + c2 >= want) {
        d = 2; cnt = c2; above += c3;
      } else if (above + c3 + c2 + c1 >= want) {
        d = 1; cnt = c1; above += c3 + c2;
      } else {
        d = 0; cnt = c0; above += c3 + c2 + c1;
      }
      d += 4 * lane;
    }
    const int src = __ffs(__ballot_sync(0xffffffffu, here)) - 1;
    d = __shfl_sync(0xffffffffu, d, src);
    cnt = __shfl_sync(0xffffffffu, cnt, src);
    above = __shfl_sync(0xffffffffu, above, src);
    __syncwarp();   // every count read before the next pass clears them
    want -= above;
    prefix |= (uint64_t)d << shift;
    top = shift;
    if (cnt == want) break;
  }
  // Exactly k entries have their bits from top up at or above the prefix.
  // A batch's entries move, after all of them are read, to places below
  // every entry a later batch reads.
  const uint64_t floor_digits = prefix >> top;
  uint64_t least = ~0ull;
  int base = 0;
  auto keep = [&](uint64_t x, int j) {
    const bool in = j < nb && (x >> top) >= floor_digits;
    const unsigned bal = __ballot_sync(0xffffffffu, in);
    if (in) {
      key[base + __popc(bal & ((1u << lane) - 1u))] = x;
      least = x < least ? x : least;
    }
    base += __popc(bal);
  };
  for (int j0 = 0; j0 < nb; j0 += 32 * kRadixBatch) {
    uint64_t x[kRadixBatch];
#pragma unroll
    for (int b = 0; b < kRadixBatch; ++b) {
      const int j = j0 + 32 * b + lane;
      x[b] = j < nb ? buffered(key, gv, gi, k, j) : 0ull;
    }
    __syncwarp();
#pragma unroll
    for (int b = 0; b < kRadixBatch; ++b) keep(x[b], j0 + 32 * b + lane);
  }
  const unsigned hi = __reduce_min_sync(0xffffffffu, (unsigned)(least >> 32));
  const unsigned lo = __reduce_min_sync(
      0xffffffffu, (unsigned)(least >> 32) == hi ? (unsigned)least : ~0u);
  __syncwarp();
  return ((uint64_t)hi << 32) | lo;
}

// Appends a row's candidates (c0, c1: the scores s0, s1 of corpus rows n0
// + lane and n0 + 32 + lane) to its buffer of nb entries, by ballot and
// prefix count, lanes in order.
__device__ __forceinline__ void radix_append(uint64_t* key, unsigned* gv,
                                             int* gi, int k, int nb,
                                             float s0, float s1, bool c0,
                                             bool c1, unsigned b0,
                                             unsigned b1, int n0, int lane) {
  const unsigned below = (1u << lane) - 1u;
  if (c0) buffer(key, gv, gi, k, nb + __popc(b0 & below),
                 sel_key(s0, n0 + lane));
  if (c1) buffer(key, gv, gi, k, nb + __popc(b0) + __popc(b1 & below),
                 sel_key(s1, n0 + 32 + lane));
}

// radix_tile on a row whose buffer cannot take the tile's candidates: the
// select, the threshold raised, the tile filtered again and appended.
template <int TM, bool LEAN>
__device__ __forceinline__ void radix_refill(const float* St, float* Cv, int k,
                                          int r, int n0, int warp, int lane,
                                          float* part_v, int* part_i) {
  uint64_t* key = radix_keys<TM>(Cv) + (size_t)r * k;
  unsigned* gv = reinterpret_cast<unsigned*>(part_v);
  int* count = radix_counts<TM>(Cv) + r;
  const float thr = key_value(radix_select<LEAN>(
      key, gv, part_i, k, *count, radix_hist<TM>(Cv, k, warp), lane));
  const float s0 = St[r * (kTN + 1) + lane];
  const float s1 = St[r * (kTN + 1) + 32 + lane];
  const bool c0 = s0 > thr, c1 = s1 > thr;
  const unsigned b0 = __ballot_sync(0xffffffffu, c0);
  const unsigned b1 = __ballot_sync(0xffffffffu, c1);
  radix_append(key, gv, part_i, k, k, s0, s1, c0, c1, b0, b1, n0, lane);
  if (lane == 0) {
    Cv[r] = thr;
    *count = k + __popc(b0) + __popc(b1);
  }
  __syncwarp();
}

// The radix selection of one TM x kTN score tile (k > kAppendMaxK): one
// warp per query row.  The row's candidates (s > its threshold) go to the
// end of its buffer by ballot and prefix count; when the buffer cannot take
// them, radix_refill selects, raises the threshold and filters the tile
// again (k >= 64: then it fits).  LEAN: radix_lean.
template <int TM, bool LEAN>
__device__ inline void radix_tile(const float* St, float* Cv, int k, int n0,
                                  int rows_valid, int warp, int lane,
                                  float* part_v, int* part_i, int row0,
                                  int splits, int split) {
  for (int r = warp; r < rows_valid; r += kWarps) {
    const float s0 = St[r * (kTN + 1) + lane];
    const float s1 = St[r * (kTN + 1) + 32 + lane];
    const float thr = Cv[r];
    const bool c0 = s0 > thr, c1 = s1 > thr;
    const unsigned b0 = __ballot_sync(0xffffffffu, c0);
    const unsigned b1 = __ballot_sync(0xffffffffu, c1);
    if ((b0 | b1) == 0u) continue;
    const size_t o = ((size_t)(row0 + r) * splits + split) * k;
    int* count = radix_counts<TM>(Cv) + r;
    const int nb = *count;
    if (nb + __popc(b0) + __popc(b1) > 2 * k) {
      radix_refill<TM, LEAN>(St, Cv, k, r, n0, warp, lane, part_v + o,
                             part_i + o);
      continue;
    }
    radix_append(radix_keys<TM>(Cv) + (size_t)r * k,
                 reinterpret_cast<unsigned*>(part_v + o), part_i + o, k, nb,
                 s0, s1, c0, c1, b0, b1, n0, lane);
    if (lane == 0) *count = nb + __popc(b0) + __popc(b1);
    __syncwarp();
  }
}

// The top bit of m > 0.
__host__ __device__ constexpr int top_bit(int m) {
  return m >= 2 ? 2 * top_bit(m / 2) : 1;
}

// The final sort: the bitonic network in its flip form, every comparator
// keeping the better key at the lower place.  Sizes 2, 4, ..., each a
// stage of mask size - 1 (place x meets x ^ (size - 1)) then of masks
// size / 4, ..., 1; places past the keys hold kEmptyKey, which no stage
// moves below a real key.  A block of 32 E keys lives in registers, block
// place lane * E + e in a[e], so that a stage of mask below E pairs two
// registers of a lane and needs no shuffle.
template <int E, int M>
__device__ __forceinline__ void sort_stage(uint64_t (&a)[E], int lane) {
  constexpr int HI = M / E, LO = M % E, HB = top_bit(M);
  if constexpr (HI == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if ((e & HB) == 0) {
        const uint64_t x = a[e], y = a[e ^ LO];
        a[e] = x > y ? x : y;
        a[e ^ LO] = x > y ? y : x;
      }
  } else {
    const bool lower = (lane & (HB / E)) == 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (LO == 0) {
        const uint64_t y = __shfl_xor_sync(0xffffffffu, a[e], HI);
        a[e] = lower == (a[e] > y) ? a[e] : y;
      } else if (e < (e ^ LO)) {
        const uint64_t y0 = __shfl_xor_sync(0xffffffffu, a[e ^ LO], HI);
        const uint64_t y1 = __shfl_xor_sync(0xffffffffu, a[e], HI);
        a[e] = lower == (a[e] > y0) ? a[e] : y0;
        a[e ^ LO] = lower == (a[e ^ LO] > y1) ? a[e ^ LO] : y1;
      }
    }
  }
}

// Stages of masks S, S / 2, ..., 1.
template <int E, int S>
__device__ __forceinline__ void sort_halves(uint64_t (&a)[E], int lane) {
  if constexpr (S > 0) {
    sort_stage<E, S>(a, lane);
    sort_halves<E, S / 2>(a, lane);
  }
}

// Sort the block best first.
template <int E, int SIZE = 2>
__device__ __forceinline__ void sort_block(uint64_t (&a)[E], int lane) {
  if constexpr (SIZE <= 32 * E) {
    sort_stage<E, SIZE - 1>(a, lane);
    sort_halves<E, SIZE / 4>(a, lane);
    sort_block<E, SIZE * 2>(a, lane);
  }
}

// A stage of the same network over key[0, n) in shared memory (places up
// to pad, a power of two): each pair x < x ^ m with x ^ m < n.
__device__ inline void sort_stage_shared(uint64_t* key, int n, int pad, int m,
                                         int lane) {
  const int hb = 1 << (31 - __clz(m));
  for (int p = lane; p < pad / 2; p += 32) {
    const int i = ((p & ~(hb - 1)) << 1) | (p & (hb - 1));
    const int j = i ^ m;
    if (j < n) {
      const uint64_t x = key[i], y = key[j];
      if (y > x) {
        key[i] = y;
        key[j] = x;
      }
    }
  }
  __syncwarp();
}

// sort_keys in blocks of 32 E keys: each block in registers (the first
// load in any order: the keys are unordered), then, for n above a block,
// the stages of wider sizes with masks of a block and up in shared
// memory, each followed by the blocks' narrower stages in registers.
template <int E>
__device__ __forceinline__ void sort_blocks(uint64_t* key, int n, int lane) {
  constexpr int P = 32 * E;
  auto store = [&](int c0, const uint64_t (&a)[E]) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int x = c0 + lane * E + e;
      if (x < n) key[x] = a[e];
    }
  };
  for (int c0 = 0; c0 < n; c0 += P) {
    uint64_t a[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int x = c0 + e * 32 + lane;
      a[e] = x < n ? key[x] : kEmptyKey;
    }
    sort_block<E>(a, lane);
    __syncwarp();   // every read of the block before its writes
    store(c0, a);
  }
  int pad = P;
  while (pad < n) pad <<= 1;
  for (int size = 2 * P; size <= pad; size <<= 1) {
    __syncwarp();
    sort_stage_shared(key, n, pad, size - 1, lane);
    for (int s = size / 4; s >= P; s >>= 1)
      sort_stage_shared(key, n, pad, s, lane);
    for (int c0 = 0; c0 < n; c0 += P) {
      uint64_t a[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int x = c0 + lane * E + e;
        a[e] = x < n ? key[x] : kEmptyKey;
      }
      sort_halves<E, P / 2>(a, lane);
      store(c0, a);
    }
  }
  __syncwarp();
}

// Sort key[0, n) best first, in blocks of the least of 128, 256 and 512
// keys that holds them (512 above).  Whole warp calls; out of line, one
// copy for every kernel.
__device__ __noinline__ void sort_keys(uint64_t* key, int n, int lane) {
  if (n <= 128)
    sort_blocks<4>(key, n, lane);
  else if (n <= 256)
    sort_blocks<8>(key, n, lane);
  else
    sort_blocks<16>(key, n, lane);
}

// The radix selection's end of a split: each row's warp selects its
// buffer down to k, sorts the survivors and writes them out, (-inf,
// INT32_MAX) past them.  The warp that selected the row's tiles takes it,
// so no block barrier is needed.
template <int TM>
__device__ inline void radix_finish(float* Cv, int k, int rows_valid,
                                    int warp, int lane, float* part_v,
                                    int* part_i, int row0, int splits,
                                    int split) {
  for (int r = warp; r < rows_valid; r += kWarps) {
    uint64_t* key = radix_keys<TM>(Cv) + (size_t)r * k;
    const size_t o = ((size_t)(row0 + r) * splits + split) * k;
    int nb = radix_counts<TM>(Cv)[r];
    if (nb > k) {
      radix_select<false>(key, reinterpret_cast<unsigned*>(part_v + o),
                      part_i + o, k, nb, radix_hist<TM>(Cv, k, warp), lane);
      nb = k;
    }
    sort_keys(key, nb, lane);
    for (int j = lane; j < k; j += 32) {
      const bool real = j < nb;
      const uint64_t x = real ? key[j] : kEmptyKey;
      part_v[o + j] = real ? key_value(x) : -INFINITY;
      part_i[o + j] = real ? key_index(x) : kINT32_MAX;
    }
  }
}

// The radix selection's start: thresholds -inf (+inf past m, which the
// gate then never counts), empty buffers.
template <int TM>
__device__ inline void init_radix(float* Cv, int rows_valid) {
  for (int r = threadIdx.x; r < TM; r += kThreads) {
    Cv[r] = r < rows_valid ? -INFINITY : INFINITY;
    radix_counts<TM>(Cv)[r] = 0;
  }
}

// The bucket selection's cells of one thread: for query row warp +
// kWarps j of its block, the best two (value, index) of its lane's class
// in the window, best first, (-inf, INT32_MAX) where empty.
template <int R>
struct BucketCells {
  float v1[R], v2[R];
  int i1[R], i2[R];
  __device__ void clear(int j) {
    v1[j] = v2[j] = -INFINITY;
    i1[j] = i2[j] = kINT32_MAX;
  }
};

// Overflow entries a row of the bucket selection: the warp's merge lists
// (kTN entries) shared by its TM / kWarps rows, at most kBucketOverflow
// (bucket_merge reads one a lane).
constexpr int kBucketOverflow = 32;
__host__ __device__ constexpr int bucket_overflow(int tm) {
  return kTN / (tm / kWarps) < kBucketOverflow ? kTN / (tm / kWarps)
                                               : kBucketOverflow;
}

// Puts (v, id) in a cell (v beats the window's threshold; strict >, so an
// earlier index keeps a tie): returns in (pv, pi) the entry pushed out,
// -inf where the cell had room.
__device__ __forceinline__ void bucket_put(float& v1, int& i1, float& v2,
                                           int& i2, float v, int id,
                                           float& pv, int& pi) {
  if (v > v1) {
    pv = v2; pi = i2;
    v2 = v1; i2 = i1;
    v1 = v; i1 = id;
  } else if (v > v2) {
    pv = v2; pi = i2;
    v2 = v; i2 = id;
  } else {
    pv = v; pi = id;
  }
}

// The larger of two keys.
__device__ __forceinline__ uint64_t key_max(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}

// A window's end for one row, the port of _merge_narrow (fused_topk.py
// :1024): the carry's k entries (lane j holds slot j), the lane's two cell
// entries (v1, i1, v2, i2) and its overflow entry (ov, oi: o <= 32 places,
// -inf where empty, left empty), as sel_keys; k times the warp's best key
// is taken out (a max over the high words, then over the low words of the
// lanes that hold that high word: value desc, index asc) and lane t keeps
// the t-th as carry slot t.  Whole warp calls; k <= 32.  Out of line, as
// carry_merge: its registers stay out of the walk's budget.
template <int COPY>
__device__ __noinline__ void bucket_merge(float* cv, int* ci, int k, float v1,
                                          int i1, float v2, int i2,
                                          float* ov, int* oi, int o,
                                          int lane) {
  uint64_t x[4];
  x[0] = lane < k && cv[lane] > -INFINITY ? sel_key(cv[lane], ci[lane])
                                          : kEmptyKey;
  x[1] = v1 > -INFINITY ? sel_key(v1, i1) : kEmptyKey;
  x[2] = v2 > -INFINITY ? sel_key(v2, i2) : kEmptyKey;
  x[3] = kEmptyKey;
  if (lane < o) {
    if (ov[lane] > -INFINITY) x[3] = sel_key(ov[lane], oi[lane]);
    ov[lane] = -INFINITY;
  }
  uint64_t best = key_max(key_max(x[0], x[1]), key_max(x[2], x[3]));
  uint64_t mine = kEmptyKey;
  for (int t = 0; t < k; ++t) {
    const unsigned hi =
        __reduce_max_sync(0xffffffffu, (unsigned)(best >> 32));
    const unsigned lo = __reduce_max_sync(
        0xffffffffu, (unsigned)(best >> 32) == hi ? (unsigned)best : 0u);
    const uint64_t win = ((uint64_t)hi << 32) | lo;
    if (win == kEmptyKey) break;   // nothing real is left
    if (lane == t) mine = win;
    if (best == win) {   // real keys are distinct: one lane holds it
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (x[e] == win) x[e] = kEmptyKey;
      best = key_max(key_max(x[0], x[1]), key_max(x[2], x[3]));
    }
  }
  if (lane < k) {
    const bool real = mine != kEmptyKey;
    cv[lane] = real ? key_value(mine) : -INFINITY;
    ci[lane] = real ? key_index(mine) : kINT32_MAX;
  }
  __syncwarp();
}

// The bucket selection of one TM x kTN score tile (k <= kInsertMaxK): each
// warp takes its rows (warp + kWarps j).  A row whose scores all fail its
// threshold costs one vote.  Otherwise, when the overflow (lv, li: the
// warp's merge lists, bucket_overflow(TM) entries a row) cannot take what
// the cells would push out, the window ends first (bucket_merge) and the
// tile is filtered again against the raised threshold, into empty cells;
// then each lane puts its passing scores in its cell and the pushed-out
// entries are appended to the overflow by ballot and prefix count.
// count, when not null, gains {windows ended, overflow entries}.
template <int TM, int COPY = 0>
__device__ __forceinline__ void bucket_tile(const float* St, float* Cv,
                                            int* Ci, float* lv, int* li,
                                            BucketCells<TM / kWarps>& cells,
                                            int k, int n0, int rows_valid,
                                            int warp, int lane, int* count) {
  constexpr int R = TM / kWarps, O = bucket_overflow(TM);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = warp + kWarps * j;
    if (r >= rows_valid) break;
    float* cv = Cv + (size_t)r * k;
    const float s0 = St[r * (kTN + 1) + lane];
    const float s1 = St[r * (kTN + 1) + 32 + lane];
    float thr = cv[k - 1];
    bool c0 = s0 > thr, c1 = s1 > thr;
    if (!__any_sync(0xffffffffu, c0 || c1)) continue;
    float* ov = lv + O * j;
    int* oi = li + O * j;
    // A cell pushes out one entry for each passing score past its room.
    const int held = (cells.v1[j] > -INFINITY) + (cells.v2[j] > -INFINITY);
    const int push = held + c0 + c1 - 2;
    const unsigned p1 = __ballot_sync(0xffffffffu, push > 0);
    int base = 0;   // the overflow's entries
    if (p1 != 0u) {
      const unsigned p2 = __ballot_sync(0xffffffffu, push > 1);
      base = __popc(__ballot_sync(0xffffffffu,
                                  lane < O && ov[lane] > -INFINITY));
      if (base + __popc(p1) + __popc(p2) > O) {
        bucket_merge<COPY>(cv, Ci + (size_t)r * k, k, cells.v1[j],
                           cells.i1[j], cells.v2[j], cells.i2[j], ov, oi, O,
                           lane);
        cells.clear(j);
        if (count != nullptr && lane == 0) atomicAdd(count, 1);
        thr = cv[k - 1];
        c0 = s0 > thr;
        c1 = s1 > thr;
        base = 0;
      }
    }
    float pv0 = -INFINITY, pv1 = -INFINITY;
    int pi0 = kINT32_MAX, pi1 = kINT32_MAX;
    if (c0)
      bucket_put(cells.v1[j], cells.i1[j], cells.v2[j], cells.i2[j], s0,
                 n0 + lane, pv0, pi0);
    if (c1)
      bucket_put(cells.v1[j], cells.i1[j], cells.v2[j], cells.i2[j], s1,
                 n0 + 32 + lane, pv1, pi1);
    const unsigned b0 = __ballot_sync(0xffffffffu, pv0 > -INFINITY);
    const unsigned b1 = __ballot_sync(0xffffffffu, pv1 > -INFINITY);
    if ((b0 | b1) == 0u) continue;
    const unsigned below = (1u << lane) - 1u;
    if (pv0 > -INFINITY) {
      const int e = base + __popc(b0 & below);
      ov[e] = pv0;
      oi[e] = pi0;
    }
    if (pv1 > -INFINITY) {
      const int e = base + __popc(b0) + __popc(b1 & below);
      ov[e] = pv1;
      oi[e] = pi1;
    }
    if (count != nullptr && lane == 0)
      atomicAdd(count + 1, __popc(b0) + __popc(b1));
    __syncwarp();
  }
}

// The bucket selection's end of a split, after the walk's last barrier:
// each warp ends its rows' last windows, then a barrier before the carries
// are written out.
template <int TM, int COPY = 0>
__device__ inline void bucket_flush(float* Cv, int* Ci, float* lv, int* li,
                                    BucketCells<TM / kWarps>& cells, int k,
                                    int rows_valid, int warp, int lane,
                                    int* count) {
  constexpr int R = TM / kWarps, O = bucket_overflow(TM);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = warp + kWarps * j;
    if (r >= rows_valid) break;
    float* ov = lv + O * j;
    const bool held = cells.v1[j] > -INFINITY ||
                      (lane < O && ov[lane] > -INFINITY);
    if (!__any_sync(0xffffffffu, held)) continue;
    bucket_merge<COPY>(Cv + (size_t)r * k, Ci + (size_t)r * k, k,
                       cells.v1[j], cells.i1[j], cells.v2[j], cells.i2[j],
                       ov, li + O * j, O, lane);
    if (count != nullptr && lane == 0) atomicAdd(count, 1);
  }
  __syncthreads();
}

// The bucket selection's start: empty cells and overflow lists (the merge
// lists, kWarps kTN values).
template <int R>
__device__ inline void init_bucket(BucketCells<R>& cells, float* lv) {
#pragma unroll
  for (int j = 0; j < R; ++j) cells.clear(j);
  for (int e = threadIdx.x; e < kWarps * kTN; e += kThreads)
    lv[e] = -INFINITY;
}

// The gstack selection's cells: a row's classes are the columns of the
// 64-column tile (lane owns columns lane and 32 + lane of its warp's
// rows, so a cell is one lane's and needs no shuffle to update).
constexpr int kGstackCells = kTN;
// The deepest stacks gstack_levels gives, the union bound on a launch's
// fire probability it keeps them under, and the blocks of a launch it
// counts: kernel_geometry sizes a launch to the blocks the card holds at
// once, two an SM on the H100's 132 SMs.
constexpr int kGstackMaxLevels = 16;
constexpr double kGstackFire = 0.05;
constexpr int kGstackBlocks = 264;

// blocks tm C(k, levels) / cells^(levels - 1): the union bound, over a
// launch's blocks, a block's tm rows and a row's cells, on some cell
// holding `levels` of a row's top-k (uniformly spread winners), which a
// fire needs.
__host__ __device__ constexpr double gstack_fire_bound(int k, int tm,
                                                       int levels) {
  double b = (double)kGstackBlocks * tm;
  for (int i = 0; i < levels; ++i) {
    b = b * (k - i) / (i + 1);
    if (i > 0) b /= kGstackCells;
    if (b <= 0.0) return 0.0;
  }
  return b;
}

// The stack depth at k and query tile tm: a launch's expected cost is its
// build, about a level's work each level, plus the chance that any of its
// blocks fires times one exact walk of a split.  The launch's blocks run
// in one wave, so the re-walk of even one block adds a whole split's walk
// to the launch (on the H100, 2M x 256 batch 8 k=10 with two of 263
// blocks fired took 1.41 against 0.82 ms, PERF.md).  One more level saves
// less than it costs once the fire bound is below a level's share of the
// walk; taking that share as kGstackFire (kernel D's levels: +0.01 to
// +0.24 ms over its product, PERF.md), the depth is the least that holds
// the bound to kGstackFire, from one level below the bound's (gstack_tile)
// up.  fused_topk.gstack_levels is the host's mirror.
__host__ __device__ constexpr int gstack_levels(int k, int tm) {
  int levels = (k - 1) / kGstackCells + 2;
  while (levels < kGstackMaxLevels &&
         gstack_fire_bound(k, tm, levels) > kGstackFire)
    ++levels;
  return levels;
}

// Shared memory after the staging: the score tile, each row's bound, each
// row's kGstackCells x levels keys (level-major: key l * 64 + cell).
__host__ __device__ inline size_t gstack_tail_bytes(int tm, int levels) {
  return (size_t)tm * (kTN + 1) * sizeof(float) + (size_t)tm * sizeof(float)
       + (size_t)tm * kGstackCells * levels * sizeof(uint64_t);
}

// The gstack selection's state: Cv is the word after the score tile,
// holding each row's bound, then the rows' stacks.
template <int TM>
__device__ __forceinline__ uint64_t* gstack_keys(float* Cv) {
  return reinterpret_cast<uint64_t*>(Cv + TM);
}

// Bounds -inf (+inf past m, which the gate then never counts) and empty
// stacks.
template <int TM>
__device__ inline void init_gstack(float* Cv, int levels, int rows_valid) {
  for (int r = threadIdx.x; r < TM; r += kThreads)
    Cv[r] = r < rows_valid ? -INFINITY : INFINITY;
  uint64_t* key = gstack_keys<TM>(Cv);
  for (int e = threadIdx.x; e < TM * kGstackCells * levels; e += kThreads)
    key[e] = kEmptyKey;
}

// Puts x in its cell (cell[l * kGstackCells], l < levels, best first) if
// it beats the deepest entry (keys are distinct: every entry there has a
// lower index); returns whether it did.
__device__ __forceinline__ bool gstack_put(uint64_t* cell, int levels,
                                           uint64_t x) {
  int p = levels - 1;
  if (x < cell[p * kGstackCells]) return false;
  for (; p > 0; --p) {
    const uint64_t y = cell[(p - 1) * kGstackCells];
    if (y > x) break;
    cell[p * kGstackCells] = y;
  }
  cell[p * kGstackCells] = x;
  return true;
}

// The k-th best of the first 32 E keys of a row's stacks (levels 0 .. E /
// 2 - 1, E 2 or 4), sorted in registers (key_sort).  Whole warp calls.
template <int E>
__device__ __forceinline__ uint64_t gstack_kth(const uint64_t* key, int k,
                                               int lane) {
  uint64_t a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = key[e * 32 + lane];
  key_sort<E>(a, lane);
  uint64_t x = a[0];
#pragma unroll
  for (int e = 1; e < E; ++e)
    if ((k - 1) / 32 == e) x = a[e];
  return __shfl_sync(0xffffffffu, x, (k - 1) % 32);
}

// The same k-th best in a walk's lean form (radix_lean: the int4 core at
// query tile 32, which spilled with gstack_kth's registers beside its
// walk's): k times the warp's best cell head of levels 0 .. lvl taken out,
// as gstack_finish pops.  kEmptyKey where fewer than k are real.
__device__ __forceinline__ uint64_t gstack_kth_lean(const uint64_t* key,
                                                    int k, int lvl,
                                                    int lane) {
  int p0 = 0, p1 = 0;
  uint64_t h0 = key[lane], h1 = key[32 + lane], win = kEmptyKey;
  for (int t = 0; t < k; ++t) {
    const uint64_t best = key_max(h0, h1);
    const unsigned hi =
        __reduce_max_sync(0xffffffffu, (unsigned)(best >> 32));
    const unsigned lo = __reduce_max_sync(
        0xffffffffu, (unsigned)(best >> 32) == hi ? (unsigned)best : 0u);
    win = ((uint64_t)hi << 32) | lo;
    if (win == kEmptyKey) break;
    if (best == win) {
      if (h0 == win)
        h0 = ++p0 <= lvl ? key[p0 * kGstackCells + lane] : kEmptyKey;
      else
        h1 = ++p1 <= lvl ? key[p1 * kGstackCells + 32 + lane] : kEmptyKey;
    }
  }
  return win;
}

// The gstack selection of one TM x kTN score tile (k <= kAppendMaxK): one
// warp per query row.  A score is a candidate if it beats the row's bound
// (strict >); each lane puts its candidates in its two cells.  The bound
// is the k-th best entry of levels 0 .. (k - 1) / kGstackCells of the
// row's cells: a later score at or below it has k entries better than it
// or tied with a lower index, so it is in no top-k.  It is at least the
// JAX kernel's gstack tile gate's bound (fused_topk.py:1337-1369), the
// least entry of the deepest of those levels, and close to the row's k-th
// best, so few scores reach a cell.  Stacks only improve, so a bound read
// before a tile's puts holds for the whole tile; it is raised after a
// tile in which the row put any.  The carry gate reads the same word.
// LEAN: radix_lean (gstack_kth_lean).
template <int TM, bool LEAN>
__device__ inline void gstack_tile(const float* St, float* Cv, int k,
                                   int levels, int n0, int rows_valid,
                                   int warp, int lane) {
  const int lvl = (k - 1) / kGstackCells;
  for (int r = warp; r < rows_valid; r += kWarps) {
    const float s0 = St[r * (kTN + 1) + lane];
    const float s1 = St[r * (kTN + 1) + 32 + lane];
    const float bound = Cv[r];
    const bool c0 = s0 > bound, c1 = s1 > bound;
    if (!__any_sync(0xffffffffu, c0 || c1)) continue;
    uint64_t* key = gstack_keys<TM>(Cv) + (size_t)r * kGstackCells * levels;
    bool put = false;
    if (c0) put = gstack_put(key + lane, levels, sel_key(s0, n0 + lane));
    if (c1)
      put |= gstack_put(key + 32 + lane, levels,
                        sel_key(s1, n0 + 32 + lane));
    if (!__any_sync(0xffffffffu, put)) continue;
    uint64_t kth;
    if constexpr (LEAN)
      kth = gstack_kth_lean(key, k, lvl, lane);
    else
      kth = lvl == 0 ? gstack_kth<2>(key, k, lane)
                     : gstack_kth<4>(key, k, lane);
    if (lane == 0) Cv[r] = key_value(kth);
    __syncwarp();
  }
}

// The gstack selection's end of a split, after the walk's last barrier
// (the port of _gpop_finish and of _gstack_decode's detector): each row's
// warp pops its top k, k times the best of the lanes' two cell heads (a
// max over the high words, then over the low words of the lanes that hold
// that high word), written to the row's output slots by the lane that
// holds it, (-inf, INT32_MAX) past the last real entry.  The row fires
// when a pop takes a cell's deepest entry: only such a cell can have
// dropped or refused a score of the top k.  count, when not null, gains
// {rows fired, blocks fired}; flags[block] is set to whether any of the
// block's rows fired, for the exact re-walk.  Every thread calls.
template <int TM>
__device__ inline void gstack_finish(float* Cv, int k, int levels,
                                     int rows_valid, int warp, int lane,
                                     float* part_v, int* part_i, int row0,
                                     int splits, int split, int* count,
                                     int* flags) {
  bool fired = false;
  for (int r = warp; r < rows_valid; r += kWarps) {
    const uint64_t* key =
        gstack_keys<TM>(Cv) + (size_t)r * kGstackCells * levels;
    const size_t o = ((size_t)(row0 + r) * splits + split) * k;
    int p0 = 0, p1 = 0;
    uint64_t h0 = key[lane], h1 = key[32 + lane];
    bool deep = false;
    int t = 0;
    for (; t < k; ++t) {
      const uint64_t best = key_max(h0, h1);
      const unsigned hi =
          __reduce_max_sync(0xffffffffu, (unsigned)(best >> 32));
      const unsigned lo = __reduce_max_sync(
          0xffffffffu, (unsigned)(best >> 32) == hi ? (unsigned)best : 0u);
      const uint64_t win = ((uint64_t)hi << 32) | lo;
      if (win == kEmptyKey) break;   // nothing real is left
      if (best == win) {   // real keys are distinct: one lane holds it
        part_v[o + t] = key_value(win);
        part_i[o + t] = key_index(win);
        if (h0 == win) {
          deep |= p0 == levels - 1;
          ++p0;
          h0 = p0 < levels ? key[p0 * kGstackCells + lane] : kEmptyKey;
        } else {
          deep |= p1 == levels - 1;
          ++p1;
          h1 = p1 < levels ? key[p1 * kGstackCells + 32 + lane] : kEmptyKey;
        }
      }
    }
    for (int j = t + lane; j < k; j += 32) {
      part_v[o + j] = -INFINITY;
      part_i[o + j] = kINT32_MAX;
    }
    const bool row = __any_sync(0xffffffffu, deep);
    if (row && lane == 0 && count != nullptr) atomicAdd(count, 1);
    fired |= row;
  }
  const bool any = __syncthreads_or(fired) != 0;
  if (threadIdx.x == 0) {
    flags[blockIdx.x * gridDim.y + blockIdx.y] = any ? 1 : 0;
    if (any && count != nullptr) atomicAdd(count + 1, 1);
  }
}

// Whether the block returns at once: a launch of an exact selection that
// re-walks the fired splits of a gstack launch (flags not null) skips
// every block whose flag is clear.
__device__ __forceinline__ bool rewalk_skips(const int* flags) {
  return flags != nullptr && flags[blockIdx.x * gridDim.y + blockIdx.y] == 0;
}

// The gstack selection above kAppendMaxK.  Its query tile, and the
// deepest stacks it takes (the JAX kernel's cap, _BIGK_MAX_LEVELS).
constexpr int kGstackBigTM = 16;
constexpr int kGstackBigMaxK = 1024;
constexpr int kGstackBigMaxLevels = 32;

// Shared memory after the staging: the score tile, each row's bound, each
// row's kGstackCells x levels sel_keys (level-major: place l * 64 + cell),
// then each row's 64 cell states (a byte: the entries, and kGstackLost).
__host__ __device__ inline size_t gstack_big_tail_bytes(int tm, int levels) {
  return (size_t)tm * (kTN + 1) * sizeof(float) + (size_t)tm * sizeof(float)
       + (size_t)tm * kGstackCells * levels * sizeof(uint64_t)
       + (size_t)tm * kGstackCells;
}

// The stacks of a TM-row block above kAppendMaxK (Cv is the word after the
// score tile, each row's bound; the keys follow).
template <int TM>
struct BigStacks {
  unsigned char* base;
  int levels;
  __device__ BigStacks(float* Cv, int levels)
      : base(reinterpret_cast<unsigned char*>(Cv + TM)), levels(levels) {}
  __device__ int per_row() const { return kGstackCells * levels; }
  __device__ uint64_t* keys(int r) const {
    return reinterpret_cast<uint64_t*>(base) + (size_t)r * per_row();
  }
  __device__ uint8_t* state(int r) const {
    return base + (size_t)TM * per_row() * sizeof(uint64_t)
           + (size_t)r * kGstackCells;
  }
  // The high word (the value's orderable bits) of place x of row r.
  __device__ uint32_t hi(int r, int x) const {
    return (uint32_t)(keys(r)[x] >> 32);
  }
};

// Empty stacks and cells, bounds -inf (+inf past m, which the gate then
// never counts).
template <int TM>
__device__ inline void init_gstack_big(float* Cv, int levels,
                                       int rows_valid) {
  for (int r = threadIdx.x; r < TM; r += kThreads)
    Cv[r] = r < rows_valid ? -INFINITY : INFINITY;
  const BigStacks<TM> S(Cv, levels);
  for (int e = threadIdx.x; e < TM * S.per_row(); e += kThreads)
    S.keys(0)[e] = kEmptyKey;
  for (int e = threadIdx.x; e < TM * kGstackCells; e += kThreads)
    S.state(0)[e] = 0;
}

// A cell's state byte: its entries, and this bit once it lost one.
constexpr uint8_t kGstackLost = 0x80;

// Puts key x in column `cell` of row r if it beats the cell's deepest
// entry; returns whether it did.  A score that beat the row's bound and
// meets the cell full (it shifts an entry out, or is refused) marks the
// cell lost.  The shift starts below the cell's last entry.  Every entry of
// the cell came from an earlier tile, so its index is lower: x goes after
// the entries of its value, and high words alone decide.
template <int TM>
__device__ __forceinline__ bool gstack_big_put(const BigStacks<TM>& S, int r,
                                               int cell, uint64_t x) {
  const uint32_t xh = (uint32_t)(x >> 32);
  uint8_t& state = S.state(r)[cell];
  const int used = state & ~kGstackLost;
  int p;
  if (used == S.levels) {
    state = kGstackLost | used;
    p = (S.levels - 1) * kGstackCells + cell;
    if (xh <= S.hi(r, p)) return false;
  } else {
    state = used + 1;
    p = used * kGstackCells + cell;
  }
  uint64_t* key = S.keys(r);
  for (; p >= kGstackCells; p -= kGstackCells) {
    const uint64_t y = key[p - kGstackCells];
    if ((uint32_t)(y >> 32) >= xh) break;
    key[p] = y;
  }
  key[p] = x;
  return true;
}

// The gstack selection of one TM x kTN score tile above kAppendMaxK: one
// warp per query row, a score a candidate if it beats the row's bound
// (strict >), each lane putting its candidates in its two cells.  The
// bound is the weakest entry of level (k - 1) / 64 over the row's 64
// cells, one min-reduction after a tile in which the row put any (the form
// of the JAX kernel's gstack tile gate, fused_topk.py:1337-1369): each
// cell holds that many and one entries at or above it, 64 ((k - 1) / 64 +
// 1) >= k in all, so a later score at or below it (its index is higher) is
// in no top-k.  It stays -inf until every cell has them.  The carry gate
// reads the same word.
template <int TM>
__device__ inline void gstack_big_tile(const float* St, float* Cv, int k,
                                       int levels, int n0, int rows_valid,
                                       int warp, int lane) {
  const BigStacks<TM> S(Cv, levels);
  const int lvl = (k - 1) / kGstackCells * kGstackCells;
  for (int r = warp; r < rows_valid; r += kWarps) {
    const float s0 = St[r * (kTN + 1) + lane];
    const float s1 = St[r * (kTN + 1) + 32 + lane];
    const float bound = Cv[r];
    const bool c0 = s0 > bound, c1 = s1 > bound;
    if (!__any_sync(0xffffffffu, c0 || c1)) continue;
    bool put = false;
    if (c0) put = gstack_big_put(S, r, lane, sel_key(s0, n0 + lane));
    if (c1)
      put |= gstack_big_put(S, r, 32 + lane, sel_key(s1, n0 + 32 + lane));
    if (!__any_sync(0xffffffffu, put)) continue;
    const uint32_t w =
        min(S.hi(r, lvl + lane), S.hi(r, lvl + 32 + lane));
    const uint32_t least = __reduce_min_sync(0xffffffffu, w);
    if (lane == 0) Cv[r] = key_value(((uint64_t)least << 32) | 1u);
    __syncwarp();
  }
}

// The split's end above kAppendMaxK, gstack_finish's k pops: each row's
// warp takes k times the best of its lanes' two cell heads and writes it
// to the row's output slots, (-inf, INT32_MAX) past the last real entry.
// The row fires when a pop takes the deepest entry of a lost cell: only
// such a cell can have dropped or refused a score of the top k (a score
// the bound refused is in none).  count and flags as gstack_finish's.
template <int TM>
__device__ inline void gstack_big_finish(float* Cv, int k, int levels,
                                         int rows_valid, int warp, int lane,
                                         float* part_v, int* part_i,
                                         int row0, int splits, int split,
                                         int* count, int* flags) {
  const BigStacks<TM> S(Cv, levels);
  const int places = levels * kGstackCells;
  const int deepest = places - kGstackCells;
  bool fired = false;
  for (int r = warp; r < rows_valid; r += kWarps) {
    const uint8_t* state = S.state(r);
    const uint64_t* key = S.keys(r);
    const size_t o = ((size_t)(row0 + r) * splits + split) * k;
    int p0 = lane, p1 = 32 + lane;
    uint64_t h0 = key[p0], h1 = key[p1];
    bool deep = false;
    int t = 0;
    for (; t < k; ++t) {
      const uint64_t best = key_max(h0, h1);
      const unsigned hi =
          __reduce_max_sync(0xffffffffu, (unsigned)(best >> 32));
      const unsigned lo = __reduce_max_sync(
          0xffffffffu, (unsigned)(best >> 32) == hi ? (unsigned)best : 0u);
      const uint64_t win = ((uint64_t)hi << 32) | lo;
      if (win == kEmptyKey) break;   // nothing real is left
      if (best == win) {   // real keys are distinct: one lane holds it
        part_v[o + t] = key_value(win);
        part_i[o + t] = key_index(win);
        if (h0 == win) {
          deep |= p0 >= deepest && (state[lane] & kGstackLost);
          p0 += kGstackCells;
          h0 = p0 < places ? key[p0] : kEmptyKey;
        } else {
          deep |= p1 >= deepest && (state[32 + lane] & kGstackLost);
          p1 += kGstackCells;
          h1 = p1 < places ? key[p1] : kEmptyKey;
        }
      }
    }
    for (int j = t + lane; j < k; j += 32) {
      part_v[o + j] = -INFINITY;
      part_i[o + j] = kINT32_MAX;
    }
    const bool row = __any_sync(0xffffffffu, deep);
    if (row && lane == 0 && count != nullptr) atomicAdd(count, 1);
    fired |= row;
  }
  const bool any = __syncthreads_or(fired) != 0;
  if (threadIdx.x == 0) {
    flags[blockIdx.x * gridDim.y + blockIdx.y] = any ? 1 : 0;
    if (any && count != nullptr) atomicAdd(count + 1, 1);
  }
}

// ---------------------------------------------------------------------------
// The stack selection (SEL kStack, k up to kAppendMaxK, on request): the
// port of the TPU kernel's per-tile stacks (_select_stack fused_topk.py
// :337, _stack_geometry :323, _STACK_DEPTH :270).  There each of the 128
// lane classes of a tile of block_n corpus rows keeps a sorted stack of its
// best min(8, groups) scores of the tile, a group id packed into each
// score's low mantissa bits (scores truncated by up to 31 ulps); one
// pop-merge takes the best k of the carry and the stacks, and a class
// whose next level could hold a winner sends the tile through the exact
// extraction again.  Here a window of kStackWindow consecutive tiles of the
// block's split stands for one JAX tile of 64 kStackWindow rows.  Each (row,
// column of the 64-column tile) cell keeps the window's exact sel_keys that
// beat the row's bound (the carry's k-th value when the window began,
// strict >, the carry gate's word), sorted, in shared memory with a count
// (stack_tile): keys are exact, so nothing is truncated.  A cell meets one
// score a tile, so cells kStackWindow deep hold every candidate of the
// window: the JAX kernel's case groups <= depth, where nothing can be lost
// and nothing is detected.  At the window's end (stack_window_end) the
// row's warp pops its best cell head while that beats the carry entry it
// would displace, and merges the popped entries into the carry by rank:
// the carry is then the exact top k of carry and window, and its k-th
// value the next bound.
// ---------------------------------------------------------------------------

// The stack selection's window, in tiles of the split, and its cells'
// depth (chosen by measurement on the H100 among windows of 4, 8 and 16,
// PERF.md: the shortest was the fastest at 17 <= k <= 32, its tail the
// smallest).
constexpr int kStackWindow = 4;
static_assert(kStackWindow >= 1 && kStackWindow <= 8,
              "cells as deep as the window, at most the TPU kernel's "
              "_STACK_DEPTH");

// Words of a row's state: whether the window put any, then 64 count bytes
// (a cell's entries).
constexpr int kStackStateWords = 1 + kGstackCells / 4;

// Shared memory after the staging: the score tile, each row's bound, each
// row's state, each row's carry of k keys, each row's kGstackCells x
// kStackWindow keys (level-major: key l * 64 + cell), then each warp's 2k
// keys of merge scratch.
__host__ __device__ inline size_t stack_tail_bytes(int tm, int k) {
  return (size_t)tm * (kTN + 1) * sizeof(float) + (size_t)tm * sizeof(float)
       + (size_t)tm * kStackStateWords * sizeof(uint32_t)
       + (size_t)tm * k * sizeof(uint64_t)
       + (size_t)tm * kGstackCells * kStackWindow * sizeof(uint64_t)
       + (size_t)kWarps * 2 * k * sizeof(uint64_t);
}

// The stack selection's state: Cv is the word after the score tile,
// holding each row's bound, then the rows' states, carries, cells and the
// warps' scratch.
template <int TM>
struct StackState {
  float* Cv;
  int k;
  __device__ uint32_t* state(int r) const {
    return reinterpret_cast<uint32_t*>(Cv + TM) + r * kStackStateWords;
  }
  __device__ uint8_t* used(int r) const {
    return reinterpret_cast<uint8_t*>(state(r) + 1);
  }
  __device__ uint64_t* carry(int r) const {
    return reinterpret_cast<uint64_t*>(Cv + TM + TM * kStackStateWords) +
           (size_t)r * k;
  }
  __device__ uint64_t* cells(int r) const {
    return carry(TM) + (size_t)r * kGstackCells * kStackWindow;
  }
  __device__ uint64_t* scratch(int warp) const {
    return cells(TM) + (size_t)warp * 2 * k;
  }
};

// Bounds -inf (+inf past m, which the gate then never counts), clear
// states, empty carries.
template <int TM>
__device__ inline void init_stack(const StackState<TM>& S, int rows_valid) {
  for (int r = threadIdx.x; r < TM; r += kThreads)
    S.Cv[r] = r < rows_valid ? -INFINITY : INFINITY;
  uint32_t* st = S.state(0);
  for (int e = threadIdx.x; e < TM * kStackStateWords; e += kThreads)
    st[e] = 0u;
  uint64_t* key = S.carry(0);
  for (int e = threadIdx.x; e < TM * S.k; e += kThreads) key[e] = kEmptyKey;
}

// Puts candidate x in its cell (cell[l * kGstackCells], l < *used, best
// first).  The cell holds fewer than kStackWindow entries: it meets one
// score a tile.  Keys are distinct.
__device__ __forceinline__ void stack_put(uint64_t* cell, uint8_t* used,
                                          uint64_t x) {
  int p = *used;
  *used = (uint8_t)(p + 1);
  for (; p > 0; --p) {
    const uint64_t y = cell[(p - 1) * kGstackCells];
    if (y > x) break;
    cell[p * kGstackCells] = y;
  }
  cell[p * kGstackCells] = x;
}

// The stack selection of one TM x kTN score tile: one warp per query row.
// A score is a candidate if it beats the row's bound (strict >); each lane
// puts its candidates in its two cells (columns lane and 32 + lane).
template <int TM>
__device__ inline void stack_tile(const float* St, const StackState<TM>& S,
                                  int n0, int rows_valid, int warp,
                                  int lane) {
  for (int r = warp; r < rows_valid; r += kWarps) {
    const float s0 = St[r * (kTN + 1) + lane];
    const float s1 = St[r * (kTN + 1) + 32 + lane];
    const float bound = S.Cv[r];
    const bool c0 = s0 > bound, c1 = s1 > bound;
    if (!__any_sync(0xffffffffu, c0 || c1)) continue;
    uint64_t* cell = S.cells(r);
    uint8_t* used = S.used(r);
    if (c0) stack_put(cell + lane, used + lane, sel_key(s0, n0 + lane));
    if (c1)
      stack_put(cell + 32 + lane, used + 32 + lane,
                sel_key(s1, n0 + 32 + lane));
    if (lane == 0) S.state(r)[0] = 1u;
  }
}

// Entries of a[0, n), sorted best first, that beat x.
__device__ __forceinline__ int keys_above(const uint64_t* a, int n,
                                          uint64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The end of a window, for each of the warp's rows that put any (the port
// of _select_stack's pop-merge): the warp pops the best of its lanes' two
// cell heads (a max over the high words, then over the low words of the
// lanes that hold that high word) while it beats the carry entry it would
// displace (the pop's c-th beats carry[k - 1 - c]; the next ones are worse
// and the carry's better), to scratch[c].  Then each popped entry goes to
// place c + (carry entries above it) and each of the carry's first k - c
// to j + (popped entries above it), in scratch[k, 2k), copied back as the
// carry, whose k-th value is the row's new bound.  Whole warp calls.
template <int TM>
__device__ inline void stack_window_end(const StackState<TM>& S,
                                        int rows_valid, int warp,
                                        int lane) {
  const int k = S.k;
  uint64_t* scratch = S.scratch(warp);
  for (int r = warp; r < rows_valid; r += kWarps) {
    __syncwarp();
    uint32_t* st = S.state(r);
    if (st[0] == 0u) continue;
    const uint64_t* cell = S.cells(r);
    uint64_t* carry = S.carry(r);
    uint8_t* used = S.used(r);
    const int u0 = used[lane], u1 = used[32 + lane];
    int p0 = 0, p1 = 0;
    uint64_t h0 = u0 > 0 ? cell[lane] : kEmptyKey;
    uint64_t h1 = u1 > 0 ? cell[32 + lane] : kEmptyKey;
    int c = 0;
    for (; c < k; ++c) {
      const uint64_t best = key_max(h0, h1);
      const unsigned hi =
          __reduce_max_sync(0xffffffffu, (unsigned)(best >> 32));
      const unsigned lo = __reduce_max_sync(
          0xffffffffu, (unsigned)(best >> 32) == hi ? (unsigned)best : 0u);
      const uint64_t win = ((uint64_t)hi << 32) | lo;
      // Empty (nothing left) never beats a carry entry.
      if (win <= carry[k - 1 - c]) break;
      if (lane == 0) scratch[c] = win;
      if (best == win) {   // real keys are distinct: one lane holds it
        if (h0 == win) {
          ++p0;
          h0 = p0 < u0 ? cell[p0 * kGstackCells + lane] : kEmptyKey;
        } else {
          ++p1;
          h1 = p1 < u1 ? cell[p1 * kGstackCells + 32 + lane] : kEmptyKey;
        }
      }
    }
    __syncwarp();
    if (c > 0) {
      uint64_t* out = scratch + k;
      for (int i = lane; i < c; i += 32) {
        const uint64_t x = scratch[i];
        out[i + keys_above(carry, k, x)] = x;
      }
      for (int j = lane; j < k - c; j += 32) {
        const uint64_t x = carry[j];
        out[j + keys_above(scratch, c, x)] = x;
      }
      __syncwarp();
      for (int j = lane; j < k; j += 32) carry[j] = out[j];
    }
    used[lane] = 0;
    used[32 + lane] = 0;
    __syncwarp();
    if (lane == 0) {
      st[0] = 0u;
      S.Cv[r] = key_value(carry[k - 1]);
    }
  }
  __syncwarp();
}

// The stack selection's end of a split, after the walk's last barrier:
// the last window's end, then each row's carry to its output slots
// ((-inf, INT32_MAX) past the last real entry).  Every thread calls.
template <int TM>
__device__ inline void stack_finish(const StackState<TM>& S, int rows_valid,
                                    int warp, int lane, float* part_v,
                                    int* part_i, int row0, int splits,
                                    int split) {
  stack_window_end<TM>(S, rows_valid, warp, lane);
  for (int r = warp; r < rows_valid; r += kWarps) {
    const uint64_t* carry = S.carry(r);
    const size_t o = ((size_t)(row0 + r) * splits + split) * S.k;
    for (int j = lane; j < S.k; j += 32) {
      part_v[o + j] = key_value(carry[j]);
      part_i[o + j] = key_index(carry[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// The carry gate: the TPU kernel's exact tile pruning (prune=, fused_topk.py
// :1434-1478, prune_eff :1995), a runtime argument of every kernel here.
//
// On the TPU a tile's selection is k full-width extraction passes, and one
// max pass decides whether any row's tile maximum beats that row's current
// k-th value.  Here the selection already drops every score that does not
// beat its row's threshold (select_tile, append_tile: s > cv[k - 1];
// radix_tile: s > the row's threshold word), so
// what a skipped tile saves is the selection's read-and-compare pass over
// the score tile, its ballots, and the calls themselves.  While the
// epilogue writes a tile's scores, each thread compares its scores with
// their rows' cv[k - 1] (the same strict >), and the barrier that already
// precedes the selection carries the vote (__syncthreads_or), so the gate
// adds no barrier.  A tile nobody votes for skips select_tile /
// append_tile / radix_tile entirely.
//
// Exact: the vote reads cv[k - 1] after the previous tile's selection has
// ended (the walks' barriers order them) and before this tile's begins,
// the very threshold the selection's filter starts from, and the filter
// only rises within a tile.  A skipped tile is one in which the filter
// would admit no score, so the carry, and the split lists written out, are
// bit for bit those with the gate off: in every core, in both consumers,
// dense and listed, inserting and appending (the appending selection's
// cv[k - 1] excludes the slack, so it is stale, but it is its filter's
// threshold all the same; the slack changes only when a score passes it)
// and radix (the threshold word, raised only by a select the filter's own
// candidates set off).
// On ring_wgmma.cuh's consumer one vote decides a step's four tiles: their
// selections run in walk order with no barrier between them, so a tile's
// filter starts at or above the threshold the step's vote read; one
// decision a step keeps the one barrier, and four would need a shared word
// per tile cleared between steps.  Query rows past m hold +inf as their
// k-th value (the carry's initialisation), so they vote for nothing.
//
// Row groups: the TPU kernel gates 64-row groups of its query tile at
// k <= 16 (fused_topk.py:1449-1471).  Kernel A's query tiles are 16, 32
// or 64 rows, so a block is one such group, at every k.
//
// count, when not null, gathers {tiles gated, tiles skipped} (one thread
// a block adds a tile's, or a step's live tiles'); null costs nothing.
//
// The gate holds only kernel arguments, and finds the carry at its fixed
// offset CV from the score tiles the walk already holds: a pointer of its
// own, live across the walk, cost the tile-16 bf16x3 ring a spill.  With
// WORD (the radix selection, the gstack selection) it reads the row's
// threshold word (the gstack's bound) at CV + r in place of cv[k - 1]: the
// same filter's threshold, which only rises, so the gate stays exact.
// ---------------------------------------------------------------------------

template <int CV, bool WORD = false>
struct CarryGate {
  static constexpr bool kGated = true;
  int k;
  bool on;
  int* count;
  __device__ bool vote(const float* St, int r, float s) const {
    return on && s > St[WORD ? CV + r : CV + r * k + k - 1];
  }
  __device__ bool fire(bool v, int tiles) const {
    if (!on) {
      __syncthreads();
      return true;
    }
    const bool any = __syncthreads_or(v) != 0;
    if (count != nullptr && threadIdx.x == 0) {
      atomicAdd(count, tiles);
      if (!any) atomicAdd(count + 1, tiles);
    }
    return any;
  }
};

// The carry's initialisation: (-inf, INT32_MAX) slots, and +inf as the
// k-th value of the query rows past m, which the gate then never counts
// (nothing else reads their carry).
__device__ inline void init_carry(float* Cv, int* Ci, int k, int tm,
                                  int rows_valid) {
  for (int e = threadIdx.x; e < tm * k; e += kThreads) {
    Cv[e] = e < rows_valid * k ? -INFINITY : INFINITY;
    Ci[e] = kINT32_MAX;
  }
}

// ---------------------------------------------------------------------------
// The highest core: exact f32 products on the CUDA cores, fed by the ring
// of tile_scores.cuh.
//
// Producer: the ring carries the raw f32 corpus bytes.  A position is a
// step's corpus rows x ring_row_bytes (32, 16 or 8 features at query tile
// 64, 32 or 16),
// copied by 16-byte cp.async stages - 1 positions ahead of the products and
// straight across steps; a listed walk reads each tile's list entry as it
// copies it and skips ids past the corpus.  The query tile is staged once
// a block where f32_plan keeps it resident; otherwise its columns of the
// position's features ride the stage, after the corpus rows.
//
// Consumer: register tiles of f32 FMA.  A step is 4096 / TM corpus rows
// (64 / TM kernel tiles), so every query tile scores 4096 pairs a step, 16
// a thread.  Lane (lq, lc) = (lane / 8, lane % 8) of warp w owns query
// rows 16 (w % WQ) + lq + 4 i and step rows 32 (w / WQ) + lc + 8 j, i, j <
// 4 (WQ = TM / 16 warps along the query tile).  Each 16-byte shared read
// brings four features of one row: a read of query row i meets 4 rows (8
// lanes each, a broadcast), a read of corpus row j meets 8 rows (4 lanes
// each); rows an odd number of 16-byte units apart put the rows of one
// read on distinct banks.  Every four features a warp reads 768 distinct
// bytes for 2048 FMA lanes (2.7 a byte; the per-tile micro-tile read 0.5
// at query tile 64).  Each score keeps one accumulator, fmaf
// over features in ascending order, as before: the scores are the
// per-tile core's, bit for bit.  After a step's products, its kernel tiles
// take turns in one score tile: the warps of tile j write its scores, then
// every warp selects on it.
// ---------------------------------------------------------------------------

constexpr int kF32Stages = 4;   // the most stages of the f32 ring

__host__ __device__ constexpr int f32_step_rows(int tm) { return 4096 / tm; }
__host__ __device__ constexpr int f32_step_tiles(int tm) { return 64 / tm; }

// Bytes of one stage: the step's corpus rows, and the query tile's rows
// when it rides.
__host__ __device__ inline size_t f32_stage_bytes(int tm, bool q_resident) {
  return (size_t)(f32_step_rows(tm) + (q_resident ? 0 : tm)) *
         ring_row_stride(tm, kHighest);
}

// Byte stride of a resident query row: every feature the positions hold.
__host__ __device__ inline int f32_query_stride(int tm, int dim) {
  return odd_units(ring_chunks(tm, kHighest, 4 * dim) *
                       ring_row_bytes(tm, kHighest), 16);
}

// The ring of `stages`, then the resident query tile.
__host__ __device__ inline size_t f32_staging_bytes(int tm, int dim,
                                                    bool q_resident,
                                                    int stages) {
  return stages * f32_stage_bytes(tm, q_resident) +
         (q_resident ? (size_t)tm * f32_query_stride(tm, dim) : 0);
}

// The f32 ring beside `rest` bytes of the selection's shared memory: the
// most blocks an SM (two at most), then the query tile resident wherever
// that keeps them, then the most stages.
inline RingPlan f32_plan(int tm, int dim, size_t rest) {
  RingPlan best{0, false, 0};
  int best_key = -1;
  for (int res = 1; res >= 0; --res)
    for (int s = kF32Stages; s >= 2; --s) {
      const size_t b = f32_staging_bytes(tm, dim, res != 0, s) + rest;
      if (b > kMaxSmem) continue;
      const int blocks = smem_blocks(b) < 2 ? smem_blocks(b) : 2;
      const int key = 100 * blocks + 10 * res + s;
      if (key > best_key) {
        best_key = key;
        best = RingPlan{s, res != 0, b};
      }
    }
  return best;
}

// Stage features [f0, f0 + cols) of query rows [row0, row0 + TM) into Qs
// (row stride qs floats), zero past row m and feature dim.  vec: 16-byte
// cp.async copies (dim % 4 == 0, aligned rows); otherwise plain loads.
template <int TM>
__device__ inline void f32_query(float* Qs, int qs,
                                 const float* __restrict__ q, int row0, int m,
                                 int dim, int f0, int cols, bool vec) {
  if (vec) {
    const int pieces = cols / 4;
    for (int e = threadIdx.x; e < TM * pieces; e += kThreads) {
      const int r = e / pieces, o = (e % pieces) * 4;
      const int gr = row0 + r, f = f0 + o;
      const bool in = gr < m && f < dim;   // whole 4-feature pieces
      cp_async16(Qs + r * qs + o, in ? q + (size_t)gr * dim + f : q,
                 in ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < TM * cols; e += kThreads) {
    const int r = e / cols, o = e % cols;
    const int gr = row0 + r, f = f0 + o;
    Qs[r * qs + o] = gr < m && f < dim ? q[(size_t)gr * dim + f] : 0.f;
  }
}

// The products of one position: acc[i][j] gains q(qr + 4 i rows) .
// c(cr + 8 j rows) over the position's features, one fmaf a feature in
// ascending order.  qs: the query's row stride in floats.
template <int TM>
__device__ inline void f32_products(const float* qr, int qs, const float* cr,
                                    float (&acc)[4][4]) {
  constexpr int BK = ring_cols(TM, kHighest);
  constexpr int CS = ring_row_stride(TM, kHighest) / 4;
#pragma unroll
  for (int u = 0; u < BK; u += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(qr + 4 * i * qs + u);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(cr + 8 * j * CS + u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// The highest core's walk: the ring, the register tiles, then the
// selection of each of the step's tiles in walk order.  Two blocks an SM:
// f32_plan keeps their shared memory, the bound their registers.
template <int TM, bool LISTED, int SEL>
__global__ void __launch_bounds__(kThreads, 2)
fused_topk_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ c,
                      const float* __restrict__ cb,
                      const uint8_t* __restrict__ mask,
                      const int* __restrict__ tiles,
                      float* __restrict__ part_v, int* __restrict__ part_i,
                      int m, int n, int dim, int k, int splits,
                      int tiles_per_split, int p, int tn_tiles,
                      int block_rows, bool vec, int stages,
                      bool q_resident, bool prune,
                      int* __restrict__ gate_count,
                      int* __restrict__ sel_count, int levels,
                      int* __restrict__ flags) {
  if constexpr (!gstack_sel(SEL))
    if (rewalk_skips(flags)) return;
  constexpr int S = f32_step_tiles(TM), R = f32_step_rows(TM);
  constexpr int RB = ring_row_bytes(TM, kHighest);
  constexpr int BK = ring_cols(TM, kHighest);
  constexpr int RS = ring_row_stride(TM, kHighest);
  constexpr int WQ = TM / 16;   // warps along the query rows
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = 4 * dim;
  const int chunks = ring_chunks(TM, kHighest, row_bytes);
  const size_t stage = f32_stage_bytes(TM, q_resident);
  const int qs = (q_resident ? f32_query_stride(TM, dim) : RS) / 4;
  float* Qr = reinterpret_cast<float*>(smem + stages * stage);
  float* St = reinterpret_cast<float*>(
      smem + f32_staging_bytes(TM, dim, q_resident, stages));
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
  const int* list = LISTED ? tiles + (size_t)(row0 / block_rows) * p
                           : nullptr;
  const int n_tiles = LISTED ? p * tn_tiles : (n + kTN - 1) / kTN;
  const int layout_tiles =
      LISTED ? (n + tn_tiles * kTN - 1) / (tn_tiles * kTN) : 0;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  // The first corpus row of kernel tile t, or -1 past the split or where
  // its listed id names no rows (never read).
  auto first_row = [&](int t) -> int {
    if (t >= t_end) return -1;
    if constexpr (LISTED) {
      const int lt = list[t / tn_tiles];
      if (lt < 0 || lt >= layout_tiles) return -1;
      return (lt * tn_tiles + t % tn_tiles) * kTN;
    }
    return t * kTN;
  };

  if constexpr (SEL == kRadix)
    init_radix<TM>(Cv, rows_valid);
  else if constexpr (SEL == kGstack)
    init_gstack<TM>(Cv, levels, rows_valid);
  else if constexpr (SEL == kGstackBig)
    init_gstack_big<TM>(Cv, levels, rows_valid);
  else if constexpr (SEL == kStack)
    init_stack<TM>(StackState<TM>{Cv, k}, rows_valid);
  else
    init_carry(Cv, Ci, k, TM, rows_valid);
  const CarryGate<TM * (kTN + 1), word_bound(SEL)> gate{
      k, prune, gate_count};
  if constexpr (SEL == kAppend)   // the slack counts
    for (int r = tid; r < TM; r += kThreads)
      reinterpret_cast<int*>(Lv)[r] = 0;
  [[maybe_unused]] BucketCells<TM / kWarps> cells;
  if constexpr (SEL == kBucket) init_bucket(cells, Lv);
  [[maybe_unused]] int window = 0;   // the stack selection's

  // The producer: the next position (its step's first tile, its chunk)
  // into stage `to`; one commit group a position, empty or not.  The first
  // rows of its step's tiles are read once a step (a listed id once).
  const unsigned char* cbytes = reinterpret_cast<const unsigned char*>(c);
  int it = t_begin, ikc = 0;
  int pn0[S];
#pragma unroll
  for (int j = 0; j < S; ++j) pn0[j] = first_row(it + j);
  auto produce = [&](int to) {
    unsigned char* st = smem + to * stage;
    if (it < t_end) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (pn0[j] >= 0)
          ring_corpus<TM, kHighest>(st + j * kTN * RS, cbytes, row_bytes,
                                    row_bytes, pn0[j], n, ikc * RB, vec);
      if (!q_resident)
        f32_query<TM>(reinterpret_cast<float*>(st + R * RS), RS / 4, q, row0,
                      m, dim, ikc * BK, BK, vec);
    }
    cp_async_commit();
    if (++ikc == chunks) {
      ikc = 0;
      it += S;
#pragma unroll
      for (int j = 0; j < S; ++j) pn0[j] = first_row(it + j);
    }
  };
  if (q_resident)   // joins position 0's group
    f32_query<TM>(Qr, qs, q, row0, m, dim, 0, chunks * BK, vec);
  for (int i = 0; i < stages - 1; ++i) produce(i);

  const int qrow = 16 * (warp % WQ) + (lane >> 3);
  const int crow = 32 * (warp / WQ) + (lane & 7);
  const int tile = crow / kTN, col = crow % kTN;   // the step tile, column
  int st = 0;   // the consumer's stage
  for (int t0 = t_begin; t0 < t_end; t0 += S) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < S; ++j) any |= first_row(t0 + j) >= 0;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int kc = 0; kc < chunks; ++kc) {
      cp_async_wait_for(stages - 2);   // this position's copies landed
      __syncthreads();          // everyone's; the stage refilled next is read
      produce(st == 0 ? stages - 1 : st - 1);   // stages - 1 positions ahead
      const unsigned char* cs = smem + st * stage;
      st = st == stages - 1 ? 0 : st + 1;
      if (!any) continue;
      const float* qc = q_resident ? Qr + kc * BK
                                   : reinterpret_cast<const float*>(cs + R * RS);
      f32_products<TM>(qc + qrow * qs, qs,
                       reinterpret_cast<const float*>(cs) + crow * (RS / 4),
                       acc);
    }
    if (!any) continue;
    // The step's tiles in walk order through the one score tile: a barrier
    // before each tile's scores overwrite the last one's (the next step's
    // first position has its own), one before its selection.
#pragma unroll 1
    for (int t = 0; t < S; ++t) {
      const int n0 = first_row(t0 + t);
      if (n0 < 0) continue;
      if (t > 0) __syncthreads();
      bool vote = false;   // the gate's, once a row on its largest score
      if (tile == t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float best = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float s =
                epilogue(acc[i][j], n0 + col + 8 * j, n, nullptr, cb, mask);
            St[(qrow + 4 * i) * (kTN + 1) + col + 8 * j] = s;
            best = fmaxf(best, s);
          }
          vote |= gate.vote(St, qrow + 4 * i, best);
        }
      }
      if (!gate.fire(vote, 1)) continue;
      if constexpr (SEL == kRadix)
        radix_tile<TM, false>(St, Cv, k, n0, rows_valid, warp, lane, part_v,
                              part_i, row0, splits, split);
      else if constexpr (SEL == kGstack)
        gstack_tile<TM, false>(St, Cv, k, levels, n0, rows_valid, warp,
                               lane);
      else if constexpr (SEL == kGstackBig)
        gstack_big_tile<TM>(St, Cv, k, levels, n0, rows_valid, warp, lane);
      else if constexpr (SEL == kStack) {
        const StackState<TM> S{Cv, k};
        const int w = (t0 + t - t_begin) / kStackWindow;
        if (w != window) {
          stack_window_end<TM>(S, rows_valid, warp, lane);
          window = w;
        }
        stack_tile<TM>(St, S, n0, rows_valid, warp, lane);
      }
      else if constexpr (SEL == kBucket)
        bucket_tile<TM>(St, Cv, Ci, Lv + warp * kTN, Li + warp * kTN, cells,
                        k, n0, rows_valid, warp, lane, sel_count);
      else if constexpr (SEL == kAppend)
        append_tile<TM, 4>(St, Cv, k, n0, rows_valid, warp, lane, part_v,
                        part_i, row0, splits, split);
      else
        select_tile<TM>(St, Cv, Ci, Lv + warp * kTN, Li + warp * kTN, k, n0,
                        rows_valid, warp, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (SEL == kRadix) {
    radix_finish<TM>(Cv, k, rows_valid, warp, lane, part_v, part_i, row0,
                     splits, split);
    return;
  }
  if constexpr (SEL == kGstack) {
    gstack_finish<TM>(Cv, k, levels, rows_valid, warp, lane, part_v, part_i,
                      row0, splits, split, sel_count, flags);
    return;
  }
  if constexpr (SEL == kGstackBig) {
    gstack_big_finish<TM>(Cv, k, levels, rows_valid, warp, lane, part_v,
                          part_i, row0, splits, split, sel_count, flags);
    return;
  }
  if constexpr (SEL == kStack) {
    stack_finish<TM>(StackState<TM>{Cv, k}, rows_valid, warp, lane, part_v,
                     part_i, row0, splits, split);
    return;
  }
  if constexpr (SEL == kAppend)
    flush_slack<TM, 4>(Cv, k, rows_valid, warp, lane, part_v, part_i, row0,
                    splits, split);
  if constexpr (SEL == kBucket)
    bucket_flush<TM>(Cv, Ci, Lv + warp * kTN, Li + warp * kTN, cells, k,
                     rows_valid, warp, lane, sel_count);
  for (int e = tid; e < rows_valid * k; e += kThreads) {
    const int r = e / k, j = e % k;
    const size_t o = ((size_t)(row0 + r) * splits + split) * k + j;
    part_v[o] = Cv[e];
    part_i[o] = Ci[e];
  }
}

// The ring cores' walk (bf16x3 at every query tile, the stored cores at
// 16 and 32): the ring of tile_scores.cuh, then the selection and carry.  Two
// blocks an SM: the ring's plan keeps their shared memory, and the bound
// their registers.  LISTED instantiates the probed walk apart from the
// dense one: sharing one instantiation moved the dense cores' register
// allocation and slowed some of them by up to 13 % on the H100 (PERF.md).
template <int TM, int CORE, bool LISTED, int SEL>
__global__ void __launch_bounds__(kThreads, 2)
fused_topk_stored_kernel(const uint16_t* __restrict__ qp,
                         const void* __restrict__ cp,
                         const float* __restrict__ scale,
                         const float* __restrict__ cb,
                         const uint8_t* __restrict__ mask,
                         const int* __restrict__ tiles,
                         float* __restrict__ part_v,
                         int* __restrict__ part_i,
                         int m, int n, int dim, int c_ld, int ck, int k,
                         int splits, int tiles_per_split, int p,
                         int tn_tiles, int block_rows, bool vec,
                         int stages, bool q_resident, bool prune,
                         int* __restrict__ gate_count,
                         int* __restrict__ sel_count, int levels,
                         int* __restrict__ flags) {
  if constexpr (!gstack_sel(SEL))
    if (rewalk_skips(flags)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = ring_chunks(TM, CORE, c_ld * ring_elem_bytes(CORE));
  float* St = reinterpret_cast<float*>(
      smem + ring_bytes(TM, CORE, chunks, q_resident, stages));
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
  const int* list = LISTED ? tiles + (size_t)(row0 / block_rows) * p
                           : nullptr;
  const int n_tiles = LISTED ? p * tn_tiles : (n + kTN - 1) / kTN;
  const int layout_tiles =
      LISTED ? (n + tn_tiles * kTN - 1) / (tn_tiles * kTN) : 0;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if constexpr (SEL == kRadix)
    init_radix<TM>(Cv, rows_valid);
  else if constexpr (SEL == kGstack)
    init_gstack<TM>(Cv, levels, rows_valid);
  else if constexpr (SEL == kGstackBig)
    init_gstack_big<TM>(Cv, levels, rows_valid);
  else if constexpr (SEL == kStack)
    init_stack<TM>(StackState<TM>{Cv, k}, rows_valid);
  else
    init_carry(Cv, Ci, k, TM, rows_valid);
  const CarryGate<TM * (kTN + 1), word_bound(SEL)> gate{
      k, prune, gate_count};
  if constexpr (SEL == kAppend)   // the slack counts
    for (int r = tid; r < TM; r += kThreads)
      reinterpret_cast<int*>(Lv)[r] = 0;
  [[maybe_unused]] BucketCells<TM / kWarps> cells;
  if constexpr (SEL == kBucket) init_bucket(cells, Lv);
  [[maybe_unused]] int window = 0;   // the stack selection's
  ring_walk<TM, CORE, LISTED>(
      qp, cp, scale, cb, mask, list, layout_tiles, tn_tiles, smem, St, row0,
      m, n, dim, c_ld, ck, t_begin, t_end, stages, q_resident, vec,
      [&](int t, int n0) {
        if constexpr (SEL == kRadix)
          radix_tile<TM, radix_lean(TM, CORE)>(St, Cv, k, n0, rows_valid,
                                               warp, lane, part_v, part_i,
                                               row0, splits, split);
        else if constexpr (SEL == kGstack)
          gstack_tile<TM, radix_lean(TM, CORE)>(St, Cv, k, levels, n0,
                                                rows_valid, warp, lane);
        else if constexpr (SEL == kGstackBig)
          gstack_big_tile<TM>(St, Cv, k, levels, n0, rows_valid, warp, lane);
        else if constexpr (SEL == kStack) {
          const StackState<TM> S{Cv, k};
          const int w = (t - t_begin) / kStackWindow;
          if (w != window) {
            stack_window_end<TM>(S, rows_valid, warp, lane);
            window = w;
          }
          stack_tile<TM>(St, S, n0, rows_valid, warp, lane);
        }
        else if constexpr (SEL == kBucket)
          bucket_tile<TM>(St, Cv, Ci, Lv + warp * kTN, Li + warp * kTN,
                          cells, k, n0, rows_valid, warp, lane, sel_count);
        else if constexpr (SEL == kAppend)
          append_tile<TM, compact_lanes(TM, CORE)>(
              St, Cv, k, n0, rows_valid, warp, lane, part_v, part_i, row0,
              splits, split);
        else
          select_tile<TM>(St, Cv, Ci, Lv + warp * kTN, Li + warp * kTN, k,
                          n0, rows_valid, warp, lane);
      },
      gate);
  if constexpr (SEL == kRadix) {
    radix_finish<TM>(Cv, k, rows_valid, warp, lane, part_v, part_i, row0,
                     splits, split);
    return;
  }
  if constexpr (SEL == kGstack) {
    gstack_finish<TM>(Cv, k, levels, rows_valid, warp, lane, part_v, part_i,
                      row0, splits, split, sel_count, flags);
    return;
  }
  if constexpr (SEL == kGstackBig) {
    gstack_big_finish<TM>(Cv, k, levels, rows_valid, warp, lane, part_v,
                          part_i, row0, splits, split, sel_count, flags);
    return;
  }
  if constexpr (SEL == kStack) {
    stack_finish<TM>(StackState<TM>{Cv, k}, rows_valid, warp, lane, part_v,
                     part_i, row0, splits, split);
    return;
  }
  if constexpr (SEL == kAppend)
    flush_slack<TM, compact_lanes(TM, CORE)>(Cv, k, rows_valid, warp, lane,
                                             part_v, part_i, row0, splits,
                                             split);
  if constexpr (SEL == kBucket)
    bucket_flush<TM>(Cv, Ci, Lv + warp * kTN, Li + warp * kTN, cells, k,
                     rows_valid, warp, lane, sel_count);
  for (int e = tid; e < rows_valid * k; e += kThreads) {
    const int r = e / k, j = e % k;
    const size_t o = ((size_t)(row0 + r) * splits + split) * k + j;
    part_v[o] = Cv[e];
    part_i[o] = Ci[e];
  }
}

// The stored cores at query tile 64: ring_wgmma.cuh's ring, filled by
// TMA loads on the launch's maps (byte by byte where vec is false), and its
// warpgroup products, each warpgroup on its own kernel tiles (kWgTiles a
// step), the same selection on each tile's scores in walk order.
template <int TM, int CORE, bool LISTED, bool APPEND>
__global__ void __launch_bounds__(kThreads, kWgBlocks)
fused_topk_wgmma_kernel(const __grid_constant__ WgMaps maps,
                        const uint16_t* __restrict__ qp,
                        const void* __restrict__ cp,
                        const float* __restrict__ scale,
                        const float* __restrict__ cb,
                        const uint8_t* __restrict__ mask,
                        const int* __restrict__ tiles,
                        float* __restrict__ part_v,
                        int* __restrict__ part_i,
                        int m, int n, int dim, int c_ld, int ck, int k,
                        int splits, int tiles_per_split, int p,
                        int tn_tiles, int block_rows, bool vec,
                        int stages, bool prune,
                        int* __restrict__ gate_count) {
  static_assert(TM == kWgTM, "the warpgroup consumer takes 64 query rows");
  extern __shared__ __align__(16) unsigned char smem[];
  float* St = wg_tail(smem, CORE, stages);
  float* Cv = St + kWgTiles * TM * (kTN + 1);
  int* Ci = reinterpret_cast<int*>(Cv + (size_t)TM * k);
  float* Lv = reinterpret_cast<float*>(Ci + (size_t)TM * k);
  int* Li = reinterpret_cast<int*>(Lv + kWarps * kTN);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TM;
  const int rows_valid = min(TM, m - row0);
  const int split = blockIdx.y;
  const int* list = LISTED ? tiles + (size_t)(row0 / block_rows) * p
                           : nullptr;
  const int n_tiles = LISTED ? p * tn_tiles : (n + kTN - 1) / kTN;
  const int layout_tiles =
      LISTED ? (n + tn_tiles * kTN - 1) / (tn_tiles * kTN) : 0;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  init_carry(Cv, Ci, k, TM, rows_valid);
  const CarryGate<kWgTiles * TM * (kTN + 1)> gate{k, prune, gate_count};
  if constexpr (APPEND)   // the slack counts
    for (int r = tid; r < TM; r += kThreads)
      reinterpret_cast<int*>(Lv)[r] = 0;
  wg_walk<CORE, LISTED>(
      maps, qp, cp, scale, cb, mask, list, layout_tiles, tn_tiles, smem, St,
      row0, m, n, dim, c_ld, ck, t_begin, t_end, stages, vec,
      [&](const WgStep& step) {
        // A row's warp takes the step's tiles in order.
#pragma unroll 1
        for (int j = 0; j < kWgTiles; ++j)
          if (step.n0[j] >= 0) {
            if constexpr (APPEND)
              append_tile<TM, 4>(St + j * TM * (kTN + 1), Cv, k, step.n0[j],
                              rows_valid, warp, lane, part_v, part_i, row0,
                              splits, split);
            else
              select_tile<TM, 1>(St + j * TM * (kTN + 1), Cv, Ci,
                                 Lv + warp * kTN, Li + warp * kTN, k,
                                 step.n0[j], rows_valid, warp, lane);
          }
      },
      gate);
  if constexpr (APPEND)
    flush_slack<TM, 4>(Cv, k, rows_valid, warp, lane, part_v, part_i, row0,
                    splits, split);
  for (int e = tid; e < rows_valid * k; e += kThreads) {
    const int r = e / k, j = e % k;
    const size_t o = ((size_t)(row0 + r) * splits + split) * k + j;
    part_v[o] = Cv[e];
    part_i[o] = Ci[e];
  }
}

// Whether the (TM, CORE) launch takes the warpgroup consumer: the stored
// cores at query tile 64.  bf16x3 keeps the mma.sync ring there: a
// warpgroup walk of it (three wgmma a k16, one block an SM, which halves
// the warps that select and leaves the canonical 16 query tiles x 9
// splits for 132 SMs) was the slower at every shape measured on the H100
// and is not built (PERF.md, ROADMAP.md).
template <int TM, int CORE>
constexpr bool wgmma_core() {
  return stored_core(CORE) && TM == kWgTM;
}

// The ring core a launch of CORE at query tile TM streams: bf16x3 takes 64
// features a position (kBf16x3W) at query tiles 16 and 64 wherever that
// ring keeps two blocks an SM (at 256 dims and more: tile 16 up to k = 495,
// tile 64 up to k = 45), else 32.  Chosen by measurement on the H100
// (PERF.md): wider positions cost fewer barriers a byte, two blocks an SM
// outweigh them, and at query tile 32 the wide listed walk spilled.
template <int TM, int CORE>
int ring_core_beside(int c_ld, size_t tail) {
  if constexpr (CORE == kBf16x3 && TM != 32) {
    const RingPlan wide =
        ring_plan(TM, kBf16x3W, ring_chunks(TM, kBf16x3W, 2 * c_ld), tail);
    if (wide.stages > 0 && smem_blocks(wide.bytes) >= 2) return kBf16x3W;
  }
  return CORE;
}

// The ring core beside the carry's selections' tail at k.
template <int TM, int CORE>
int ring_core(int k, int c_ld) {
  return ring_core_beside<TM, CORE>(c_ld, tail_bytes(TM, k));
}

// The ring of a core at this k and corpus row stride c_ld (the f32 core's:
// dim).
template <int TM, int CORE>
RingPlan stored_plan(int k, int c_ld) {
  if constexpr (wgmma_core<TM, CORE>()) {
    return wg_plan(CORE, k);
  } else if constexpr (CORE == kHighest) {
    return f32_plan(TM, c_ld, tail_bytes(TM, k));
  } else {
    const int core = ring_core<TM, CORE>(k, c_ld);
    return ring_plan(TM, core,
                     ring_chunks(TM, core, c_ld * ring_elem_bytes(core)),
                     tail_bytes(TM, k));
  }
}

// Whether a launch of kernel A at query tile tm, core and k that asks for
// the gstack selection takes it: k up to kAppendMaxK on the mma.sync ring
// and the f32 walk, where the stacks fit beside the ring's least plan (two
// stages, the query tile riding them; bf16x3's 32-feature ring).
// The warpgroup consumer is not built: its threads hold 254-255 registers,
// and its four score tiles (66.6 KB) beside stacks of three levels for 64
// rows (96 KB) leave too little for its ring's stages.
inline bool gstack_built(int tm, int core, int k) {
  if (k < 1 || k > kAppendMaxK || (stored_core(core) && tm == kWgTM))
    return false;
  const size_t ring = 2 * (core == kHighest ? f32_stage_bytes(tm, false)
                                            : ring_stage_bytes(tm, core,
                                                               false));
  return ring + gstack_tail_bytes(tm, gstack_levels(k, tm)) <= kMaxSmem;
}

// The ring core of the gstack instantiation beside its stacks (bf16x3's
// 64-feature ring wherever that keeps two blocks an SM, as ring_core).
template <int TM, int CORE>
int gstack_core(int k, int c_ld) {
  return ring_core_beside<TM, CORE>(
      c_ld, gstack_tail_bytes(TM, gstack_levels(k, TM)));
}

// The ring of the gstack instantiation beside its stacks.
template <int TM, int CORE>
RingPlan gstack_plan(int k, int c_ld) {
  const size_t tail = gstack_tail_bytes(TM, gstack_levels(k, TM));
  if constexpr (CORE == kHighest) {
    return f32_plan(TM, c_ld, tail);
  } else {
    const int core = gstack_core<TM, CORE>(k, c_ld);
    return ring_plan(TM, core,
                     ring_chunks(TM, core, c_ld * ring_elem_bytes(core)),
                     tail);
  }
}

// The stack selection's instantiations: the bf16x3 core's mma.sync ring
// (and its wide form) and the f32 walk, at query tiles 16 and 32, dense
// (the class fused_topk.stack_route takes it in; the other cores, query
// tile 64 and the tile lists were slower or not measured, PERF.md).
template <int TM, int CORE, bool LISTED>
constexpr bool stack_instance() {
  return (TM == 16 || TM == 32) && (CORE == kBf16x3 || CORE == kHighest) &&
         !LISTED;
}

// Whether a dense launch of kernel A at query tile tm, core and k that
// asks for the stack selection takes it: k up to kAppendMaxK on an
// instantiation, where its tail fits beside the ring's least plan.
inline bool stack_built(int tm, int core, int k) {
  if (k < 1 || k > kAppendMaxK || (tm != 16 && tm != 32) ||
      (core != kBf16x3 && core != kHighest))
    return false;
  const size_t ring = 2 * (core == kHighest ? f32_stage_bytes(tm, false)
                                            : ring_stage_bytes(tm, core,
                                                               false));
  return ring + stack_tail_bytes(tm, k) <= kMaxSmem;
}

// The ring of the stack instantiation beside its tail.
template <int TM, int CORE>
RingPlan stack_plan(int k, int c_ld) {
  const size_t tail = stack_tail_bytes(TM, k);
  if constexpr (CORE == kHighest) {
    return f32_plan(TM, c_ld, tail);
  } else {
    const int core = ring_core_beside<TM, CORE>(c_ld, tail);
    return ring_plan(TM, core,
                     ring_chunks(TM, core, c_ld * ring_elem_bytes(core)),
                     tail);
  }
}

// The gstack selection's plan above kAppendMaxK at query tile tm, core, k
// and tiles_per_split tps: its depth, and whether it is built.  Lossless
// first: a cell sees one score a tile, so levels >= tps never drop one (at
// least (k - 1) / 64 + 1, the bound's).  Elsewhere the least depth from
// the bound's whose gstack_fire_bound is at most kGstackFire (the union
// bound on a launch's fire, as gstack_levels), up to kGstackBigMaxLevels.
// Either is built at the query tile kGstackBigTM where its stacks fit
// beside the ring's least plan (two stages, the query tile riding them;
// bf16x3's 32-feature ring).  Not built, levels is the depth it wanted
// (searched up to 2 kGstackBigMaxLevels).  fused_topk.gstack_big_plan is
// the host's mirror.
struct GstackBig {
  int levels;
  bool built;
};

inline size_t gstack_least_ring(int tm, int core) {
  return 2 * (core == kHighest ? f32_stage_bytes(tm, false)
                               : ring_stage_bytes(tm, core, false));
}

inline GstackBig gstack_big_plan(int tm, int core, int k, int tps) {
  const int least = (k - 1) / kGstackCells + 1;
  int levels = tps > least ? tps : least;
  if (levels > kGstackBigMaxLevels) {
    levels = least;
    while (levels < 2 * kGstackBigMaxLevels &&
           gstack_fire_bound(k, tm, levels) > kGstackFire)
      ++levels;
  }
  const size_t ring = gstack_least_ring(tm, core);
  const bool ok = k > kAppendMaxK && k <= kGstackBigMaxK &&
                  tm == kGstackBigTM && !(stored_core(core) && tm == kWgTM) &&
                  levels <= kGstackBigMaxLevels;
  return {levels,
          ok && ring + gstack_big_tail_bytes(tm, levels) <= kMaxSmem};
}

// The ring beside the stacks of a plan above kAppendMaxK (bf16x3's
// 64-feature ring wherever that keeps two blocks an SM, as ring_core).
template <int TM, int CORE>
RingPlan gstack_big_ring(int c_ld, size_t tail) {
  if constexpr (CORE == kHighest) {
    return f32_plan(TM, c_ld, tail);
  } else {
    const int core = ring_core_beside<TM, CORE>(c_ld, tail);
    return ring_plan(TM, core,
                     ring_chunks(TM, core, c_ld * ring_elem_bytes(core)),
                     tail);
  }
}

// The kernel of selection sel: K<kInsert>, K<kAppend>, K<kRadix>, or,
// where BUCKET, K<kBucket>.
template <bool BUCKET, typename Pick>
auto by_selection(int sel, Pick&& pick) {
  if constexpr (BUCKET)
    if (sel == kBucket) return pick(std::integral_constant<int, kBucket>{});
  return sel == kRadix    ? pick(std::integral_constant<int, kRadix>{})
         : sel == kAppend ? pick(std::integral_constant<int, kAppend>{})
                          : pick(std::integral_constant<int, kInsert>{});
}

// Kernel<TM, CORE, LISTED, selection(k)>, or <..., kBucket> where bucket
// asks for it and bucket_built, its shared memory (0 where it cannot fit)
// and its ring.  The warpgroup consumer keeps the slack above k = 16 (its
// query tile takes k <= 128) and takes no bucket.  (The gstack
// instantiations are gstack_kernel_of's, in the gstack unit.)
template <int TM, int CORE, bool LISTED>
auto kernel_of(int k, int c_ld, bool bucket, size_t& bytes, RingPlan& plan) {
  plan = stored_plan<TM, CORE>(k, c_ld);
  bytes = plan.bytes;
  const int sel = bucket && bucket_built(TM, CORE, k) ? kBucket
                                                      : selection(k);
  if constexpr (wgmma_core<TM, CORE>()) {
    return sel != kInsert ? fused_topk_wgmma_kernel<TM, CORE, LISTED, true>
                          : fused_topk_wgmma_kernel<TM, CORE, LISTED, false>;
  } else if constexpr (CORE == kHighest) {
    return by_selection<bucket_tile(TM, kHighest)>(sel, [](auto s) {
      return fused_topk_f32_kernel<TM, LISTED, decltype(s)::value>;
    });
  } else {
    if constexpr (CORE == kBf16x3 && TM != 32)
      if (ring_core<TM, CORE>(k, c_ld) == kBf16x3W)
        return by_selection<bucket_tile(TM, kBf16x3W)>(sel, [](auto s) {
          return fused_topk_stored_kernel<TM, kBf16x3W, LISTED,
                                          decltype(s)::value>;
        });
    return by_selection<bucket_tile(TM, CORE)>(sel, [](auto s) {
      return fused_topk_stored_kernel<TM, CORE, LISTED, decltype(s)::value>;
    });
  }
}

// The gstack instantiation of kernel<TM, CORE, LISTED> (bf16x3 on the
// ring gstack_core picks), its shared memory and its ring: the mma.sync
// ring's and the f32 walk's, where gstack_built.
template <int TM, int CORE, bool LISTED>
auto gstack_kernel_of(int k, int c_ld, size_t& bytes, RingPlan& plan) {
  plan = gstack_plan<TM, CORE>(k, c_ld);
  bytes = plan.bytes;
  if constexpr (CORE == kHighest) {
    return fused_topk_f32_kernel<TM, LISTED, kGstack>;
  } else {
    if constexpr (CORE == kBf16x3 && TM != 32)
      if (gstack_core<TM, CORE>(k, c_ld) == kBf16x3W)
        return fused_topk_stored_kernel<TM, kBf16x3W, LISTED, kGstack>;
    return fused_topk_stored_kernel<TM, CORE, LISTED, kGstack>;
  }
}

// The instantiation of kernel<TM, CORE, LISTED> above kAppendMaxK
// (bf16x3 on the ring gstack_big_ring picks), its shared memory and its
// ring.
template <int TM, int CORE, bool LISTED>
auto gstack_big_kernel(int c_ld, size_t tail, size_t& bytes,
                       RingPlan& plan) {
  plan = gstack_big_ring<TM, CORE>(c_ld, tail);
  bytes = plan.bytes;
  if constexpr (CORE == kHighest) {
    return fused_topk_f32_kernel<TM, LISTED, kGstackBig>;
  } else {
    if constexpr (CORE == kBf16x3 && TM != 32)
      if (ring_core_beside<TM, CORE>(c_ld, tail) == kBf16x3W)
        return fused_topk_stored_kernel<TM, kBf16x3W, LISTED, kGstackBig>;
    return fused_topk_stored_kernel<TM, CORE, LISTED, kGstackBig>;
  }
}

// The stack instantiation of kernel<TM, CORE, false> (bf16x3 on the ring
// ring_core_beside picks beside its tail), its shared memory and its ring,
// where stack_built.
template <int TM, int CORE>
auto stack_kernel_of(int k, int c_ld, size_t& bytes, RingPlan& plan) {
  plan = stack_plan<TM, CORE>(k, c_ld);
  bytes = plan.bytes;
  if constexpr (CORE == kHighest) {
    return fused_topk_f32_kernel<TM, false, kStack>;
  } else {
    if constexpr (TM != 32)
      if (ring_core_beside<TM, CORE>(c_ld, stack_tail_bytes(TM, k)) ==
          kBf16x3W)
        return fused_topk_stored_kernel<TM, kBf16x3W, false, kStack>;
    return fused_topk_stored_kernel<TM, CORE, false, kStack>;
  }
}

// One launch of `kern`, a kernel<TM, CORE, LISTED> of `bytes` shared
// memory on `plan`: sel_count the selection's counters, levels and flags
// the gstack's (its depth; its block flags, written by a gstack launch,
// read by the re-walk of an exact one).
template <int TM, int CORE, bool LISTED, typename Kern>
int launch_kernel(Kern kern, size_t bytes, const RingPlan& plan,
                  const void* qp, const void* cp, const float* scale,
                  const float* cb, const uint8_t* mask, const int* tiles,
                  float* part_v, int* part_i, int m, int n, int dim,
                  int c_ld, int ck, int k, int splits, int tiles_per_split,
                  int p, int tn_tiles, int block_rows, bool prune,
                  int* gate_count, int* sel_count, int levels, int* flags,
                  cudaStream_t stream) {
  if (bytes == 0 || bytes > kMaxSmem) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + TM - 1) / TM, splits);
  if constexpr (CORE == kHighest) {
    // The ring's 16-byte copies: whole 4-feature pieces, aligned rows.
    kern<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(qp), static_cast<const float*>(cp), cb,
        mask, tiles, part_v, part_i, m, n, dim, k, splits, tiles_per_split,
        p, tn_tiles, block_rows,
        dim % 4 == 0 && aligned(qp, 16) && aligned(cp, 16), plan.stages,
        plan.q_resident, prune, gate_count, sel_count, levels, flags);
  } else {
    const size_t row_bytes = (size_t)c_ld * ring_elem_bytes(CORE);
    const bool vec = ring_aligned(qp, cp, dim, row_bytes);
    if constexpr (wgmma_core<TM, CORE>()) {
      WgMaps maps{};   // unread where vec is false
      if (vec) {
        const int rc = wg_maps(maps, CORE, qp, cp, m, n, dim, row_bytes);
        if (rc != 0) return rc;
      }
      kern<<<grid, kThreads, bytes, stream>>>(
          maps, static_cast<const uint16_t*>(qp), cp, scale, cb, mask, tiles,
          part_v, part_i, m, n, dim, c_ld, ck, k, splits, tiles_per_split, p,
          tn_tiles, block_rows, vec, plan.stages, prune, gate_count);
    } else
      kern<<<grid, kThreads, bytes, stream>>>(
          static_cast<const uint16_t*>(qp), cp, scale, cb, mask, tiles,
          part_v, part_i, m, n, dim, c_ld, ck, k, splits, tiles_per_split, p,
          tn_tiles, block_rows, vec, plan.stages, plan.q_resident, prune,
          gate_count, sel_count, levels, flags);
  }
  return (int)cudaGetLastError();
}

#if !defined(PMM_GSTACK_UNIT) && !defined(PMM_GSTACK_BIG_UNIT) && \
    !defined(PMM_STACK_UNIT)
// Kernel A as alt asks (0: its selection by k, kBucket, kGstack, kStack).
// A gstack launch (the units' pmm_fused_topk_gstack_launch and
// pmm_fused_topk_gstack_big_launch) is followed by the exact selection's
// launch on the same grid, which walks again, exactly, the splits of the
// blocks the detector flagged and returns at once in every other block: no
// host synchronisation, and the lists are the exact selection's bit for
// bit.  A lossless plan above kAppendMaxK (levels >= the split's tiles)
// cannot fire and launches no re-walk; nor does the stack selection
// (pmm_fused_topk_stack_launch), whose cells are lossless.
template <int TM, int CORE, bool LISTED>
int launch(const void* qp, const void* cp, const float* scale,
           const float* cb, const uint8_t* mask, const int* tiles,
           float* part_v, int* part_i, int m, int n, int dim, int c_ld,
           int ck, int k, int splits, int tiles_per_split, int p,
           int tn_tiles, int block_rows, bool prune, int* gate_count,
           int alt, int* sel_count, int* flags, cudaStream_t stream) {
  bool gstack = alt == kGstack && gstack_built(TM, CORE, k);
  if (gstack) {
    if (flags == nullptr) return -1;
    const int rc = pmm_fused_topk_gstack_launch(
        qp, cp, scale, cb, mask, tiles, part_v, part_i, m, n, dim, c_ld, ck,
        k, splits, tiles_per_split, p, tn_tiles, block_rows, TM, CORE,
        LISTED, prune, gate_count, sel_count, flags, stream);
    if (rc != 0) return rc;
  } else if (alt == kStack && !LISTED && stack_built(TM, CORE, k)) {
    return pmm_fused_topk_stack_launch(qp, cp, scale, cb, mask, part_v,
                                       part_i, m, n, dim, c_ld, ck, k, splits,
                                       tiles_per_split, TM, CORE, prune,
                                       gate_count, stream);
  } else if (alt == kGstack && k > kAppendMaxK) {
    const GstackBig big = gstack_big_plan(TM, CORE, k, tiles_per_split);
    if (big.built) {
      if (flags == nullptr) return -1;
      const int rc = pmm_fused_topk_gstack_big_launch(
          qp, cp, scale, cb, mask, tiles, part_v, part_i, m, n, dim, c_ld,
          ck, k, splits, tiles_per_split, p, tn_tiles, block_rows, TM, CORE,
          LISTED, prune, gate_count, sel_count, flags, stream);
      if (rc != 0 || big.levels >= tiles_per_split) return rc;
      gstack = true;
    }
  }
  size_t bytes;
  RingPlan plan{};
  auto kern = kernel_of<TM, CORE, LISTED>(k, c_ld, alt == kBucket, bytes,
                                          plan);
  return launch_kernel<TM, CORE, LISTED>(
      kern, bytes, plan, qp, cp, scale, cb, mask, tiles, part_v, part_i, m,
      n, dim, c_ld, ck, k, splits, tiles_per_split, p, tn_tiles, block_rows,
      prune, gate_count, gstack ? nullptr : sel_count, 0,
      gstack ? flags : nullptr, stream);
}

// Blocks of kernel<TM, CORE, LISTED> one SM holds at this k and corpus row
// stride (its registers and shared memory), or a negative cudaError_t.  The
// bucket instantiations have the insertion's shared memory and the same
// launch bounds, so they hold as many; a gstack launch takes the
// insertion's or slack's geometry too (its re-walk runs on the same grid).
template <int TM, int CORE, bool LISTED>
int occupancy(int k, int c_ld) {
  size_t bytes;
  RingPlan plan{};
  auto kern = kernel_of<TM, CORE, LISTED>(k, c_ld, false, bytes, plan);
  if (bytes == 0 || bytes > kMaxSmem) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      kThreads, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

#endif  // !PMM_GSTACK_UNIT && !PMM_GSTACK_BIG_UNIT && !PMM_STACK_UNIT

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

#ifdef PMM_GSTACK_UNIT
int pmm_fused_topk_gstack_launch(
    const void* qp, const void* cp, const float* scale, const float* cb,
    const uint8_t* mask, const int* tiles, float* part_v, int* part_i, int m,
    int n, int dim, int c_ld, int ck, int k, int splits, int tiles_per_split,
    int p, int tn_tiles, int block_rows, int tm, int core, int listed,
    int prune, int* gate_count, int* sel_count, int* flags, void* stream) {
  if (!gstack_built(tm, core, k)) return -1;
  return dispatch(tm, core, listed != 0, [&](auto tmc, auto cc, auto lc) {
    constexpr int TM = decltype(tmc)::value, CORE = decltype(cc)::value;
    constexpr bool LISTED = decltype(lc)::value;
    if constexpr (wgmma_core<TM, CORE>()) {
      return -1;
    } else {
      size_t bytes;
      RingPlan plan{};
      auto kern = gstack_kernel_of<TM, CORE, LISTED>(k, c_ld, bytes, plan);
      return launch_kernel<TM, CORE, LISTED>(
          kern, bytes, plan, qp, cp, scale, cb, mask, tiles, part_v, part_i,
          m, n, dim, c_ld, ck, k, splits, tiles_per_split, p, tn_tiles,
          block_rows, prune != 0, gate_count, sel_count,
          gstack_levels(k, TM), flags, static_cast<cudaStream_t>(stream));
    }
  });
}
#elif defined(PMM_STACK_UNIT)
int pmm_fused_topk_stack_launch(
    const void* qp, const void* cp, const float* scale, const float* cb,
    const uint8_t* mask, float* part_v, int* part_i, int m, int n, int dim,
    int c_ld, int ck, int k, int splits, int tiles_per_split, int tm,
    int core, int prune, int* gate_count, void* stream) {
  if (!stack_built(tm, core, k)) return -1;
  return dispatch(tm, core, false, [&](auto tmc, auto cc, auto lc) {
    constexpr int TM = decltype(tmc)::value, CORE = decltype(cc)::value;
    if constexpr (!stack_instance<TM, CORE, decltype(lc)::value>()) {
      return -1;
    } else {
      size_t bytes;
      RingPlan plan{};
      auto kern = stack_kernel_of<TM, CORE>(k, c_ld, bytes, plan);
      return launch_kernel<TM, CORE, false>(
          kern, bytes, plan, qp, cp, scale, cb, mask, nullptr, part_v, part_i,
          m, n, dim, c_ld, ck, k, splits, tiles_per_split, 0, 0, 0,
          prune != 0, gate_count, nullptr, 0, nullptr,
          static_cast<cudaStream_t>(stream));
    }
  });
}

extern "C" {

// Whether a dense launch of kernel A at query tile tm, core and k that
// asks for the stack selection takes it (1 or 0; -1 for k <= 0), and out =
// {its window (its cells' depth), its tail plus the ring's least plan in
// bytes, its ring's stages (0 where not built)}.
int pmm_fused_topk_stack(int tm, int core, int k, int c_ld, int* out) {
  if (k <= 0 || c_ld <= 0 || core < 0 || core > kInt4c) return -1;
  const bool built = stack_built(tm, core, k);
  out[0] = kStackWindow;
  out[1] = (int)(2 * (core == kHighest ? f32_stage_bytes(tm, false)
                                       : ring_stage_bytes(tm, core, false)) +
                 stack_tail_bytes(tm, k));
  out[2] = !built ? 0 : dispatch(tm, core, false, [&](auto tmc, auto cc, auto) {
    constexpr int TM = decltype(tmc)::value, CORE = decltype(cc)::value;
    return stack_plan<TM, CORE>(k, c_ld).stages;
  });
  return built ? 1 : 0;
}

}  // extern "C"
#elif defined(PMM_GSTACK_BIG_UNIT)
int pmm_fused_topk_gstack_big_launch(
    const void* qp, const void* cp, const float* scale, const float* cb,
    const uint8_t* mask, const int* tiles, float* part_v, int* part_i, int m,
    int n, int dim, int c_ld, int ck, int k, int splits, int tiles_per_split,
    int p, int tn_tiles, int block_rows, int tm, int core, int listed,
    int prune, int* gate_count, int* sel_count, int* flags, void* stream) {
  const GstackBig big = gstack_big_plan(tm, core, k, tiles_per_split);
  if (!big.built) return -1;
  return dispatch(tm, core, listed != 0, [&](auto tmc, auto cc, auto lc) {
    constexpr int TM = decltype(tmc)::value, CORE = decltype(cc)::value;
    constexpr bool LISTED = decltype(lc)::value;
    if constexpr (TM != kGstackBigTM || wgmma_core<TM, CORE>()) {
      return -1;
    } else {
      size_t bytes;
      RingPlan plan{};
      auto kern = gstack_big_kernel<TM, CORE, LISTED>(
          c_ld, gstack_big_tail_bytes(TM, big.levels), bytes, plan);
      return launch_kernel<TM, CORE, LISTED>(
          kern, bytes, plan, qp, cp, scale, cb, mask, tiles, part_v, part_i,
          m, n, dim, c_ld, ck, k, splits, tiles_per_split, p, tn_tiles,
          block_rows, prune != 0, gate_count, sel_count, big.levels, flags,
          static_cast<cudaStream_t>(stream));
    }
  });
}
#else
extern "C" {

// Returns 0 on success, a cudaError_t after a refused launch, the
// CUresult of a tensor map that failed to encode (the stored cores at
// query tile 64), or -1 for arguments the kernel does not take.  core is
// a Core: qp is f32 (rows, dim) for kHighest and bf16 (rows, 2*dim)
// [hi | lo] otherwise; cp is
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
//
// prune != 0 turns the carry gate on (exact: the lists are those with it
// off); gate_count, if not null, is two int32 counters the kernel adds
// {tiles gated, tiles skipped} to.
//
// alt asks for another selection: 3 the bucket selection, which the
// launch takes where pmm_fused_topk_bucket says so; 4 the gstack
// selection, where pmm_fused_topk_gstack says so; 6 the stack selection,
// where pmm_fused_topk_stack says so; 0 none (the lists are the same, bit
// for bit, whatever alt is).  alt_count, if not null, is two int32
// counters such a launch adds to: the bucket's {windows ended, overflow
// entries}, the gstack's and the stack's {rows fired, blocks fired} (a
// row is a query row's split).  flags, for a gstack or stack launch, is
// one int32 a block of the (ceil(m / tm), splits) grid, which it writes
// and its re-walk reads.
int pmm_fused_topk_partial(const void* qp, const void* cp, const float* scale,
                           const float* cb, const uint8_t* mask,
                           const int* tiles, float* part_v, int* part_i,
                           int m, int n, int dim, int c_ld, int ck, int k,
                           int splits, int tiles_per_split, int tm, int core,
                           int n_lists, int p, int tn, int block_rows,
                           int prune, int* gate_count, int alt,
                           int* alt_count, int* flags, void* stream) {
  if (m <= 0 || n <= 0 || dim <= 0 || k <= 0 || splits <= 0 ||
      tiles_per_split <= 0 ||
      (alt != 0 && alt != kBucket && alt != kGstack && alt != kStack))
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
        block_rows, prune != 0, gate_count, alt, alt_count, flags, s);
  });
}

// Blocks of the (tm, core, listed) kernel that one SM of the current
// device holds at this k and corpus row stride c_ld (pmm_fused_topk_partial's
// c_ld); negative on an error, -1 for arguments it does not take.
int pmm_fused_topk_blocks_per_sm(int tm, int k, int core, int listed,
                                 int c_ld) {
  if (k <= 0 || c_ld <= 0) return -1;
  return dispatch(tm, core, listed != 0, [&](auto tmc, auto cc, auto lc) {
    return occupancy<decltype(tmc)::value, decltype(cc)::value,
                     decltype(lc)::value>(k, c_ld);
  });
}

// Kernel A's selection at k: 0 inserts, 1 appends to the slack, 2 takes
// the radix selection (the warpgroup consumer appends at 2); -1 for k <= 0.
int pmm_fused_topk_route(int k) {
  return k <= 0 ? -1 : selection(k);
}

// Whether a launch of kernel A at query tile tm, core and k that asks for
// the bucket selection takes it: 1 or 0; -1 for k <= 0.
int pmm_fused_topk_bucket(int tm, int core, int k) {
  if (k <= 0) return -1;
  return bucket_built(tm, core, k) ? 1 : 0;
}

// Whether a launch of kernel A at query tile tm, core and k that asks for
// the gstack selection takes it: 1 or 0; -1 for k <= 0.
int pmm_fused_topk_gstack(int tm, int core, int k) {
  if (k <= 0) return -1;
  return gstack_built(tm, core, k) ? 1 : 0;
}

// The gstack selection's plan above kAppendMaxK (gstack_big_plan) at query
// tile tm, core, k and tiles_per_split tps: out = {levels, the stacks'
// tail plus the ring's least plan in bytes}; returns 1 where built, 0
// where not (out then the plan it wanted), -1 for k <= kAppendMaxK or tps
// <= 0.
int pmm_fused_topk_gstack_big(int tm, int core, int k, int tps, int* out) {
  if (k <= kAppendMaxK || tps <= 0 || core < 0 || core > kInt4c) return -1;
  const GstackBig big = gstack_big_plan(tm, core, k, tps);
  out[0] = big.levels;
  out[1] = (int)(gstack_least_ring(tm, core) +
                 gstack_big_tail_bytes(tm, big.levels));
  return big.built ? 1 : 0;
}

// The gstack selection's stack depth at k and query tile tm (gstack_levels);
// -1 for k <= 0.
int pmm_fused_topk_levels(int k, int tm) {
  return k <= 0 ? -1 : gstack_levels(k, tm);
}

// The staging of kernel A's core at query tile tm, k and corpus row
// stride c_ld (pmm_fused_topk_partial's c_ld): out = {stages, bytes a
// stage, query resident (0 / 1), the kernel's shared memory}.  Returns 0,
// or -1 for arguments it does not take.
int pmm_fused_topk_ring(int tm, int core, int c_ld, int k, int* out) {
  if (k <= 0 || c_ld <= 0) return -1;
  return dispatch(tm, core, false, [&](auto tmc, auto cc, auto) {
    constexpr int TM = decltype(tmc)::value, CORE = decltype(cc)::value;
    const RingPlan plan = stored_plan<TM, CORE>(k, c_ld);
    out[0] = plan.stages;
    out[1] = (int)(wgmma_core<TM, CORE>()
                       ? wg_stage_bytes(CORE)
                   : CORE == kHighest
                       ? f32_stage_bytes(TM, plan.q_resident)
                       : ring_stage_bytes(TM, ring_core<TM, CORE>(k, c_ld),
                                          plan.q_resident));
    out[2] = plan.q_resident ? 1 : 0;
    out[3] = (int)plan.bytes;
    return plan.stages > 0 ? 0 : -1;
  });
}

}  // extern "C"
#endif  // PMM_GSTACK_UNIT / PMM_STACK_UNIT / PMM_GSTACK_BIG_UNIT
