#!/usr/bin/env python3
"""Smoke run of polars_matmul_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each printing one line or a few:

0. the card (nvidia-smi name and power limit), torch and CUDA versions;
1. build of the CUDA kernels from this checkout's sources (nvcc, sm_90a,
   one compiler per source, all started together), each instantiation's
   registers and spills (none allowed in the warpgroup consumer), a line
   for each tile-64 stored instantiation of kernels A and D (registers,
   spills, its ring's stages, its TMA producer), and the
   stored cores' ring at dim 768 (stages, bytes a stage, the query's
   place, blocks an SM; query tiles 16 and 32 at k=100, 64 at k=10, 100
   and 128), the bf16x3 core's ring (``BF16X3_PLANS``, no spill allowed
   in any of its instantiations) and the highest core's f32 ring at dims
   256 and 768 (``HIGHEST_PLANS``), the source's plan held to the host's
   mirror; kernel A's bucket selection: the source's route
   (``pmm_fused_topk_bucket``) held to ``fused_topk.bucket_built`` at
   every query tile, core and k, and its instantiations' lines (no spill
   allowed); kernel A's gstack selection likewise (``pmm_fused_topk_gstack``
   against ``fused_topk.gstack_built``, ``pmm_fused_topk_levels`` against
   ``gstack_levels``, its instantiations' lines, no spill allowed, and its
   depth and ring beside its stacks at a few query tiles and k); kernel A's
   stack selection likewise (``pmm_fused_topk_stack``'s built and window
   against ``fused_topk.stack_built`` / ``STACK_WINDOW`` at every query
   tile, core and k <= 128, its instantiations' lines, no spill allowed,
   its tail and ring at a few query tiles and k);
2. each kernel against its plain PyTorch version on the card, over ragged
   shapes and at the shapes phases 3 and 4 give it, every metric and
   every core of kernel A (bf16x3, highest, bf16c, int8c, int4c; int4
   also above dim 4096), with and without a mask, with duplicate rows,
   and on integer tie data where the results must be bit-identical; the
   stored cores at the ring's edges (unaligned rows, a dim below and one
   not a multiple of a stage, int4 over two feature chunks, splits of one
   tile, a list whose last id lies past the corpus, k up to 1024; at
   query tile 64, the warpgroup consumer, 33, 65 and 300 queries, k up to
   128 and corpus rows not a multiple of a step); the highest and bf16x3
   cores at their rings' edges (dims 1, 3, 4, 5, 255, 257 and 768, query
   tiles 16, 32 and 64, k up to 512, the same splits and lists); the
   bf16x3 ring's mma.sync consumer against the per-tile staging it
   replaced (``scores_bf16x3``, kept as this reference), every score
   bit for bit on the canonical and 2M x 256 operands at query tiles 16,
   32 and 64; non-finite data (``NONFINITE_MS`` x ``NONFINITE_KS``: corpus
   rows and queries holding NaN and +-inf) through kernels A and B in every
   core, dense and listed, with and without a mask, against their plain
   versions (indices exact, integer data bit for bit), and the public
   ``topk`` / ``Corpus.topk`` on the card against the CPU on the same bad
   inputs; the
   on-card quantizers against the host NumPy ones, bit for bit (rows with
   NaN, +-inf and out-of-range entries included); kernel B
   bit for bit over a sweep of sorted lists (splits 1 to 1024, k 1 to
   1024, m 1 to 1000: tie data, padded and wholly -inf lists, -inf entries
   with real indices; one block a row and several); kernel A
   walking random per-block tile lists (probed search) in every core,
   and a list of every tile against the dense scan, bit for bit; and
   every launch of kernel A in this phase run again with its carry gate
   on (``prune``), the split lists equal to the gate off bit for bit
   (dense, listed, ragged, every core, inserting, appending and radix,
   both consumers), the count of cases and of skipped tiles printed;
   kernel A's selections on integer tie data bit for bit (``SELECT_KS``:
   the appending selection up to ``APPEND_MAX_K``, the radix selection
   above it in every core at query tiles 16 and 32, dense and listed;
   ``SLACK_EDGES``: the slack and the radix buffer filled exactly and one
   entry past); kernel A's bucket selection (``selection="bucket"``, k <=
   16): every launch of this phase where it is built run again asking for
   it, gate off and on, the split lists equal to the insertion's bit for
   bit (``BucketCheck``), and its own edges against the plain version bit
   for bit (``_bucket_edges``: every core, each query tile it is built
   at, k=1/2/5/10/16, splits of 1, 2, 3 and 17 tiles and a list, masks,
   zero query rows, class-heavy data that fills its overflow); kernel A's
   gstack selection (``selection="gstack"`` / ``"gpop"``, k <= 128): every
   launch of this phase where it is built run again asking for it, gate
   off and on, the split lists equal to the insertion's or the slack's
   bit for bit (``GstackCheck``), and its own edges against the plain
   version bit for bit with its fire counter equal to the plain version
   of its walk's (``_gstack_edges``: every core, each query tile it is
   built at, k=1/10/16/100/128, splits of 1, 3 and 17 tiles and a list,
   masks, zero query rows, planted collisions that must fire); kernel A's
   stack selection against its plain version and the plain version of its
   walk, bit for bit (``_stack_edges``: its cores, each query tile it is
   built at, ``STACK_KS``, dense splits of 1, 3 and 17 tiles, masks, zero
   query rows, planted data that crowds one column);
3. the canonical workload (1000 queries x 10,000 rows x 256 dims, f32,
   cosine, seed 42) through ``topk`` and a resident ``Corpus`` at k=10,
   k=100 and k=512, in the default precision and precision="highest",
   each held to a float64 NumPy oracle;
4. a 2,000,000 x 256 resident corpus answering requests of 8 and 256
   queries at k=10 and k=100, and one of 8 at k=10 through a corpus whose
   config asks for the bucket selection, and two through corpora asking
   for "gstack" (the 2M rows) and "gpop" (their first 10,000: gpop's
   envelope), and 8 queries at k=17 and 32 (the default "auto", which
   takes the stack selection in its class) and k=24 through a corpus
   asking for "stack", each held to a float64 oracle on the card;
5. the launch counts of each main path (phases 3 and 4, each tier of
   phase 7, and the probed path of phase 8): its kernels and cores ran,
   the radix selection ran (canonical k=512), the bucket, the gstack and
   the stack selections ran (phase 4's requests), the plain versions did
   not;
6. times from CUDA events: kernels against plain versions and library
   calls, and requests with their bounds (both cores at the canonical
   k=10, 100 and 512, each launch's selection, blocks, slots and splits
   printed; the highest core at 2M x 256 batch 8 and 256, and its
   canonical ``Corpus.topk`` request; the bf16x3 core likewise at 2M x
   256 batch 8 and 256, and on the 2M x 256 f32 clustered lists in phase
   8); kernel B at the seven list
   shapes of the main path's requests (``MERGE_SHAPES``), a call timed
   by CUDA events as every kernel is, and on the device alone (a CUDA
   graph of calls), beside ``torch.topk`` of the flattened lists and its
   byte bound; kernel A with its carry gate on and off in turns (the
   lists equal bit for bit, the share of tiles the gate skipped, each
   setting's times and their spread) at the canonical k=10 / 100 / 512,
   2M x 256 batch 8 / 256 at k=10 / 100, and, in phases 7 and 8, 10M x
   768 int8 and the clustered int8 corpus at probe 0.05, batch 8 / 256 at
   k=10 / 100, then whether the gate was ever slower where the JAX
   package's prune="auto" would turn it on; kernel A with the insertion
   and asked for the bucket selection in turns (``_time_bucket``: the
   lists equal, the bucket's windows and overflow entries, each route's
   times and their spread) at the canonical k=1 / 10 / 16 at query tiles
   32 and 16, 2M x 256 batch 8 k=10, and in phases 7 and 8 10M x 768 int8
   batch 8 k=10 and the probed cells at k <= 16, then where it was
   faster; kernel A with its own selection and asked for the gstack
   selection in turns (``_time_gstack``: the lists equal, the fire counter
   equal to the plain version of the walk, each route's times and their
   spread) at the canonical k=10 and 100 at query tiles 64, 32 and 16,
   2M x 256 batch 8 at k=10 and 100 and batch 256 at k=10, and in phases
   7 and 8 10M x 768 int8 batch 8 k=10 and the probed cells, then where
   it was faster; kernel A with the slack and asked for the stack
   selection in turns (``_time_stack``: the lists equal to the slack's
   and within tolerance of the plain version of the walk's, kernel A
   alone and A + B,
   each route's times and their spread, the plain version, the library
   call and the bound) in its class, 2M x 256 batch 8 at k=17 and 32 and
   the canonical k=17 and 32 at query tile 16, both cores, then where it
   was faster;
7. the full-width path: a 10,000,000 x 768 corpus (the north-star shape)
   made on the card from seed 42, stored as int8 (requests of 8 and 256
   queries at k=10 and k=100), int4 and bf16 (8 and 256 queries at
   k=100), one tier at a time, each request through ``Corpus.topk`` held
   to a float64 oracle over what the tier stores; int8 recall@10 against
   the f32 corpus is reported; each tier's kernels are also checked
   against their plain versions at these shapes (phase 2's checks), real
   and integer tie data; kernel A alone is timed at k=100, batch 8 and
   256;
8. probed search: a 10,000,000 x 768 Gaussian blob mixture made on the
   card from seed 42, built into ``ClusteredCorpus(storage="int8")`` (the
   f32 source freed after), answering 8 and 256 queries at k=10 and 100
   with probe=0.05 and probe=None, and a 2,000,000 x 256 f32 clustered
   corpus answering 1000 queries (routed over several tile lists) at
   k=10 and 100, probe=0.05; each request held to a float64 oracle over
   exactly the rows its lists visited; probed recall@10 against the
   exhaustive scan reported; listed kernel A checked against its plain
   version at these shapes and timed against its bound and a library
   yardstick, the f32 clustered corpus's lists in its highest core too;
9. the tiled product and autotune: ``pallas_matmul`` (kernel C, both
   cores: the f32 ``highest`` ring, the TMA + ``wgmma`` ``bf16x3`` body
   with its split kernel above 128 queries and the ``mma.sync`` body at
   128 or fewer) driven from NumPy at the canonical 1000 x 10,000 x 256
   shape and on card tensors at 8192 x 65,536 x 768 and 8 x 65,536 x 768,
   each held to a float64 product, with its launch counts by body (the
   split once a wgmma product); kernel C against its plain version over
   ragged shapes (and f64 inputs once) and at those three, against
   float64 too, the split kernel against ``split_pad_plain`` bit for bit,
   and the source's launch plan at those three printed; CUDA-event times
   (batches of 8 calls) of kernel C, its
   plain version and ``torch.matmul`` f32 beside the bound and the
   roofline share, the split's beside its byte bound, and cuBLAS's bf16
   rate on the split halves as a yardstick; ``autotune`` on the card
   (every candidate's time, the distinct launches it measured, the winner
   persisted under ``PMM_TPU_CACHE_DIR`` and served from there a second
   time, an all-defaults ``topk_torch`` adopting it, held to a float64
   oracle); explicit selections outside their envelope raising the JAX
   package's errors, dense and probed;
10. the attribution kit: kernel D (``csrc/floor.cu``, ``floor_stacks``,
   on kernel A's consumers): its launch plans (consumer, ring, stages,
   shared memory, register levels) held to the host mirror; against its
   plain version in every core (bf16x3, int8c, int4c, int4-rint,
   int4-raw), at levels 0, 1, 4 and 5, every id rule (global, segmented,
   tile-local) and posu setting, over ragged shapes, integer tie data bit
   for bit; its stored cores at query tile 64 on the warpgroup consumer
   (33, 65 and 300 queries, n not a whole number of steps, levels 0-3, a
   segment restarting inside a step); its bf16x3 core on kernel A's ring
   (both forms) against the per-tile staging's stacks bit for bit; then
   its main path, the three experiments of ``polars_matmul_tpu_torch/
   tools`` at their JAX sizes (the canonical floor, 2M x 256 int8 at batch
   256, 2M x 768 int8 / int4 at batch 8 and 256; the floors JSON goes to
   ``build/floors.json``), counted; and each core's time at its
   experiment's shape beside D at levels 0 there, kernel A's (and A minus
   D(0)), its plain version's, the library yardstick's and the bound, with
   its consumer and blocks an SM;
11. corpus mutation, each path with its own phase 5 counts: phase 7's
   10M x 768 int8 corpus built from its first 9,990,000 rows with
   ``capacity=10_000_000``, its last 10,000 rows added back in 10 adds
   of 1,000 from a CUDA tensor (the storage and the prepared form keep
   their addresses), 10,000 rows updated and 100,000 ids deleted, then
   phase 7's four requests held to a float64 oracle over the live stored
   rows with no deleted id returned; kernel A and the requests timed at
   capacity 1.01 n, at capacity=None and on the mutated corpus, in
   turns; phase 4's 2M x 256 f32 corpus grown by one add past capacity,
   then held to the float64 oracle; phase 8's 10M x 768 int8 blob
   mixture built with 64 reserve tiles, 100,000 rows added (placed in
   tile-tail slack, claimed reserve tiles and appended tiles, all
   required), 10,000 updated and 10,000 deleted, probed and exhaustive
   requests held to the float64 oracle over the live visited rows, then
   ``rebuild()`` (drift 0, no dead tile, the same exhaustive ids); each
   mutation call's host time and probed recall@10 before and after;
12. the Arrow path on raw buffers (``interop.buffers``, no pyarrow
   needed), counted like phase 5: a 2,000,000 x 768 f32 values buffer in
   host memory from NumPy seed 42, described as a FixedSizeList (its
   extraction a view) and as a List<f32> with int32 offsets at array
   offset 3, 0.1 % of its rows null (the first not at bit 0 of its
   byte), packed by the native packer (``interop/csrc/pmm_native.cpp``,
   built with g++, required); ``Corpus.from_arrow`` of the first (f32;
   256 queries at k=10 and 100 through ``topk_buffers``, the result
   buffers' layout checked, held to the float64 oracle) and of the second
   (int8; batch 8 k=10 held to the oracle over the stored codes, null
   rows stored as zeros and scored 0), ``ClusteredCorpus.from_arrow`` of
   the first (batch 8 k=10 probe 0.05 over the visited rows);
   ``matmul_buffers`` at 1000 x 10,000 x 256 from columns and a handle
   against a float64 product; host times of the extraction, upload,
   prep, requests (``topk_buffers`` beside ``Corpus.topk``) and assembly;
   where pyarrow imports, ``topk_arrow`` and ``Corpus.from_arrow`` on
   ``pa`` arrays equal to the buffer path;
13. sharded search (``parallel``), every leg counted like phase 5, on
   meshes that name the one card several times: phase 7's 10M x 768 int8
   codes (quantized chunk by chunk as phase 7 draws them) on 4 shards,
   batch 8 and 256 at k=10 and 100 through both merges (allgather and
   ring), each held to the unsharded handle on the same codes and, at
   batch 8, to the float64 oracle; the merges' own times; the same codes
   with ``capacity=`` on both handles, 1,000 rows added, 10,000 updated,
   100,000 deleted, compared again; phase 4's 2M x 256 corpus on a 2 x 2
   mesh at batch 256 k=10 in bf16x3 and highest, ``distributed_matmul``
   at 1000 x 10,000 x 256 against float64; phase 8's 2M x 256 f32 blob
   mixture as a ``ClusteredCorpus`` on 4 shards (exhaustive requests equal
   the dense scan, probe 0.05 recall reported); a one-rank NCCL process
   group carrying the canonical request through both merges;
14. the example scripts (``polars_matmul_tpu_torch/examples``), each
   ``main`` in this process at its default size, the JAX scripts' TPU
   sizes (``EXAMPLES``): quickstart; serving at 200,000 x 256;
   benchmark_topk's ten sweeps around 1000 x 10,000 x 256;
   benchmark_matmul at 1000 x 10,000 x 256, f32 and f64; benchmark_bigcorpus
   at 2,000,000 x 256 in four tiers with the carry gate on and off;
   benchmark_clustered at 2,000,000 x 256 and its drift -> rebuild part;
   benchmark_scaling at 1,250,000 x 768 on 1, 2 and 4 shards of the card;
   every check inside a script fails the run; counted like phase 5
   (kernel A dense, listed, on the warpgroup consumer and gated, kernel B,
   no plain version).

The kernels: kernel A (``csrc/fused_topk.cu``, five cores, dense and
listed, its carry gate a runtime argument), kernel B
(``csrc/topk_merge.cu``), kernel C (``csrc/matmul.cu``, two cores) and
kernel D (``csrc/floor.cu``, five cores; its staging and
products are kernel A's, ``csrc/tile_scores.cuh``).  ``PMM_TPU_CACHE_DIR``
is set to a fresh directory under ``build/`` before anything runs, so no
autotune winner of an earlier run changes what the all-defaults paths
launch.

The line before the last is a JSON object of per-kernel results; the last
is {"ok": true, "device": {...}}.  Any failure exits non-zero with its
traceback and prints no result; so does a machine without a CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

SEED = 42
# The package's zero-norm guard for cosine (ops.metrics.cosine_eps, f32).
ZERO_NORM = 1e-6
N_QUERIES, N_CORPUS, DIM = 1000, 10_000, 256
BIG_ROWS = 2_000_000
# The full-width path: the north-star corpus of BASELINE.json.
WIDE_ROWS, WIDE_DIM = 10_000_000, 768
WIDE_REQUESTS = {"int8": ((8, 10), (8, 100), (256, 10), (256, 100)),
                 "int4": ((8, 100), (256, 100)),
                 "bf16": ((8, 100), (256, 100))}
TIER_CORE = {"bf16": "bf16c", "int8": "int8c", "int4": "int4c"}
# Probed search (phase 8): blob mixtures of CENTRES centres, probe share.
CENTRES, SPREAD, PROBE = 1024, 4.0, 0.05
CLUSTER_REQUESTS = ((8, 10), (8, 100), (256, 10), (256, 100))
# The tiled product (phase 9): ragged shapes (on 132 SMs n 16,895 gives
# bf16x3's mma.sync body at m <= 128 one full wave, the others wgmma), the
# canonical shape of examples/benchmark_matmul.py:45, and a large one (a
# 2.15 GB output).
MM_MS, MM_NS = (1, 37, 300, 1000), (1, 129, 5000, 10_000, 16_895)
MM_DIMS = (1, 56, 256, 300, 768, 4100)
MM_SHAPES = ((N_QUERIES, N_CORPUS, DIM), (8192, 65_536, 768))
# A few queries against a large corpus: bf16x3's mma.sync body (m <= 128)
# and the highest core's 32-row tile.
MM_FEW = (8, 65_536, 768)
MM_SRC = "polars_matmul_tpu/kernels/matmul.py:46"
# Kernel C's bf16x3 core drops lo.lo and the bf16 rounding of each lo:
# at most about 3 * 2^-16 of each term |q_d c_d| (2^-14 bounds it).
SPLIT_RTOL = 2.0 ** -14
# Kernel against plain version: the f32 sums run in another order, and
# their rounding error scales with the terms summed, not with the result.
# So a score may differ by ATOL + RTOL * max(|score|, scale), where scale
# is the row's term scale |q_i| * max_j |c_j| + max_j |bias_j|.
RTOL, ATOL = 1e-5, 2e-6
KERNEL_SRC = "polars_matmul_tpu_torch/kernels/csrc/"
TPU_KERNEL = "polars_matmul_tpu/kernels/fused_topk.py"
# Where each core of kernel A sits in the TPU kernel (_kernel, :1167).
CORE_LINE = {"bf16x3": 1258, "highest": 1294, "bf16c": 1271,
             "int8c": 1283, "int4c": 1285}
# The cores whose corpus streams through kernel A's ring of raw bytes, and
# the ring's edges (m, n, dim): unaligned rows (bf16c at dim 36, int8 at
# 100), a dim below one stage (56) and one not a multiple of it (300),
# int4 over two feature chunks (4200), n not a multiple of 64, and n past
# 1024 for the tallest carry beside the ring.
STORED = ("bf16c", "int8c", "int4c")
RING_EDGES = ((5, 129, 36), (5, 129, 100), (37, 1100, 56), (16, 700, 300),
              (9, 1300, 4200))
# The same at query tile 64 (the warpgroup consumer, four kernel tiles a
# step), at k=1, 100 and 128 (the tallest tile-64 carry): 33, 65 and 300
# queries, n not a whole number of steps (18, 21 and 11 kernel tiles) and
# one that is (1000 rows, 16 tiles), unaligned rows (36, 100), int4 over
# two feature chunks (4200).
RING64_EDGES = ((33, 1100, 36), (65, 1300, 100), (300, 700, 4200),
                (65, 1000, WIDE_DIM))
# The highest core's f32 ring: dims below a 16-byte piece (1, 3), one
# piece (4), not a multiple of 4 (5, 255, 257: the unaligned path), the
# wide 768; n a multiple of no kernel tile; query tiles 16 (m 9, or
# k=512), 32 (m 20) and 64 (m 33, 65, 300).
HIGHEST_EDGES = ((9, 129, 1), (33, 700, 3), (20, 1100, 4), (65, 1300, 5),
                 (9, 700, 255), (300, 1000, 257), (33, 1100, WIDE_DIM))
# The f32 ring's plans phase 1 prints: (query tile, k) of the canonical
# tiers, of batch 8 and of the tallest carries; the bf16x3 ring's too (its
# edges are HIGHEST_EDGES).
HIGHEST_PLANS = ((64, 10), (64, 100), (64, 128), (32, 10), (32, 256),
                 (16, 10), (16, 100), (16, 512), (16, 1024))
BF16X3_PLANS = HIGHEST_PLANS
# Kernel A's selections by the source's Selection value (the warpgroup
# consumer's bool: 0 insert, 1 append).
SELECTIONS = ("insert", "append", "radix", "bucket", "gstack",
              "gstack-big", "stack")
# The TPU kernel's bucket selection, which kernel A's kBucket ports.
BUCKET_SRC = TPU_KERNEL + ":1083"
# The TPU kernel's gstack build (_gstack_update), which kernel A's kGstack
# ports with the detector of _gstack_decode (:752) and _gpop_finish (:922).
GSTACK_SRC = TPU_KERNEL + ":608"
# The TPU kernel's big-k gstack depth (_bigk_depth), which kernel A's
# kGstackBig ports with the same build and finish.
GSTACK_BIG_SRC = TPU_KERNEL + ":539"
# The TPU kernel's per-tile stacks (_select_stack), which kernel A's
# kStack ports.
STACK_SRC = TPU_KERNEL + ":337"
# The one instantiation of kernel A known to spill (4 B stored, 4 B
# loaded; ROADMAP.md): phase 1 fails on a spill in any other.  The carry
# gate's vote moved it here from bf16c listed at query tile 16 (8 B / 32
# B), which no longer spills; the other forms of the vote spilled here
# too, or here and elsewhere.
KNOWN_SPILL = "fused_topk_stored_kernel<32, 1, listed, insert>"
# The producer of the stored cores' ring at query tile 64
# (csrc/ring_wgmma.cuh), in phase 1's lines and the kernels line.
WG_PRODUCER = ("TMA 2-D bulk-tensor loads from one thread, full / empty "
               "mbarriers, stages - 1 positions ahead")
# Kernel D's levels=0 form of the int4 family at query tile 32 keeps eight
# running maxima beside a ring at its 128 registers and spills 4 B (off the
# experiments' path: batches of 17-32); phase 1 fails on a spill in any
# other form that holds its state in registers.
FLOOR_KNOWN_SPILLS = tuple(
    f"floor_stacks_kernel<32, {core}, ring, row maxima in registers>"
    for core in ("int4c", "int4-rint", "int4-raw"))
# The per-tile staging kernels A and D's bf16x3 cores ran before the ring
# (tile_scores.cuh::scores_bf16x3), writing every score: the reference the
# ring's mma.sync consumer must equal bit for bit (phases 2 and 10).
PER_TILE_CU = r"""
#include "tile_scores.cuh"

namespace {
template <int TM>
__global__ void __launch_bounds__(kThreads)
per_tile_kernel(const uint16_t* __restrict__ q,
                const uint16_t* __restrict__ c, const float* __restrict__ cb,
                float* __restrict__ out, int m, int n, int dim, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Qh = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Ql = Qh + TM * kBKP;
  uint16_t* Ch = Ql + TM * kBKP;
  uint16_t* Cl = Ch + kTN * kBKP;
  float* St = reinterpret_cast<float*>(smem + operand_bytes(TM, kBf16x3));
  const int row0 = blockIdx.x * TM, n0 = blockIdx.y * kTN;
  scores_bf16x3<TM>(q, c, cb, nullptr, Qh, Ql, Ch, Cl, St, row0, n0, m, n,
                    dim, vec);
  __syncthreads();
  for (int e = threadIdx.x; e < TM * kTN; e += kThreads) {
    const int r = e / kTN, col = e % kTN;
    if (row0 + r < m && n0 + col < n)
      out[(size_t)(row0 + r) * n + n0 + col] = St[r * (kTN + 1) + col];
  }
}
}  // namespace

extern "C" int per_tile_scores(const void* q, const void* c, const float* cb,
                               float* out, int m, int n, int dim,
                               void* stream) {
  constexpr int TM = 16;
  const bool vec = dim % 8 == 0 && aligned(q, 16) && aligned(c, 16);
  const dim3 grid((m + TM - 1) / TM, (n + kTN - 1) / kTN);
  const size_t bytes =
      operand_bytes(TM, kBf16x3) + TM * (kTN + 1) * sizeof(float);
  per_tile_kernel<TM><<<grid, kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(c), cb,
      out, m, n, dim, vec);
  return (int)cudaGetLastError();
}
"""
# nvcc of PER_TILE_CU, started beside the kernels' build (phase 1).
_per_tile = {}
# Kernel D's ring cores by the CUDA source's Core value (ptxas lines).
FLOOR_CORES = {1: "bf16x3", 3: "int8c", 4: "int4c", 5: "int4-rint",
               6: "int4-raw", 7: "bf16x3w"}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def compare(v, i, v_ref, i_ref, rtol=RTOL, atol=ATOL, scale=0.0, what="",
            exact=False):
    """Top-k results agree: the same NaN slots with the same indices, the
    same infinite slots, finite scores within tolerance, and indices equal
    except where the two scores tie within it; with ``exact``, scores and
    indices are bit-identical (NaN slots as NaN).  Returns the largest
    absolute score difference."""
    import torch

    require(v.shape == v_ref.shape, f"{what}: shape {v.shape} != "
            f"{v_ref.shape}")
    nan_a, nan_b = torch.isnan(v), torch.isnan(v_ref)
    require(torch.equal(nan_a, nan_b)
            and torch.equal(i[nan_a], i_ref[nan_b]),
            f"{what}: NaN slots differ")
    if exact:
        require(torch.equal(v[~nan_a], v_ref[~nan_b]),
                f"{what}: scores differ")
        require(torch.equal(i, i_ref), f"{what}: indices differ")
        return 0.0
    inf_a, inf_b = torch.isinf(v), torch.isinf(v_ref)
    require(torch.equal(inf_a, inf_b) and torch.equal(v[inf_a], v_ref[inf_b]),
            f"{what}: infinite slots differ")
    fin = ~inf_a & ~nan_a
    diff = torch.where(fin, (v - v_ref).abs(), torch.zeros_like(v))
    tol = atol + rtol * torch.maximum(
        v_ref.abs(), torch.as_tensor(scale, device=v_ref.device))
    worst = float(diff.max().item()) if diff.numel() else 0.0
    require(bool((diff[fin] <= tol[fin]).all()),
            f"{what}: scores differ by up to {worst}")
    mism = i != i_ref
    require(bool((diff[mism & fin] <= tol[mism & fin]).all())
            and torch.equal(i[mism & inf_a], i_ref[mism & inf_a]),
            f"{what}: index mismatch without a score tie")
    return worst


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def numpy_oracle(q, c, k):
    """bench.py's float64 cosine oracle."""
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cn = c / np.linalg.norm(c, axis=1, keepdims=True)
    s = qn.astype(np.float64) @ cn.astype(np.float64).T
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(s, idx, 1)


def gate(idx, scores, ref_idx, ref_scores, what: str) -> None:
    """bench.py's correctness gate: scores within rtol 1e-4 / atol 1e-5,
    index differences only on tied scores."""
    require(idx.shape == ref_idx.shape, f"{what}: shape {idx.shape}")
    require(bool(np.isfinite(scores).all()), f"{what}: non-finite scores")
    require(np.allclose(scores, ref_scores, rtol=1e-4, atol=1e-5),
            f"{what}: scores off by "
            f"{np.abs(scores - ref_scores).max()}")
    mism = idx.astype(np.int64) != ref_idx
    require(bool(np.all(np.abs(scores[mism] - ref_scores[mism])
                        <= 1e-5 + 1e-4 * np.abs(ref_scores[mism]))),
            f"{what}: index mismatch without a score tie")


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"{torch.cuda.get_device_name(0)}")
    return card


# The stack selection in phase 1: its tail and ring at these (query tile,
# k), its class's and beyond.
STACK_PLAN_CELLS = ((16, 17), (16, 32), (32, 17), (32, 32), (16, 100),
                    (32, 128), (64, 17))


def _stack_plans(F, lib, log):
    """Phase 1's lines of the stack selection: where a dense launch that
    asks for it takes it and its window, the source's rules against the
    host's (``stack_built``, STACK_WINDOW) at every query tile, core and
    k <= 128, its instantiations (no spill: kernel A's check), and its
    tail and ring at STACK_PLAN_CELLS at the canonical width."""
    import ctypes

    out = (ctypes.c_int * 3)()
    got, want = [], []
    for tm in (16, 32, 64):
        for ci, core in enumerate(F.CORES):
            c_ld = F._corpus_width(core, DIM)
            for k in range(1, F.APPEND_MAX_K + 1):
                built = lib.pmm_fused_topk_stack(tm, ci, k, c_ld, out)
                got.append((built, out[0]))
                want.append((int(F.stack_built(tm, core, k)),
                             F.STACK_WINDOW))
    require(got == want, "kernel A's stack route or window: the source's "
            "rule differs from fused_topk.stack_built / STACK_WINDOW")
    stack = [line for line in _ptxas_summary(log)
             if line.startswith(("fused_topk_stored_kernel<",
                                 "fused_topk_f32_kernel<"))
             and ", stack>" in line]
    require(len(stack) > 0, "no stack instantiation of kernel A was built")
    for line in stack:
        print("  stack: " + line)
    for tm, k in STACK_PLAN_CELLS:
        plans = []
        for ci, core in enumerate(F.CORES):
            if lib.pmm_fused_topk_stack(tm, ci, k, F._corpus_width(core, DIM),
                                        out) != 1:
                plans.append(f"{core} not built ({out[1]} B)")
                continue
            plans.append(f"{core} {out[2]} stages, {out[1]} B beside the "
                         f"ring's least plan")
        print(f"  stack: tm={tm} k={k}: tail {F.stack_tail_bytes(tm, k)} B; "
              f"at dim {DIM}: " + "; ".join(plans)
              + f"; route (bf16x3, dense) "
              f"{F.stack_route('auto', k, tm, False, 'bf16x3')}")
    print(f"  stack: {len(stack)} instantiations (k <= {F.APPEND_MAX_K}, "
          f"dense, query tiles 16 / 32, {F.STACK_CORES}; windows of "
          f"{F.STACK_WINDOW} tiles, cells as deep: lossless), "
          f"{sum('spills' in line for line in stack)} spilling; the "
          f"source's route and window equal the host's at tm 16 / 32 / 64, "
          f"every core, k=1...{F.APPEND_MAX_K}; \"auto\" and \"stack\" take "
          f"it at {F.STACK_MIN_K} <= k <= {F.STACK_MAX_K}, where its tail "
          f"leaves two blocks an SM")


# The gstack selection above k = 128 in phase 1: the source's plan
# (pmm_fused_topk_gstack_big) against the host's at these query tiles, k
# and split lengths, and the plans of the cells phase 6 and ab_kernel_a.py
# time (canonical at the gstack's own geometry; 2M x 256 batch 8, lossy).
GSTACK_BIG_PLAN_KS = (129, 130, 192, 200, 256, 300, 512, 640, 1000, 1024)
GSTACK_BIG_PLAN_TPS = (1, 3, 8, 20, 24, 25, 27, 28, 32, 33, 47, 79, 237,
                       1184, 32768, 32769)


def _gstack_big_plans(F, lib, log):
    """Phase 1's lines of the gstack selection above k = 128: the rule's
    agreement, the new instantiations' ptxas lines (no spill: kernel A's
    check), and its plans and not-built cases with their bytes."""
    import ctypes

    import torch

    out = (ctypes.c_int * 2)()
    got, want = [], []
    for tm in (16, 32):
        for core, name in enumerate(F.CORES):
            for k in GSTACK_BIG_PLAN_KS:
                for tps in GSTACK_BIG_PLAN_TPS:
                    built = lib.pmm_fused_topk_gstack_big(tm, core, k, tps,
                                                          out)
                    got.append((built, *out))
                    levels, ok = F.gstack_big_plan(tm, name, k, tps)
                    want.append((int(ok), levels,
                                 F.gstack_big_bytes(tm, name, levels)))
    bad = [(g, w) for g, w in zip(got, want) if g != w]
    require(not bad, f"the gstack plan above k = {F.APPEND_MAX_K}: the "
            f"source's rule differs from fused_topk.gstack_big_plan, e.g. "
            f"{bad[:3]}")
    lines = [line for line in _ptxas_summary(log)
             if line.startswith(("fused_topk_stored_kernel<",
                                 "fused_topk_f32_kernel<"))
             and ", gstack-big>" in line]
    require(len(lines) > 0, "no gstack instantiation above k = 128 was "
            "built")
    for line in lines:
        print("  gstack above 128: " + line)
    sms = F.device_sms(torch.device("cuda"))
    for label, m, n in (("canonical", N_QUERIES, N_CORPUS),
                        (f"{BIG_ROWS}x{DIM} batch 8", 8, BIG_ROWS)):
        for k in (129, 256, 512, 1024):
            plans = []
            for core in F.CORES:
                geo = F.gstack_geometry(m, n, k, core, sms)
                if geo is None:
                    _, splits, tps = F.launch_geometry(
                        m, n, k, sms, 1, F.GSTACK_BIG_TM)
                    levels = F.gstack_big_plan(F.GSTACK_BIG_TM, core, k,
                                               tps)[0]
                    plans.append(
                        f"{core} not built ({levels} levels wanted at {tps} "
                        f"tiles a split: "
                        f"{F.gstack_big_bytes(F.GSTACK_BIG_TM, core, levels)}"
                        f" B beside the ring's least plan; the radix)")
                    continue
                tm, splits, tps = geo
                levels = F.gstack_big_plan(tm, core, k, tps)[0]
                st, stage, res, total = F.gstack_big_ring(
                    tm, core, F._corpus_width(core, DIM), k, tps)
                blocks = min(2, F._SMEM_PER_SM // (total
                                                   + F._SMEM_PER_BLOCK))
                plans.append(
                    f"{core} {splits} splits of {tps} tiles, {levels} levels "
                    f"({'lossless' if levels >= tps else 'lossy'}), "
                    f"{st} stages of {stage} B, {total} B ({blocks} "
                    f"block{'s' if blocks > 1 else ''} an SM)")
            print(f"  gstack above 128: {label} k={k}: " + "; ".join(plans))
    print(f"  gstack above 128: {len(lines)} instantiations (query tile "
          f"{F.GSTACK_BIG_TM}, every core, dense and listed), "
          f"{sum('spills' in line for line in lines)} spilling; the "
          f"source's plan equals the host's at tm 16 / 32, every core, "
          f"k={GSTACK_BIG_PLAN_KS}, tiles a split {GSTACK_BIG_PLAN_TPS}")


def _ptxas_summary(log: str):
    """One line per compiled kernel from nvcc's -Xptxas -v output: its
    template arguments, registers and spilled bytes (kernel C's also its
    static shared memory; its dynamic shared memory is its plan's)."""
    lines, name, spill, kc = [], None, "", False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?floor_stacks_kernel"
                      r"ILi(\d+)ELi(\d+)ELi(\d)ELi(n?\d)E", line)
        if m:   # kernel D: <query tile, core, consumer, stacks>
            stacks = ("row maxima in registers" if m.group(4) == "n1"
                      else "stacks in shared memory" if m.group(4) == "0"
                      else f"{m.group(4)} levels in registers")
            name = (f"floor_stacks_kernel<{m.group(1)}, "
                    f"{FLOOR_CORES.get(int(m.group(2)), m.group(2))}, "
                    f"{('ring', 'wgmma')[int(m.group(3))]}, {stacks}>")
            spill, kc = "", False
            continue
        m = re.search(r"Compiling entry function '\w*?"
                      r"(matmul_f32_kernel|matmul_wgmma_kernel|"
                      r"matmul_mma_kernel|split_pad_kernel)"
                      r"(?:ILb(\d)ELi(\d+)E)?", line)
        if m:   # kernel C (the f32 core: <copies, rows a thread>)
            args = (f"<{('4', '16')[int(m.group(2))]}-byte copies, "
                    f"{16 * int(m.group(3))} rows>"
                    if m.group(2) is not None else "")
            name, spill, kc = m.group(1) + args, "", True
            continue
        m = re.search(r"Compiling entry function '\w*?"
                      r"((?:fused_topk_partial|fused_topk_stored|"
                      r"fused_topk_wgmma|fused_topk_f32|topk_merge_tree|"
                      r"topk_merge_best)_kernel)"
                      r"(?:ILi(\d+)E)?(?:Li(\d+)E)?(?:Lb(\d)E)?"
                      r"(?:L[bi](\d)E)?", line)
        if m:
            args = ", ".join(a for a in m.groups()[1:3] if a is not None)
            if m.group(4) is not None:
                args += ", listed" if m.group(4) == "1" else ", dense"
            if m.group(5) is not None:   # kernel A's selection
                args += ", " + SELECTIONS[int(m.group(5))]
            name, spill = m.group(1) + (f"<{args}>" if args else ""), ""
            kc = False
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and m.group(1) != "0":
            spill = f", spills {m.group(1)} B stored / {m.group(2)} B loaded"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line) if kc else None
            lines.append(f"{name}: {m.group(1)} registers"
                         + (f", {smem.group(1)} B static smem" if smem
                            else "") + spill)
            name = None
    return lines


def _tile64_report(F, log: str) -> None:
    """Phase 1's line for every tile-64 stored instantiation (kernel A's
    warpgroup consumer, kernel D's wgmma forms): its registers and spills,
    its ring's stages at dim 768 (kernel A at k=10 / 100 / 128, kernel D
    at the stack levels of its form) and its producer."""
    from polars_matmul_tpu_torch.kernels import floor as D

    seen = 0
    for line in _ptxas_summary(log):
        a = re.match(r"fused_topk_wgmma_kernel<64, (\d+), ", line)
        d = re.match(r"floor_stacks_kernel<64, (\S+), wgmma, (.*)>", line)
        if a:
            core = F.CORES[int(a.group(1))]
            stages = "/".join(str(F.wg_plan(core, k)[0])
                              for k in (10, 100, 128)) + " at k=10/100/128"
        elif d:
            core = d.group(1)
            levels = ((0,) if d.group(2).startswith("row maxima")
                      else (1,) if d.group(2).startswith("1 levels")
                      else (2, 3))
            stages = "/".join(str(D.floor_plan(64, core, lv, WIDE_DIM)[2])
                              for lv in levels) + " at levels " + "/".join(
                                  map(str, levels))
        else:
            continue
        seen += 1
        print(f"  tile 64: {line}; stages {stages}; producer "
              f"{WG_PRODUCER}")
    require(seen > 0, "no tile-64 stored instantiation in the build log")


def phase_build():
    import ctypes

    from polars_matmul_tpu_torch.kernels import _build
    from polars_matmul_tpu_torch.kernels import fused_topk as F

    t0 = time.perf_counter()
    out = Path(tempfile.mkdtemp(prefix="per-tile-",
                                dir=Path(__file__).resolve().parent
                                / "build"))
    (out / "per_tile.cu").write_text(PER_TILE_CU)
    _per_tile["so"] = out / "per_tile.so"
    _per_tile["proc"] = subprocess.Popen(
        [_build.find_nvcc(), *_build._ARCH, *_build._FLAGS, "-shared",
         "-I", str(_build._CSRC), "-o", str(_per_tile["so"]),
         str(out / "per_tile.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lib = _build.load_library()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s -> {_build.build_info['path']}")
    log = str(_build.build_info["log"])
    for line in _ptxas_summary(log):
        print("  ptxas: " + line)
    # Kernel A: no instantiation spills but the one known (bf16x3 listed
    # at query tile 32), and no wgmma that ptxas had to serialize.
    for line in _ptxas_summary(log):
        require(not re.match(r"fused_topk_(stored|wgmma|f32)_kernel<", line)
                or line.startswith(KNOWN_SPILL) or "spills" not in line,
                f"kernel A spills: {line}")
    for line in log.splitlines():
        if "wgmma" in line and "serialized" in line:
            print("  ptxas: " + line.strip())
    # Kernel D: no spill where its stacks or maxima live in registers
    # (reg_max keeps to the forms ptxas fits) but the known ones, no
    # serialised products.
    for line in _ptxas_summary(log):
        require(not line.startswith("floor_stacks_kernel<")
                or "in registers" not in line or "spills" not in line
                or line.startswith(FLOOR_KNOWN_SPILLS),
                f"kernel D spills: {line}")
    require(not any("serialized" in line and "floor_stacks" in line
                    for line in log.splitlines()),
            "ptxas serialised kernel D's wgmma products")
    # Kernel C: no spill in any of its kernels, no serialised products.
    for line in _ptxas_summary(log):
        require(not re.match(r"(matmul_f32|matmul_wgmma|matmul_mma|split_pad)"
                             r"_kernel", line) or "spills" not in line,
                f"kernel C spills: {line}")
    require(not any("serialized" in line and "matmul_wgmma" in line
                    for line in log.splitlines()),
            "ptxas serialised kernel C's wgmma products")
    # The stored cores' ring at the north-star width: the source's plan
    # must be the host mirror's (tm 64: the warpgroup consumer's ring, at
    # k=10 and 128 too).
    for tm, k in ((16, 100), (32, 100), (64, 10), (64, 100), (64, 128)):
        for core in STORED:
            c_ld = F._corpus_width(core, WIDE_DIM)
            plan = (ctypes.c_int * 4)()
            require(lib.pmm_fused_topk_ring(tm, F.CORES.index(core), c_ld,
                                            k, plan) == 0,
                    f"no ring plan for tm={tm} {core}")
            want = F.stage_plan(tm, core, c_ld, k)
            require(tuple(plan) == (want[0], want[1], int(want[2]), want[3]),
                    f"ring plan tm={tm} {core} k={k}: source {tuple(plan)}, "
                    f"host {want}")
            blocks = [lib.pmm_fused_topk_blocks_per_sm(
                tm, k, F.CORES.index(core), listed, c_ld)
                for listed in (0, 1)]
            row = (F.wg_row_bytes(core) if tm == F.WG_TM
                   else F.ring_row_bytes(tm, core))
            print(f"  ring: tm={tm} {core} at dim {WIDE_DIM}, k={k}"
                  f"{' (wgmma)' if tm == F.WG_TM else ''}: {plan[0]} stages "
                  f"of {plan[1]} B ({row} corpus bytes a row), query "
                  f"{'resident' if plan[2] else 'in the ring'}, {plan[3]} B "
                  f"of shared memory; blocks an SM {blocks[0]} dense, "
                  f"{blocks[1]} listed")
    _tile64_report(F, log)
    # Kernel A's selection by k: the source's rule is the host's mirror.
    ks = range(1, F._MAX_FUSED_K + 1)
    routes = [lib.pmm_fused_topk_route(k) for k in ks]
    require(routes == [SELECTIONS.index(F.selection(k)) for k in ks],
            "kernel A's selection by k: the source's rule differs from "
            "fused_topk.selection")
    radix = [line for line in _ptxas_summary(log)
             if line.startswith(("fused_topk_stored_kernel<",
                                 "fused_topk_f32_kernel<"))
             and ", radix>" in line]
    require(len(radix) > 0, "no radix instantiation of kernel A was built")
    print(f"  selection: insert at k <= {F.INSERT_MAX_K}, append at k <= "
          f"{F.APPEND_MAX_K}, radix above (a buffer of 2k, "
          f"{F.RADIX_BITS}-bit digits; the tile-64 warpgroup consumer "
          f"appends); the source's rule equals the host's at k=1..."
          f"{F._MAX_FUSED_K}; {len(radix)} radix instantiations, "
          f"{sum('spills' in line for line in radix)} spilling")
    # The bucket selection: where a launch that asks for it takes it, the
    # source's rule against the host's, and its instantiations (no spill:
    # kernel A's check above).
    built = [lib.pmm_fused_topk_bucket(tm, core, k)
             for tm in (16, 32, 64) for core in range(len(F.CORES))
             for k in ks]
    require(built == [int(F.bucket_built(tm, core, k))
                      for tm in (16, 32, 64) for core in F.CORES
                      for k in ks],
            "kernel A's bucket route: the source's rule differs from "
            "fused_topk.bucket_built")
    bucket = [line for line in _ptxas_summary(log)
              if line.startswith(("fused_topk_stored_kernel<",
                                  "fused_topk_f32_kernel<"))
              and ", bucket>" in line]
    require(len(bucket) > 0, "no bucket instantiation of kernel A was built")
    for line in bucket:
        print("  bucket: " + line)
    print(f"  bucket: {len(bucket)} instantiations (k <= {F.INSERT_MAX_K}, "
          f"the mma.sync ring at query tiles 16 and {F.BUCKET_MAX_TM}, the "
          f"f32 walk at 16, dense and listed; overflow "
          f"{F.bucket_overflow(16)} / {F.bucket_overflow(32)} entries a row "
          f"at tm 16 / 32), {sum('spills' in line for line in bucket)} "
          f"spilling; the source's route equals the host's at tm 16 / 32 / "
          f"64, every core, k=1...{F._MAX_FUSED_K}")
    # The gstack selection: where a launch that asks for it takes it and
    # its depth, the source's rules against the host's, and its
    # instantiations (no spill: kernel A's check above).
    ks128 = range(1, F.APPEND_MAX_K + 1)
    built = [lib.pmm_fused_topk_gstack(tm, core, k)
             for tm in (16, 32, 64) for core in range(len(F.CORES))
             for k in ks128]
    require(built == [int(F.gstack_built(tm, core, k))
                      for tm in (16, 32, 64) for core in F.CORES
                      for k in ks128],
            "kernel A's gstack route: the source's rule differs from "
            "fused_topk.gstack_built")
    levels = [lib.pmm_fused_topk_levels(k, tm) for tm in (16, 32, 64)
              for k in ks128]
    require(levels == [F.gstack_levels(k, tm) for tm in (16, 32, 64)
                       for k in ks128],
            "kernel A's gstack depth: the source's rule differs from "
            "fused_topk.gstack_levels")
    gstack = [line for line in _ptxas_summary(log)
              if line.startswith(("fused_topk_stored_kernel<",
                                  "fused_topk_f32_kernel<"))
              and ", gstack>" in line]
    require(len(gstack) > 0, "no gstack instantiation of kernel A was built")
    for line in gstack:
        print("  gstack: " + line)
    for tm, k in ((16, 10), (32, 10), (64, 10), (16, 16), (64, 16),
                  (16, 100), (32, 100)):
        plans = []
        for core in F.CORES:
            if not F.gstack_built(tm, core, k):
                plans.append(f"{core} not built")
                continue
            st, stage, res, nbytes = F.gstack_plan(
                tm, core, F._corpus_width(core, WIDE_DIM), k)
            plans.append(f"{core} {st} stages of {stage} B, {nbytes} B "
                         f"({F._SMEM_PER_SM // (nbytes + F._SMEM_PER_BLOCK)}"
                         f" blocks an SM by shared memory)")
        print(f"  gstack: tm={tm} k={k}: {F.gstack_levels(k, tm)} levels "
              f"(fire bound {F.gstack_fire_bound(k, tm, F.gstack_levels(k, tm)):.4f}"
              f" a block), stacks {F.gstack_tail_bytes(tm, F.gstack_levels(k, tm))}"
              f" B; at dim {WIDE_DIM}: " + "; ".join(plans))
    print(f"  gstack: {len(gstack)} instantiations (k <= {F.APPEND_MAX_K}, "
          f"the mma.sync ring at query tiles 16 / 32 / 64 (bf16x3), the f32 "
          f"walk, dense and listed; {F.GSTACK_CELLS} cells a row, stacks in "
          f"shared memory), {sum('spills' in line for line in gstack)} "
          f"spilling; the source's route and depth equal the host's at tm "
          f"16 / 32 / 64, every core, k=1...{F.APPEND_MAX_K}")
    _gstack_big_plans(F, lib, log)
    _stack_plans(F, lib, log)
    # The bf16x3 ring at the canonical and the wide dims (c_ld 2 dim).
    core = F.CORES.index("bf16x3")
    for dim in (DIM, WIDE_DIM):
        for tm, k in BF16X3_PLANS:
            plan = (ctypes.c_int * 4)()
            require(lib.pmm_fused_topk_ring(tm, core, 2 * dim, k, plan) == 0,
                    f"no bf16x3 ring plan for tm={tm} k={k} dim={dim}")
            want = F.stage_plan(tm, "bf16x3", 2 * dim, k)
            require(tuple(plan) == (want[0], want[1], int(want[2]), want[3]),
                    f"bf16x3 ring plan tm={tm} k={k} dim={dim}: source "
                    f"{tuple(plan)}, host {want}")
            blocks = [lib.pmm_fused_topk_blocks_per_sm(tm, k, core, listed,
                                                       2 * dim)
                      for listed in (0, 1)]
            require(min(blocks) >= 1, f"bf16x3 tm={tm} k={k} dim={dim}: "
                    f"blocks an SM {blocks}")
            row = F.ring_row_bytes(tm, F.ring_core(tm, "bf16x3", 2 * dim,
                                                   k))
            print(f"  ring: tm={tm} bf16x3 at dim {dim}, k={k}: {plan[0]} "
                  f"stages of {plan[1]} B ({row} corpus bytes a row, "
                  f"{row // 4} features), query "
                  f"{'resident' if plan[2] else 'in the ring'}, {plan[3]} B "
                  f"of shared memory; blocks an SM {blocks[0]} dense, "
                  f"{blocks[1]} listed")
    # The highest core's f32 ring at the canonical and the wide dims, at
    # the query tiles and k its main path takes.
    core = F.CORES.index("highest")
    for dim in (DIM, WIDE_DIM):
        for tm, k in HIGHEST_PLANS:
            plan = (ctypes.c_int * 4)()
            require(lib.pmm_fused_topk_ring(tm, core, dim, k, plan) == 0,
                    f"no f32 ring plan for tm={tm} k={k} dim={dim}")
            want = F.stage_plan(tm, "highest", dim, k)
            require(tuple(plan) == (want[0], want[1], int(want[2]), want[3]),
                    f"f32 ring plan tm={tm} k={k} dim={dim}: source "
                    f"{tuple(plan)}, host {want}")
            blocks = [lib.pmm_fused_topk_blocks_per_sm(tm, k, core, listed,
                                                       dim)
                      for listed in (0, 1)]
            require(min(blocks) >= 1, f"highest tm={tm} k={k} dim={dim}: "
                    f"blocks an SM {blocks}")
            print(f"  ring: tm={tm} highest at dim {dim}, k={k}: {plan[0]} "
                  f"stages of {plan[1]} B ({F.f32_step_rows(tm)} corpus rows "
                  f"x {F.f32_cols(tm)} features), query "
                  f"{'resident' if plan[2] else 'riding the stages'}, "
                  f"{plan[3]} B of shared memory; blocks an SM {blocks[0]} "
                  f"dense, {blocks[1]} listed")


def _case_data(torch, gen, m, n, dim, dup: bool):
    q = torch.randn((m, dim), generator=gen, device="cuda")
    c = torch.randn((n, dim), generator=gen, device="cuda")
    if dup and n > 2:
        c[n // 2:] = c[: n - n // 2].clone()   # every row has a twin
        q[:] = c[0]                             # and ties at the top
    return q, c


def _tie_data(torch, gen, m, n, dim):
    """Integer entries in [-2, 2], every row twinned: dot and euclidean
    scores are exact in f32 in any summation order (and bf16 splits them
    with lo = 0), so the kernels must match their plain versions bit for
    bit, tie order included."""
    c = torch.randint(-2, 3, (n, dim), generator=gen, device="cuda").float()
    c[n // 2:] = c[: n - n // 2].clone()
    q = torch.randint(-2, 3, (m, dim), generator=gen, device="cuda").float()
    return q, c


def _row_norms(F, cp, precision, dim, chunk=1 << 20):
    """|row| of each prepared corpus row (codes unpacked), in row chunks."""
    import torch

    out = []
    for r0 in range(0, cp.shape[0], chunk):
        blk = cp[r0:r0 + chunk]
        if precision == "int4c":
            blk = F.unpack_int4(blk, dim)
        out.append(blk.float().norm(dim=1))
    return torch.cat(out)


def _term_scale(F, qp, cp, cbp, precision):
    """Row term scale |q_i| * max_j |c_j| + max_j |bias_j| (see RTOL),
    with c_j the corpus row the scores see (codes times their scale)."""
    norms = _row_norms(F, cp, precision, F._query_dim(qp, precision))
    bias = cbp
    if precision in F._QUANT:
        norms, bias = norms * cbp[0], cbp[1]
    return (qp.float().norm(dim=1, keepdim=True) * norms.max()
            + bias.abs().max())


def _check_kernels(F, qp, cp, cbp, mask, k, precision, err, what,
                   scale=0.0, exact=False):
    """At the geometry the main path picks for this shape: kernel A
    against its plain version, kernel B against its plain version on A's
    lists (bit-identical), and A + B through ``fused_select`` against the
    plain version of both."""
    import torch

    m, n = qp.shape[0], cp.shape[0]
    tm, splits, tps = F.kernel_geometry(m, n, k, precision, qp.device,
                                        dim=F._query_dim(qp, precision))
    pv, pi = F.fused_topk_partial(qp, cp, cbp, mask, k, precision, splits,
                                  tps, tm)
    rv, ri = F.fused_topk_partial_plain(qp, cp, cbp, mask, k, precision,
                                        splits, tps)
    part_scale = scale[:, :, None] if torch.is_tensor(scale) else scale
    err[precision] = max(err[precision], compare(
        pv, pi, rv, ri, scale=part_scale, exact=exact,
        what="kernel A " + what))
    del rv, ri
    v, i = F.topk_merge(pv, pi, k)
    mv, mi = F.topk_merge_plain(pv, pi, k)
    err["topk_merge"] = max(err["topk_merge"], compare(
        v, i, mv, mi, exact=True, what="kernel B " + what))
    sv, si = F.fused_select(qp, cp, cbp, mask, k, precision)
    require(torch.equal(sv, v) and torch.equal(si, i),
            f"fused_select {what}: differs from kernel A then B")
    fv, fi = F.fused_topk_plain(qp, cp, cbp, mask, k, precision)
    compare(v, i, fv, fi, scale=scale, exact=exact, what="A+B " + what)


def _check_shape(F, torch, gen, q, c, ks, err, label, tie=False,
                 precisions=("bf16x3", "highest")):
    """Every metric (only dot and euclidean on tie data, whose cosine
    scores are not exact), each core of ``precisions``, k in ``ks``, with
    and without a mask.  Returns the number of cases."""
    m, n = q.shape[0], c.shape[0]
    keep = torch.rand((n,), generator=gen, device="cuda") < 0.7
    mask_row = F.pad_mask_row(keep, n)
    metrics = ("dot", "euclidean") if tie else ("cosine", "dot", "euclidean")
    cases = 0
    for metric in metrics:
        for precision in precisions:
            qp = F.prepare_queries(q, metric, precision)
            cp, cbp = F.prepare_corpus(c, metric, precision=precision)
            scale = 0.0 if tie else _term_scale(F, qp, cp, cbp, precision)
            for k in ks:
                for mask in (None, mask_row):
                    what = (f"{label} m={m} n={n} dim={q.shape[1]} k={k} "
                            f"{metric} {precision} "
                            f"mask={mask is not None} tie={tie}")
                    _check_kernels(F, qp, cp, cbp, mask, k, precision, err,
                                   what, scale=scale, exact=tie)
                    cases += 1
            del qp, cp, cbp
    return cases


def _ring_edges(F, torch, gen, err):
    """The ring's cores at its edges, real and integer tie data (bit for
    bit): the stored cores over RING_EDGES at k=1, 100 and 1024 and
    RING64_EDGES at k=1, 100 and 128, the highest and bf16x3 cores over
    HIGHEST_EDGES at k=1, 10, 100 and 512; at the main path's geometry, in
    splits of one tile, and walking a list of every other layout tile
    whose last id lies past the corpus.  Returns the cases."""
    cases = 0
    edges = ([(e, (1, 100, 1024), STORED) for e in RING_EDGES]
             + [(e, (1, 100, 128), STORED) for e in RING64_EDGES]
             + [(e, (1, 10, 100, 512), ("highest", "bf16x3"))
                for e in HIGHEST_EDGES])
    for (m, n, dim), ks, precisions in edges:
        for tie in (False, True):
            q, c = (_tie_data(torch, gen, m, n, dim) if tie else
                    _case_data(torch, gen, m, n, dim, False))
            metric = "dot" if tie else "cosine"
            n_tiles, tn = -(-n // F._TN), 128
            layout = -(-n // tn)
            tiles = torch.tensor([list(range(0, layout, 2)) + [layout + 1]],
                                 dtype=torch.int32, device="cuda")
            for precision in precisions:
                qp = F.prepare_queries(q, metric, precision)
                cp, cbp = F.prepare_corpus(c, metric, precision=precision)
                scale = 0.0 if tie else _term_scale(F, qp, cp, cbp,
                                                    precision)
                part_scale = scale if tie else scale[:, :, None]
                for k in sorted({min(k, n) for k in ks}):
                    what = (f"ring edge m={m} n={n} dim={dim} k={k} "
                            f"{precision} tie={tie}")
                    _check_kernels(F, qp, cp, cbp, None, k, precision, err,
                                   what, scale=scale, exact=tie)
                    tm = F.query_tile_rows(m, k)
                    pv, pi = F.fused_topk_partial(qp, cp, cbp, None, k,
                                                  precision, n_tiles, 1, tm)
                    rv, ri = F.fused_topk_partial_plain(
                        qp, cp, cbp, None, k, precision, n_tiles, 1)
                    err[precision] = max(err[precision], compare(
                        pv, pi, rv, ri, scale=part_scale, exact=tie,
                        what="one-tile splits, " + what))
                    _check_listed(F, qp, cp, cbp, None, k, precision, tiles,
                                  tn, m, err, "a list past the corpus, "
                                  + what, scale=scale, exact=tie)
                    cases += 3
    torch.cuda.synchronize()
    return cases


# Kernel A's selections above k = 16: the k they are held at (the
# appending selection up to APPEND_MAX_K, the radix selection above), and
# masks of (valid rows a tile) over a split's first tiles that put exactly
# a row's slack or radix buffer entries, or one more, in it before the next
# tile (the empty carry and the -inf threshold take every valid score):
# the slack at k=17 (17 entries) and 100 (64), the radix buffer (2k) at
# k=129 and 512 (the 192-entry cases at k=512 were the slack's edges
# while k=512 appended).
SELECT_KS = (17, 32, 33, 100, 128, 129, 256, 512, 1024)
SLACK_EDGES = ((100, (64, 36)), (100, (64, 37)), (512, (64, 64, 64)),
               (512, (64, 64, 63, 1)), (512, (64, 64, 63, 2)),
               (17, (17, 1)), (17, (18,)),
               (129, (64, 64, 64, 64, 2)), (129, (64, 64, 64, 64, 3)),
               (512, (64,) * 16), (512, (64,) * 15 + (63, 2)))


def _selection_edges(F, torch, gen, err):
    """Kernel A's appending and radix selections against their plain
    versions, bit for bit on integer tie data: every k of SELECT_KS in the
    bf16x3, highest and int8c cores (int8c at 65 queries: the warpgroup
    consumer's 4-tile steps), at the main path's geometry, in splits of one
    and two tiles (shorter than k), half the query rows zero, with a mask
    that drops a third of the rows and every row of whole splits, and
    walking a list; then the edges of SLACK_EDGES, each split filling the
    slack or the radix buffer exactly and one entry past; then the radix
    selection (SELECT_KS above APPEND_MAX_K) in every core at query tiles
    16 and 32 (32 up to k=256, its envelope), dense in splits of 3 and 17
    tiles and listed, masked and not.  Returns the cases."""
    cases = 0
    m_of = {"bf16x3": 37, "highest": 37, "int8c": 65}
    n, dim = 3000, 56
    keep = torch.rand((n,), generator=gen, device="cuda") < 0.66
    keep[n // 3: n // 3 + 640] = False
    masks = (None, F.pad_mask_row(keep, n))
    layout, tn = -(-n // 128), 128
    tiles = torch.tensor([list(range(0, layout, 2))], dtype=torch.int32,
                         device="cuda")
    for precision, m in m_of.items():
        q, c = _tie_data(torch, gen, m, n, dim)
        q[::2] = 0.0
        qp = F.prepare_queries(q, "dot", precision)
        cp, cbp = F.prepare_corpus(c, "dot", precision=precision)
        for k in SELECT_KS:
            tm = F.query_tile_rows(m, k)
            for mask in masks:
                what = (f"selection m={m} n={n} k={k} {precision} "
                        f"mask={mask is not None}")
                _check_kernels(F, qp, cp, cbp, mask, k, precision, err, what,
                               exact=True)
                for tps in (1, 2):
                    splits = -(-n // (tps * F._TN))
                    pv, pi = F.fused_topk_partial(qp, cp, cbp, mask, k,
                                                  precision, splits, tps, tm)
                    compare(pv, pi, *F.fused_topk_partial_plain(
                        qp, cp, cbp, mask, k, precision, splits, tps),
                        exact=True, what=f"splits of {tps} tiles, " + what)
                _check_listed(F, qp, cp, cbp, mask, k, precision, tiles, tn,
                              m, err, "listed " + what, exact=True)
                cases += 4
        for k, counts in SLACK_EDGES:
            tps = len(counts) + 2
            rows = tps * F._TN
            valid = torch.ones(rows, dtype=torch.bool, device="cuda")
            for t, cnt in enumerate(counts):
                valid[t * F._TN + cnt:(t + 1) * F._TN] = False
            mask = F.pad_mask_row(valid.repeat(-(-n // rows))[:n], n)
            splits = -(-n // rows)
            pv, pi = F.fused_topk_partial(qp, cp, cbp, mask, k, precision,
                                          splits, tps,
                                          F.query_tile_rows(m, k))
            compare(pv, pi, *F.fused_topk_partial_plain(
                qp, cp, cbp, mask, k, precision, splits, tps), exact=True,
                what=f"slack edge k={k} tiles {counts} {precision}")
            cases += 1
    cases += _radix_tiles(F, torch, gen, n, dim, masks, tiles, tn)
    torch.cuda.synchronize()
    return cases


def _radix_tiles(F, torch, gen, n, dim, masks, tiles, tn):
    """The radix selection bit for bit on tie data (see
    ``_selection_edges``), every core, query tiles 16 and 32."""
    m, cases = 37, 0
    q, c = _tie_data(torch, gen, m, n, dim)
    q[::2] = 0.0
    n_tiles = -(-n // F._TN)
    for precision in F.CORES:
        qp = F.prepare_queries(q, "dot", precision)
        cp, cbp = F.prepare_corpus(c, "dot", precision=precision)
        for k in SELECT_KS:
            if F.selection(k) != "radix":
                continue
            for tm in (16, 32) if k <= 256 else (16,):
                for mask in masks:
                    what = (f"radix selection m={m} n={n} k={k} tm={tm} "
                            f"{precision} mask={mask is not None}")
                    for tps in (3, 17):
                        splits = -(-n_tiles // tps)
                        args = (qp, cp, cbp, mask, k, precision, splits, tps)
                        compare(*F.fused_topk_partial(*args, tm),
                                *F.fused_topk_partial_plain(*args),
                                exact=True, what=f"splits of {tps} tiles, "
                                + what)
                    args = (qp, cp, cbp, mask, k, precision, 2, -(-(
                        tiles.shape[1] * tn // F._TN) // 2))
                    compare(*F.fused_topk_partial(*args, tm, tiles, tn, m),
                            *F.fused_topk_partial_plain(*args, tiles, tn, m),
                            exact=True, what="listed " + what)
                    cases += 3
        del qp, cp, cbp
    return cases


# Non-finite data through kernels A and B (phase 2): query rows (query
# tiles 16, 32 and 64 at k <= 128; 16 and 32 at k=256; 16 at k=512) and k
# (inserting at 1 and 10, appending at 100, radix at 256 and 512).
NONFINITE_MS = (9, 20, 65)
NONFINITE_KS = (1, 10, 100, 256, 512)


def _poison(torch, q, c):
    """Bad corpus rows (a NaN, a +inf or a -inf entry; a row of each
    whole) and bad queries (rows 1, 3, 5 of at most m: NaN, +inf, -inf),
    written in place.  Returns the bad corpus rows."""
    n, dim = c.shape
    bad = list(range(3, n, 41))
    for j, r in enumerate(bad):
        c[r, (5 * r) % dim] = (np.nan, np.inf, -np.inf)[j % 3]
    c[n // 2] = np.nan
    c[n // 2 + 1] = np.inf
    c[n // 2 + 2] = -np.inf
    for j, r in enumerate(range(1, min(q.shape[0], 6), 2)):
        q[r, (3 * r) % dim] = (np.nan, np.inf, -np.inf)[j]
    return torch.tensor(bad + [n // 2, n // 2 + 1, n // 2 + 2],
                        device=c.device)


def _no_bad(torch, v, i, bad, what):
    """No NaN selected and no bad row in a kernel's result; every -inf
    slot the sentinel."""
    require(not bool(torch.isnan(v).any()), f"{what}: a NaN was selected")
    require(not bool(torch.isin(i, bad.to(i.dtype)).any()),
            f"{what}: a bad row was selected")
    require(torch.equal(v == float("-inf"), i == 2 ** 31 - 1),
            f"{what}: -inf slots and sentinel indices differ")


def _nonfinite_edges(F, torch, gen, err):
    """Kernels A and B against their plain versions on bad rows and bad
    queries: every core, NONFINITE_MS x NONFINITE_KS, every metric (dot
    and euclidean on integer data, bit for bit; cosine on normal data,
    whose scores lie within 1), with and without a mask that also drops
    some bad rows, dense and walking a list of every other layout tile.
    Returns the cases."""
    n, dim, tn = 3000, 56, 128
    layout = -(-n // tn)
    tiles = torch.tensor([list(range(0, layout, 2))], dtype=torch.int32,
                         device="cuda")
    cases = 0
    for m in NONFINITE_MS:
        data = {}
        for tie in (True, False):
            q, c = (_tie_data(torch, gen, m, n, dim) if tie
                    else _case_data(torch, gen, m, n, dim, False))
            bad = _poison(torch, q, c)
            data[tie] = (q, c, bad)
        keep = torch.rand((n,), generator=gen, device="cuda") < 0.66
        keep[data[True][2][::2]] = False
        masks = (None, F.pad_mask_row(keep, n))
        for metric in ("cosine", "dot", "euclidean"):
            tie = metric != "cosine"
            q, c, bad = data[tie]
            for precision in F.CORES:
                qp = F.prepare_queries(q, metric, precision)
                cp, cbp = F.prepare_corpus(c, metric, precision=precision)
                scale = 0.0 if tie else 1.0
                for k in NONFINITE_KS:
                    for mask in masks:
                        what = (f"non-finite m={m} n={n} k={k} {metric} "
                                f"{precision} mask={mask is not None}")
                        _check_kernels(F, qp, cp, cbp, mask, k, precision,
                                       err, what, scale=scale, exact=tie)
                        sv, si = _check_listed(
                            F, qp, cp, cbp, mask, k, precision, tiles, tn, m,
                            err, "listed " + what, scale=scale, exact=tie)
                        _no_bad(torch, sv, si, bad, "listed " + what)
                        _no_bad(torch, *F.fused_select(
                            qp, cp, cbp, mask, k, precision), bad, what)
                        cases += 2
                del qp, cp, cbp
    torch.cuda.synchronize()
    return cases


def _kernel_launches(F):
    """(kernel A, kernel B) launches so far."""
    return np.array([F.launches["fused_topk_partial"]
                     + F.launches["fused_topk_partial_tiles"],
                     F.launches["topk_merge"]])


def _plain_launches(F):
    return sum(F.launches[key] for key in (
        "fused_topk_plain", "fused_topk_partial_plain", "topk_merge_plain"))


def _nonfinite_public(torch):
    """The public paths on the card against the CPU on the same bad
    inputs: ``topk`` (bf16x3 and highest) and ``Corpus.topk`` (bf16, int8,
    int4), k=10 and 100, every metric; indices equal (cosine: up to
    scores tied within tolerance), each bad query (NaN, INT32_MAX), no bad
    row returned, and no plain version run on the card.  Then a
    ``ClusteredCorpus`` (f32 and int8) on the card, exhaustive and probed:
    the same rule, its bad rows in cluster 0.  Returns the requests held
    to the CPU."""
    import polars_matmul_tpu_torch as pmt
    from polars_matmul_tpu_torch.kernels import fused_topk as F

    rng = np.random.default_rng(SEED)
    m, n, dim = 37, 5000, 56
    q_int = rng.integers(-2, 3, (m, dim)).astype(np.float32)
    c_int = rng.integers(-2, 3, (n, dim)).astype(np.float32)
    q_real = rng.standard_normal((m, dim)).astype(np.float32)
    c_real = rng.standard_normal((n, dim)).astype(np.float32)
    bads = [_poison(torch, torch.from_numpy(qq), torch.from_numpy(cc))
            .numpy() for qq, cc in ((q_int, c_int), (q_real, c_real))]
    bad_q = [1, 3, 5]
    requests = 0

    def held(got, metric, bad, what, want=None):
        gi, gv = got
        require(not np.isin(gi, bad).any(), f"{what}: a bad row returned")
        require((gi[bad_q] == 2 ** 31 - 1).all()
                and np.isnan(gv[bad_q]).all(),
                f"{what}: a bad query's slots are not (NaN, INT32_MAX)")
        if want is None:
            return
        wi, wv = want
        if metric == "cosine":
            compare(torch.from_numpy(gv), torch.from_numpy(gi.astype(
                np.int64)), torch.from_numpy(wv), torch.from_numpy(
                wi.astype(np.int64)), scale=1.0, what=what)
        else:
            require(np.array_equal(gi, wi) and np.allclose(
                gv, wv, rtol=1e-6, atol=1e-6, equal_nan=True),
                f"{what}: the card's result differs from the CPU's")

    for metric in ("cosine", "dot", "euclidean"):
        q, c, bad = ((q_real, c_real, bads[1]) if metric == "cosine"
                     else (q_int, c_int, bads[0]))
        handles = {dev: {tier: pmt.Corpus(c, storage=tier, device=dev)
                         for tier in ("bf16", "int8", "int4")}
                   for dev in ("cuda", "cpu")}
        for k in (10, 100):
            for core in ("bf16x3", "highest"):
                cfg = pmt.SearchConfig(precision=core)
                plain = _plain_launches(F)
                got = pmt.topk(q, c, k, metric, config=cfg, device="cuda")
                require(_plain_launches(F) == plain,
                        "a plain version ran on a card request")
                held(got, metric, bad, f"topk {metric} {core} k={k}",
                     pmt.topk(q, c, k, metric, config=cfg, device="cpu"))
                requests += 1
            for tier in ("bf16", "int8", "int4"):
                plain = _plain_launches(F)
                got = handles["cuda"][tier].topk(q, k, metric)
                require(_plain_launches(F) == plain,
                        "a plain version ran on a card request")
                held(got, metric, bad, f"Corpus {tier} {metric} k={k}",
                     handles["cpu"][tier].topk(q, k, metric))
                requests += 1
        del handles
        for tier in ("f32", "int8"):
            cc = pmt.ClusteredCorpus(c, clusters=8, storage=tier,
                                     device="cuda")
            tiles = cc.layout.row_pos[bad] // cc.layout.tn
            require((cc.layout.tile_cluster[tiles] == 0).all()
                    and bool(torch.isfinite(cc.centroids).all()),
                    f"ClusteredCorpus {tier}: a bad row outside cluster 0")
            for probe in (None, 0.25):
                held(cc.topk(q, 100, metric, probe=probe), metric, bad,
                     f"ClusteredCorpus {tier} {metric} probe={probe}")
    torch.cuda.synchronize()
    return requests


def _tile_lists(torch, scores, k):
    """The best k of every 64-row tile's scores of each row as kernel A's
    carry holds them (value descending, lowest index first on ties, -inf
    slots (-inf, INT32_MAX)): what one-tile splits at k return."""
    m, n = scores.shape
    tiles = -(-n // 64)
    s = torch.nn.functional.pad(scores, (0, tiles * 64 - n),
                                value=float("-inf")).view(m, tiles, 64)
    v, order = torch.sort(s, dim=2, descending=True, stable=True)
    i = order + 64 * torch.arange(tiles, device=s.device)[None, :, None]
    if k > 64:
        v = torch.nn.functional.pad(v, (0, k - 64), value=float("-inf"))
        i = torch.nn.functional.pad(i, (0, k - 64))
    v, i = v[:, :, :k], i[:, :, :k]
    i = torch.where(v == float("-inf"), torch.full_like(i, 2 ** 31 - 1), i)
    return v.contiguous(), i.to(torch.int32)


def _per_tile_lib():
    """The per-tile reference (``PER_TILE_CU``), loaded once its build
    (started in phase 1) is done."""
    import ctypes

    if "lib" not in _per_tile:
        proc = _per_tile["proc"]
        log = proc.communicate()[0]
        require(proc.returncode == 0, f"the per-tile reference did not "
                f"build:\n{log}")
        lib = ctypes.CDLL(str(_per_tile["so"]))
        lib.per_tile_scores.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.per_tile_scores.restype = ctypes.c_int
        _per_tile["lib"] = lib
    return _per_tile["lib"]


def _per_tile_scores(torch, qp, cp, cb):
    """Every bf16x3 score of [hi | lo] operands by the per-tile staging,
    (m, n) f32 (cb the (n,) bias row)."""
    m, n, dim = qp.shape[0], cp.shape[0], qp.shape[1] // 2
    ref = torch.empty((m, n), device="cuda")
    rc = _per_tile_lib().per_tile_scores(
        qp.data_ptr(), cp.data_ptr(), cb.data_ptr(), ref.data_ptr(), m, n,
        dim, torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"per-tile reference launch failed: error {rc}")
    return ref


def _per_tile_bits(F, torch):
    """The bf16x3 ring's mma.sync consumer against the per-tile staging it
    replaced (``PER_TILE_CU``): every score, bit for bit, in one-tile
    splits at each query tile and both ring forms (32 and 64 features a
    position: ``ring_core``'s k), on the canonical cosine operands and on
    the 2M x 256 ones (batch 8, 32 and 64 of phase 4's queries).  Returns
    the cases."""
    rng = np.random.default_rng(SEED)
    q = torch.from_numpy(rng.standard_normal(
        (N_QUERIES, DIM)).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.standard_normal(
        (N_CORPUS, DIM)).astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    big = torch.randn((BIG_ROWS, DIM), generator=gen, device="cuda")
    q8 = torch.randn((8, DIM), generator=gen, device="cuda")
    q256 = torch.randn((256, DIM), generator=gen, device="cuda")
    cases, seen = 0, set()
    # (tm, k): tile 16 at k=64 (64 features a position) and 512 (32), 32
    # at 64, 64 at 32 (64 features) and 128 (32).
    forms = {16: (64, 512), 32: (64,), 64: (32, 128)}
    for qf, cf, label, tms in ((q, c, "canonical", (16, 32, 64)),
                               (q8, big, "2M batch 8", (16,)),
                               (q256[:32], big, "2M batch 32", (32,)),
                               (q256[:64], big, "2M batch 64", (64,))):
        qp = F.prepare_queries(qf, "cosine", "bf16x3")
        cp, cbp = F.prepare_corpus(cf, "cosine", precision="bf16x3")
        n = cp.shape[0]
        ref = _per_tile_scores(torch, qp, cp, cbp)
        tiles = -(-n // 64)
        for tm in tms:
            for k in forms[tm]:
                rv, ri = _tile_lists(torch, ref, k)
                pv, pi = F.fused_topk_partial(qp, cp, cbp, None, k,
                                              "bf16x3", tiles, 1, tm)
                core = F.ring_core(tm, "bf16x3", cp.shape[1], k)
                require(torch.equal(pv, rv) and torch.equal(pi, ri),
                        f"bf16x3 ({core}) {label} at tm {tm}, k={k}: the "
                        f"ring's scores differ from the per-tile staging's")
                cases += 1
                seen.add(core)
                del pv, pi, rv, ri
        del qp, cp, cbp, ref
    del big
    torch.cuda.empty_cache()
    require(seen == {"bf16x3", "bf16x3w"}, f"ring forms checked: {seen}")
    return cases


def _bad_quantizer_rows(torch, c):
    """Rows of ``c`` made bad in place, each beside out-of-range entries:
    one NaN, one +inf, one -inf, a whole NaN row, a whole +inf row.
    Returns their indices."""
    n, dim = c.shape
    rows = torch.arange(5, n, 89, device=c.device)
    for j, r in enumerate(rows.tolist()):
        c[r, (7 * r) % dim] = (np.nan, np.inf, -np.inf)[j % 3]
        c[r, (7 * r + 1) % dim] = 300.0
        c[r, (7 * r + 2) % dim] = -300.0
    c[1] = np.nan
    c[2] = np.inf
    return torch.cat([rows, torch.tensor([1, 2], device=c.device)])


def _check_quantizers(F, torch, gen):
    """The torch quantizers on the card against the host NumPy ones, bit
    for bit, on one ingestion chunk: zero rows, and rows holding NaN,
    +-inf and entries far outside the codes' range (each of those codes 0
    and scale NaN).  Returns the bad rows checked."""
    from polars_matmul_tpu_torch.kernels import storage as S

    checked = 0
    for dim in (WIDE_DIM, 4200):
        c = torch.randn((4096, dim), generator=gen, device="cuda")
        c[::97] = 0.0
        bad = _bad_quantizer_rows(torch, c).cpu().numpy()
        host = c.cpu().numpy()
        codes, scales = F.quantize_int8(c)
        hc, hs = S._quantize_rows_np(host)
        require(np.array_equal(codes.cpu().numpy(), hc)
                and np.array_equal(scales.cpu().numpy().view(np.int32),
                                   hs.view(np.int32)),
                f"int8 quantizer on the card differs from the host at {dim}")
        require((hc[bad] == 0).all() and np.isnan(hs[bad]).all(),
                f"int8 quantizer: a bad row is not codes 0, scale NaN")
        ck, dpp, _ = F.feature_geometry(dim)
        packed, scales = F.quantize_int4(c, ck)
        hp, hs = S._quantize_rows_int4_np(host, ck, dpp)
        require(np.array_equal(packed.cpu().numpy(), hp)
                and np.array_equal(scales.cpu().numpy().view(np.int32),
                                   hs.view(np.int32)),
                f"int4 quantizer on the card differs from the host at {dim}")
        require((hp[bad] == 0).all() and np.isnan(hs[bad]).all(),
                f"int4 quantizer: a bad row is not codes 0, scale NaN")
        checked += 2 * bad.size
    return checked


def _random_lists(torch, gen, n_lists, n_layout, p):
    """(n_lists, p) ascending distinct layout-tile ids, drawn on the card."""
    keys = torch.rand((n_lists, n_layout), generator=gen, device="cuda")
    pick = torch.argsort(keys, dim=1)[:, :p]
    return torch.sort(pick, dim=1).values.to(torch.int32).contiguous()


def _check_listed(F, qp, cp, cbp, mask, k, precision, tiles, tn, block_rows,
                  err, what, scale=0.0, exact=False):
    """Kernel A on tile lists against its plain version, kernel B on its
    lists (bit-identical), and A + B through ``fused_select`` against the
    plain version of both.  Lists of fewer rows than a query tile run
    through ``fused_select`` only (it pads each list's rows to a tile).
    Returns fused_select's result."""
    import torch

    m = qp.shape[0]
    tm = F.listed_tile_rows(m, k, block_rows)
    sv, si = F.fused_select(qp, cp, cbp, mask, k, precision, tiles, tn,
                            block_rows)
    if tiles.shape[0] == 1 or block_rows % tm == 0:
        tm, splits, tps = F.kernel_geometry(
            m, tiles.shape[1] * tn, k, precision, qp.device, tm, listed=True,
            dim=F._query_dim(qp, precision))
        args = (qp, cp, cbp, mask, k, precision)
        pv, pi = F.fused_topk_partial(*args, splits, tps, tm, tiles, tn,
                                      block_rows)
        rv, ri = F.fused_topk_partial_plain(*args, splits, tps, tiles, tn,
                                            block_rows)
        part_scale = scale[:, :, None] if torch.is_tensor(scale) else scale
        err["tiles"] = max(err["tiles"], compare(
            pv, pi, rv, ri, scale=part_scale, exact=exact,
            what="listed kernel A " + what))
        v, i = F.topk_merge(pv, pi, k)
        compare(v, i, *F.topk_merge_plain(pv, pi, k), exact=True,
                what="kernel B on listed " + what)
        require(torch.equal(sv, v) and torch.equal(si, i),
                f"listed fused_select {what}: differs from kernel A then B")
    fv, fi = F.fused_topk_plain(qp, cp, cbp, mask, k, precision, tiles, tn,
                                block_rows)
    err["tiles"] = max(err["tiles"], compare(
        sv, si, fv, fi, scale=scale, exact=exact, what="listed A+B " + what))
    return sv, si


# Kernel B's sweep (phase 2): every (m, splits, k) of these with m * splits
# * k <= MERGE_SWEEP_CAP.
MERGE_SWEEP_SPLITS = (1, 2, 3, 31, 32, 33, 258, 264, 1023, 1024)
MERGE_SWEEP_KS = (1, 2, 10, 16, 100, 128, 512, 1024)
MERGE_SWEEP_MS = (1, 8, 37, 1000)
MERGE_SWEEP_CAP = 1 << 26
# Kernel B's timed shapes (phase 6), (m, splits, k, where the shape comes
# from): the lists kernel A leaves for kernel B on the main path's requests
# (launch_geometry on 132 SMs).
MERGE_SHAPES = (
    (1000, 16, 10, "canonical k=10, bf16x3 and highest"),
    (1000, 16, 100, "canonical k=100"),
    (1000, 5, 512, "canonical k=512"),
    (8, 1024, 100, "2M x 256 f32, batch 8, k=100"),
    (8, 264, 100, "10M x 768 int8, batch 8, k=100"),
    (8, 258, 100, "probed 10M int8, probe 0.05, batch 8, k=100"),
    (256, 33, 100, "10M x 768 int8, batch 256, k=100"),
)
# How sorted_lists fills the lists.
MERGE_MODES = ("random", "ties", "padded", "empty", "real_inf")


def sorted_lists(torch, gen, m, splits, k, mode, device="cuda"):
    """(m, splits, k) f32 values and int32 indices shaped as kernel A
    leaves them: list s of a row holds k distinct indices of [2 k s, 2 k (s
    + 1)), ordered by value descending, then index ascending, so the
    splits cover ascending index ranges.  ``mode``:

    - "random": normal values;
    - "ties": integer values in [0, 4), ties within and across lists;
    - "padded": ties, each list finite up to a random length and (-inf,
      INT32_MAX) after it;
    - "empty": padded, with every third list and every fourth row (a
      masked row) wholly -inf;
    - "real_inf": padded, the -inf tails keeping real indices.
    """
    if mode not in MERGE_MODES:
        raise ValueError(f"mode must be one of {MERGE_MODES}, not {mode!r}")
    shape = (m, splits, k)
    pos = torch.arange(k, device=device)
    base = 2 * k * torch.arange(splits, device=device)
    idx = (base[None, :, None] + 2 * pos + torch.randint(
        0, 2, shape, generator=gen, device=device))
    if mode == "random":
        v = torch.randn(shape, generator=gen, device=device)
    else:
        v = torch.randint(0, 4, shape, generator=gen,
                          device=device).to(torch.float32)
    v, order = torch.sort(v, dim=2, descending=True, stable=True)
    idx = torch.gather(idx, 2, order)
    if mode in ("padded", "empty", "real_inf"):
        fill = torch.randint(0, k + 1, (m, splits, 1), generator=gen,
                             device=device)
        if mode == "empty":
            fill[:, ::3] = 0
            fill[::4] = 0
        tail = pos >= fill
        v = v.masked_fill(tail, float("-inf"))
        if mode != "real_inf":
            idx = idx.masked_fill(tail, np.iinfo(np.int32).max)
    return v.contiguous(), idx.to(torch.int32).contiguous()


def shuffled_lists(torch, gen, m, splits, k, device="cuda"):
    """``sorted_lists`` on tie data, each list still ordered by (value
    desc, index asc) but the lists of each row in a random order, so their
    index ranges no longer ascend from list to list: the lists the ring
    merge of sharded search hands kernel B."""
    v, i = sorted_lists(torch, gen, m, splits, k, "padded", device)
    order = torch.argsort(torch.rand((m, splits), generator=gen,
                                     device=device), dim=1)
    order = order[:, :, None].expand(m, splits, k)
    return (torch.gather(v, 1, order).contiguous(),
            torch.gather(i, 1, order).contiguous())


# Out-of-order lists of the sweep: (m, splits, k).
MERGE_SHUFFLED = ((1, 2, 10), (8, 4, 10), (8, 4, 100), (37, 33, 16),
                  (256, 2, 100), (1000, 8, 128))


def _merge_sweep(F, torch, gen):
    """Kernel B against its plain version, bit for bit, on sorted lists
    with ascending split ranges (``sorted_lists``): at every shape of the
    sweep on integer tie data, and on one of random values, padded lists,
    wholly -inf lists and rows, and -inf entries with real indices, in
    turn; on lists out of index order (``shuffled_lists``); then lists
    past the kernel's limits, which it must refuse.  Returns (cases,
    grouped cases, cases of several rows a block)."""
    sms = F.device_sms(torch.device("cuda"))
    others = [mode for mode in MERGE_MODES if mode != "ties"]
    cases = grouped = shared = 0
    for m in MERGE_SWEEP_MS:
        for splits in MERGE_SWEEP_SPLITS:
            for k in MERGE_SWEEP_KS:
                if m * splits * k > MERGE_SWEEP_CAP:
                    continue
                for mode in ("ties", others[cases % len(others)]):
                    pv, pi = sorted_lists(torch, gen, m, splits, k, mode)
                    compare(*F.topk_merge(pv, pi, k),
                            *F.topk_merge_plain(pv, pi, k), exact=True,
                            what=f"kernel B sweep m={m} splits={splits} "
                            f"k={k} {mode}")
                    cases += 1
                    groups, rows = F.merge_plan(m, splits, k, sms)
                    grouped += groups > 1
                    shared += rows > 1
                del pv, pi
    for m, splits, k in MERGE_SHUFFLED:
        pv, pi = shuffled_lists(torch, gen, m, splits, k)
        compare(*F.topk_merge(pv, pi, k), *F.topk_merge_plain(pv, pi, k),
                exact=True, what=f"kernel B out-of-order lists m={m} "
                f"splits={splits} k={k}")
        cases += 1
    for splits, k in ((2, 4097), (F._MAX_SPLITS + 1, 10)):
        pv = torch.zeros((1, splits, k), device="cuda")
        pi = torch.zeros((1, splits, k), dtype=torch.int32, device="cuda")
        try:
            F.topk_merge(pv, pi, k)
        except RuntimeError as e:
            require("error -1" in str(e), f"kernel B at {splits} lists of "
                    f"{k}: {e}")
        else:
            raise AssertionError(f"kernel B took {splits} lists of {k}")
    torch.cuda.synchronize()
    return cases, grouped, shared


# (m, n, dim, layout tile rows, query rows per list): one list, several,
# and lists shorter than a query tile (block_q=8, which fused_select pads).
LISTED_SHAPES = ((1, 129, 56, 128, 8), (37, 5000, 56, 128, 16),
                 (37, 5000, 300, 256, 8), (300, 5000, 768, 128, 128),
                 (300, 5000, 256, 256, 256))


def _compare_listed(F, torch, gen, err):
    """Phase 2 on tile lists: every core and metric over LISTED_SHAPES with
    random per-list tile lists (one tile, a third of them, all of them in
    a random subset), integer tie data bit-exact, and a list of every tile
    against the dense scan bit for bit (within tolerance where a stored
    core's list and dense walks take different consumers).  Returns the
    case counts."""
    cases = ties = full = near = 0
    for m, n, dim, tn, br in LISTED_SHAPES:
        n_layout = -(-n // tn)
        n_lists = -(-m // br)
        for tie in (False, True):
            q, c = (_tie_data(torch, gen, m, n, dim) if tie else
                    _case_data(torch, gen, m, n, dim, False))
            keep = torch.rand((n,), generator=gen, device="cuda") < 0.7
            metrics = ("dot", "euclidean") if tie else ("cosine", "dot",
                                                        "euclidean")
            for metric in metrics:
                for precision in F.CORES:
                    qp = F.prepare_queries(q, metric, precision)
                    cp, cbp = F.prepare_corpus(c, metric,
                                               precision=precision)
                    scale = (0.0 if tie else
                             _term_scale(F, qp, cp, cbp, precision))
                    for k in sorted({min(k, n) for k in (1, 10, 100)}):
                        mask = (F.pad_mask_row(keep, n)
                                if (cases + ties) % 2 else None)
                        p = (1, max(1, n_layout // 3), n_layout)[
                            (cases + ties) % 3]
                        tiles = _random_lists(torch, gen, n_lists, n_layout,
                                              p)
                        what = (f"m={m} n={n} dim={dim} tn={tn} lists of "
                                f"{br} rows P={p} k={k} {metric} "
                                f"{precision} mask={mask is not None} "
                                f"tie={tie}")
                        _check_listed(F, qp, cp, cbp, mask, k, precision,
                                      tiles, tn, br, err, what, scale=scale,
                                      exact=tie)
                        if tie:
                            ties += 1
                            continue
                        cases += 1
                        every = torch.arange(
                            n_layout, dtype=torch.int32,
                            device="cuda").repeat(n_lists, 1).contiguous()
                        lv, li = F.fused_select(qp, cp, cbp, mask, k,
                                                precision, every, tn, br)
                        dv, di = F.fused_select(qp, cp, cbp, mask, k,
                                                precision)
                        if F.wgmma_core(F.listed_tile_rows(m, k, br),
                                        precision) != F.wgmma_core(
                                            F.query_tile_rows(m, k),
                                            precision):
                            # The warpgroup (tile 64) and mma.sync
                            # consumers sum the products in other orders.
                            compare(lv, li, dv, di, scale=scale,
                                    what=f"every tile listed against the "
                                    f"dense scan, {what}")
                            near += 1
                            continue
                        require(torch.equal(lv, dv) and torch.equal(li, di),
                                f"every tile listed differs from the dense "
                                f"scan: {what}")
                        full += 1
    torch.cuda.synchronize()
    return cases, ties, full, near


def phase_compare(F, ms=(1, 37, 300), ns=(1, 129, 5000),
                  dims=(3, 56, 256, 300, 768), ks=(1, 10, 100, 512, 1024)):
    """Kernels A (every core) and B against their plain versions on CUDA
    tensors: over a ragged grid of shapes, then at the shapes phases 3
    and 4 give them (phase 7 checks its own).  Returns the largest
    absolute score difference of each core of kernel A and of kernel B."""
    import torch

    with GateCheck(F, torch) as gate_check, \
            BucketCheck(F, torch) as bucket_check, \
            GstackCheck(F, torch) as gstack_check:
        err = _compare_all(F, torch, ms, ns, dims, ks)
    require(gate_check.listed > 0 and gate_check.wgmma > 0
            and gate_check.appending > 0 and gate_check.radix > 0,
            "phase 2 ran no listed, warpgroup, appending or radix launch")
    require(bucket_check.cases > 0 and bucket_check.listed > 0,
            "phase 2 checked no dense or no listed bucket launch")
    require(gstack_check.cases > 0 and gstack_check.listed > 0,
            "phase 2 checked no dense or no listed gstack launch")
    print(f"phase 2: kernel A's gstack selection: {gstack_check.cases} "
          f"launches of this phase at k <= {F.APPEND_MAX_K} where it is "
          f"built ran again asking for it and gave the insertion's or the "
          f"slack's split lists bit for bit, the carry gate off and on "
          f"({gstack_check.listed} listed; every core, ragged, tie and "
          f"non-finite data); its counter: {gstack_check.rows} rows and "
          f"{gstack_check.blocks} blocks fired (each walked again)")
    print(f"phase 2: kernel A's bucket selection: {bucket_check.cases} "
          f"launches of this phase at k <= {F.INSERT_MAX_K} where it is "
          f"built ran again asking for it and gave the insertion's split "
          f"lists bit for bit, the carry gate off and on "
          f"({bucket_check.listed} listed; every core, ragged, tie and "
          f"non-finite data); its counter: {bucket_check.windows} windows "
          f"ended, {bucket_check.overflow} overflow entries")
    print(f"phase 2: kernel A's carry gate: {gate_check.cases} launches of "
          f"this phase ran again with prune on and gave the split lists "
          f"of prune off bit for bit ({gate_check.listed} listed, "
          f"{gate_check.wgmma} on the warpgroup consumer, "
          f"{gate_check.appending} appending, {gate_check.radix} radix; "
          f"every core, dense, ragged, tie data); the gate skipped "
          f"{gate_check.skipped} of {gate_check.gated} tiles")
    return err


def _compare_all(F, torch, ms, ns, dims, ks):
    """Phase 2's checks (see ``phase_compare``)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    err = {name: 0.0 for name in F.CORES + ("topk_merge", "tiles")}
    cases = 0
    shapes = [(m, n, d, False, F.CORES) for m in ms for n in ns for d in dims]
    shapes.append((37, 5000, 56, True, F.CORES))
    # Above dim 4096 the int4 packing is chunk-interleaved.
    shapes.append((37, 5000, 4200, False, ("int4c",)))
    for m, n, dim, dup, precisions in shapes:
        q, c = _case_data(torch, gen, m, n, dim, dup)
        keep = torch.rand((n,), generator=gen, device="cuda") < 0.7
        for metric in ("cosine", "dot", "euclidean"):
            for precision in precisions:
                qp = F.prepare_queries(q, metric, precision)
                cp, cbp = F.prepare_corpus(c, metric, precision=precision)
                scale = _term_scale(F, qp, cp, cbp, precision)
                for k in sorted({min(k, n) for k in ks}):
                    mask = (F.pad_mask_row(keep, n) if cases % 2 else None)
                    what = (f"m={m} n={n} dim={dim} k={k} {metric} "
                            f"{precision} mask={mask is not None} dup={dup}")
                    _check_kernels(F, qp, cp, cbp, mask, k, precision, err,
                                   what, scale=scale)
                    cases += 1
    ties = 0
    for m, n, dim in ((37, 5000, 56), (300, 5000, WIDE_DIM)):
        q, c = _tie_data(torch, gen, m, n, dim)
        ties += _check_shape(F, torch, gen, q, c, (1, 10, 100), err,
                             "ragged", tie=True, precisions=F.CORES)
    edges = _ring_edges(F, torch, gen, err)
    t0 = time.perf_counter()
    selection = _selection_edges(F, torch, gen, err)
    print(f"phase 2: kernel A's appending and radix selections: "
          f"{selection} cases bit-identical to their plain version "
          f"(k={SELECT_KS}, radix above {F.APPEND_MAX_K}; bf16x3, highest, "
          f"int8c at query tile 64 in 4-tile steps; main geometry, splits of "
          f"1 and 2 tiles, zero query rows, masked rows and whole splits, a "
          f"tile list; the slack filled exactly and one past at "
          f"k=17/100/512, the radix buffer at k=129/512; the radix "
          f"selection in every core at query tiles 16 and 32, dense and "
          f"listed); {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gstack, rows, blocks, planted = _gstack_edges(F, torch, gen)
    print(f"phase 2: kernel A's gstack selection: {gstack} cases "
          f"bit-identical to its plain version (k={GSTACK_KS}, every core, "
          f"each query tile where built, dense splits of {GSTACK_TPS} tiles "
          f"and a list, masked and not; tie data with zero query rows, and "
          f"planted collisions), each gated twin equal; the counter equal "
          f"to the plain version of the walk's fires in every case: {rows} "
          f"rows ({planted} of them planted) and {blocks} blocks fired, "
          f"each block walked again; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stack = _stack_edges(F, torch, gen)
    print(f"phase 2: kernel A's stack selection: {stack} cases "
          f"bit-identical to its plain version and to the plain version of "
          f"its walk (k={STACK_KS}, {F.STACK_CORES}, each query tile where "
          f"built, dense splits of {STACK_TPS} tiles, masked and not; tie "
          f"data with zero query rows, and planted data crowding one "
          f"column; windows of {F.STACK_WINDOW} tiles), each gated twin "
          f"equal; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cases, lossless, lossy, rows, planted, skipped = _gstack_bigk_edges(
        F, torch, gen)
    print(f"phase 2: kernel A's gstack selection above k = "
          f"{F.APPEND_MAX_K}: {cases} cases ({lossless} lossless, {lossy} "
          f"lossy) bit-identical to its plain version and to the radix "
          f"selection's lists on the same splits (k={GSTACK_BIG_KS}, every "
          f"core, query tile {F.GSTACK_BIG_TM}, dense splits of "
          f"{GSTACK_BIG_TPS} tiles and two lists, masked and not; tie, "
          f"non-finite and planted data), each gated twin equal; the counter "
          f"equal to the plain version of the walk's fires in every case: "
          f"{rows} rows ({planted} of them planted), none lossless; not "
          f"built (core, k, tiles a split): {skipped}; "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bucket, windows, overflow = _bucket_edges(F, torch, gen)
    require(overflow > 0, "the bucket edges filled no overflow")
    print(f"phase 2: kernel A's bucket selection: {bucket} cases "
          f"bit-identical to its plain version (k={BUCKET_KS}, every core, "
          f"query tiles 16 and 32 where built, dense splits of {BUCKET_TPS} "
          f"tiles and a "
          f"list, masked and not; tie data with zero query rows, and "
          f"class-heavy data: {windows} windows ended, {overflow} overflow "
          f"entries), each gated twin equal; "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    before = _kernel_launches(F)
    nf_cases = _nonfinite_edges(F, torch, gen, err)
    nf_requests = _nonfinite_public(torch)
    launched = _kernel_launches(F) - before
    print(f"phase 2: non-finite values: {nf_cases} cases of kernels A and B "
          f"against their plain versions on corpus rows and queries holding "
          f"NaN and +-inf (every core, m={NONFINITE_MS}: query tiles 16, "
          f"32, 64; k={NONFINITE_KS}: inserting, appending and radix; "
          f"dense and "
          f"listed, masked and not, the carry gate on and off; indices "
          f"exact, integer data bit for bit, no bad row and no NaN "
          f"selected), then {nf_requests} public requests (topk in "
          f"bf16x3 and highest, Corpus at bf16 / int8 / int4, k=10 and 100, "
          f"every metric) equal to the CPU's on the same bad inputs, and "
          f"ClusteredCorpus requests holding the rule; {launched[0]} "
          f"launches of kernel A (the gate's reruns included), "
          f"{launched[1]} of kernel B, no plain version on a card request; "
          f"{time.perf_counter() - t0:.1f} s")
    bad_rows = _check_quantizers(F, torch, gen)
    t0 = time.perf_counter()
    merges, grouped, shared = _merge_sweep(F, torch, gen)
    print(f"phase 2: kernel B sweep: {merges} cases bit-identical to its "
          f"plain version ({grouped} with several blocks a row, {shared} "
          f"with several rows a block; k > 4096 and more than 1024 lists "
          f"refused), splits "
          f"{MERGE_SWEEP_SPLITS} x k {MERGE_SWEEP_KS} x m {MERGE_SWEEP_MS} "
          f"up to {MERGE_SWEEP_CAP} entries; tie data, random values, "
          f"padded and wholly -inf lists, -inf with real indices; "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"phase 2: {edges} cases at the ring's edges match (the stored "
          f"cores dense, in splits of one tile and on a list past the "
          f"corpus; unaligned dims 36 and 100, dims 56, 300 and 4200, n not "
          f"a multiple of 64, k=1/100/1024; at query tile 64, m=33/65/300, "
          f"n not a multiple of 128, k=1/100/128; the highest and bf16x3 "
          f"cores at dims 1, 3, 4, 5, 255, 257 and {WIDE_DIM}, query tiles "
          f"16/32/64, k=1/10/100/512; integer tie data bit-identical)")
    bits = _per_tile_bits(F, torch)
    print(f"phase 2: the bf16x3 ring's mma.sync consumer equals the "
          f"per-tile staging it replaced bit for bit in {bits} cases (every "
          f"score of the canonical operands at query tiles 16, 32 and 64, "
          f"of the {BIG_ROWS}x{DIM} ones at batch 8, 32 and 64; 32 and 64 "
          f"features a position)")
    print(f"phase 2: {cases} ragged cases match (atol {ATOL} + rtol {RTOL} "
          f"x max(|score|, row term scale); kernel B bit-identical), every "
          f"core; {ties} integer tie cases bit-identical; the on-card "
          f"quantizers equal the host ones bit for bit ({bad_rows} bad "
          f"rows among them, each codes 0 and scale NaN)")
    listed, listed_ties, full, near = _compare_listed(F, torch, gen, err)
    print(f"phase 2: listed kernel A (tile lists): {listed} ragged cases "
          f"match their plain version, {listed_ties} integer tie cases "
          f"bit-identical, every core; {full} lists of every tile equal "
          f"the dense result bit for bit, {near} more within tolerance "
          f"(a core whose list and dense walks take different consumers); "
          f"max abs err {err['tiles']:.3g}")

    main = 0
    for tie in (False, True):
        q, c = (_tie_data(torch, gen, N_QUERIES, N_CORPUS, DIM) if tie else
                _case_data(torch, gen, N_QUERIES, N_CORPUS, DIM, False))
        main += _check_shape(F, torch, gen, q, c, (10, 100, 512), err,
                             "canonical", tie=tie)
        q, c = (_tie_data(torch, gen, 256, BIG_ROWS, DIM) if tie else
                _case_data(torch, gen, 256, BIG_ROWS, DIM, False))
        for batch in (8, 256):
            main += _check_shape(F, torch, gen, q[:batch], c, (10, 100), err,
                                 "2M", tie=tie)
        del q, c
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"phase 2: {main} cases at the main path's shapes "
          f"({N_QUERIES}x{N_CORPUS}x{DIM} at k=10/100/512, {BIG_ROWS}x{DIM} "
          f"at batch 8/256 and k=10/100; every metric, precision and mask; "
          f"integer tie data bit-identical) match; max abs err A "
          f"{err['bf16x3']:.3g} (bf16x3), {err['highest']:.3g} (highest), "
          f"B {err['topk_merge']:.3g}")
    return err


CANON_TIERS = ((10, "bf16x3"), (100, "bf16x3"), (512, "bf16x3"),
               (10, "highest"), (100, "highest"), (512, "highest"))


def phase_canonical(pmt, q, c):
    ref_idx, ref_scores = numpy_oracle(q, c, 512)
    for k, precision in CANON_TIERS:
        cfg = pmt.SearchConfig(precision=precision)
        idx, scores = pmt.topk(q, c, k, "cosine", config=cfg)
        gate(idx, scores, ref_idx[:, :k], ref_scores[:, :k],
             f"topk k={k} {precision}")
        corpus = pmt.Corpus(c, config=cfg)
        idx, scores = corpus.topk(q, k)
        gate(idx, scores, ref_idx[:, :k], ref_scores[:, :k],
             f"Corpus.topk k={k} {precision}")
        print(f"phase 3: canonical {N_QUERIES}x{N_CORPUS}x{DIM} cosine "
              f"k={k} {precision}: topk and Corpus.topk pass the float64 "
              f"oracle gate")


def _oracle_on_card(torch, q, c, k, chunk=250_000):
    """float64 cosine top-k on the card, in corpus chunks."""
    qn = q.double()
    qn = qn / qn.norm(dim=1, keepdim=True)
    best_v, best_i = [], []
    for r0 in range(0, c.shape[0], chunk):
        cn = c[r0:r0 + chunk].double()
        cn = cn / cn.norm(dim=1, keepdim=True)
        v, i = torch.topk(qn @ cn.T, k, dim=1)
        best_v.append(v)
        best_i.append(i + r0)
    v = torch.cat(best_v, dim=1)
    i = torch.cat(best_i, dim=1)
    v, order = torch.sort(v, dim=1, descending=True, stable=True)
    return (torch.gather(i, 1, order)[:, :k].cpu().numpy(),
            v[:, :k].cpu().numpy())


def phase_big(pmt, torch):
    from polars_matmul_tpu_torch.kernels import fused_topk as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    c = torch.randn((BIG_ROWS, DIM), generator=gen, device="cuda")
    corpus = pmt.Corpus(c)
    requests = {}
    for batch in (8, 256):
        q = torch.randn((batch, DIM), generator=gen, device="cuda")
        for k in (10, 100):
            t0 = time.perf_counter()
            idx, scores = corpus.topk(q, k)   # results land on the host
            first = (time.perf_counter() - t0) * 1e3
            ref_idx, ref_scores = _oracle_on_card(torch, q, c, k)
            gate(idx, scores, ref_idx, ref_scores,
                 f"2M corpus batch={batch} k={k}")
            requests[(batch, k)] = q
            print(f"phase 4: {BIG_ROWS}x{DIM} corpus, batch {batch}, k={k}: "
                  f"passes the float64 oracle gate (first request "
                  f"{first:.1f} ms host, corpus prep included on the "
                  f"first)")
    # The bucket selection on the main path: batch 8 (query tile 16) at
    # k=10, asked for by the corpus's config.
    q = requests[(8, 10)]
    idx, scores = pmt.Corpus(c, config=pmt.SearchConfig(
        selection="bucket")).topk(q, 10)
    ref_idx, ref_scores = _oracle_on_card(torch, q, c, 10)
    gate(idx, scores, ref_idx, ref_scores,
         "2M corpus batch=8 k=10 selection='bucket'")
    print(f"phase 4: {BIG_ROWS}x{DIM} corpus, batch 8, k=10, "
          f"selection='bucket': passes the float64 oracle gate")
    # The gstack selection on the main path: the same request asked for
    # "gstack", and for "gpop" on the corpus's first 10,000 rows (gpop
    # takes at most 128 groups of 128 rows, as in the JAX package); both
    # take kernel A's gstack selection.
    for sel, rows in (("gstack", BIG_ROWS), ("gpop", N_CORPUS)):
        idx, scores = pmt.Corpus(c[:rows], config=pmt.SearchConfig(
            selection=sel)).topk(q, 10)
        ref_idx, ref_scores = _oracle_on_card(torch, q, c[:rows], 10)
        gate(idx, scores, ref_idx, ref_scores,
             f"{rows}x{DIM} corpus batch=8 k=10 selection={sel!r}")
        print(f"phase 4: {rows}x{DIM} corpus, batch 8, k=10, "
              f"selection={sel!r}: passes the float64 oracle gate")
    # The gstack selection above k = 128 on the main path, asked for by the
    # corpus's config: batch 8 over the 2M rows at k=256 (132 splits of 237
    # tiles: lossy) and k=512 (not built: the radix at its own geometry),
    # and 1000 queries over the first 10,000 at k=512 (the canonical shape:
    # lossless).
    q_canon = torch.randn((N_QUERIES, DIM), generator=gen, device="cuda")
    for rows, qs, k in ((BIG_ROWS, q, 256), (BIG_ROWS, q, 512),
                        (N_CORPUS, q_canon, 512)):
        idx, scores = pmt.Corpus(c[:rows], config=pmt.SearchConfig(
            selection="gstack")).topk(qs, k)
        ref_idx, ref_scores = _oracle_on_card(torch, qs, c[:rows], k)
        gate(idx, scores, ref_idx, ref_scores,
             f"{rows}x{DIM} corpus batch={qs.shape[0]} k={k} "
             f"selection='gstack'")
        geo = F.gstack_geometry(qs.shape[0], rows, k, "bf16x3",
                                F.device_sms(qs.device))
        print(f"phase 4: {rows}x{DIM} corpus, batch {qs.shape[0]}, k={k}, "
              f"selection='gstack' ("
              + (f"{geo[1]} splits of {geo[2]} tiles" if geo else
                 "not built: the radix selection")
              + "): passes the float64 oracle gate")
    # The stack selection on the main path: the default "auto" takes it in
    # its class (batch 8, query tile 16, k=17 and 32), and so does a corpus
    # whose config asks for "stack" (k=24).
    q = requests[(8, 10)]
    stacked = pmt.Corpus(c, config=pmt.SearchConfig(selection="stack"))
    for handle, sel, k in ((corpus, "auto", 17), (corpus, "auto", 32),
                           (stacked, "stack", 24)):
        tm = F.query_tile_rows(8, k)
        require(F.stack_route(sel, k, tm, False, "bf16x3"),
                f"selection={sel!r} at batch 8 k={k} does not take the stack")
        idx, scores = handle.topk(q, k)
        ref_idx, ref_scores = _oracle_on_card(torch, q, c, k)
        gate(idx, scores, ref_idx, ref_scores,
             f"2M corpus batch=8 k={k} selection={sel!r} (the stack)")
        print(f"phase 4: {BIG_ROWS}x{DIM} corpus, batch 8, k={k}, "
              f"selection={sel!r} (the stack selection, windows of "
              f"{F.STACK_WINDOW} tiles): passes the float64 oracle gate")
    del stacked
    return corpus, requests


def profile_request(torch, fn, label: str, card: str, host_ms: float,
                    ab_ms: Optional[float] = None) -> None:
    """One request under torch.profiler: device time by kernel, and the
    device's busy share of ``host_ms``, the request's median host time
    measured without the profiler (which slows the host side).

    Device time is summed over the trace's device events (kernels,
    copies), not over ``key_averages()``: there a CPU operator carries its
    kernels' device time as well (``aten::mm`` and CUPTI's "Activity
    Buffer Request" each carried one GEMM's, tripling it), and the
    package's ``pmm.*`` ranges span the request on the device too.  The
    trace must hold kernel A and, where ``ab_ms`` (the request's kernels A
    + B, CUDA events) is given, at least half of that in device time: a
    profile that misses either fails the phase (a trace once held
    0.0614 ms of an 8.659 ms request, with no kernel A; its cause is not
    known)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("pmm."):
            dev[e.name] = dev.get(e.name, 0.0) + e.device_time_total
    busy = sum(dev.values())
    kernel_a = sum(t for name, t in dev.items()
                   if re.search(r"fused_topk_\w+_kernel", name))
    top = ", ".join(f"{name[:48]} {t / 1e3:.4f} ms" for name, t in
                    sorted(dev.items(), key=lambda x: -x[1])[:5])
    ab = "" if ab_ms is None else f" (A+B by events {ab_ms:.4f} ms)"
    print(f"phase 6: [{card}] {label} profile: device busy "
          f"{busy / 1e3:.4f} ms, {100 * busy / (host_ms * 1e3):.1f} % of the "
          f"{host_ms:.3f} ms request; kernel A {kernel_a / 1e3:.4f} ms{ab}; "
          f"{top}")
    require(kernel_a > 0 and (ab_ms is None or busy >= 500 * ab_ms),
            f"{label}: the profile missed kernel A or half of the request's "
            f"A+B device time")


def _request_ab_ms(F, handle, q, k, core):
    """Kernels A + B of a dense request of ``handle`` (a ``Corpus`` whose
    core is ``core``) at k, cosine, on its prepared operands: CUDA events,
    the median of five calls."""
    qp = F.prepare_queries(q, "cosine", core)
    cp, cbp = handle._prepared_for(F.Metric.COSINE)
    return cuda_ms(lambda: F.fused_select(qp, cp, cbp, None, k, core),
                   reps=5, warmup=1)


def _bound(nbytes, ops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take,
    each input read once and each output written once, at the published
    peaks of ``utils.profiling`` (``dtype`` "bfloat16" for tensor-core
    products, "float32_cuda_cores" for f32 FMA)."""
    from polars_matmul_tpu_torch.utils import profiling as P

    peak, hbm = P.device_peak_tflops(dtype), P.device_hbm_bytes_per_s()
    require(peak is not None and hbm is not None,
            f"no published peak for {P.device_name()} in utils/profiling")
    by_bytes, by_ops = nbytes / hbm * 1e3, ops / (peak * 1e12) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def _entry(ms, plain_ms, library_ms, library_call, bound, shape):
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": library_call, "bound_ms": bound[0],
            "bound_by": bound[1], "shape": shape}


class GateCheck:
    """Phase 2's check of kernel A's carry gate (``prune``): while it is
    active, every launch of kernel A on the card runs a second time with
    the gate on and its counter, and the split lists must equal the first
    launch's bit for bit.  ``cases`` counts the launches checked,
    ``gated`` / ``skipped`` the tiles the gate saw and skipped."""

    def __init__(self, F, torch):
        self.F, self.torch = F, torch
        self.cases = self.gated = self.skipped = 0
        self.listed = self.wgmma = self.appending = self.radix = 0

    def __enter__(self):
        F, torch = self.F, self.torch
        self.launch = launch = F.fused_topk_partial

        def checked(qp, cp, cbp, mask, k, precision, splits, tps, tm,
                    *rest, prune=False, gate_count=None, **kw):
            args = (qp, cp, cbp, mask, k, precision, splits, tps, tm) + rest
            off = launch(*args, prune=prune, gate_count=gate_count, **kw)
            if prune or not qp.is_cuda:
                return off
            count = torch.zeros(2, dtype=torch.int32, device=qp.device)
            on = launch(*args, prune=True, gate_count=count, **kw)
            require(torch.equal(on[1], off[1]) and torch.equal(
                on[0].view(torch.int32), off[0].view(torch.int32)),
                f"kernel A with the gate on differs from off: m={qp.shape[0]}"
                f" n={cp.shape[0]} k={k} {precision} tm={tm} splits={splits}"
                f" listed={bool(rest) or 'tiles' in kw}")
            gated, skipped = count.tolist()
            self.cases += 1
            self.gated += gated
            self.skipped += skipped
            self.listed += bool(rest and rest[0] is not None) or (
                kw.get("tiles") is not None)
            self.wgmma += F.wgmma_core(tm, precision)
            self.appending += F.selection(k) == "append" or (
                k > F.INSERT_MAX_K and F.wgmma_core(tm, precision))
            self.radix += F.selection(k) == "radix" and not F.wgmma_core(
                tm, precision)
            return off

        F.fused_topk_partial = checked
        return self

    def __exit__(self, *exc):
        self.F.fused_topk_partial = self.launch
        return False


class BucketCheck:
    """Phase 2's check of kernel A's bucket selection: while it is active,
    every launch of kernel A on the card that does not ask for it, where
    it is built (``bucket_built``: k <= 16 at query tiles 16 and 32, the
    f32 walk at 16), runs
    again asking for it, and the split lists must equal the first
    launch's bit for bit.  Inside ``GateCheck`` that launch runs with the
    carry gate off and on, equal too.  ``cases`` counts the launches
    checked, ``listed`` the listed ones, ``windows`` / ``overflow`` what
    the bucket's counter gathered over them (gate off and on)."""

    def __init__(self, F, torch):
        self.F, self.torch = F, torch
        self.cases = self.listed = self.windows = self.overflow = 0

    def __enter__(self):
        F, torch = self.F, self.torch
        self.launch = launch = F.fused_topk_partial

        def checked(qp, cp, cbp, mask, k, precision, splits, tps, tm,
                    *rest, bucket=False, bucket_count=None, **kw):
            args = (qp, cp, cbp, mask, k, precision, splits, tps, tm) + rest
            out = launch(*args, bucket=bucket, bucket_count=bucket_count,
                         **kw)
            if (bucket or kw.get("gstack") or kw.get("stack")
                    or not qp.is_cuda or not F.bucket_built(tm, precision, k)):
                return out
            count = torch.zeros(2, dtype=torch.int32, device=qp.device)
            got = launch(*args, bucket=True, bucket_count=count, **kw)
            listed = bool(rest and rest[0] is not None) or (
                kw.get("tiles") is not None)
            require(torch.equal(got[1], out[1]) and torch.equal(
                got[0].view(torch.int32), out[0].view(torch.int32)),
                f"kernel A's bucket selection differs from the insertion: "
                f"m={qp.shape[0]} n={cp.shape[0]} k={k} {precision} tm={tm} "
                f"splits={splits} listed={listed}")
            windows, overflow = count.tolist()
            self.cases += 1
            self.listed += listed
            self.windows += windows
            self.overflow += overflow
            return out

        F.fused_topk_partial = checked
        return self

    def __exit__(self, *exc):
        self.F.fused_topk_partial = self.launch
        return False


class GstackCheck:
    """Phase 2's check of kernel A's gstack selection: while it is active,
    every launch of kernel A on the card that asks for no other selection,
    where the gstack is built (``gstack_built``: k <= 128 on the mma.sync
    ring and the f32 walk where its stacks fit), runs again asking for it,
    and the split lists (its re-walk's where its detector fired) must
    equal the first launch's bit for bit.  Inside ``GateCheck`` that
    launch runs with the carry gate off and on, equal too.  ``cases``
    counts the launches checked, ``listed`` the listed ones, ``rows`` /
    ``blocks`` what the gstack's counter gathered over them (gate off and
    on), ``big`` the launches above k = 128 (query tile 16, where
    ``gstack_big_plan`` builds it on the launch's splits: the radix
    selection's lists on the same splits)."""

    def __init__(self, F, torch):
        self.F, self.torch = F, torch
        self.cases = self.listed = self.rows = self.blocks = self.big = 0

    def __enter__(self):
        F, torch = self.F, self.torch
        self.launch = launch = F.fused_topk_partial

        def checked(qp, cp, cbp, mask, k, precision, splits, tps, tm,
                    *rest, gstack=False, gstack_count=None, **kw):
            args = (qp, cp, cbp, mask, k, precision, splits, tps, tm) + rest
            out = launch(*args, gstack=gstack, gstack_count=gstack_count,
                         **kw)
            if (gstack or kw.get("bucket") or kw.get("stack")
                    or not qp.is_cuda
                    or not F.gstack_built(tm, precision, k, tps)):
                return out
            count = torch.zeros(2, dtype=torch.int32, device=qp.device)
            got = launch(*args, gstack=True, gstack_count=count, **kw)
            listed = bool(rest and rest[0] is not None) or (
                kw.get("tiles") is not None)
            require(torch.equal(got[1], out[1]) and torch.equal(
                got[0].view(torch.int32), out[0].view(torch.int32)),
                f"kernel A's gstack selection differs from {F.selection(k)}: "
                f"m={qp.shape[0]} n={cp.shape[0]} k={k} {precision} tm={tm} "
                f"splits={splits} listed={listed}")
            rows, blocks = count.tolist()
            self.cases += 1
            self.listed += listed
            self.big += k > F.APPEND_MAX_K
            self.rows += rows
            self.blocks += blocks
            return out

        F.fused_topk_partial = checked
        return self

    def __exit__(self, *exc):
        self.F.fused_topk_partial = self.launch
        return False


# The gstack selection's own edges (phase 2): k from one level below the
# bound's to 128, dense splits of 1, 3 and 17 tiles, and its query tiles.
GSTACK_KS = (1, 10, 16, 100, 128)
GSTACK_TPS = (1, 3, 17)


def _planted_heavy(torch, gen, m, n, dim):
    """Integer data whose every row's top-k crowd one column of the tile:
    the queries non-negative, the corpus rows in column 5 of every tile
    (rows 5 + 64 j) +3 in every feature, so that column's cell takes more
    of a row's top-k than it holds and the detector fires on every row
    (the counterpart of the JAX package's planted collision); then every
    row of the first half twinned in the second."""
    q, c = _tie_data(torch, gen, m, n, dim)
    q = q.abs()
    c[5::64] += 3.0
    c[n // 2:] = c[: n - n // 2].clone()
    return q, c


def _gstack_edges(F, torch, gen):
    """Kernel A's gstack selection against its plain version, bit for bit
    on integer data, and its fire counter against the plain version of its
    walk (``fused_topk.gstack_partial_plain``): tie data with half the
    query rows zero, and planted collisions (``_planted_heavy``: every row
    fires), every core, each query tile it is built at, GSTACK_KS x
    GSTACK_TPS dense splits, with and without a mask that drops a third of
    the rows and every row of whole splits, and walking a list; each
    launch's gated twin too (under GateCheck, whose second launch the
    counter then also counts).  Returns (cases, rows fired, blocks fired,
    planted rows fired)."""
    n, dim, tn = 3000, 56, 128
    m = 37
    layout = -(-n // tn)
    tiles = torch.tensor([list(range(0, layout, 2))], dtype=torch.int32,
                         device="cuda")
    keep = torch.rand((n,), generator=gen, device="cuda") < 0.66
    keep[n // 3: n // 3 + 640] = False
    masks = (None, F.pad_mask_row(keep, n))
    n_tiles = -(-n // F._TN)
    cases = rows = blocks = planted_rows = 0
    count = torch.zeros(2, dtype=torch.int32, device="cuda")
    for planted in (False, True):
        if planted:
            q, c = _planted_heavy(torch, gen, m, n, dim)
        else:
            q, c = _tie_data(torch, gen, m, n, dim)
            q[::2] = 0.0
        for precision in F.CORES:
            qp = F.prepare_queries(q, "dot", precision)
            cp, cbp = F.prepare_corpus(c, "dot", precision=precision)
            for k, mask in ((k, mask) for k in GSTACK_KS for mask in masks):
                what = (f"gstack selection m={m} n={n} k={k} {precision} "
                        f"mask={mask is not None} planted={planted}")
                runs = [((qp, cp, cbp, mask, k, precision, -(-n_tiles // tps),
                          tps), (), f"splits of {tps} tiles, ")
                        for tps in GSTACK_TPS]
                runs.append(((qp, cp, cbp, mask, k, precision, 2, -(-(
                    tiles.shape[1] * tn // F._TN) // 2)), (tiles, tn, m),
                    "listed "))
                for args, listed, label in runs:
                    want = F.fused_topk_partial_plain(*args, *listed)
                    for tm in (16, 32, 64):
                        if not F.gstack_built(tm, precision, k, args[7]):
                            continue
                        count.zero_()
                        compare(*F.fused_topk_partial(
                            *args, tm, *listed, gstack=True,
                            gstack_count=count), *want, exact=True,
                            what=f"{label}tm={tm}, {what}")
                        fired = F.gstack_partial_plain(*args, tm, *listed)[2]
                        want_rows, want_blocks = F.gstack_fires(fired, tm)
                        got = count.tolist()
                        # GateCheck's gated twin adds its own fires.
                        require(got == [2 * want_rows, 2 * want_blocks],
                                f"{label}tm={tm}, {what}: the gstack counter "
                                f"{got} differs from twice the model's "
                                f"{[want_rows, want_blocks]}")
                        rows, blocks = rows + want_rows, blocks + want_blocks
                        planted_rows += planted * want_rows
                        cases += 1
            del qp, cp, cbp
    torch.cuda.synchronize()
    require(planted_rows > 0, "no planted collision fired")
    return cases, rows, blocks, planted_rows


# The stack selection's own edges (phase 2): k below, in and above its
# class up to 128, dense splits of 1, 3 and 17 tiles (a window ending
# inside a split and at its end).
STACK_KS = (1, 17, 32, 100, 128)
STACK_TPS = (1, 3, 17)


def _stack_edges(F, torch, gen):
    """Kernel A's stack selection against its plain version and the plain
    version of its walk (``fused_topk.stack_partial_plain``), bit for bit
    on integer data: tie data with half the query rows zero, and planted
    data (``_planted_heavy``: every row's top-k crowd one column), its
    cores, each query tile it is built at, STACK_KS x STACK_TPS dense
    splits, with and without a mask that drops a third of the rows and
    every row of whole splits; each launch's gated twin too (under
    GateCheck).  Returns the cases."""
    n, dim, m = 3000, 56, 37
    keep = torch.rand((n,), generator=gen, device="cuda") < 0.66
    keep[n // 3: n // 3 + 640] = False
    masks = (None, F.pad_mask_row(keep, n))
    n_tiles = -(-n // F._TN)
    cases = 0
    for planted in (False, True):
        if planted:
            q, c = _planted_heavy(torch, gen, m, n, dim)
        else:
            q, c = _tie_data(torch, gen, m, n, dim)
            q[::2] = 0.0
        for precision in F.STACK_CORES:
            qp = F.prepare_queries(q, "dot", precision)
            cp, cbp = F.prepare_corpus(c, "dot", precision=precision)
            for k, mask, tps in ((k, mask, tps) for k in STACK_KS
                                 for mask in masks for tps in STACK_TPS):
                what = (f"stack selection m={m} n={n} k={k} {precision} "
                        f"mask={mask is not None} planted={planted}, splits "
                        f"of {tps} tiles")
                args = (qp, cp, cbp, mask, k, precision, -(-n_tiles // tps),
                        tps)
                want = F.fused_topk_partial_plain(*args)
                compare(*F.stack_partial_plain(*args), *want, exact=True,
                        what=f"the plain walk, {what}")
                for tm in (16, 32):
                    if not F.stack_built(tm, precision, k):
                        continue
                    compare(*F.fused_topk_partial(*args, tm, stack=True),
                            *want, exact=True, what=f"tm={tm}, {what}")
                    cases += 1
            del qp, cp, cbp
    torch.cuda.synchronize()
    return cases


# The gstack selection above k = 128 (phase 2): its k, dense splits of 3
# and 17 tiles (lossless) and of one split of all 47 (lossy), the listed
# walk in 2 splits of 12 positions (lossless) and 1 of 48 (lossy).
GSTACK_BIG_KS = (129, 200, 256, 512, 1024)
GSTACK_BIG_TPS = (3, 17, 47)


def _gstack_bigk_edges(F, torch, gen):
    """Kernel A's gstack selection above k = 128 (query tile 16) against
    its plain version and against the radix selection's lists on the same
    splits, bit for bit on integer data (and so on each other), and its
    fire counter against the plain version of its walk
    (``fused_topk.gstack_partial_plain``): tie data with every other query
    row zero, non-finite rows and queries (``_poison``), and planted
    collisions (``_planted_heavy``), every core, GSTACK_BIG_KS, lossless
    and lossy dense splits and two lists, with and without a mask; each
    launch's gated twin too (under GateCheck, whose second launch the
    counter then also counts).  A lossless launch must not fire.  Returns
    (cases, lossless, lossy, rows fired, planted rows fired, not built)."""
    n, dim, tn, m, tm = 3000, 56, 128, 37, F.GSTACK_BIG_TM
    layout = -(-n // tn)
    lists = {2: torch.tensor([list(range(0, layout, 2))], dtype=torch.int32,
                             device="cuda"),
             1: torch.tensor([list(range(layout))], dtype=torch.int32,
                             device="cuda")}
    keep = torch.rand((n,), generator=gen, device="cuda") < 0.66
    keep[n // 3: n // 3 + 640] = False
    masks = (None, F.pad_mask_row(keep, n))
    n_tiles = -(-n // F._TN)
    cases = lossless = lossy = rows = planted_rows = 0
    skipped = set()
    count = torch.zeros(2, dtype=torch.int32, device="cuda")
    for kind in ("tie", "nonfinite", "planted"):
        if kind == "planted":
            q, c = _planted_heavy(torch, gen, m, n, dim)
        else:
            q, c = _tie_data(torch, gen, m, n, dim)
            q[::2] = 0.0
            if kind == "nonfinite":
                _poison(torch, q, c)
        for precision in F.CORES:
            qp = F.prepare_queries(q, "dot", precision)
            cp, cbp = F.prepare_corpus(c, "dot", precision=precision)
            for k, mask in ((k, mask) for k in GSTACK_BIG_KS
                            for mask in masks):
                what = (f"gstack above 128 m={m} n={n} k={k} {precision} "
                        f"mask={mask is not None} {kind}")
                runs = [((qp, cp, cbp, mask, k, precision,
                          -(-n_tiles // tps), tps), (),
                         f"splits of {tps} tiles, ")
                        for tps in GSTACK_BIG_TPS]
                for splits, tiles in lists.items():
                    tps = -(-(tiles.shape[1] * tn // F._TN) // splits)
                    runs.append(((qp, cp, cbp, mask, k, precision, splits,
                                  tps), (tiles, tn, m),
                                 f"listed, {splits} splits, "))
                for args, listed, label in runs:
                    if not F.gstack_built(tm, precision, k, args[7]):
                        skipped.add((precision, k, args[7]))
                        continue
                    want = F.fused_topk_partial_plain(*args, *listed)
                    radix = F.fused_topk_partial(*args, tm, *listed)
                    count.zero_()
                    got = F.fused_topk_partial(*args, tm, *listed,
                                               gstack=True,
                                               gstack_count=count)
                    compare(*got, *want, exact=True,
                            what=f"{label}{what}: against the plain version")
                    compare(*got, *radix, exact=True,
                            what=f"{label}{what}: against the radix lists")
                    fired = F.gstack_partial_plain(*args, tm, *listed)[2]
                    want_rows, want_blocks = F.gstack_fires(fired, tm)
                    levels = F.gstack_big_plan(tm, precision, k, args[7])[0]
                    # GateCheck's gated twin adds its own fires.
                    require(count.tolist() == [2 * want_rows,
                                               2 * want_blocks],
                            f"{label}{what}: the gstack counter "
                            f"{count.tolist()} differs from twice the "
                            f"model's {[want_rows, want_blocks]}")
                    require(levels < args[7] or want_rows == 0,
                            f"{label}{what}: a lossless launch fired")
                    lossless += levels >= args[7]
                    lossy += levels < args[7]
                    rows += want_rows
                    planted_rows += (kind == "planted") * want_rows
                    cases += 1
            del qp, cp, cbp
    torch.cuda.synchronize()
    require(lossless > 0 and lossy > 0, "the gstack edges above k = 128 ran "
            "no lossless or no lossy launch")
    require(planted_rows > 0, "no planted collision fired above k = 128")
    return cases, lossless, lossy, rows, planted_rows, sorted(skipped)


# The bucket selection's own edges (phase 2): k (every k it takes is <=
# 16), dense splits of 1, 2, 3 and 17 tiles (one-tile windows, windows
# ending mid-split, a first tile alone), and its query tiles.
BUCKET_KS = (1, 2, 5, 10, 16)
BUCKET_TPS = (1, 2, 3, 17)


def _class_heavy(torch, gen, m, n, dim):
    """Integer tie data whose best scores crowd a few of the bucket's
    classes: the queries are made non-negative and the corpus rows in the
    tile columns of lanes 0 and 5 (columns 0, 5, 32 and 37 of every 64)
    get +2 in every feature, so a row's top-k, and most scores that beat
    its early thresholds, fall in a few cells (the overflow fills, windows
    end early); then every row of the first half is twinned in the second
    (whose heavy rows so sit in other columns), so ties abound."""
    q, c = _tie_data(torch, gen, m, n, dim)
    q = q.abs()
    lane = torch.arange(n, device="cuda") % 64 % 32
    heavy = (lane == 0) | (lane == 5)
    c[heavy] += 2.0
    c[n // 2:] = c[: n - n // 2].clone()
    return q, c


def _bucket_edges(F, torch, gen):
    """Kernel A's bucket selection against its plain version, bit for bit
    on integer data: tie data with half the query rows zero (all-tied
    rows) and class-heavy data (``_class_heavy``), every core, each query
    tile it is built at (16, and 32 but in highest), BUCKET_KS x
    BUCKET_TPS dense splits, with and
    without a mask that drops a third of the rows and every row of whole
    splits, and walking a list; each launch's gated twin too (under
    GateCheck).  Returns (cases, windows, overflow entries)."""
    n, dim, tn = 3000, 56, 128
    m = 37
    layout = -(-n // tn)
    tiles = torch.tensor([list(range(0, layout, 2))], dtype=torch.int32,
                         device="cuda")
    keep = torch.rand((n,), generator=gen, device="cuda") < 0.66
    keep[n // 3: n // 3 + 640] = False
    masks = (None, F.pad_mask_row(keep, n))
    n_tiles = -(-n // F._TN)
    cases = windows = overflow = 0
    count = torch.zeros(2, dtype=torch.int32, device="cuda")
    for heavy in (False, True):
        if heavy:
            q, c = _class_heavy(torch, gen, m, n, dim)
        else:
            q, c = _tie_data(torch, gen, m, n, dim)
            q[::2] = 0.0
        for precision in F.CORES:
            qp = F.prepare_queries(q, "dot", precision)
            cp, cbp = F.prepare_corpus(c, "dot", precision=precision)
            for k, mask in ((k, mask) for k in BUCKET_KS for mask in masks):
                what = (f"bucket selection m={m} n={n} k={k} {precision} "
                        f"mask={mask is not None} class-heavy={heavy}")
                runs = [((qp, cp, cbp, mask, k, precision, -(-n_tiles // tps),
                          tps), (), f"splits of {tps} tiles, ")
                        for tps in BUCKET_TPS]
                runs.append(((qp, cp, cbp, mask, k, precision, 2, -(-(
                    tiles.shape[1] * tn // F._TN) // 2)), (tiles, tn, m),
                    "listed "))
                for args, listed, label in runs:
                    want = F.fused_topk_partial_plain(*args, *listed)
                    for tm in (16, 32):
                        if not F.bucket_built(tm, precision, k):
                            continue
                        count.zero_()
                        compare(*F.fused_topk_partial(
                            *args, tm, *listed, bucket=True,
                            bucket_count=count), *want, exact=True,
                            what=f"{label}tm={tm}, {what}")
                        w, o = count.tolist()
                        windows, overflow = windows + w, overflow + o
                        cases += 1
            del qp, cp, cbp
    torch.cuda.synchronize()
    return cases, windows, overflow


# Kernel A with the carry gate on and off at the cells of phase 6: each
# cell's times, skip share and verdict, for the summary and PERF.md.
GATE_CELLS = []
GATE_TURNS = 3
GATE_SRC = TPU_KERNEL + ":1434"


def _jax_rule(F, n: int, dim: int, k: int) -> bool:
    """Whether the JAX package's prune="auto" turns its gate on for a dense
    request over n rows: at least 16 corpus tiles of its layout tile
    (fused_topk.py:1995).  The port's "auto" is off (``prune_gate``); this
    says where the JAX rule would turn the gate on."""
    from polars_matmul_tpu_torch.config import SearchConfig

    return -(-n // F.layout_tile_rows(dim, SearchConfig(), k)) >= 16


def _time_gate(F, torch, card, label, args, jax_rule, reps=10, **kw):
    """Kernel A (``fused_topk_partial(*args, **kw)``) with the carry gate on
    and off, in turns (off, on, on, off, ...), CUDA events: the split
    lists equal bit for bit, the gate's skip share from its counter, the
    median of each setting's turns and their spread.  ``jax_rule``: the
    JAX package's "auto" (at least 16 corpus tiles) would turn the gate
    on here.  Returns the cell."""
    count = torch.zeros(2, dtype=torch.int32, device="cuda")
    off = F.fused_topk_partial(*args, **kw)
    on = F.fused_topk_partial(*args, prune=True, gate_count=count, **kw)
    require(torch.equal(on[1], off[1]) and torch.equal(
        on[0].view(torch.int32), off[0].view(torch.int32)),
        f"{label}: kernel A with the gate on differs from off")
    gated, skipped = count.tolist()
    times = {"off": [], "on": []}
    for turn in range(GATE_TURNS):
        for setting in (("off", "on") if turn % 2 == 0 else ("on", "off")):
            times[setting].append(cuda_ms(lambda: F.fused_topk_partial(
                *args, prune=setting == "on", **kw), reps=reps, warmup=2))
    med = {key: statistics.median(v) for key, v in times.items()}
    spread = max(max(v) - min(v) for v in times.values())
    cell = {"label": label, "off_ms": med["off"], "on_ms": med["on"],
            "off_turns": times["off"], "on_turns": times["on"],
            "spread_ms": spread, "skipped": skipped, "gated": gated,
            "skip_share": skipped / max(1, gated), "jax_rule": jax_rule,
            "no_worse": med["on"] - med["off"] <= spread}
    GATE_CELLS.append(cell)
    print(f"phase 6: [{card}] carry gate, {label}: off "
          f"{' / '.join(f'{t:.4f}' for t in times['off'])} ms, on "
          f"{' / '.join(f'{t:.4f}' for t in times['on'])} ms (medians "
          f"{med['off']:.4f} / {med['on']:.4f}, spread {spread:.4f}); "
          f"skipped {skipped} of {gated} tiles ({cell['skip_share']:.3f}); "
          f"the JAX rule turns 'auto' {'on' if jax_rule else 'off'} here; "
          f"on {'no worse than' if cell['no_worse'] else 'SLOWER than'} off "
          f"beyond the spread")
    return cell


# Kernel A asked for the bucket selection against the insertion at the
# cells of phase 6 (k <= 16, query tiles 16 and 32): each cell's times,
# counter and verdict, for the summary and PERF.md.
BUCKET_CELLS = []


def _time_bucket(F, torch, card, label, args, reps=10, **kw):
    """Kernel A (``fused_topk_partial(*args, **kw)``, args ending in the
    query tile) with the insertion and asked for the bucket selection, in
    turns (insert, bucket, bucket, insert, ...), CUDA events: the split
    lists equal bit for bit, the bucket's windows and overflow entries
    from its counter, each route's median and their spread.  Returns the
    cell, or None where the bucket is not built."""
    k, precision, tm = args[4], args[5], args[8]
    if not F.bucket_built(tm, precision, k):
        return None
    count = torch.zeros(2, dtype=torch.int32, device="cuda")
    ins = F.fused_topk_partial(*args, **kw)
    got = F.fused_topk_partial(*args, bucket=True, bucket_count=count, **kw)
    require(torch.equal(got[1], ins[1]) and torch.equal(
        got[0].view(torch.int32), ins[0].view(torch.int32)),
        f"{label}: the bucket selection differs from the insertion")
    windows, overflow = count.tolist()
    times = {"insert": [], "bucket": []}
    for turn in range(GATE_TURNS):
        for route in (("insert", "bucket") if turn % 2 == 0
                      else ("bucket", "insert")):
            times[route].append(cuda_ms(lambda: F.fused_topk_partial(
                *args, bucket=route == "bucket", **kw), reps=reps,
                warmup=2))
    med = {key: statistics.median(v) for key, v in times.items()}
    spread = max(max(v) - min(v) for v in times.values())
    cell = {"label": label, "insert_ms": med["insert"],
            "bucket_ms": med["bucket"], "spread_ms": spread,
            "windows": windows, "overflow": overflow,
            "faster": med["insert"] - med["bucket"] > spread}
    BUCKET_CELLS.append(cell)
    print(f"phase 6: [{card}] bucket selection, {label}: insert "
          f"{' / '.join(f'{t:.4f}' for t in times['insert'])} ms, bucket "
          f"{' / '.join(f'{t:.4f}' for t in times['bucket'])} ms (medians "
          f"{med['insert']:.4f} / {med['bucket']:.4f}, spread {spread:.4f}); "
          f"{windows} windows, {overflow} overflow entries; bucket "
          f"{'faster than' if cell['faster'] else 'not faster than'} the "
          f"insertion beyond the spread")
    return cell


# Kernel A asked for the gstack selection against its own selection (the
# insertion or the slack) at the cells of phase 6 (k <= 128 where it is
# built): each cell's times, fires and verdict, for the summary and
# PERF.md.
GSTACK_CELLS = []


def _time_gstack(F, torch, card, label, args, reps=10, **kw):
    """Kernel A (``fused_topk_partial(*args, **kw)``, args ending in the
    query tile, then a listed launch's tiles, tn and block rows) with its
    own selection and asked for the gstack selection, in turns (own,
    gstack, gstack, own, ...), CUDA events: the split lists equal bit for
    bit, the gstack's counter equal to the plain version of its walk on
    the same operands (``fused_topk.gstack_partial_plain``), each route's
    median and their spread.  Returns the cell, or None where the gstack
    is not built."""
    k, precision, tm = args[4], args[5], args[8]
    if not F.gstack_built(tm, precision, k, args[7]):
        print(f"phase 6: [{card}] gstack selection, {label}: not built "
              f"({F.gstack_levels(k, tm)} levels, stacks "
              f"{F.gstack_tail_bytes(tm, F.gstack_levels(k, tm))} B)")
        return None
    count = torch.zeros(2, dtype=torch.int32, device="cuda")
    own = F.fused_topk_partial(*args, **kw)
    got = F.fused_topk_partial(*args, gstack=True, gstack_count=count, **kw)
    require(torch.equal(got[1], own[1]) and torch.equal(
        got[0].view(torch.int32), own[0].view(torch.int32)),
        f"{label}: the gstack selection differs from {F.selection(k)}")
    fired = F.gstack_partial_plain(*args[:8], tm, *args[9:])[2]
    model = F.gstack_fires(fired, tm)
    rows, blocks = count.tolist()
    require((rows, blocks) == model,
            f"{label}: the gstack counter ({rows}, {blocks}) differs from "
            f"the plain version of its walk {model}")
    times = {"own": [], "gstack": []}
    for turn in range(GATE_TURNS):
        for route in (("own", "gstack") if turn % 2 == 0
                      else ("gstack", "own")):
            times[route].append(cuda_ms(lambda: F.fused_topk_partial(
                *args, gstack=route == "gstack", **kw), reps=reps,
                warmup=2))
    med = {key: statistics.median(v) for key, v in times.items()}
    spread = max(max(v) - min(v) for v in times.values())
    m, splits = args[0].shape[0], args[6]
    cell = {"label": label, "own_ms": med["own"],
            "gstack_ms": med["gstack"], "spread_ms": spread,
            "rows": rows, "blocks": blocks, "row_splits": m * splits,
            "block_count": -(-m // tm) * splits,
            "levels": F.gstack_levels(k, tm),
            "faster": med["own"] - med["gstack"] > spread}
    GSTACK_CELLS.append(cell)
    print(f"phase 6: [{card}] gstack selection, {label}: "
          f"{F.selection(k)} {' / '.join(f'{t:.4f}' for t in times['own'])}"
          f" ms, gstack {' / '.join(f'{t:.4f}' for t in times['gstack'])} "
          f"ms (medians {med['own']:.4f} / {med['gstack']:.4f}, spread "
          f"{spread:.4f}); {cell['levels']} levels; fired {rows} of "
          f"{m * splits} rows, {blocks} of {cell['block_count']} blocks "
          f"walked again (the plain version of the walk: the same); gstack "
          f"{'faster than' if cell['faster'] else 'not faster than'} "
          f"{F.selection(k)} beyond the spread")
    return cell


# Kernel A asked for the stack selection against the slack at the cells
# of phase 6 (its class): each cell's times and verdict, for the summary
# and PERF.md.
STACK_CELLS = []
# The k of phase 6's stack cells.
STACK_TIMED_KS = (17, 32)


def _time_stack(F, torch, card, label, args, library, bound):
    """Kernel A (``fused_topk_partial(*args)``, args ending in the query
    tile) with the slack and asked for the stack selection, alone and with
    kernel B, in turns (CUDA events, GATE_TURNS turns): the split lists
    equal bit for bit to the slack's and within tolerance of the plain
    version of its walk (``fused_topk.stack_partial_plain``), each route's
    median and their
    spread, beside the plain version's time, the library call
    (``library``) and ``bound``.  Returns the kernels line's entry."""
    k, precision, tm = args[4], args[5], args[8]
    require(F.stack_built(tm, precision, k), f"{label}: the stack is not "
            f"built")
    own = F.fused_topk_partial(*args)
    got = F.fused_topk_partial(*args, stack=True)
    compare(*got, *own, exact=True,
            what=f"{label}: the stack against {F.selection(k)}")
    # Real data: the plain version's scores round otherwise than the
    # ring's, so it is held within RTOL of the row's term scale (the exact
    # plain walk on integer data is phase 2's ``_stack_edges``).
    compare(*got, *F.stack_partial_plain(*args[:8]),
            scale=_term_scale(F, *args[:3], precision)[:, :, None],
            what=f"{label}: the stack against stack_partial_plain")
    routes = {"own": lambda: F.fused_topk_partial(*args),
              "stack": lambda: F.fused_topk_partial(*args, stack=True)}
    routes["own A+B"] = lambda: F.topk_merge(*routes["own"](), k)
    routes["stack A+B"] = lambda: F.topk_merge(*routes["stack"](), k)
    times = {name: [] for name in routes}
    for turn in range(GATE_TURNS):
        for name in (list(routes) if turn % 2 == 0 else
                     list(reversed(list(routes)))):
            times[name].append(cuda_ms(routes[name], reps=10, warmup=2))
    med = {name: statistics.median(v) for name, v in times.items()}
    spread = {a: max(max(times[a]) - min(times[a]),
                     max(times[b]) - min(times[b]))
              for a, b in (("stack", "own"), ("stack A+B", "own A+B"))}
    faster = {a: med[b] - med[a] > spread[a]
              for a, b in (("stack", "own"), ("stack A+B", "own A+B"))}
    plain = cuda_ms(lambda: F.stack_partial_plain(*args[:8]), reps=3,
                    warmup=1)
    lib = cuda_ms(library, reps=10)
    STACK_CELLS.append({"label": label, "own_ms": med["own"],
                        "stack_ms": med["stack"], "faster": faster["stack"],
                        "faster_ab": faster["stack A+B"]})
    print(f"phase 6: [{card}] stack selection, {label}: {F.selection(k)} A "
          f"{' / '.join(f'{t:.4f}' for t in times['own'])} ms, A+B "
          f"{' / '.join(f'{t:.4f}' for t in times['own A+B'])} ms; stack "
          f"(windows of {F.STACK_WINDOW} tiles) A "
          f"{' / '.join(f'{t:.4f}' for t in times['stack'])} ms, A+B "
          f"{' / '.join(f'{t:.4f}' for t in times['stack A+B'])} ms "
          f"(medians A {med['own']:.4f} / {med['stack']:.4f}, A+B "
          f"{med['own A+B']:.4f} / {med['stack A+B']:.4f}; faster beyond "
          f"the spread: A {faster['stack']}, A+B {faster['stack A+B']}); "
          f"plain walk {plain:.3f} ms; library "
          f"torch.addmm + torch.topk (f32) {lib:.4f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    return _entry(med["stack"], plain, lib, "torch.addmm + torch.topk (f32)",
                  bound, f"{label}: selection='auto' / 'stack' (windows of "
                  f"{F.STACK_WINDOW} tiles; {F.selection(k)} "
                  f"{med['own']:.4f} ms; A+B {med['stack A+B']:.4f} against "
                  f"{med['own A+B']:.4f} ms)")


def _stack_summary(card):
    """The stack selection's cells: where it was faster than the slack
    beyond the spread ("auto" takes it where ``fused_topk.stack_route``
    says)."""
    faster = [c["label"] for c in STACK_CELLS if c["faster"]]
    print(f"phase 6: [{card}] stack selection: {len(STACK_CELLS)} cells "
          f"timed, faster than the slack beyond the spread at "
          f"{len(faster)} (A; A + B at "
          f"{sum(c['faster_ab'] for c in STACK_CELLS)}): {faster}")


# The canonical k that phase 6 times the gstack selection above k = 128 at
# (k=1024 is not built there: it prints so).
GSTACK_BIG_TIMED = (129, 256, 512, 1024)


def _time_gstack_bigk(F, torch, card, label, qp, cp, cbp, k, core, library,
                      m, n, dim):
    """Kernel A's radix selection at its geometry against the gstack
    selection above k = 128 at its own (``gstack_geometry``), kernel A
    alone and A + B, in turns (CUDA events, GATE_TURNS turns): the gstack's
    lists equal the radix's on its splits and the merged results equal,
    its counter equal to the plain version of its walk; beside the plain
    version's time, the library call (``library``) and the bound of the
    function (the operands, the lists of the radix's geometry, the
    products).  Returns the kernels line's entry (the gstack's kernel A
    time), or None where the gstack is not built."""
    dev = qp.device
    own = F.kernel_geometry(m, n, k, core, dev, dim=dim)
    geo = F.gstack_geometry(m, n, k, core, F.device_sms(dev))
    if geo is None:
        print(f"phase 6: [{card}] gstack above 128, {label}: not built "
              f"(selection='gstack' runs the radix at tm={own[0]}, "
              f"splits={own[1]})")
        return None
    tm, splits, tps = geo
    levels = F.gstack_big_plan(tm, core, k, tps)[0]
    args = (qp, cp, cbp, None, k, core, splits, tps, tm)
    count = torch.zeros(2, dtype=torch.int32, device="cuda")
    got = F.fused_topk_partial(*args, gstack=True, gstack_count=count)
    compare(*got, *F.fused_topk_partial(*args), exact=True,
            what=f"{label}: the gstack against the radix on its splits")
    compare(*F.topk_merge(*got, k), *F.topk_merge(*F.fused_topk_partial(
        qp, cp, cbp, None, k, core, own[1], own[2], own[0]), k), exact=True,
            what=f"{label}: the gstack's merged result against the radix's")
    model = F.gstack_fires(F.gstack_partial_plain(*args)[2], tm)
    require(tuple(count.tolist()) == model,
            f"{label}: the gstack counter {count.tolist()} differs from the "
            f"plain version of its walk {model}")
    routes = {
        "radix": lambda: F.fused_topk_partial(qp, cp, cbp, None, k, core,
                                              own[1], own[2], own[0]),
        "gstack": lambda: F.fused_topk_partial(*args, gstack=True)}
    routes["radix A+B"] = lambda: F.topk_merge(*routes["radix"](), k)
    routes["gstack A+B"] = lambda: F.topk_merge(*routes["gstack"](), k)
    times = {name: [] for name in routes}
    for turn in range(GATE_TURNS):
        for name in (list(routes) if turn % 2 == 0 else
                     list(reversed(list(routes)))):
            times[name].append(cuda_ms(routes[name], reps=10, warmup=2))
    med = {name: statistics.median(v) for name, v in times.items()}
    spread = {a: max(max(times[a]) - min(times[a]),
                     max(times[b]) - min(times[b]))
              for a, b in (("gstack", "radix"), ("gstack A+B", "radix A+B"))}
    plain = cuda_ms(lambda: F.gstack_partial_plain(*args), reps=3, warmup=1)
    lib = cuda_ms(library, reps=10)
    passes, peak = ((1, "float32_cuda_cores") if core == "highest"
                    else (3, "bfloat16"))
    bound = _bound(qp.nbytes + cp.nbytes + cbp.nbytes + m * own[1] * k * 8,
                   passes * 2 * m * n * dim, peak)
    faster = {a: med[b] - med[a] > spread[a]
              for a, b in (("gstack", "radix"), ("gstack A+B", "radix A+B"))}
    print(f"phase 6: [{card}] gstack above 128, {label}: radix (tm="
          f"{own[0]}, splits={own[1]}) A {' / '.join(f'{t:.4f}' for t in times['radix'])}"
          f" ms, A+B {' / '.join(f'{t:.4f}' for t in times['radix A+B'])}"
          f" ms; gstack (tm={tm}, {splits} splits of {tps} tiles, {levels} "
          f"levels, {'lossless' if levels >= tps else 'lossy'}) A "
          f"{' / '.join(f'{t:.4f}' for t in times['gstack'])} ms, A+B "
          f"{' / '.join(f'{t:.4f}' for t in times['gstack A+B'])} ms "
          f"(medians A {med['radix']:.4f} / {med['gstack']:.4f}, A+B "
          f"{med['radix A+B']:.4f} / {med['gstack A+B']:.4f}; faster beyond "
          f"the spread: A {faster['gstack']}, A+B {faster['gstack A+B']}); "
          f"fired {model[0]} rows; plain walk {plain:.3f} ms; library "
          f"torch.addmm + torch.topk (f32) {lib:.4f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    return _entry(med["gstack"], plain, lib, "torch.addmm + torch.topk (f32)",
                  bound, f"{label}: {m} x {n} x {dim} cosine, "
                  f"selection='gstack' ({splits} splits of {tps} tiles, "
                  f"{levels} levels; radix "
                  f"{med['radix']:.4f} ms; A+B {med['gstack A+B']:.4f} "
                  f"against {med['radix A+B']:.4f} ms)")


def _gstack_summary(card):
    """The gstack selection's cells: where it was faster than kernel A's
    own selection beyond the spread ("auto" takes it where
    ``fused_topk.gstack_route`` says)."""
    faster = [c["label"] for c in GSTACK_CELLS if c["faster"]]
    print(f"phase 6: [{card}] gstack selection: {len(GSTACK_CELLS)} cells "
          f"timed, faster than the insertion or slack beyond the spread at "
          f"{len(faster)}: {faster}")


def _bucket_summary(card):
    """The bucket selection's cells: where it was faster than the
    insertion beyond the spread ("auto" takes it where
    ``fused_topk.bucket_route`` says)."""
    faster = [c["label"] for c in BUCKET_CELLS if c["faster"]]
    print(f"phase 6: [{card}] bucket selection: {len(BUCKET_CELLS)} cells "
          f"timed, faster than the insertion beyond the spread at "
          f"{len(faster)}: {faster}")


def _gate_summary(card):
    """The carry gate's cells: where the JAX rule would turn "auto" on, and
    whether the gate was slower than off beyond the spread there."""
    ruled = [c for c in GATE_CELLS if c["jax_rule"]]
    slower = [c["label"] for c in ruled if not c["no_worse"]]
    print(f"phase 6: [{card}] carry gate: {len(GATE_CELLS)} cells timed, "
          f"{len(ruled)} where the JAX rule turns 'auto' on; on slower "
          f"than off beyond the spread at {len(slower)} of them "
          f"{slower} ('auto' is off on the card)")


def _time_merge(F, torch, card):
    """Kernel B at the shapes of ``MERGE_SHAPES`` (the lists the main
    path's requests give it), on sorted lists of random values: CUDA
    events around one call (the host's enqueue included, as ``cuda_ms``
    times every kernel) and a CUDA graph of 20 calls (the device alone),
    beside its plain version, ``torch.topk`` of the flattened lists and
    its byte bound."""
    from polars_matmul_tpu_torch.utils.profiling import graph_ms

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sms = F.device_sms(torch.device("cuda"))
    for m, splits, k, source in MERGE_SHAPES:
        pv, pi = sorted_lists(torch, gen, m, splits, k, "random")
        compare(*F.topk_merge(pv, pi, k), *F.topk_merge_plain(pv, pi, k),
                exact=True, what=f"timed kernel B {m}x{splits}x{k}")
        flat = pv.reshape(m, -1)
        b, b_dev = (cuda_ms(lambda: F.topk_merge(pv, pi, k)),
                    graph_ms(lambda: F.topk_merge(pv, pi, k)))
        plain, plain_dev = (cuda_ms(lambda: F.topk_merge_plain(pv, pi, k)),
                            graph_ms(lambda: F.topk_merge_plain(pv, pi, k)))
        lib, lib_dev = (cuda_ms(lambda: torch.topk(flat, k, dim=1)),
                        graph_ms(lambda: torch.topk(flat, k, dim=1)))
        bound = _bound(pv.nbytes + pi.nbytes + m * k * 8, 0,
                       "float32_cuda_cores")
        groups, rows = F.merge_plan(m, splits, k, sms)
        print(f"phase 6: [{card}] kernel B {m}x{splits}x{k} ({source}; "
              f"{groups} blocks a row, {rows} rows a block): "
              f"{b:.4f} ms a call, {b_dev:.4f} ms on the device | plain "
              f"{plain:.4f} ms a call, {plain_dev:.4f} ms on the device | "
              f"torch.topk {lib:.4f} ms a call, "
              f"{lib_dev:.4f} ms on the device | bound {bound[0]:.4f} ms "
              f"({bound[1]})")
        del pv, pi, flat


def phase_times(pmt, F, torch, q_np, c_np, corpus_big, requests, card):
    """Device times of kernels, plain versions and library calls, and
    request times.  Returns the per-kernel entries of the canonical k=10
    tiers (kernel A's bf16x3 and highest cores, kernel B)."""
    from polars_matmul_tpu_torch.ops.reference import exact_matmul
    from polars_matmul_tpu_torch.utils.profiling import graph_ms

    q = torch.from_numpy(q_np).cuda()
    c = torch.from_numpy(c_np).cuda()
    # The library yardstick: the f32 cosine scores with one cuBLAS call,
    # then torch.topk (TF32 off: the function is exact f32).
    qn = q / q.norm(dim=1, keepdim=True)
    cn = c / c.norm(dim=1, keepdim=True)
    zero = torch.zeros(N_CORPUS, device="cuda")

    def library(k):
        with exact_matmul():
            return torch.topk(torch.addmm(zero, qn, cn.T), k, dim=1)

    libs = {k: cuda_ms(lambda: library(k)) for k in (10, 100, 512)}
    per_kernel = {}
    for k, precision in CANON_TIERS:
        qp = F.prepare_queries(q, "cosine", precision)
        cp, cbp = F.prepare_corpus(c, "cosine", precision=precision)
        compare(*F.fused_select(qp, cp, cbp, None, k, precision),
                *F.fused_topk_plain(qp, cp, cbp, None, k, precision),
                scale=_term_scale(F, qp, cp, cbp, precision),
                what=f"timed canonical k={k} {precision}")
        ab = cuda_ms(lambda: F.fused_select(qp, cp, cbp, None, k, precision))
        plain = cuda_ms(lambda: F.fused_topk_plain(qp, cp, cbp, None, k,
                                                   precision))
        tm, splits, tps = F.kernel_geometry(N_QUERIES, N_CORPUS, k,
                                            precision, q.device, dim=DIM)
        # The launch against the card's slots (blocks an SM x SMs).
        per_sm = F._occupancy[(q.device.index, tm, k, precision, False,
                               F._corpus_width(precision, DIM))]
        grid = -(-N_QUERIES // tm) * splits
        slots = per_sm * F.device_sms(q.device)
        print(f"phase 6: [{card}] canonical k={k} {precision}: "
              f"{F.selection(k)} selection, tm={tm}, {splits} splits of "
              f"{tps} tiles, {grid} blocks on {slots} slots ({per_sm} an SM"
              f"), {grid / slots:.2f} waves")
        a = cuda_ms(lambda: F.fused_topk_partial(qp, cp, cbp, None, k,
                                                 precision, splits, tps, tm))
        if precision == "bf16x3":
            _time_gate(F, torch, card, f"canonical k={k} bf16x3 (tm={tm}, "
                       f"splits={splits})",
                       (qp, cp, cbp, None, k, precision, splits, tps, tm),
                       _jax_rule(F, N_CORPUS, DIM, k))
        a_plain = cuda_ms(lambda: F.fused_topk_partial_plain(
            qp, cp, cbp, None, k, precision, splits, tps))
        pv, pi = F.fused_topk_partial(qp, cp, cbp, None, k, precision,
                                      splits, tps, tm)
        b = cuda_ms(lambda: F.topk_merge(pv, pi, k))
        b_plain = cuda_ms(lambda: F.topk_merge_plain(pv, pi, k))
        # The kernels line: each core at k=10, 100 and 512 (the
        # insertion, the appending and the radix selections).
        passes, peak = ((3, "bfloat16") if precision == "bf16x3"
                        else (1, "float32_cuda_cores"))
        a_bound = _bound(
            qp.nbytes + cp.nbytes + cbp.nbytes + pv.nbytes + pi.nbytes,
            passes * 2 * N_QUERIES * N_CORPUS * DIM, peak)
        per_kernel[precision + ("" if k == 10 else f".k{k}")] = dict(
            _entry(a, a_plain, libs[k], "torch.addmm + torch.topk (f32)",
                   a_bound, f"{N_QUERIES}x{N_CORPUS}x{DIM} cosine k={k}"),
            selection=F.selection(k))
        print(f"phase 6: [{card}] canonical k={k} {precision}: kernel A "
              f"bound {a_bound[0]:.4f} ms ({a_bound[1]}); library "
              f"torch.addmm + torch.topk {libs[k]:.4f} ms")
        if (k, precision) == CANON_TIERS[0]:
            # A call timed by events, as every entry is; kernel B finishes
            # well before a call's Python enqueue does, so its device time
            # (a CUDA graph of calls) stands beside it under device_*.
            m = pv.shape[0]
            flat = pv.reshape(m, -1)
            b_lib = cuda_ms(lambda: torch.topk(flat, k, dim=1))
            dev = [graph_ms(fn) for fn in (
                lambda: F.topk_merge(pv, pi, k),
                lambda: F.topk_merge_plain(pv, pi, k),
                lambda: torch.topk(flat, k, dim=1))]
            b_bound = _bound(pv.nbytes + pi.nbytes + m * k * 8, 0,
                             "float32_cuda_cores")
            per_kernel["topk_merge"] = dict(_entry(
                b, b_plain, b_lib, "torch.topk of the flattened split lists",
                b_bound, f"{m}x{splits}x{k} split lists"),
                device_ms=dev[0], device_plain_ms=dev[1],
                device_library_ms=dev[2])
            print(f"phase 6: [{card}] canonical k=10: kernel B bound "
                  f"{b_bound[0]:.4f} ms (bytes); library torch.topk over "
                  f"the flattened lists {b_lib:.4f} ms | on the device "
                  f"(a CUDA graph of calls): kernel B {dev[0]:.4f} ms, "
                  f"plain {dev[1]:.4f} ms, torch.topk {dev[2]:.4f} ms")
        print(f"phase 6: [{card}] canonical k={k} {precision} (tm={tm}, "
              f"splits={splits}): A+B {ab:.4f} ms, plain {plain:.4f} ms | "
              f"A {a:.4f} ms, A plain {a_plain:.4f} ms | B {b:.4f} ms, "
              f"B plain {b_plain:.4f} ms")
    # The bucket selection at the canonical shape: k=1, 10 and 16 in both
    # cores, at query tiles 32 and 16 (the main path's 64 takes the
    # insertion), beside the insertion at 64.
    for precision in ("bf16x3", "highest"):
        qp = F.prepare_queries(q, "cosine", precision)
        cp, cbp = F.prepare_corpus(c, "cosine", precision=precision)
        for k in (1, 10, 16):
            tm, splits, tps = F.kernel_geometry(N_QUERIES, N_CORPUS, k,
                                                precision, q.device, dim=DIM)
            a = cuda_ms(lambda: F.fused_topk_partial(
                qp, cp, cbp, None, k, precision, splits, tps, tm))
            print(f"phase 6: [{card}] canonical k={k} {precision}: kernel A "
                  f"(insertion, tm={tm}, splits={splits}) {a:.4f} ms")
            for tm in (32, 16):
                geo = F.kernel_geometry(N_QUERIES, N_CORPUS, k, precision,
                                        q.device, tm, dim=DIM)
                _time_bucket(F, torch, card, f"canonical k={k} {precision} "
                             f"(tm={tm}, splits={geo[1]})",
                             (qp, cp, cbp, None, k, precision, geo[1],
                              geo[2], tm))
        del qp, cp, cbp
    # The gstack selection at the canonical shape: k=10 at the main path's
    # query tile 64 and at 32 and 16, k=100 at 32 and 16 (64 not built),
    # both cores.
    for precision in ("bf16x3", "highest"):
        qp = F.prepare_queries(q, "cosine", precision)
        cp, cbp = F.prepare_corpus(c, "cosine", precision=precision)
        for k, tms in ((10, (64, 32, 16)), (100, (64, 32, 16))):
            for tm in tms:
                geo = F.kernel_geometry(N_QUERIES, N_CORPUS, k, precision,
                                        q.device, tm, dim=DIM)
                _time_gstack(F, torch, card, f"canonical k={k} {precision} "
                             f"(tm={tm}, splits={geo[1]})",
                             (qp, cp, cbp, None, k, precision, geo[1],
                              geo[2], tm))
        del qp, cp, cbp
    # The gstack selection above k = 128 at the canonical shape, both
    # cores: the radix at its geometry against the gstack at its own, A
    # and A + B.
    for precision in ("bf16x3", "highest"):
        qp = F.prepare_queries(q, "cosine", precision)
        cp, cbp = F.prepare_corpus(c, "cosine", precision=precision)
        for k in GSTACK_BIG_TIMED:
            cell = _time_gstack_bigk(F, torch, card, f"canonical k={k} "
                                     f"{precision}", qp, cp, cbp, k,
                                     precision, lambda: library(k),
                                     N_QUERIES, N_CORPUS, DIM)
            if (k, precision) == (512, "bf16x3"):
                per_kernel["gstack_bigk"] = cell
        del qp, cp, cbp
    # The stack selection at the canonical shape in its class: k=17 and 32
    # at query tile 16 (the main path's tile 64 keeps the slack), both
    # cores.
    for precision in ("bf16x3", "highest"):
        qp = F.prepare_queries(q, "cosine", precision)
        cp, cbp = F.prepare_corpus(c, "cosine", precision=precision)
        passes, peak = ((3, "bfloat16") if precision == "bf16x3"
                        else (1, "float32_cuda_cores"))
        for k in STACK_TIMED_KS:
            tm, splits, tps = F.kernel_geometry(N_QUERIES, N_CORPUS, k,
                                                precision, q.device, 16,
                                                dim=DIM)
            bound = _bound(qp.nbytes + cp.nbytes + cbp.nbytes
                           + N_QUERIES * splits * k * 8,
                           passes * 2 * N_QUERIES * N_CORPUS * DIM, peak)
            _time_stack(F, torch, card, f"canonical k={k} {precision} "
                        f"(tm={tm}, splits={splits})",
                        (qp, cp, cbp, None, k, precision, splits, tps, tm),
                        lambda k=k: library(k), bound)
        del qp, cp, cbp
    _time_merge(F, torch, card)
    canon = pmt.Corpus(c_np)
    q_card = torch.from_numpy(q_np).to("cuda")
    for k in (10, 100, 512):
        canon.topk(q_np, k)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            canon.topk(q_np, k)
            ts.append((time.perf_counter() - t0) * 1e3)
        print(f"phase 6: [{card}] canonical Corpus.topk k={k} from NumPy: "
              f"{statistics.median(ts):.3f} ms host per 1000-query request")
        profile_request(torch, lambda: canon.topk(q_np, k),
                        f"canonical Corpus.topk k={k}", card,
                        statistics.median(ts),
                        ab_ms=_request_ab_ms(F, canon, q_card, k, "bf16x3"))
    canon = pmt.Corpus(c_np, config=pmt.SearchConfig(precision="highest"))
    canon.topk(q_np, 10)
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        canon.topk(q_np, 10)
        ts.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 6: [{card}] canonical Corpus.topk k=10 precision=highest "
          f"from NumPy: {statistics.median(ts):.3f} ms host per 1000-query "
          f"request")
    profile_request(torch, lambda: canon.topk(q_np, 10),
                    "canonical Corpus.topk k=10 highest", card,
                    statistics.median(ts),
                    ab_ms=_request_ab_ms(F, canon, q_card, 10, "highest"))
    del canon
    big = {core: _time_big(F, torch, corpus_big, requests, card, core)
           for core in ("bf16x3", "highest")}
    per_kernel["bucket"] = big["bf16x3"].pop("bucket")
    big["highest"].pop("bucket", None)
    per_kernel["gstack"] = big["bf16x3"].pop("gstack")
    big["highest"].pop("gstack", None)
    per_kernel["stack"] = big["bf16x3"].pop("stack")
    big["highest"].pop("stack", None)
    per_kernel["gated"] = _time_big_gate(F, torch, corpus_big, requests,
                                         card, big["bf16x3"])
    for (batch, k), qb in requests.items():
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            corpus_big.topk(qb, k)
            ts.append((time.perf_counter() - t0) * 1e3)
        qp = F.prepare_queries(qb, "cosine", "bf16x3")
        cp, cbp = corpus_big._prepared_for(F.Metric.COSINE)
        dev = cuda_ms(lambda: F.fused_select(qp, cp, cbp, None, k,
                                             "bf16x3"), reps=5)
        print(f"phase 6: [{card}] {BIG_ROWS}x{DIM} corpus batch {batch} "
              f"k={k}: request {statistics.median(ts):.3f} ms host, "
              f"A+B {dev:.3f} ms device")
        profile_request(torch, lambda: corpus_big.topk(qb, k),
                        f"{BIG_ROWS}x{DIM} batch {batch} k={k}", card,
                        statistics.median(ts), ab_ms=dev)
    return per_kernel


def _time_big(F, torch, corpus_big, requests, card, core):
    """Kernel A's bf16x3 or highest core at the 2M x 256 corpus, k=10,
    batch 8 and 256: kernel A alone and A + B (CUDA events) beside the
    plain version, the library yardstick (torch.addmm + torch.topk, f32)
    and the bound, after a check against the plain version."""
    from polars_matmul_tpu_torch.ops.reference import exact_matmul

    f32 = corpus_big._dense_device()
    cp, cbp = F.prepare_corpus(f32, "cosine", precision=core)
    cn = f32 / f32.norm(dim=1, keepdim=True)
    zero = torch.zeros(BIG_ROWS, device="cuda")
    passes, peak = ((3, "bfloat16") if core == "bf16x3"
                    else (1, "float32_cuda_cores"))
    measured = {}
    for (batch, k), qb in requests.items():
        if k != 10:
            continue
        qp = F.prepare_queries(qb, "cosine", core)
        compare(*F.fused_select(qp, cp, cbp, None, k, core),
                *F.fused_topk_plain(qp, cp, cbp, None, k, core),
                scale=_term_scale(F, qp, cp, cbp, core),
                what=f"timed {BIG_ROWS}x{DIM} batch {batch} {core}")
        tm, splits, tps = F.kernel_geometry(batch, BIG_ROWS, k, core,
                                            qp.device, dim=DIM)
        a = cuda_ms(lambda: F.fused_topk_partial(qp, cp, cbp, None, k,
                                                 core, splits, tps, tm),
                    reps=10)
        ab = cuda_ms(lambda: F.fused_select(qp, cp, cbp, None, k, core),
                     reps=10)
        plain = cuda_ms(lambda: F.fused_topk_partial_plain(
            qp, cp, cbp, None, k, core, splits, tps), reps=3, warmup=1)
        qn = qb / qb.norm(dim=1, keepdim=True)

        def library():
            with exact_matmul():
                return torch.topk(torch.addmm(zero, qn, cn.T), k, dim=1)

        lib = cuda_ms(library, reps=5)
        bound = _bound(qp.nbytes + cp.nbytes + cbp.nbytes
                       + batch * splits * k * 8,
                       passes * 2 * batch * BIG_ROWS * DIM, peak)
        print(f"phase 6: [{card}] {BIG_ROWS}x{DIM} batch {batch} k={k} "
              f"{core} (tm={tm}, splits={splits}): A {a:.4f} ms, A+B "
              f"{ab:.4f} ms, A plain {plain:.3f} ms; bound {bound[0]:.4f} "
              f"ms ({bound[1]}); library torch.addmm + torch.topk (f32) "
              f"{lib:.4f} ms")
        measured[batch] = (plain, lib, bound)
        bucket = _time_bucket(F, torch, card, f"{BIG_ROWS}x{DIM} batch "
                              f"{batch} k={k} {core} (tm={tm}, "
                              f"splits={splits})",
                              (qp, cp, cbp, None, k, core, splits, tps, tm))
        if bucket is not None:
            measured["bucket"] = _entry(
                bucket["bucket_ms"], plain, lib,
                "torch.addmm + torch.topk (f32)", bound,
                f"{BIG_ROWS}x{DIM} cosine batch {batch} k={k} {core}, "
                f"selection='bucket' (insertion {bucket['insert_ms']:.4f} "
                f"ms; {bucket['windows']} windows, {bucket['overflow']} "
                f"overflow entries)")
        gstack = _time_gstack(F, torch, card, f"{BIG_ROWS}x{DIM} batch "
                              f"{batch} k={k} {core} (tm={tm}, "
                              f"splits={splits})",
                              (qp, cp, cbp, None, k, core, splits, tps, tm))
        if gstack is not None and batch == 8:
            measured["gstack"] = _entry(
                gstack["gstack_ms"], plain, lib,
                "torch.addmm + torch.topk (f32)", bound,
                f"{BIG_ROWS}x{DIM} cosine batch {batch} k={k} {core}, "
                f"selection='gstack' (insertion {gstack['own_ms']:.4f} ms; "
                f"{gstack['levels']} levels, {gstack['rows']} of "
                f"{gstack['row_splits']} rows fired)")
    # The gstack at batch 8, k=100 (the slack's; tile 16, 10 levels).
    qb = requests[(8, 100)]
    qp = F.prepare_queries(qb, "cosine", core)
    tm, splits, tps = F.kernel_geometry(8, BIG_ROWS, 100, core, qp.device,
                                        dim=DIM)
    _time_gstack(F, torch, card, f"{BIG_ROWS}x{DIM} batch 8 k=100 {core} "
                 f"(tm={tm}, splits={splits})",
                 (qp, cp, cbp, None, 100, core, splits, tps, tm))
    # The stack at batch 8 in its class (tile 16: the main path's launch).
    qn = qb / qb.norm(dim=1, keepdim=True)
    for k in STACK_TIMED_KS:
        tm, splits, tps = F.kernel_geometry(8, BIG_ROWS, k, core, qp.device,
                                            dim=DIM)
        require(F.stack_route("auto", k, tm, False, core),
                f"batch 8 k={k} {core} is not in the stack's class")

        def library(k=k):
            with exact_matmul():
                return torch.topk(torch.addmm(zero, qn, cn.T), k, dim=1)

        bound = _bound(qp.nbytes + cp.nbytes + cbp.nbytes + 8 * splits * k * 8,
                       passes * 2 * 8 * BIG_ROWS * DIM, peak)
        entry = _time_stack(F, torch, card, f"{BIG_ROWS}x{DIM} batch 8 k={k} "
                            f"{core} (tm={tm}, splits={splits})",
                            (qp, cp, cbp, None, k, core, splits, tps, tm),
                            library, bound)
        if k == max(STACK_TIMED_KS):
            measured["stack"] = entry
    del cp, cbp, cn
    return measured


def _time_big_gate(F, torch, corpus_big, requests, card, measured):
    """Kernel A's bf16x3 core at the 2M x 256 corpus with the carry gate on
    and off, batch 8 and 256, k=10 and 100.  Returns the kernels line's
    entry of the gated launch: batch 8 k=10 (``benchmark_bigcorpus``'s
    first cell), beside the plain version, library call and bound of
    ``_time_big`` there."""
    cp, cbp = corpus_big._prepared_for(F.Metric.COSINE)
    entry = None
    for (batch, k), qb in requests.items():
        qp = F.prepare_queries(qb, "cosine", "bf16x3")
        tm, splits, tps = F.kernel_geometry(batch, BIG_ROWS, k, "bf16x3",
                                            qp.device, dim=DIM)
        cell = _time_gate(F, torch, card, f"{BIG_ROWS}x{DIM} batch {batch} "
                          f"k={k} bf16x3 (tm={tm}, splits={splits})",
                          (qp, cp, cbp, None, k, "bf16x3", splits, tps, tm),
                          _jax_rule(F, BIG_ROWS, DIM, k))
        if (batch, k) == (8, 10):
            plain, lib, bound = measured[8]
            entry = _entry(cell["on_ms"], plain, lib,
                           "torch.addmm + torch.topk (f32)", bound,
                           f"{BIG_ROWS}x{DIM} cosine batch 8 k=10, prune on "
                           f"(off {cell['off_ms']:.4f} ms, skip share "
                           f"{cell['skip_share']:.3f})")
    return entry


def _wide_f32(torch, chunk=1 << 20):
    """The 10M x 768 f32 corpus, made on the card from SEED in row
    chunks."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    c = torch.empty((WIDE_ROWS, WIDE_DIM), device="cuda")
    for r0 in range(0, WIDE_ROWS, chunk):
        c[r0:r0 + chunk].normal_(generator=gen)
    return c


def _wide_tie_corpus(pmt, F, torch, tier, gen, chunk=1 << 20):
    """A 10M x 768 corpus of integer codes in [-2, 2], every row twinned,
    in the tier's own form (int8 / int4 codes with scale 1, bf16 rows)."""
    n, half = WIDE_ROWS, WIDE_ROWS // 2
    codes = torch.empty((n, WIDE_DIM), dtype=torch.int8, device="cuda")
    for r0 in range(0, half, chunk):
        r1 = min(half, r0 + chunk)
        codes[r0:r1] = torch.randint(-2, 3, (r1 - r0, WIDE_DIM),
                                     generator=gen, device="cuda",
                                     dtype=torch.int8)
    codes[half:] = codes[:n - half]
    ones = torch.ones(n, device="cuda")
    if tier == "int8":
        return pmt.Corpus(codes, storage="int8", scales=ones)
    if tier == "int4":
        ck = F.feature_geometry(WIDE_DIM)[0]
        packed = torch.cat([F.pack_int4(codes[r0:r0 + chunk], ck)
                            for r0 in range(0, n, chunk)])
        del codes
        return pmt.Corpus(packed, storage="int4", scales=ones, dim=WIDE_DIM)
    rows = codes.to(torch.bfloat16)
    del codes
    return pmt.Corpus(rows, storage="bf16")


def _oracle_stored(F, torch, corpus, q, k, chunk=250_000, alive=None):
    """float64 cosine top-k over what the tier stores: the codes for int8
    and int4 (their scale cancels), the prepared rows for bf16 (rows
    normalised in f32 and rounded to bf16, which the kernel scores as
    they are); its n rows, without the rows ``alive`` (a device bool over
    the n rows) marks False.  A zero row (an Arrow column's null row)
    scores 0, as the package scores a row of norm <= ZERO_NORM."""
    qn = q.double()
    qn = qn / qn.norm(dim=1, keepdim=True)
    rows_all = (corpus._prepared_for(F.Metric.COSINE)[0]
                if corpus.storage == "bf16" else corpus._device)
    best_v, best_i = [], []
    for r0 in range(0, corpus.n, chunk):
        r1 = min(corpus.n, r0 + chunk)
        blk = rows_all[r0:r1]
        if corpus.storage == "int4":
            blk = F.unpack_int4(blk, corpus.dim)
        rows = blk.double()
        if corpus.storage != "bf16":
            norm = rows.norm(dim=1, keepdim=True)
            rows = torch.where(norm > ZERO_NORM, rows / norm, 0.0)
        s = qn @ rows.T
        if alive is not None:
            s[:, ~alive[r0:r1]] = float("-inf")
        v, i = torch.topk(s, k, dim=1)
        best_v.append(v)
        best_i.append(i + r0)
    v, order = torch.sort(torch.cat(best_v, dim=1), dim=1, descending=True,
                          stable=True)
    return (torch.gather(torch.cat(best_i, dim=1), 1, order)[:, :k]
            .cpu().numpy(), v[:, :k].cpu().numpy())


def _library_rows(F, torch, corpus, chunk=1 << 20):
    """The cosine rows the kernel scores, as bf16, for the library
    yardstick: codes times 1/|codes| (int8, int4), the prepared rows
    (bf16)."""
    cp, cbp = corpus._prepared_for(F.Metric.COSINE)
    if corpus.storage == "bf16":
        return cp
    out = torch.empty((corpus.n, corpus.dim), dtype=torch.bfloat16,
                      device="cuda")
    for r0 in range(0, corpus.n, chunk):
        blk = cp[r0:r0 + chunk]
        if corpus.storage == "int4":
            blk = F.unpack_int4(blk, corpus.dim)
        out[r0:r0 + chunk] = (blk.float() * cbp[0, r0:r0 + chunk, None]
                              ).to(torch.bfloat16)
    return out


def _check_wide(F, torch, gen, corpus, q, core, err, tie):
    """Phase 2's kernel checks at the full-width shapes, on the tier's own
    prepared operands.  Returns the number of cases."""
    n = corpus.n
    mask_row = F.pad_mask_row(
        torch.rand((n,), generator=gen, device="cuda") < 0.7, n)
    if tie:   # dot and euclidean are exact in any order: bit for bit
        cases = [(m, 8, k, mk) for m in ("dot", "euclidean")
                 for k in (10, 100) for mk in (None, mask_row)]
    else:
        cases = [("cosine", b, k, mk) for b in (8, 256) for k in (10, 100)
                 for mk in (None, mask_row)]
        cases += [(m, 8, 100, mask_row) for m in ("dot", "euclidean")]
    scales = {}
    for metric, batch, k, mask in cases:
        cp, cbp = corpus._prepared_for(F.Metric.parse(metric))
        qp = F.prepare_queries(q[:batch], metric, core)
        if (metric, batch) not in scales:
            scales[(metric, batch)] = (0.0 if tie else
                                       _term_scale(F, qp, cp, cbp, core))
        _check_kernels(F, qp, cp, cbp, mask, k, core, err,
                       f"{WIDE_ROWS}x{WIDE_DIM} {corpus.storage} b={batch} "
                       f"k={k} {metric} mask={mask is not None} tie={tie}",
                       scale=scales[(metric, batch)], exact=tie)
    return len(cases)


def phase_wide(pmt, F, torch, card, err):
    """Phase 7 (with its phase 5 counts and phase 6 times): the 10M x 768
    corpus in each quantized tier.  Returns each core's kernel entry (at
    batch 8, k=100; its warpgroup consumer's, "<core>.wgmma", at batch
    256) and the launches of the tiers' main paths."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    q = torch.randn((256, WIDE_DIM), generator=gen, device="cuda")
    entries, counts = {}, {"topk_merge": 0}
    for tier, requests in WIDE_REQUESTS.items():
        core = TIER_CORE[tier]
        label = f"{WIDE_ROWS}x{WIDE_DIM} {tier}"
        c = _wide_f32(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        corpus = pmt.Corpus(c, storage=tier)   # quantized on the card
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        f32_top10 = (_oracle_on_card(torch, q[:8], c, 10)[0]
                     if tier == "int8" else None)
        del c
        torch.cuda.empty_cache()
        stored = corpus._device.nbytes + (
            0 if corpus._scales is None else corpus._scales.nbytes)
        print(f"phase 7: {label} corpus built from a CUDA f32 tensor in "
              f"{built:.2f} s host ({stored / 1e9:.2f} GB stored)")

        # The tier's main path: count only its launches.
        F.reset_launch_counts()
        results = {}
        for batch, k in requests:
            t0 = time.perf_counter()
            results[(batch, k)] = corpus.topk(q[:batch], k)
            first = (time.perf_counter() - t0) * 1e3
            print(f"phase 7: {label} batch {batch} k={k}: first request "
                  f"{first:.1f} ms host (corpus prep included on the first)")
        torch.cuda.synchronize()
        launched, cores = dict(F.launches), dict(F.core_launches)
        print(f"phase 5: launches on the {label} path: {launched}, by core "
              f"{cores}")
        require(cores[core] > 0, f"{core} never launched on the {tier} path")
        require(launched["topk_merge"] > 0,
                f"topk_merge never launched on the {tier} path")
        for name in ("fused_topk_plain", "fused_topk_partial_plain",
                     "topk_merge_plain"):
            require(launched[name] == 0, f"{name} ran on the {tier} path")
        # Its batch-256 requests run the warpgroup consumer (query tile 64).
        require(launched["fused_topk_partial_wgmma"] > 0,
                f"the warpgroup consumer never launched on the {tier} path")
        counts[core] = cores[core]
        counts[core + ".wgmma"] = launched["fused_topk_partial_wgmma"]
        counts["topk_merge"] += launched["topk_merge"]

        for (batch, k), (idx, scores) in results.items():
            ref_idx, ref_scores = _oracle_stored(F, torch, corpus, q[:batch],
                                                 k)
            gate(idx, scores, ref_idx, ref_scores, f"{label} batch={batch} "
                 f"k={k}")
            print(f"phase 7: {label} batch {batch} k={k}: passes the float64 "
                  f"oracle gate over the stored rows")
        if f32_top10 is not None:
            idx = results[(8, 10)][0].astype(np.int64)
            recall = np.mean([len(set(a) & set(b)) / 10
                              for a, b in zip(idx, f32_top10)])
            print(f"phase 7: {label} recall@10 against the f32 corpus, batch "
                  f"8: {recall:.4f} (reported, not gated)")

        cases = _check_wide(F, torch, gen, corpus, q, core, err, False)
        print(f"phase 2: {cases} cases at the {label} main path's shapes "
              f"match; max abs err A ({core}) {err[core]:.3g}")

        lib_rows = _library_rows(F, torch, corpus)
        zero = torch.zeros(corpus.n, dtype=torch.bfloat16, device="cuda")
        cp, cbp = corpus._prepared_for(F.Metric.COSINE)
        for batch, k in requests:
            qb = q[:batch]
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                corpus.topk(qb, k)
                ts.append((time.perf_counter() - t0) * 1e3)
            host = statistics.median(ts)
            qp = F.prepare_queries(qb, "cosine", core)
            ab = cuda_ms(lambda: F.fused_select(qp, cp, cbp, None, k, core),
                         reps=5, warmup=1)
            qn = (qb / qb.norm(dim=1, keepdim=True)).to(torch.bfloat16)
            lib = cuda_ms(lambda: torch.topk(torch.addmm(zero, qn,
                                                         lib_rows.T), k,
                                             dim=1), reps=5, warmup=1)
            ops = 2 * 2 * batch * corpus.n * corpus.dim
            bound = _bound(cp.nbytes + cbp.nbytes + qp.nbytes
                           + batch * k * 8, ops, "bfloat16")
            print(f"phase 6: [{card}] {label} batch {batch} k={k}: request "
                  f"{host:.3f} ms host, A+B {ab:.3f} ms device, bound "
                  f"{bound[0]:.3f} ms ({bound[1]}), library torch.addmm + "
                  f"torch.topk on the dequantised bf16 rows {lib:.3f} ms")
            profile_request(torch, lambda: corpus.topk(qb, k),
                            f"{label} batch {batch} k={k}", card, host,
                            ab_ms=ab)
            if tier == "int8":
                tm, splits, tps = F.kernel_geometry(batch, corpus.n, k, core,
                                                    qp.device, dim=corpus.dim)
                _time_gate(F, torch, card, f"{label} batch {batch} k={k} "
                           f"(tm={tm}, splits={splits})",
                           (qp, cp, cbp, None, k, core, splits, tps, tm),
                           _jax_rule(F, corpus.n, corpus.dim, k), reps=5)
                _time_bucket(F, torch, card, f"{label} batch {batch} k={k} "
                             f"(tm={tm}, splits={splits})",
                             (qp, cp, cbp, None, k, core, splits, tps, tm),
                             reps=5)
                if batch == 8:   # tile 64 is the warpgroup consumer's
                    _time_gstack(F, torch, card, f"{label} batch {batch} "
                                 f"k={k} (tm={tm}, splits={splits})",
                                 (qp, cp, cbp, None, k, core, splits, tps,
                                  tm), reps=5)
            if k == 100:
                tm, splits, tps = F.kernel_geometry(batch, corpus.n, k, core,
                                                    qp.device, dim=corpus.dim)
                a = cuda_ms(lambda: F.fused_topk_partial(
                    qp, cp, cbp, None, k, core, splits, tps, tm), reps=5,
                    warmup=1)
                a_plain = cuda_ms(lambda: F.fused_topk_partial_plain(
                    qp, cp, cbp, None, k, core, splits, tps),
                    reps=2 if batch == 8 else 1, warmup=1)
                a_bound = _bound(cp.nbytes + cbp.nbytes + qp.nbytes
                                 + batch * splits * k * 8, ops,
                                 "bfloat16")
                entries[core if batch == 8 else core + ".wgmma"] = _entry(
                    a, a_plain, lib, "torch.addmm + torch.topk on the "
                    "dequantised bf16 rows", a_bound,
                    f"{label} cosine batch {batch} k=100")
                print(f"phase 6: [{card}] {label} batch {batch} k=100: "
                      f"kernel A {a:.3f} ms (tm={tm}, splits={splits}), A "
                      f"plain {a_plain:.3f} ms, bound {a_bound[0]:.3f} ms "
                      f"({a_bound[1]}), library {lib:.3f} ms")
        del lib_rows, zero, cp, cbp, corpus, results
        torch.cuda.empty_cache()

        tie_corpus = _wide_tie_corpus(pmt, F, torch, tier, gen)
        q_tie = torch.randint(-2, 3, (8, WIDE_DIM), generator=gen,
                              device="cuda").float()
        cases = _check_wide(F, torch, gen, tie_corpus, q_tie, core, err,
                            True)
        print(f"phase 2: {cases} integer tie cases at the {label} shapes "
              f"bit-identical, tie order included")
        del tie_corpus
        torch.cuda.empty_cache()
    return entries, counts


def _blobs(torch, gen, rows, dim, chunk=1 << 20):
    """A rows x dim f32 Gaussian blob mixture on the card (CENTRES centres
    times SPREAD plus N(0, 1), as examples/benchmark_clustered.py makes
    it), and a function drawing queries from the same mixture."""
    centres = torch.randn((CENTRES, dim), generator=gen,
                          device="cuda") * SPREAD
    c = torch.empty((rows, dim), device="cuda")
    for r0 in range(0, rows, chunk):
        r1 = min(rows, r0 + chunk)
        label = torch.randint(0, CENTRES, (r1 - r0,), generator=gen,
                              device="cuda")
        c[r0:r1].normal_(generator=gen)
        c[r0:r1] += centres[label]

    def queries(m, g=gen):
        label = torch.randint(0, CENTRES, (m,), generator=g, device="cuda")
        return centres[label] + torch.randn((m, dim), generator=g,
                                            device="cuda")

    return c, queries


def _probe_plan(cc, q, k, probe):
    """What ``ClusteredCorpus.topk(q, k, probe=probe)`` runs: the routed
    query order (or None), the routed queries, the tile lists (None for an
    exhaustive scan) and the query rows per list."""
    import torch
    from polars_matmul_tpu_torch.kernels.fused_topk import probe_block_rows
    from polars_matmul_tpu_torch.ops.cluster import probe_tiles, resolve_probe
    from polars_matmul_tpu_torch.ops.metrics import Metric

    m = q.shape[0]
    br = probe_block_rows(m, cc.dim, cc.config, k)
    order = (cc._route_order(q, Metric.COSINE)
             if probe is not None and m > br else None)
    qr = q if order is None else q[torch.from_numpy(order).to(q.device)]
    p, exhaustive = resolve_probe(probe, cc.n_tiles)
    tiles = None if exhaustive else probe_tiles(
        qr, cc.centroids, cc._tile_cluster_dev, p=p, tm=br,
        metric_v="cosine")
    return order, qr, tiles, br


def _stored_rows(F, cc, pos):
    """float64 rows of the permuted positions ``pos`` as the kernel scores
    them for cosine: codes (int8 / int4; their scale cancels) or values."""
    blk = cc._base[pos]
    if cc.storage == "int4":
        blk = F.unpack_int4(blk, cc.dim)
    return blk.double()


def _oracle_visited(F, torch, cc, qr, k, tiles, br, chunk=250_000):
    """float64 cosine top-k of the routed queries ``qr`` over exactly the
    live rows each list visits (every live row without lists), as
    original row ids: (indices, scores) on the host."""
    perm = cc._perm_dev.long()
    tn = cc.layout.tn
    dead = (None if cc._tombstones is None
            else torch.from_numpy(cc._tombstones).to("cuda"))
    out_i, out_v = [], []
    for b in range(-(-qr.shape[0] // br)):
        qb = qr[b * br:(b + 1) * br].double()
        qb = qb / qb.norm(dim=1, keepdim=True)
        if tiles is None:
            pos = torch.arange(cc.layout.n_padded, device="cuda")
        else:
            pos = (tiles[b].long()[:, None] * tn
                   + torch.arange(tn, device="cuda")).reshape(-1)
        pos = pos[perm[pos] >= 0]
        if dead is not None:   # tombstoned rows never match
            pos = pos[~dead[perm[pos]]]
        best_v, best_i = [], []
        for r0 in range(0, pos.shape[0], chunk):
            p = pos[r0:r0 + chunk]
            rows = _stored_rows(F, cc, p)
            rows = rows / rows.norm(dim=1, keepdim=True)
            v, i = torch.topk(qb @ rows.T, min(k, p.shape[0]), dim=1)
            best_v.append(v)
            best_i.append(p[i])
        v, order = torch.sort(torch.cat(best_v, dim=1), dim=1,
                              descending=True, stable=True)
        out_v.append(v[:, :k])
        out_i.append(perm[torch.gather(torch.cat(best_i, dim=1), 1,
                                       order[:, :k])])
    return (torch.cat(out_i).cpu().numpy(), torch.cat(out_v).cpu().numpy())


def _request_checked(F, torch, cc, q, k, probe, label, phase=8,
                     request=None):
    """One ``ClusteredCorpus.topk`` request (or ``request()``, another
    entry point's (indices, scores) of the same request) held to the
    float64 oracle over the live rows its blocks visited.  Returns
    (indices, scores)."""
    t0 = time.perf_counter()
    idx, scores = (request() if request is not None
                   else cc.topk(q, k, probe=probe))
    host = (time.perf_counter() - t0) * 1e3
    order, qr, tiles, br = _probe_plan(cc, q, k, probe)
    ref_i, ref_v = _oracle_visited(F, torch, cc, qr, k, tiles, br)
    if order is not None:   # back to the caller's row order
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size)
        ref_i, ref_v = ref_i[inv], ref_v[inv]
    gate(idx, scores, ref_i, ref_v, label)
    share = 1.0 if tiles is None else tiles.shape[1] / cc.n_tiles
    print(f"phase {phase}: {label}: passes the float64 oracle gate over the "
          f"{share:.4f} of tiles each of its {-(-q.shape[0] // br)} "
          f"list(s) visited (first request {host:.1f} ms host"
          f"{', routed' if order is not None else ''})")
    return idx, scores


def _listed_operands(F, cc, q, k, probe):
    """The routed queries, prepared operands and tile lists of one probed
    request, as the request hands them to kernel A."""
    from polars_matmul_tpu_torch.ops.metrics import Metric

    _, qr, tiles, br = _probe_plan(cc, q, k, probe)
    core = cc._effective_precision()
    cp, cbp = cc._prepared_for(Metric.COSINE)
    qp = F.prepare_queries(qr, "cosine", core)
    return qr, qp, cp, cbp, core, tiles, br


def _time_probed(F, torch, cc, q, k, card, label):
    """Times of one probed request and its parts: the request (host), the
    probe step, listed kernel A, its plain version, the library yardstick
    (index_select of the listed rows, then torch.addmm + torch.topk per
    list, gather counted) and the bound.  Returns the kernel entry and
    the request's host ms."""
    from polars_matmul_tpu_torch.ops.cluster import probe_tiles
    from polars_matmul_tpu_torch.ops.reference import exact_matmul

    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        cc.topk(q, k, probe=PROBE)
        ts.append((time.perf_counter() - t0) * 1e3)
    host = statistics.median(ts)
    qr, qp, cp, cbp, core, tiles, br = _listed_operands(F, cc, q, k, PROBE)
    m, p, tn = q.shape[0], tiles.shape[1], cc.layout.tn
    probe_ms = cuda_ms(lambda: probe_tiles(
        q, cc.centroids, cc._tile_cluster_dev, p=p, tm=br,
        metric_v="cosine"), reps=10)
    tm = F.listed_tile_rows(m, k, br)
    tm, splits, tps = F.kernel_geometry(m, p * tn, k, core, qp.device, tm,
                                        listed=True,
                                        dim=F._query_dim(qp, core))
    args = (qp, cp, cbp, None, k, core, splits, tps)
    a = cuda_ms(lambda: F.fused_topk_partial(*args, tm, tiles, tn, br),
                reps=10, warmup=2)
    if core == "int8c":
        _time_gate(F, torch, card, f"{label} probe {PROBE} batch {m} k={k} "
                   f"(tm={tm}, splits={splits}, {p} tiles a list)",
                   args + (tm, tiles, tn, br), p >= 16)
    _time_bucket(F, torch, card, f"{label} probe {PROBE} batch {m} k={k} "
                 f"(tm={tm}, splits={splits}, {p} tiles a list)",
                 args + (tm, tiles, tn, br))
    _time_gstack(F, torch, card, f"{label} probe {PROBE} batch {m} k={k} "
                 f"(tm={tm}, splits={splits}, {p} tiles a list)",
                 args + (tm, tiles, tn, br))
    a_plain = cuda_ms(lambda: F.fused_topk_partial_plain(
        *args, tiles, tn, br), reps=3, warmup=1)
    ab = cuda_ms(lambda: F.fused_select(qp, cp, cbp, None, k, core, tiles,
                                        tn, br), reps=10, warmup=2)
    # Library yardstick: the cosine rows the kernel scores, as bf16 (codes
    # times 1/|codes|; f32 rows normalised), gathered per list.
    qn = qr / qr.norm(dim=1, keepdim=True)
    pos = [(tiles[b].long()[:, None] * tn
            + torch.arange(tn, device="cuda")).reshape(-1)
           for b in range(tiles.shape[0])]
    if core in F._QUANT:
        scale = cbp[0]

        def rows_of(b):
            blk = torch.index_select(cp, 0, pos[b])
            if core == "int4c":
                blk = F.unpack_int4(blk, cc.dim)
            return (blk.float() * scale[pos[b], None]).to(torch.bfloat16)
        qn = qn.to(torch.bfloat16)
    else:
        dense = cc._dense_view()
        dense = dense / dense.norm(dim=1, keepdim=True).clamp(min=1e-30)

        def rows_of(b):
            return torch.index_select(dense, 0, pos[b])
    zero = torch.zeros(p * tn, dtype=qn.dtype, device="cuda")

    def library():
        for b in range(tiles.shape[0]):
            with exact_matmul():
                torch.topk(torch.addmm(zero, qn[b * br:(b + 1) * br],
                                       rows_of(b).T), k, dim=1)
    lib = cuda_ms(library, reps=5, warmup=1)
    row_bytes = cp.shape[1] * cp.element_size() + cbp.element_size() * (
        cbp.shape[0] if cbp.ndim == 2 else 1)
    passes, peak = ((1, "float32_cuda_cores") if core == "highest" else
                    (3 if core == "bf16x3" else 2, "bfloat16"))
    bound = _bound(tiles.shape[0] * p * tn * row_bytes + qp.nbytes
                   + m * splits * k * 8,
                   passes * 2 * m * p * tn * cc.dim, peak)
    print(f"phase 6: [{card}] {label} probe {PROBE} batch {m} k={k}: "
          f"request {host:.3f} ms host; probe step {probe_ms:.4f} ms; "
          f"listed A {a:.4f} ms (tm={tm}, splits={splits}, {p} of "
          f"{cc.n_tiles} tiles a list, {tiles.shape[0]} list(s)), A plain "
          f"{a_plain:.3f} ms, A+B {ab:.4f} ms; bound {bound[0]:.4f} ms "
          f"({bound[1]}); library index_select + torch.addmm + torch.topk "
          f"per list {lib:.4f} ms")
    return _entry(a, a_plain, lib,
                  "torch.index_select of the listed rows + torch.addmm + "
                  "torch.topk per list (gather counted)", bound,
                  f"{label} cosine probe {PROBE} batch {m} k={k}"), host


def phase_clustered(pmt, F, torch, card, err):
    """Phase 8 (with its phase 5 counts and phase 6 times): probed search
    through ClusteredCorpus, at the 10M x 768 int8 north star and on a
    2M x 256 f32 corpus whose 1000-query requests route over several tile
    lists.  Returns the listed kernel's entry and the probed path's
    launches."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    c, queries = _blobs(torch, gen, WIDE_ROWS, WIDE_DIM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wide = pmt.ClusteredCorpus(c, storage="int8")
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    del c
    torch.cuda.empty_cache()
    label = f"{WIDE_ROWS}x{WIDE_DIM} int8 clustered"
    print(f"phase 8: {label} built from a CUDA f32 blob mixture "
          f"({CENTRES} centres) in {built:.2f} s host: {wide.clusters} "
          f"clusters, {wide.n_tiles} tiles of {wide.layout.tn} rows, "
          f"{wide._base.nbytes / 1e9:.2f} GB of codes")
    q = queries(256)
    gen2 = torch.Generator(device="cuda")
    gen2.manual_seed(SEED + 2)
    c2, queries2 = _blobs(torch, gen2, BIG_ROWS, DIM)
    proxy = pmt.ClusteredCorpus(c2)
    del c2
    torch.cuda.empty_cache()
    q2 = queries2(N_QUERIES)
    label2 = f"{BIG_ROWS}x{DIM} f32 clustered"
    print(f"phase 8: {label2} built: {proxy.clusters} clusters, "
          f"{proxy.n_tiles} tiles of {proxy.layout.tn} rows")

    # The probed path: count only its launches.
    F.reset_launch_counts()
    results = {}
    for batch, k in CLUSTER_REQUESTS:
        for probe in (PROBE, None):
            results[(batch, k, probe)] = _request_checked(
                F, torch, wide, q[:batch], k, probe,
                f"{label} batch {batch} k={k} probe={probe}")[0]
    for k in (10, 100):
        _request_checked(F, torch, proxy, q2, k, PROBE,
                         f"{label2} batch {N_QUERIES} k={k} probe={PROBE}")
    torch.cuda.synchronize()
    launched, cores = dict(F.launches), dict(F.core_launches)
    print(f"phase 5: launches on the probed path: {launched}, by core "
          f"{cores}")
    for name in ("fused_topk_partial_tiles", "fused_topk_partial_wgmma",
                 "topk_merge"):
        require(launched[name] > 0, f"{name} never launched on the probed "
                f"path")
    for core in ("int8c", "bf16x3"):
        require(cores[core] > 0, f"{core} never launched on the probed path")
    for name in ("fused_topk_plain", "fused_topk_partial_plain",
                 "topk_merge_plain"):
        require(launched[name] == 0, f"{name} ran on the probed path")
    for batch in (8, 256):
        got = results[(batch, 10, PROBE)].astype(np.int64)
        exact = results[(batch, 10, None)].astype(np.int64)
        recall = np.mean([len(set(a) & set(b)) / 10
                          for a, b in zip(got, exact)])
        print(f"phase 8: {label} batch {batch} probe {PROBE}: recall@10 "
              f"against the exhaustive scan {recall:.4f} (reported, not "
              f"gated)")

    # The listed kernel against its plain version at these shapes.
    cases = 0
    for cc, qq, ks in ((wide, q[:8], (10, 100)), (wide, q, (10, 100)),
                       (proxy, q2, (10, 100))):
        for k in ks:
            _, qp, cp, cbp, core, tiles, br = _listed_operands(
                F, cc, qq, k, PROBE)
            _check_listed(F, qp, cp, cbp, None, k, core, tiles,
                          cc.layout.tn, br, err,
                          f"{cc.storage} n={cc.n} batch {qq.shape[0]} k={k}",
                          scale=_term_scale(F, qp, cp, cbp, core))
            cases += 1
    print(f"phase 2: {cases} listed cases at the probed path's shapes "
          f"match; max abs err listed A {err['tiles']:.3g}")

    entry, host = _time_probed(F, torch, wide, q[:8], 10, card, label)
    for batch, k in CLUSTER_REQUESTS[1:]:
        _time_probed(F, torch, wide, q[:batch], k, card, label)
    for k in (10, 100):
        _time_probed(F, torch, proxy, q2, k, card, label2)
    # The listed highest instantiation on the same lists' rows.
    proxy.config = proxy.config.with_updates(precision="highest")
    _, qp, cp, cbp, core, tiles, br = _listed_operands(F, proxy, q2, 10,
                                                       PROBE)
    require(core == "highest", f"the f32 clustered corpus runs {core}")
    _check_listed(F, qp, cp, cbp, None, 10, core, tiles, proxy.layout.tn, br,
                  err, f"f32 n={proxy.n} batch {N_QUERIES} k=10 highest",
                  scale=_term_scale(F, qp, cp, cbp, core))
    del qp, cp, cbp
    _time_probed(F, torch, proxy, q2, 10, card, label2 + " highest")
    for batch in (8, 256):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            wide.topk(q[:batch], 10)
            ts.append((time.perf_counter() - t0) * 1e3)
        print(f"phase 6: [{card}] {label} exhaustive batch {batch} k=10: "
              f"request {statistics.median(ts):.3f} ms host")
    profile_request(torch, lambda: wide.topk(q[:8], 10, probe=PROBE),
                    f"{label} probe {PROBE} batch 8 k=10", card, host)
    del wide, proxy
    torch.cuda.empty_cache()
    return entry, launched["fused_topk_partial_tiles"]


def _check_product(torch, out, q, c, core, what, plain=None):
    """Kernel C's output against a float64 product of the same f32 inputs
    (and, given ``plain``, against its plain version): within ATOL + RTOL
    x the term scale |q_i| |c_j| per element, plus, for bf16x3, SPLIT_RTOL
    x sum_d |q_d c_d| against float64.  Returns the largest absolute
    difference from ``plain`` (0.0 without it)."""
    scale = q.norm(dim=1)[:, None] * c.norm(dim=1)[None, :]
    worst = 0.0
    if plain is not None:
        diff = (out - plain).abs()
        worst = float(diff.max())
        require(bool((diff <= ATOL + RTOL * torch.maximum(plain.abs(), scale)
                      ).all()),
                f"kernel C {core} {what}: differs from its plain version by "
                f"up to {worst}")
        del diff, plain
    qd, cd = q.double(), c.double()
    tol = ATOL + RTOL * scale.double()
    if core == "bf16x3":
        tol += SPLIT_RTOL * (qd.abs() @ cd.abs().T)
    off = (out.double() - qd @ cd.T).abs()
    require(bool((off <= tol).all()), f"kernel C {core} {what}: off the "
            f"float64 product by up to {float(off.max())}")
    return worst


def _check_split(M, torch, q, c, err):
    """The split kernel's buffer equals ``split_pad_plain``'s bit for
    bit (err["mm.split"] stays the largest difference, 0)."""
    got = M.split_pad(q, c)
    want = M.split_pad_plain(q, c).to(got.device)
    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    err["mm.split"] = max(err.get("mm.split", 0.0), float(
        (got.float() - want.float()).abs().max()))
    require(same, f"the split of {tuple(q.shape)} and {tuple(c.shape)} "
            f"differs from split_pad_plain")


def _matmul_main_path(M, torch, q_np, c_np):
    """The main path of kernel C, counted: ``pallas_matmul`` from NumPy at
    the canonical shape in every precision, and on card tensors at the
    large shape in each core, each held to a float64 product.  Returns the
    large shape's operands."""
    M.reset_launch_counts()
    q, c = torch.from_numpy(q_np).cuda(), torch.from_numpy(c_np).cuda()
    for precision in ("highest", "bf16x3", "default", "high", "bf16c"):
        out = M.pallas_matmul(q_np, c_np, precision=precision)
        require(out.is_cuda and out.dtype == torch.float32
                and tuple(out.shape) == (N_QUERIES, N_CORPUS),
                f"pallas_matmul from NumPy ({precision}): {out.device} "
                f"{out.dtype} {tuple(out.shape)}")
        _check_product(torch, out, q, c, M._CORE[precision],
                       f"canonical {precision} from NumPy")
    m, n, dim = MM_SHAPES[1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    ql = torch.randn((m, dim), generator=gen, device="cuda")
    cl = torch.randn((n, dim), generator=gen, device="cuda")
    for core in M.CORES:
        out = M.pallas_matmul(ql, cl, precision=core)
        _check_product(torch, out, ql, cl, core, f"{m}x{n}x{dim}")
        del out
        torch.cuda.empty_cache()
    mf = MM_FEW[0]
    for core in M.CORES:
        out = M.pallas_matmul(ql[:mf], cl, precision=core)
        _check_product(torch, out, ql[:mf], cl, core, f"{mf}x{n}x{dim}")
        del out
    torch.cuda.synchronize()
    counts, bodies = dict(M.launches), dict(M.body_launches)
    cores, split = dict(M.core_launches), dict(M.split_launches)
    print(f"phase 5: launches on the pallas_matmul path: {counts}, by core "
          f"{cores}, by body {bodies}, the split {split}")
    for body in M.BODIES:
        require(bodies[body] > 0, f"kernel C's {body} body never launched")
    require(counts["pallas_matmul_plain"] == 0,
            "pallas_matmul_plain ran on the pallas_matmul path")
    require(split["split_pad"] == bodies["wgmma"]
            and split["split_pad_plain"] == 0,
            f"the bf16x3 core's split ran {split}, not once a wgmma product")
    launched = {"highest": bodies["ffma"], "bf16x3": bodies["wgmma"],
                "bf16x3_mma": bodies["mma"], "split": split["split_pad"]}
    print(f"phase 9: pallas_matmul from NumPy at {N_QUERIES}x{N_CORPUS}x{DIM} "
          f"(precision highest, bf16x3, default, high, bf16c) and on card "
          f"tensors at {m}x{n}x{dim} and {mf}x{n}x{dim} (each core) pass the "
          f"float64 product")
    return launched, ql, cl


def _mm_key(M, m, n, dim, core):
    """The ``err`` key of kernel C's body at (m, n, dim) in ``core``: as
    the kernels line names it."""
    mma = core == "bf16x3" and M.launch_plan(m, n, dim, core)["body"] == "mma"
    return f"mm.{core}_mma" if mma else f"mm.{core}"


def _compare_matmul(M, torch, large, err):
    """Kernel C against its plain version and float64 over ragged shapes,
    f64 inputs once, and at the main path's shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    cases, bodies = 0, set()
    for m in MM_MS:
        for n in MM_NS:
            for dim in MM_DIMS:
                q = torch.randn((m, dim), generator=gen, device="cuda")
                c = torch.randn((n, dim), generator=gen, device="cuda")
                _check_split(M, torch, q, c, err)
                for core in M.CORES:
                    out = M.pallas_matmul(q, c, precision=core)
                    key = _mm_key(M, m, n, dim, core)
                    err[key] = max(err[key], _check_product(
                        torch, out, q, c, core, f"m={m} n={n} dim={dim}",
                        plain=M.pallas_matmul_plain(q, c, core)))
                    bodies.add(M.launch_plan(m, n, dim, core)["body"])
                    cases += 1
    require(bodies == set(M.BODIES), f"the ragged cases ran kernel C's "
            f"bodies {sorted(bodies)}, not all of {M.BODIES}")
    q64 = torch.randn((300, 300), generator=gen, device="cuda",
                      dtype=torch.float64)
    c64 = torch.randn((129, 300), generator=gen, device="cuda",
                      dtype=torch.float64)
    out = M.pallas_matmul(q64, c64)
    require(out.dtype == torch.float64, f"f64 inputs gave {out.dtype}")
    off = float((out - q64 @ c64.T).abs().max())
    scale = q64.norm(dim=1)[:, None] * c64.norm(dim=1)[None, :]
    require(bool(((out - q64 @ c64.T).abs() <= ATOL + RTOL * scale).all()),
            f"f64 inputs: off the float64 product by {off}")
    for m, n, dim in MM_SHAPES + (MM_FEW,):
        if (m, n, dim) == MM_SHAPES[1]:
            q, c = large
        elif (m, n, dim) == MM_FEW:
            q, c = large[0][:m], large[1]
        else:
            q = torch.randn((m, dim), generator=gen, device="cuda")
            c = torch.randn((n, dim), generator=gen, device="cuda")
        _check_split(M, torch, q, c, err)
        for core in M.CORES:
            print(f"phase 9: kernel C {core} at {m}x{n}x{dim}: "
                  f"{M.launch_plan(m, n, dim, core)}")
            out = M.pallas_matmul(q, c, precision=core)
            key = _mm_key(M, m, n, dim, core)
            err[key] = max(err[key], _check_product(
                torch, out, q, c, core, f"{m}x{n}x{dim}",
                plain=M.pallas_matmul_plain(q, c, core)))
            del out
            torch.cuda.empty_cache()
            cases += 1
    torch.cuda.synchronize()
    print(f"phase 9: kernel C matches its plain version (atol {ATOL} + rtol "
          f"{RTOL} x max(|value|, |q_i| |c_j|)) and the float64 product "
          f"(bf16x3 also + {SPLIT_RTOL:.3g} x sum_d |q_d c_d|) in {cases} "
          f"cases, both cores: ragged m {MM_MS}, n {MM_NS}, dim {MM_DIMS} "
          f"and the shapes {MM_SHAPES + (MM_FEW,)}; f64 inputs give f64 "
          f"within {off:.3g} of the float64 product; max abs err against "
          f"plain highest {err['mm.highest']:.3g}, bf16x3 wgmma "
          f"{err['mm.bf16x3']:.3g}, mma {err['mm.bf16x3_mma']:.3g}; "
          f"the split kernel equals its plain version bit for bit in every "
          f"case")


def _time_matmul(M, torch, large, card):
    """CUDA-event times of kernel C (batches of 8 calls between events,
    ``tools.median_ms``: the clock the card holds under sustained load),
    its plain version and torch.matmul f32 (TF32 off: the library
    yardstick, never called by the port) at the main path's shapes,
    beside the bound.  Returns the entries: each core's at the canonical
    shape, the mma body's at MM_FEW."""
    from polars_matmul_tpu_torch.ops.reference import exact_matmul
    from polars_matmul_tpu_torch.tools import median_ms
    from polars_matmul_tpu_torch.utils import profiling as P

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    entries = {}
    for m, n, dim in MM_SHAPES + (MM_FEW,):
        if (m, n, dim) == MM_SHAPES[1]:
            (q, c), iters = large, 5
        elif (m, n, dim) == MM_FEW:
            q, c, iters = large[0][:m], large[1], 10
        else:
            q = torch.randn((m, dim), generator=gen, device="cuda")
            c = torch.randn((n, dim), generator=gen, device="cuda")
            iters = 20

        def library():
            with exact_matmul():
                return torch.matmul(q, c.T)

        lib = median_ms(library, iters)
        nbytes = (m * dim + n * dim + m * n) * 4
        flops = 2 * m * n * dim
        for core in M.CORES:
            ms = median_ms(lambda: M.pallas_matmul(q, c, precision=core),
                           iters)
            plain = P.benchmark(lambda: M.pallas_matmul_plain(q, c, core),
                                warmup=1, iters=max(3, iters // 4)
                                )["median_ms"]
            if core == "highest":
                bound = _bound(nbytes, flops, "float32_cuda_cores")
                roof = P.roofline(flops, ms / 1e3, "float32_cuda_cores")
            else:
                bound = _bound(nbytes, 3 * flops, "bfloat16")
                roof = P.roofline(flops, ms / 1e3, "float32")
            shape = f"{m}x{n}x{dim}"
            print(f"phase 9: [{card}] pallas_matmul {core} {shape}: kernel C "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, torch.matmul f32 "
                  f"{lib:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}); "
                  f"{roof['achieved_gflops'] / 1e3:.1f} TFLOP/s, "
                  f"{100 * roof['fraction_of_peak']:.1f} % of the "
                  f"{roof['peak_tflops']:.1f} TFLOP/s roofline")
            entry = _entry(ms, plain, lib, "torch.matmul f32 (TF32 off)",
                           bound, shape)
            if (m, n, dim) == MM_SHAPES[0]:
                entries[core] = entry
            elif (m, n, dim) == MM_FEW and core == "bf16x3":
                entries["bf16x3_mma"] = entry
        if (m, n, dim) != MM_FEW:
            split = _time_split(M, torch, q, c, iters, card)
            if (m, n, dim) == MM_SHAPES[0]:
                entries["split"] = split
        del q, c
        torch.cuda.empty_cache()
    return entries


def _time_split(M, torch, q, c, iters, card):
    """The split kernel's CUDA-event time beside its plain version and its
    byte bound; then the yardstick the port never calls: cuBLAS's rate for
    one bf16 product of the split hi halves (f32 out).  Returns the split's
    entry."""
    from polars_matmul_tpu_torch.tools import median_ms
    from polars_matmul_tpu_torch.utils import profiling as P

    (m, dim), n = q.shape, c.shape[0]
    dp = M.padded_dim(dim)
    ms = median_ms(lambda: M.split_pad(q, c), iters)
    plain = P.benchmark(lambda: M.split_pad_plain(q, c), warmup=1,
                        iters=max(3, iters // 4))["median_ms"]
    bound = _bound((m + n) * (dim * 4 + 2 * dp * 2), 0, "bfloat16")
    shape = f"{m}x{n}x{dim}"
    print(f"phase 9: [{card}] kernel C's split {shape} -> ({m + n}, "
          f"{2 * dp}) bf16: {ms:.4f} ms, plain {plain:.4f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    buf = M.split_pad(q, c)
    qh, ch = buf[:m, :dp], buf[m:, :dp]

    def yardstick():
        try:
            return torch.ops.aten.mm.dtype(qh, ch.t(), torch.float32)
        except (RuntimeError, TypeError):
            return torch.mm(qh, ch.t())

    how = "aten.mm.dtype(bf16, bf16 -> f32)"
    try:
        yardstick()
    except (RuntimeError, TypeError):
        how = "torch.mm bf16"
    t = P.benchmark(yardstick, iters=iters)["median_ms"]
    peak = P.device_peak_tflops("bfloat16")
    rate = 2 * m * n * dp / (t / 1e3) / 1e12
    print(f"phase 9: [{card}] yardstick, not called by the port: cuBLAS "
          f"{how} of the split hi halves {m}x{n}x{dp}: {t:.4f} ms, "
          f"{rate:.1f} TFLOP/s, {100 * rate / peak:.1f} % of the {peak:.0f} "
          f"TFLOP/s bf16 peak")
    del buf, qh, ch
    return _entry(ms, plain, None, None, bound, shape)


def _autotune_on_card(pmt, F, torch, q_np, c_np, card):
    """``autotune`` at the canonical shape: every candidate's time, the
    distinct launches it measured, the winner persisted in this run's
    PMM_TPU_CACHE_DIR and served from there without measuring, and an
    all-defaults ``topk_torch`` dispatching with the winner's fields, held
    to the float64 oracle."""
    from polars_matmul_tpu_torch.utils import autotune as A

    measured = []
    timer = A.device_step_seconds

    def counting(step, q, **kw):
        measured.append(q.shape)
        return timer(step, q, **kw)

    A.device_step_seconds = counting
    t0 = time.perf_counter()
    win = pmt.autotune(N_QUERIES, N_CORPUS, DIM, 10, "cosine", verbose=True)
    took = time.perf_counter() - t0
    launches = len(measured)
    cores = {F.kernel_precision(p) for p in (
        pmt.default_config().precision, "highest")}
    require(launches == len(cores),
            f"autotune measured {launches} launches; the grid has "
            f"{len(cores)} distinct ones")
    path = Path(A._cache_path())
    require(path.parent == Path(os.environ["PMM_TPU_CACHE_DIR"])
            and path.is_file(), f"no winner persisted at {path}")
    key = [A._device_kind(), DIM, A._k_regime(10), A._n_regime(N_CORPUS),
           "cosine", pmt.default_config().precision]
    saved = json.loads(path.read_text())
    require(json.dumps(key) in saved, f"{path} lacks the key {key}")
    # A fresh process's view: the in-memory winners dropped, the file read.
    A._WINNER_CACHE.clear()
    A._DISK_LOADED[0] = False
    again = pmt.autotune(N_QUERIES, N_CORPUS, DIM, 10, "cosine")
    A.device_step_seconds = timer
    require(again == win and len(measured) == launches,
            "the second autotune call measured again or changed the winner")
    print(f"phase 9: [{card}] autotune {N_QUERIES}x{N_CORPUS}x{DIM} cosine "
          f"k=10: {launches} distinct launches measured for the grid "
          f"({took:.2f} s), winner "
          f"{ {f: getattr(win, f) for f in A._CFG_FIELDS} } persisted in "
          f"{path} as {saved[json.dumps(key)]}; a second call (winners "
          f"reloaded from the file) measured nothing")

    seen = {}
    prepared = F.fused_topk_prepared

    def spy(*args, **kw):
        seen.update(kw)
        return prepared(*args, **kw)

    F.fused_topk_prepared = spy
    F.reset_launch_counts()
    q, c = torch.from_numpy(q_np).cuda(), torch.from_numpy(c_np).cuda()
    vals, idx = pmt.topk_torch(q, c, 10, "cosine")
    torch.cuda.synchronize()
    F.fused_topk_prepared = prepared
    cfg = seen["config"]
    for f in A._CFG_FIELDS:
        require(getattr(cfg, f) == getattr(win, f),
                f"all-defaults topk_torch ran {f}={getattr(cfg, f)!r}, the "
                f"winner has {getattr(win, f)!r}")
    core = F.kernel_precision(win.precision)
    require(F.core_launches[core] > 0,
            f"all-defaults topk_torch did not launch kernel A's {core} core")
    ref_idx, ref_scores = numpy_oracle(q_np, c_np, 10)
    gate(idx.cpu().numpy(), vals.cpu().numpy().astype(np.float64), ref_idx,
         ref_scores, "topk_torch with the autotune winner")
    print(f"phase 9: an all-defaults topk_torch dispatched with the winner's "
          f"fields (kernel A {core} core: {F.core_launches[core]} launch) "
          f"and passes the float64 oracle gate")


# Explicit selections outside their envelope: (what, selection, k, rows,
# dim, extra config, probe, start of the JAX package's message).
ENVELOPES = (
    ("bucket above k=128", "bucket", 200, 5000, 64, {}, None,
     "selection='bucket' supports k <= 128"),
    ("gpop above k=16", "gpop", 20, 500, 64, {}, None,
     "selection='gpop' requires a dense (non-probed) scan"),
    ("gpop past 128 groups", "gpop", 10, 20_000, 64, {}, None,
     "selection='gpop' requires a dense (non-probed) scan"),
    ("gstack on 3-group tiles", "gstack", 20, 20_000, 64,
     {"block_n": 384, "block_q": 8}, None,
     "selection='gstack' requires k <= 1024"),
    ("gpop probed", "gpop", 5, 20_000, 64, {}, 0.5,
     "selection='gpop' requires a dense (non-probed) scan"),
)


def _envelopes_on_card(pmt, torch, card):
    """Each explicit selection outside its envelope raises the JAX
    package's ValueError on CUDA tensors, dense and probed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    for what, selection, k, rows, dim, extra, probe, msg in ENVELOPES:
        cfg = pmt.SearchConfig(selection=selection, **extra)
        c = torch.randn((rows, dim), generator=gen, device="cuda")
        q = torch.randn((8, dim), generator=gen, device="cuda")
        try:
            if probe is None:
                pmt.topk_torch(q, c, k, "cosine", config=cfg)
            else:
                pmt.ClusteredCorpus(c, config=cfg).topk(q, k, probe=probe)
        except ValueError as e:
            require(str(e).startswith(msg)
                    and ("(probed)" in str(e)) == (probe is not None),
                    f"{what}: raised {e!r}")
        else:
            raise RuntimeError(f"{what}: selection={selection!r} did not "
                               f"raise")
    print(f"phase 9: [{card}] {len(ENVELOPES)} explicit selections outside "
          f"their envelope raise the JAX package's ValueError on CUDA "
          f"tensors ({', '.join(e[0] for e in ENVELOPES)})")


def phase_matmul(pmt, F, torch, q_np, c_np, card):
    """Phase 9 (with its phase 5 counts): kernel C's main path, its checks
    and times, autotune on the card, and the selection envelopes.  Returns
    kernel C's JSON entries."""
    from polars_matmul_tpu_torch.kernels import matmul as M

    t0 = time.perf_counter()
    cores, ql, cl = _matmul_main_path(M, torch, q_np, c_np)
    err = {f"mm.{key}": 0.0 for key in cores}
    _compare_matmul(M, torch, (ql, cl), err)
    times = _time_matmul(M, torch, (ql, cl), card)
    del ql, cl
    torch.cuda.empty_cache()
    _autotune_on_card(pmt, F, torch, q_np, c_np, card)
    _envelopes_on_card(pmt, torch, card)
    print(f"phase 9: took {time.perf_counter() - t0:.1f} s host")
    return [dict({"name": f"pallas_matmul.{core}", "route": "cuda",
                  "source": KERNEL_SRC + "matmul.cu", "replaces": MM_SRC,
                  "launches": cores[core], "max_abs_err": err[f"mm.{core}"]},
                 **times[core]) for core in cores]


# Kernel D (phase 10): ragged shapes (m, n, dim, tn, kernel A's k for the
# geometry); dim 56 and 300 take the element-wise int4 loads, 300 every
# core's, and 40,000 rows span three 16,384-row segments (and too many
# groups for global ids, which must raise).
FLOOR_SHAPES = ((1, 129, 56, 128, 10), (37, 5000, 300, 256, 100),
                (300, 5000, 768, 1024, 10), (64, 40_000, 256, 2048, 512))
FLOOR_LEVELS = (0, 1, 4, 5)
FLOOR_SRC = ("tools/exp_floor.py:55 (_kernel_ab), tools/exp_b256.py:94 "
             "(_kernel_build), tools/exp_int4.py:82 (_kernel_mm)")
# Each packed value drops its score's low 7 bits (2^-16 of it): two
# scores within tolerance may land one 128-ulp step apart.
PACK_RTOL = 2.0 ** -15


def _floor_operands(D, F, torch, q, c, core, gen, tie):
    """Kernel D's operands of ``core`` from f32 rows: queries [hi | lo];
    a bias row (bf16x3) or scale | bias rows (integers and scale 1 on tie
    data, so that every score is exact)."""
    from polars_matmul_tpu_torch.tools import exp_int4

    n = c.shape[0]
    qp = F.split_hi_lo(q)
    bias = (torch.randint(-3, 4, (n,), generator=gen, device="cuda").float()
            if tie else 0.1 * torch.randn((n,), generator=gen,
                                          device="cuda"))
    if core == "bf16x3":
        return qp, F.split_hi_lo(c), bias[None].contiguous()
    if core == "int8c":
        cp, scale = (c.to(torch.int8), None) if tie else F.quantize_int8(c)
    else:
        cp, scale = exp_int4._host_quantize_int4(c)
        if core == "int4-rint":   # any byte on real data: rint's ties too
            cp = (D.repack_int4_rint(cp) if tie else torch.randint(
                -128, 128, cp.shape, generator=gen, device="cuda",
                dtype=torch.int8))
    if tie:
        scale = torch.ones(n, device="cuda")
    return qp, cp, torch.stack([scale, bias]).contiguous()


def _floor_scale(D, qp, cp, cb, core):
    """Row term scale of kernel D's scores (see RTOL): |q_i| times the
    largest decoded corpus row (times its scale), plus the largest
    |bias|."""
    dim = qp.shape[1] // 2
    if core == "bf16x3":
        rows = cp[:, :dim].float() + cp[:, dim:].float()
        norms, bias = rows.norm(dim=1), cb[0]
    else:
        norms = D._decoded_corpus(cp, core).norm(dim=1) * cb[0].abs()
        bias = cb[1]
    qf = qp[:, :dim].float() + qp[:, dim:].float()
    return qf.norm(dim=1) * norms.max() + bias.abs().max()


def _check_floor(D, torch, qp, cp, cb, core, levels, tn, ids, posu, k, err,
                 what, exact):
    """Kernel D against its plain version at its own geometry: every
    split's every level and the output; bit for bit on tie data, else
    decoded scores within ATOL + RTOL x max(|score|, row term scale) +
    PACK_RTOL x |score|, group ids equal wherever a value stands clear of
    its neighbours, and levels=0 sums off only by tiles whose max lies
    within that tolerance of an integer."""
    m, n = qp.shape[0], cp.shape[0]
    geo = D.floor_geometry(m, n, core, levels, k, qp.device,
                           dim=qp.shape[1] // 2)
    out, lv = D.floor_stacks(qp, cp, cb, core=core, levels=levels, tn=tn,
                             ids=ids, posu=posu, k_geometry=k)
    out_p, lv_p = D.floor_stacks_plain(
        qp, cp, cb, core=core, levels=levels, tn=tn, ids=ids, posu=posu,
        splits=geo[1], tiles_per_split=geo[2])
    require(out.shape == out_p.shape and lv.shape == lv_p.shape,
            f"kernel D {what}: shapes {tuple(out.shape)} {tuple(lv.shape)}")
    if exact:
        require(torch.equal(out, out_p) and torch.equal(lv, lv_p),
                f"kernel D {what}: differs from its plain version on tie "
                f"data")
        return
    scale = _floor_scale(D, qp, cp, cb, core)
    if levels == 0:   # the tile maxima, then their truncated sum
        a = D.decode_ordered(lv).double()
        b = D.decode_ordered(lv_p).double()
        tol = ATOL + RTOL * torch.maximum(b.abs(), scale[:, None])
        worst = float((a - b).abs().max())
        require(bool(((a - b).abs() <= tol).all()),
                f"kernel D {what}: tile maxima differ by up to {worst}")
        near = ((b - b.round()).abs() <= tol).sum(dim=1, keepdim=True)
        require(bool(((out.long() - out_p.long()).abs() <= near).all()),
                f"kernel D {what}: sums differ beyond near-integer maxima")
        err[core] = max(err[core], worst)
        return
    empty = lv_p == D.INT32_MIN
    require(torch.equal(lv == D.INT32_MIN, empty),
            f"kernel D {what}: unfilled levels differ")
    # Equal packed values need no decoding (a packed -inf decodes to NaN).
    same = lv == lv_p
    zero = torch.zeros((), dtype=torch.float64, device="cuda")
    a = torch.where(same, zero, D.decode_packed(lv, posu).double())
    b = torch.where(empty, zero, D.decode_packed(lv_p, posu).double())
    tol = (ATOL + RTOL * torch.maximum(b.abs(), scale[:, None, None, None])
           + PACK_RTOL * b.abs())
    diff = torch.where(same, zero, (a - b).abs())
    worst = float(diff.max())
    require(bool((same | (diff <= tol)).all()),
            f"kernel D {what}: levels differ by up to {worst}")
    # A value clear of its neighbours in the cell keeps its group id; the
    # plain version one level deeper gives the candidate below the last.
    ext = torch.cat([lv_p, D.floor_stacks_plain(
        qp, cp, cb, core=core, levels=levels + 1, tn=tn, ids=ids, posu=posu,
        splits=geo[1], tiles_per_split=geo[2])[1][:, :, levels:]], dim=2)
    bx = D.decode_packed(ext, posu).double()
    step = (bx[:, :, 1:] - bx[:, :, :-1]).abs()
    step = torch.where(ext[:, :, 1:] == D.INT32_MIN, float("inf"), step)
    gap = step.clone()
    gap[:, :, 1:] = torch.minimum(step[:, :, 1:], step[:, :, :-1])
    clear = (gap > 2 * tol) & ~empty
    require(torch.equal((lv & 127)[clear], (lv_p & 127)[clear]),
            f"kernel D {what}: group ids differ")
    # The output is level 0 of the splits that reach it.
    seg = D.segment_rows(tn)
    last = torch.clamp(torch.arange(1, geo[1] + 1, device="cuda") * geo[2]
                       * 64, max=n) - 1
    reach = (last // seg == (n - 1) // seg) if ids == "segmented" else (
        torch.ones_like(last, dtype=torch.bool))
    top = torch.where(reach[None, :, None], lv[:, :, 0],
                      torch.full_like(lv[:, :, 0], D.INT32_MIN)).amax(dim=1)
    require(torch.equal(out, top), f"kernel D {what}: out is not level 0 of "
            f"its splits")
    err[core] = max(err[core], worst)


def _compare_floor(D, F, torch, err):
    """Phase 10's checks: kernel D in every core, at levels 0, 1, 4, 5,
    every id rule and posu setting, over FLOOR_SHAPES, on real data and on
    integer tie data.  On real data posu runs on non-negative scores only:
    posu orders negative scores by their raw bits, so a score that rounds
    to the other side of zero could move a level far.  Returns (cases,
    tie cases)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    cases = ties = 0
    for m, n, dim, tn, k in FLOOR_SHAPES:
        for tie in (False, True):
            if tie and n > 5000:
                continue
            for nonneg in (False, True):
                if tie:
                    q = torch.randint(-2, 3, (m, dim), generator=gen,
                                      device="cuda").float()
                    c = torch.randint(-2, 3, (n, dim), generator=gen,
                                      device="cuda").float()
                else:
                    q = torch.randn((m, dim), generator=gen, device="cuda")
                    c = torch.randn((n, dim), generator=gen, device="cuda")
                if nonneg:
                    q, c = q.abs(), c.abs()
                for core in D.CORES:
                    qp, cp, cb = _floor_operands(D, F, torch, q, c, core,
                                                 gen, tie)
                    for levels in FLOOR_LEVELS:
                        for ids in D.IDS:
                            for posu in (False, True):
                                if ((posu != nonneg and not tie) or (
                                        levels == 0 and (ids, posu) != (
                                            "global", False))):
                                    continue   # see the docstring
                                what = (f"m={m} n={n} dim={dim} tn={tn} "
                                        f"{core} L{levels} {ids} posu={posu} "
                                        f"tie={tie}")
                                if (levels and ids == "global"
                                        and -(-n // 128) > 128):
                                    try:
                                        D.floor_stacks(qp, cp, cb, core=core,
                                                       levels=levels, tn=tn,
                                                       ids=ids)
                                    except ValueError:
                                        continue
                                    raise RuntimeError(
                                        f"{what}: global ids past 128 groups "
                                        f"did not raise")
                                _check_floor(D, torch, qp, cp, cb, core,
                                             levels, tn, ids, posu, k, err,
                                             what, tie)
                                if tie:
                                    ties += 1
                                else:
                                    cases += 1
    torch.cuda.synchronize()
    return cases, ties


# Kernel D at query tile 64 (the warpgroup consumer for its stored cores):
# (m, n, dim, tn, k) with 33, 65 and 300 queries, n not a whole number of
# 256-row steps (18, 21 and 11 kernel tiles), a dim that takes the
# element-wise loads (100); FLOOR_WG_RESET's segments (tn 640: a restart
# every 16,000 rows) restart inside a step of some split, its n found for
# this card's geometry.  Levels 0, 1 (in registers), 2 (in shared memory,
# two scores a load) and 3, the deepest that keeps the warpgroup consumer
# in every stored core.
FLOOR_WG_SHAPES = ((33, 1100, 100, 128, 10), (65, 1300, 256, 256, 100),
                   (300, 700, 768, 128, 10))
FLOOR_WG_RESET = (65, 64, 640, 10)
FLOOR_WG_LEVELS = (0, 1, 2, 3)
FLOOR_STORED = ("int8c", "int4c", "int4-rint", "int4-raw")
# Kernel D's bf16x3 core on kernel A's ring against the per-tile staging
# the parent ran (PER_TILE_CU): (m, n, dim, tn, k) at query tiles 16 (m 9,
# and k=512), 32 (m 20) and 64 (m 65, 300), both ring forms, dims 256,
# 300 (not a multiple of a position) and 768.
FLOOR_BITS_SHAPES = ((9, 1300, 256, 128, 10), (20, 700, 300, 256, 100),
                     (65, 1100, 256, 128, 10), (300, 5000, 768, 1024, 10),
                     (64, 40_000, 256, 2048, 512))


def _floor_plans(D, torch):
    """Kernel D's launch plans from the source (``pmm_floor_plan``) against
    the host mirror (``floor.floor_plan``) at every query tile and core, a
    spread of levels and dims.  Returns the cases."""
    import ctypes

    from polars_matmul_tpu_torch.kernels._build import load_library

    lib = load_library()
    cases = 0
    for tm in (16, 32, 64):
        for core in D.CORES:
            for levels in (0, 1, 2, 3, 4, 5, 8, 16):
                for dim in (56, 256, 300, 768):
                    got = (ctypes.c_int * 7)()
                    rc = lib.pmm_floor_plan(tm, D._CORE_ENUM[core], levels,
                                            D.corpus_width(core, dim), got)
                    want = D.floor_plan(tm, core, levels, dim)
                    what = f"tm={tm} {core} L{levels} dim {dim}"
                    if rc != 0:
                        require(want[2] == 0, f"kernel D's plan {what}: the "
                                f"source fits none, the host {want}")
                        continue
                    got = (D.CONSUMERS[got[0]], FLOOR_CORES[got[1]], got[2],
                           got[3], bool(got[4]), got[5], got[6])
                    require(got == want, f"kernel D's plan {what}: source "
                            f"{got}, host {want}")
                    cases += 1
    return cases


def _midstep_rows(D, F, torch, core, levels, m, dim, tn, k):
    """Corpus rows at which kernel D's segmented stacks restart inside a
    wgmma step of some split at this card's geometry (None where the
    launch takes no wgmma step)."""
    seg = D.segment_rows(tn)
    for n in range(seg + 500, 4 * seg, 500):
        tm, _, tps = D.floor_geometry(m, n, core, levels, k,
                                      torch.device("cuda"), dim=dim)
        if D.floor_consumer(tm, core, levels) != "wgmma":
            return None
        for b in range(seg // 64, -(-n // 64), seg // 64):
            t0 = b // tps * tps
            if t0 < b and (b - t0) % F.WG_TILES:
                return n
    return None


def _compare_floor_wgmma(D, F, torch, err):
    """Kernel D's stored cores at query tile 64 against the plain version:
    FLOOR_WG_SHAPES in every stored core at FLOOR_WG_LEVELS, every id rule,
    posu on tie data, real data within _check_floor's tolerance and
    integer tie data bit for bit; then each (core, levels) that takes the
    warpgroup consumer with a segment restarting inside a step.  Requires
    the warpgroup consumer at levels 0-3 in every stored core.  Returns
    (cases, tie cases, mid-step resets)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    runs = [(shape, FLOOR_STORED, FLOOR_WG_LEVELS) for shape in
            FLOOR_WG_SHAPES]
    m, dim, tn, k = FLOOR_WG_RESET
    midstep = 0
    for core in FLOOR_STORED:
        for levels in FLOOR_WG_LEVELS[1:]:
            n = _midstep_rows(D, F, torch, core, levels, m, dim, tn, k)
            if n is not None:
                runs.append(((m, n, dim, tn, k), (core,), (levels,)))
                midstep += 1
    cases = ties = 0
    wg = set()
    for (m, n, dim, tn, k), cores, levels_set in runs:
        for tie in (False, True):
            if tie:
                q = torch.randint(-2, 3, (m, dim), generator=gen,
                                  device="cuda").float()
                c = torch.randint(-2, 3, (n, dim), generator=gen,
                                  device="cuda").float()
            else:
                q = torch.randn((m, dim), generator=gen, device="cuda")
                c = torch.randn((n, dim), generator=gen, device="cuda")
            for core in cores:
                qp, cp, cb = _floor_operands(D, F, torch, q, c, core, gen,
                                             tie)
                for levels in levels_set:
                    tm = D.floor_geometry(m, n, core, levels, k, dev,
                                          dim=dim)[0]
                    if D.floor_consumer(tm, core, levels) == "wgmma":
                        wg.add((core, levels))
                    for ids in D.IDS:
                        for posu in (False, True):
                            if ((posu and not tie) or (levels == 0 and (
                                    ids, posu) != ("global", False)) or (
                                    levels and ids == "global"
                                    and -(-n // 128) > 128)):
                                continue
                            _check_floor(
                                D, torch, qp, cp, cb, core, levels, tn, ids,
                                posu, k, err, f"tile 64: m={m} n={n} dim={dim}"
                                f" tn={tn} {core} L{levels} {ids} posu={posu}"
                                f" tie={tie}", tie)
                            if tie:
                                ties += 1
                            else:
                                cases += 1
    torch.cuda.synchronize()
    want = {(core, levels) for core in FLOOR_STORED
            for levels in FLOOR_WG_LEVELS}
    require(want <= wg, f"kernel D took the warpgroup consumer only at "
            f"{sorted(wg)}")
    require(midstep >= len(want) - len(FLOOR_STORED), f"kernel D: only "
            f"{midstep} segment restarts inside a wgmma step")
    return cases, ties, midstep


def _floor_ring_bits(D, F, torch):
    """Kernel D's bf16x3 core (kernel A's ring) against the per-tile
    staging the parent ran: every split's levels and out from the
    per-tile scores (``floor.stacks_of_scores``), bit for bit, over
    FLOOR_BITS_SHAPES at levels 0, 1, 2, 5 and every id rule.  Requires
    both ring forms.  Returns the cases."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 10)
    cases, forms = 0, set()
    for m, n, dim, tn, k in FLOOR_BITS_SHAPES:
        q = torch.randn((m, dim), generator=gen, device="cuda")
        c = torch.randn((n, dim), generator=gen, device="cuda")
        qp, cp, cb = _floor_operands(D, F, torch, q, c, "bf16x3", gen, False)
        ref = _per_tile_scores(torch, qp, cp, cb[0])
        for levels in (0, 1, 2, 5):
            for ids in D.IDS:
                if ((levels == 0 and ids != "global")
                        or (levels and ids == "global" and -(-n // 128) > 128)):
                    continue
                tm, splits, tps = D.floor_geometry(m, n, "bf16x3", levels, k,
                                                   dev, dim=dim)
                forms.add(D.floor_plan(tm, "bf16x3", levels, dim)[1])
                out, lv = D.floor_stacks(qp, cp, cb, core="bf16x3",
                                         levels=levels, tn=tn, ids=ids,
                                         k_geometry=k)
                want = D.stacks_of_scores(
                    lambda c0, c1: ref[:, c0:c1], m, n, n, levels=levels,
                    tn=tn, ids=ids, splits=splits, tiles_per_split=tps)
                require(torch.equal(out, want[0]) and torch.equal(lv, want[1]),
                        f"kernel D bf16x3 m={m} n={n} dim={dim} tm={tm} "
                        f"L{levels} {ids}: differs from the per-tile "
                        f"staging's stacks")
                cases += 1
        del ref
    torch.cuda.synchronize()
    require(forms == {"bf16x3", "bf16x3w"}, f"kernel D's ring forms checked: "
            f"{forms}")
    return cases


def _floor_library(D, torch, qh, rows, bias, levels, tn, ids, posu):
    """The library yardstick of kernel D: torch.addmm on bf16 rows, the
    pack, then torch.topk over each cell's groups (a segment's, when
    segmented)."""
    m, n = qh.shape[0], rows.shape[0]
    s = torch.addmm(bias, qh, rows.T).float()
    seg = D.segment_rows(tn) if ids == "segmented" else -(-n // 128) * 128
    p = D._pack(s, 0, tn, ids, D.segment_rows(tn), posu)
    p = torch.nn.functional.pad(p, (0, -n % seg), value=D.INT32_MIN)
    return torch.topk(p.reshape(m, -1, seg // 128, 128), levels, dim=2)


def _floor_entry(D, torch, name, qp, cp, cb, core, levels, tn, ids, posu, k,
                 ms, a_ms, a_core, launches, err, card):
    """Kernel D's JSON entry at one experiment's shape: its time (from the
    experiment), D at levels=0 there (its consumer may differ), its plain
    version's and the library's, the bound, and kernel A's time there.
    Checks D against its plain version first."""
    from polars_matmul_tpu_torch.tools import median_ms

    _check_floor(D, torch, qp, cp, cb, core, levels, tn, ids, posu, k, err,
                 f"{name} main-path shape", False)
    m, n, dim = qp.shape[0], cp.shape[0], qp.shape[1] // 2
    geo = D.floor_geometry(m, n, core, levels, k, qp.device,
                           dim=qp.shape[1] // 2)
    consumer = D.floor_consumer(geo[0], core, levels)
    tm0 = D.floor_geometry(m, n, core, 0, k, qp.device, dim=dim)[0]
    consumer0 = D.floor_consumer(tm0, core, 0)
    d0 = median_ms(lambda: D.floor_stacks(qp, cp, cb, core=core, levels=0,
                                          tn=tn, ids=ids, k_geometry=k), 10)
    plain = cuda_ms(lambda: D.floor_stacks_plain(
        qp, cp, cb, core=core, levels=levels, tn=tn, ids=ids, posu=posu,
        splits=geo[1], tiles_per_split=geo[2]), reps=3, warmup=1)
    qh = qp[:, :dim]
    if core == "bf16x3":
        rows, bias = cp[:, :dim], cb[0]
    else:
        rows = (D._decoded_corpus(cp, core) * cb[0][:, None]).to(
            torch.bfloat16)
        bias = cb[1]
    bias = bias.to(torch.bfloat16)
    lib = cuda_ms(lambda: _floor_library(D, torch, qh, rows, bias, levels,
                                         tn, ids, posu), reps=5, warmup=1)
    del rows
    out_bytes = m * 128 * 4 + (m * 128 * 4 * geo[1] * levels if levels
                               else m * -(-n // tn) * 4)
    passes = 3 if core == "bf16x3" else 2
    bound = _bound(qp.nbytes + cp.nbytes + cb.nbytes + out_bytes,
                   passes * 2 * m * n * dim, "bfloat16")
    blocks = D._occupancy[(qp.device.index, geo[0], core, levels,
                           qp.shape[1] // 2)]
    print(f"phase 10: [{card}] kernel D {name} ({m}x{n}x{dim} {core} "
          f"L{levels} {ids}{' posu' if posu else ''}; tm={geo[0]} "
          f"{consumer}, splits={geo[1]}, {blocks} block(s)/SM): {ms:.4f} ms; "
          f"D(0) {d0:.4f} ms (tm={tm0} {consumer0}), D(L) - D(0) "
          f"{ms - d0:+.4f} ms; kernel A ({a_core}) there {a_ms:.4f} ms, "
          f"A - D(0) {a_ms - d0:+.4f} ms; plain {plain:.3f} ms, library "
          f"torch.addmm + pack + torch.topk {lib:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    entry = _entry(ms, plain, lib, "torch.addmm on bf16 rows + pack + "
                   "torch.topk over each cell's groups", bound,
                   f"{name}: {m}x{n}x{dim} L{levels} {ids}")
    return dict({"name": f"floor_stacks.{core}", "route": "cuda",
                 "source": KERNEL_SRC + "floor.cu", "replaces": FLOOR_SRC,
                 "launches": launches[core], "max_abs_err": err[core],
                 "consumer": consumer, "kernel_a_ms": a_ms, "d0_ms": d0,
                 "kernel_a_minus_d0_ms": a_ms - d0, "blocks_per_sm": blocks},
                **entry)


def phase_floor(F, torch, card):
    """Phase 10 (with its phase 5 counts): kernel D against its plain
    version, then its main path, the three experiments at their JAX sizes
    (tools/exp_floor.py, exp_b256.py, exp_int4.py, ported), then each
    core's entry at its experiment's shape.  Returns kernel D's JSON
    entries."""
    from polars_matmul_tpu_torch.kernels import floor as D
    from polars_matmul_tpu_torch.tools import exp_b256, exp_floor, exp_int4

    t0 = time.perf_counter()
    plans = _floor_plans(D, torch)
    print(f"phase 10: kernel D's launch plans (consumer, ring, stages, "
          f"shared memory, levels in registers) equal the host mirror's in "
          f"{plans} cases")
    err = {core: 0.0 for core in D.CORES}
    cases, ties = _compare_floor(D, F, torch, err)
    print(f"phase 10: kernel D matches its plain version in {cases} ragged "
          f"cases (every core, levels {FLOOR_LEVELS}, every id rule and "
          f"posu setting; decoded levels within atol {ATOL} + rtol {RTOL} x "
          f"max(|score|, row term scale) + {PACK_RTOL:.3g} x |score|, ids "
          f"exact where clear) and {ties} integer tie cases bit for bit; "
          f"global ids past 128 groups raise")
    cases, ties, midstep = _compare_floor_wgmma(D, F, torch, err)
    print(f"phase 10: kernel D at query tile 64 (the stored cores on the "
          f"warpgroup consumer at levels {FLOOR_WG_LEVELS}) matches its "
          f"plain version in {cases} ragged cases "
          f"and {ties} tie cases bit for bit, {midstep} of them with a "
          f"segment restarting inside a step")
    bits = _floor_ring_bits(D, F, torch)
    print(f"phase 10: kernel D's bf16x3 core on kernel A's ring (both "
          f"forms) equals the per-tile staging's stacks bit for bit in "
          f"{bits} cases; the checks took {time.perf_counter() - t0:.1f} s")

    # The main path: the three experiments.  Count only their launches.
    t1 = time.perf_counter()
    D.reset_launch_counts()
    F.reset_launch_counts()
    floors = exp_floor.main("cuda", Path(__file__).resolve().parent
                            / "build" / "floors.json")
    b256 = exp_b256.main("cuda")
    int4 = exp_int4.main("cuda")
    torch.cuda.synchronize()
    launched, cores = dict(D.launches), dict(D.core_launches)
    print(f"phase 5: launches on the experiments' path: {launched}, by core "
          f"{cores}; kernels A / B {dict(F.launches)}")
    for core in D.CORES:
        require(cores[core] > 0, f"kernel D {core} never launched on the "
                f"experiments' path")
    require(launched["floor_stacks_plain"] == 0,
            "floor_stacks_plain ran on the experiments' path")
    for name in ("fused_topk_plain", "fused_topk_partial_plain",
                 "topk_merge_plain"):
        require(F.launches[name] == 0, f"{name} ran on the experiments' "
                f"path")
    print(f"phase 10: the three experiments ran in "
          f"{time.perf_counter() - t1:.1f} s")

    entries = []
    qf, cf, qp = exp_floor.build(torch.device("cuda"))
    cp, cb = exp_floor.corpus_operands(cf, 2048)
    entries.append(_floor_entry(
        D, torch, "exp_floor B1_2048", qp, cp, cb, "bf16x3", 1, 2048,
        "global", False, 10, floors["floor_k10_ms"],
        floors["geometry"]["B1_2048"]["kernel_a_ms"], "bf16x3, k=10", cores,
        err, card))
    del qf, cf, qp, cp, cb
    q, cp, cb, tn = exp_b256.build(torch.device("cuda"))
    qp = F.prepare_queries(q, "cosine", "int8c")
    lv = b256["n_levels"]
    entries.append(_floor_entry(
        D, torch, f"exp_b256 L{lv}", qp, cp, cb, "int8c", lv, tn,
        "segmented", False, exp_b256.K, b256[f"L{lv}"], b256["kernel-A"],
        "int8c, k=100", cores, err, card))
    del q, qp, cp, cb
    torch.cuda.empty_cache()
    q, corpora, tn = exp_int4.build(torch.device("cuda"))
    qp = F.prepare_queries(q[:8], "cosine", "int8c")
    # Kernel A runs int8 codes in its int8c core, the int4 family in int4c.
    a_tag = {"int8": "int8c", "int4": "int4-i32", "rint": "int4-i32"}
    for tag, core, form in exp_int4.MODES:
        entry = _floor_entry(
            D, torch, f"exp_int4 {tag}-b8", qp, *corpora[form], core, 1,
            tn, "tile-local", False, exp_int4.K, int4[f"{tag}-b8"]["ms"],
            int4[f"{a_tag[form]}-b8"]["kernel_a_ms"],
            f"{'int8c' if form == 'int8' else 'int4c'}, k=100", cores, err,
            card)
        if core != "int8c":   # int8c's entry is the b256 build's
            entries.append(entry)
    del q, qp, corpora
    torch.cuda.empty_cache()
    print(f"phase 10: took {time.perf_counter() - t0:.1f} s host")
    return entries


# Corpus mutation (phase 11).  The dense corpus is phase 7's, built without
# its last MUT_ADDS x MUT_ADD_ROWS rows, which come back through add;
# updated rows and ids are drawn from MUT_SEED.
MUT_SEED = SEED + 1
MUT_ADDS, MUT_ADD_ROWS = 10, 1_000
MUT_UPDATES, MUT_DELETES = 10_000, 100_000
# The clustered corpus is phase 8's, with a reserve of dead tiles.
CL_RESERVE, CL_ADDS, CL_UPDATES, CL_DELETES = 64, 100_000, 10_000, 10_000
# Capacity beside capacity=None: reserved rows the kernels walk as -inf.
CAP_SHARE = 1.01


def _host_ms(torch, fn):
    """(fn(), host ms of the call, ending in a device synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _counted(F, what, cores, wgmma=False, tiles=False):
    """The launch counts since the last reset: kernels A (in ``cores``,
    the warpgroup consumer and the tile lists as asked) and B ran, the
    plain versions did not.  Returns (launches, core launches)."""
    launched, by_core = dict(F.launches), dict(F.core_launches)
    print(f"phase 5: launches on the {what} path: {launched}, by core "
          f"{by_core}")
    for core in cores:
        require(by_core[core] > 0, f"{core} never launched on the {what} "
                f"path")
    names = (["topk_merge"] + (["fused_topk_partial_wgmma"] if wgmma else [])
             + (["fused_topk_partial_tiles"] if tiles else []))
    for name in names:
        require(launched[name] > 0, f"{name} never launched on the {what} "
                f"path")
    for name in ("fused_topk_plain", "fused_topk_partial_plain",
                 "topk_merge_plain"):
        require(launched[name] == 0, f"{name} ran on the {what} path")
    return launched, by_core


def _kernel_a_ms(F, torch, corpus, qb, k, alive=None):
    """Kernel A alone on a dense handle's cosine operands (every stored
    row, its capacity included; ``alive`` as the mask the handle gives)."""
    core = corpus._effective_precision()
    cp, cbp = corpus._prepared_for(F.Metric.COSINE)
    qp = F.prepare_queries(qb, "cosine", core)
    mask = None if alive is None else F.pad_mask_row(alive, cp.shape[0])
    tm, splits, tps = F.kernel_geometry(qb.shape[0], cp.shape[0], k, core,
                                        qp.device, dim=corpus.dim)
    return cuda_ms(lambda: F.fused_topk_partial(qp, cp, cbp, mask, k, core,
                                                splits, tps, tm),
                   reps=10, warmup=2)


def _request_ms(corpus, qb, k, reps=5):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        corpus.topk(qb, k)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _mutation_dense(pmt, F, torch, card):
    """The 10M x 768 int8 corpus with capacity: 10 adds from a CUDA tensor
    (in place), an update, a delete, then phase 7's requests held to the
    float64 oracle over the live stored rows; capacity beside
    capacity=None.  Returns the launches of its path."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    q = torch.randn((256, WIDE_DIM), generator=gen, device="cuda")
    c = _wide_f32(torch)
    keep = WIDE_ROWS - MUT_ADDS * MUT_ADD_ROWS
    label = f"{WIDE_ROWS}x{WIDE_DIM} int8 capacity={WIDE_ROWS}"
    corpus, built = _host_ms(torch, lambda: pmt.Corpus(
        c[:keep], storage="int8", capacity=WIDE_ROWS))
    print(f"phase 11: {label}: built from the first {keep} rows in "
          f"{built:.1f} ms host: {corpus!r}")

    # The mutation path: count only its launches.
    F.reset_launch_counts()
    corpus.topk(q[:8], 10)   # the cosine form exists before the adds
    held = (corpus._device, corpus._scales) + corpus._prepared_for(
        F.Metric.COSINE)
    ptrs = [t.data_ptr() for t in held]
    del held
    add_ms = []
    for i in range(MUT_ADDS):
        r0 = keep + i * MUT_ADD_ROWS
        n, ms = _host_ms(torch, lambda: corpus.add(c[r0:r0 + MUT_ADD_ROWS]))
        add_ms.append(ms)
    require(n == WIDE_ROWS, f"{label}: {n} rows after the adds")
    now = [t.data_ptr() for t in (corpus._device, corpus._scales)
           + corpus._prepared_for(F.Metric.COSINE)]
    require(now == ptrs, f"{label}: an add within capacity reallocated the "
            f"storage or a prepared form")
    rng = np.random.default_rng(MUT_SEED)
    g43 = torch.Generator(device="cuda")
    g43.manual_seed(MUT_SEED)
    ids = rng.choice(WIDE_ROWS, MUT_UPDATES, replace=False)
    rows = torch.randn((MUT_UPDATES, WIDE_DIM), generator=g43, device="cuda")
    _, upd_ms = _host_ms(torch, lambda: corpus.update(ids, rows))
    dead = rng.choice(WIDE_ROWS, MUT_DELETES, replace=False)
    _, del_ms = _host_ms(torch, lambda: corpus.delete(dead))
    print(f"phase 11: [{card}] {label}: add of {MUT_ADD_ROWS} rows "
          f"(CUDA tensor) median {statistics.median(add_ms):.3f} ms host "
          f"(of {MUT_ADDS}: {', '.join(f'{t:.3f}' for t in add_ms)}); update "
          f"of {MUT_UPDATES} rows {upd_ms:.3f} ms; delete of {MUT_DELETES} "
          f"ids {del_ms:.3f} ms; storage and prepared form written in "
          f"place: {corpus!r}")
    del rows
    alive = torch.ones(WIDE_ROWS, dtype=torch.bool, device="cuda")
    alive[torch.from_numpy(dead).to("cuda")] = False
    for batch, k in WIDE_REQUESTS["int8"]:
        (idx, scores), ms = _host_ms(torch, lambda: corpus.topk(q[:batch],
                                                               k))
        ref_idx, ref_scores = _oracle_stored(F, torch, corpus, q[:batch], k,
                                             alive=alive)
        gate(idx, scores, ref_idx, ref_scores, f"{label} batch={batch} k={k}")
        require(not np.isin(idx, dead).any(),
                f"{label} batch={batch} k={k}: a deleted row was returned")
        print(f"phase 11: {label} batch {batch} k={k}: passes the float64 "
              f"oracle gate over the live stored rows, no deleted id "
              f"({ms:.1f} ms host)")
    torch.cuda.synchronize()
    launched, by_core = _counted(F, f"{label} mutation", ("int8c",),
                                 wgmma=True)

    # Capacity against capacity=None on the same rows, in turns.
    plain = pmt.Corpus(c, storage="int8")
    reserved = pmt.Corpus(c, storage="int8",
                          capacity=int(CAP_SHARE * WIDE_ROWS))
    del c
    torch.cuda.empty_cache()
    times = {}
    handles = (("capacity=None", plain, None),
               (f"capacity={CAP_SHARE} n", reserved, None),
               ("mutated (capacity=n, 1 % deleted)", corpus, alive))
    for name, h, mk in handles + handles[::-1]:
        t = times.setdefault(name, {"a": [], "r8": [], "r256": []})
        t["a"].append(_kernel_a_ms(F, torch, h, q, 100, mk))
        t["r8"].append(_request_ms(h, q[:8], 10))
        t["r256"].append(_request_ms(h, q, 100))
    for name, t in times.items():
        print(f"phase 11: [{card}] {WIDE_ROWS}x{WIDE_DIM} int8 {name}: "
              f"kernel A batch 256 k=100 "
              f"{' / '.join(f'{x:.3f}' for x in t['a'])} ms device; "
              f"request batch 8 k=10 "
              f"{' / '.join(f'{x:.3f}' for x in t['r8'])} ms host, batch "
              f"256 k=100 {' / '.join(f'{x:.3f}' for x in t['r256'])} ms "
              f"host (in turns: first and second pass)")
    return launched, by_core


def _mutation_growth(pmt, torch):
    """Phase 4's 2M x 256 f32 corpus (the bf16x3 default core) built
    without its last MUT_ADD_ROWS rows at capacity n; one add past
    capacity, then batch 8 k=10 held to the float64 oracle."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    c = torch.randn((BIG_ROWS, DIM), generator=gen, device="cuda")
    q = torch.randn((8, DIM), generator=gen, device="cuda")
    keep = BIG_ROWS - MUT_ADD_ROWS
    corpus = pmt.Corpus(c[:keep])
    corpus.topk(q, 10)   # a prepared form exists before the growth
    _, add_ms = _host_ms(torch, lambda: corpus.add(c[keep:]))
    require(corpus._cap == 2 * keep and not corpus._prepared,
            f"growth: capacity {corpus._cap}, prepared forms kept")
    (idx, scores), first = _host_ms(torch, lambda: corpus.topk(q, 10))
    ref_idx, ref_scores = _oracle_on_card(torch, q, c, 10)
    gate(idx, scores, ref_idx, ref_scores, "growth batch=8 k=10")
    print(f"phase 11: {BIG_ROWS}x{DIM} f32: add of {MUT_ADD_ROWS} rows past "
          f"capacity {keep} took {add_ms:.3f} ms host (capacity now "
          f"{corpus._cap}); batch 8 k=10 passes the float64 oracle gate "
          f"({first:.1f} ms host, the re-prep included)")
    return add_ms


def _placement(before, after, ids):
    """Rows ``ids`` placed in (tile-tail slack, claimed dead tiles,
    appended tiles)."""
    pos = after.row_pos[ids].astype(np.int64)
    old = pos < before.n_padded
    dead = np.zeros(pos.size, bool)
    dead[old] = before.tile_cluster[pos[old] // before.tn] == -1
    return int((old & ~dead).sum()), int(dead.sum()), int((~old).sum())


def _recall(got, exact):
    return np.mean([len(set(a) & set(b)) / exact.shape[1]
                    for a, b in zip(got.astype(np.int64),
                                    exact.astype(np.int64))])


def _mutation_clustered(pmt, F, torch, card):
    """Phase 8's 10M x 768 int8 blob mixture built with CL_RESERVE dead
    tiles: an add from the mixture (reaching slack, reserve and appended
    tiles), an update, a delete, probed and exhaustive requests held to
    the float64 oracle over the live visited rows, then ``rebuild()``.
    Returns the launches of its path."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    c, queries = _blobs(torch, gen, WIDE_ROWS, WIDE_DIM)
    cc = pmt.ClusteredCorpus(c, storage="int8", reserve_tiles=CL_RESERVE)
    del c
    torch.cuda.empty_cache()
    q = queries(256)
    label = f"{WIDE_ROWS}x{WIDE_DIM} int8 clustered"
    print(f"phase 11: {label} built with reserve_tiles={CL_RESERVE}: {cc!r}")
    g43 = torch.Generator(device="cuda")
    g43.manual_seed(MUT_SEED)
    rng = np.random.default_rng(MUT_SEED)

    # The mutation path: count only its launches.
    F.reset_launch_counts()
    before, n0 = cc.layout, cc.n
    rows = queries(CL_ADDS, g43)
    _, add_ms = _host_ms(torch, lambda: cc.add(rows))
    placed = _placement(before, cc.layout, np.arange(n0, cc.n))
    del before, rows
    require(all(placed), f"{label}: add placed {placed} rows in slack, "
            f"claimed reserve and appended tiles; each must be reached")
    ids = rng.choice(cc.n, CL_UPDATES, replace=False)
    rows = queries(CL_UPDATES, g43)
    _, upd_ms = _host_ms(torch, lambda: cc.update(ids, rows))
    dead = rng.choice(cc.n, CL_DELETES, replace=False)
    _, del_ms = _host_ms(torch, lambda: cc.delete(dead))
    del rows
    print(f"phase 11: [{card}] {label}: add of {CL_ADDS} rows {add_ms:.3f} ms "
          f"host ({placed[0]} into tile-tail slack, {placed[1]} into claimed "
          f"reserve tiles, {placed[2]} into appended tiles); update of "
          f"{CL_UPDATES} rows {upd_ms:.3f} ms; delete of {CL_DELETES} ids "
          f"{del_ms:.3f} ms; drift {cc.drift:.5f}: {cc!r}")

    def checked(batch, k, probe, when):
        got = _request_checked(F, torch, cc, q[:batch], k, probe,
                               f"{label} {when} batch {batch} k={k} "
                               f"probe={probe}", phase=11)
        require(not np.isin(got[0], dead).any(),
                f"{label} {when}: a deleted row was returned")
        return got

    for batch, k in ((8, 10), (256, 100)):
        checked(batch, k, PROBE, "before rebuild")
    exact = checked(8, 10, None, "before rebuild")
    recall = [_recall(cc.topk(q[:8], 10, probe=PROBE)[0], exact[0])]
    tiles, clusters = cc.n_tiles, cc.clusters
    _, rb_ms = _host_ms(torch, lambda: cc.rebuild())
    require(cc.drift == 0.0, f"{label}: drift {cc.drift} after rebuild")
    # Compacted: no dead or appended tiles, each cluster in the fewest
    # whole tiles its rows need (the default cluster count follows n, so
    # the tile count may move either way).
    need = int(np.sum(-(-cc.layout.counts // cc.layout.tn)))
    require(cc.n_tiles == need, f"{label}: {cc.n_tiles} tiles after "
            f"rebuild, the clusters need {need}")
    after = checked(8, 10, None, "after rebuild")
    gate(after[0], after[1], exact[0].astype(np.int64), exact[1],
         f"{label}: exhaustive results across rebuild")
    checked(8, 10, PROBE, "after rebuild")
    recall.append(_recall(cc.topk(q[:8], 10, probe=PROBE)[0], after[0]))
    torch.cuda.synchronize()
    launched, by_core = _counted(F, f"{label} mutation", ("int8c",),
                                 tiles=True)
    print(f"phase 11: [{card}] {label}: rebuild() {rb_ms:.1f} ms host, "
          f"{tiles} -> {cc.n_tiles} tiles (no dead tile left), "
          f"{clusters} -> {cc.clusters} clusters; the "
          f"exhaustive batch 8 k=10 gives the same ids (ties aside); probed "
          f"recall@10 against the exhaustive scan, batch 8, probe {PROBE}: "
          f"{recall[0]:.4f} before, {recall[1]:.4f} after (reported, not "
          f"gated)")
    return launched, by_core


# Kernels-line entries that phase 11's paths launch, by its count keys.
MUTATION_KEYS = {"fused_topk_partial.int8c": "int8c",
                 "fused_topk_partial.int8c.wgmma": "int8c.wgmma",
                 "fused_topk_partial.bf16x3": "bf16x3",
                 "topk_merge": "topk_merge",
                 "fused_topk_partial.tiles": "tiles"}


def phase_mutation(pmt, F, torch, card):
    """Phase 11: corpus mutation at full width, each path with its own
    phase 5 counts.  Returns the launches to add to the kernels line, by
    its keys ("int8c", "int8c.wgmma", "bf16x3", "topk_merge", "tiles")."""
    t0 = time.perf_counter()
    dense, dense_core = _mutation_dense(pmt, F, torch, card)
    torch.cuda.empty_cache()
    F.reset_launch_counts()
    _mutation_growth(pmt, torch)
    torch.cuda.synchronize()
    grown, grown_core = _counted(F, f"{BIG_ROWS}x{DIM} f32 growth",
                                 ("bf16x3",))
    torch.cuda.empty_cache()
    cl, cl_core = _mutation_clustered(pmt, F, torch, card)
    torch.cuda.empty_cache()
    print(f"phase 11: {time.perf_counter() - t0:.1f} s host in all")
    return {"int8c": dense_core["int8c"] + cl_core["int8c"],
            "int8c.wgmma": (dense["fused_topk_partial_wgmma"]
                            + cl["fused_topk_partial_wgmma"]),
            "bf16x3": grown_core["bf16x3"],
            "topk_merge": (dense["topk_merge"] + grown["topk_merge"]
                           + cl["topk_merge"]),
            "tiles": cl["fused_topk_partial_tiles"]}


# Arrow interop (phase 12): one host values buffer of ARROW_ROWS x WIDE_DIM
# f32 from SEED (an embedding column at the north star's width), described
# by its buffers as a FixedSizeList (a view) and as a List<f32> with int32
# offsets after ARROW_OFFSET empty rows, sliced there, ARROW_NULL_SHARE of
# its rows null (packed by the native packer).  The phase drives the
# buffer layer, the code under topk_arrow that needs no pyarrow.
ARROW_ROWS, ARROW_OFFSET, ARROW_NULL_SHARE = 2_000_000, 3, 0.001
ARROW_QUERIES = 256
# Kernels-line entries that phase 12's path launches, by its count keys.
ARROW_KEYS = {"fused_topk_partial.bf16x3": "bf16x3",
              "fused_topk_partial.int8c": "int8c",
              "topk_merge": "topk_merge",
              "fused_topk_partial.tiles": "tiles"}


def _arrow_columns(B):
    """The host values buffer as (rows, dim), its FixedSizeList and List
    columns, the List's null rows (the first not at bit 0 of its byte;
    drawn from SEED + 12) and ARROW_QUERIES query rows (from SEED)."""
    rng = np.random.default_rng(SEED)
    values = np.empty(ARROW_ROWS * WIDE_DIM, np.float32)
    rng.standard_normal(dtype=np.float32, out=values)
    fsl = B.EmbeddingColumn(length=ARROW_ROWS, values=values,
                            list_size=WIDE_DIM)
    offsets = np.zeros(ARROW_OFFSET + ARROW_ROWS + 1, np.int32)
    offsets[ARROW_OFFSET:] = (np.arange(ARROW_ROWS + 1, dtype=np.int32)
                              * WIDE_DIM)
    pick = np.random.default_rng(SEED + 12)
    nulls = np.sort(pick.choice(ARROW_ROWS - 1, int(ARROW_NULL_SHARE
                                                    * ARROW_ROWS),
                                replace=False) + 1)
    valid = np.ones(ARROW_OFFSET + ARROW_ROWS, bool)
    valid[ARROW_OFFSET + nulls] = False
    require((ARROW_OFFSET + nulls[0]) % 8 != 0,
            "the first null row sits at bit 0 of its byte")
    lst = B.EmbeddingColumn(length=ARROW_ROWS, values=values,
                            offsets=offsets, offset=ARROW_OFFSET,
                            validity=np.packbits(valid, bitorder="little"))
    queries = rng.standard_normal((ARROW_QUERIES, WIDE_DIM),
                                  dtype=np.float32)
    return values.reshape(ARROW_ROWS, WIDE_DIM), fsl, lst, nulls, queries


def _check_packed(packed, rows, nulls, chunk=1 << 17):
    """The packed List column: the values rows, the null rows zeros."""
    require(packed.shape == rows.shape and packed.dtype == np.float32,
            f"packed {packed.shape} {packed.dtype}")
    require(not packed[nulls].any(), "a null row was not packed as zeros")
    keep = np.ones(rows.shape[0], bool)
    keep[nulls] = False
    for r0 in range(0, rows.shape[0], chunk):
        same = (packed[r0:r0 + chunk] == rows[r0:r0 + chunk]).all(axis=1)
        require(bool(same[keep[r0:r0 + chunk]].all()),
                f"packed rows from {r0} differ from the values buffer")


def _topk_result(out, m, k):
    """(indices, scores) of ``TopkBuffers`` holding m lists of k, after
    checking their layout: int32 offsets i * k, a u32 index child and an
    f64 score child."""
    require(out.offsets.dtype == np.int32 and np.array_equal(
        out.offsets, np.arange(m + 1) * k), "top-k offsets are not i * k")
    require(out.index.dtype == np.uint32 and out.index.shape == (m * k,),
            f"index child {out.index.dtype} {out.index.shape}")
    require(out.score.dtype == np.float64 and out.score.shape == (m * k,),
            f"score child {out.score.dtype} {out.score.shape}")
    return out.index.reshape(m, k), out.score.reshape(m, k)


def _median_ms(torch, fn, reps=5):
    return statistics.median(_host_ms(torch, fn)[1] for _ in range(reps))


def _arrow_dense(pmt, F, torch, B, topk_buffers, fsl, lst, nulls, queries,
                 card):
    """Corpus.from_arrow of the FixedSizeList (f32) and of the List with
    nulls (int8), requests through topk_buffers held to float64 oracles."""
    label = f"{ARROW_ROWS}x{WIDE_DIM}"
    q_dev = torch.from_numpy(queries).cuda()
    qcol, q8 = B.matrix_column(queries), B.matrix_column(queries[:8])
    corpus, up_ms = _host_ms(torch, lambda: pmt.Corpus.from_arrow(fsl))
    _, prep_ms = _host_ms(torch, lambda: corpus._prepared_for(
        F.Metric.COSINE))
    for k in (10, 100):
        out, ms = _host_ms(torch, lambda: topk_buffers(qcol, corpus, k))
        idx, scores = _topk_result(out, ARROW_QUERIES, k)
        ref_idx, ref_scores = _oracle_on_card(torch, q_dev, corpus._device,
                                              k)
        gate(idx, scores, ref_idx, ref_scores,
             f"{label} f32 FixedSizeList batch 256 k={k}")
        print(f"phase 12: {label} f32 Corpus.from_arrow(FixedSizeList), "
              f"topk_buffers batch {ARROW_QUERIES} k={k} cosine: offsets, "
              f"u32 index and f64 score children as Arrow lays them out; "
              f"passes the float64 oracle gate ({ms:.1f} ms host)")
    times = {"topk_buffers": [], "Corpus.topk": []}
    for _ in range(2):
        times["topk_buffers"].append(_median_ms(
            torch, lambda: topk_buffers(q8, corpus, 10)))
        times["Corpus.topk"].append(_median_ms(
            torch, lambda: corpus.topk(queries[:8], 10)))
    idx, scores = corpus.topk(queries, 100)
    asm_ms = _median_ms(torch, lambda: B.topk_to_buffers(idx, scores))
    del corpus
    torch.cuda.empty_cache()
    print(f"phase 12: [{card}] {label} f32: Corpus.from_arrow (upload) "
          f"{up_ms:.1f} ms host, cosine prep {prep_ms:.1f} ms; batch 8 "
          f"k=10 through topk_buffers "
          f"{' / '.join(f'{t:.3f}' for t in times['topk_buffers'])} ms "
          f"host, Corpus.topk on the same NumPy matrix "
          f"{' / '.join(f'{t:.3f}' for t in times['Corpus.topk'])} ms "
          f"(medians of 5, in turns); assembly of batch 256 k=100 "
          f"{asm_ms:.3f} ms host")

    c8, up8_ms = _host_ms(torch, lambda: pmt.Corpus.from_arrow(
        lst, storage="int8"))
    dead = torch.from_numpy(nulls).cuda()
    require(not bool(c8._device[dead].any()),
            "a null row is not stored as zero codes")
    out, ms = _host_ms(torch, lambda: topk_buffers(q8, c8, 10))
    idx, scores = _topk_result(out, 8, 10)
    ref_idx, ref_scores = _oracle_stored(F, torch, c8, q_dev[:8], 10)
    gate(idx, scores, ref_idx, ref_scores,
         f"{label} int8 List with nulls batch 8 k=10")
    print(f"phase 12: [{card}] {label} int8 Corpus.from_arrow(List, "
          f"{nulls.size} null rows, offset {ARROW_OFFSET}): packed, "
          f"quantized and uploaded in {up8_ms:.1f} ms host; topk_buffers "
          f"batch 8 k=10 passes the float64 oracle gate over the stored "
          f"codes, null rows stored as zeros ({ms:.1f} ms host)")
    del c8
    torch.cuda.empty_cache()


def phase_arrow(pmt, F, torch, q_np, c_np, card):
    """Phase 12: the Arrow path on raw buffers at ARROW_ROWS x WIDE_DIM,
    counted like phase 5, and matmul_buffers at the canonical shape.
    Returns the launches to add to the kernels line, by ARROW_KEYS'
    values."""
    from polars_matmul_tpu_torch.api.arrow_ops import (matmul_buffers,
                                                       topk_buffers)
    from polars_matmul_tpu_torch.interop import buffers as B
    from polars_matmul_tpu_torch.interop import native

    t0 = time.perf_counter()
    rows, fsl, lst, nulls, queries = _arrow_columns(B)
    made = time.perf_counter() - t0
    view, view_ms = _host_ms(torch, lambda: B.extract_matrix(fsl))
    require(view.shape == rows.shape and view.__array_interface__["data"][0]
            == rows.__array_interface__["data"][0],
            "the FixedSizeList extraction is not a view of its buffer")
    packs = dict(B.packs)
    packed, pack_ms = _host_ms(torch, lambda: B.extract_matrix(lst))
    require(B.packs == dict(packs, native=packs["native"] + 1),
            f"the List column did not take the native packer: {B.packs}, "
            f"{native.build_info}")
    _check_packed(packed, rows, nulls)
    del packed, view
    print(f"phase 12: [{card}] {ARROW_ROWS}x{WIDE_DIM} f32 values buffer "
          f"made in {made:.1f} s host (NumPy, seed {SEED}); extraction: the "
          f"FixedSizeList a view ({view_ms:.4f} ms host), the List (int32 "
          f"offsets, array offset {ARROW_OFFSET}, {nulls.size} null rows, "
          f"the first at bit {(ARROW_OFFSET + nulls[0]) % 8} of its byte) "
          f"packed by the native packer in {pack_ms:.1f} ms host, every row "
          f"checked ({native.build_info['library']})")

    # The Arrow path: count only its launches.
    F.reset_launch_counts()
    _arrow_dense(pmt, F, torch, B, topk_buffers, fsl, lst, nulls, queries,
                 card)
    cc, cl_ms = _host_ms(torch, lambda: pmt.ClusteredCorpus.from_arrow(fsl))
    q8 = B.matrix_column(queries[:8])
    _request_checked(
        F, torch, cc, torch.from_numpy(queries[:8]).cuda(), 10, PROBE,
        f"{ARROW_ROWS}x{WIDE_DIM} f32 ClusteredCorpus.from_arrow("
        f"FixedSizeList) topk_buffers batch 8 k=10 probe={PROBE}",
        phase=12, request=lambda: _topk_result(
            topk_buffers(q8, cc, 10, probe=PROBE), 8, 10))
    print(f"phase 12: [{card}] ClusteredCorpus.from_arrow built in "
          f"{cl_ms:.1f} ms host: {cc!r}")
    del cc
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launched, by_core = _counted(F, f"{ARROW_ROWS}x{WIDE_DIM} Arrow",
                                 ("bf16x3", "int8c"), tiles=True)
    require(B.packs["native"] == packs["native"] + 2
            and B.packs["plain"] == packs["plain"],
            f"packs on the Arrow path: {B.packs}")

    # matmul_buffers at the canonical shape, from columns and a handle.
    mq, mc = B.matrix_column(q_np), B.matrix_column(c_np)
    qd, cd = torch.from_numpy(q_np).cuda(), torch.from_numpy(c_np).cuda()
    for what, corpus in (("columns", mc), ("a Corpus handle",
                                           pmt.Corpus(c_np))):
        out, ms = _host_ms(torch, lambda: matmul_buffers(mq, corpus))
        require(out.list_size == N_CORPUS and out.offsets is None
                and out.values.dtype == np.float32
                and out.values.shape == (N_QUERIES * N_CORPUS,),
                f"matmul_buffers ({what}): {out.list_size} "
                f"{out.values.dtype} {out.values.shape}")
        panel = torch.from_numpy(out.values.reshape(N_QUERIES, N_CORPUS))
        _check_product(torch, panel.cuda(), qd, cd, "highest",
                       f"matmul_buffers from {what}")
        print(f"phase 12: matmul_buffers {N_QUERIES}x{N_CORPUS}x{DIM} f32 "
              f"from {what}: a FixedSizeList[{N_CORPUS}] panel within the "
              f"float64 product's tolerance ({ms:.1f} ms host)")

    try:
        import pyarrow as pa
    except ImportError:
        print("phase 12: pyarrow is not installed on this machine: the "
              "pyarrow adapter (topk_arrow, matmul_arrow, from_arrow on pa "
              "arrays) is left to the CPU tests (tests/test_torch_interop.py)")
    else:
        col = pa.FixedSizeListArray.from_arrays(pa.array(rows.reshape(-1)),
                                                WIDE_DIM)
        qa = pa.FixedSizeListArray.from_arrays(
            pa.array(queries[:8].reshape(-1)), WIDE_DIM)
        corpus = pmt.Corpus.from_arrow(col)
        got = pmt.topk_arrow(qa, corpus, 10).flatten()
        want = topk_buffers(q8, corpus, 10)
        require(np.array_equal(np.asarray(got.field("index")), want.index)
                and np.array_equal(np.asarray(got.field("score")),
                                   want.score),
                "topk_arrow differs from topk_buffers on the same column")
        print(f"phase 12: topk_arrow and Corpus.from_arrow on pyarrow "
              f"{pa.__version__} arrays equal topk_buffers on their buffers")
        del corpus
        torch.cuda.empty_cache()
    print(f"phase 12: {time.perf_counter() - t0:.1f} s host in all")
    return {"bf16x3": by_core["bf16x3"], "int8c": by_core["int8c"],
            "topk_merge": launched["topk_merge"],
            "tiles": launched["fused_topk_partial_tiles"]}



# Sharded search (phase 13): SHARDS mesh positions on the one card (a mesh
# may repeat a device), phase 7's int8 codes, phase 4's f32 corpus on a
# 2 x 2 mesh, phase 8's 2M x 256 f32 blob mixture clustered on SHARDS
# shards, and a one-rank NCCL process group.
SHARDS = 4
SHARD_MERGES = ("allgather", "ring")
SHARD_ADDS, SHARD_UPDATES, SHARD_DELETES = 1_000, 10_000, 100_000
# Kernels-line entries that phase 13's paths launch, by its count keys.
SHARD_KEYS = {"fused_topk_partial.int8c": "int8c",
              "fused_topk_partial.int8c.wgmma": "int8c.wgmma",
              "fused_topk_partial.bf16x3": "bf16x3",
              "fused_topk_partial.highest": "highest",
              "topk_merge": "topk_merge",
              "fused_topk_partial.tiles": "tiles"}


def _wide_codes(F, torch, chunk=1 << 20):
    """Phase 7's int8 codes and scales of the 10M x 768 corpus, quantized
    chunk by chunk as ``_wide_f32`` draws the rows (the f32 matrix is
    never whole), and the f32 values of its last SHARD_ADDS rows."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    codes = torch.empty((WIDE_ROWS, WIDE_DIM), dtype=torch.int8,
                        device="cuda")
    scales = torch.empty(WIDE_ROWS, device="cuda")
    buf = torch.empty((chunk, WIDE_DIM), device="cuda")
    for r0 in range(0, WIDE_ROWS, chunk):
        r1 = min(WIDE_ROWS, r0 + chunk)
        blk = buf[: r1 - r0]
        blk.normal_(generator=gen)
        codes[r0:r1], scales[r0:r1] = F.quantize_int8(blk)
    return codes, scales, blk[-SHARD_ADDS:].clone()


def _same_result(torch, got, want, what):
    """Two handles' (indices, scores) on the same rows agree: the kernel
    tolerance, indices equal except at ties (``compare``).  Returns (the
    largest score difference, whether both are bit-identical)."""
    (gi, gv), (wi, wv) = got, want
    err = compare(torch.from_numpy(gv), torch.from_numpy(gi.astype(np.int64)),
                  torch.from_numpy(wv), torch.from_numpy(wi.astype(np.int64)),
                  what=what)
    return err, bool(np.array_equal(gi, wi) and np.array_equal(gv, wv))


def _shard_parts_ms(F, torch, sharded, plain, q, k):
    """CUDA-event ms of the parts of one request on this sharded handle:
    kernel A over every shard (their sum) beside kernel A over the
    unsharded handle's rows, kernel B on the S shard lists (the allgather
    merge), and the S (S - 1) two-list merges of the ring."""
    from polars_matmul_tpu_torch.parallel import sharded as SH

    sc = sharded._device
    cfg = sharded.config.with_updates(precision="int8c")
    forms = sc.prepared_for(F.Metric.COSINE, cfg, "int8c")
    keys = sorted(forms, key=lambda x: x[0])
    qp = F.prepare_queries(q, "cosine", "int8c")
    a_shards = 0.0
    for key in keys:
        cp, cbp = forms[key]
        tm, splits, tps = F.kernel_geometry(q.shape[0], cp.shape[0], k,
                                            "int8c", q.device, dim=sc.dim)
        a_shards += cuda_ms(lambda: F.fused_topk_partial(
            qp, cp, cbp, None, k, "int8c", splits, tps, tm), reps=5,
            warmup=1)
    a_plain = _kernel_a_ms(F, torch, plain, q, k)
    lists = [SH._offset(*F.select_prepared(q, *forms[key], k, "cosine",
                                           config=cfg, precision="int8c"),
                        key[0] * sc.ns, k, float("-inf")) for key in keys]
    gather = cuda_ms(lambda: SH._kernel_merge(lists, k), reps=10)
    pairs = SHARDS * (SHARDS - 1)
    ring = cuda_ms(lambda: [SH._kernel_merge(lists[:2], k)
                            for _ in range(pairs)], reps=10)
    return a_shards, a_plain, gather, ring


def _shard_wide(pmt, F, torch, card):
    """Phase 7's 10M x 768 int8 codes over SHARDS shards of the card, both
    merges, held to the unsharded handle and (batch 8) to the float64
    oracle; then capacity=, adds, an update and a delete on both handles.
    Returns the launches of its sharded requests."""
    label = f"{WIDE_ROWS}x{WIDE_DIM} int8 on {SHARDS} shards"
    (codes, scales, tail), made = _host_ms(torch,
                                           lambda: _wide_codes(F, torch))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    q = torch.randn((256, WIDE_DIM), generator=gen, device="cuda")
    mesh = pmt.make_mesh(1, SHARDS, devices=["cuda:0"] * SHARDS)
    plain = pmt.Corpus(codes, storage="int8", scales=scales)
    sharded, built = _host_ms(torch, lambda: pmt.Corpus(
        codes, storage="int8", scales=scales, mesh=mesh))
    print(f"phase 13: {label}: codes made from seed {SEED} in {made:.1f} ms "
          f"host; {sharded!r} over {mesh!r}, sharded on the card in "
          f"{built:.1f} ms host, {sharded._device.ns} rows a shard")

    # The sharded path: count only its launches.
    F.reset_launch_counts()
    results = {}
    for merge in SHARD_MERGES:
        sharded.config = sharded.config.with_updates(merge=merge)
        for batch, k in WIDE_REQUESTS["int8"]:
            results[(merge, batch, k)] = sharded.topk(q[:batch], k)
    torch.cuda.synchronize()
    launched, by_core = _counted(F, f"{label} sharded", ("int8c",),
                                 wgmma=True)
    for (merge, batch, k), got in results.items():
        what = f"{label} {merge} batch {batch} k={k}"
        err, same = _same_result(torch, got, plain.topk(q[:batch], k), what)
        line = (f"phase 13: {what}: matches the unsharded handle (max abs "
                f"diff {err:.3g}, bit-identical {same})")
        if batch == 8:
            gate(*got, *_oracle_stored(F, torch, plain, q[:8], k), what)
            line += ", passes the float64 oracle gate over the stored rows"
        print(line)
    for merge in SHARD_MERGES:
        sharded.config = sharded.config.with_updates(merge=merge)
        for batch, k in WIDE_REQUESTS["int8"]:
            ms = [_request_ms(h, q[:batch], k) for h in (sharded, plain,
                                                         sharded, plain)]
            print(f"phase 6: [{card}] {label} {merge} batch {batch} k={k}: "
                  f"request {ms[0]:.3f} / {ms[2]:.3f} ms host, unsharded "
                  f"{ms[1]:.3f} / {ms[3]:.3f} ms (median of 5, in turns)")
    for batch, k in ((8, 10), (256, 100)):
        a_shards, a_plain, gather, ring = _shard_parts_ms(
            F, torch, sharded, plain, q[:batch], k)
        print(f"phase 6: [{card}] {label} batch {batch} k={k}: kernel A "
              f"over the {SHARDS} shards {a_shards:.4f} ms in all, over the "
              f"unsharded rows {a_plain:.4f} ms; the merge, kernel B on "
              f"({batch}, {SHARDS}, {k}) lists, {gather:.4f} ms a call; the "
              f"ring's {SHARDS * (SHARDS - 1)} two-list merges {ring:.4f} ms")
        sharded.config = sharded.config.with_updates(merge="allgather")
        host = _request_ms(sharded, q[:batch], k)
        profile_request(torch, lambda: sharded.topk(q[:batch], k),
                        f"{label} allgather batch {batch} k={k}", card, host)
    del sharded, plain
    torch.cuda.empty_cache()

    # capacity=: the same mutations on a sharded and an unsharded handle.
    keep = WIDE_ROWS - SHARD_ADDS
    cap_sh = pmt.Corpus(codes[:keep], storage="int8", scales=scales[:keep],
                        capacity=WIDE_ROWS, mesh=mesh)
    cap_plain = pmt.Corpus(codes[:keep], storage="int8",
                           scales=scales[:keep], capacity=WIDE_ROWS)
    del codes, scales
    torch.cuda.empty_cache()
    rng = np.random.default_rng(MUT_SEED)
    ids = rng.choice(keep, SHARD_UPDATES, replace=False)
    g = torch.Generator(device="cuda")
    g.manual_seed(MUT_SEED)
    rows = torch.randn((SHARD_UPDATES, WIDE_DIM), generator=g,
                       device="cuda")
    dead = rng.choice(WIDE_ROWS, SHARD_DELETES, replace=False)
    times = {}
    for name, h in (("sharded", cap_sh), ("unsharded", cap_plain)):
        h.topk(q[:8], 10)   # the cosine form exists before the mutations
        _, add = _host_ms(torch, lambda: h.add(tail))
        _, upd = _host_ms(torch, lambda: h.update(ids, rows))
        _, dele = _host_ms(torch, lambda: h.delete(dead))
        times[name] = (add, upd, dele)
        require(h.n == WIDE_ROWS, f"{label}: {name} holds {h.n} rows")
    print(f"phase 13: [{card}] {label} capacity={WIDE_ROWS}: add of "
          f"{SHARD_ADDS} / update of {SHARD_UPDATES} / delete of "
          f"{SHARD_DELETES} ms host, sharded "
          f"{' / '.join(f'{t:.3f}' for t in times['sharded'])}, unsharded "
          f"{' / '.join(f'{t:.3f}' for t in times['unsharded'])}: {cap_sh!r}")
    alive = torch.ones(WIDE_ROWS, dtype=torch.bool, device="cuda")
    alive[torch.from_numpy(dead).to("cuda")] = False
    F.reset_launch_counts()
    for merge in SHARD_MERGES:
        cap_sh.config = cap_sh.config.with_updates(merge=merge)
        for batch, k in WIDE_REQUESTS["int8"]:
            what = f"{label} mutated {merge} batch {batch} k={k}"
            got = cap_sh.topk(q[:batch], k)
            err, same = _same_result(torch, got, cap_plain.topk(q[:batch], k),
                                     what)
            require(not np.isin(got[0], dead).any(),
                    f"{what}: a deleted row was returned")
            line = (f"phase 13: {what}: matches the unsharded handle (max "
                    f"abs diff {err:.3g}, bit-identical {same}), no deleted "
                    f"id")
            if batch == 8:
                gate(*got, *_oracle_stored(F, torch, cap_plain, q[:8], k,
                                           alive=alive), what)
                line += ", passes the float64 oracle gate over the live rows"
            print(line)
    torch.cuda.synchronize()
    mutated, mut_core = _counted(F, f"{label} mutated", ("int8c",),
                                 wgmma=True)
    del cap_sh, cap_plain, rows, alive
    torch.cuda.empty_cache()
    return {"int8c": by_core["int8c"] + mut_core["int8c"],
            "int8c.wgmma": (launched["fused_topk_partial_wgmma"]
                            + mutated["fused_topk_partial_wgmma"]),
            "topk_merge": launched["topk_merge"] + mutated["topk_merge"]}


def _shard_f32(pmt, F, torch, q_np, c_np, card):
    """Phase 4's 2M x 256 corpus on a 2 x 2 mesh (two query blocks, two
    shards), batch 256 k=10 in bf16x3 and highest, held to the unsharded
    handle and the float64 oracle; ``distributed_matmul`` at the canonical
    shape against a float64 product.  Returns the launches of its sharded
    requests."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    c = torch.randn((BIG_ROWS, DIM), generator=gen, device="cuda")
    g3 = torch.Generator(device="cuda")
    g3.manual_seed(SEED + 3)
    q = torch.randn((256, DIM), generator=g3, device="cuda")
    mesh = pmt.make_mesh(2, 2, devices=["cuda:0"] * 4)
    label = f"{BIG_ROWS}x{DIM} f32 on a 2x2 mesh"
    ref = _oracle_on_card(torch, q, c, 10)
    launched = {"bf16x3": 0, "highest": 0, "topk_merge": 0}
    for precision in ("bf16x3", "highest"):
        cfg = pmt.SearchConfig(precision=precision)
        plain = pmt.Corpus(c, config=cfg)
        sharded = pmt.Corpus(c, config=cfg, mesh=mesh)
        F.reset_launch_counts()
        got = sharded.topk(q, 10)
        torch.cuda.synchronize()
        counts, cores = _counted(F, f"{label} {precision}", (precision,))
        launched[precision] += cores[precision]
        launched["topk_merge"] += counts["topk_merge"]
        what = f"{label} {precision} batch 256 k=10"
        err, same = _same_result(torch, got, plain.topk(q, 10), what)
        gate(*got, *ref, what)
        ms = [_request_ms(h, q, 10) for h in (sharded, plain, sharded,
                                              plain)]
        print(f"phase 13: {what}: matches the unsharded handle (max abs "
              f"diff {err:.3g}, bit-identical {same}), passes the float64 "
              f"oracle gate")
        print(f"phase 6: [{card}] {what}: request {ms[0]:.3f} / "
              f"{ms[2]:.3f} ms host, unsharded {ms[1]:.3f} / {ms[3]:.3f} ms "
              f"(median of 5, in turns)")
        del plain, sharded
    del c
    torch.cuda.empty_cache()
    qc, cc = torch.from_numpy(q_np).cuda(), torch.from_numpy(c_np).cuda()
    sc = pmt.shard_corpus(cc, mesh)
    out = pmt.distributed_matmul(qc, sc, mesh)
    _check_product(torch, out, qc, cc, "highest",
                   f"distributed_matmul {N_QUERIES}x{N_CORPUS}x{DIM}")
    mm = cuda_ms(lambda: pmt.distributed_matmul(qc, sc, mesh))
    lib = cuda_ms(lambda: torch.matmul(qc, cc.T))
    print(f"phase 13: [{card}] distributed_matmul {N_QUERIES}x{N_CORPUS}x"
          f"{DIM} on the 2x2 mesh: within the float64 gate; {mm:.4f} ms "
          f"(CUDA events) beside torch.matmul f32 unsharded {lib:.4f} ms")
    return launched


def _shard_clustered(pmt, F, torch, card):
    """Phase 8's 2M x 256 f32 blob mixture as a ClusteredCorpus on SHARDS
    shards: exhaustive requests equal the dense scan, probed recall@10
    against them reported.  Returns the launches of its requests."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    c, queries = _blobs(torch, gen, BIG_ROWS, DIM)
    mesh = pmt.make_mesh(1, SHARDS, devices=["cuda:0"] * SHARDS)
    clustered, built = _host_ms(torch, lambda: pmt.ClusteredCorpus(
        c, mesh=mesh))
    single = pmt.ClusteredCorpus(c)
    dense = pmt.Corpus(c)
    del c
    q = queries(256)
    label = f"{BIG_ROWS}x{DIM} f32 clustered on {SHARDS} shards"
    print(f"phase 13: {label}: {clustered!r} built in {built:.1f} ms host "
          f"({clustered._lt} tiles a shard, striped)")
    F.reset_launch_counts()
    results = {(batch, probe): clustered.topk(q[:batch], 10, probe=probe)
               for batch in (8, 256) for probe in (None, PROBE)}
    torch.cuda.synchronize()
    launched, cores = _counted(F, f"{label}", ("bf16x3",), tiles=True)
    for batch in (8, 256):
        what = f"{label} exhaustive batch {batch} k=10"
        err, same = _same_result(torch, results[(batch, None)],
                                 dense.topk(q[:batch], 10), what)
        exact = results[(batch, None)][0].astype(np.int64)
        got = results[(batch, PROBE)][0].astype(np.int64)
        one = single.topk(q[:batch], 10, probe=PROBE)[0].astype(np.int64)
        recall, recall_one = (np.mean([len(set(a) & set(b)) / 10
                                       for a, b in zip(x, exact)])
                              for x in (got, one))
        ms = [_request_ms(h, q[:batch], 10) for h in (clustered, dense)]
        probed = [_host_ms(torch, lambda: h.topk(q[:batch], 10,
                                                 probe=PROBE))[1]
                  for h in (clustered, single) for _ in range(5)]
        print(f"phase 13: {what}: equals the dense scan (max abs diff "
              f"{err:.3g}, bit-identical {same}); probe {PROBE} recall@10 "
              f"against it {recall:.4f}, unsharded ClusteredCorpus "
              f"{recall_one:.4f} (reported, not gated)")
        print(f"phase 6: [{card}] {label} batch {batch} k=10: exhaustive "
              f"request {ms[0]:.3f} ms host (dense Corpus {ms[1]:.3f}); "
              f"probe {PROBE} {statistics.median(probed[:5]):.3f} ms "
              f"(unsharded ClusteredCorpus "
              f"{statistics.median(probed[5:]):.3f})")
    del clustered, single, dense
    torch.cuda.empty_cache()
    return {"bf16x3": cores["bf16x3"], "topk_merge": launched["topk_merge"],
            "tiles": launched["fused_topk_partial_tiles"]}


def _shard_nccl(pmt, torch, q_np, c_np):
    """A one-rank NCCL process group (``init_distributed`` with the JAX
    package's keywords) carrying one request of each merge: the
    collectives' code runs, on the card."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pmt.init_distributed(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=1, process_id=0)
    try:
        require(torch.distributed.get_backend() == "nccl",
                f"backend {torch.distributed.get_backend()}")
        mesh = pmt.make_mesh(1, SHARDS, devices=["cuda:0"] * SHARDS)
        require(mesh.distributed, "the mesh did not see the process group")
        sc = pmt.shard_corpus(torch.from_numpy(c_np).cuda(), mesh)
        ref = numpy_oracle(q_np, c_np, 10)
        for merge in SHARD_MERGES:
            v, i = pmt.distributed_topk(torch.from_numpy(q_np).cuda(), sc,
                                        10, "cosine", mesh,
                                        pmt.SearchConfig(merge=merge))
            gate(i.cpu().numpy(), v.cpu().numpy().astype(np.float64), *ref,
                 f"one-rank NCCL {merge}")
        print(f"phase 13: a one-rank NCCL group ({mesh!r}) carried the "
              f"canonical request through both merges; passes the float64 "
              f"oracle gate")
    finally:
        torch.distributed.destroy_process_group()


def phase_sharded(pmt, F, torch, q_np, c_np, card):
    """Phase 13: sharded search on the one card, each leg with its own
    phase 5 counts.  Returns the launches to add to the kernels line, by
    its keys ("int8c", "int8c.wgmma", "bf16x3", "highest", "topk_merge",
    "tiles")."""
    t0 = time.perf_counter()
    total = {}
    legs = (lambda: _shard_wide(pmt, F, torch, card),
            lambda: _shard_f32(pmt, F, torch, q_np, c_np, card),
            lambda: _shard_clustered(pmt, F, torch, card))
    for leg in legs:
        for key, n in leg().items():
            total[key] = total.get(key, 0) + n
        torch.cuda.empty_cache()
    _shard_nccl(pmt, torch, q_np, c_np)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s host in all")
    return total


# Phase 14: the seven example scripts at their default (TPU) sizes, each
# with the arguments given here (benchmark_topk's NumPy baseline timed
# over fewer calls, to keep the phase within a few minutes).
EXAMPLES = (
    ("quickstart", []),
    ("serving", []),
    ("benchmark_topk", ["--warmup", "1", "--iters", "3"]),
    ("benchmark_matmul", []),
    ("benchmark_bigcorpus", []),
    ("benchmark_clustered", []),
    ("benchmark_scaling", []),
)


def phase_examples(F, torch, card):
    """Phase 14: ``polars_matmul_tpu_torch.examples`` on the card, each
    script's ``main`` in this process (its own checks raise on a wrong
    result), counted like phase 5.  Returns the launches to add to the
    kernels line, by entry name."""
    import importlib

    F.reset_launch_counts()
    t_all = time.perf_counter()
    for name, argv in EXAMPLES:
        mod = importlib.import_module(
            f"polars_matmul_tpu_torch.examples.{name}")
        print(f"phase 14: [{card}] python -m polars_matmul_tpu_torch."
              f"examples.{name} {' '.join(argv)}".rstrip(), flush=True)
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        require(out["device"] == "cuda", f"examples.{name} ran on "
                f"{out['device']}")
        print(f"phase 14: examples.{name}: every check passed, "
              f"{time.perf_counter() - t0:.1f} s host", flush=True)
        del out
        torch.cuda.empty_cache()
    counts, cores = dict(F.launches), dict(F.core_launches)
    print(f"phase 5: launches on the examples' path: {counts}, by core "
          f"{cores}; {time.perf_counter() - t_all:.1f} s host")
    for key in ("fused_topk_partial", "fused_topk_partial_tiles",
                "fused_topk_partial_wgmma", "fused_topk_partial_gated",
                "topk_merge"):
        require(counts[key] > 0, f"{key} never launched on the examples' "
                                 f"path")
    for core in ("bf16x3", "bf16c", "int8c", "int4c"):
        require(cores[core] > 0, f"{core} never launched on the examples' "
                                 f"path")
    for key in ("fused_topk_plain", "fused_topk_partial_plain",
                "topk_merge_plain"):
        require(counts[key] == 0, f"{key} ran on the examples' path")
    added = {f"fused_topk_partial.{core}": n for core, n in cores.items()}
    added.update({"topk_merge": counts["topk_merge"],
                  "fused_topk_partial.tiles":
                      counts["fused_topk_partial_tiles"],
                  "fused_topk_partial.gated":
                      counts["fused_topk_partial_gated"]})
    return added


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # A fresh autotune cache: a winner persisted by an earlier run must not
    # change what the all-defaults paths launch.
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    os.environ["PMM_TPU_CACHE_DIR"] = tempfile.mkdtemp(
        prefix="autotune-", dir=build)
    import polars_matmul_tpu_torch as pmt
    from polars_matmul_tpu_torch.kernels import fused_topk as F

    card = phase_card()
    phase_build()
    err = phase_compare(F)

    rng = np.random.default_rng(SEED)
    q = rng.standard_normal((N_QUERIES, DIM)).astype(np.float32)
    c = rng.standard_normal((N_CORPUS, DIM)).astype(np.float32)

    # Phases 3 and 4 are the f32 main path: count only their launches.
    F.reset_launch_counts()
    phase_canonical(pmt, q, c)
    corpus_big, requests = phase_big(pmt, torch)
    torch.cuda.synchronize()
    counts, cores = dict(F.launches), dict(F.core_launches)
    print(f"phase 5: launches on the f32 main path: {counts}, by core "
          f"{cores}")
    for name in ("fused_topk_partial", "fused_topk_partial_radix",
                 "fused_topk_partial_bucket", "fused_topk_partial_gstack",
                 "fused_topk_partial_gstack_bigk", "fused_topk_partial_stack",
                 "topk_merge"):
        require(counts[name] > 0, f"{name} never launched on the main path")
    for core in ("bf16x3", "highest"):
        require(cores[core] > 0, f"{core} never launched on the main path")
    for name in ("fused_topk_plain", "fused_topk_partial_plain",
                 "topk_merge_plain"):
        require(counts[name] == 0, f"{name} ran on the main path")

    per_kernel = phase_times(pmt, F, torch, q, c, corpus_big, requests, card)
    del corpus_big, requests
    torch.cuda.empty_cache()
    wide, wide_counts = phase_wide(pmt, F, torch, card, err)
    per_kernel.update(wide)
    torch.cuda.empty_cache()
    per_kernel["tiles"], tiles_launches = phase_clustered(pmt, F, torch,
                                                          card, err)
    _gate_summary(card)
    _bucket_summary(card)
    _gstack_summary(card)
    _stack_summary(card)
    launches = dict(cores, **wide_counts)
    launches["topk_merge"] += counts["topk_merge"]
    kernels = [dict({"name": f"fused_topk_partial.{core}", "route": "cuda",
                     "source": KERNEL_SRC + "fused_topk.cu",
                     "replaces": f"{TPU_KERNEL}:{CORE_LINE[core]}",
                     "launches": launches[core], "max_abs_err": err[core]},
                    **per_kernel[core])
               for core in F.CORES]
    # Each core of the f32 main path at k=100 and 512: the entry's
    # "selection" names the route its launches took.
    kernels += [dict({"name": f"fused_topk_partial.{core}.k{k}",
                      "route": "cuda", "source": KERNEL_SRC + "fused_topk.cu",
                      "replaces": f"{TPU_KERNEL}:{CORE_LINE[core]}",
                      "launches": launches[core],
                      "max_abs_err": err[core]},
                     **per_kernel[f"{core}.k{k}"])
                for core in ("bf16x3", "highest") for k in (100, 512)]
    kernels += [dict({"name": f"fused_topk_partial.{core}.wgmma",
                      "route": "cuda", "source": KERNEL_SRC + "ring_wgmma.cuh",
                      "replaces": f"{TPU_KERNEL}:{CORE_LINE[core]}",
                      "launches": launches[core + ".wgmma"],
                      "max_abs_err": err[core], "producer": WG_PRODUCER},
                     **per_kernel[core + ".wgmma"])
                for core in STORED]
    kernels.append(dict({"name": "topk_merge", "route": "cuda",
                         "source": KERNEL_SRC + "topk_merge.cu",
                         "replaces": TPU_KERNEL + ":922",
                         "launches": launches["topk_merge"],
                         "max_abs_err": err["topk_merge"]},
                        **per_kernel["topk_merge"]))
    kernels.append(dict({"name": "fused_topk_partial.tiles", "route": "cuda",
                         "source": KERNEL_SRC + "fused_topk.cu",
                         "replaces": TPU_KERNEL + ":2162",
                         "launches": tiles_launches,
                         "max_abs_err": err["tiles"]},
                        **per_kernel["tiles"]))
    # Kernel A with the carry gate on: its launches on the main paths
    # (phase 14's benchmark_bigcorpus, and wherever prune="auto" turns it
    # on); its results equal the gate off bit for bit (phase 2), so its
    # error against the plain version is the bf16x3 core's.
    kernels.append(dict({"name": "fused_topk_partial.gated", "route": "cuda",
                         "source": KERNEL_SRC + "fused_topk.cu",
                         "replaces": GATE_SRC,
                         "launches": counts["fused_topk_partial_gated"],
                         "max_abs_err": err["bf16x3"]},
                        **per_kernel["gated"]))
    # Kernel A asked for the bucket selection (the JAX kernel's
    # _select_bucket): its launches on the f32 main path (phase 4's
    # selection="bucket" request); its lists equal the insertion's bit for
    # bit (phase 2), so its error against the plain version is the bf16x3
    # core's.
    kernels.append(dict({"name": "fused_topk_partial.bucket",
                         "route": "cuda",
                         "source": KERNEL_SRC + "fused_topk.cu",
                         "replaces": BUCKET_SRC,
                         "launches": counts["fused_topk_partial_bucket"],
                         "max_abs_err": err["bf16x3"]},
                        **per_kernel["bucket"]))
    # Kernel A asked for the gstack selection (the JAX kernel's gstack
    # build, its detector and gpop's finish), with its exact re-walk: its
    # launches on the f32 main path (phase 4's selection="gstack" and
    # "gpop" requests); its lists equal the insertion's bit for bit (phase
    # 2), so its error against the plain version is the bf16x3 core's.
    kernels.append(dict({"name": "fused_topk_partial.gstack",
                         "route": "cuda",
                         "source": KERNEL_SRC + "fused_topk.cu",
                         "replaces": GSTACK_SRC,
                         "launches": counts["fused_topk_partial_gstack"],
                         "max_abs_err": err["bf16x3"]},
                        **per_kernel["gstack"]))
    # The gstack selection above k = 128 (the JAX kernel's big-k gstack):
    # its launches on the f32 main path (phase 4's selection="gstack"
    # requests where it is built); its lists equal the radix selection's
    # on the same splits bit for bit (phase 2), so its error against the
    # plain version is the bf16x3 core's.
    kernels.append(dict({"name": "fused_topk_partial.gstack_bigk",
                         "route": "cuda",
                         "source": KERNEL_SRC + "fused_topk_gstack_big.cu",
                         "replaces": GSTACK_BIG_SRC,
                         "launches": counts["fused_topk_partial_gstack_bigk"],
                         "max_abs_err": err["bf16x3"]},
                        **per_kernel["gstack_bigk"]))
    # Kernel A asked for the stack selection (the JAX kernel's
    # _select_stack): its launches on the f32 main path (phase 4's "auto"
    # requests in its class and its selection="stack" request); its lists
    # equal the slack's bit for bit (phase 2), so its error against the
    # plain version is the bf16x3 core's.
    kernels.append(dict({"name": "fused_topk_partial.stack",
                         "route": "cuda",
                         "source": KERNEL_SRC + "fused_topk.cu",
                         "replaces": STACK_SRC,
                         "launches": counts["fused_topk_partial_stack"],
                         "max_abs_err": err["bf16x3"]},
                        **per_kernel["stack"]))
    kernels += phase_matmul(pmt, F, torch, q, c, card)
    kernels += phase_floor(F, torch, card)
    torch.cuda.empty_cache()
    mutation = phase_mutation(pmt, F, torch, card)
    torch.cuda.empty_cache()
    arrow = phase_arrow(pmt, F, torch, q, c, card)
    torch.cuda.empty_cache()
    sharded = phase_sharded(pmt, F, torch, q, c, card)
    torch.cuda.empty_cache()
    examples = phase_examples(F, torch, card)
    for entry in kernels:
        name = entry["name"]
        entry["launches"] += (mutation.get(MUTATION_KEYS.get(name), 0)
                              + arrow.get(ARROW_KEYS.get(name), 0)
                              + sharded.get(SHARD_KEYS.get(name), 0)
                              + examples.get(name, 0))
    require(all(entry["launches"] > 0 for entry in kernels
                if entry["name"] == "fused_topk_partial.gated"),
            "kernel A never launched with the carry gate on a main path")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
