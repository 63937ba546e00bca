#!/usr/bin/env python3
"""Smoke run of polars_matmul_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each printing one line or a few:

0. the card (nvidia-smi name and power limit), torch and CUDA versions;
1. build of the CUDA kernels from this checkout's sources (nvcc, sm_90a,
   one compiler per source, all started together);
2. each kernel against its plain PyTorch version on the card, over ragged
   shapes and at the shapes phases 3 and 4 give it, every metric and
   every core of kernel A (bf16x3, highest, bf16c, int8c, int4c; int4
   also above dim 4096), with and without a mask, with duplicate rows,
   and on integer tie data where the results must be bit-identical; the
   on-card quantizers against the host NumPy ones, bit for bit; kernel A
   walking random per-block tile lists (probed search) in every core,
   and a list of every tile against the dense scan, bit for bit;
3. the canonical workload (1000 queries x 10,000 rows x 256 dims, f32,
   cosine, seed 42) through ``topk`` and a resident ``Corpus`` at k=10,
   k=100, k=512 and precision="highest", each held to a float64 NumPy
   oracle;
4. a 2,000,000 x 256 resident corpus answering requests of 8 and 256
   queries at k=10 and k=100, each held to a float64 oracle on the card;
5. the launch counts of each main path (phases 3 and 4, each tier of
   phase 7, and the probed path of phase 8): its kernels and cores ran,
   the plain versions did not;
6. times from CUDA events: kernels against plain versions and library
   calls, and requests with their bounds;
7. the full-width path: a 10,000,000 x 768 corpus (the north-star shape)
   made on the card from seed 42, stored as int8 (requests of 8 and 256
   queries at k=10 and k=100), int4 and bf16 (8 and 256 queries at
   k=100), one tier at a time, each request through ``Corpus.topk`` held
   to a float64 oracle over what the tier stores; int8 recall@10 against
   the f32 corpus is reported; each tier's kernels are also checked
   against their plain versions at these shapes (phase 2's checks), real
   and integer tie data;
8. probed search: a 10,000,000 x 768 Gaussian blob mixture made on the
   card from seed 42, built into ``ClusteredCorpus(storage="int8")`` (the
   f32 source freed after), answering 8 and 256 queries at k=10 and 100
   with probe=0.05 and probe=None, and a 2,000,000 x 256 f32 clustered
   corpus answering 1000 queries (routed over several tile lists) at
   k=10 and 100, probe=0.05; each request held to a float64 oracle over
   exactly the rows its lists visited; probed recall@10 against the
   exhaustive scan reported; listed kernel A checked against its plain
   version at these shapes and timed against its bound and a library
   yardstick;
9. the tiled product and autotune: ``pallas_matmul`` (kernel C, both
   cores) driven from NumPy at the canonical 1000 x 10,000 x 256 shape and
   on card tensors at 8192 x 65,536 x 768, each held to a float64 product,
   with its launch counts; kernel C against its plain version over ragged
   shapes (and f64 inputs once) and at those two, against float64 too;
   CUDA-event times of kernel C, its plain version and ``torch.matmul``
   f32 beside the bound and the roofline share; ``autotune`` on the card
   (every candidate's time, the distinct launches it measured, the winner
   persisted under ``PMM_TPU_CACHE_DIR`` and served from there a second
   time, an all-defaults ``topk_torch`` adopting it, held to a float64
   oracle); explicit selections outside their envelope raising the JAX
   package's errors, dense and probed;
10. the attribution kit: kernel D (``csrc/floor.cu``, ``floor_stacks``)
   against its plain version in every core (bf16x3, int8c, int4c,
   int4-rint, int4-raw), at levels 0, 1, 4 and 5, every id rule (global,
   segmented, tile-local) and posu setting, over ragged shapes, integer tie
   data bit for bit; then its main path, the three experiments of
   ``polars_matmul_tpu_torch/tools`` at their JAX sizes (the canonical
   floor, 2M x 256 int8 at batch 256, 2M x 768 int8 / int4 at batch 8 and
   256; the floors JSON goes to ``build/floors.json``), counted; and each
   core's time at its experiment's shape beside kernel A's there, its
   plain version's, the library yardstick's and the bound.

The kernels: kernel A (``csrc/fused_topk.cu``, five cores, dense and
listed), kernel B (``csrc/topk_merge.cu``), kernel C (``csrc/matmul.cu``,
two cores) and kernel D (``csrc/floor.cu``, five cores; its staging and
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

import numpy as np

SEED = 42
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
# The tiled product (phase 9): ragged shapes, the canonical shape of
# examples/benchmark_matmul.py:45, and a large one (a 2.15 GB output).
MM_MS, MM_NS = (1, 37, 300, 1000), (1, 129, 5000, 10_000)
MM_DIMS = (1, 56, 256, 300, 768, 4100)
MM_SHAPES = ((N_QUERIES, N_CORPUS, DIM), (8192, 65_536, 768))
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


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def compare(v, i, v_ref, i_ref, rtol=RTOL, atol=ATOL, scale=0.0, what="",
            exact=False):
    """Top-k results agree: the same -inf slots, finite scores within
    tolerance, and indices equal except where the two scores tie within
    it; with ``exact``, scores and indices are bit-identical.  Returns the
    largest absolute score difference."""
    import torch

    require(v.shape == v_ref.shape, f"{what}: shape {v.shape} != "
            f"{v_ref.shape}")
    if exact:
        require(torch.equal(v, v_ref), f"{what}: scores differ")
        require(torch.equal(i, i_ref), f"{what}: indices differ")
        return 0.0
    inf_a, inf_b = torch.isinf(v), torch.isinf(v_ref)
    require(torch.equal(inf_a, inf_b) and torch.equal(v[inf_a], v_ref[inf_b]),
            f"{what}: infinite slots differ")
    fin = ~inf_a
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


def _ptxas_summary(log: str):
    """One line per compiled kernel from nvcc's -Xptxas -v output: its
    template arguments, registers and spilled bytes."""
    from polars_matmul_tpu_torch.kernels.matmul import CORES

    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?"
                      r"((?:fused_topk_partial|topk_merge|matmul|"
                      r"floor_stacks)_kernel)"
                      r"ILi(\d+)E(?:Li(\d+)E)?(?:Lb(\d)E)?", line)
        if m:
            args = ", ".join(a for a in m.groups()[1:3] if a is not None)
            if m.group(1) == "matmul_kernel":
                args = CORES[int(args)]
            if m.group(4) is not None:
                args += ", listed" if m.group(4) == "1" else ", dense"
            name, spill = f"{m.group(1)}<{args}>", ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and m.group(1) != "0":
            spill = f", spills {m.group(1)} B stored / {m.group(2)} B loaded"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers{spill}")
            name = None
    return lines


def phase_build():
    from polars_matmul_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s -> {_build.build_info['path']}")
    for line in _ptxas_summary(str(_build.build_info["log"])):
        print("  ptxas: " + line)


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
    tm, splits, tps = F.kernel_geometry(m, n, k, precision, qp.device)
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


def _check_quantizers(F, torch, gen):
    """The torch quantizers on the card against the host NumPy ones, bit
    for bit, on one ingestion chunk (zero rows included)."""
    from polars_matmul_tpu_torch.api import search as S

    for dim in (WIDE_DIM, 4200):
        c = torch.randn((4096, dim), generator=gen, device="cuda")
        c[::97] = 0.0
        host = c.cpu().numpy()
        codes, scales = F.quantize_int8(c)
        hc, hs = S._quantize_rows_np(host)
        require(np.array_equal(codes.cpu().numpy(), hc)
                and np.array_equal(scales.cpu().numpy(), hs),
                f"int8 quantizer on the card differs from the host at {dim}")
        ck, dpp, _ = F.feature_geometry(dim)
        packed, scales = F.quantize_int4(c, ck)
        hp, hs = S._quantize_rows_int4_np(host, ck, dpp)
        require(np.array_equal(packed.cpu().numpy(), hp)
                and np.array_equal(scales.cpu().numpy(), hs),
                f"int4 quantizer on the card differs from the host at {dim}")


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
        tm, splits, tps = F.kernel_geometry(m, tiles.shape[1] * tn, k,
                                            precision, qp.device, tm,
                                            listed=True)
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


# (m, n, dim, layout tile rows, query rows per list): one list, several,
# and lists shorter than a query tile (block_q=8, which fused_select pads).
LISTED_SHAPES = ((1, 129, 56, 128, 8), (37, 5000, 56, 128, 16),
                 (37, 5000, 300, 256, 8), (300, 5000, 768, 128, 128),
                 (300, 5000, 256, 256, 256))


def _compare_listed(F, torch, gen, err):
    """Phase 2 on tile lists: every core and metric over LISTED_SHAPES with
    random per-list tile lists (one tile, a third of them, all of them in
    a random subset), integer tie data bit-exact, and a list of every tile
    against the dense scan bit for bit.  Returns the case counts."""
    cases = ties = full = 0
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
                        require(torch.equal(lv, dv) and torch.equal(li, di),
                                f"every tile listed differs from the dense "
                                f"scan: {what}")
                        full += 1
    torch.cuda.synchronize()
    return cases, ties, full


def phase_compare(F, ms=(1, 37, 300), ns=(1, 129, 5000),
                  dims=(3, 56, 256, 300, 768), ks=(1, 10, 100, 512, 1024)):
    """Kernels A (every core) and B against their plain versions on CUDA
    tensors: over a ragged grid of shapes, then at the shapes phases 3
    and 4 give them (phase 7 checks its own).  Returns the largest
    absolute score difference of each core of kernel A and of kernel B."""
    import torch

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
    _check_quantizers(F, torch, gen)
    print(f"phase 2: {cases} ragged cases match (atol {ATOL} + rtol {RTOL} "
          f"x max(|score|, row term scale); kernel B bit-identical), every "
          f"core; {ties} integer tie cases bit-identical; the on-card "
          f"quantizers equal the host ones bit for bit")
    listed, listed_ties, full = _compare_listed(F, torch, gen, err)
    print(f"phase 2: listed kernel A (tile lists): {listed} ragged cases "
          f"match their plain version, {listed_ties} integer tie cases "
          f"bit-identical, every core; {full} lists of every tile equal "
          f"the dense result bit for bit; max abs err {err['tiles']:.3g}")

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
               (10, "highest"))


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
    return corpus, requests


def profile_request(torch, fn, label: str, card: str,
                    host_ms: float) -> None:
    """One request under torch.profiler: device time by kernel, and the
    device's busy share of ``host_ms``, the request's median host time
    measured without the profiler (which slows the host side)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # The package's own record_function ranges ("pmm.*") also carry
    # device time; count only the work itself.
    dev = sorted(((e.self_device_time_total, e.key)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0
                  and not e.key.startswith("pmm.")), reverse=True)
    busy = sum(t for t, _ in dev)
    if not dev:
        print(f"phase 6: [{card}] {label}: profiler saw no device time "
              f"(not measured)")
        return
    top = ", ".join(f"{name[:48]} {t / 1e3:.4f} ms" for t, name in dev[:5])
    print(f"phase 6: [{card}] {label} profile: device busy "
          f"{busy / 1e3:.4f} ms, {100 * busy / (host_ms * 1e3):.1f} % of the "
          f"{host_ms:.3f} ms request; {top}")


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


def phase_times(pmt, F, torch, q_np, c_np, corpus_big, requests, card):
    """Device times of kernels, plain versions and library calls, and
    request times.  Returns the per-kernel entries of the canonical k=10
    tiers (kernel A's bf16x3 and highest cores, kernel B)."""
    from polars_matmul_tpu_torch.ops.reference import exact_matmul

    q = torch.from_numpy(q_np).cuda()
    c = torch.from_numpy(c_np).cuda()
    # The library yardstick: the f32 cosine scores with one cuBLAS call,
    # then torch.topk (TF32 off: the function is exact f32).
    qn = q / q.norm(dim=1, keepdim=True)
    cn = c / c.norm(dim=1, keepdim=True)
    zero = torch.zeros(N_CORPUS, device="cuda")

    def library():
        with exact_matmul():
            return torch.topk(torch.addmm(zero, qn, cn.T), 10, dim=1)

    lib = cuda_ms(library)
    shape = f"{N_QUERIES}x{N_CORPUS}x{DIM} cosine k=10"
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
                                            precision, q.device)
        a = cuda_ms(lambda: F.fused_topk_partial(qp, cp, cbp, None, k,
                                                 precision, splits, tps, tm))
        a_plain = cuda_ms(lambda: F.fused_topk_partial_plain(
            qp, cp, cbp, None, k, precision, splits, tps))
        pv, pi = F.fused_topk_partial(qp, cp, cbp, None, k, precision,
                                      splits, tps, tm)
        b = cuda_ms(lambda: F.topk_merge(pv, pi, k))
        b_plain = cuda_ms(lambda: F.topk_merge_plain(pv, pi, k))
        if k == 10:
            passes, peak = ((3, "bfloat16") if precision == "bf16x3"
                            else (1, "float32_cuda_cores"))
            a_bound = _bound(
                qp.nbytes + cp.nbytes + cbp.nbytes + pv.nbytes + pi.nbytes,
                passes * 2 * N_QUERIES * N_CORPUS * DIM, peak)
            per_kernel[precision] = _entry(
                a, a_plain, lib, "torch.addmm + torch.topk (f32)", a_bound,
                shape)
            print(f"phase 6: [{card}] canonical k=10 {precision}: kernel A "
                  f"bound {a_bound[0]:.4f} ms ({a_bound[1]}); library "
                  f"torch.addmm + torch.topk {lib:.4f} ms")
        if (k, precision) == CANON_TIERS[0]:
            m = pv.shape[0]
            b_lib = cuda_ms(lambda: torch.topk(pv.reshape(m, -1), k, dim=1))
            b_bound = _bound(pv.nbytes + pi.nbytes + m * k * 8, 0,
                             "float32_cuda_cores")
            per_kernel["topk_merge"] = _entry(
                b, b_plain, b_lib, "torch.topk of the flattened split lists",
                b_bound, f"{m}x{splits}x{k} split lists")
            print(f"phase 6: [{card}] canonical k=10: kernel B bound "
                  f"{b_bound[0]:.4f} ms (bytes); library torch.topk over "
                  f"the flattened lists {b_lib:.4f} ms")
        print(f"phase 6: [{card}] canonical k={k} {precision} (tm={tm}, "
              f"splits={splits}): A+B {ab:.4f} ms, plain {plain:.4f} ms | "
              f"A {a:.4f} ms, A plain {a_plain:.4f} ms | B {b:.4f} ms, "
              f"B plain {b_plain:.4f} ms")
    canon = pmt.Corpus(c_np)
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
                        statistics.median(ts))
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
                        statistics.median(ts))
    return per_kernel


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


def _oracle_stored(F, torch, corpus, q, k, chunk=250_000):
    """float64 cosine top-k over what the tier stores: the codes for int8
    and int4 (their scale cancels), the prepared rows for bf16 (rows
    normalised in f32 and rounded to bf16, which the kernel scores as
    they are)."""
    qn = q.double()
    qn = qn / qn.norm(dim=1, keepdim=True)
    rows_all = (corpus._prepared_for(F.Metric.COSINE)[0]
                if corpus.storage == "bf16" else corpus._device)
    best_v, best_i = [], []
    for r0 in range(0, corpus.n, chunk):
        blk = rows_all[r0:r0 + chunk]
        if corpus.storage == "int4":
            blk = F.unpack_int4(blk, corpus.dim)
        rows = blk.double()
        if corpus.storage != "bf16":
            rows = rows / rows.norm(dim=1, keepdim=True)
        v, i = torch.topk(qn @ rows.T, k, dim=1)
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
    batch 8, k=100) and the launches of the tiers' main paths."""
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
        counts[core] = cores[core]
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
                            f"{label} batch {batch} k={k}", card, host)
            if (batch, k) == (8, 100):
                tm, splits, tps = F.kernel_geometry(batch, corpus.n, k, core,
                                                    qp.device)
                a = cuda_ms(lambda: F.fused_topk_partial(
                    qp, cp, cbp, None, k, core, splits, tps, tm), reps=5,
                    warmup=1)
                a_plain = cuda_ms(lambda: F.fused_topk_partial_plain(
                    qp, cp, cbp, None, k, core, splits, tps), reps=2,
                    warmup=1)
                a_bound = _bound(cp.nbytes + cbp.nbytes + qp.nbytes
                                 + batch * splits * k * 8, ops,
                                 "bfloat16")
                entries[core] = _entry(
                    a, a_plain, lib,
                    "torch.addmm + torch.topk on the dequantised bf16 rows",
                    a_bound, f"{label} cosine batch 8 k=100")
                print(f"phase 6: [{card}] {label} batch 8 k=100: kernel A "
                      f"{a:.3f} ms, A plain {a_plain:.3f} ms, bound "
                      f"{a_bound[0]:.3f} ms ({a_bound[1]})")
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

    def queries(m):
        label = torch.randint(0, CENTRES, (m,), generator=gen, device="cuda")
        return centres[label] + torch.randn((m, dim), generator=gen,
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


def _request_checked(F, torch, cc, q, k, probe, label):
    """One ``ClusteredCorpus.topk`` request held to the float64 oracle over
    the rows its blocks visited.  Returns (indices, host ms)."""
    t0 = time.perf_counter()
    idx, scores = cc.topk(q, k, probe=probe)
    host = (time.perf_counter() - t0) * 1e3
    order, qr, tiles, br = _probe_plan(cc, q, k, probe)
    ref_i, ref_v = _oracle_visited(F, torch, cc, qr, k, tiles, br)
    if order is not None:   # back to the caller's row order
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size)
        ref_i, ref_v = ref_i[inv], ref_v[inv]
    gate(idx, scores, ref_i, ref_v, label)
    share = 1.0 if tiles is None else tiles.shape[1] / cc.n_tiles
    print(f"phase 8: {label}: passes the float64 oracle gate over the "
          f"{share:.4f} of tiles each of its {-(-q.shape[0] // br)} "
          f"list(s) visited (first request {host:.1f} ms host"
          f"{', routed' if order is not None else ''})")
    return idx


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
                                        listed=True)
    args = (qp, cp, cbp, None, k, core, splits, tps)
    a = cuda_ms(lambda: F.fused_topk_partial(*args, tm, tiles, tn, br),
                reps=10, warmup=2)
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
    passes = 3 if core == "bf16x3" else 2
    bound = _bound(tiles.shape[0] * p * tn * row_bytes + qp.nbytes
                   + m * splits * k * 8,
                   passes * 2 * m * p * tn * cc.dim, "bfloat16")
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
                f"{label} batch {batch} k={k} probe={probe}")
    for k in (10, 100):
        _request_checked(F, torch, proxy, q2, k, PROBE,
                         f"{label2} batch {N_QUERIES} k={k} probe={PROBE}")
    torch.cuda.synchronize()
    launched, cores = dict(F.launches), dict(F.core_launches)
    print(f"phase 5: launches on the probed path: {launched}, by core "
          f"{cores}")
    for name in ("fused_topk_partial_tiles", "topk_merge"):
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
    torch.cuda.synchronize()
    counts, cores = dict(M.launches), dict(M.core_launches)
    print(f"phase 5: launches on the pallas_matmul path: {counts}, by core "
          f"{cores}")
    for core in M.CORES:
        require(cores[core] > 0, f"kernel C {core} never launched")
    require(counts["pallas_matmul_plain"] == 0,
            "pallas_matmul_plain ran on the pallas_matmul path")
    print(f"phase 9: pallas_matmul from NumPy at {N_QUERIES}x{N_CORPUS}x{DIM} "
          f"(precision highest, bf16x3, default, high, bf16c) and on card "
          f"tensors at {m}x{n}x{dim} (each core) pass the float64 product")
    return cores, ql, cl


def _compare_matmul(M, torch, large, err):
    """Kernel C against its plain version and float64 over ragged shapes,
    f64 inputs once, and at the main path's two shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    cases = 0
    for m in MM_MS:
        for n in MM_NS:
            for dim in MM_DIMS:
                q = torch.randn((m, dim), generator=gen, device="cuda")
                c = torch.randn((n, dim), generator=gen, device="cuda")
                for core in M.CORES:
                    out = M.pallas_matmul(q, c, precision=core)
                    err[f"mm.{core}"] = max(err[f"mm.{core}"], _check_product(
                        torch, out, q, c, core, f"m={m} n={n} dim={dim}",
                        plain=M.pallas_matmul_plain(q, c, core)))
                    cases += 1
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
    for m, n, dim in MM_SHAPES:
        if (m, n, dim) == MM_SHAPES[1]:
            q, c = large
        else:
            q = torch.randn((m, dim), generator=gen, device="cuda")
            c = torch.randn((n, dim), generator=gen, device="cuda")
        for core in M.CORES:
            out = M.pallas_matmul(q, c, precision=core)
            err[f"mm.{core}"] = max(err[f"mm.{core}"], _check_product(
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
          f"and the shapes {MM_SHAPES}; f64 inputs give f64 within "
          f"{off:.3g} of the float64 product; max abs err against plain "
          f"highest {err['mm.highest']:.3g}, bf16x3 {err['mm.bf16x3']:.3g}")


def _time_matmul(M, torch, large, card):
    """CUDA-event times of kernel C, its plain version and torch.matmul f32
    (TF32 off: the library yardstick, never called by the port) at the
    two shapes, beside the bound.  Returns the canonical shape's entries
    per core."""
    from polars_matmul_tpu_torch.ops.reference import exact_matmul
    from polars_matmul_tpu_torch.utils import profiling as P

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    entries = {}
    for m, n, dim in MM_SHAPES:
        if (m, n, dim) == MM_SHAPES[1]:
            (q, c), iters = large, 5
        else:
            q = torch.randn((m, dim), generator=gen, device="cuda")
            c = torch.randn((n, dim), generator=gen, device="cuda")
            iters = 20

        def library():
            with exact_matmul():
                return torch.matmul(q, c.T)

        lib = P.benchmark(library, iters=iters)["median_ms"]
        nbytes = (m * dim + n * dim + m * n) * 4
        flops = 2 * m * n * dim
        for core in M.CORES:
            ms = P.benchmark(lambda: M.pallas_matmul(q, c, precision=core),
                             iters=iters)["median_ms"]
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
            if (m, n, dim) == MM_SHAPES[0]:
                entries[core] = _entry(ms, plain, lib,
                                       "torch.matmul f32 (TF32 off)", bound,
                                       shape)
        del q, c
        torch.cuda.empty_cache()
    return entries


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
    err = {f"mm.{core}": 0.0 for core in M.CORES}
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
                 **times[core]) for core in M.CORES]


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
    geo = D.floor_geometry(m, n, core, levels, k, qp.device)
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
    experiment), its plain version's and the library's, the bound, and
    kernel A's time there.  Checks D against its plain version first."""
    _check_floor(D, torch, qp, cp, cb, core, levels, tn, ids, posu, k, err,
                 f"{name} main-path shape", False)
    m, n, dim = qp.shape[0], cp.shape[0], qp.shape[1] // 2
    geo = D.floor_geometry(m, n, core, levels, k, qp.device)
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
    blocks = D._occupancy[(qp.device.index, geo[0], core, levels)]
    print(f"phase 10: [{card}] kernel D {name} ({m}x{n}x{dim} {core} "
          f"L{levels} {ids}{' posu' if posu else ''}; tm={geo[0]}, "
          f"splits={geo[1]}, {blocks} block(s)/SM): {ms:.4f} ms, kernel A "
          f"({a_core}) there {a_ms:.4f} ms, plain {plain:.3f} ms, library "
          f"torch.addmm + pack + torch.topk {lib:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    entry = _entry(ms, plain, lib, "torch.addmm on bf16 rows + pack + "
                   "torch.topk over each cell's groups", bound,
                   f"{name}: {m}x{n}x{dim} L{levels} {ids}")
    return dict({"name": f"floor_stacks.{core}", "route": "cuda",
                 "source": KERNEL_SRC + "floor.cu", "replaces": FLOOR_SRC,
                 "launches": launches[core], "max_abs_err": err[core],
                 "kernel_a_ms": a_ms, "blocks_per_sm": blocks}, **entry)


def phase_floor(F, torch, card):
    """Phase 10 (with its phase 5 counts): kernel D against its plain
    version, then its main path, the three experiments at their JAX sizes
    (tools/exp_floor.py, exp_b256.py, exp_int4.py, ported), then each
    core's entry at its experiment's shape.  Returns kernel D's JSON
    entries."""
    from polars_matmul_tpu_torch.kernels import floor as D
    from polars_matmul_tpu_torch.tools import exp_b256, exp_floor, exp_int4

    t0 = time.perf_counter()
    err = {core: 0.0 for core in D.CORES}
    cases, ties = _compare_floor(D, F, torch, err)
    print(f"phase 10: kernel D matches its plain version in {cases} ragged "
          f"cases (every core, levels {FLOOR_LEVELS}, every id rule and "
          f"posu setting; decoded levels within atol {ATOL} + rtol {RTOL} x "
          f"max(|score|, row term scale) + {PACK_RTOL:.3g} x |score|, ids "
          f"exact where clear) and {ties} integer tie cases bit for bit; "
          f"global ids past 128 groups raise; took "
          f"{time.perf_counter() - t0:.1f} s")

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
    for name in ("fused_topk_partial", "topk_merge"):
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
    launches = dict(cores, **wide_counts)
    launches["topk_merge"] += counts["topk_merge"]
    kernels = [dict({"name": f"fused_topk_partial.{core}", "route": "cuda",
                     "source": KERNEL_SRC + "fused_topk.cu",
                     "replaces": f"{TPU_KERNEL}:{CORE_LINE[core]}",
                     "launches": launches[core], "max_abs_err": err[core]},
                    **per_kernel[core])
               for core in F.CORES]
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
    kernels += phase_matmul(pmt, F, torch, q, c, card)
    kernels += phase_floor(F, torch, card)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
