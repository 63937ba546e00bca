"""Probed (clustered) search benchmark: bytes-read scaling + recall.

The port of the JAX package's ``examples/benchmark_clustered.py``.  A
small batch against a big corpus is bound by the corpus bytes it reads;
probed search reads fewer: rows are k-means clustered into whole corpus
tiles, and each query block visits only the ``probe`` fraction of tiles
its centroid scores rank best (kernel A walks its block's tile list;
unlisted tiles are never read).  The expectation checked: search time
falls with ``probe`` and recall against the exhaustive scan stays high
where the data cluster.

The corpus is a Gaussian blob mixture made on the device from seeded
``torch.Generator`` draws (the JAX script draws it with ``jax.random`` on
the TPU; the values differ): 2,000,000 x 256 around 200 centres on the
card, 20,000 x 256 on the CPU by default, 256 clusters, batch 64, probes
1.0 / 0.25 / 0.1 / 0.05.  It is clustered and laid out step by step as
the JAX script does (``kmeans`` on a sample, ``assign_rows``,
``cluster_layout``, ``permute_rows``, ``prepare_corpus``; ``probe_tiles``
each request).  Then the drift -> rebuild part: a ``ClusteredCorpus`` of
120,000 x 64 NumPy rows (seed 7, the JAX script's draws) grown by half
its rows from new centres, before and after ``rebuild()``.

    python -m polars_matmul_tpu_torch.examples.benchmark_clustered [--cpu]
        [--rows 2000000] [--dim 256] [--k 10] [--clusters 256]
        [--batch 64] [--probes 1.0 0.25 0.1 0.05]

Times: ``ms/search`` is a probed search's device time (``probe_tiles``
plus ``fused_topk_prepared`` in a CUDA graph of ``--iters`` calls,
``utils.profiling.graph_ms``), ``ms/call`` the same between CUDA events;
``ingestion`` and ``rebuild`` are host times.  Checked (a failure fails
the run): recall 1 at probe 1.0, probed lists ascending and within the
layout, and the exhaustive results unchanged by ``rebuild()``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import polars_matmul_tpu_torch as pmt
from polars_matmul_tpu_torch.config import SearchConfig
from polars_matmul_tpu_torch.kernels import fused_topk as F
from polars_matmul_tpu_torch.ops.cluster import (assign_rows, cluster_layout,
                                                 kmeans, permute_rows,
                                                 probe_tiles, resolve_probe)
from polars_matmul_tpu_torch.ops.metrics import Metric

from ._common import (card, check, device_ms, event_ms, fmt, host_ms, parser,
                      pick_device, sync)

CARD_ROWS = 2_000_000
CPU_ROWS = 20_000


def _gen(device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def blobs(n, m, dim, n_centers, device, chunk=1 << 20):
    """Corpus rows and queries around ``n_centers`` centres (spread 4),
    made on the device in row chunks."""
    centers = torch.randn((n_centers, dim), generator=_gen(device, 0),
                          device=device) * 4.0
    ga, gn = _gen(device, 1), _gen(device, 2)
    c = torch.empty((n, dim), device=device)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        comp = torch.randint(0, n_centers, (r1 - r0,), generator=ga,
                             device=device)
        c[r0:r1] = centers[comp] + torch.randn((r1 - r0, dim), generator=gn,
                                               device=device)
    qcomp = torch.randint(0, n_centers, (m,), generator=_gen(device, 9),
                          device=device)
    q = centers[qcomp] + torch.randn((m, dim), generator=_gen(device, 4),
                                     device=device)
    return c, q


def recall(idx, exact):
    k = exact.shape[1]
    return float(np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(idx, exact)]))


def drift_rebuild(rows, device):
    """The JAX script's drift -> rebuild mechanics, on its NumPy draws."""
    rng2 = np.random.default_rng(7)
    nc, dim2 = min(rows, 120_000), 64
    centers = rng2.standard_normal((40, dim2)).astype(np.float32) * 4.0
    base = (centers[rng2.integers(0, 40, nc)]
            + rng2.standard_normal((nc, dim2))).astype(np.float32)
    cc = pmt.ClusteredCorpus(base, clusters=40, device=device)
    new_centers = (np.full((1, dim2), 18.0, np.float32)
                   + rng2.standard_normal((12, dim2)) * 6.0)
    drift_rows = (new_centers[rng2.integers(0, 12, nc // 2)]
                  + rng2.standard_normal((nc // 2, dim2))).astype(np.float32)
    cc.add(drift_rows)
    qd = (new_centers[rng2.integers(0, 12, 16)]
          + rng2.standard_normal((16, dim2))).astype(np.float32)
    ei, ev = cc.topk(qd, 10)

    def rec_at(pr):
        pi, _ = cc.topk(qd, 10, probe=pr)
        return recall(pi, ei)

    r_before = rec_at(0.2)
    d_before, tiles_before = cc.drift, cc.layout.n_tiles
    sync(device)
    t0 = time.perf_counter()
    cc.rebuild()
    sync(device)
    t_rebuild = (time.perf_counter() - t0) * 1e3
    ei2, ev2 = cc.topk(qd, 10)
    exhaustive_ok = bool(
        np.array_equal(ei2, ei)
        or np.allclose(np.sort(ev2, 1), np.sort(ev, 1), rtol=1e-6))
    r_after = rec_at(0.2)
    print(f"\ndrift -> rebuild ({nc} rows + {nc // 2} drifted, probe=0.2):")
    print(f"  drift signal {d_before:.2f} -> {cc.drift:.2f}; tiles "
          f"{tiles_before} -> {cc.layout.n_tiles} (compaction); rebuild "
          f"{t_rebuild:.0f} ms host")
    print(f"  exhaustive invariant: {exhaustive_ok}; probed recall@10 "
          f"{r_before:.3f} -> {r_after:.3f} (workload-dependent; drift says "
          f"re-measure)")
    check(exhaustive_ok, "rebuild() changed the exhaustive results")
    check(cc.drift == 0.0, f"drift {cc.drift} after rebuild()")
    return {"drift_before": d_before, "drift_after": cc.drift,
            "tiles_before": tiles_before, "tiles_after": cc.layout.n_tiles,
            "rebuild_host_ms": t_rebuild, "recall_before": r_before,
            "recall_after": r_after, "exhaustive_ok": exhaustive_ok}


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--rows", type=int, default=None,
                    help=f"default {CARD_ROWS} on the card, {CPU_ROWS} on "
                         f"the CPU")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--clusters", type=int, default=256)
    ap.add_argument("--centers", type=int, default=200,
                    help="generator mixture components")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--probes", type=float, nargs="+",
                    default=[1.0, 0.25, 0.1, 0.05])
    ap.add_argument("--iters", type=int, default=40,
                    help="calls in the CUDA graph a time is taken from")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    n = args.rows or (CPU_ROWS if device.type == "cpu" else CARD_ROWS)
    dim, k, m = args.dim, args.k, args.batch
    cfg = SearchConfig(use_autotune_cache=False)
    tn = F.layout_tile_rows(dim, cfg, k)
    tm = F.probe_block_rows(m, dim, cfg, k)

    c, q = blobs(n, m, dim, args.centers, device)
    # --- cluster + permuted layout (ingestion cost, one-shot) -----------
    sync(device)
    t0 = time.perf_counter()
    sample = c[torch.randperm(n, generator=_gen(device, 3),
                              device=device)[:min(n, 131072)]]
    cent, _ = kmeans(sample, args.clusters, iters=8, seed=0)
    assign = assign_rows(c, cent)
    lay = cluster_layout(assign, args.clusters, tn)
    perm = torch.as_tensor(lay.perm, device=device)
    cperm = permute_rows(c, perm)
    cp, cbp = F.prepare_corpus(cperm, Metric.COSINE,
                               precision=F.kernel_precision(cfg.precision))
    cbp = torch.where(perm >= 0, cbp, torch.full_like(cbp, float("-inf")))
    sync(device)
    t_ing = time.perf_counter() - t0
    del c, cperm, sample
    n_tiles = lay.n_tiles
    tc = torch.as_tensor(lay.tile_cluster, device=device)
    print(f"corpus {n} x {dim} in {args.clusters} clusters -> {n_tiles} "
          f"tiles of {tn} rows (+{lay.n_padded - n} slack), ingestion "
          f"{t_ing:.1f}s host, device={device.type} ({card(device)})")

    def search(p):
        tiles = (None if p is None else
                 probe_tiles(q, cent, tc, p=p, tm=tm, metric_v="cosine"))
        return F.fused_topk_prepared(q, cp, cbp, k, "cosine", config=cfg,
                                     tiles=tiles, tn=tn)

    exact_idx = None
    hdr = (f"{'probe':>8s} {'tiles':>6s} {'ms/search':>10s} {'ms/call':>9s} "
           f"{'corpus GB/s':>12s} {'recall@' + str(k):>10s}")
    print(hdr)
    print("-" * len(hdr))
    rows = []
    for probe in args.probes:
        p, exhaustive = resolve_probe(float(probe), n_tiles)
        pk = None if exhaustive else p
        gb = -(-m // tm) * p * tn * dim * 4 / 1e9
        if pk is not None:
            tiles = probe_tiles(q, cent, tc, p=pk, tm=tm, metric_v="cosine")
            check(bool((tiles[:, 1:] > tiles[:, :-1]).all())
                  and int(tiles.min()) >= 0 and int(tiles.max()) < n_tiles,
                  f"probe {probe}: the tile lists are not ascending ids of "
                  f"the layout")
        idx = search(pk)[1].cpu().numpy()
        if exact_idx is None and exhaustive:
            exact_idx = idx
        rec = float("nan") if exact_idx is None else recall(idx, exact_idx)
        if exhaustive:
            check(rec == 1.0, f"probe {probe} is exhaustive but recalls "
                              f"{rec}")
        t = device_ms(lambda: search(pk), device, calls=args.iters)
        if t is None:
            t = host_ms(lambda: search(pk), device, warmup=1, iters=3)
        call = event_ms(lambda: search(pk), device)
        rows.append({"probe": probe, "tiles": p, "ms_search": t,
                     "ms_call": call, "gb_per_s": gb / (t / 1e3),
                     "recall": rec})
        print(f"{probe:8.2f} {p:6d} {t:10.3f} {fmt(call)} "
              f"{gb / (t / 1e3):12.1f} {rec:10.3f}")
    del cp, cbp
    return {"device": device.type, "n": n, "n_tiles": n_tiles, "tn": tn,
            "ingestion_s": t_ing, "rows": rows,
            "drift": drift_rebuild(n, device)}


if __name__ == "__main__":
    main()
