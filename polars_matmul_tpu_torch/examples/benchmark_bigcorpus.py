"""Big-corpus serving benchmark: storage tiers x kernel A's carry gate.

The port of the JAX package's ``examples/benchmark_bigcorpus.py``:
millions of resident corpus rows searched by small query batches, in the
four storage tiers, with ``SearchConfig.prune`` "on" and "off":

- the carry gate (``prune``): kernel A skips a tile's selection when no
  row's score in it beats that row's current k-th value.  Exact: the
  results are the same bit for bit (checked here).  On the TPU the gate
  skips k extraction passes a tile; kernel A's selection already drops
  every score below the k-th value, so here it saves the pass that finds
  none (PERF.md has its times on the H100);
- the storage tier: f32 (the bf16x3 [hi | lo] split: f32's bytes), bf16
  (half), int8 (a quarter), int4 (an eighth).  A small batch is bound by
  the corpus bytes it reads.

The corpus is made on the device from a seeded ``torch.Generator`` (the
JAX script draws it with ``jax.random`` on the TPU; the values differ),
2,000,000 x 256 on the card and 20,000 x 256 on the CPU by default.
Each tier is prepared from it as the JAX script prepares its own
(``prepare_corpus``, ``quantize_int8``, ``quantize_int4``).

    python -m polars_matmul_tpu_torch.examples.benchmark_bigcorpus [--cpu]
        [--rows 2000000] [--dim 256] [--k 10] [--batches 8 64]

Times: ``ms/search`` is a search's device time (``fused_topk_prepared``,
kernels A + B and the query prep, in a CUDA graph of ``--iters`` calls,
``utils.profiling.graph_ms``); ``ms/call`` the same call between CUDA
events around batches of calls (the host's enqueue shows where it is the
longer); ``corpus GB/s`` the tier's bytes over ``ms/search``; ``skipped``
the share of kernel A's tiles the gate skipped (its launch's counter).
On the CPU the plain versions run and ``ms/search`` is the host clock.
"""

from __future__ import annotations

import torch

from polars_matmul_tpu_torch.config import SearchConfig
from polars_matmul_tpu_torch.kernels import fused_topk as F
from polars_matmul_tpu_torch.ops.metrics import Metric

from ._common import (card, check, device_ms, event_ms, fmt, host_ms, parser,
                      pick_device)

CARD_ROWS = 2_000_000
CPU_ROWS = 20_000


def build_tiers(n: int, dim: int, device, seed: int = 0,
                chunk: int = 1 << 20):
    """{tier: (precision, cp, cbp)} of one corpus made on ``device`` from
    ``seed``, normal rows made in chunks; the f32 rows are freed after."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    c = torch.empty((n, dim), device=device)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        c[r0:r1] = torch.randn((r1 - r0, dim), generator=gen, device=device)
    tiers = {"f32/bf16x3": ("bf16x3", *F.prepare_corpus(
        c, Metric.COSINE, precision="bf16x3"))}
    tiers["bf16"] = ("bf16c", *F.prepare_corpus(
        c.to(torch.bfloat16), Metric.COSINE, precision="bf16c"))
    codes, scales = F.quantize_int8(c)
    tiers["int8"] = ("int8c", *F.prepare_corpus(
        codes, Metric.COSINE, precision="int8c", scales=scales))
    del codes, scales
    ck = F.feature_geometry(dim)[0]
    p4, s4 = F.quantize_int4(c, ck)
    tiers["int4"] = ("int4c", *F.prepare_corpus(
        p4, Metric.COSINE, precision="int4c", scales=s4))
    del c, p4, s4
    return tiers


def skipped_share(q, cp, cbp, k, precision):
    """The share of kernel A's tiles its gate skipped on this request, and
    the tiles it gated (one launch at the request's geometry), or None
    off the card."""
    if not q.is_cuda:
        return None, 0
    qp = F.prepare_queries(q, "cosine", precision)
    dim = q.shape[1]
    tm, splits, tps = F.kernel_geometry(q.shape[0], cp.shape[0], k,
                                        precision, q.device, dim=dim)
    count = torch.zeros(2, dtype=torch.int32, device=q.device)
    F.fused_topk_partial(qp, cp, cbp, None, k, precision, splits, tps, tm,
                         prune=True, gate_count=count)
    gated, skipped = count.tolist()
    return skipped / max(1, gated), gated


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--rows", type=int, default=None,
                    help=f"default {CARD_ROWS} on the card, {CPU_ROWS} on "
                         f"the CPU")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 64])
    ap.add_argument("--iters", type=int, default=40,
                    help="calls in the CUDA graph a time is taken from")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    n = args.rows or (CPU_ROWS if device.type == "cpu" else CARD_ROWS)
    dim, k = args.dim, args.k
    cfg0 = SearchConfig(use_autotune_cache=False)
    tn = F.layout_tile_rows(dim, cfg0, k)
    print(f"corpus {n} x {dim}, k={k}, tile={tn} rows "
          f"({(n + tn - 1) // tn} tiles), device={device.type} "
          f"({card(device)})")
    tiers = build_tiers(n, dim, device)

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    hdr = (f"{'tier':>10s} {'batch':>6s} {'prune':>6s} {'ms/search':>10s} "
           f"{'ms/call':>9s} {'corpus GB/s':>12s} {'skipped':>8s}")
    print(hdr)
    print("-" * len(hdr))
    rows = []
    for name, (precision, cp, cbp) in tiers.items():
        gb = (cp.nbytes + cbp.nbytes) / 1e9
        for m in args.batches:
            q = torch.randn((m, dim), generator=gen, device=device)
            results = {}
            for prune in ("on", "off"):
                cfg = cfg0.with_updates(precision=precision, prune=prune)

                def search(cfg=cfg):
                    return F.fused_topk_prepared(q, cp, cbp, k, "cosine",
                                                 config=cfg,
                                                 precision=precision, tn=tn)

                before = F.launches["fused_topk_partial_gated"]
                results[prune] = search()
                if device.type == "cuda":
                    gated = F.launches["fused_topk_partial_gated"] > before
                    check(gated == (prune == "on"),
                          f"prune={prune!r} launched kernel A "
                          f"{'with' if gated else 'without'} the gate")
                t = device_ms(search, device, calls=args.iters)
                if t is None:
                    t = host_ms(search, device, warmup=1, iters=3)
                call = event_ms(search, device)
                share, gated_tiles = ((None, 0) if prune == "off" else
                                      skipped_share(q, cp, cbp, k, precision))
                rows.append({"tier": name, "batch": m, "prune": prune,
                             "ms_search": t, "ms_call": call,
                             "gb_per_s": gb / (t / 1e3),
                             "skipped": share, "gated_tiles": gated_tiles})
                print(f"{name:>10s} {m:6d} {prune:>6s} {t:10.3f} "
                      f"{fmt(call)} {gb / (t / 1e3):12.1f} "
                      f"{'' if share is None else f'{share:8.3f}'}")
            (v1, i1), (v0, i0) = results["on"], results["off"]
            check(torch.equal(i1, i0) and torch.equal(
                v1.view(torch.int32), v0.view(torch.int32)),
                f"{name} batch {m}: prune='on' differs from 'off'")
    return {"device": device.type, "n": n, "dim": dim, "k": k, "tn": tn,
            "rows": rows}


if __name__ == "__main__":
    main()
