"""Sharded scaling benchmark: rows/s vs corpus-shard count.

The port of the JAX package's ``examples/benchmark_scaling.py``.  The
north-star pod configuration shards a 10M x 768 f32 corpus over several
hosts with a k=100 merge; this measures its building block on one card:
a 1,250,000 x 768 f32 corpus, 256 queries, k=100, on meshes that name
the card 1, 2 and 4 times (``make_mesh(devices=["cuda:0"] * s)``, as
``chip_smoke.py`` phase 13 does), each sharded request through both
merges (allgather and ring).  The shards share one card, so the numbers
are the fan-out's and the merges' costs, not traffic between cards.
With ``--cpu`` the mesh names the CPU 1, 2, 4 and 8 times over a 20,000
row corpus (the JAX script's 8-device CPU mesh): a structure test whose
numbers are not performance.

The corpus is drawn on the device from a seeded ``torch.Generator``: a
NumPy draw of 1.25M x 768 (the JAX script's) costs more host time than
the whole benchmark.  The queries too (seed 42).  Every sharded result
is checked against the one-shard handle's: the same indices (scores
within 1e-6), or a failure.

    python -m polars_matmul_tpu_torch.examples.benchmark_scaling [--cpu]
        [--corpus ROWS] [--dim 768] [--queries 256] [--k 100]

Prints rows/s = queries x corpus rows / the request's host time (median
of three ``Corpus.topk`` calls, results on the host).
"""

from __future__ import annotations

import numpy as np
import torch

import polars_matmul_tpu_torch as pmt
from polars_matmul_tpu_torch.config import SearchConfig

from ._common import card, check, host_ms, parser, pick_device

CARD_ROWS = 1_250_000
CPU_ROWS = 20_000


def draw(rows, dim, device, seed, chunk=1 << 20):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((rows, dim), device=device)
    for r0 in range(0, rows, chunk):
        r1 = min(rows, r0 + chunk)
        out[r0:r1] = torch.randn((r1 - r0, dim), generator=gen,
                                 device=device)
    return out


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--corpus", type=int, default=None,
                    help=f"corpus rows (default {CARD_ROWS} on the card, "
                         f"{CPU_ROWS} on the CPU)")
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=100)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    n_corpus = args.corpus or (CPU_ROWS if device.type == "cpu"
                               else CARD_ROWS)
    print(f"device: {device.type} ({card(device)}), corpus "
          f"{n_corpus}x{args.dim} f32, "
          f"{args.queries} queries, k={args.k}")
    c = draw(n_corpus, args.dim, device, seed=0)
    q = draw(args.queries, args.dim, device, seed=42)
    name = "cpu" if device.type == "cpu" else f"cuda:{torch.cuda.current_device()}"
    shard_counts = (1, 2, 4, 8) if device.type == "cpu" else (1, 2, 4)

    base_rate, reference, rows = None, None, []
    for s in shard_counts:
        mesh = pmt.make_mesh(1, s, devices=[name] * s)
        corpus = pmt.Corpus(c, mesh=mesh)
        for merge in (["allgather", "ring"] if s > 1 else ["allgather"]):
            corpus.config = SearchConfig(merge=merge)
            idx, scores = corpus.topk(q, args.k, "cosine")
            if reference is None:
                reference = (idx, scores)
            else:
                check(np.array_equal(idx, reference[0]) and np.allclose(
                    scores, reference[1], rtol=1e-6, atol=1e-6),
                    f"shards={s} merge={merge}: differs from one shard")
            t = host_ms(lambda: corpus.topk(q, args.k, "cosine"), device,
                        warmup=1, iters=3)
            rate = args.queries * n_corpus / (t / 1e3)
            eff = ""
            if s == 1 and merge == "allgather":
                base_rate = rate
            elif base_rate:
                eff = f"  scaling eff {rate / (base_rate * s):.2f}"
            rows.append({"shards": s, "merge": merge, "host_ms": t,
                         "rows_per_s": rate})
            print(f"shards={s} merge={merge:10s}: {t:9.1f} ms host -> "
                  f"{rate / 1e9:8.2f} G rows/s{eff}")
        del corpus
    return {"device": device.type, "n": n_corpus, "rows": rows}


if __name__ == "__main__":
    main()
