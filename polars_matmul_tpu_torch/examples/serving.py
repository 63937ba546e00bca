"""Serving pattern: resident corpus, batch accumulation, filtered queries.

The port of the JAX package's ``examples/serving.py``: upload and prepare
the corpus once, then serve query batches against it, each with its own
corpus filter, and read one result per batch; then mutate a corpus in
place (``capacity=``, add / update / delete), save and reload it at int8,
and serve probed requests from a ``ClusteredCorpus`` through drift and
``rebuild``.  On the card the corpus is the JAX script's TPU size,
200,000 x 256; on the CPU (``--cpu``) its off-TPU size, 5,000 x 64.  The
data are the JAX script's NumPy draws from seed 0, in its order, so both
scripts serve the same requests.

    python -m polars_matmul_tpu_torch.examples.serving [--cpu]

Request times are host times with the results on the host; they include
the upload of each batch and the download of its results.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

import polars_matmul_tpu_torch as pmt

from ._common import card, check, parser, pick_device, sync

CARD_SIZE = (200_000, 256)
CPU_SIZE = (5_000, 64)
K = 10
BATCH = 512


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--requests", type=int, default=5)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    n, dim = CPU_SIZE if device.type == "cpu" else CARD_SIZE
    k, batch = K, BATCH
    out = {"device": device.type, "n": n, "dim": dim}

    rng = np.random.default_rng(0)
    corpus_emb = rng.standard_normal((n, dim)).astype(np.float32)
    # a categorical attribute to filter on per request
    category = rng.integers(0, 8, size=n)

    print(f"corpus {n}x{dim} on {device.type} ({card(device)}); uploading "
          f"+ preparing once...")
    t0 = time.perf_counter()
    corpus = pmt.Corpus(corpus_emb, device=device)
    # warm the prepared cache for the metric we serve
    corpus.topk(corpus_emb[:1], 1, "cosine")
    out["ready_s"] = time.perf_counter() - t0
    print(f"  ready in {out['ready_s']:.1f}s")

    # steady-state serving loop
    lat, requests = [], []
    for req in range(args.requests):
        queries = rng.standard_normal((batch, dim)).astype(np.float32)
        want = req % 8  # this request only wants category == want
        sync(device)
        t0 = time.perf_counter()
        idx, scores = corpus.topk(queries, k, "cosine",
                                  mask=category == want)
        lat.append((time.perf_counter() - t0) * 1e3)
        check((category[idx.reshape(-1)] == want).all(),
              f"request {req} returned a row outside category {want}")
        requests.append((want, idx, scores))
        print(f"  request {req}: {batch} queries (category {want}) in "
              f"{lat[-1]:.1f} ms host; top hit score {scores[0, 0]:.4f}")
    out["requests"] = requests
    out["request_host_ms"] = lat
    out["qps"] = batch / (min(lat) / 1e3)
    print(f"steady-state: {out['qps']:,.0f} queries/s per batch-call "
          f"(host time of the fastest request, transfers included)")

    # --- live index mutation: upsert / append / delete -------------------
    # In place: rows are written into the stored and prepared forms, so
    # the next request needs no rebuild.
    fresh = rng.standard_normal((64, dim)).astype(np.float32)
    corpus2 = pmt.Corpus(corpus_emb[:5000], capacity=8000, storage="int8",
                         device=device)
    corpus2.topk(fresh[:1], 1)                  # build the prepared form
    sync(device)
    t0 = time.perf_counter()
    corpus2.add(fresh)                          # new docs: ids 5000..5063
    corpus2.update([17, 123], fresh[:2])        # re-embedded docs
    corpus2.delete([44])                        # retired doc
    sync(device)
    out["mutation_host_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"mutations (add 64 / update 2 / delete 1) in "
          f"{out['mutation_host_ms']:.1f} ms host (written in place; no "
          f"rebuild before the next request)")
    idx, _ = corpus2.topk(fresh[:2], 1)
    check(idx[0, 0] == 17 and idx[1, 0] == 123,
          "the updated rows do not answer their own embeddings")
    out["upserted"] = idx

    # --- persistence: storage-native save / load -------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus.npz")
        corpus2.save(path)                      # int8: quarter-size file
        size_mb = os.path.getsize(path) / 1e6
        restored = pmt.Corpus.load(path, device=device)
    idx2, _ = restored.topk(fresh[:2], 1)
    check((idx2 == idx).all(), "the reloaded corpus answers differently")
    out["reloaded"] = idx2
    print(f"saved + reloaded {restored.n} rows ({size_mb:.1f} MB int8 "
          f"file); results identical")

    # --- probed (IVF-style) serving with drift recovery ------------------
    # probe= bounds corpus bytes read; add() places rows by the centroids
    # fitted at construction, so after heavy growth the fit goes stale.
    # `drift` is the cheap signal; rebuild() re-fits storage-native
    # (exhaustive results invariant, ids/tombstones stable).
    cc = pmt.ClusteredCorpus(corpus_emb[:5000], storage="int8",
                             device=device)
    probed = [cc.topk(fresh[:8], 5, probe=0.2)]    # ~20% of corpus bytes
    cc.add(rng.standard_normal((2000, dim)).astype(np.float32))
    out["drift"] = cc.drift
    print(f"drift after heavy adds: {cc.drift:.0%} of rows placed "
          f"against stale centroids")
    if cc.drift > 0.25:
        sync(device)
        t0 = time.perf_counter()
        cc.rebuild()
        sync(device)
        out["rebuild_host_ms"] = (time.perf_counter() - t0) * 1e3
        print(f"rebuild (re-fit + re-layout, never requantizes) in "
              f"{out['rebuild_host_ms']:.0f} ms host; drift reset to "
              f"{cc.drift:.0%}")
    out["drift_after"] = cc.drift
    probed.append(cc.topk(fresh[:8], 5, probe=0.2))  # the fresh layout
    out["probed"] = probed
    return out


if __name__ == "__main__":
    main()
