"""End-to-end top-k benchmark sweep vs NumPy.

The port of the JAX package's ``examples/benchmark_topk.py``: sweeps
around the base workload 1000 queries x 10,000 corpus rows x 256 dims,
k=10, f32 cosine, varying one axis at a time (queries 100 and 5000,
corpus 1000 and 100,000, dims 64 and 1024, k=1 and 100, f64), against a
NumPy normalize + matmul + argpartition baseline.  Every case is checked
against a float64 NumPy oracle before it is timed (scores within rtol
1e-4 / atol 1e-5, index differences only on tied scores); a failure
fails the run.  The data are the JAX script's NumPy draws from seed 42.

    python -m polars_matmul_tpu_torch.examples.benchmark_topk [--cpu]
        [--base 1000 10000 256] [--warmup 2] [--iters 5]

Columns: NumPy's host time; the port's request time on the host
(``Corpus.topk`` from NumPy, results back as NumPy); and, for the f32
cases on the card, the device time of the resident corpus's kernels
(kernels A + B through ``fused_topk_prepared`` on card tensors, CUDA
events around batches of calls).  ``--base`` scales the sweep: each case
keeps the JAX script's ratio to the base (queries / 10 and x 5, corpus /
10 and x 10, dims / 4 and x 4).
"""

from __future__ import annotations

import numpy as np
import torch

import polars_matmul_tpu_torch as pmt
from polars_matmul_tpu_torch.kernels import fused_topk as F

from ._common import (CPU, card, check, event_ms, fmt, host_ms, parser,
                      pick_device)

BASE = (1000, 10_000, 256)


def numpy_topk_cosine(query, corpus, k):
    """Reference NumPy implementation (the JAX script's)."""
    qn = query / np.linalg.norm(query, axis=1, keepdims=True)
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    scores = qn @ cn.T
    idx = np.argpartition(-scores, min(k, scores.shape[1] - 1), axis=1)[:, :k]
    part = np.take_along_axis(scores, idx, 1)
    order = np.argsort(-part, axis=1)
    return np.take_along_axis(idx, order, 1), np.take_along_axis(part, order, 1)


def verify_correctness(corpus_handle, q, c, k):
    """The JAX script's check of one case against a float64 oracle; raises
    AssertionError on a mismatch, and returns the checked (indices,
    scores)."""
    idx, scores = corpus_handle.topk(q, k, "cosine")
    ref_idx, ref_scores = numpy_topk_cosine(
        q.astype(np.float64), c.astype(np.float64), k)
    check(np.allclose(scores, ref_scores, rtol=1e-4, atol=1e-5),
          "score mismatch vs NumPy oracle")
    mism = idx != ref_idx
    if mism.any():
        ok = np.abs(scores[mism] - ref_scores[mism]) <= (
            1e-5 + 1e-4 * np.abs(ref_scores[mism]))
        check(bool(ok.all()), "index mismatch vs NumPy oracle (non-tie)")
    return idx, scores


def kernel_ms(corpus, q, k, device):
    """Device time of the resident corpus's kernels for one request (f32
    on the card only)."""
    if device.type != "cuda" or q.dtype != np.float32:
        return None
    qt = torch.from_numpy(q).to(device)
    cp, cbp = corpus._prepared_for(F.Metric.COSINE)
    precision = corpus._effective_precision()
    return event_ms(lambda: F.fused_topk_prepared(
        qt, cp, cbp, k, "cosine", config=corpus.config,
        precision=precision), device)


def run_case(n_queries, n_corpus, dim, k, dtype, device, warmup=2,
             iters=5):
    rng = np.random.default_rng(42)
    q = rng.standard_normal((n_queries, dim)).astype(dtype)
    c = rng.standard_normal((n_corpus, dim)).astype(dtype)

    t_np = host_ms(lambda: numpy_topk_cosine(q, c, k), CPU, warmup, iters)

    corpus = pmt.Corpus(c, device=device)  # resident corpus: upload once
    idx, scores = verify_correctness(corpus, q, c, k)
    t_host = host_ms(lambda: corpus.topk(q, k, "cosine"), device, warmup,
                     iters)
    return {"numpy_ms": t_np, "host_ms": t_host,
            "device_ms": kernel_ms(corpus, q, k, device),
            "verified": True, "indices": idx, "scores": scores}


def sweeps(base):
    nq, nc, dim = base
    return [
        (f"base {nq}x{nc}x{dim} k=10 f32", {}),
        (f"queries={nq // 10}", {"n_queries": nq // 10}),
        (f"queries={nq * 5}", {"n_queries": nq * 5}),
        (f"corpus={nc // 10}", {"n_corpus": nc // 10}),
        (f"corpus={nc * 10}", {"n_corpus": nc * 10}),
        (f"dim={dim // 4}", {"dim": dim // 4}),
        (f"dim={dim * 4}", {"dim": dim * 4}),
        ("k=1", {"k": 1}),
        ("k=100", {"k": 100}),
        ("f64", {"dtype": np.float64}),
    ]


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--base", type=int, nargs=3, default=list(BASE),
                    metavar=("QUERIES", "CORPUS", "DIM"))
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    base = dict(n_queries=args.base[0], n_corpus=args.base[1],
                dim=args.base[2], k=10, dtype=np.float32)
    print(f"device: {device.type} ({card(device)})")
    print(f"{'case':<42} {'numpy':>9} {'host':>9} {'device':>9} "
          f"{'ratio':>7}  (host / numpy, <1 = faster)")
    cases = {}
    for name, over in sweeps(args.base):
        res = run_case(**{**base, **over}, device=device,
                       warmup=args.warmup, iters=args.iters)
        cases[name] = res
        print(f"{name:<42} {fmt(res['numpy_ms'], 9, 1)} "
              f"{fmt(res['host_ms'], 9, 1)} {fmt(res['device_ms'])} "
              f"{res['host_ms'] / res['numpy_ms']:6.2f}x")
    print("correctness: verified vs NumPy on every case")
    return {"device": device.type, "cases": cases}


if __name__ == "__main__":
    main()
