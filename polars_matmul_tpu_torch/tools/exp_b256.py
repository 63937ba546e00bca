"""The batch-256 corpus-scale cost on the H100, split into its owners (port
of the JAX package's ``tools/exp_b256.py``).

A 2,000,000 x 256 int8 corpus (per-row codes of N(0, 1) rows, made on the
card from a seed in row chunks, padded to whole tn-row tiles as the JAX
experiment pads it; tn = 2048 is the JAX tile height for int8c at k=100),
256 cosine queries, k=100.  Stages:

- ``full``: the product path, ``fused_topk_prepared`` on the int8c
  operands (what ``Corpus(storage="int8").topk`` runs): kernels A + B.
- ``kernel-A``: kernel A alone at the same geometry.  The JAX experiment
  patched its gstack finish (``_gstack_decode``: no detection, a stubbed
  finish) to price the finish; the port has no gstack to patch, and
  ``full`` minus ``kernel-A`` is the whole finish (kernel B).
- ``build``: kernel D (``kernels/floor.py``) with the segmented id rule
  at kernel A's k=100 geometry: levels 0 (the product and epilogue
  alone), 1 and n_levels (the JAX gstack's depth for this corpus,
  ``_gstack_geometry``), and n_levels with posu.  As in the JAX code
  (``exp_b256.py:128``), posu packs the raw bits of the unbiased cosine
  scores; the +1.0 bias its docstring names is not applied.
- ``finish``: kernel B on kernel A's split lists against ``torch.topk`` of
  the flattened lists.

    python -m polars_matmul_tpu_torch.tools.exp_b256
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from ..config import SearchConfig
from ..kernels import floor as D
from ..kernels import fused_topk as F
from . import card, emit, kernel_a_ms, median_ms

N, DIM, K, B = 2_000_000, 256, 100, 256
CFG = SearchConfig(precision="int8c", use_autotune_cache=False)


def build(device: torch.device, n: int = N, dim: int = DIM, b: int = B,
          k: int = K, seed: int = 11, chunk: int = 250_000):
    """(queries f32 (b, dim), codes int8 (n_pad, dim), scale | bias (2,
    n_pad), tn): the corpus quantized chunk by chunk on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q = torch.randn((b, dim), generator=gen, device=device)
    tn = F.layout_tile_rows(dim, CFG, k)
    n_pad = -(-n // tn) * tn
    codes = torch.zeros((n_pad, dim), dtype=torch.int8, device=device)
    scales = torch.ones(n_pad, device=device)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        c = torch.randn((r1 - r0, dim), generator=gen, device=device)
        codes[r0:r1], scales[r0:r1] = F.quantize_int8(c)
    cb = F.prepare_int8_bias(codes, scales, "cosine", n)
    return q, codes, cb, tn


def main(device: str = "cuda", n: int = N, dim: int = DIM, b: int = B,
         k: int = K, iters: int = 10, seed: int = 11) -> Dict:
    dev = torch.device(device)
    q, cp, cb, tn = build(dev, n, dim, b, k, seed)
    res = {"card": card(dev), "tn": tn, "rows": cp.shape[0]}
    emit({"tag": "setup", "tn": tn, "corpus_gb": cp.nbytes / 1e9,
          "card": res["card"]})

    res["full"] = median_ms(lambda: F.fused_topk_prepared(
        q, cp, cb, k, "cosine", config=CFG, precision="int8c", tn=tn), iters)
    qp = F.prepare_queries(q, "cosine", "int8c")
    res["kernel-A"] = kernel_a_ms(qp, cp, cb, k, "int8c", iters)
    emit({"tag": "full", "ms": res["full"]})
    emit({"tag": "kernel-A", "ms": res["kernel-A"]})

    _, _, _, n_levels, n_segs = D._gstack_geometry(cp.shape[0] // 128, k)
    res["n_levels"], res["n_segs"] = n_levels, n_segs
    emit({"tag": "geom", "n_levels": n_levels, "n_segs": n_segs})
    for tag, levels, posu in (("matmul+epi(L0)", 0, False), ("L1", 1, False),
                              (f"L{n_levels}", n_levels, False),
                              (f"L{n_levels}-posu", n_levels, True)):
        geo = D.floor_geometry(b, cp.shape[0], "int8c", levels, k, dev,
                               dim=cp.shape[1])
        res[tag] = median_ms(lambda: D.floor_stacks(
            qp, cp, cb, core="int8c", levels=levels, tn=tn, ids="segmented",
            posu=posu, k_geometry=k), iters)
        emit({"tag": tag, "ms": res[tag], "tm": geo[0], "splits": geo[1],
              "consumer": D.floor_consumer(geo[0], "int8c", levels)})

    if dev.type == "cuda":
        tm, splits, tps = F.kernel_geometry(b, cp.shape[0], k, "int8c", dev,
                                            dim=cp.shape[1])
    else:
        tm, splits, tps = F.launch_geometry(b, cp.shape[0], k,
                                            D._NOTIONAL_SMS)
    pv, pi = F.fused_topk_partial(qp, cp, cb, None, k, "int8c", splits, tps,
                                  tm)
    res["finish-kernel-B"] = median_ms(lambda: F.topk_merge(pv, pi, k), iters)
    res["finish-torch.topk"] = median_ms(
        lambda: torch.topk(pv.reshape(b, -1), k, dim=1), iters)
    emit({"tag": "finish", "lists": list(pv.shape),
          "kernel_b_ms": res["finish-kernel-B"],
          "torch_topk_ms": res["finish-torch.topk"]})
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    main(args.device, iters=args.iters)
