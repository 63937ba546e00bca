"""The cost of the int4 unpack on the H100 (port of the JAX package's
``tools/exp_int4.py``).

A 2,000,000 x 768 corpus (N(0, 1) rows made on the card from a seed in row
chunks, padded to whole tn-row tiles; tn = 1024 is the JAX tile height for
int8c at k=100) stored three ways: int8 codes, nibble-packed int4 (byte j:
feature j low, feature j + 384 high) and the same int4 codes repacked as
b = 16 hi + lo (``repack_int4_rint``); cosine scale | bias rows for each.
Kernel D (``kernels/floor.py``) runs the product against each at one
packed stack level with tile-local ids, at kernel A's k=100 geometry, in
four modes: ``int8c`` (the bar), ``int4-i32`` (the nibble unpack, kernel
A's int4c core), ``int4-rint`` (the repack decoded in float) and
``int4-raw`` (the bytes fed as they are: wrong on purpose, the cost of a
free unpack).  Batches 8 and 256; each time beside the corpus bytes over
3.35 TB/s and kernel A's int8c / int4c time at the same shape.

    python -m polars_matmul_tpu_torch.tools.exp_int4
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch

from ..config import SearchConfig
from ..kernels import floor as D
from ..kernels import fused_topk as F
from ..utils import profiling as P
from . import card, emit, kernel_a_ms, median_ms

N, DIM, K = 2_000_000, 768, 100
BATCHES = (8, 256)
# (tag, kernel D core, corpus) of each mode.
MODES = (("int8c", "int8c", "int8"), ("int4-i32", "int4c", "int4"),
         ("int4-rint", "int4-rint", "rint"), ("int4-raw", "int4-raw", "int4"))
CFG = SearchConfig(precision="int8c", use_autotune_cache=False)


def _host_quantize_int8(c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes and scales (``exp_int4.py::_host_quantize_int8``):
    scale = max|row| / 127 (1 for a zero row), codes rint(c / scale)."""
    return F.quantize_int8(c)


def _host_quantize_int4(c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int4 codes in [-7, 7], packed with feature j in the low
    nibble and feature j + dim / 2 in the high nibble of byte j, and the
    scales (``exp_int4.py::_host_quantize_int4``)."""
    c = c.to(torch.float32)
    scale = F._row_scale(c, 7.0)
    codes = torch.clamp(torch.round(c / scale), -7, 7).to(torch.int16)
    half = c.shape[1] // 2
    packed = (codes[:, :half] & 0xF) | ((codes[:, half:] & 0xF) << 4)
    return packed.to(torch.int8), scale[:, 0].contiguous()


def build(device: torch.device, n: int = N, dim: int = DIM, k: int = K,
          seed: int = 21, chunk: int = 250_000):
    """(queries f32 (256, dim), {"int8" | "int4" | "rint": (corpus,
    scale | bias)}, tn), made on ``device`` chunk by chunk."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q = torch.randn((max(BATCHES), dim), generator=gen, device=device)
    tn = F.layout_tile_rows(dim, CFG, k)
    n_pad = -(-n // tn) * tn
    cp8 = torch.zeros((n_pad, dim), dtype=torch.int8, device=device)
    cp4 = torch.zeros((n_pad, dim // 2), dtype=torch.int8, device=device)
    ones = torch.ones(n_pad, device=device)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        c = torch.randn((r1 - r0, dim), generator=gen, device=device)
        cp8[r0:r1] = _host_quantize_int8(c)[0]
        cp4[r0:r1] = _host_quantize_int4(c)[0]
    # For cosine the dequant scales cancel: the scale row is 1/|codes|.
    corpora = {"int8": (cp8, F.prepare_int8_bias(cp8, ones, "cosine", n)),
               "int4": (cp4, F.prepare_int4_bias(cp4, ones, "cosine", n))}
    corpora["rint"] = (D.repack_int4_rint(cp4), corpora["int4"][1])
    return q, corpora, tn


def main(device: str = "cuda", n: int = N, dim: int = DIM, k: int = K,
         iters: int = 10, seed: int = 21) -> Dict:
    dev = torch.device(device)
    q, corpora, tn = build(dev, n, dim, k, seed)
    hbm = P.device_hbm_bytes_per_s(dev) if dev.type == "cuda" else None
    res = {"card": card(dev), "tn": tn}
    emit({"tag": "tiling", "tn": tn, "card": res["card"]})
    for b in BATCHES:
        qp = F.prepare_queries(q[:b], "cosine", "int8c")
        for tag, core, form in MODES:
            cp, cb = corpora[form]
            geo = D.floor_geometry(b, cp.shape[0], core, 1, k, dev, dim=dim)
            ms = median_ms(lambda: D.floor_stacks(
                qp, cp, cb, core=core, levels=1, tn=tn, ids="tile-local",
                k_geometry=k), iters)
            row = {"tag": f"{tag}-b{b}", "ms": ms, "tm": geo[0],
                   "splits": geo[1],
                   "consumer": D.floor_consumer(geo[0], core, 1),
                   "corpus_gb": cp.nbytes / 1e9}
            if hbm:
                row["hbm_bound_ms"] = cp.nbytes / hbm * 1e3
                row["fraction_of_bound"] = row["hbm_bound_ms"] / ms
            if core in ("int8c", "int4c"):
                row["kernel_a_ms"] = kernel_a_ms(qp, cp, cb, k, core, iters)
            res[row["tag"]] = row
            emit(row)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    main(args.device, iters=args.iters)
