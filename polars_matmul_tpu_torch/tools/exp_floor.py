"""The selection floor of the canonical workload on the H100, per k tier
(port of the JAX package's ``tools/exp_floor.py``).

The canonical 1000 x 10,000 x 256 cosine search in the bf16x3 core, its
queries padded to 1024 rows and its corpus to whole tn-row tiles as the
JAX experiment pads them.  Programs, each kernel D (``kernels/floor.py``)
with global group ids:

- A (``levels=0``): the product and epilogue with no selection, a
  per-tile row-max sum (the JAX ``mxu_epilogue``);
- B1: A plus one packed stack level over every score (the k <= 128
  floor);
- B5 / B4: five levels at the k <= 16 geometry, four (ceil(512 / 128)) at
  the k = 512 one.

A, B1, B5 run at tn = 2048 and kernel A's k = 10 geometry; A, B1 at tn =
4096 and the k = 100 geometry; B4 at tn = 4096 and the k = 512 geometry.
Kernel A runs beside each program on the same operands at that k.
The shipped stages time the port's one-shot ``fused_topk`` (prep, kernels
A + B) at k = 10, 100, 512 with the JAX selections (gpop, gstack), and
beside it kernels A + B and kernel A alone on the prepared operands.  The
floors JSON keeps the JAX schema's keys (``device_kind`` is the card's
name) and adds the card's power limit, kernel D's ``floor_*`` beside
kernel A's ``kernel_a_*`` times and the geometry each ran.

    python -m polars_matmul_tpu_torch.tools.exp_floor --out build/floors.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

import torch

from ..config import SearchConfig
from ..kernels import floor as D
from ..kernels import fused_topk as F
from ..utils.autotune import _device_kind
from . import card, emit, kernel_a_ms, median_ms

M, N, DIM = 1000, 10_000, 256
DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "floors.json")
# (tag, levels, tn, kernel A's k for the geometry).
PROGRAMS = (("A_2048", 0, 2048, 10), ("B1_2048", 1, 2048, 10),
            ("B5_2048", 5, 2048, 10), ("A_4096", 0, 4096, 100),
            ("B1_4096", 1, 4096, 100), ("B4_4096", 4, 4096, 512))
# (k, the JAX experiment's selection) of the shipped stages.
SHIPPED = ((10, "gpop"), (100, "gstack"), (512, "gstack"))


def build(device: torch.device, m: int = M, n: int = N, dim: int = DIM,
          seed: int = 7):
    """(queries f32 (m, dim), corpus f32 (n, dim), padded queries bf16
    (round_up(m, 256), 2 dim) [hi | lo] after the cosine scaling), made on
    ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    qf = torch.randn((m, dim), generator=gen, device=device)
    cf = torch.randn((n, dim), generator=gen, device=device)
    mp = -(-m // 256) * 256
    qn = torch.zeros((mp, dim), device=device)
    qn[:m] = qf / qf.norm(dim=1, keepdim=True)
    return qf, cf, F.split_hi_lo(qn)


def corpus_operands(cf: torch.Tensor, tn: int):
    """The JAX ``prepare_corpus(c, "cosine", tn=tn, precision="bf16x3")``:
    cosine-scaled rows split [hi | lo], padded to whole tn-row tiles with
    zero rows of bias -inf; the bias as a (1, n_padded) row."""
    cp, cb = F.prepare_corpus(cf, "cosine", precision="bf16x3")
    pad = -cp.shape[0] % tn
    cp = torch.nn.functional.pad(cp, (0, 0, 0, pad))
    cb = torch.nn.functional.pad(cb, (0, pad), value=float("-inf"))
    return cp.contiguous(), cb[None].contiguous()


def main(device: str = "cuda", out: Optional[Path] = DEFAULT_OUT,
         m: int = M, n: int = N, dim: int = DIM, iters: int = 20,
         seed: int = 7) -> Dict:
    dev = torch.device(device)
    qf, cf, qp = build(dev, m, n, dim, seed)
    res, geometry = {}, {}
    for tag, levels, tn, k in PROGRAMS:
        cp, cb = corpus_operands(cf, tn)
        geo = D.floor_geometry(qp.shape[0], cp.shape[0], "bf16x3", levels,
                               k, dev)
        res[tag] = median_ms(lambda: D.floor_stacks(
            qp, cp, cb, core="bf16x3", levels=levels, tn=tn, ids="global",
            k_geometry=k), iters)
        geometry[tag] = {"tm": geo[0], "splits": geo[1], "tn": tn,
                         "levels": levels, "rows": cp.shape[0],
                         "kernel_a_ms": kernel_a_ms(qp, cp, cb, k, "bf16x3",
                                                    iters)}
        emit({"program": tag, "ms": res[tag], **geometry[tag]})
    del cp, cb

    cpa, cba = F.prepare_corpus(cf, "cosine", precision="bf16x3")
    qa = F.prepare_queries(qf, "cosine", "bf16x3")
    for k, selection in SHIPPED:
        cfg = SearchConfig(selection=selection, use_autotune_cache=False)
        res[f"C_k{k}"] = median_ms(
            lambda: F.fused_topk(qf, cf, k, "cosine", config=cfg), iters)
        res[f"AB_k{k}"] = median_ms(
            lambda: F.fused_select(qa, cpa, cba, None, k, "bf16x3"), iters)
        res[f"A_k{k}"] = kernel_a_ms(qa, cpa, cba[None], k, "bf16x3", iters)
        emit({"program": f"C_k{k}_{selection}", "ms": res[f"C_k{k}"],
              "kernels_ab_ms": res[f"AB_k{k}"],
              "kernel_a_ms": res[f"A_k{k}"]})

    floors = {
        "device_kind": _device_kind(dev),
        "card": card(dev),
        "workload": f"{m}x{n}x{dim}d f32 cosine (canonical)",
        "mxu_epilogue_ms": res["A_2048"],
        "mxu_epilogue_bn4096_ms": res["A_4096"],
        "floor_k10_ms": res["B1_2048"],
        "floor_k100_ms": res["B1_4096"],
        "floor_k512_ms": res["B4_4096"],
        "floor_b5_ms": res["B5_2048"],
        "shipped_k10_ms": res["C_k10"],
        "shipped_k100_ms": res["C_k100"],
        "shipped_k512_ms": res["C_k512"],
        "provenance": "polars_matmul_tpu_torch/tools/exp_floor.py",
        "geometry": geometry,
    }
    for k in (10, 100, 512):
        floors[f"fraction_of_floor_k{k}"] = (floors[f"floor_k{k}_ms"]
                                             / floors[f"shipped_k{k}_ms"])
        floors[f"kernels_ab_k{k}_ms"] = res[f"AB_k{k}"]
        floors[f"kernel_a_k{k}_ms"] = res[f"A_k{k}"]
    if out is not None:
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(floors, indent=1, sort_keys=True))
    emit(floors)
    return floors


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    main(args.device, args.out, iters=args.iters)
