"""Global configuration for the PyTorch/CUDA port.

Same contract as ``polars_matmul_tpu.config``: every knob has a default
that preserves the reference semantics, and ``SearchConfig`` is an
optional override.  The fields, defaults and enum validation are the JAX
package's, so a config can be carried from one package to the other.

On this port:

- ``block_q`` / ``block_n`` do not size the CUDA kernel's tiles (it
  picks its own), but they size probed search as in the JAX package:
  ``ClusteredCorpus``'s layout tile (``kernels.fused_topk.
  layout_tile_rows``) and the query rows that share one tile list
  (``probe_block_rows``), so both packages list the same tiles.
- ``k_pad`` keeps its meaning through ``kernels.fused_topk.effective_k_pad``,
  but does not raise the fused path's k ceiling: the CUDA kernels hold at
  most 1024 candidates per row, so k > 1024 runs the reference top-k even
  where the JAX package, with ``k_pad`` > 1024, stays fused.
- ``prune``: kernel A's carry gate (``kernels.fused_topk.prune_gate``),
  the JAX kernel's exact tile pruning: with it on, a tile in which no
  row's score beats that row's current k-th value skips the selection;
  the results are those with it off, bit for bit.  "on" and "off" force
  it.  "auto" is off on the card (the JAX package turns it on at 16 or
  more corpus tiles, or listed tiles a query block): on an NVIDIA H100
  80GB HBM3 at 700 W (``chip_smoke.py`` phase 6, on and off in turns),
  the gate was slower than off beyond the run's spread in 3 of the 12
  cells where the JAX rule turns it on (2M x 256 bf16x3 batch 256
  k=100: 7.488 against 7.402 ms; 10M x 768 int8 batch 256 k=100: 41.965
  against 41.646 ms; the 10M x 768 int8 clustered corpus at probe 0.05,
  batch 8 k=10: 0.397 against 0.391 ms), though it saved 5 % at 10M x
  768 int8 batch 256 k=10 (36.383 against 38.363 ms, 30.5 % of the
  tiles skipped).
- ``selection``: every value gives the same exact result (kernel A carry
  + kernel B merge).  "bucket" runs kernel A's port of the JAX kernel's
  bucket selection where it is built (``kernels.fused_topk.bucket_built``:
  k <= 16 at query tiles 16 and 32, 16 only for "highest"; the same
  lists, bit for bit); "auto" takes it where ``kernels.fused_topk.
  bucket_route`` says (nowhere: it did not beat the insertion on the
  card).  "gstack" and "gpop" run kernel A's port of the JAX kernel's
  gstack build, its detector and its pop finish where it is built
  (``kernels.fused_topk.gstack_built``: k <= 128 on the mma.sync ring and
  the f32 walk where its stacks fit in shared memory, never on the
  stored cores' tile-64 warpgroup consumer), a second launch walking
  again, exactly, every split its detector flags (the same lists, bit for
  bit); above k = 128 "gstack" takes it at query tile 16 on its own
  splits (``kernels.fused_topk.gstack_geometry``): stacks as deep as a
  split is long where they fit (lossless: nothing fires, no re-walk),
  else lossy stacks with the re-walk (``gstack_big_plan``), else the
  radix selection at its own geometry.  There it was slower than the
  radix selection in every cell measured on the card (canonical bf16x3
  k=512 1.3369 against 0.7134 ms), so an explicit "gstack" above k = 128
  is slower than the radix it ran before; "auto" takes it where
  ``kernels.fused_topk.gstack_route`` says (nowhere).  "stack" and "auto"
  run kernel A's port of the JAX kernel's stack selection in its class
  (``kernels.fused_topk.stack_route``: dense, 17 <= k <= 32, query tiles
  16 and 32, the bf16x3 and highest cores, where its tail leaves two
  blocks an SM), where it was faster than the slack on the card; the
  same lists, bit for bit.
  Every other value, and these four where their selection is not built
  or outside its class, runs kernel A's own selection by k (``kernels.fused_topk.selection``:
  the insertion at k <= 16, the slack at k <= 128, the radix selection
  above).  An explicit "gpop",
  "gstack", "bucket", "stack" or "insert" outside the envelope the JAX
  package gives it raises the JAX package's ValueError
  (``kernels.fused_topk.check_selection``), dense and probed alike.
- ``precision``: each value runs its own core of the fused kernel:
  ``"bf16x3"``, ``"highest"``, and the quantized-storage cores
  ``"bf16c"``, ``"int8c"`` and ``"int4c"`` (on module-level ``topk`` and
  an f32 ``Corpus`` they quantize the corpus on the way in; a
  ``Corpus(storage="bf16" | "int8" | "int4")`` always runs its tier's
  core).  ``"default"`` and ``"high"`` run ``"highest"`` (exact f32 is
  inside their looser contract).
- ``prep_chunk_bytes`` bounds the f32 temporaries of corpus ingestion
  and prep: ``Corpus`` quantizes and prepares in row chunks of about
  this many bytes.
- ``use_pallas=False`` forces the reference top-k path, as in the JAX
  package (the name is kept so that configs carry over).
- ``use_autotune_cache``: as in the JAX package, a ``fused_topk`` whose
  tuning fields are all at their defaults adopts the winner ``autotune``
  persisted for this card and problem class; False keeps the defaults.

There is no ``ensure_x64``: torch has float64 natively.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Tuning knobs for the fused search path (see the module docstring
    for how each one maps onto the CUDA port)."""

    block_q: int = 256
    block_n: int = 2048
    k_pad: int = 128
    selection: str = "auto"
    auto_tile: bool = True
    precision: str = "bf16x3"
    prune: str = "auto"
    use_pallas: bool = True
    use_autotune_cache: bool = True
    max_fused_dim: int = 8192
    fallback_score_bytes: int = 1 << 30
    merge: str = "allgather"
    prep_chunk_bytes: int = 1 << 30
    ring_pipeline: int = 2
    mesh_axes: Tuple[str, str] = ("data", "corpus")

    def __post_init__(self):
        for field, allowed in (
            ("prune", ("auto", "on", "off")),
            ("selection", ("auto", "extract", "insert", "bucket",
                           "stack", "gstack", "gpop")),
            ("merge", ("allgather", "ring")),
            ("precision", ("default", "high", "highest",
                           "bf16x3", "bf16c", "int8c", "int4c")),
        ):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(
                    f"Unknown {field}: {v!r} (expected one of {allowed})"
                )

    def with_updates(self, **kw) -> "SearchConfig":
        return dataclasses.replace(self, **kw)


_default_config = SearchConfig()


def default_config() -> SearchConfig:
    return _default_config


def set_default_config(cfg: SearchConfig) -> None:
    global _default_config
    _default_config = cfg


def resolve(cfg: Optional[SearchConfig]) -> SearchConfig:
    return cfg if cfg is not None else _default_config
