"""polars-matmul-tpu on PyTorch and CUDA: the port of ``polars_matmul_tpu``
to an NVIDIA H100.

The same public operations — ``topk``, ``matmul``, the resident
``Corpus``, the ``ClusteredCorpus`` of probed search and ``autotune`` —
with the fused top-k kernels and the tiled product ``kernels.
pallas_matmul`` written by hand in CUDA C++ for Hopper (``kernels/csrc``),
built with ``nvcc`` at first use.  The JAX package stays the reference;
this package imports neither ``jax`` nor ``pyarrow``.

``topk_torch`` and ``matmul_torch`` are the tensor-level operations
(torch tensors in, torch tensors out), the counterparts of ``topk_jax``
and ``matmul_jax``.
"""

from __future__ import annotations

from .config import SearchConfig, default_config, set_default_config
from .ops.metrics import Metric
from .api.clustered import ClusteredCorpus
from .api.search import Corpus, matmul, topk
from .kernels.fused_topk import fused_topk as topk_torch
from .kernels.matmul import pairwise_matmul as matmul_torch
from .utils.autotune import autotune

__version__ = "0.1.0"

__all__ = [
    "ClusteredCorpus",
    "Corpus",
    "Metric",
    "SearchConfig",
    "autotune",
    "default_config",
    "matmul",
    "matmul_torch",
    "set_default_config",
    "topk",
    "topk_torch",
]
