"""polars-matmul-tpu on PyTorch and CUDA: the port of ``polars_matmul_tpu``
to an NVIDIA H100.

The same public operations — ``topk``, ``matmul``, the resident
``Corpus``, the ``ClusteredCorpus`` of probed search, ``autotune``, the
Arrow operations ``topk_arrow`` / ``matmul_arrow``, when polars imports
the ``.pmm`` namespace on ``pl.Expr``, and sharded search over a mesh of
devices and ``torch.distributed`` ranks (``make_mesh``, ``shard_corpus``,
``distributed_topk``, ``distributed_matmul``, ``mesh=`` on the handles) —
with the fused top-k kernels and the tiled product
``kernels.pallas_matmul`` written by hand in CUDA C++ for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use.
The JAX package stays the reference.  Importing this package imports
neither ``jax`` nor ``pyarrow``: the Arrow work runs on raw buffers
(``interop.buffers``), and only the adapter of ``pyarrow`` arrays imports
it, when called.

``topk_torch`` and ``matmul_torch`` are the tensor-level operations
(torch tensors in, torch tensors out), the counterparts of ``topk_jax``
and ``matmul_jax``.
"""

from __future__ import annotations

from .config import SearchConfig, default_config, set_default_config
from .ops.metrics import Metric
from .api.clustered import ClusteredCorpus
from .api.search import Corpus, matmul, topk
from .api.arrow_ops import matmul_arrow, topk_arrow
from .kernels.fused_topk import fused_topk as topk_torch
from .kernels.matmul import pairwise_matmul as matmul_torch
from .parallel import (ShardedCorpus, distributed_matmul, distributed_topk,
                       init_distributed, make_mesh, shard_corpus)
from .utils.autotune import autotune

__version__ = "0.1.0"

__all__ = [
    "ClusteredCorpus",
    "Corpus",
    "Metric",
    "SearchConfig",
    "ShardedCorpus",
    "autotune",
    "default_config",
    "distributed_matmul",
    "distributed_topk",
    "init_distributed",
    "make_mesh",
    "matmul",
    "matmul_arrow",
    "matmul_torch",
    "set_default_config",
    "shard_corpus",
    "topk",
    "topk_arrow",
    "topk_torch",
]

# Register the Polars .pmm expression namespace when polars imports.
try:
    import polars  # noqa: F401
except ImportError:
    pass
else:
    from .api.namespace import PmmNamespace  # noqa: F401

    __all__.append("PmmNamespace")
