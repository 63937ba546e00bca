"""Sharded search across a mesh of devices and ranks (port of
``polars_matmul_tpu.parallel``)."""

from .mesh import Mesh, init_distributed, make_mesh
from .sharded import (
    ShardedCorpus,
    distributed_matmul,
    distributed_topk,
    shard_corpus,
)

__all__ = [
    "Mesh",
    "ShardedCorpus",
    "distributed_matmul",
    "distributed_topk",
    "init_distributed",
    "make_mesh",
    "shard_corpus",
]
