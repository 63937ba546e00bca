"""Similarity / distance metric definitions (port of
``polars_matmul_tpu.ops.metrics``): three metrics, case-insensitive
parsing, ``"l2"`` as an alias for euclidean, and the sort direction."""

from __future__ import annotations

import enum

import torch


class Metric(enum.Enum):
    COSINE = "cosine"
    DOT = "dot"
    EUCLIDEAN = "euclidean"

    @classmethod
    def parse(cls, s) -> "Metric":
        if isinstance(s, Metric):
            return s
        low = str(s).lower()
        if low == "cosine":
            return cls.COSINE
        if low == "dot":
            return cls.DOT
        if low in ("euclidean", "l2"):
            return cls.EUCLIDEAN
        raise ValueError(
            f"Unknown metric: '{s}'. Supported: cosine, dot, euclidean"
        )

    @property
    def higher_is_better(self) -> bool:
        """True for similarities, False for distances."""
        return self is not Metric.EUCLIDEAN


def cosine_eps(dtype) -> float:
    """Zero-norm guard epsilon: 1e-6 for float32, 1e-10 otherwise.

    Rows or columns with norm <= eps score 0.0.  ``dtype`` may be a torch
    or a numpy dtype.
    """
    if isinstance(dtype, torch.dtype):
        return 1e-6 if dtype == torch.float32 else 1e-10
    import numpy as np

    return 1e-6 if np.dtype(dtype) == np.float32 else 1e-10
