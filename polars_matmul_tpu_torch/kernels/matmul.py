"""Pairwise matmul Q . C^T (port of ``polars_matmul_tpu.kernels.matmul``).

The JAX package leaves the plain product to XLA's ``dot_general``; the
port leaves it to ``torch.matmul``, in full float32 or float64 with TF32
off.  The Pallas template ``pallas_matmul`` is not ported yet
(ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import torch

from ..ops.reference import exact_matmul


def pairwise_matmul(q: torch.Tensor, c: torch.Tensor, *,
                    precision: str = "highest") -> torch.Tensor:
    """Q . C^T in the inputs' dtype.  ``precision`` is accepted for
    signature parity: this product is always exact (never TF32)."""
    with exact_matmul():
        return torch.matmul(q, c.T)
