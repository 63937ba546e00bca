"""Plain PyTorch implementations of the two public operations (port of
``polars_matmul_tpu.ops.reference``).

They are the oracle for the fused kernels and the compute path wherever
the JAX package uses XLA instead of its Pallas kernel: float64 inputs,
k above ``kernels.fused_topk.max_fused_k``, ``use_pallas=False`` and
problems ``supports()`` declines.

- ``pairwise_scores``: cosine divides the raw dot products by the norm
  product with zero-norm guards (eps 1e-10 f64 / 1e-6 f32; degenerate rows
  or columns score 0.0); euclidean is sqrt(max(0, |q|^2 + |c|^2 - 2 q.c)).
- ``topk_search``: score, mask, select, with lowest-index-wins ties.
  ``torch.topk`` does not specify the order of equal values, so selection
  is a stable sort.

Non-finite values follow the port's one rule: a corpus row holding NaN or
+-inf is never returned, a query row holding one gets (NaN, INT32_MAX) in
every slot, and no selection ever takes a NaN score.

Products run in full float32 (or float64): TF32 is switched off for the
duration of each call on the card, because its 10-bit mantissa cannot
hold float32 semantics.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from .metrics import Metric, cosine_eps

INT32_MAX = torch.iinfo(torch.int32).max


@contextlib.contextmanager
def exact_matmul():
    """Run the enclosed products in full precision: TF32 off for cuBLAS
    matmuls and cuDNN, restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def mixed_matmul(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Q . C^T in q's dtype, never TF32: the JAX package's
    ``preferred_element_type=q.dtype``.  Operands of two dtypes multiply
    in their promoted dtype (float32 x float64 in float64, bfloat16 x
    float32 in float32) and the product is cast to q's dtype."""
    dt = torch.promote_types(q.dtype, c.dtype)
    with exact_matmul():
        return torch.matmul(q.to(dt), c.to(dt).T).to(q.dtype)


def pairwise_scores(q: torch.Tensor, c: torch.Tensor,
                    metric=Metric.COSINE, *,
                    precision: str = "highest") -> torch.Tensor:
    """Dense (n_queries, n_corpus) score matrix for the given metric.

    ``precision`` is accepted for signature parity; this path always
    computes exact products in the input dtype.
    """
    metric = Metric.parse(metric)
    d = mixed_matmul(q, c)
    if metric is Metric.DOT:
        return d
    if metric is Metric.COSINE:
        eps = cosine_eps(q.dtype)
        qn = torch.sqrt(torch.sum(q * q, dim=1))
        cn = torch.sqrt(torch.sum(c * c, dim=1))
        denom_ok = (qn[:, None] > eps) & (cn[None, :] > eps)
        denom = qn[:, None] * cn[None, :]
        safe = torch.where(denom_ok, denom, torch.ones_like(denom))
        return torch.where(denom_ok, d / safe, torch.zeros_like(d))
    qsq = torch.sum(q * q, dim=1)
    csq = torch.sum(c * c, dim=1)
    sq = qsq[:, None] + csq[None, :] - 2.0 * d
    return torch.sqrt(torch.clamp(sq, min=0.0))


def bad_rows(x: torch.Tensor) -> torch.Tensor:
    """(rows,) bool: the rows of ``x`` that hold a NaN or +-inf."""
    return ~torch.isfinite(x).all(dim=1)


def _worst(higher_is_better: bool) -> float:
    return float("-inf") if higher_is_better else float("inf")


def void_bad_queries(q: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NaN, INT32_MAX) in every slot of a query row of ``q`` that holds a
    NaN or +-inf; the other rows as they are."""
    bad = bad_rows(q)[:, None].to(vals.device)
    return (torch.where(bad, torch.full_like(vals, float("nan")), vals),
            torch.where(bad, torch.full_like(idx, INT32_MAX), idx))


def topk_from_scores(scores: torch.Tensor, k: int,
                     higher_is_better: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row, best first, lowest index first among equal values.
    A NaN score counts as the worst value (-inf similarity, +inf
    distance), and every slot holding the worst value gets the index
    INT32_MAX."""
    worst = _worst(higher_is_better)
    scores = torch.where(torch.isnan(scores), worst, scores)
    vals, idx = torch.sort(scores, dim=1, descending=higher_is_better,
                           stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    return vals, torch.where(vals == worst, INT32_MAX, idx)


def topk_two_key(vals: torch.Tensor, idx: torch.Tensor, k: int,
                 higher_is_better: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row of (vals, idx) pairs by explicit (score, index) keys:
    best score first, the lower index first among equal scores, whatever
    order the pairs come in.  A stable sort by index, then a stable sort
    by score, orders every pair by its own key.  A NaN score counts as
    the worst value, which then carries the index INT32_MAX."""
    worst = _worst(higher_is_better)
    vals = torch.where(torch.isnan(vals), worst, vals)
    idx = torch.where(vals == worst, INT32_MAX, idx)
    by_index = torch.sort(idx, dim=1, stable=True).indices
    vals = torch.gather(vals, 1, by_index)
    idx = torch.gather(idx, 1, by_index)
    order = torch.sort(vals, dim=1, descending=higher_is_better,
                       stable=True).indices[:, :k]
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def topk_search(q: torch.Tensor, c: torch.Tensor, k: int,
                metric=Metric.COSINE, *,
                mask: Optional[torch.Tensor] = None,
                precision: str = "highest"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ((m, k) scores, (m, k) int32 indices).

    ``k`` must already be clamped to ``c.shape[0]``.  ``mask`` (n,) bool
    excludes corpus rows, and so does a corpus row holding NaN or +-inf;
    slots beyond the number of rows left carry the sentinels (-inf
    similarity / +inf distance, index int32-max), and a query row holding
    NaN or +-inf gets (NaN, int32-max) in every slot.
    """
    metric = Metric.parse(metric)
    scores = pairwise_scores(q, c, metric, precision=precision)
    keep = ~bad_rows(c)
    if mask is not None:
        keep = keep & mask.to(torch.bool)
    scores = torch.where(keep[None, :], scores,
                         _worst(metric.higher_is_better))
    vals, idx = topk_from_scores(scores, k, metric.higher_is_better)
    return void_bad_queries(q, vals, idx.to(torch.int32))
