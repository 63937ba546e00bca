"""Polars ``.pmm`` expression namespace (port of
``polars_matmul_tpu.api.namespace``).

Importing the package registers the namespace on ``pl.Expr`` when polars
imports; ``topk(corpus, k, metric="cosine")`` returns
``List[Struct{index: u32, score: f64}]``; ``matmul(corpus, flatten=False)``
returns ``Array[f32|f64, n_corpus]`` or a flat column.  A Series crosses
into the search through Arrow (``Series.to_arrow`` is zero-copy) and
``topk_arrow`` / ``matmul_arrow``.

The JAX package registers the same name: with both imported, the later
import's ``pmm`` wins (polars warns that it overrides a namespace).

This module imports only when polars is installed; the rest of the package
works without it.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import polars as pl

from .arrow_ops import matmul_arrow, topk_arrow
from .clustered import ClusteredCorpus
from .search import Corpus, DeviceLike

MetricName = Literal["cosine", "dot", "euclidean"]

_TOPK_DTYPE = pl.List(pl.Struct({"index": pl.UInt32, "score": pl.Float64}))


def _series_to_arrow(s: pl.Series):
    return s.to_arrow()


def _from_arrow(arr, name: str) -> pl.Series:
    out = pl.from_arrow(arr)
    return out.rename(name)


@pl.api.register_expr_namespace("pmm")
class PmmNamespace:
    """Polars Expression API for similarity search operations.

    Registered automatically when you import ``polars_matmul_tpu_torch``.

    Example:
        >>> import polars as pl
        >>> import polars_matmul_tpu_torch  # registers .pmm namespace
        >>> df.with_columns(
        ...     pl.col("embedding").pmm.topk(corpus["embedding"], k=5)
        ... )
    """

    def __init__(self, expr: pl.Expr):
        self._expr = expr

    def topk(
        self,
        corpus: pl.Series,
        k: int,
        metric: MetricName = "cosine",
        *,
        mask: "pl.Series | None" = None,
        probe: "float | int | None" = None,
        device: DeviceLike = None,
    ) -> pl.Expr:
        """Find top-k similar corpus items per embedding.

        Returns ``List[Struct{index: u32, score: f64}]`` (cosine default,
        euclidean lower-is-better, k clamped to corpus size).  ``mask`` is
        an optional boolean Series over the corpus rows for filtered search
        (nulls excluded).  ``device=`` places a search against a Series as
        ``topk`` does (the card unless asked otherwise).

        ``corpus`` may also be a resident ``polars_matmul_tpu_torch.Corpus``
        or ``ClusteredCorpus`` handle (e.g. ``Corpus.from_arrow(
        df["embedding"])``): the corpus is uploaded and prepared once,
        and every expression evaluation only moves the queries — the
        serving pattern.  ``probe=`` (ClusteredCorpus only) bounds the
        corpus tiles each query block visits.
        """
        if isinstance(corpus, pl.Expr):
            raise TypeError(
                "corpus must be a Polars Series, not an Expression. "
                "Use corpus['column_name'] or "
                "corpus.get_column('column_name')."
            )
        corpus_arrow = (corpus
                        if isinstance(corpus, (Corpus, ClusteredCorpus))
                        else _series_to_arrow(corpus))
        mask_arrow = None if mask is None else _series_to_arrow(mask)

        def _run(s: pl.Series) -> pl.Series:
            out = topk_arrow(_series_to_arrow(s), corpus_arrow, k, metric,
                             mask=mask_arrow, probe=probe, device=device)
            return _from_arrow(out, "topk")

        return self._expr.map_batches(
            _run,
            is_elementwise=True,
            return_dtype=_TOPK_DTYPE,
        )

    def matmul(
        self,
        corpus: pl.Series,
        flatten: bool = False,
        *,
        device: DeviceLike = None,
    ) -> pl.Expr:
        """All pairwise dot products against ``corpus``.

        ``flatten=True`` returns the (n_queries * n_corpus) row-major flat
        column (a length-changing expression).
        ``corpus`` may be a resident ``Corpus`` or ``ClusteredCorpus``
        handle, like ``topk``.
        """
        if isinstance(corpus, pl.Expr):
            raise TypeError(
                "corpus must be a Polars Series, not an Expression. "
                "Use corpus['column_name'] or "
                "corpus.get_column('column_name')."
            )
        # The declared dtype follows the corpus's inner dtype; the closure
        # casts the computed result to it, so that mixed f32 / f64 inputs
        # cannot make the declaration and the data disagree.
        if isinstance(corpus, (Corpus, ClusteredCorpus)):
            corpus_arrow, n_corpus = corpus, corpus.n
            is_f32 = corpus.dtype == np.float32
        else:
            corpus_arrow, n_corpus = _series_to_arrow(corpus), len(corpus)
            is_f32 = getattr(corpus.dtype, "inner", None) == pl.Float32
        inner_dtype = pl.Float32 if is_f32 else pl.Float64

        if flatten:
            def _run_flat(s: pl.Series) -> pl.Series:
                out = matmul_arrow(_series_to_arrow(s), corpus_arrow,
                                   flatten=True, device=device)
                return _from_arrow(out, "matmul").cast(inner_dtype)

            return self._expr.map_batches(
                _run_flat,
                is_elementwise=False,  # output length differs from input
                return_dtype=inner_dtype,
            )

        dtype = pl.Array(inner_dtype, n_corpus)

        def _run(s: pl.Series) -> pl.Series:
            out = matmul_arrow(_series_to_arrow(s), corpus_arrow,
                               device=device)
            return _from_arrow(out, "matmul").cast(dtype)

        return self._expr.map_batches(
            _run,
            is_elementwise=True,
            return_dtype=dtype,
        )
