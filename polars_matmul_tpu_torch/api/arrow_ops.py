"""The two public operations on Arrow embedding columns (port of
``polars_matmul_tpu.api.arrow_ops``).

Each comes in two layers.  ``topk_buffers`` / ``matmul_buffers`` take
columns as ``interop.buffers.EmbeddingColumn`` (Arrow's buffers as NumPy
arrays) and return result buffers: they need no ``pyarrow``, and they are
all the work.  ``topk_arrow`` / ``matmul_arrow`` take ``pyarrow`` arrays
apart into those buffers and build ``pyarrow`` arrays from the results;
the Polars namespace calls through them.

The JAX package's contract:
- an empty left column gives a typed empty result (not an error);
- an empty corpus column raises "Empty series";
- the both-f32 rule picks the compute dtype;
- k is clamped to the corpus size; top-k scores are widened to f64;
- ``mask`` (n_corpus,) excludes rows, and its Arrow nulls count as
  excluded;
- ``corpus`` may be a resident ``Corpus`` or ``ClusteredCorpus`` handle,
  whose own ``config`` and device govern (``config=`` or ``device=`` with
  one raises); ``probe=`` needs a ``ClusteredCorpus``.

``device=`` places a call on columns as ``topk`` / ``matmul`` do: the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..config import SearchConfig
from ..interop import buffers as B
from ..ops.metrics import Metric
from ..utils.profiling import annotate
from . import search
from .clustered import ClusteredCorpus
from .search import DeviceLike

_HANDLES = (search.Corpus, ClusteredCorpus)


def _handle_only(config, device) -> None:
    if config is not None:
        raise ValueError(
            "config= has no effect with a resident Corpus — the handle's "
            "own config governs (pass config= to Corpus)")
    if device is not None:
        raise ValueError(
            "device= has no effect with a resident Corpus — the handle "
            "lives on its own device (pass device= to Corpus)")


def topk_buffers(left: B.EmbeddingColumn, corpus, k: int,
                 metric: Union[str, Metric] = "cosine", *, mask=None,
                 probe: Union[float, int, None] = None,
                 config: Optional[SearchConfig] = None,
                 device: DeviceLike = None) -> B.TopkBuffers:
    """Top-k of each left row against ``corpus`` (an ``EmbeddingColumn``
    or a handle), as ``List<Struct{index: u32, score: f64}>`` buffers.
    ``mask`` is a ``BoolColumn`` or anything ``np.asarray`` reads."""
    Metric.parse(metric)   # a bad metric raises before any data moves
    clustered = isinstance(corpus, ClusteredCorpus)
    if probe is not None and not clustered:
        raise ValueError(
            "probe= requires a ClusteredCorpus handle (only a clustered "
            "layout knows which corpus tiles a probe may skip)")
    if isinstance(corpus, _HANDLES):
        _handle_only(config, device)
        if len(left) == 0:
            return B.empty_topk_buffers()
        dt = B.promote_pair(B.value_type(left), corpus.dtype)
        with annotate("pmm.extract"):
            q = B.extract_matrix(left, dt)
        kw = {"probe": probe} if clustered else {}
        idx, scores = corpus.topk(q, k, metric, mask=B.mask_values(mask),
                                  **kw)
        with annotate("pmm.assemble"):
            return B.topk_to_buffers(idx, scores)
    if len(left) == 0:
        return B.empty_topk_buffers()
    if len(corpus) == 0:
        raise ValueError("Empty series")
    dt = B.promote_pair(B.value_type(left), B.value_type(corpus))
    with annotate("pmm.extract"):
        q = B.extract_matrix(left, dt)
        c = B.extract_matrix(corpus, dt)
    idx, scores = search.topk(q, c, k, metric, mask=B.mask_values(mask),
                              config=config, device=device)
    with annotate("pmm.assemble"):
        return B.topk_to_buffers(idx, scores)


def matmul_buffers(left: B.EmbeddingColumn, corpus, *,
                   flatten: bool = False,
                   config: Optional[SearchConfig] = None,
                   device: DeviceLike = None) -> B.MatrixBuffers:
    """All pairwise dot products of the left rows against ``corpus`` (an
    ``EmbeddingColumn`` or a handle, original row order either way), as a
    ``FixedSizeList[n_corpus]`` column's buffers, or with ``flatten`` the
    flat row-major column's."""
    if isinstance(corpus, _HANDLES):
        _handle_only(config, device)
        dt = B.promote_pair(B.value_type(left), corpus.dtype)
        if len(left) == 0:
            return B.empty_matrix_buffers(dt)
        out = corpus.matmul(B.extract_matrix(left, dt))
    else:
        if len(left) == 0:
            dt = (np.dtype(np.float64) if len(corpus) == 0
                  else B.promote_pair(B.value_type(left),
                                      B.value_type(corpus)))
            return B.empty_matrix_buffers(dt)
        if len(corpus) == 0:
            raise ValueError("Empty series")
        dt = B.promote_pair(B.value_type(left), B.value_type(corpus))
        q = B.extract_matrix(left, dt)
        c = B.extract_matrix(corpus, dt)
        out = search.matmul(q, c, config=config, device=device)
    return B.flat_buffers(out) if flatten else B.matrix_to_buffers(out)


def topk_arrow(left, corpus, k: int, metric: Union[str, Metric] = "cosine",
               *, mask=None, probe: Union[float, int, None] = None,
               config: Optional[SearchConfig] = None,
               device: DeviceLike = None):
    """Arrow List / FixedSizeList embeddings -> ``List[Struct{index: u32,
    score: f64}]``: ``topk_buffers`` on ``pyarrow`` arrays.  ``corpus``
    may be a resident ``Corpus`` or ``ClusteredCorpus`` handle (the serving
    pattern: prepared once, queried straight from Arrow columns); ``mask``
    a boolean column or ndarray over the corpus rows."""
    from ..interop import arrow as ai

    if not isinstance(corpus, _HANDLES):
        corpus = ai.to_column(corpus)
    return ai.topk_array(topk_buffers(
        ai.to_column(left), corpus, k, metric, mask=ai.to_mask(mask),
        probe=probe, config=config, device=device))


def matmul_arrow(left, corpus, *, flatten: bool = False,
                 config: Optional[SearchConfig] = None,
                 device: DeviceLike = None):
    """Arrow embeddings -> ``FixedSizeList[n_corpus]`` of pairwise dot
    products (a flat row-major column with ``flatten``):
    ``matmul_buffers`` on ``pyarrow`` arrays.  ``corpus`` may be a
    resident ``Corpus`` or ``ClusteredCorpus`` handle."""
    from ..interop import arrow as ai

    if not isinstance(corpus, _HANDLES):
        corpus = ai.to_column(corpus)
    return ai.matrix_array(matmul_buffers(
        ai.to_column(left), corpus, flatten=flatten, config=config,
        device=device))
