"""The ``pyarrow`` adapter over ``interop.buffers``: the JAX package's
``interop`` names, on ``pyarrow`` arrays.

Each function takes a ``pa.Array`` / ``pa.ChunkedArray`` (a chunked array
is combined first; ``extract_embedding_column`` also takes a polars
Series, through ``to_arrow``) apart into its buffers, or builds a
``pa.Array`` from result buffers, without copying them; the extraction and
assembly themselves are ``buffers``'.  ``pyarrow`` is imported inside the
functions only: the package imports, and the buffer layer runs, without
it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import buffers as B
from .buffers import ExtractError

__all__ = ["ExtractError", "column_dim", "empty_matrix_arrow",
           "empty_topk_arrow", "extract_embedding_column", "extract_matrix",
           "matrix_to_arrow", "promote_pair", "to_column", "to_mask",
           "topk_to_arrow"]


def _view(buf, dtype) -> np.ndarray:
    """A read-only NumPy view of an Arrow buffer (Arrow's memory is
    immutable)."""
    dtype = np.dtype(dtype)
    out = (np.empty(0, dtype) if buf is None
           else np.frombuffer(buf, dtype, count=buf.size // dtype.itemsize))
    out.flags.writeable = False
    return out


def _bitmap(arr) -> Optional[np.ndarray]:
    """An array's validity bitmap as bytes (None when nothing is null)."""
    buf = arr.buffers()[0]
    if arr.null_count == 0 or buf is None:
        return None
    return _view(buf, np.uint8)


def to_column(arr) -> B.EmbeddingColumn:
    """The buffers of an embedding column (an ``EmbeddingColumn`` is
    returned as it is, without importing ``pyarrow``)."""
    if isinstance(arr, B.EmbeddingColumn):
        return arr
    import pyarrow as pa

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    fixed = pa.types.is_fixed_size_list(t)
    if not (fixed or pa.types.is_list(t) or pa.types.is_large_list(t)):
        return B.EmbeddingColumn(length=len(arr), type_name=str(t))
    child = arr.values   # the whole child, at its own offset
    vt = t.value_type
    values = None
    if pa.types.is_integer(vt) or pa.types.is_floating(vt):
        values = _view(child.buffers()[1], vt.to_pandas_dtype())
    offsets = None
    if not fixed:
        offsets = _view(arr.buffers()[1],
                        np.int32 if pa.types.is_list(t) else np.int64)
    return B.EmbeddingColumn(
        length=len(arr), values=values,
        list_size=t.list_size if fixed else None, offsets=offsets,
        offset=arr.offset, validity=_bitmap(arr), values_offset=child.offset,
        values_validity=_bitmap(child), value_type=str(vt))


def to_mask(mask):
    """A boolean ``pa`` array as a ``BoolColumn`` (its nulls exclude);
    anything else as it is."""
    import pyarrow as pa

    if not isinstance(mask, (pa.Array, pa.ChunkedArray)):
        return mask
    if isinstance(mask, pa.ChunkedArray):
        mask = mask.combine_chunks()
    if not pa.types.is_boolean(mask.type):
        mask = mask.cast(pa.bool_())
    return B.BoolColumn(data=_view(mask.buffers()[1], np.uint8),
                        length=len(mask), offset=mask.offset,
                        validity=_bitmap(mask))


def promote_pair(left_vt, right_vt) -> np.dtype:
    """Both-f32 rule on two Arrow value types."""
    return B.promote_pair(str(left_vt), str(right_vt))


def extract_matrix(arr, dtype: Optional[np.dtype] = None) -> np.ndarray:
    """Dense (n_rows, dim) matrix of an Arrow embedding column: a view of
    its buffer for a FixedSizeList of ``dtype`` with no nulls, else
    packed, nulls as 0.0."""
    return B.extract_matrix(to_column(arr), dtype)


def extract_embedding_column(column) -> np.ndarray:
    """An Arrow (or polars) embedding column as a handle's embeddings in
    its promoted dtype: the ``from_arrow`` front door of ``Corpus`` and
    ``ClusteredCorpus``."""
    if hasattr(column, "to_arrow"):   # polars Series
        column = column.to_arrow()
    return B.extract_embedding(to_column(column))


def column_dim(arr) -> int:
    """Vector dimension of an embedding column (0 rows -> 0)."""
    return B.column_dim(to_column(arr))


def topk_array(out: B.TopkBuffers):
    """``TopkBuffers`` -> ``List<Struct{index: u32, score: f64}>``."""
    import pyarrow as pa

    struct = pa.StructArray.from_arrays(
        [pa.array(out.index, type=pa.uint32()),
         pa.array(out.score, type=pa.float64())], names=["index", "score"])
    return pa.ListArray.from_arrays(pa.array(out.offsets, type=pa.int32()),
                                    struct)


def matrix_array(out: B.MatrixBuffers):
    """``MatrixBuffers`` -> FixedSizeList, List or flat column."""
    import pyarrow as pa

    flat = pa.array(out.values)
    if out.list_size is not None:
        return pa.FixedSizeListArray.from_arrays(flat, out.list_size)
    if out.offsets is not None:
        return pa.ListArray.from_arrays(pa.array(out.offsets,
                                                 type=pa.int32()), flat)
    return flat


def topk_to_arrow(indices: np.ndarray, scores: np.ndarray):
    """(n, k) arrays -> Arrow ``List<Struct{index: u32, score: f64}>``."""
    return topk_array(B.topk_to_buffers(indices, scores))


def empty_topk_arrow():
    """Typed empty result for 0 queries."""
    return topk_array(B.empty_topk_buffers())


def matrix_to_arrow(scores: np.ndarray):
    """(m, n) scores -> Arrow ``FixedSizeList[n]`` column."""
    return matrix_array(B.matrix_to_buffers(scores))


def empty_matrix_arrow(dtype: np.dtype):
    """Typed empty matmul result: ``List`` of f32 or f64."""
    return matrix_array(B.empty_matrix_buffers(dtype))
