"""Arrow embedding columns as raw buffers: extraction into a dense matrix
and the result layouts, without ``pyarrow`` (the layout work of
``polars_matmul_tpu.interop.arrow``).

An ``EmbeddingColumn`` describes a ``FixedSizeList`` / ``List`` /
``LargeList`` column by Arrow's own buffers as NumPy arrays: the child's
values buffer and its offset and validity bitmap, the list size or the
offsets buffer, and the parent's validity bitmap, offset and length.
Bitmaps are Arrow's (bit ``offset + i`` is row i, least significant bit
first).  ``interop.arrow`` takes ``pyarrow`` arrays apart into these
buffers and builds arrays from the result buffers; the work between runs
here, on any machine that has NumPy.

The extraction rules are the JAX package's (``extract_matrix``): a
FixedSizeList of the target dtype with no nulls is returned as a view of
its buffer (no copy); every other column is packed, null rows and null
values as 0.0.  A List's dimension comes from its first row, which must
not be null; every valid row must have it.  The compute dtype is float32
only when both columns are float32 (the both-f32 rule); every other value
type, float16 included, computes in float64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .native import native_pack_list

_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)
# Arrow's names of the value types an embedding may have.
_ARROW_NAMES = {np.dtype(t): name for t, name in (
    (np.float16, "halffloat"), (np.float32, "float"), (np.float64, "double"),
    (np.int8, "int8"), (np.int16, "int16"), (np.int32, "int32"),
    (np.int64, "int64"), (np.uint8, "uint8"), (np.uint16, "uint16"),
    (np.uint32, "uint32"), (np.uint64, "uint64"))}
_SUPPORTED = frozenset(_ARROW_NAMES.values())

# Packs of List columns by route: the native library or the plain loop.
packs = {"native": 0, "plain": 0}


class ExtractError(ValueError):
    """A malformed embedding column (the JAX package's messages)."""


@dataclass
class EmbeddingColumn:
    """An embedding column by its Arrow buffers (see the module
    docstring).  ``list_size`` makes it a FixedSizeList, ``offsets`` (int32
    for List, int64 for LargeList; entry ``offset + i`` starts row i) a
    List; with neither, it stands for a column of another Arrow type,
    ``type_name``, which extraction refuses.  ``value_type`` is Arrow's
    name of the child's type (by default from ``values.dtype``); a type
    NumPy cannot hold comes with ``values=None`` and is refused too."""

    length: int
    values: Optional[np.ndarray] = None
    list_size: Optional[int] = None
    offsets: Optional[np.ndarray] = None
    offset: int = 0
    validity: Optional[np.ndarray] = None
    values_offset: int = 0
    values_validity: Optional[np.ndarray] = None
    value_type: Optional[str] = None
    type_name: Optional[str] = None

    def __post_init__(self):
        if self.value_type is None and self.values is not None:
            self.value_type = _ARROW_NAMES.get(self.values.dtype,
                                               str(self.values.dtype))

    def __len__(self) -> int:
        return self.length


def matrix_column(matrix: np.ndarray) -> EmbeddingColumn:
    """A FixedSizeList column over the rows of a C-contiguous (n, dim)
    matrix (its buffer, not a copy)."""
    if matrix.ndim != 2 or not matrix.flags.c_contiguous:
        raise ValueError("expected a C-contiguous (n, dim) matrix")
    return EmbeddingColumn(length=matrix.shape[0],
                           values=matrix.reshape(-1),
                           list_size=matrix.shape[1])


@dataclass(frozen=True)
class BoolColumn:
    """An Arrow boolean column: its data and validity bitmaps."""

    data: np.ndarray
    length: int
    offset: int = 0
    validity: Optional[np.ndarray] = None


@dataclass(frozen=True)
class TopkBuffers:
    """A ``List<Struct{index: u32, score: f64}>`` column: int32 offsets
    (n + 1) and the flat index and score children."""

    offsets: np.ndarray
    index: np.ndarray
    score: np.ndarray

    def __len__(self) -> int:
        return self.offsets.size - 1


@dataclass(frozen=True)
class MatrixBuffers:
    """A score column: ``FixedSizeList[list_size]`` over the flat
    row-major ``values``; with int32 ``offsets`` instead a ``List``; with
    neither a flat column."""

    values: np.ndarray
    list_size: Optional[int] = None
    offsets: Optional[np.ndarray] = None


def bits(bitmap: np.ndarray, offset: int, length: int) -> np.ndarray:
    """Bits [offset, offset + length) of an Arrow bitmap, as bools."""
    b0, head = offset >> 3, offset & 7
    raw = np.unpackbits(bitmap[b0:(offset + length + 7) >> 3],
                        bitorder="little")
    return raw[head:head + length].astype(bool)


def all_set(bitmap: Optional[np.ndarray], offset: int, length: int) -> bool:
    """Whether bits [offset, offset + length) are all set (no bitmap: all
    valid).  Whole bytes are compared as bytes."""
    if bitmap is None or length == 0:
        return True
    head = min((-offset) & 7, length)
    full = (length - head) >> 3
    start = offset + head
    b0 = start >> 3
    if head and not bits(bitmap, offset, head).all():
        return False
    if not (bitmap[b0:b0 + full] == 0xFF).all():
        return False
    tail = length - head - 8 * full
    return not tail or bool(bits(bitmap, start + 8 * full, tail).all())


def value_type(col: EmbeddingColumn) -> str:
    """Arrow's name of the column's value type; a column that is not a
    list is refused with the JAX package's message."""
    if col.list_size is None and col.offsets is None:
        raise ExtractError(
            f"Expected a List or FixedSizeList column, got {col.type_name}")
    return col.value_type


def _is_f32(t) -> bool:
    if isinstance(t, str):
        return t == "float"
    return np.dtype(t) == _F32


def promote_pair(left, right) -> np.dtype:
    """Both-f32 rule: float32 iff both value types (Arrow names, or NumPy
    dtypes) are float32; float64 otherwise."""
    return _F32 if _is_f32(left) and _is_f32(right) else _F64


def column_dim(col: EmbeddingColumn) -> int:
    """Vector dimension of an embedding column (0 rows -> 0)."""
    if col.list_size is not None:
        return int(col.list_size)
    if col.length == 0:
        return 0
    return int(col.offsets[col.offset + 1]) - int(col.offsets[col.offset])


def pack_list_plain(values: np.ndarray, offsets: np.ndarray,
                    validity: Optional[np.ndarray], bit_offset: int,
                    n_rows: int, dim: int) -> np.ndarray:
    """Plain version of the native packer, the JAX package's loop: row i
    is ``values[offsets[i]:offsets[i + 1]]``, zeros where bit
    ``bit_offset + i`` of ``validity`` is clear; the first valid row of
    another length raises, named."""
    out = np.zeros((n_rows, dim), dtype=values.dtype)
    valid = None if validity is None else bits(validity, bit_offset, n_rows)
    for i in range(n_rows):
        if valid is not None and not valid[i]:
            continue
        s, e = int(offsets[i]), int(offsets[i + 1])
        ln = min(e - s, dim)
        if e - s != dim:
            raise ExtractError(
                f"Dimension mismatch: row {i} has {e - s} dimensional "
                f"vectors, expected {dim}"
            )
        out[i, :ln] = values[s: s + ln]
    return out


def pack_list(values: np.ndarray, offsets: np.ndarray,
              validity: Optional[np.ndarray], bit_offset: int, n_rows: int,
              dim: int) -> np.ndarray:
    """The native packer where it builds, else ``pack_list_plain``;
    ``packs`` counts each."""
    out = native_pack_list(values, offsets, validity, bit_offset, n_rows,
                           dim)
    if out is not None:
        packs["native"] += 1
        return out
    packs["plain"] += 1
    return pack_list_plain(values, offsets, validity, bit_offset, n_rows,
                           dim)


def _window(col: EmbeddingColumn, start: int, length: int,
            dtype: np.dtype) -> np.ndarray:
    """Child values [start, start + length) as ``dtype``, null values as
    0.0: a view where no cast and no null needs a copy."""
    flat = col.values[start:start + length]
    if all_set(col.values_validity, start, length):
        return flat.astype(dtype, copy=False)
    flat = flat.astype(dtype)
    flat[~bits(col.values_validity, start, length)] = 0
    return flat


def extract_matrix(col: EmbeddingColumn,
                   dtype: Optional[np.dtype] = None) -> np.ndarray:
    """Dense (n_rows, dim) row-major matrix of an embedding column, in
    ``dtype`` (default: float32 for float32 values, else float64)."""
    n = col.length
    if n == 0:
        raise ExtractError("Empty series")
    vt = value_type(col)
    if vt not in _SUPPORTED or col.values is None:
        raise ExtractError(f"Unsupported embedding value type: {vt}")
    dtype = promote_pair(vt, vt) if dtype is None else np.dtype(dtype)
    row_ok = all_set(col.validity, col.offset, n)

    if col.list_size is not None:
        dim = int(col.list_size)
        if dim == 0:
            raise ExtractError("Zero-dimensional vectors")
        start = col.values_offset + col.offset * dim
        out = _window(col, start, n * dim, dtype).reshape(n, dim)
        if row_ok:
            return np.ascontiguousarray(out)
        if np.may_share_memory(out, col.values):
            out = out.copy()
        out[~bits(col.validity, col.offset, n)] = 0.0
        return out

    offs = col.offsets[col.offset:col.offset + n + 1]
    if not row_ok and not bits(col.validity, col.offset, 1)[0]:
        raise ExtractError("First element is null")
    dim = int(offs[1]) - int(offs[0])
    if dim == 0:
        raise ExtractError("Zero-dimensional vectors")
    lo, hi = int(offs[0]), int(offs[-1])
    if row_ok and (np.diff(offs) == dim).all():
        flat = _window(col, col.values_offset + lo, n * dim, dtype)
        return np.ascontiguousarray(flat.reshape(n, dim))
    values = _window(col, col.values_offset + lo, hi - lo, dtype)
    return pack_list(values, offs.astype(np.int64) - lo,
                     None if row_ok else col.validity, col.offset, n, dim)


def extract_embedding(col: EmbeddingColumn) -> np.ndarray:
    """A column as a handle's embeddings, in its promoted dtype (the
    ``from_arrow`` front door of ``Corpus`` and ``ClusteredCorpus``)."""
    vt = value_type(col)
    return extract_matrix(col, promote_pair(vt, vt))


def mask_values(mask) -> Optional[np.ndarray]:
    """A mask as NumPy bools; a ``BoolColumn``'s nulls count as False
    (excluded)."""
    if mask is None:
        return None
    if isinstance(mask, BoolColumn):
        out = bits(mask.data, mask.offset, mask.length)
        if mask.validity is not None:
            out &= bits(mask.validity, mask.offset, mask.length)
        return out
    return np.asarray(mask).astype(bool)


def topk_to_buffers(indices: np.ndarray, scores: np.ndarray) -> TopkBuffers:
    """(n, k) results -> offsets ``arange(n + 1) * k`` and flat u32 index
    and f64 score children."""
    n, k = indices.shape
    return TopkBuffers(
        offsets=(np.arange(n + 1, dtype=np.int64) * k).astype(np.int32),
        index=np.ascontiguousarray(indices, dtype=np.uint32).reshape(-1),
        score=np.ascontiguousarray(scores, dtype=np.float64).reshape(-1))


def empty_topk_buffers() -> TopkBuffers:
    """The typed empty result of 0 queries."""
    return TopkBuffers(offsets=np.zeros(1, np.int32),
                       index=np.empty(0, np.uint32),
                       score=np.empty(0, np.float64))


def matrix_to_buffers(scores: np.ndarray) -> MatrixBuffers:
    """(m, n) scores -> a FixedSizeList[n] column."""
    return MatrixBuffers(values=np.ascontiguousarray(scores).reshape(-1),
                         list_size=scores.shape[1])


def flat_buffers(scores: np.ndarray) -> MatrixBuffers:
    """(m, n) scores -> the flat row-major column (``flatten=True``)."""
    return MatrixBuffers(values=np.ascontiguousarray(scores).reshape(-1))


def empty_matrix_buffers(dtype) -> MatrixBuffers:
    """The typed empty matmul result: an empty ``List`` of f32 or f64."""
    inner = _F32 if np.dtype(dtype) == _F32 else _F64
    return MatrixBuffers(values=np.empty(0, inner),
                         offsets=np.zeros(1, np.int32))

