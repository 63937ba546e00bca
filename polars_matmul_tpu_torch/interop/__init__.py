"""Arrow interop: ``buffers`` (extraction and result layouts on raw Arrow
buffers, NumPy only), ``native`` (the host List packer, built with g++ at
first use) and ``arrow`` (the ``pyarrow`` adapter, which imports
``pyarrow`` only when called)."""

from .arrow import (
    ExtractError,
    column_dim,
    empty_matrix_arrow,
    empty_topk_arrow,
    extract_matrix,
    matrix_to_arrow,
    promote_pair,
    topk_to_arrow,
)
from .native import native_available

__all__ = [
    "ExtractError",
    "column_dim",
    "empty_matrix_arrow",
    "empty_topk_arrow",
    "extract_matrix",
    "matrix_to_arrow",
    "native_available",
    "promote_pair",
    "topk_to_arrow",
]
