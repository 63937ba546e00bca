"""The storage tiers' row preparation (shared by ``api.search``,
``api.clustered`` and ``parallel.sharded``): host and torch per-row int8 /
int4 quantization of float rows into a tier's codes and scales, the host
inverse of the int4 packing, and ``prepare_corpus`` of stored rows in row
chunks.  Every quantizer gives a row holding NaN or +-inf zero codes and
a NaN scale, which the prep turns into a row no kernel selects."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .fused_topk import (feature_geometry, prepare_corpus, quantize_int4,
                         quantize_int8)

ArrayLike = Union[np.ndarray, torch.Tensor]


def _row_scales_np(blk: np.ndarray, top: float) -> np.ndarray:
    """``fused_topk._row_scale`` on the host: max|row| / top, 1.0 for a
    zero row, NaN for a row holding NaN or +-inf."""
    amax = np.abs(blk).max(axis=1)
    sc = np.where(amax > 0, amax / np.float32(top), np.float32(1.0))
    return np.where(np.isfinite(amax), sc, np.nan).astype(np.float32)


def _codes_np(x: np.ndarray, sc: np.ndarray) -> np.ndarray:
    """``fused_topk._codes`` on the host: rounded codes as int8, zero in
    every row of a NaN scale."""
    return np.where(np.isnan(sc)[:, None], 0.0, x).astype(np.int8)


def _quantize_rows_int4_np(c: np.ndarray, ck: int, dpp: int):
    """Host per-row symmetric int4 quantization, nibble-packed per feature
    chunk (the layout of ``kernels.fused_topk.quantize_int4``), in row
    chunks so the f32 / int32 temporaries stay bounded."""
    n, dim = c.shape
    packed = np.empty((n, dpp // 2), np.int8)
    scales = np.empty(n, np.float32)
    step = max(1, (64 << 20) // max(dpp * 4, 1))
    for r0 in range(0, n, step):
        blk = np.asarray(c[r0:r0 + step], dtype=np.float32)
        sc = _row_scales_np(blk, 7.0)
        codes = _codes_np(np.clip(np.rint(blk / sc[:, None]), -7, 7), sc)
        codes = np.pad(codes.astype(np.int32), ((0, 0), (0, dpp - dim)))
        ch = codes.reshape(codes.shape[0], dpp // ck, ck)
        packed[r0:r0 + step] = ((ch[:, :, : ck // 2] & 0xF)
                                | ((ch[:, :, ck // 2:] & 0xF) << 4)
                                ).astype(np.int8).reshape(
                                    codes.shape[0], dpp // 2)
        scales[r0:r0 + step] = sc
    return packed, scales


def _unpack_int4_np(packed: np.ndarray, ck: int, dim: int) -> np.ndarray:
    """Host inverse of the int4 packing -> int codes (n, dim)."""
    n = packed.shape[0]
    p32 = packed.astype(np.int32).reshape(n, -1, ck // 2)
    lo = ((p32 & 0xF) ^ 8) - 8
    hi = (((p32 >> 4) & 0xF) ^ 8) - 8
    return np.concatenate([lo, hi], axis=2).reshape(n, -1)[:, :dim]


def _quantize_rows_np(c: np.ndarray):
    """Host per-row symmetric int8 quantization (``quantize_int8``'s
    semantics), in row chunks so the f32 temporary stays bounded; the
    corpus then uploads a quarter of the f32 bytes."""
    n, dim = c.shape
    codes = np.empty((n, dim), np.int8)
    scales = np.empty(n, np.float32)
    step = max(1, (64 << 20) // max(dim * 4, 1))
    for r0 in range(0, n, step):
        blk = np.asarray(c[r0:r0 + step], dtype=np.float32)
        s = _row_scales_np(blk, 127.0)
        codes[r0:r0 + step] = _codes_np(np.rint(blk / s[:, None]), s)
        scales[r0:r0 + step] = s
    return codes, scales


def quantize_stored(c: ArrayLike, storage: str, dim: int,
                    device: torch.device, chunk_rows: int,
                    rows: Optional[int] = None):
    """(codes, scales) of float rows for an "int8" or "int4" tier: NumPy
    by the host quantizers (codes stay NumPy, so that the caller uploads
    quantized bytes), a tensor by the torch ones on its own device, in
    row chunks, into tensors on ``device`` of ``rows`` rows (default n;
    codes 0 and scale 1 past n).  A row holding NaN or +-inf: codes 0,
    scale NaN."""
    int4 = storage == "int4"
    ck, dpp, _ = feature_geometry(dim)
    if not isinstance(c, torch.Tensor):
        return (_quantize_rows_int4_np(c, ck, dpp) if int4
                else _quantize_rows_np(c))
    n = c.shape[0]
    rows = n if rows is None else rows
    codes = torch.zeros((rows, dpp // 2 if int4 else dim), dtype=torch.int8,
                        device=device)
    scales = torch.ones(rows, dtype=torch.float32, device=device)
    for r0 in range(0, n, chunk_rows):
        r1 = min(n, r0 + chunk_rows)
        qc, sc = (quantize_int4(c[r0:r1], ck) if int4
                  else quantize_int8(c[r0:r1]))
        codes[r0:r1].copy_(qc)
        scales[r0:r1].copy_(sc)
    return codes, scales


def prepare_stored(c: torch.Tensor, scales: Optional[torch.Tensor], metric,
                   precision: str, chunk_rows: int):
    """``prepare_corpus`` of stored rows in row chunks, so that no prep
    holds a full-size f32 temporary.  Where the prep leaves the rows as
    stored (int8 / int4 codes, bf16 rows for dot and euclidean, f32 rows
    for "highest" dot and euclidean) cp is the storage itself and only the
    bias or scale | bias rows are computed."""
    n = c.shape[0]
    cp = cbp = None
    for r0 in range(0, n, chunk_rows):
        r1 = min(n, r0 + chunk_rows)
        chunk = c[r0:r1]
        sc = None if scales is None else scales[r0:r1]
        cpc, cbc = prepare_corpus(chunk, metric, precision=precision,
                                  scales=sc)
        if r1 - r0 == n:
            return cpc, cbc
        if cp is None:
            shared = cpc.data_ptr() == chunk.data_ptr()
            cp = c if shared else torch.empty(
                (n,) + tuple(cpc.shape[1:]), dtype=cpc.dtype,
                device=c.device)
            cbp = torch.empty(tuple(cbc.shape[:-1]) + (n,),
                              dtype=cbc.dtype, device=c.device)
        if cp is not c:
            cp[r0:r1] = cpc
        cbp[..., r0:r1] = cbc
    return cp, cbp
