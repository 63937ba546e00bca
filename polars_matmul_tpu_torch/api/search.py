"""The public operations on NumPy arrays or torch tensors (port of
``polars_matmul_tpu.api.search``).

Same contract as the JAX package: the both-f32 rule (float64 otherwise,
through ``ops.reference``), "Dimension mismatch" / "Empty series" /
"Zero-dimensional vectors" errors, the k clamp, k=0 giving empty (m, 0)
results, an empty query batch giving a typed empty result, and
``(u32 indices, f64 scores)`` NumPy outputs.

Devices: every entry point takes ``device=`` (a ``torch.device`` or a
string).  Left out, a torch tensor input keeps its own device and a NumPy
input goes to ``"cuda"``.  The CPU is used only when asked for; asking for
``"cuda"`` without a card raises.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import SearchConfig, resolve
from ..kernels.fused_topk import (dequant_int4, feature_geometry,
                                  fused_topk, fused_topk_prepared,
                                  kernel_precision, max_fused_k,
                                  prepare_corpus, supports)
from ..kernels.matmul import pairwise_matmul
from ..kernels.storage import prepare_stored, quantize_stored
from ..ops.metrics import Metric
from ..parallel.sharded import (distributed_matmul, distributed_topk,
                                shard_corpus)
from ..utils.profiling import annotate, call_stats

ArrayLike = Union[np.ndarray, torch.Tensor]
DeviceLike = Union[str, torch.device, None]

_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)
_HALF_TORCH = (torch.float16, torch.bfloat16)


def resolve_device(device: DeviceLike, *arrays) -> torch.device:
    """The device a call runs on (see the module docstring)."""
    if device is not None:
        dev = torch.device(device)
    else:
        dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
                   torch.device("cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested (the default for NumPy inputs) but "
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def _as_input(x) -> ArrayLike:
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _is_f32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    return np.dtype(dtype) == _F32


def _is_half(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype in _HALF_TORCH
    return ((np.dtype(dtype).itemsize == 2
             and np.issubdtype(dtype, np.floating))
            or str(dtype) == "bfloat16")


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.float32 if dtype == _F32 else torch.float64


def _to_torch(x: ArrayLike, dtype: Optional[np.dtype],
              device: torch.device) -> torch.Tensor:
    """``x`` on ``device`` as ``dtype`` (None keeps a half dtype as is)."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        if str(x.dtype) == "bfloat16":
            x = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(x)
    tdt = x.dtype if dtype is None else _torch_dtype(dtype)
    return x.to(device=device, dtype=tdt)


def _to_host(vals: torch.Tensor, idx: torch.Tensor):
    return (idx.cpu().numpy().astype(np.uint32),
            vals.cpu().numpy().astype(np.float64))


def _validate_pair(q: ArrayLike, c: ArrayLike) -> None:
    if q.ndim != 2 or c.ndim != 2:
        raise ValueError("Embeddings must be 2-D (n_rows, dim) matrices")
    if q.shape[1] != c.shape[1]:
        raise ValueError(
            f"Dimension mismatch: left has {q.shape[1]} dimensional vectors, "
            f"right has {c.shape[1]} dimensional vectors"
        )
    if q.shape[1] == 0:
        raise ValueError("Zero-dimensional vectors")


def _host_ids(indices) -> np.ndarray:
    """Row ids as a flat host array (ids index the host tombstones and
    layout)."""
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    return np.asarray(indices).reshape(-1)


def _repeats(ids: np.ndarray) -> bool:
    """Whether an id occurs twice (a sort: ``np.unique`` imports
    ``numpy.ma`` on its first call, a tenth of a second)."""
    s = np.sort(ids)
    return bool((s[1:] == s[:-1]).any())


def _check_width(x, dim: int) -> None:
    """Rows (queries, or rows to add) of a handle's width."""
    if x.ndim != 2 or x.shape[1] != dim:
        raise ValueError(
            f"Dimension mismatch: left has "
            f"{x.shape[1] if x.ndim == 2 else tuple(x.shape)} "
            f"dimensional vectors, right has {dim} dimensional vectors"
        )


def _validate_mask(mask, n: int):
    if mask is None:
        return None
    m = _as_input(mask)
    if tuple(m.shape) != (n,):
        raise ValueError(
            f"mask must have shape ({n},) matching the corpus rows, "
            f"got {tuple(m.shape)}"
        )
    return m.to(torch.bool) if isinstance(m, torch.Tensor) else m.astype(bool)


def _mask_on(mask, device: torch.device) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    if isinstance(mask, torch.Tensor):
        return mask.to(device=device, dtype=torch.bool)
    return torch.from_numpy(np.ascontiguousarray(mask)).to(device)


def compute_dtype(q_dtype, c_dtype) -> np.dtype:
    """Both-f32 rule: float32 only when both inputs are float32."""
    return _F32 if _is_f32(q_dtype) and _is_f32(c_dtype) else _F64


def _empty_topk(m: int):
    return np.empty((m, 0), np.uint32), np.empty((m, 0), np.float64)


def matmul(queries: ArrayLike, corpus: ArrayLike, *,
           config: Optional[SearchConfig] = None,
           device: DeviceLike = None) -> np.ndarray:
    """All pairwise dot products: (m, n) = Q . C^T in the compute dtype."""
    cfg = resolve(config)
    q = _as_input(queries)
    c = _as_input(corpus)
    if q.shape[0] == 0:
        return np.empty((0, c.shape[0]), dtype=compute_dtype(q.dtype, c.dtype))
    if c.shape[0] == 0:
        raise ValueError("Empty series")
    _validate_pair(q, c)
    dt = compute_dtype(q.dtype, c.dtype)
    dev = resolve_device(device, q, c)
    with annotate("pmm.matmul"):
        out = pairwise_matmul(_to_torch(q, dt, dev), _to_torch(c, dt, dev),
                              precision=cfg.precision)
    return out.cpu().numpy()


def topk(queries: ArrayLike, corpus: ArrayLike, k: int,
         metric: Union[str, Metric] = "cosine", *, mask=None,
         config: Optional[SearchConfig] = None,
         device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """Fused top-k search.

    Returns ``(indices (m, k') u32, scores (m, k') f64)`` with
    ``k' = min(k, n_corpus)``, rows best first, ties lowest index first.
    ``mask`` (n_corpus,) bool excludes rows; slots beyond the matching
    rows carry sentinel scores (-inf similarity / +inf distance).  A
    corpus row holding NaN or +-inf is never returned, and a query row
    holding one gets (index 2147483647, score NaN) in every slot.
    """
    metric = Metric.parse(metric)
    q = _as_input(queries)
    c = _as_input(corpus)
    if q.shape[0] == 0:
        return np.empty((0, 0), np.uint32), np.empty((0, 0), np.float64)
    if c.shape[0] == 0:
        raise ValueError("Empty series")
    _validate_pair(q, c)
    mk = _validate_mask(mask, c.shape[0])
    kk = min(int(k), c.shape[0])
    if kk <= 0:
        return _empty_topk(q.shape[0])
    dt = compute_dtype(q.dtype, c.dtype)
    dev = resolve_device(device, q, c)
    t0 = time.perf_counter()
    with annotate(f"pmm.topk.{metric.value}"):
        vals, idx = fused_topk(_to_torch(q, dt, dev), _to_torch(c, dt, dev),
                               kk, metric, mask=_mask_on(mk, dev),
                               config=resolve(config))
        out = _to_host(vals, idx)
    call_stats("topk", m=q.shape[0], n=c.shape[0], dim=q.shape[1], k=kk,
               dtype=dt, wall_s=time.perf_counter() - t0)
    return out


def _is_int8(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.int8
    return np.dtype(dtype) == np.int8


def _row_block(x: ArrayLike, r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of ``x`` as a tensor on its own device (the CPU for
    NumPy)."""
    if isinstance(x, torch.Tensor):
        return x[r0:r1]
    return _to_torch(x[r0:r1], None, torch.device("cpu"))


def _holds(held: Optional[torch.Tensor], x) -> bool:
    """Whether ``held`` is the caller's ``x`` itself: the same tensor
    memory, or a NumPy array that ``torch.from_numpy`` viewed (a CPU
    handle keeps that view, read-only arrays included)."""
    if held is None:
        return False
    if isinstance(x, torch.Tensor):
        return x.data_ptr() == held.data_ptr()
    return (isinstance(x, np.ndarray) and x.size > 0
            and held.device.type == "cpu"
            and x.__array_interface__["data"][0] == held.data_ptr())


def _scales_vector(scales, n: int):
    scales = (scales.to(torch.float32) if isinstance(scales, torch.Tensor)
              else np.asarray(scales, dtype=np.float32)).reshape(-1)
    if scales.shape[0] != n:
        raise ValueError(
            f"scales must have shape ({n},), got {tuple(scales.shape)}")
    return scales


class Corpus:
    """Device-resident corpus handle: the corpus is uploaded and prepared
    once, and each ``topk`` / ``matmul`` call only moves the queries.

    ``storage`` is how the corpus is held on its one device, and each tier
    runs its own core of the fused kernel:

    - ``"f32"`` (float64 input keeps float64 and takes the reference path);
    - ``"bf16"``: half the bytes, searched by the "bf16c" core;
    - ``"int8"``: per-row symmetric int8 codes and one f32 scale a row (a
      quarter of the bytes), searched by "int8c", which converts codes to
      bf16 in the kernel and folds the scale into the epilogue; scores
      match the dequantized corpus.  Pre-quantized codes pass as int8
      ``embeddings`` with ``scales`` (n,), row ~= codes * scale;
    - ``"int4"``: codes in [-7, 7], two a byte (an eighth of the bytes),
      searched by "int4c"; pre-packed bytes pass with ``scales`` and the
      original ``dim``.

    Every quantized tier presents float32 semantics, whatever the input's
    float width.  Floats are quantized where they lie: NumPy on the host
    (so the upload moves quantized bytes), a tensor on its own device, in
    row chunks of ``config.prep_chunk_bytes``.  A torch tensor already in
    the tier's form is held as it is, on its own device unless
    ``device=`` says otherwise.

    Rows holding NaN or +-inf are held but never returned, whatever the
    tier (``topk``); ``add`` and ``update`` keep that rule row by row.

    ``capacity`` reserves stored rows for ``add``: rows in [n, capacity)
    are zeros (scale 1) whose prepared bias is -inf, so the kernels walk
    the whole buffer and never select them.  ``add``, ``update`` and
    ``delete`` mutate the handle in place, with the JAX package's
    semantics and errors.

    ``mesh=`` (``parallel.make_mesh``) shards the stored rows over the
    mesh's corpus axis (``parallel.shard_corpus``, the JAX package's
    padding) and serves ``topk`` / ``matmul`` by ``distributed_topk`` /
    ``distributed_matmul``; the handle's device is the mesh's home device
    (``device=`` is not taken).  On a mesh, ``add`` needs ``capacity=``
    and never grows past it, ``update`` writes each row into its shard
    and the shard's prepared forms in place, ``delete`` tombstones, and
    ``save`` gathers the shards, as in the JAX package.
    """

    def __init__(self, embeddings: ArrayLike, *, mesh=None,
                 storage: str = "f32", scales=None,
                 dim: Optional[int] = None, capacity: Optional[int] = None,
                 config: Optional[SearchConfig] = None,
                 device: DeviceLike = None):
        cfg = resolve(config)
        c = _as_input(embeddings)
        if c.ndim != 2:
            raise ValueError("Embeddings must be 2-D (n_rows, dim) matrices")
        if c.shape[0] == 0:
            raise ValueError("Empty series")
        if c.shape[1] == 0:
            raise ValueError("Zero-dimensional vectors")
        if storage not in ("f32", "bf16", "int8", "int4"):
            raise ValueError(f"Unknown storage mode: {storage!r}")
        int8_in = _is_int8(c.dtype)
        if int8_in and storage not in ("int8", "int4"):
            raise ValueError(
                "int8 embeddings (pre-quantized codes) require "
                "storage='int8' (or storage='int4' for nibble-packed "
                "codes with dim=)")
        prepacked_int4 = storage == "int4" and int8_in
        if prepacked_int4:
            if scales is None or dim is None:
                raise ValueError(
                    "pre-packed int4 codes require scales=(n,) and the "
                    "original dim= (the packed width is ambiguous)")
            _, dpp_chk, _ = feature_geometry(int(dim))
            if c.shape[1] * 2 != dpp_chk:
                raise ValueError(
                    f"packed width {c.shape[1]} does not match dim={dim} "
                    f"(expected {dpp_chk // 2})")
            scales = _scales_vector(scales, c.shape[0])
        elif dim is not None:
            raise ValueError("dim= is only meaningful with pre-packed int4 "
                             "codes")
        if storage == "int8" and int8_in:
            if scales is None:
                raise ValueError(
                    "pre-quantized int8 embeddings require scales=(n,) "
                    "with row ~= codes * scale")
            scales = _scales_vector(scales, c.shape[0])
        elif scales is not None and not prepacked_int4:
            raise ValueError(
                "scales= is only meaningful with pre-quantized int8 "
                "or pre-packed int4 embeddings")
        if mesh is not None and device is not None:
            raise ValueError("device= and mesh= are exclusive: a mesh "
                             "handle lives on the mesh's devices")
        self.config = cfg
        self.mesh = mesh
        self.storage = storage
        self.n, self.dim = c.shape
        if prepacked_int4:
            self.dim = int(dim)
        # Stored rows (and int8 / int4 scales) are allocated at _cap rows.
        self._cap = (self.n if capacity is None
                     else max(int(capacity), self.n))
        self.dtype = (_F32 if storage != "f32" or _is_f32(c.dtype)
                      else _F64)
        self.device = (mesh.home if mesh is not None
                       else resolve_device(device, c))
        # Rows a chunk of ingestion or prep handles (its f32 temporaries
        # take about prep_chunk_bytes).
        self._chunk_rows = max(1, cfg.prep_chunk_bytes // (4 * self.dim))
        # int8 / int4: the (_cap,) f32 per-row dequant scale.
        self._scales: Optional[torch.Tensor] = None
        if mesh is not None:
            # A ShardedCorpus; every reserved row is usable (quantized
            # shards round their height up, so there may be more than
            # asked for).
            self._device = self._shard(c, scales, int8_in, capacity)
            if capacity is not None:
                self._cap = self._device.shape[0]
        elif storage == "f32":
            self._device = self._with_capacity(
                _to_torch(c, self.dtype, self.device))
        elif storage == "bf16":
            self._device = self._store_bf16(c)
        elif int8_in:
            self._device = self._with_capacity(_to_torch(c, None,
                                                         self.device))
            self._scales = self._with_capacity(
                _to_torch(scales, _F32, self.device), fill=1.0)
        else:
            self._device, self._scales = self._quantize(c)
        # A caller's tensor or NumPy array held as it is: copied before
        # the first write (shards are always copies).
        self._borrowed = mesh is None and any(
            _holds(y, x) for x, y in ((c, self._device),
                                      (scales, self._scales)))
        # Dequantized f32 rows of a bf16 / int8 / int4 corpus, built only
        # for matmul and the reference path (k > max_fused_k,
        # use_pallas=False): the f32 bytes, once.
        self._f32_view: Optional[torch.Tensor] = None
        # Tombstoned rows (delete, or a loaded file's): excluded from
        # every topk through the mask path.
        self._tombstones: Optional[np.ndarray] = None
        self._alive: Optional[torch.Tensor] = None
        # (metric, kernel precision) -> (cp, cbp) on the device, _cap rows.
        self._prepared = {}

    def _with_capacity(self, t: torch.Tensor, fill: float = 0.0
                       ) -> torch.Tensor:
        """``t`` on the device in a buffer of ``_cap`` rows, ``fill``
        past its own (copied from where ``t`` lies, so that a host
        tensor goes straight into the device buffer)."""
        if t.shape[0] == self._cap:
            return t.to(self.device)
        out = torch.full((self._cap,) + tuple(t.shape[1:]), fill,
                         dtype=t.dtype, device=self.device)
        out[: t.shape[0]].copy_(t)
        return out

    def _shard(self, c: ArrayLike, scales, int8_in: bool,
               capacity: Optional[int]):
        """The stored rows as a ShardedCorpus over ``self.mesh``: float
        rows quantized or rounded where they lie (NumPy on the host, so
        that only the tier's bytes are uploaded, a shard at a time; a
        tensor on its own device), then split."""
        if self.storage in ("int8", "int4"):
            if not int8_in:
                where = (c.device if isinstance(c, torch.Tensor)
                         else torch.device("cpu"))
                c, scales = quantize_stored(c, self.storage, self.dim,
                                            where, self._chunk_rows)
            return shard_corpus(c, self.mesh, self.config, scales=scales,
                                storage=self.storage, dim=self.dim,
                                capacity=capacity)
        if isinstance(c, torch.Tensor):
            rows = c.to(torch.float32 if self.storage == "bf16"
                        else _torch_dtype(self.dtype))
        else:
            rows = np.asarray(c, dtype=_F32 if self.storage == "bf16"
                              else self.dtype)
        if self.storage == "bf16":
            rows = torch.as_tensor(rows).to(torch.bfloat16)
        return shard_corpus(rows, self.mesh, self.config, capacity=capacity)

    def _store_bf16(self, c: ArrayLike) -> torch.Tensor:
        """bf16 rows on the device, rounded from f32 (float64 input
        rounds to f32 first, as in the JAX package), in row chunks."""
        if isinstance(c, torch.Tensor) and c.dtype == torch.bfloat16:
            return self._with_capacity(c)
        out = torch.zeros((self._cap, self.dim), dtype=torch.bfloat16,
                          device=self.device)
        for r0 in range(0, self.n, self._chunk_rows):
            r1 = min(self.n, r0 + self._chunk_rows)
            out[r0:r1].copy_(_row_block(c, r0, r1).to(torch.float32)
                             .to(torch.bfloat16))
        return out

    def _quantize(self, c: ArrayLike):
        """(codes, scales) on the device from float rows, at ``_cap``
        rows (see ``quantize_stored``)."""
        codes, scales = quantize_stored(c, self.storage, self.dim,
                                        self.device, self._chunk_rows,
                                        rows=self._cap)
        return (self._with_capacity(torch.as_tensor(codes)),
                self._with_capacity(torch.as_tensor(scales), fill=1.0))

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        extras = []
        if self._cap > self.n:
            extras.append(f"capacity={self._cap}")
        if self.deleted_count:
            extras.append(f"deleted={self.deleted_count}")
        extra = (", " + ", ".join(extras)) if extras else ""
        where = ("mesh" if self.mesh is not None
                 else f"device={str(self.device)!r}")
        return (f"Corpus({self.n}x{self.dim}, storage={self.storage!r}, "
                f"{where}{extra})")

    # -- mutation ---------------------------------------------------------
    def _apply_row_mutation(self, r: ArrayLike, pos) -> None:
        """Write rows ``r`` at ``pos`` (a slice for add, a device index
        tensor for update) into the stored buffer and every cached
        prepared form, in place.  The prep is row-wise, so preparing only
        the new rows is exact.  A prepared form whose cp is the storage
        itself (codes; rows a prep keeps as stored) takes only its bias
        rows: a prepared row written there would corrupt the corpus.  A
        caller's tensor held as the storage is copied first."""
        if self._borrowed:
            self._device = self._device.clone()
            if self._scales is not None:
                self._scales = self._scales.clone()
            self._prepared.clear()
            self._borrowed = False
        scales = None
        if self.storage in ("int8", "int4"):
            codes, scales = quantize_stored(r, self.storage, self.dim,
                                            self.device, self._chunk_rows)
            src = torch.as_tensor(codes).to(self.device)
            scales = torch.as_tensor(scales).to(self.device)
            self._device[pos] = src
            self._scales[pos] = scales
        else:
            rows32 = _to_torch(r, _F32, self.device)
            if self.dtype == _F64:
                # float64 handles take the rows at full precision (and
                # stay on the reference path: they have no prepared forms).
                stored = _to_torch(r, _F64, self.device)
            else:
                stored = rows32.to(self._device.dtype)
            self._device[pos] = stored
            # bf16: prepare from the stored (rounded) rows, so that a write
            # and a later prep from storage score the same bits.
            src = stored if self.storage == "bf16" else rows32
        self._f32_view = None
        for (metric, precision), (cp, cbp) in self._prepared.items():
            cpc, cbc = prepare_corpus(src, metric, precision=precision,
                                      scales=scales)
            if cp.data_ptr() != self._device.data_ptr():
                cp[pos] = cpc
            cbp[..., pos] = cbc

    def add(self, rows: ArrayLike) -> int:
        """Append rows; returns the new row count (ids ``n..n+m-1``).

        Within capacity the rows are written in place into the stored
        buffer and every cached prepared form (no buffer is reallocated).
        Past capacity the capacity doubles (``max(2 * cap, new_n)``): the
        buffers are reallocated and the prepared forms rebuild lazily.

        A mesh handle adds only when built with ``capacity=``, and never
        past it: the rows are scattered into the shards that own the next
        global positions, in place."""
        if self.mesh is not None and not self._device.has_capacity:
            raise ValueError(
                "add() on a mesh-sharded Corpus requires the handle to "
                "be built with capacity= (reserved rows are what make "
                "sharded growth an in-place scatter)"
            )
        r = _as_input(rows)
        _check_width(r, self.dim)
        m = r.shape[0]
        if m == 0:
            return self.n
        new_n = self.n + m
        if self.mesh is not None:
            if new_n > self._cap:
                raise ValueError(
                    f"add() exceeds the mesh handle's capacity "
                    f"({self.n} + {m} > {self._cap}); rebuild (or "
                    f"save/load) with a larger capacity="
                )
            self._device.scatter(np.arange(self.n, new_n), r, self.config)
            self._device.n_true = new_n
        else:
            if new_n > self._cap:
                self._cap = max(2 * self._cap, new_n)
                self._device = self._with_capacity(self._device[: self.n])
                if self._scales is not None:
                    self._scales = self._with_capacity(
                        self._scales[: self.n], fill=1.0)
                self._prepared.clear()
                self._f32_view = None
            self._apply_row_mutation(r, slice(self.n, new_n))
        if self._tombstones is not None:
            self._tombstones = np.concatenate(
                [self._tombstones, np.zeros(m, dtype=bool)])
            self._alive = None
        self.n = new_n
        return new_n

    def update(self, indices, rows: ArrayLike) -> None:
        """Overwrite rows in place by id (upsert): the stored buffer and
        every cached prepared form.  Ids must be integers, unique and in
        [0, n).  Updating a tombstoned row revives it."""
        idx = _host_ids(indices)
        r = _as_input(rows)
        _check_width(r, self.dim)
        if idx.size != r.shape[0]:
            raise ValueError(
                f"got {idx.size} indices for {r.shape[0]} rows")
        if idx.size == 0:
            return
        if not np.issubdtype(idx.dtype, np.integer):
            raise ValueError(
                f"update indices must be integers, got dtype {idx.dtype}")
        if idx.min() < 0 or idx.max() >= self.n:
            raise ValueError(
                f"update indices must be in [0, {self.n}); got "
                f"[{idx.min()}, {idx.max()}]")
        if _repeats(idx):
            raise ValueError("update indices must be unique")
        if self.mesh is not None:
            self._device.scatter(idx.astype(np.int64), r, self.config)
        else:
            pos = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            self._apply_row_mutation(r, pos)
        if self._tombstones is not None and self._tombstones[idx].any():
            self._tombstones[idx] = False
            self._alive = None

    def delete(self, indices) -> int:
        """Tombstone rows by id: they never match again (topk only;
        ``matmul`` still scores them).  The stored rows and prepared forms
        are untouched.  Returns the total number of tombstoned rows."""
        idx = _host_ids(indices)
        if idx.size and not np.issubdtype(idx.dtype, np.integer):
            raise ValueError(
                f"delete indices must be integers, got dtype {idx.dtype}")
        if idx.size and (idx.min() < 0 or idx.max() >= self.n):
            raise ValueError(
                f"delete indices must be in [0, {self.n}); got "
                f"[{idx.min()}, {idx.max()}]")
        if self._tombstones is None:
            self._tombstones = np.zeros(self.n, dtype=bool)
        self._tombstones[idx] = True
        self._alive = None
        return int(self._tombstones.sum())

    @property
    def deleted_count(self) -> int:
        return 0 if self._tombstones is None else int(self._tombstones.sum())

    def _effective_precision(self) -> str:
        """The kernel core this handle runs: a quantized tier always runs
        its own ("bf16c", "int8c", "int4c"), whatever the config says (the
        values are quantized at rest; another core could only spend
        memory); f32 runs the config's precision."""
        tier = {"bf16": "bf16c", "int8": "int8c", "int4": "int4c"}
        return tier.get(self.storage, kernel_precision(self.config.precision))

    def _dense_device(self) -> torch.Tensor:
        """(n, dim) rows in the compute dtype for matmul and the reference
        path: the f32 corpus itself, else a cached dequantized f32 view
        (the capacity rows left out)."""
        rows = self._device[: self.n]
        if self.storage == "f32":
            return rows
        if self._f32_view is None:
            if self.storage == "int8":
                dense = (rows.to(torch.float32)
                         * self._scales[: self.n, None])
            elif self.storage == "int4":
                dense = dequant_int4(rows, self._scales[: self.n], self.dim)
            else:
                dense = rows.to(torch.float32)
            self._f32_view = dense
        return self._f32_view

    def _prepared_for(self, metric: Metric):
        """Cached (cp, cbp) of ``prepare_stored`` for this metric and the
        handle's core, over all ``_cap`` stored rows.  The capacity rows
        get bias -inf in the last cbp row (a quantized core's scale row
        above it stays finite: 0 * -inf would be NaN)."""
        precision = self._effective_precision()
        key = (metric.value, precision)
        if key not in self._prepared:
            cp, cbp = prepare_stored(self._device, self._scales, metric,
                                     precision, self._chunk_rows)
            if cbp.shape[-1] > self.n:
                (cbp[-1] if cbp.ndim == 2 else cbp)[self.n:] = float("-inf")
            self._prepared[key] = (cp, cbp)
        return self._prepared[key]

    def _combined_mask(self, user_mk) -> Optional[torch.Tensor]:
        mk = _mask_on(user_mk, self.device)
        if self._tombstones is None:
            return mk
        if self._alive is None:
            self._alive = torch.from_numpy(~self._tombstones).to(self.device)
        return self._alive if mk is None else (mk & self._alive)

    def topk(self, queries: ArrayLike, k: int,
             metric: Union[str, Metric] = "cosine", *, mask=None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k against the resident corpus; same outputs as ``topk``.
        Half-precision queries (float16, bfloat16) upload as they are and
        run the float32 path."""
        metric = Metric.parse(metric)
        q = _as_input(queries)
        if q.shape[0] == 0:
            return np.empty((0, 0), np.uint32), np.empty((0, 0), np.float64)
        _check_width(q, self.dim)
        user_mk = _validate_mask(mask, self.n)
        kk = min(int(k), self.n)
        if kk <= 0:
            return _empty_topk(q.shape[0])
        half_q = _is_half(q.dtype)
        dt = _F32 if half_q else compute_dtype(q.dtype, self.dtype)
        cfg = self.config
        mk = self._combined_mask(user_mk)
        if self.mesh is not None:
            with annotate(f"pmm.topk.{metric.value}"):
                vals, idx = distributed_topk(
                    _to_torch(q, dt, self.device), self._device, kk, metric,
                    self.mesh, cfg, mask=mk)
                return _to_host(vals, idx)
        sup = supports(q.shape, (self.n, self.dim), dt, kk, cfg)
        if (not sup and self.storage != "f32" and dt == _F32
                and kk <= max_fused_k(cfg)):
            # Quantized storage above max_fused_dim stays on the kernel:
            # the reference path would build (and cache) the dense f32
            # rows, the bytes the tier exists to save.
            sup = True
        with annotate(f"pmm.topk.{metric.value}"):
            if cfg.use_pallas and dt == _F32 and self.dtype == _F32 and sup:
                qt = _to_torch(q, None if half_q else dt, self.device)
                cp, cbp = self._prepared_for(metric)
                vals, idx = fused_topk_prepared(
                    qt, cp, cbp, kk, metric, mask=mk, config=cfg,
                    precision=self._effective_precision())
            else:
                ct = self._dense_device().to(_torch_dtype(dt))
                vals, idx = fused_topk(_to_torch(q, dt, self.device), ct, kk,
                                       metric, mask=mk, config=cfg)
            return _to_host(vals, idx)

    def matmul(self, queries: ArrayLike) -> np.ndarray:
        """Q . C^T against the stored rows (dequantized for bf16 / int8 /
        int4), in the compute dtype."""
        q = _as_input(queries)
        if q.shape[0] == 0:
            return np.empty((0, self.n), dtype=compute_dtype(q.dtype,
                                                             self.dtype))
        _check_width(q, self.dim)
        dt = compute_dtype(q.dtype, self.dtype)
        if self.mesh is not None:
            with annotate("pmm.matmul"):
                out = distributed_matmul(_to_torch(q, dt, self.device),
                                         self._device, self.mesh,
                                         self.config)
            return out.cpu().numpy()
        with annotate("pmm.matmul"):
            out = pairwise_matmul(_to_torch(q, dt, self.device),
                                  self._dense_device().to(_torch_dtype(dt)),
                                  precision=self.config.precision)
        return out.cpu().numpy()

    def save(self, path) -> None:
        """Persist to ``path`` (.npz) in the JAX package's format, which its
        ``Corpus.load`` reads back: the tier's own bytes of the n rows
        (bf16 as ``data_u16`` bits, int8 codes or packed int4 with
        ``scales``) and the tombstones.  Capacity is not saved: pass
        ``capacity=`` again to ``load``.  A mesh handle gathers its shards
        (every rank takes part); the file loads on one device or on a
        mesh."""
        if self.mesh is not None:
            data, scales = self._device.gather(self.mesh, "cpu")
            data = data[: self.n]
        else:
            data = self._device[: self.n].cpu()
            scales = self._scales
        arrays = {"n": np.int64(self.n), "dim": np.int64(self.dim),
                  "storage": np.array(self.storage)}
        if self.storage == "bf16":
            arrays["data_u16"] = data.view(torch.int16).numpy().view(
                np.uint16)
        else:
            arrays["data"] = data.numpy()
        if scales is not None:
            arrays["scales"] = scales[: self.n].cpu().numpy()
        if self._tombstones is not None:
            arrays["tombstones"] = self._tombstones
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def from_arrow(cls, column, **kwargs) -> "Corpus":
        """A resident corpus straight from an Arrow (or polars) embedding
        column, or from its buffers (an ``interop.buffers.EmbeddingColumn``,
        no ``pyarrow`` needed): a FixedSizeList of float32 with no nulls
        is held without a copy, every other column is packed, nulls as
        0.0.  Takes the constructor's keywords (``storage=``,
        ``capacity=``, ``config=``, ``device=``, ...).  The handle then
        serves ``topk_arrow`` / ``matmul_arrow`` and ``.pmm``."""
        from ..interop.arrow import extract_embedding_column

        return cls(extract_embedding_column(column), **kwargs)

    @classmethod
    def load(cls, path, *, mesh=None, capacity: Optional[int] = None,
             config: Optional[SearchConfig] = None,
             device: DeviceLike = None) -> "Corpus":
        """Rebuild a corpus saved by either package's ``Corpus.save``, from
        its stored bytes (codes are not quantized again); ``mesh=``
        shards it."""
        with np.load(path, allow_pickle=False) as z:
            storage = str(z["storage"])
            if storage == "bf16":
                data = torch.from_numpy(
                    z["data_u16"].view(np.int16)).view(torch.bfloat16)
            else:
                data = z["data"]
            scales = z["scales"] if "scales" in z else None
            tomb = z["tombstones"] if "tombstones" in z else None
            dim4 = int(z["dim"]) if storage == "int4" else None
        # NumPy's default device, also for the bf16 bits read as a tensor.
        obj = cls(data, mesh=mesh, storage=storage, scales=scales, dim=dim4,
                  capacity=capacity, config=config,
                  device=device if mesh is not None
                  else resolve_device(device))
        if tomb is not None and tomb.any():
            obj._tombstones = tomb.astype(bool)
        return obj
