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
from ..kernels.fused_topk import (fused_topk, fused_topk_prepared,
                                  kernel_precision, prepare_corpus, supports)
from ..kernels.matmul import pairwise_matmul
from ..ops.metrics import Metric
from ..utils.profiling import annotate, call_stats

ArrayLike = Union[np.ndarray, torch.Tensor]
DeviceLike = Union[str, torch.device, None]

_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)
_HALF_TORCH = (torch.float16, torch.bfloat16)


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to polars_matmul_tpu_torch yet "
        f"(ROADMAP.md queue 1, item {item})")


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
    rows carry sentinel scores (-inf similarity / +inf distance).
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


class Corpus:
    """Device-resident corpus handle: the corpus is uploaded and prepared
    once, and each ``topk`` / ``matmul`` call only moves the queries.

    This port holds ``storage="f32"`` on one device.  Other storage tiers,
    ``mesh=``, ``capacity=``, ``add``, ``update`` and ``delete`` raise
    ``NotImplementedError`` naming the ROADMAP item that ports them.
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
        if storage != "f32":
            raise _not_ported(f"storage={storage!r}", 2)
        if c.dtype in (np.int8, torch.int8):
            raise ValueError(
                "int8 embeddings (pre-quantized codes) require "
                "storage='int8' (or storage='int4' for nibble-packed "
                "codes with dim=)")
        if dim is not None:
            raise ValueError("dim= is only meaningful with pre-packed int4 "
                             "codes")
        if scales is not None:
            raise ValueError(
                "scales= is only meaningful with pre-quantized int8 "
                "or pre-packed int4 embeddings")
        if mesh is not None:
            raise _not_ported("Corpus(mesh=...)", 6)
        if capacity is not None:
            raise _not_ported("Corpus(capacity=...)", 3)
        self.config = cfg
        self.storage = storage
        self.n, self.dim = c.shape
        self.dtype = _F32 if _is_f32(c.dtype) else _F64
        self.device = resolve_device(device, c)
        self._device = _to_torch(c, self.dtype, self.device)
        # Rows deleted in a corpus saved by the JAX package (Corpus.load):
        # excluded from every topk through the mask path.
        self._tombstones: Optional[np.ndarray] = None
        self._alive: Optional[torch.Tensor] = None
        # (metric, kernel precision) -> (cp, cbp) on the device.
        self._prepared = {}

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return (f"Corpus({self.n}x{self.dim}, storage={self.storage!r}, "
                f"device={str(self.device)!r})")

    def add(self, rows) -> int:
        raise _not_ported("Corpus.add", 3)

    def update(self, indices, rows) -> None:
        raise _not_ported("Corpus.update", 3)

    def delete(self, indices) -> int:
        raise _not_ported("Corpus.delete", 3)

    def _prepared_for(self, metric: Metric):
        precision = kernel_precision(self.config.precision)
        key = (metric.value, precision)
        if key not in self._prepared:
            self._prepared[key] = prepare_corpus(self._device, metric,
                                                 precision=precision)
        return self._prepared[key]

    def _combined_mask(self, user_mk) -> Optional[torch.Tensor]:
        mk = _mask_on(user_mk, self.device)
        if self._tombstones is None:
            return mk
        if self._alive is None:
            self._alive = torch.from_numpy(~self._tombstones).to(self.device)
        return self._alive if mk is None else (mk & self._alive)

    def _check_queries(self, q) -> None:
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"Dimension mismatch: left has "
                f"{q.shape[1] if q.ndim == 2 else tuple(q.shape)} "
                f"dimensional vectors, right has {self.dim} dimensional "
                f"vectors"
            )

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
        self._check_queries(q)
        user_mk = _validate_mask(mask, self.n)
        kk = min(int(k), self.n)
        if kk <= 0:
            return _empty_topk(q.shape[0])
        half_q = _is_half(q.dtype)
        dt = _F32 if half_q else compute_dtype(q.dtype, self.dtype)
        cfg = self.config
        mk = self._combined_mask(user_mk)
        with annotate(f"pmm.topk.{metric.value}"):
            if (cfg.use_pallas and dt == _F32 and self.dtype == _F32
                    and supports(q.shape, (self.n, self.dim), dt, kk, cfg)):
                qt = _to_torch(q, None if half_q else dt, self.device)
                cp, cbp = self._prepared_for(metric)
                vals, idx = fused_topk_prepared(qt, cp, cbp, kk, metric,
                                                mask=mk, config=cfg)
            else:
                ct = self._device.to(_torch_dtype(dt))
                vals, idx = fused_topk(_to_torch(q, dt, self.device), ct, kk,
                                       metric, mask=mk, config=cfg)
            return _to_host(vals, idx)

    def matmul(self, queries: ArrayLike) -> np.ndarray:
        q = _as_input(queries)
        if q.shape[0] == 0:
            return np.empty((0, self.n), dtype=compute_dtype(q.dtype,
                                                             self.dtype))
        self._check_queries(q)
        dt = compute_dtype(q.dtype, self.dtype)
        with annotate("pmm.matmul"):
            out = pairwise_matmul(_to_torch(q, dt, self.device),
                                  self._device.to(_torch_dtype(dt)),
                                  precision=self.config.precision)
        return out.cpu().numpy()

    def save(self, path) -> None:
        """Persist to ``path`` (.npz) in the JAX package's format, which its
        ``Corpus.load`` reads back."""
        arrays = {"n": np.int64(self.n), "dim": np.int64(self.dim),
                  "storage": np.array(self.storage),
                  "data": self._device.cpu().numpy()}
        if self._tombstones is not None:
            arrays["tombstones"] = self._tombstones
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, path, *, mesh=None, capacity: Optional[int] = None,
             config: Optional[SearchConfig] = None,
             device: DeviceLike = None) -> "Corpus":
        """Rebuild a corpus saved by either package's ``Corpus.save``
        (storage "f32"; other tiers raise until they are ported)."""
        with np.load(path, allow_pickle=False) as z:
            storage = str(z["storage"])
            if storage != "f32":
                raise _not_ported(f"loading storage={storage!r}", 2)
            data = z["data"]
            tomb = z["tombstones"] if "tombstones" in z else None
        obj = cls(data, mesh=mesh, storage=storage, capacity=capacity,
                  config=config, device=device)
        if tomb is not None and tomb.any():
            obj._tombstones = tomb.astype(bool)
        return obj
