"""Tracing helpers (port of ``annotate`` and ``call_stats`` from
``polars_matmul_tpu.utils.profiling``).

- ``annotate``: a ``torch.profiler.record_function`` range around a phase,
  so it shows in a ``torch.profiler`` trace; with ``PMM_TPU_DEBUG=1`` it
  also logs the host time of the phase.
- ``call_stats``: one JSON line per call on the package logger, behind the
  same debug flag.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Optional

import torch

log = logging.getLogger("polars_matmul_tpu_torch")
_DEBUG = os.environ.get("PMM_TPU_DEBUG", "0") == "1"


@contextlib.contextmanager
def annotate(name: str):
    """Profiler range + optional debug timing (host clock)."""
    t0 = time.perf_counter() if _DEBUG else 0.0
    with torch.profiler.record_function(name):
        yield
    if _DEBUG:
        log.info("%s: %.3f ms", name, (time.perf_counter() - t0) * 1e3)


def call_stats(op: str, *, m: int, n: int, dim: int, k: Optional[int] = None,
               dtype=None, wall_s: Optional[float] = None) -> None:
    """Shapes, dtype, transfer bytes and host wall time of one call."""
    if not _DEBUG:
        return
    itemsize = 4 if str(dtype) in ("float32", "torch.float32") else 8
    rec = {
        "op": op,
        "m": m,
        "n": n,
        "dim": dim,
        "dtype": str(dtype),
        "bytes_h2d": m * dim * itemsize,
        "bytes_d2h": (m * k * (itemsize + 4) if k is not None
                      else m * n * itemsize),
    }
    if k is not None:
        rec["k"] = k
    if wall_s:
        rec["wall_ms"] = round(wall_s * 1e3, 3)
        rec["wall_gflops"] = round(2.0 * m * n * dim / wall_s / 1e9, 1)
    log.info(json.dumps(rec))
