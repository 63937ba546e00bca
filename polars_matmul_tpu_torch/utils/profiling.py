"""Tracing and timing helpers (port of ``polars_matmul_tpu.utils.profiling``).

- ``annotate``: a ``torch.profiler.record_function`` range around a phase,
  so it shows in a ``torch.profiler`` trace; with ``PMM_TPU_DEBUG=1`` it
  also logs the host time of the phase.
- ``block`` and ``benchmark``: wait for the card, and time a function:
  CUDA events when it runs on the card, the host clock on the CPU;
  ``graph_ms``: its device time alone, from a CUDA graph of many calls.
- ``device_peak_tflops``, ``device_hbm_bytes_per_s`` and ``roofline``:
  achieved GFLOP/s against the card's published peak (NVIDIA's H100 SXM
  data sheet; other cards report no peak).
- ``call_stats``: one JSON line per call on the package logger, behind the
  same debug flag.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import statistics
import time
from typing import Callable, Dict, Optional

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


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in ``x`` (nested tuples, lists and
    dict values)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for item in x:
            _cuda_devices(item, out)
    elif isinstance(x, dict):
        for item in x.values():
            _cuda_devices(item, out)
    return out


def block(x):
    """Wait until the card has finished the work behind ``x``: a
    ``torch.cuda.synchronize`` of each CUDA device its tensors lie on
    (nested tuples, lists and dicts too); a no-op on the CPU.  Returns
    ``x``."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)
    return x


def benchmark(fn: Callable, *args, warmup: int = 2, iters: int = 10,
              **kw) -> Dict[str, float]:
    """Time ``fn(*args, **kw)``: min, median and mean in ms over ``iters``
    calls after ``warmup``.  When its arguments or its result lie on the
    card, each call is timed by CUDA events on the current stream (so the
    time is the card's, enqueue gaps included); otherwise by the host
    clock.  The first call always runs, as a warmup."""
    out = None
    for _ in range(max(1, warmup)):
        out = block(fn(*args, **kw))
    devices = _cuda_devices((args, kw, out), set())
    times = []
    for _ in range(iters):
        if devices:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kw)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            block(fn(*args, **kw))
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return {
        "min_ms": times[0],
        "median_ms": statistics.median(times),
        "mean_ms": sum(times) / len(times),
        "iters": float(iters),
    }


def graph_ms(fn: Callable, calls: int = 20, iters: int = 5) -> float:
    """Device time of one ``fn()`` in ms without the host's enqueue:
    ``calls`` calls captured in one CUDA graph, replayed ``iters`` times
    between CUDA events; the median replay over ``calls`` (the gaps
    between the graph's kernels count).  The card only: ``fn`` launches on
    the current stream, and everything it allocates comes from the
    graph's pool."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


# Published dense peaks, TFLOP/s, keyed by a lower-cased substring of
# ``torch.cuda.get_device_name()``, then dtype: NVIDIA's H100 SXM data
# sheet ("NVIDIA H100 80GB HBM3" is the SXM5 part), at its 700 W limit.
# Only for reporting; a card without an entry reports achieved GFLOP/s
# alone.  The JAX package's denominator policy: "bfloat16" is the
# tensor-core peak; "float32" is the ceiling of f32-accurate products
# through the bf16x3 split, three bf16 products per f32 one (bf16 peak /
# 3); "float32_cuda_cores" is f32 FMA outside the tensor cores (the
# "highest" cores).
_PEAK_TFLOPS = {
    "h100 80gb hbm3": {"bfloat16": 989.0, "float32": 989.0 / 3,
                       "float32_cuda_cores": 67.0},
}
# Published device-memory bandwidth, bytes/s (the same data sheet).
_HBM_BYTES_PER_S = {"h100 80gb hbm3": 3.35e12}


def device_name(device=None) -> Optional[str]:
    """``torch.cuda.get_device_name(device)``, or None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device)


def _by_name(table: dict, device):
    """The entry of ``table`` whose key is in the card's name, or None."""
    name = (device_name(device) or "").lower()
    return next((v for sub, v in table.items() if sub in name), None)


def device_peak_tflops(dtype: str = "float32",
                       device=None) -> Optional[float]:
    """The card's published peak for ``dtype`` ("bfloat16", "float32",
    "float32_cuda_cores"), TFLOP/s, or None for an unknown card."""
    return (_by_name(_PEAK_TFLOPS, device) or {}).get(dtype)


def device_hbm_bytes_per_s(device=None) -> Optional[float]:
    """The card's published device-memory bandwidth, or None."""
    return _by_name(_HBM_BYTES_PER_S, device)


def roofline(flops: float, seconds: float, dtype: str = "float32",
             device=None) -> Dict:
    """Achieved GFLOP/s and, on a card with a published peak, that peak
    and the fraction of it reached."""
    gflops = flops / seconds / 1e9
    peak = device_peak_tflops(dtype, device)
    out = {"achieved_gflops": gflops}
    if peak:
        out["peak_tflops"] = peak
        out["fraction_of_peak"] = gflops / (peak * 1e3)
    return out


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
