"""What the example scripts share: the device choice, the checks and the
timers."""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Optional

import torch

from ..utils.profiling import graph_ms

CPU = torch.device("cpu")


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the scripts' common ``--cpu``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap


def pick_device(cpu: bool) -> torch.device:
    """The CPU when asked, else the card; without one this raises rather
    than fall back to the CPU."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def check(cond: bool, msg: str) -> None:
    """A correctness check of a script: it fails the run, ``-O`` or not."""
    if not cond:
        raise AssertionError(msg)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn: Callable, device: torch.device, warmup: int = 2,
            iters: int = 5) -> float:
    """Median host time of one ``fn()`` in ms, the card drained before
    and after each call (a call that returns NumPy has its results on the
    host already)."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def event_ms(fn: Callable, device: torch.device, warmup: int = 2,
             iters: int = 5, batch: int = 8) -> Optional[float]:
    """Median time of one ``fn()`` in ms between CUDA events around
    batches of ``batch`` calls (the card's time, enqueue gaps included);
    None off the card."""
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / batch)
    return statistics.median(ts)


def device_ms(fn: Callable, device: torch.device, calls: int = 10
              ) -> Optional[float]:
    """Device time of one ``fn()`` in ms without the host's enqueue (a
    CUDA graph of ``calls`` calls, ``utils.profiling.graph_ms``); None off
    the card."""
    if device.type != "cuda":
        return None
    return graph_ms(fn, calls=calls)


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device type off the card."""
    from ..tools import card as tool_card

    return tool_card(device)


def fmt(ms: Optional[float], width: int = 9, digits: int = 3) -> str:
    """A time in ms, right-aligned in ``width`` columns with its unit, or
    n/a where it was not taken."""
    text = "n/a" if ms is None else f"{ms:.{digits}f}ms"
    return f"{text:>{width}s}"
