"""The JAX package's attribution experiments, on the H100.

The JAX package's ``tools/exp_floor.py``, ``tools/exp_b256.py`` and
``tools/exp_int4.py`` split the cost of its fused kernel into the product
and epilogue, each level of a packed stack selection, the posu raw-bit
build and each int4 unpack.  Here each experiment drives kernel D
(``kernels/floor.py``), which runs kernel A's own staging and products,
beside kernels A and B at the same shapes:

    python -m polars_matmul_tpu_torch.tools.exp_floor --out build/floors.json
    python -m polars_matmul_tpu_torch.tools.exp_b256
    python -m polars_matmul_tpu_torch.tools.exp_int4

Each prints one JSON line a stage and returns its results from
``main(device="cuda", ...)``; ``device="cpu"`` runs the plain versions
(host-clock times, which say nothing about the card).  Times come from
CUDA events (``utils.profiling.benchmark``) around batches of calls.
Corpora are made on the device from a seed, in row chunks.
"""

from __future__ import annotations

import json
import subprocess
from typing import Callable, Dict

import torch

from ..kernels import floor as D
from ..kernels import fused_topk as F
from ..utils.profiling import benchmark


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    device type off the card)."""
    if device.type != "cuda":
        return device.type
    smi = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip()


# Calls of the timed function between one pair of CUDA events: a call
# enqueues in tens of microseconds of Python, so one call alone would time
# the host too wherever the card finishes first (the canonical shapes).
BATCH = 8


def median_ms(fn: Callable, iters: int) -> float:
    """Median time of one ``fn()`` in ms over ``iters`` batches of BATCH
    calls: CUDA events on the card, the host clock elsewhere."""
    return benchmark(lambda: [fn() for _ in range(BATCH)], warmup=2,
                     iters=iters)["median_ms"] / BATCH


def emit(record: Dict) -> None:
    print(json.dumps(record), flush=True)


def kernel_a_ms(qp: torch.Tensor, cp: torch.Tensor, cb: torch.Tensor,
                k: int, core: str, iters: int) -> float:
    """Kernel A alone (``fused_topk_partial``) on kernel D's operands of
    ``core`` (an int4 decode of kernel D reads as "int4c"), at its own
    geometry for k: on the card at its occupancy, elsewhere on the
    notional card of ``kernels.floor``."""
    core = "int4c" if core in D._INT4 else core
    bias = cb[0] if core == "bf16x3" else cb
    m, n = qp.shape[0], cp.shape[0]
    if qp.is_cuda:
        tm, splits, tps = F.kernel_geometry(m, n, k, core, qp.device,
                                            dim=qp.shape[1] // 2)
    else:
        tm, splits, tps = F.launch_geometry(m, n, k, D._NOTIONAL_SMS)
    return median_ms(lambda: F.fused_topk_partial(
        qp, cp, bias, None, k, core, splits, tps, tm), iters)
