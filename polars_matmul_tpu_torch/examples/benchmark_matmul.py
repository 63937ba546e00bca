"""Raw pairwise-matmul benchmark sweep vs NumPy.

The port of the JAX package's ``examples/benchmark_matmul.py``: all
pairwise dot products at 1000 x 10,000 x 256, f32 and f64, from NumPy
matrices, from a FixedSizeList column (a view of its buffer) and from a
List column (packed on the host), then the flat output layout, and a
spot check against NumPy.  The columns are ``pyarrow`` arrays where
pyarrow imports (``matmul_arrow``), else the same columns by their Arrow
buffers (``api.arrow_ops.matmul_buffers``, no pyarrow needed); the script
prints which.  The data are the JAX script's NumPy draws from seed 42.

    python -m polars_matmul_tpu_torch.examples.benchmark_matmul [--cpu]
        [--shape 1000 10000 256]

Times: NumPy's on the host; each port call's host time (NumPy or columns
in, NumPy or buffers out); and the product's device time on card tensors
(``matmul_torch``, CUDA events around batches of calls).
"""

from __future__ import annotations

import numpy as np
import torch

import polars_matmul_tpu_torch as pmt
from polars_matmul_tpu_torch.api.arrow_ops import matmul_buffers
from polars_matmul_tpu_torch.interop import buffers as B

from ._common import (CPU, card, check, event_ms, fmt, host_ms, parser,
                      pick_device)

SHAPE = (1000, 10_000, 256)


def list_column(x: np.ndarray) -> B.EmbeddingColumn:
    """A List column over the rows of ``x`` (int32 offsets)."""
    n, dim = x.shape
    return B.EmbeddingColumn(
        length=n, values=np.ascontiguousarray(x).reshape(-1),
        offsets=np.arange(0, n * dim + 1, dim, dtype=np.int32))


class Columns:
    """The script's columns and product calls: pyarrow arrays where it
    imports, else their buffers."""

    def __init__(self, device, buffers: bool = False):
        self.device = device
        self.pa = None
        if not buffers:
            try:
                import pyarrow
            except ImportError:
                pass
            else:
                self.pa = pyarrow
        self.name = "pyarrow" if self.pa else "buffers"

    def fixed(self, x):
        if self.pa is None:
            return B.matrix_column(np.ascontiguousarray(x))
        return self.pa.FixedSizeListArray.from_arrays(
            self.pa.array(x.reshape(-1)), x.shape[1])

    def ragged(self, x):
        if self.pa is None:
            return list_column(x)
        return self.pa.array(x.tolist(),
                             type=self.pa.list_(self.pa.from_numpy_dtype(
                                 x.dtype)))

    def matmul(self, q, c, flatten=False):
        if self.pa is None:
            return matmul_buffers(q, c, flatten=flatten, device=self.device)
        return pmt.matmul_arrow(q, c, flatten=flatten, device=self.device)


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--shape", type=int, nargs=3, default=list(SHAPE),
                    metavar=("QUERIES", "CORPUS", "DIM"))
    ap.add_argument("--buffers", action="store_true",
                    help="the buffer layer even where pyarrow imports")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    cols = Columns(device, args.buffers)
    print(f"device: {device.type} ({card(device)}); columns as "
          f"{cols.name}")
    rng = np.random.default_rng(42)
    n_q, n_c, dim = args.shape
    rows = {}

    def line(name, t_np, t_host, t_dev=None):
        rows[name] = {"numpy_ms": t_np, "host_ms": t_host, "device_ms": t_dev}
        ratio = "" if t_np is None else f"{t_host / t_np:6.2f}x"
        print(f"{name:<40} {fmt(t_np, 10, 1)} {fmt(t_host, 10, 1)} "
              f"{fmt(t_dev)} {ratio}")

    print(f"{'case':<40} {'numpy':>10} {'host':>10} {'device':>9} "
          f"{'ratio':>7}")
    for dtype in (np.float32, np.float64):
        q = rng.standard_normal((n_q, dim)).astype(dtype)
        c = rng.standard_normal((n_c, dim)).astype(dtype)
        t_np = host_ms(lambda: q @ c.T, CPU)

        # NumPy-matrix API; the device time of the product alone
        t_mm = host_ms(lambda: pmt.matmul(q, c, device=device), device)
        qt, ct = (torch.from_numpy(x).to(device) for x in (q, c))
        t_dev = event_ms(lambda: pmt.matmul_torch(qt, ct), device)
        line(f"matmul {dtype.__name__} (ndarray)", t_np, t_mm, t_dev)

        # FixedSizeList (its buffer is the matrix: no copy)
        qa, ca = cols.fixed(q), cols.fixed(c)
        line(f"matmul {dtype.__name__} (FixedSizeList)", t_np,
             host_ms(lambda: cols.matmul(qa, ca), device))

        # ragged List (the pack path)
        ql, cl = cols.ragged(q), cols.ragged(c)
        line(f"matmul {dtype.__name__} (List)", t_np,
             host_ms(lambda: cols.matmul(ql, cl), device))
        del qt, ct

    # flatten mode
    q32 = rng.standard_normal((n_q, dim)).astype(np.float32)
    c32 = rng.standard_normal((n_c, dim)).astype(np.float32)
    qa, ca = cols.fixed(q32), cols.fixed(c32)
    line("matmul f32 flatten=True", None,
         host_ms(lambda: cols.matmul(qa, ca, flatten=True), device))

    # correctness spot-check
    out = pmt.matmul(q32[:8], c32[:16], device=device)
    ref = q32[:8] @ c32[:16].T
    check(np.allclose(out, ref, rtol=1e-5, atol=1e-5),
          f"matmul differs from NumPy by "
          f"{float(np.max(np.abs(out - ref))):.3g}")
    flat = cols.matmul(qa, ca, flatten=True)
    values = flat.values if cols.pa is None else flat.to_numpy()
    check(values.shape == (n_q * n_c,) and np.allclose(
        values[:n_c], q32[0] @ c32.T, rtol=1e-4, atol=1e-4),
        "the flat layout's first row differs from NumPy")
    print("correctness: verified vs NumPy")
    return {"device": device.type, "columns": cols.name, "cases": rows}


if __name__ == "__main__":
    main()
