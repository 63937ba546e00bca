"""Kernel C on one card: a parent checkout's build against this tree's.

Builds the parent's ``polars_matmul_tpu_torch/kernels/csrc/matmul.cu``
alone with ``nvcc`` into a library of its own under ``build/``, loads it
with ``ctypes`` beside this tree's library, and times the parent's
``pmm_matmul`` and this tree's ``pallas_matmul`` on the same operands in
turns (parent, change, change, parent), each core at each shape, with
CUDA events around batches of calls (``tools.median_ms``); "kernel" is
this tree's library called as the parent's is, without the wrapper.
Below 10^8 outputs each is also timed in a CUDA graph of 20 calls
(``utils.profiling.graph_ms``: the device alone, no host enqueue), in
the same turns.  Beside each pair: the largest difference between the
two outputs, the plain version's time, ``torch.matmul`` in f32 with
TF32 off (the library yardstick), the bound, the change timed one call
at a time (an event pair and a sync around each call) and in batches
that free each output before the next call, the card's SM
clock and power draw while each side's batches ran (``nvidia-smi``
polled), the source's launch plan, and for the wgmma body the split and
the product alone.  One JSON line a (shape, core), the card's name and
power limit in each.

``--variants`` adds builds of this tree's ``matmul.cu`` with a line
patched (``VARIANTS``) to the turns: parent, change, each variant, then
the same in reverse.

    mkdir -p build/parent
    git archive <parent> polars_matmul_tpu_torch | tar -x -C build/parent
    python -m polars_matmul_tpu_torch.tools.ab_matmul --parent build/parent
    python -m polars_matmul_tpu_torch.tools.ab_matmul --parent build/parent \\
        --shapes 1x65536x768,64x65536x768 --variants wgmma-all,rows128
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import matmul as M
from ..kernels.fused_topk import _ptr
from ..ops.reference import exact_matmul
from ..utils import profiling as P
from . import BATCH, card, emit, median_ms

# The canonical shape of examples/benchmark_matmul.py:45 and a large one
# (a 2.15 GB output), as chip_smoke.py's MM_SHAPES.
SHAPES = ((1000, 10_000, 256), (8192, 65_536, 768))
BUILD = Path(__file__).resolve().parents[2] / "build"
# Builds of this tree's matmul.cu with a line changed: (pattern,
# replacement) pairs of re.subn, each of which must match once.
VARIANTS = {
    # The bf16x3 core's wgmma body at every m (no mma.sync body).
    "wgmma-all": [(r"constexpr int kMmaMaxM = \d+;",
                   "constexpr int kMmaMaxM = 0;")],
    # The highest core's 128-row tile at every m.
    "rows128": [(r"inline int f32_rows\(int m\) \{[^}]*\}",
                 "inline int f32_rows(int m) { return 128; }")],
}


def _nvcc(src: Path, so: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [_build.find_nvcc(), *_build._ARCH, *_build._FLAGS, "-shared", "-I",
         str(src.parent), "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(parent: Path, variants=()):
    """(loaded libraries, nvcc's output) by build: the parent's
    ``matmul.cu`` alone and each variant's patched copy of this tree's,
    every nvcc at once, under ``build/``."""
    BUILD.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ab-matmul-", dir=BUILD))
    srcs = {"parent": parent / "polars_matmul_tpu_torch" / "kernels"
            / "csrc" / "matmul.cu"}
    for name in variants:
        d = work / f"src-{name}"
        shutil.copytree(_build._CSRC, d)
        text = (d / "matmul.cu").read_text()
        for pattern, replacement in VARIANTS[name]:
            text, hits = re.subn(pattern, replacement, text, count=1)
            if hits != 1:
                raise RuntimeError(f"variant {name}: {pattern} is not in "
                                   f"matmul.cu")
        (d / "matmul.cu").write_text(text)
        srcs[name] = d / "matmul.cu"
    procs = {name: _nvcc(src, work / f"{name}.so")
             for name, src in srcs.items()}
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{srcs[name]} failed to build:\n"
                               f"{logs[name]}")
        lib = libs[name] = ctypes.CDLL(str(work / f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        fns = ({"pmm_matmul": [p, p, p, i, i, i, i, p]} if name == "parent"
               else {"pmm_matmul_plan": [i, i, i, i, p],
                     "pmm_matmul_highest": [p, p, p, i, i, i, p],
                     "pmm_split_pad": [p, p, p, i, i, i, p],
                     "pmm_matmul_bf16x3": [p, p, p, p, i, i, i, p]})
        for fn, args in fns.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = i
    return libs, logs


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def parent_matmul(lib, q: torch.Tensor, c: torch.Tensor,
                  core: str) -> torch.Tensor:
    """The parent's kernel C on contiguous f32 CUDA operands."""
    out = torch.empty((q.shape[0], c.shape[0]), dtype=torch.float32,
                      device=q.device)
    rc = lib.pmm_matmul(_ptr(q), _ptr(c), _ptr(out), q.shape[0], c.shape[0],
                        q.shape[1], M.CORES.index(core), _stream())
    if rc != 0:
        raise RuntimeError(f"the parent's pmm_matmul failed: error {rc}")
    return out


def variant_matmul(lib, q: torch.Tensor, c: torch.Tensor,
                   core: str) -> torch.Tensor:
    """A variant build's kernel C, called as ``pallas_matmul`` calls this
    tree's."""
    (m, dim), n = q.shape, c.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    if core == "highest":
        rc = lib.pmm_matmul_highest(_ptr(q), _ptr(c), _ptr(out), m, n, dim,
                                    _stream())
    else:
        plan = (ctypes.c_int * len(M.PLAN_FIELDS))()
        rc = lib.pmm_matmul_plan(m, n, dim, M.CORES.index(core), plan)
        split = None
        if rc == 0 and M.BODIES[plan[2]] == "wgmma":
            split = torch.empty((m + n, 2 * M.padded_dim(dim)),
                                dtype=torch.bfloat16, device=q.device)
            rc = lib.pmm_split_pad(_ptr(q), _ptr(c), _ptr(split), m, n, dim,
                                   _stream())
        rc = rc or lib.pmm_matmul_bf16x3(_ptr(q), _ptr(c), _ptr(split),
                                         _ptr(out), m, n, dim, _stream())
    if rc != 0:
        raise RuntimeError(f"a variant's kernel C failed: error {rc}")
    return out


class Clocks:
    """The card's SM clock (MHz) and power draw (W), polled by
    ``nvidia-smi`` every 50 ms while the block runs: ``.sm_mhz`` and
    ``.watts`` hold the median of the samples (None where the block
    ended before the first).  The sample taken before the block is
    dropped."""

    def __init__(self, device: torch.device):
        self.index = device.index or 0

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--id={self.index}",
             "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.proc.stdout.readline()   # the sample before the block
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=60)[0]
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        self.sm_mhz = statistics.median(r[0] for r in rows) if rows else None
        self.watts = statistics.median(r[1] for r in rows) if rows else None


def bound_ms(m: int, n: int, dim: int, core: str):
    """(ms, "bytes" or "operations"): each input read once and the output
    written once at the card's memory rate, or the products at its peak
    (f32 FMA for highest; three bf16 products for bf16x3)."""
    nbytes = (m * dim + n * dim + m * n) * 4
    flops = 2 * m * n * dim
    if core == "highest":
        ops_ms = flops / (P.device_peak_tflops("float32_cuda_cores") * 1e12)
    else:
        ops_ms = 3 * flops / (P.device_peak_tflops("bfloat16") * 1e12)
    by_bytes = nbytes / P.device_hbm_bytes_per_s()
    return ((by_bytes * 1e3, "bytes") if by_bytes >= ops_ms
            else (ops_ms * 1e3, "operations"))


def main(parent: Path, shapes=SHAPES, iters: int = 10, seed: int = 0,
         cores=None, variants=()):
    """Time the parent, this tree and each of ``variants`` (names of
    ``VARIANTS``) in turns at ``shapes`` in ``cores`` (all by default)."""
    if not torch.cuda.is_available():
        raise RuntimeError("ab_matmul needs a CUDA device")
    dev = torch.device("cuda")
    name = card(dev)
    libs, logs = build(parent, variants)
    _build.load_library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    results = []
    for m, n, dim in shapes:
        q = torch.randn((m, dim), generator=gen, device=dev)
        c = torch.randn((n, dim), generator=gen, device=dev)
        big = m * n > 100_000_000
        reps = max(3, iters // 3) if big else iters

        def library():
            with exact_matmul():
                return torch.matmul(q, c.T)

        lib_ms = median_ms(library, reps)
        for core in cores or M.CORES:
            fns = {"parent": lambda: parent_matmul(libs["parent"], q, c,
                                                   core),
                   "change": lambda: M.pallas_matmul(q, c, precision=core),
                   "kernel": lambda: variant_matmul(_build.load_library(),
                                                    q, c, core)}
            for v in variants:
                fns[v] = (lambda vlib=libs[v]:
                          variant_matmul(vlib, q, c, core))
            ref = fns["change"]()
            diffs = {k: float((f() - ref).abs().max())
                     for k, f in fns.items() if k != "change"}
            del ref
            times = {k: [] for k in fns}
            graph = {k: [] for k in fns}
            sm_mhz = {k: [] for k in fns}
            watts = {k: [] for k in fns}
            for k in list(fns) + list(fns)[::-1]:
                with Clocks(dev) as clk:
                    times[k].append(median_ms(fns[k], reps))
                sm_mhz[k].append(clk.sm_mhz)
                watts[k].append(clk.watts)
                if not big:
                    graph[k].append(P.graph_ms(fns[k]))
            # Each output freed before the next call (a 1 x 1 copy kept,
            # for the events), so that the allocator hands the same block
            # back: batches with the footprint of one call.
            freed = median_ms(lambda: fns["change"]()[:1, :1].clone(), reps)
            with Clocks(dev) as clk:
                single = P.benchmark(fns["change"],
                                     iters=reps * BATCH)["median_ms"]
            plain = P.benchmark(lambda: M.pallas_matmul_plain(q, c, core),
                                warmup=1, iters=3)["median_ms"]
            rec = {"card": name, "shape": [m, n, dim], "core": core,
                   "parent_ms": times.pop("parent"),
                   "change_ms": times.pop("change"),
                   "max_abs_diff": diffs.pop("parent"),
                   "kernel_ms": times.pop("kernel"),
                   "graph_ms": graph if not big else None,
                   "change_single_call_ms": single,
                   "change_freed_ms": freed,
                   "sm_mhz": sm_mhz, "watts": watts,
                   "single_call_sm_mhz": clk.sm_mhz,
                   "single_call_watts": clk.watts,
                   "plain_ms": plain, "library_ms": lib_ms,
                   "library_call": "torch.matmul f32 (TF32 off)"}
            if times:
                rec["variants_ms"] = times
                rec["variants_max_abs_diff"] = diffs
            rec["bound_ms"], rec["bound_by"] = bound_ms(m, n, dim, core)
            rec["plan"] = M.launch_plan(m, n, dim, core)
            if rec["plan"]["body"] == "wgmma":
                split = M.split_pad(q, c)
                out = torch.empty((m, n), device=dev)

                def product():
                    rc = _build.load_library().pmm_matmul_bf16x3(
                        _ptr(q), _ptr(c), _ptr(split), _ptr(out), m, n, dim,
                        _stream())
                    if rc != 0:
                        raise RuntimeError(f"pmm_matmul_bf16x3: {rc}")
                    return out

                rec["split_ms"] = median_ms(lambda: M.split_pad(q, c), reps)
                rec["product_ms"] = median_ms(product, reps)
                del split, out
            emit(rec)
            results.append(rec)
        del q, c
        torch.cuda.empty_cache()
    for build_name, log in logs.items():
        emit({"card": name, "build": build_name, "ptxas": [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]})
    return results


def _shape(text: str):
    m, n, dim = (int(v) for v in text.split("x"))
    return m, n, dim


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout of the parent commit (git archive)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cores", default=",".join(M.CORES),
                    help="comma-separated cores to time")
    ap.add_argument("--shapes", default=",".join(
        "x".join(map(str, s)) for s in SHAPES),
        help="comma-separated MxNxDIM shapes")
    ap.add_argument("--variants", default="",
                    help=f"extra builds, of {', '.join(VARIANTS)}")
    args = ap.parse_args()
    variants = [v for v in args.variants.split(",") if v]
    for v in variants:
        if v not in VARIANTS:
            raise SystemExit(f"ab_matmul: unknown variant {v}")
    main(args.parent, shapes=[_shape(s) for s in args.shapes.split(",")],
         iters=args.iters, cores=args.cores.split(","), variants=variants)
