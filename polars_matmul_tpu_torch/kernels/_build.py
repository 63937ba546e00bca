"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` file for ``sm_90a``
(Hopper), one compiler process per source, all started together, and links
the objects into one shared library with a plain C interface, which is
loaded with ``ctypes``.  The build goes to
``build/polars_matmul_tpu_torch/<hash of the sources>/libpmm_kernels.so``
under the checkout (``build/`` is git-ignored); the hash covers the
``csrc/*.cuh`` headers the sources include as well, so a change to any
source or header builds afresh and an unchanged tree reuses the library.

``nvcc`` is looked up on ``PATH``, then in ``$CUDA_HOME/bin``, then in
``/usr/local/cuda/bin``.  A missing compiler, a failed build or a failed
load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
               / "polars_matmul_tpu_torch")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# What the last build did: library path, seconds, and nvcc's output (the
# ptxas lines give each kernel's registers, shared memory and spills).
build_info: Dict[str, object] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in /usr/local/cuda/bin; "
        "the CUDA kernels of polars_matmul_tpu_torch cannot be built"
    )


def _sources():
    """The translation units: each is compiled on its own."""
    return sorted(_CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in sorted(_sources() + list(_CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_ARCH + _FLAGS).encode())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pmm_fused_topk_partial.argtypes = [p] * 8 + [i] * 14 + [p]
    lib.pmm_fused_topk_partial.restype = i
    lib.pmm_fused_topk_blocks_per_sm.argtypes = [i, i, i, i]
    lib.pmm_fused_topk_blocks_per_sm.restype = i
    lib.pmm_topk_merge.argtypes = [p, p, p, p, i, i, i, p]
    lib.pmm_topk_merge.restype = i
    lib.pmm_matmul.argtypes = [p, p, p, i, i, i, i, p]
    lib.pmm_matmul.restype = i
    lib.pmm_floor_stacks.argtypes = [p] * 7 + [i] * 12 + [p]
    lib.pmm_floor_stacks.restype = i
    lib.pmm_floor_blocks_per_sm.argtypes = [i, i, i]
    lib.pmm_floor_blocks_per_sm.restype = i


def _build(so: Path) -> str:
    """Compile each source to an object in parallel, then link ``so``.
    Returns nvcc's output; raises on the first failure."""
    nvcc = find_nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [so.parent / f"{src.stem}.{tag}.o" for src in _sources()]
    logs = [obj.with_suffix(".log") for obj in objs]
    procs = []
    for src, obj, out in zip(_sources(), objs, logs):
        cmd = [nvcc, *_ARCH, *_FLAGS, "-c", "-o", str(obj), str(src)]
        with open(out, "w") as f:   # a file, so no pipe fills and blocks
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT)))
    log, failed = "", None
    for (cmd, proc), out in zip(procs, logs):
        proc.wait()
        log += out.read_text()
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd)
    tmp = so.parent / f"libpmm_kernels.{tag}.so"
    try:
        if failed is None:
            cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp),
                   *[str(o) for o in objs]]
            r = subprocess.run(cmd, capture_output=True, text=True)
            log += r.stdout + r.stderr
            if r.returncode != 0:
                failed = (r.returncode, cmd)
        if failed is not None:
            raise RuntimeError(
                f"nvcc failed ({failed[0]}): {' '.join(failed[1])}\n{log}")
        os.replace(tmp, so)   # atomic: concurrent builds agree
    finally:
        tmp.unlink(missing_ok=True)
        for path in objs + logs:
            path.unlink(missing_ok=True)
    return log


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = _BUILD_ROOT / _source_hash()
        so = out_dir / "libpmm_kernels.so"
        t0 = time.perf_counter()
        log = ""
        if not so.is_file():
            log = _build(so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                          log=log)
        _lib = lib
        return lib
