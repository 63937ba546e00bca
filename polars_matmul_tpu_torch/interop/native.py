"""The host packer of ragged List columns (``csrc/pmm_native.cpp``).

At first use (never at import) ``g++`` builds the source into
``build/polars_matmul_tpu_torch/native/<hash of the source and flags>/
libpmm_native.so`` under the checkout (``build/`` is git-ignored) and
``ctypes`` loads it.  Without ``g++``, or if the build fails,
``native_pack_list`` returns None and ``buffers.pack_list`` runs the plain
version, the per-row NumPy loop; ``build_info`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "pmm_native.cpp"
_BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
               / "polars_matmul_tpu_torch" / "native")
# No -march=native: the library may be loaded on another machine's CPU.
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# The last build: library path, or the reason there is none.
build_info: Dict[str, str] = {}


def _build() -> Optional[Path]:
    gxx = shutil.which("g++")
    if gxx is None:
        build_info["error"] = "g++ not found on PATH"
        return None
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libpmm_native.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # Built under a temporary name and renamed: another process may be
    # building or loading the same library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    run = subprocess.run([gxx, *_FLAGS, "-o", tmp, str(_SRC)],
                         capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        os.unlink(tmp)
        build_info["error"] = run.stderr
        return None
    os.replace(tmp, lib)
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built at the first call (None without it)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for name in ("pmm_pack_list_f32", "pmm_pack_list_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, i64, i64, i64, p]
            fn.restype = ctypes.c_int
        build_info["library"] = str(path)
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def native_pack_list(values: np.ndarray, offsets: np.ndarray,
                     validity: Optional[np.ndarray], bit_offset: int,
                     n_rows: int, dim: int) -> Optional[np.ndarray]:
    """Pack a ragged List column (f32 or f64 ``values``, ``n_rows + 1``
    int64 offsets into them, an Arrow validity bitmap whose bit
    ``bit_offset + i`` is row i, or None) into a dense (n_rows, dim)
    matrix; null rows become 0.0.  None when the library is unavailable
    or the dtype is neither f32 nor f64 (the caller runs the plain
    version); raises ``ValueError`` when a valid row's length is not
    ``dim``, without naming the row, as the JAX package's packer does."""
    lib = get_lib()
    if lib is None or values.dtype not in (np.float32, np.float64):
        return None
    fn = (lib.pmm_pack_list_f32 if values.dtype == np.float32
          else lib.pmm_pack_list_f64)
    values = np.ascontiguousarray(values)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if offsets.shape != (n_rows + 1,):
        raise ValueError(f"{offsets.size} offsets for {n_rows} rows")
    if n_rows and (offsets.min() < 0 or offsets.max() > values.size):
        raise ValueError("List offsets reach outside the values buffer")
    if validity is not None:
        validity = np.ascontiguousarray(validity, dtype=np.uint8)
        need = (bit_offset + n_rows + 7) >> 3
        if validity.size < need:
            raise ValueError(f"validity bitmap of {validity.size} bytes, "
                             f"{need} needed")
    out = np.empty((n_rows, dim), dtype=values.dtype)
    rc = fn(values.ctypes.data, offsets.ctypes.data,
            None if validity is None else validity.ctypes.data,
            bit_offset, n_rows, dim, out.ctypes.data)
    if rc != 0:
        raise ValueError(
            "Dimension mismatch: ragged List rows have inconsistent lengths")
    return out
