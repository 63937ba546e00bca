"""Pairwise matmul Q . C^T (port of ``polars_matmul_tpu.kernels.matmul``).

- ``pairwise_matmul``: the plain product.  The JAX package leaves it to
  XLA's ``dot_general``; the port leaves it to ``torch.matmul``, in full
  float32 or float64 with TF32 off.
- ``pallas_matmul``: the JAX package's hand-written tiled product
  (``_mm_kernel``, a benchmark and a template for fused epilogues).  Here
  it is kernel C, ``csrc/matmul.cu``, written by hand for Hopper, with two
  cores: ``"highest"`` (f32 FFMA on the CUDA cores) and ``"bf16x3"`` (each
  operand split into bf16 hi | lo while staged, three ``mma.sync`` bf16
  products accumulated in f32, the arithmetic of kernel A's bf16x3 core).
  CUDA tensors launch kernel C, CPU tensors run ``pallas_matmul_plain``,
  and any other device raises.  Launches are counted in ``launches`` and,
  per core, in ``core_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.reference import exact_matmul, mixed_matmul
from .fused_topk import _ptr, split_hi_lo

# Kernel C's cores, in the order of the CUDA source's Core enum.
CORES = ("highest", "bf16x3")
# The core each precision runs (the JAX package's _PRECISION keys: any
# other precision, "int8c" and "int4c" included, is a KeyError there too).
_CORE = {"default": "highest", "high": "highest", "highest": "highest",
         "bf16x3": "bf16x3", "bf16c": "bf16x3"}

# Launches per wrapper, for showing that a run went through the kernel.
launches = {"pallas_matmul": 0, "pallas_matmul_plain": 0}
# Kernel C's launches by core (each also counts in launches).
core_launches = {core: 0 for core in CORES}


def reset_launch_counts() -> None:
    for counts in (launches, core_launches):
        for key in counts:
            counts[key] = 0


def pairwise_matmul(q: torch.Tensor, c: torch.Tensor, *,
                    precision: str = "highest") -> torch.Tensor:
    """Q . C^T in the queries' dtype, as the JAX package's
    ``dot_general(..., preferred_element_type=q.dtype)``: operands of two
    dtypes multiply in their promoted dtype, and the product is cast to
    q's.  ``precision`` is accepted for signature parity: this product is
    always exact (never TF32)."""
    return mixed_matmul(q, c)


def pallas_matmul_plain(q: torch.Tensor, c: torch.Tensor,
                        core: str = "highest") -> torch.Tensor:
    """Plain version of kernel C on f32 (m, dim) and (n, dim) operands.

    "highest": the f32 product (TF32 off).  "bf16x3": ``split_hi_lo`` of
    both operands and the three products of the bf16 halves, each upcast
    to f32 (their products are exact), grouped as kernel C sums them:
    qh.ch + (qh.cl + ql.ch).
    """
    if core not in CORES:
        raise ValueError(f"no kernel C core {core!r}; cores: {CORES}")
    launches["pallas_matmul_plain"] += 1
    with exact_matmul():
        if core == "highest":
            return q @ c.T
        d = q.shape[1]
        qs, cs = split_hi_lo(q), split_hi_lo(c)
        qh, ql = qs[:, :d].float(), qs[:, d:].float()
        ch, cl = cs[:, :d].float(), cs[:, d:].float()
        return qh @ ch.T + (qh @ cl.T + ql @ ch.T)


def _kernel_c(q: torch.Tensor, c: torch.Tensor, core: str) -> torch.Tensor:
    """Kernel C on contiguous f32 CUDA operands: (m, n) f32."""
    from ._build import load_library

    lib = load_library()
    m, dim = q.shape
    n = c.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pmm_matmul(_ptr(q), _ptr(c), _ptr(out), m, n, dim,
                            CORES.index(core), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"pallas_matmul launch failed: error {rc}")
    launches["pallas_matmul"] += 1
    core_launches[core] += 1
    return out


def pallas_matmul(q, c, *, block_m: int = 256, block_n: int = 512,
                  block_k: int = 512, precision: str = "highest",
                  device=None) -> torch.Tensor:
    """Q . C^T through kernel C: (m, n) in ``q``'s dtype, computed in f32.

    ``q`` (m, dim) and ``c`` (n, dim) are NumPy arrays or torch tensors.
    NumPy inputs go to ``"cuda"`` unless ``device=`` says otherwise; a
    tensor keeps its device.  Inputs are cast to f32 and the result back
    to ``q``'s dtype, as the JAX function does (an f64 input gives f64,
    computed in f32).  ``precision`` picks the core: "default", "high"
    and "highest" run "highest", "bf16x3" and "bf16c" run "bf16x3"; any
    other value is a KeyError, as in the JAX package.  An empty operand
    (m, n or dim 0) raises.

    ``block_m`` / ``block_n`` / ``block_k`` must be positive; they size
    the JAX kernel's grid but not kernel C's tiles (128 x 128 outputs a
    block, its own feature stages), as ``config.py`` says of ``block_q``.
    """
    for name, b in (("block_m", block_m), ("block_n", block_n),
                    ("block_k", block_k)):
        if isinstance(b, bool) or not isinstance(b, int) or b <= 0:
            raise ValueError(f"{name} must be a positive int, got {b!r}")
    from ..api.search import resolve_device

    dev = resolve_device(device, q, c)
    qt = torch.as_tensor(q).to(dev)
    ct = torch.as_tensor(c).to(dev)
    if qt.ndim != 2 or ct.ndim != 2 or qt.shape[1] != ct.shape[1]:
        raise ValueError(f"pallas_matmul takes (m, dim) and (n, dim), got "
                         f"{tuple(qt.shape)} and {tuple(ct.shape)}")
    if 0 in (qt.shape[0], ct.shape[0], qt.shape[1]):
        raise ValueError(f"pallas_matmul needs non-empty operands, got "
                         f"{tuple(qt.shape)} and {tuple(ct.shape)}")
    core = _CORE[precision]
    q32 = qt.to(torch.float32).contiguous()
    c32 = ct.to(torch.float32).contiguous()
    if dev.type == "cpu":
        out = pallas_matmul_plain(q32, c32, core)
    elif dev.type == "cuda":
        out = _kernel_c(q32, c32, core)
    else:
        raise RuntimeError(f"no kernel for device {dev}")
    return out.to(qt.dtype)
