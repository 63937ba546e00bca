"""Pairwise matmul Q . C^T (port of ``polars_matmul_tpu.kernels.matmul``).

- ``pairwise_matmul``: the plain product.  The JAX package leaves it to
  XLA's ``dot_general``; the port leaves it to ``torch.matmul``, in full
  float32 or float64 with TF32 off.
- ``pallas_matmul``: the JAX package's hand-written tiled product
  (``_mm_kernel``, a benchmark and a template for fused epilogues).  Here
  it is kernel C, ``csrc/matmul.cu``, written by hand for Hopper, with two
  cores: ``"highest"`` (f32 FFMA on the CUDA cores, fed by a cp.async
  ring) and ``"bf16x3"`` (the arithmetic of kernel A's bf16x3 core: three
  bf16 products accumulated in f32).  Above 128 queries bf16x3 splits
  both operands once a call into padded bf16 [hi | lo] rows
  (``split_pad``), then runs ``wgmma`` products fed by TMA; at 128 or
  fewer it runs the ``mma.sync`` body that splits as it stages, which is
  faster there.  CUDA tensors launch kernel C, CPU tensors run
  ``pallas_matmul_plain``, and any other device raises.  Launches are
  counted in ``launches``, per core in ``core_launches``, per body in
  ``body_launches``; the split's in ``split_launches``.
- ``launch_plan``: the launch kernel C makes at a shape, as its source
  works it out (``pmm_matmul_plan``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as TF

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
# Kernel C's bodies, in the order of the source's Body enum: the f32
# ring ("highest"), TMA + wgmma and mma.sync ("bf16x3").
BODIES = ("ffma", "wgmma", "mma")
# Kernel C's launches by body (each also counts in core_launches).
body_launches = {body: 0 for body in BODIES}
# The wgmma body's split of both operands (one launch a product).
split_launches = {"split_pad": 0, "split_pad_plain": 0}

# Split rows are whole boxes of this many features (the TMA's 128 bytes).
BOX = 64


def reset_launch_counts() -> None:
    for counts in (launches, core_launches, body_launches, split_launches):
        for key in counts:
            counts[key] = 0


# The fields of kernel C's launch plan (``pmm_matmul_plan``): q rows and
# c rows a tile, the body (an index of BODIES), the group of q tiles of
# the tile order, ring stages, blocks, dynamic shared memory bytes.
PLAN_FIELDS = ("bm", "bn", "body", "group", "stages", "blocks", "smem")


def launch_plan(m: int, n: int, dim: int, core: str) -> dict:
    """The launch kernel C makes for (m, n, dim) in ``core`` on the
    current card, as the source works it out (``pmm_matmul_plan``)."""
    from ._build import load_library

    plan = (ctypes.c_int * len(PLAN_FIELDS))()
    if load_library().pmm_matmul_plan(m, n, dim, CORES.index(core),
                                      plan) != 0:
        raise ValueError(f"kernel C takes no {(m, n, dim, core)}")
    out = dict(zip(PLAN_FIELDS, plan))
    out["body"] = BODIES[out["body"]]
    return out


def padded_dim(dim: int) -> int:
    """Features of each half of a split row: dim rounded up to whole
    64-feature boxes."""
    return -(-dim // BOX) * BOX


def split_pad_plain(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version of the split kernel: ``split_hi_lo`` of each f32
    operand zero-padded to ``padded_dim(dim)`` features, q's rows then
    c's: bf16 (m + n, 2 dp), each row [hi | lo]."""
    split_launches["split_pad_plain"] += 1
    pad = padded_dim(q.shape[1]) - q.shape[1]
    return torch.cat([split_hi_lo(TF.pad(x, (0, pad))) for x in (q, c)])


def split_pad(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The split of kernel C's wgmma body, one launch for both contiguous
    f32 operands of one dim: bf16 (m + n, 2 ``padded_dim(dim)``), as
    ``split_pad_plain`` gives bit for bit.  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return split_pad_plain(q, c)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(q.device):
        return _split(lib, q, c, ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream))


def _split(lib, q: torch.Tensor, c: torch.Tensor, stream) -> torch.Tensor:
    """``split_pad``'s launch on ``stream``, in the current device."""
    (m, dim), n = q.shape, c.shape[0]
    out = torch.empty((m + n, 2 * padded_dim(dim)), dtype=torch.bfloat16,
                      device=q.device)
    rc = lib.pmm_split_pad(_ptr(q), _ptr(c), _ptr(out), m, n, dim, stream)
    if rc != 0:
        raise RuntimeError(f"split_pad launch failed: error {rc}")
    split_launches["split_pad"] += 1
    return out


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


@functools.lru_cache(maxsize=1024)
def _body(m: int, n: int, dim: int, core: str, device: int) -> str:
    """The body kernel C runs at (m, n, dim) in ``core`` on card
    ``device``, the current one (the plan counts its SMs)."""
    return launch_plan(m, n, dim, core)["body"]


def _kernel_c(q: torch.Tensor, c: torch.Tensor, core: str) -> torch.Tensor:
    """Kernel C on contiguous f32 CUDA operands: (m, n) f32, in the body
    of its launch plan.  The wgmma body runs on the split's buffer, whose
    rows its tensor maps need 16-byte aligned, which the padding
    guarantees."""
    from ._build import load_library

    lib = load_library()
    m, dim = q.shape
    n = c.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        body = _body(m, n, dim, core, torch.cuda.current_device())
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if core == "highest":
            rc = lib.pmm_matmul_highest(_ptr(q), _ptr(c), _ptr(out), m, n,
                                        dim, stream)
        else:
            split = _split(lib, q, c, stream) if body == "wgmma" else None
            if split is not None and split.data_ptr() % 16:
                raise RuntimeError("the split rows are not 16-byte aligned")
            rc = lib.pmm_matmul_bf16x3(_ptr(q), _ptr(c), _ptr(split),
                                       _ptr(out), m, n, dim, stream)
    if rc != 0:
        raise RuntimeError(f"pallas_matmul launch failed: error {rc}")
    launches["pallas_matmul"] += 1
    core_launches[core] += 1
    body_launches[body] += 1
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
    the JAX kernel's grid but not kernel C's tiles (``launch_plan``), as
    ``config.py`` says of ``block_q``.
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
