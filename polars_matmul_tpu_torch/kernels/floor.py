"""Kernel D: kernel A's staging and score tiles without its selection, then a
per-tile row-max sum or an L-level packed stack selection (port of the
three experiment kernels of the JAX package's ``tools/``).

The JAX package measured what its fused kernel costs piece by piece with
three Pallas kernels: ``tools/exp_floor.py::_kernel_ab`` (the bf16x3
product and epilogue with no selection, or 1-5 stack levels),
``tools/exp_b256.py::_kernel_build`` (the int8c product with a
segmented-gstack-style build, posu or not) and ``tools/exp_int4.py::
_kernel_mm`` (an int4 corpus unpacked four ways, one stack level).  Kernel
D, ``csrc/floor.cu`` (``floor_stacks``), computes all three on the H100
with kernel A's own staging and products (``csrc/tile_scores.cuh``), so
that kernel A minus D at ``levels=0`` is kernel A's selection cost.

What it computes, on padded operands as the JAX experiments build them:
queries ``qp`` (m, 2 dim) bf16 [hi | lo], a corpus in one of ``CORES``,
and a bias operand ``cb``: (1, n) for "bf16x3", (2, n) [scale; bias]
otherwise.

- scores: "bf16x3" s = qh.ch + (qh.cl + ql.ch) + cb[0]; every other core
  s = (qh.c + ql.c) * cb[0] + cb[1], rounded as two operations.  "int8c"
  reads int8 codes (n, dim); the int4 family reads (n, dim / 2) bytes,
  byte j holding feature j and feature j + dim / 2: "int4c" as two
  sign-extended nibbles (low, high), "int4-rint" as b = 16 hi + lo
  decoded in float (hi = rint(b / 16), lo = b - 16 hi; ``repack_int4_rint``
  makes such bytes), "int4-raw" as the byte itself in both places (wrong
  on purpose: the free-unpack control);
- ``levels=0``: out[r, :] = the sum over ``tn``-wide corpus tiles of
  int32(max of s[r, tile]), truncated toward zero, on all 128 lanes;
- ``levels>=1``: u = ``_f32_to_u`` of the score bits (the raw bits with
  ``posu``), packed p = (u & ~127) | id(col); each (row, col % 128) cell
  keeps its L largest packed values, best first, and out is level 0.  The
  ``ids`` rules: "global" id = 127 - col // 128 (``exp_floor``, at most 128
  groups), "segmented" id = 127 - (col % seg) // 128 with the stacks reset
  every seg = (16384 // tn) * tn columns and out the last segment's
  (``exp_b256``), "tile-local" id = (col % tn) // 128 (``exp_int4``).

Kernel D runs kernel A's geometry: its query tile (``query_tile_rows(m,
k_geometry)``, narrowed where the stacks would not fit in shared memory),
its 64-row corpus tiles, and splits sized by D's own occupancy.  Besides
out it returns every split's levels, (m, splits, L, 128) int32, or for
``levels=0`` the (m, ceil(n / tn)) tile maxima as order-preserving ints
(``_f32_to_u`` of the bits; ``decode_ordered``).

CUDA tensors go to the kernel, CPU tensors to ``floor_stacks_plain``, any
other device raises.  ``launches`` counts each.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..ops import reference
from . import fused_topk as F

# Kernel D's cores, the corpus forms it reads (enum values of the CUDA
# source's Core).
CORES = ("bf16x3", "int8c", "int4c", "int4-rint", "int4-raw")
_CORE_ENUM = {"bf16x3": 1, "int8c": 3, "int4c": 4, "int4-rint": 5,
              "int4-raw": 6}
_INT4 = ("int4c", "int4-rint", "int4-raw")
# Group-id rules, in the order of the CUDA source's Ids.
IDS = ("global", "segmented", "tile-local")
MAX_LEVELS = 16
INT32_MIN = -(1 << 31)
_LANES = 128
_SEGMENT_ROWS = _LANES * _LANES
_TN = F._TN
# A block's dynamic shared-memory limit on the H100.
_MAX_SMEM = 232448
# The CPU has no SMs to fill: its plain version runs the geometry of a
# notional 132-SM card holding one block an SM.
_NOTIONAL_SMS = 132
# The JAX kernel's stack depth ceiling below big k (``_STACK_DEPTH``).
_STACK_DEPTH = 8

launches = {"floor_stacks": 0, "floor_stacks_plain": 0}
# Kernel D's launches by core (each also counts in launches).
core_launches = {core: 0 for core in CORES}


def reset_launch_counts() -> None:
    for counts in (launches, core_launches):
        for key in counts:
            counts[key] = 0


# ---------------------------------------------------------------------------
# The JAX package's packing and stack geometry (``kernels/fused_topk.py``),
# kept here as the port's own copies.
# ---------------------------------------------------------------------------


def _f32_to_u(bits: torch.Tensor) -> torch.Tensor:
    """Monotone f32 bits -> sortable signed int32 (an involution): positive
    floats keep their bits, negative ones get their low 31 bits
    inverted."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def decode_ordered(u: torch.Tensor) -> torch.Tensor:
    """The f32 values of order-preserving ints."""
    return _f32_to_u(u).view(torch.float32)


def decode_packed(p: torch.Tensor, posu: bool = False) -> torch.Tensor:
    """The f32 score a packed value carries (its low 7 bits cleared)."""
    u = p & ~127
    return (u if posu else _f32_to_u(u)).view(torch.float32)


def _gstack_depth(k: int, cells: int = _LANES) -> int:
    """The JAX gstack's per-class stack depth at this k (``_gstack_depth``,
    ``fused_topk.py:491``)."""
    if k > _LANES:
        return F._bigk_depth(k, cells)
    if cells <= _LANES:
        for k_max, levels in ((10, 5), (16, 6), (32, 7), (64, 8)):
            if k <= k_max:
                return levels
        return _STACK_DEPTH + 1
    levels = 3
    while (levels < _STACK_DEPTH + 1
           and math.comb(k, levels) / cells ** (levels - 1) > 1e-7):
        levels += 1
    return levels


def _gstack_geometry(total_groups: int, k: int):
    """(low_bits, low_mask, depth, n_levels, n_segs) of the JAX gstack's
    stacks over ``total_groups`` 128-row groups (``_gstack_geometry``,
    ``fused_topk.py:566``)."""
    n_segs = max(1, -(-total_groups // _LANES))
    if n_segs == 1:
        low_bits = max(1, (total_groups - 1).bit_length())
        n_levels = min(_gstack_depth(k), total_groups)
        lossless = total_groups <= n_levels
        depth = n_levels if lossless else n_levels - 1
        return low_bits, (1 << low_bits) - 1, depth, n_levels, 1
    n_levels = _gstack_depth(k, cells=_LANES * n_segs)
    return 7, _LANES - 1, n_levels - 1, n_levels, n_segs


def repack_int4_rint(packed: torch.Tensor) -> torch.Tensor:
    """Nibble-packed int4 bytes (low nibble lo, high nibble hi, both
    signed) -> the bytes b = 16 hi + lo that "int4-rint" decodes in float
    (``tools/exp_int4.py:199-206``); wraps to int8 as the NumPy cast
    does."""
    lo, hi = F._unpack_nibbles(packed)
    return (16 * hi.to(torch.int16) + lo.to(torch.int16)).to(torch.int8)


# ---------------------------------------------------------------------------
# Geometry.
# ---------------------------------------------------------------------------


def segment_rows(tn: int) -> int:
    """Columns between two stack resets under the "segmented" rule: the
    JAX kernel's (16384 // tn) tiles of tn rows."""
    return _SEGMENT_ROWS // tn * tn if tn <= _SEGMENT_ROWS else tn


def smem_bytes(tm: int, core: str, levels: int) -> int:
    """Kernel D's shared memory (``floor_smem_bytes`` in the source): bf16
    operand tiles of 32 features (bf16x3) or ``stored_bk`` features, rows
    padded by 8; the score tile; the stacks or the running tile maxima."""
    if core == "bf16x3":
        operands = 2 * (tm + _TN) * (32 + 8) * 2
    else:
        operands = (2 * tm + _TN) * ((64 if tm == 64 else 128) + 8) * 2
    work = levels * tm * _LANES * 4 if levels else tm * 4
    return operands + tm * (_TN + 1) * 4 + work


# (device index, tm, core, levels) -> blocks of kernel D one SM holds.
_occupancy = {}


def floor_geometry(m: int, n: int, core: str, levels: int, k_geometry: int,
                   device: torch.device):
    """(tm, splits, tiles_per_split) of kernel D: kernel A's query tile for
    k_geometry (halved while the stacks do not fit) and kernel A's split
    rule at D's own occupancy on a CUDA ``device`` (a notional 132-SM card
    elsewhere)."""
    tm = F.query_tile_rows(m, k_geometry)
    while tm > 16 and smem_bytes(tm, core, levels) > _MAX_SMEM:
        tm //= 2
    sms, blocks = _NOTIONAL_SMS, 1
    if device.type == "cuda":
        key = (device.index, tm, core, levels)
        if key not in _occupancy:
            from ._build import load_library

            with torch.cuda.device(device):
                got = load_library().pmm_floor_blocks_per_sm(
                    tm, _CORE_ENUM[core], levels)
            if got <= 0:
                raise RuntimeError(f"kernel D cannot run tm={tm} {core} "
                                   f"levels={levels}: error {got}")
            _occupancy[key] = got
        blocks = _occupancy[key]
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return F.launch_geometry(m, n, k_geometry, sms, blocks, tm)


def _check(qp, cp, cb, core: str, levels: int, tn: int, ids: str):
    if core not in CORES:
        raise ValueError(f"no kernel D core {core!r}; cores: {CORES}")
    if ids not in IDS:
        raise ValueError(f"no id rule {ids!r}; rules: {IDS}")
    if not 0 <= levels <= MAX_LEVELS:
        raise ValueError(f"levels={levels} outside [0, {MAX_LEVELS}]")
    if tn <= 0 or tn % _LANES:
        raise ValueError(f"tn={tn} must be a positive multiple of {_LANES}")
    for name, t in (("cp", cp), ("cb", cb)):
        if t.device != qp.device:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{qp.device}")
    if qp.dtype != torch.bfloat16 or qp.ndim != 2 or qp.shape[1] % 2:
        raise ValueError("qp must be (m, 2 dim) bfloat16 [hi | lo]")
    dim = qp.shape[1] // 2
    want = {"bf16x3": (torch.bfloat16, 2 * dim),
            "int8c": (torch.int8, dim)}.get(core, (torch.int8, dim // 2))
    if (cp.ndim != 2 or (cp.dtype, cp.shape[1]) != want
            or (core in _INT4 and dim % 2)):
        raise ValueError(f"core {core!r} takes a {want[0]} corpus of width "
                         f"{want[1]} for dim {dim}, got {cp.dtype} "
                         f"{tuple(cp.shape)}")
    n = cp.shape[0]
    rows = 1 if core == "bf16x3" else 2
    if cb.dtype != torch.float32 or tuple(cb.shape) != (rows, n):
        raise ValueError(f"cb must be ({rows}, {n}) float32")
    for name, t in (("qp", qp), ("cp", cp), ("cb", cb)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if levels and ids == "global" and -(-n // _LANES) > _LANES:
        # The JAX kernel packs 127 - g, which goes negative past group 127
        # and corrupts the score bits (a fault of the reference).
        raise ValueError(f"the global id rule takes at most {_LANES} groups "
                         f"of {_LANES} rows; got {-(-n // _LANES)}")
    if levels and ids != "global" and tn > _SEGMENT_ROWS:
        raise ValueError(f"{ids} ids take tn <= {_SEGMENT_ROWS}; got {tn}")


def floor_stacks(qp: torch.Tensor, cp: torch.Tensor, cb: torch.Tensor, *,
                 core: str, levels: int, tn: int, ids: str = "global",
                 posu: bool = False, k_geometry: int = 10
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D at ``floor_geometry``: (out (m, 128) int32, every split's
    levels (m, splits, levels, 128) int32, or for ``levels=0`` the (m,
    ceil(n / tn)) tile maxima as order-preserving ints)."""
    _check(qp, cp, cb, core, levels, tn, ids)
    m, n = qp.shape[0], cp.shape[0]
    tm, splits, tps = floor_geometry(m, n, core, levels, k_geometry,
                                     qp.device)
    if qp.device.type == "cpu":
        return floor_stacks_plain(qp, cp, cb, core=core, levels=levels,
                                  tn=tn, ids=ids, posu=posu, splits=splits,
                                  tiles_per_split=tps)
    if qp.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {qp.device}")
    from ._build import load_library

    lib = load_library()
    dev = qp.device
    i32 = {"dtype": torch.int32, "device": dev}
    done = None
    if levels:
        out = torch.full((m, _LANES), INT32_MIN, **i32)
        lv = torch.empty((m, splits, levels, _LANES), **i32)
    else:
        out = torch.empty((m, _LANES), **i32)
        lv = torch.full((m, -(-n // tn)), INT32_MIN, **i32)
        done = torch.zeros(-(-m // tm), **i32)
    scale, bias = (None, cb[0]) if core == "bf16x3" else (cb[0], cb[1])
    ptr = F._ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pmm_floor_stacks(
            ptr(qp), ptr(cp), ptr(scale), ptr(bias), ptr(out), ptr(lv),
            ptr(done), m, n, qp.shape[1] // 2, cp.shape[1],
            _CORE_ENUM[core], levels, tn, IDS.index(ids), int(posu), splits,
            tps, tm, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"floor_stacks launch failed: error {rc}")
    launches["floor_stacks"] += 1
    core_launches[core] += 1
    return out, lv


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def _decoded_corpus(cp: torch.Tensor, core: str) -> torch.Tensor:
    """(rows, dim) f32 features of the stored corpus as ``core`` reads it."""
    if core == "int8c":
        return cp.float()
    lo, hi = F._unpack_nibbles(cp)
    if core == "int4-rint":
        b = cp.float()
        hi = torch.round(b * 0.0625)    # half to even, as rint
        lo = b - 16.0 * hi
    elif core == "int4-raw":
        lo = hi = cp
    return torch.cat([lo, hi], dim=1).float()


def floor_scores_plain(qp: torch.Tensor, cp: torch.Tensor, cb: torch.Tensor,
                       core: str, c0: int, c1: int) -> torch.Tensor:
    """Kernel D's scores of corpus rows [c0, c1), (m, c1 - c0) f32: the
    products of bf16 values upcast to f32 (exact) in the TPU kernels'
    groups, then the epilogue."""
    step = F._plain_rows(qp)
    if c1 - c0 > step:   # bound the upcast corpus rows
        return torch.cat([floor_scores_plain(qp, cp, cb, core, r,
                                             min(c1, r + step))
                          for r in range(c0, c1, step)], dim=1)
    if core == "bf16x3":
        return F._plain_scores(qp, cp[c0:c1], "bf16x3") + cb[0, c0:c1]
    d = qp.shape[1] // 2
    qh, ql = qp[:, :d].float(), qp[:, d:].float()
    c = _decoded_corpus(cp[c0:c1], core)
    with reference.exact_matmul():
        s = qh @ c.T + ql @ c.T
    return s * cb[0, c0:c1] + cb[1, c0:c1]


def _trunc_i64(x: torch.Tensor) -> torch.Tensor:
    """int32(x) truncated toward zero as the card converts it (NaN to 0,
    out of range saturated), as int64."""
    x = torch.nan_to_num(x.double(), nan=0.0).trunc()
    return x.clamp(INT32_MIN, -INT32_MIN - 1).to(torch.int64)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32, wrapping as int32 sums do."""
    return ((x - INT32_MIN) % (1 << 32) + INT32_MIN).to(torch.int32)


def _pack(s: torch.Tensor, c0: int, tn: int, ids: str, seg: int,
          posu: bool) -> torch.Tensor:
    """The packed int32 values (u & ~127) | id(col) of scores whose first
    column is corpus row c0."""
    bits = s.contiguous().view(torch.int32)
    u = bits if posu else _f32_to_u(bits)
    col = torch.arange(c0, c0 + s.shape[1], device=s.device)
    if ids == "global":
        gid = 127 - col // _LANES
    elif ids == "segmented":
        gid = 127 - (col % seg) // _LANES
    else:
        gid = (col % tn) // _LANES
    return (u & ~127) | gid.to(torch.int32)


def floor_stacks_plain(qp: torch.Tensor, cp: torch.Tensor, cb: torch.Tensor,
                       *, core: str, levels: int, tn: int,
                       ids: str = "global", posu: bool = False,
                       splits: int = 1, tiles_per_split: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel D, the same outputs for the same splits
    (split s covers corpus rows [s r, s r + r), r = tiles_per_split * 64):
    scores in chunks of whole splits, packed, and each cell's levels by a
    sort of its packed values (over the split's last segment, when
    segmented); for ``levels=0`` the tile maxima and their sum."""
    launches["floor_stacks_plain"] += 1
    m, n = qp.shape[0], cp.shape[0]
    dev = qp.device
    if levels == 0:
        return _maxima_plain(qp, cp, cb, core, tn)
    tps = tiles_per_split or -(-n // _TN)
    rows = tps * _TN
    per = max(1, F._plain_rows(qp) // rows)
    out_levels = []
    for s0 in range(0, splits, per):
        s1 = min(splits, s0 + per)
        c0, c1 = s0 * rows, min(n, s1 * rows)
        s = floor_scores_plain(qp, cp, cb, core, c0, c1)
        out_levels.append(_levels_plain(s, c0, tn, n, ids, posu, s0, s1,
                                        rows, levels))
    lv = torch.cat(out_levels, dim=1)
    seg = segment_rows(tn)
    last = torch.clamp(torch.arange(1, splits + 1, device=dev) * rows,
                       max=n) - 1
    reach = (last // seg == (n - 1) // seg) if ids == "segmented" else (
        torch.ones(splits, dtype=torch.bool, device=dev))
    top = torch.where(reach[None, :, None], lv[:, :, 0],
                      torch.full_like(lv[:, :, 0], INT32_MIN))
    return top.amax(dim=1).contiguous(), lv


def _maxima_plain(qp, cp, cb, core: str, tn: int):
    """levels=0: (out (m, 128) int32, the (m, ceil(n / tn)) tile maxima as
    order-preserving ints): each row's sum over tn-row tiles of
    int32(tile max), wrapping as an int32 sum."""
    m, n = qp.shape[0], cp.shape[0]
    step = max(tn, F._plain_rows(qp) // tn * tn)
    maxima = []
    for c0 in range(0, n, step):
        c1 = min(n, c0 + step)
        s = floor_scores_plain(qp, cp, cb, core, c0, c1)
        s = torch.nn.functional.pad(s, (0, -(c1 - c0) % tn),
                                    value=float("-inf"))
        maxima.append(s.reshape(m, -1, tn).amax(dim=2))
    maxima = torch.cat(maxima, dim=1)
    total = _trunc_i64(maxima).sum(dim=1, keepdim=True)
    return (_wrap_i32(total).expand(m, _LANES).contiguous(),
            _f32_to_u(maxima.contiguous().view(torch.int32)))


def _levels_plain(s, c0: int, tn: int, n: int, ids: str, posu: bool,
                  s0: int, s1: int, rows: int, levels: int):
    """(m, s1 - s0, levels, 128) int32: the L largest packed values of
    each (row, lane) cell of each split, from its columns (its last
    segment's, when segmented), INT32_MIN where it has fewer."""
    m, dev = s.shape[0], s.device
    seg = segment_rows(tn)
    p = _pack(s, c0, tn, ids, seg, posu)
    sp = torch.arange(s0, s1, device=dev)
    lo = sp * rows
    hi = torch.clamp(lo + rows, max=n)
    if ids == "segmented":
        lo = torch.maximum(lo, (hi - 1) // seg * seg)
    g0 = lo // _LANES
    groups = int(((hi - 1) // _LANES - g0).max()) + 1
    col = ((g0[:, None, None] + torch.arange(groups, device=dev)[:, None])
           * _LANES + torch.arange(_LANES, device=dev))   # (S, G, 128)
    live = (col >= lo[:, None, None]) & (col < hi[:, None, None])
    idx = torch.where(live, col - c0, torch.zeros_like(col))
    vals = p[:, idx.reshape(-1)].reshape(m, *idx.shape)
    vals = torch.where(live, vals, torch.full_like(vals, INT32_MIN))
    vals = torch.sort(vals.transpose(2, 3), dim=3, descending=True).values
    if groups < levels:
        vals = torch.nn.functional.pad(vals, (0, levels - groups),
                                       value=INT32_MIN)
    return vals[..., :levels].transpose(2, 3).contiguous()
