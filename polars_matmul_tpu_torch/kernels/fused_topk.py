"""Fused matmul -> metric epilogue -> top-k, on Hopper (port of
``polars_matmul_tpu.kernels.fused_topk``).

The JAX package runs one Pallas kernel (``_kernel``) whose grid walks the
corpus in order on one TPU core and carries a running top-k in VMEM.  Here
two hand-written CUDA kernels compute the same result:

- kernel A, ``csrc/fused_topk.cu`` (``fused_topk_partial``): per query
  tile and corpus split, the tiled Q.C^T, the epilogue (bias row, or
  scale and bias rows for quantized codes), the mask by select, and a
  running top-k carry per split;
- kernel B, ``csrc/topk_merge.cu`` (``topk_merge``): merges the splits'
  sorted lists into the final (m, k) result, pairs in parallel rounds
  (a small batch's rows over several blocks, ``merge_plan``).

Kernel A has five cores, the JAX kernel's precisions:

- ``"bf16x3"``: f32 corpus as bf16 [hi | lo], three bf16 products;
- ``"highest"``: f32 products;
- ``"bf16c"``: bf16-stored corpus (hi only), two products qh.c + ql.c;
- ``"int8c"``: per-row int8 codes, two products, then s = d * scale +
  bias;
- ``"int4c"``: int8 bytes each holding two signed nibbles (the layout of
  ``quantize_int4``), then as int8c.

The three stored cores stream their raw bytes through a ring of
asynchronous copies that runs across corpus tiles and decode them to bf16
as the products read them (``ring_plan`` mirrors its shared memory);
"bf16x3" streams its [hi | lo] rows through the same ring, a position's hi
and lo pieces of the same features in one stage.  At query tile 64 the
stored cores take the warpgroup consumer (``wgmma_core``, ``wg_plan``),
bf16x3 the mma.sync one.  "highest" streams its f32 rows through the same
ring into register tiles of f32 FMA (``f32_plan``).

Queries are always split hi | lo except for "highest".  Both kernels are
exact, with lowest-index-wins ties, so every ``selection`` value of
``SearchConfig`` runs them.  Kernel A's selection is its own (``selection``
by k), but for ``selection="bucket"``, which takes the port of the JAX
kernel's bucket selection where it is built (``bucket_built``: k <= 16 at
query tiles 16 and 32, 16 for "highest"; ``bucket_route`` says when
"auto" takes it too), and for ``selection="gstack"`` and ``"gpop"``, which
take the port of the JAX kernel's gstack build, its detector and its pop
finish where it is built (``gstack_built``: k <= 128 on the mma.sync ring
and the f32 walk where the stacks fit; ``gstack_route``), followed by an
exact re-walk of each split its detector flags: the same lists, bit for
bit.  Above k = 128 ``selection="gstack"`` takes it at query tile 16 on
its own geometry (``gstack_geometry``, ``gstack_big_plan``): splits no
longer than its stacks are deep where that fits, so nothing is dropped,
nothing fires and no re-walk runs; elsewhere lossy stacks with the
detector and the re-walk; elsewhere still the radix selection at its own
geometry.  It was slower than the radix selection in every cell measured
on the card (``gstack_route``).  ``selection="stack"`` and "auto" take
the port of the JAX kernel's stack selection (``stack_built``: exact
keys of windows of STACK_WINDOW tiles in per-column cells, popped into
the carry at each window's end) in the class where it was faster on the
card (``stack_route``: dense, 17 <= k <= 32, query tiles 16 and 32, the
bf16x3 and highest cores, where its tail leaves two blocks an SM).  The (m, n) score matrix never reaches
device memory: kernel A writes m * splits * k candidates.

Metric handling is the JAX package's: cosine pre-scales queries and
corpus by their inverse norms (zero-norm rows scale by 0; for int8/int4
codes the scale row carries 1/|codes| instead), euclidean selects on
2 q.c - |c|^2 and the finalize sqrt(max(|q|^2 - s, 0)) runs after the
kernels, and dot is the plain product.

Non-finite values (the rule of ``ops.reference``): a corpus row holding a
NaN or +-inf (a "bad" row) gets a NaN bias in every prepared form (int8 /
int4: zero codes, a NaN scale and a NaN scale | bias column), so each of
its scores is NaN, and kernel A's strict ``s > k-th`` drops it as it
drops every NaN: no CUDA source knows of the rule.  The plain versions
take a NaN score as -inf, which is what the kernel's carry makes of it.
A query row holding a NaN or +-inf gets (NaN, INT32_MAX) in every slot
(``select_prepared``).

Probed search (``tiles=``, the JAX kernel's ``PrefetchScalarGridSpec``
call): kernel A walks, for each query block, only the layout tiles its
list names (``tiles`` (n_query_blocks, P) int32, ascending, distinct,
``tn`` rows each), and kernel B merges as before.  The list geometry is
the JAX package's (``layout_tile_rows``, ``probe_block_rows``), so a
clustered layout and its lists mean the same rows in both packages.

The carry gate (``SearchConfig.prune``, the JAX kernel's exact tile
pruning): with it on, kernel A skips the selection of a tile in which no
row's score beats that row's current k-th value.  The split lists are
those with it off, bit for bit; ``prune_gate`` says when a config turns
it on.  The plain versions have no gate: their results are the same
either way.

Every kernel wrapper takes CUDA tensors to its kernel and CPU tensors to
its plain PyTorch version in this module; any other device raises.  Each
counts its launches in ``launches`` (kernel A on a tile list apart, as
``fused_topk_partial_tiles``, and with the gate on also as
``fused_topk_partial_gated``; kernel A also per core in
``core_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SearchConfig, resolve
from ..ops import reference
from ..ops.metrics import Metric, cosine_eps
from ..utils.profiling import annotate

INT32_MAX = reference.INT32_MAX
_NEG_INF = float("-inf")
_LANES = 128
# Feature chunk of the int4 packing above dim 4096 (the JAX package's
# K-chunk width).
_K_CHUNK = 2048
# Largest k the fused path serves, whatever the config's k_pad; beyond it
# dispatch uses the reference.
_MAX_FUSED_K = 1024
# The plain versions build their score matrices in chunks of about this
# many elements (and upcast about this many corpus values at a time).
_PLAIN_CHUNK = 1 << 26
# Kernel A's corpus tile height and the most splits kernel B merges (both
# fixed in the CUDA sources).
_TN = 64
_MAX_SPLITS = 1024
# Kernel B's fewest lists a group when a row's lists spread over blocks,
# and the most entries (rows x splits x k) a block takes when several small
# rows share one.
_MERGE_MIN_LISTS = 4
_MERGE_ROW_ENTRIES = 1024

# Kernel A's cores, in the order of the CUDA source's Core enum.
CORES = ("highest", "bf16x3", "bf16c", "int8c", "int4c")
_QUANT = ("int8c", "int4c")
# bf16x3's ring forms: 32 and 64 features a position (``ring_core``).
_HILO = ("bf16x3", "bf16x3w")
# Cores whose queries arrive as bf16 [hi | lo].
_SPLIT_QUERY = ("bf16x3", "bf16c", "int8c", "int4c")
_CORPUS_DTYPE = {"highest": torch.float32, "bf16x3": torch.bfloat16,
                 "bf16c": torch.bfloat16, "int8c": torch.int8,
                 "int4c": torch.int8}

# Launches per wrapper, for showing that a run went through the kernels.
launches = {
    "fused_topk_partial": 0,
    "fused_topk_partial_tiles": 0,
    # Kernel A's launches of the warpgroup consumer (``wgmma_core``:
    # csrc/ring_wgmma.cuh), dense or listed.
    "fused_topk_partial_wgmma": 0,
    # Kernel A's launches with the carry gate on, dense or listed.
    "fused_topk_partial_gated": 0,
    # Kernel A's launches of the radix selection (``selection``), dense or
    # listed.
    "fused_topk_partial_radix": 0,
    # Kernel A's launches of the bucket selection (``bucket_built``), dense
    # or listed.
    "fused_topk_partial_bucket": 0,
    # Kernel A's launches of the gstack selection (``gstack_built``), dense
    # or listed, each with its re-walk launch.
    "fused_topk_partial_gstack": 0,
    # Kernel A's launches of the gstack selection above APPEND_MAX_K
    # (``gstack_big_plan``), dense or listed, each with its re-walk launch
    # where the plan is lossy.
    "fused_topk_partial_gstack_bigk": 0,
    # Kernel A's launches of the stack selection (``stack_built``), dense.
    "fused_topk_partial_stack": 0,
    "topk_merge": 0,
    "fused_topk_plain": 0,
    "fused_topk_partial_plain": 0,
    "topk_merge_plain": 0,
}
# Kernel A's launches by core (each also counts in launches).
core_launches = {core: 0 for core in CORES}


def reset_launch_counts() -> None:
    for counts in (launches, core_launches):
        for key in counts:
            counts[key] = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def feature_geometry(dim: int):
    """(ck, dpp, nk): the JAX package's feature chunk width, padded width
    and chunk count (``polars_matmul_tpu.kernels.fused_topk.
    feature_geometry``).  The int4 packing is laid out in ck-wide chunks;
    the other forms here are unpadded."""
    dp = _round_up(dim, _LANES)
    ck = dp if dp <= 4096 else _K_CHUNK
    dpp = _round_up(dp, ck)
    return ck, dpp, dpp // ck


def effective_k_pad(k: int, cfg: SearchConfig) -> int:
    """The JAX kernel's carry/output width for this k: ``cfg.k_pad`` while
    k fits it, else raised in whole 128-lane groups.  Kept for the
    config's meaning; kernels A and B carry exactly k candidates."""
    return cfg.k_pad if k <= cfg.k_pad else _round_up(k, _LANES)


def max_fused_k(cfg: SearchConfig) -> int:
    """Largest k the fused path accepts: the kernels' ceiling.

    The JAX package serves max(k_pad, 1024) fused; kernels A and B hold
    at most 1024 candidates per row, so here a larger ``k_pad`` sends
    k > 1024 to the reference path, as any other unsupported problem.
    """
    del cfg
    return _MAX_FUSED_K


# ---------------------------------------------------------------------------
# Probed-search geometry: the JAX package's, so that a clustered layout and
# its tile lists cover the same rows in both packages.  Kernel A's own
# tiles (64 corpus rows, ``query_tile_rows``) are independent of these.
# ---------------------------------------------------------------------------

# The JAX kernel's VMEM budget for one grid step's working set.
_VMEM_BUDGET = 10 * 1024 * 1024


def effective_tiles(cfg: SearchConfig, k: int) -> Tuple[int, int]:
    """(block_q, block_n) the JAX package runs for this k: (128, 4096) for
    k > 16 when the config keeps its default tiling and ``auto_tile``,
    else the config's."""
    fields = SearchConfig.__dataclass_fields__
    defaults = (fields["block_q"].default, fields["block_n"].default)
    if cfg.auto_tile and k > 16 and (cfg.block_q, cfg.block_n) == defaults:
        return 128, 4096
    return cfg.block_q, cfg.block_n


def _pick_block_n(dim: int, block_q: int, block_n: int, kp: int) -> int:
    """The JAX package's corpus tile height: block_n halved (in whole 128s)
    until one grid step's working set fits _VMEM_BUDGET."""
    ck, _, nk = feature_geometry(dim)
    if nk > 1:
        block_q = min(block_q, 128)
    bn = block_n
    while bn > 128:
        tile_bytes = (
            block_q * ck * 4 * (2 if nk > 1 else 1)
            + bn * ck * 4 * 2
            + block_q * bn * 4 * 2
            + block_q * kp * 8 * 2
            + block_q * _LANES * 5 * 4
            + (block_q * bn * 4 if nk > 1 else 0)
        )
        if tile_bytes <= _VMEM_BUDGET:
            break
        bn = max(128, bn // 2 // 128 * 128)
    return max(bn, 128)


def layout_tile_rows(dim: int, cfg: SearchConfig, k: int = 1) -> int:
    """Rows of one layout tile of a clustered corpus (the JAX package's
    ``corpus_tile_rows``): 2048 at dim 256, 1024 at dim 768 under the
    default config, ``block_n`` (at least 128) under a small one."""
    bq, bn = effective_tiles(cfg, k)
    return _pick_block_n(_round_up(dim, _LANES), bq, bn,
                         effective_k_pad(k, cfg))


def probe_block_rows(m: int, dim: int, cfg: SearchConfig, k: int = 1) -> int:
    """Query rows that share one tile list (the JAX package's
    ``query_tile_rows(m, dim, cfg, k)``): ``block_q`` (256; 128 for k > 16
    or dim > 4096), or the whole batch rounded up to 8 rows if smaller."""
    bq, _ = effective_tiles(cfg, k)
    if feature_geometry(dim)[2] > 1:
        bq = min(bq, 128)
    return min(bq, _round_up(m, 8))


# ---------------------------------------------------------------------------
# Selection envelopes.  The JAX package runs an explicit "gpop", "gstack",
# "bucket", "stack" or "insert" only inside the geometry its kernel serves
# and raises outside it (``_resolve_selection``).  Kernels A + B serve every
# value alike, but the port raises where the JAX package raises, with its
# messages, on the JAX package's geometry: 128-row groups of the corpus
# padded to its tile height, and the tiles scanned.
# ---------------------------------------------------------------------------

# The JAX kernel's stack-depth ceiling for big-k (k > 128) gstack.
_BIGK_MAX_LEVELS = 32

# The three functions below are pure functions of small integers, and an
# explicit gstack at k > 128 reaches them on every request (a Python loop of
# math.comb terms, milliseconds a call): each answer is computed once.


@functools.lru_cache(maxsize=None)
def _bigk_tail(k: int, cells: int, levels: int) -> float:
    """cells * P(Binomial(k, 1/cells) >= levels): the bound on a row's
    top-k overflowing a (segment, class) stack of ``levels``."""
    p = 1.0 / cells
    tail = 0.0
    for i in range(levels, min(k, levels + 96) + 1):
        tail += math.comb(k, i) * p ** i * (1.0 - p) ** (k - i)
    return cells * tail


@functools.lru_cache(maxsize=None)
def _bigk_depth(k: int, cells: int) -> int:
    """The JAX kernel's stack depth for k > 128: the fewest levels, from
    ceil(k/128) + 1, whose overflow bound is at most 1e-7 a row."""
    lo = -(-k // _LANES) + 1
    for levels in range(lo, _BIGK_MAX_LEVELS + 1):
        if _bigk_tail(k, cells, levels) <= 1e-7:
            return levels
    return _BIGK_MAX_LEVELS


@functools.lru_cache(maxsize=None)
def _bigk_gstack_ok(k: int, total_groups: int) -> bool:
    """Whether the JAX package's big-k gstack has a stack depth whose
    overflow bound is at most 1e-6 within the level cap."""
    if k > _MAX_FUSED_K:
        return False
    n_segs = max(1, -(-total_groups // _LANES))
    cells = _LANES * n_segs if n_segs > 1 else _LANES
    levels = _bigk_depth(k, cells)
    return _bigk_tail(k, cells, levels) <= 1e-6


def check_selection(selection: str, k: int, total_groups: int,
                    use_tiles: bool, n_tiles: int, k_pad: int = 128,
                    gpt: int = 1) -> None:
    """The raising branches of the JAX package's ``_resolve_selection``
    (same arguments): ``total_groups`` 128-row groups of the padded
    corpus, ``n_tiles`` corpus tiles scanned (the list length when
    probed), ``gpt`` groups a tile.  Raises its ValueError for an explicit
    selection outside its envelope; "auto" and "extract" never raise."""
    if selection == "auto":
        return
    groups = n_tiles * gpt if use_tiles else total_groups
    segmentable = groups <= _LANES or _LANES % gpt == 0
    if k > _LANES and selection in ("bucket", "stack", "insert"):
        raise ValueError(
            f"selection={selection!r} supports k <= {_LANES}; use "
            "'auto', 'extract', or 'gstack' for larger k"
        )
    if selection == "gpop" and (
        use_tiles or total_groups > _LANES or k > 16 or k >= k_pad
    ):
        raise ValueError(
            "selection='gpop' requires a dense (non-probed) scan over at "
            f"most {_LANES * _LANES} padded corpus rows with k <= 16 and "
            f"k < k_pad (the kp-1 slot carries the detection flag); got "
            f"{total_groups} groups, k={k}, k_pad={k_pad}"
            + (" (probed)" if use_tiles else "") + " — use selection='auto'"
        )
    if selection == "gstack" and (
        not segmentable or k > _MAX_FUSED_K
        or (k > _LANES and not _bigk_gstack_ok(k, groups))
    ):
        raise ValueError(
            "selection='gstack' requires "
            f"k <= {_MAX_FUSED_K} (and a viable stack depth for this "
            f"geometry), and beyond {_LANES} scanned groups "
            f"a power-of-two corpus tile (128 %% groups-per-tile == 0); "
            f"got {groups} groups, k={k}, {gpt} groups/tile"
            + (" (probed)" if use_tiles else "") + " — use selection='auto'"
        )


def _is_f32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    return np.dtype(dtype) == np.float32


def supports(q_shape, c_shape, dtype, k: int, cfg: SearchConfig) -> bool:
    """Whether the fused kernels take this problem (else the reference).

    The same rule as the JAX package: f32 only, k up to ``max_fused_k``,
    and above ``max_fused_dim`` only where the reference path's dense
    (m, n) score matrix would exceed ``fallback_score_bytes``.
    """
    if not _is_f32(dtype):
        return False
    if k > max_fused_k(cfg):
        return False
    if q_shape[1] > cfg.max_fused_dim:
        return q_shape[0] * c_shape[0] * 4 > cfg.fallback_score_bytes
    return True


def kernel_precision(precision: str) -> str:
    """The core of kernel A a config precision runs: "default" and "high"
    run "highest" (exact f32 is inside their looser contract); every
    other precision names its own core."""
    if precision in ("highest", "high", "default"):
        return "highest"
    if precision in CORES:
        return precision
    raise ValueError(f"Unknown precision: {precision!r}")


def split_hi_lo(x: torch.Tensor) -> torch.Tensor:
    """f32 (rows, d) -> bf16 (rows, 2d) [hi | lo] with x = hi + lo.

    hi rounds to nearest in IEEE bit space (+0x8000, then clear the low
    16 bits), exactly as the JAX package's ``_split_hi_lo``, so both give
    bit-identical halves; lo = x - hi is exact in f32 and bf16-exact.
    """
    if x.dtype != torch.float32:
        raise TypeError(f"split_hi_lo takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x8000) & -65536).view(torch.float32)
    lo = x - hi
    return torch.cat([hi.to(torch.bfloat16), lo.to(torch.bfloat16)], dim=1)


# ---------------------------------------------------------------------------
# Quantized storage: per-row symmetric int8 / int4 codes.
# ---------------------------------------------------------------------------


def quantize_int8(c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: codes * scale[:, None] ~= c.

    scale = max|row| / 127 (1.0 for a zero row, so it dequantizes to
    exactly zero); codes round half to even.  A row holding NaN or +-inf
    gets codes 0 and scale NaN.  Bit-identical to the host
    ``_quantize_rows_np``, and on finite rows to the JAX package's
    ``quantize_int8``.
    """
    c = c.to(torch.float32)
    scale = _row_scale(c, 127.0)
    return _codes(torch.round(c / scale), scale), scale[:, 0].contiguous()


def _row_scale(c: torch.Tensor, top: float) -> torch.Tensor:
    """(n, 1) max|row| / top, 1.0 for a zero row, NaN for a row holding
    NaN or +-inf (its max is one of them).  The divisor is a tensor:
    PyTorch divides a CUDA tensor by a Python number as a product with
    its reciprocal, which can differ from the quotient in the last bit."""
    amax = torch.amax(torch.abs(c), dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, top),
                        torch.ones_like(amax))
    return torch.where(torch.isfinite(amax), scale, float("nan"))


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Rounded codes ``x`` as int8, zero in every row of a NaN scale (no
    float-to-int cast of NaN or of an out-of-range value, which the CPU
    wraps and the card saturates)."""
    return torch.where(torch.isnan(scale), 0.0, x).to(torch.int8)


def quantize_int4(c: torch.Tensor, ck: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int4 quantization, nibble-packed per feature chunk.

    Codes are in [-7, 7] with scale = max|row| / 7 (a row holding NaN or
    +-inf: codes 0, scale NaN).  Features are padded with zero codes to
    dpp (``feature_geometry``); in each ck-wide chunk, byte j holds
    feature j in its low nibble and feature j + ck/2 in its high nibble.
    Returns (packed (n, dpp // 2) int8, scales (n,) f32), bit-identical to
    the host ``_quantize_rows_int4_np``, and on finite rows to the JAX
    package's ``quantize_int4``.
    """
    c = c.to(torch.float32)
    scale = _row_scale(c, 7.0)
    codes = _codes(torch.clamp(torch.round(c / scale), -7, 7), scale)
    return pack_int4(codes, ck), scale[:, 0].contiguous()


def pack_int4(codes: torch.Tensor, ck: int) -> torch.Tensor:
    """(n, dim) integer codes in [-8, 7] -> (n, dpp // 2) int8 in
    ``quantize_int4``'s layout (features zero-padded to dpp)."""
    n, dim = codes.shape
    dpp = _round_up(_round_up(dim, _LANES), ck)
    codes = torch.nn.functional.pad(codes.to(torch.int16), (0, dpp - dim))
    ch = codes.reshape(n, dpp // ck, ck)
    lo = ch[:, :, : ck // 2] & 0xF
    hi = (ch[:, :, ck // 2:] & 0xF) << 4
    return (lo | hi).to(torch.int8).reshape(n, dpp // 2)


def _unpack_nibbles(packed: torch.Tensor):
    """(low, high) signed nibbles of int8 bytes, sign-extended in int8."""
    lo = ((packed & 0xF) ^ 8) - 8
    hi = (((packed >> 4) & 0xF) ^ 8) - 8
    return lo, hi


def unpack_int4(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """(rows, dim) int8 codes from ``quantize_int4``'s packed layout."""
    ck, dpp, nk = feature_geometry(dim)
    rows = packed.shape[0]
    lo, hi = _unpack_nibbles(packed.reshape(rows, nk, ck // 2))
    return torch.cat([lo, hi], dim=2).reshape(rows, dpp)[:, :dim]


def dequant_int4(packed: torch.Tensor, scales: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """Dense f32 rows from nibble-packed codes."""
    return unpack_int4(packed, dim).to(torch.float32) * scales[:, None]


def _scale_bias(code_norm: torch.Tensor, scales: torch.Tensor, metric,
                n_valid: int) -> torch.Tensor:
    """The (2, rows) scale | bias operand of int8c / int4c from each row's
    code norm: cosine scales by 1/|codes| (the dequant scale cancels),
    euclidean by the dequant scale with bias -(scale |codes|)^2, dot by
    the dequant scale.  Under every metric, a row whose dequant scale is
    NaN or +-inf (a bad row: ``quantize_int8``) gets (NaN, NaN), so its
    every score is NaN and no kernel selects it.  Rows >= n_valid get
    bias -inf; their scale stays finite, so no 0 * -inf reaches the
    epilogue."""
    metric = Metric.parse(metric)
    rows = code_norm.shape[0]
    scales = scales.to(torch.float32)
    zeros = torch.zeros_like(code_norm)
    if metric is Metric.COSINE:
        cs = torch.where(code_norm > 0, 1.0 / code_norm, zeros)
        cb = zeros
    else:
        cs = scales
        if metric is Metric.EUCLIDEAN:
            t = cs * code_norm
            cb = -(t * t)
        else:
            cb = zeros
    live = torch.arange(rows, device=code_norm.device) < n_valid
    cb = torch.where(live, cb, torch.full_like(cb, _NEG_INF))
    out = torch.stack([cs, cb], dim=0)
    return torch.where(torch.isfinite(scales), out, float("nan"))


def prepare_int8_bias(codes: torch.Tensor, scales: torch.Tensor, metric,
                      n_valid: int) -> torch.Tensor:
    """(2, rows) scale | bias for int8 codes that are the prepared corpus
    as they are (the JAX package's ``prepare_int8_bias``)."""
    codesf = codes.to(torch.float32)
    code_norm = torch.sqrt(torch.sum(codesf * codesf, dim=1))
    return _scale_bias(code_norm, scales, metric, n_valid)


def prepare_int4_bias(packed: torch.Tensor, scales: torch.Tensor, metric,
                      n_valid: int) -> torch.Tensor:
    """(2, rows) scale | bias for nibble-packed codes; the norms come
    straight from the nibbles (a sum of squares needs no feature order)."""
    lo, hi = _unpack_nibbles(packed)
    lo, hi = lo.to(torch.float32), hi.to(torch.float32)
    code_norm = torch.sqrt(torch.sum(lo * lo + hi * hi, dim=1))
    return _scale_bias(code_norm, scales, metric, n_valid)


# ---------------------------------------------------------------------------
# Operand preparation.
# ---------------------------------------------------------------------------


def _scale_rows(x: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Cosine: rows times 1/|row| (0 for norms <= eps)."""
    if metric is not Metric.COSINE:
        return x
    eps = cosine_eps(torch.float32)
    nrm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x * torch.where(nrm > eps, 1.0 / nrm, torch.zeros_like(nrm))


def prepare_queries(q: torch.Tensor, metric, precision: str) -> torch.Tensor:
    """Query prep: cosine normalises, euclidean doubles, then the hi | lo
    split for every core but "highest".  Plain torch, as the JAX package
    does it in XLA.  A query row holding NaN or +-inf is prepared as it
    comes: ``select_prepared`` voids its slots."""
    metric = Metric.parse(metric)
    q = _scale_rows(q, metric)
    if metric is Metric.EUCLIDEAN:
        q = 2.0 * q
    q = q.contiguous()
    return split_hi_lo(q) if precision in _SPLIT_QUERY else q


def prepare_corpus(c: torch.Tensor, metric, *, precision: str,
                   scales: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corpus prep for kernel A's core ``precision``: returns (cp, cbp).

    - "bf16x3": cp (n, 2*dim) bf16 [hi | lo]; "highest": (n, dim) f32;
      "bf16c": (n, dim) bf16, rounded after the metric scaling (for a
      bf16 corpus and a metric without scaling, cp is ``c`` itself).
      cbp is the (n,) f32 bias, -|c|^2 for euclidean and 0 otherwise,
      NaN for a row holding NaN or +-inf (under every metric and core).
    - "int8c" / "int4c": ``c`` is f32 (quantized here) or the int8 codes
      (packed for int4) with their ``scales``; cp is the codes, the very
      tensor given, and cbp the (2, n) scale | bias rows (NaN | NaN for a
      row whose scale is not finite).

    Nothing is padded: the kernel bounds its own edges.
    """
    metric = Metric.parse(metric)
    precision = kernel_precision(precision)
    n = c.shape[0]
    if precision in _QUANT:
        if c.dtype != torch.int8:
            if precision == "int4c":
                c, scales = quantize_int4(c, feature_geometry(c.shape[1])[0])
            else:
                c, scales = quantize_int8(c)
        elif scales is None:
            raise ValueError("int8 codes need their per-row scales=")
        bias = prepare_int4_bias if precision == "int4c" else prepare_int8_bias
        return c, bias(c, scales, metric, n)
    if c.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"prepare_corpus takes float32 or bfloat16, got "
                        f"{c.dtype}")
    keep = (precision == "bf16c" and c.dtype == torch.bfloat16
            and metric is not Metric.COSINE)
    stored = c
    bad = reference.bad_rows(c)
    # A bf16 corpus is upcast for the prep math, as in the JAX package.
    c = _scale_rows(c.to(torch.float32), metric)
    if metric is Metric.EUCLIDEAN:
        cb = -torch.sum(c * c, dim=1)
    else:
        cb = torch.zeros(n, dtype=torch.float32, device=c.device)
    cb = torch.where(bad, float("nan"), cb)
    c = c.contiguous()
    if precision == "bf16x3":
        cp = split_hi_lo(c)
    elif precision == "bf16c":
        # Unscaled bf16 rows round-trip through f32 unchanged: share them.
        cp = stored.contiguous() if keep else c.to(torch.bfloat16)
    else:
        cp = c
    return cp, cb.contiguous()


def pad_mask_row(mask, width: int) -> torch.Tensor:
    """(n,) bool mask -> (width,) uint8 with the tail past n excluded."""
    mask = torch.as_tensor(mask).to(torch.bool).reshape(-1)
    out = torch.zeros(width, dtype=torch.uint8, device=mask.device)
    out[: mask.shape[0]] = mask.to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# Plain versions: what kernels A and B compute, in PyTorch.
# ---------------------------------------------------------------------------


def _query_dim(qp: torch.Tensor, precision: str) -> int:
    return qp.shape[1] // 2 if precision in _SPLIT_QUERY else qp.shape[1]


def _plain_scores(qp, cp, precision: str) -> torch.Tensor:
    """The product of kernel A's core, with bf16 values and codes upcast
    to f32 (their products are exact) and the groups of the TPU kernel:
    qh.ch + (qh.cl + ql.ch) for bf16x3, qh.c + ql.c for the stored-corpus
    cores."""
    if precision == "highest":
        with reference.exact_matmul():
            return qp @ cp.T
    d = qp.shape[1] // 2
    qh, ql = qp[:, :d].float(), qp[:, d:].float()
    with reference.exact_matmul():
        if precision == "bf16x3":
            ch, cl = cp[:, :d].float(), cp[:, d:].float()
            return qh @ ch.T + (qh @ cl.T + ql @ ch.T)
        c = unpack_int4(cp, d) if precision == "int4c" else cp
        c = c.float()
        return qh @ c.T + ql @ c.T


def _masked_scores(qp, cp, cbp, mask, precision: str, r0: int, r1: int):
    """Epilogue scores for corpus rows [r0, r1): product, then + bias (or
    * scale + bias for int8c / int4c), then NaN and the mask by select to
    -inf (kernel A's carry takes neither)."""
    d = _plain_scores(qp, cp[r0:r1], precision)
    if precision in _QUANT:
        s = d * cbp[0, r0:r1] + cbp[1, r0:r1]
    else:
        s = d + cbp[r0:r1]
    s = torch.where(torch.isnan(s), _NEG_INF, s)
    if mask is not None:
        s = torch.where(mask[r0:r1].to(torch.bool), s,
                        torch.full_like(s, _NEG_INF))
    return s


def _plain_rows(qp) -> int:
    """Corpus rows per chunk of a plain version: about _PLAIN_CHUNK score
    entries and _PLAIN_CHUNK upcast corpus values."""
    return max(1, _PLAIN_CHUNK // max(qp.shape[0], qp.shape[1], 1))


def _finish(vals, idx, k: int):
    """Pad the last axis to k with -inf and give every -inf slot the index
    INT32_MAX (the values reach it with no NaN: the selections take NaN as
    -inf)."""
    if vals.shape[-1] < k:
        pad = k - vals.shape[-1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=_NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, pad))
    idx = torch.where(vals == _NEG_INF, torch.full_like(idx, INT32_MAX), idx)
    return vals.contiguous(), idx.to(torch.int32).contiguous()


def _listed(cp, cbp, mask, tiles_row, tn: int, precision: str):
    """The rows one tile list names, in list order: (global ids, cp, cbp,
    mask) gathered.  Rows past the corpus end, and the rows of a negative
    tile id, score -inf through their bias, as kernel A gives them."""
    n = cp.shape[0]
    gid = (tiles_row.long()[:, None] * tn
           + torch.arange(tn, device=cp.device)).reshape(-1)
    valid = (gid >= 0) & (gid < n)
    safe = torch.where(valid, gid, torch.zeros_like(gid))
    ninf = torch.full((), _NEG_INF, device=cp.device)
    if precision in _QUANT:
        cb = torch.stack([cbp[0, safe], torch.where(valid, cbp[1, safe],
                                                    ninf)])
    else:
        cb = torch.where(valid, cbp[safe], ninf)
    return gid, cp[safe], cb, None if mask is None else mask[safe]


def _per_list(fn, qp, cp, cbp, mask, precision: str, tiles, tn: int,
              block_rows: int):
    """Runs ``fn(qp rows, cp, cbp, mask)`` of a plain version per tile
    list, on the list's query rows and gathered corpus rows, and maps its
    local indices back to global ones (the gathered rows ascend with the
    list, so lowest-local-index ties are lowest-global-index ties)."""
    vals, idx = [], []
    for b in range(tiles.shape[0]):
        r0, r1 = b * block_rows, min(qp.shape[0], (b + 1) * block_rows)
        gid, cp_b, cb_b, mk_b = _listed(cp, cbp, mask, tiles[b], tn,
                                        precision)
        v, i = fn(qp[r0:r1], cp_b, cb_b, mk_b)
        g = gid[torch.clamp(i.long(), max=gid.shape[0] - 1)]
        vals.append(v)
        idx.append(torch.where(i == INT32_MAX, i, g.to(torch.int32)))
    return torch.cat(vals), torch.cat(idx)


def fused_topk_plain(qp: torch.Tensor, cp: torch.Tensor, cbp: torch.Tensor,
                     mask: Optional[torch.Tensor], k: int, precision: str,
                     tiles: Optional[torch.Tensor] = None, tn: int = 0,
                     block_rows: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernels A + B on prepared operands.

    Scores are the core's product (``_plain_scores``) through the
    epilogue, masked by select to -inf; returns the top-k by (value desc,
    index asc) with INT32_MAX wherever the value is -inf.  Builds the
    score matrix in corpus row chunks.  With ``tiles``, query rows
    [b * block_rows, (b + 1) * block_rows) see only the rows of the
    ``tn``-row tiles that list row b names.
    """
    launches["fused_topk_plain"] += 1
    if tiles is not None:
        return _per_list(
            lambda q, c, cb, mk: _topk_plain(q, c, cb, mk, k, precision),
            qp, cp, cbp, mask, precision, tiles, tn, block_rows)
    return _topk_plain(qp, cp, cbp, mask, k, precision)


def _topk_plain(qp, cp, cbp, mask, k: int, precision: str):
    m, n = qp.shape[0], cp.shape[0]
    dev = qp.device
    vals = torch.empty((m, 0), dtype=torch.float32, device=dev)
    idx = torch.empty((m, 0), dtype=torch.int64, device=dev)
    step = _plain_rows(qp)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        s = _masked_scores(qp, cp, cbp, mask, precision, r0, r1)
        cand_v = torch.cat([vals, s], dim=1)
        cand_i = torch.cat(
            [idx, torch.arange(r0, r1, device=dev).expand(m, -1)], dim=1)
        # Carry entries precede the chunk's and have lower indices, so a
        # stable sort keeps lowest-index-first among equal values.
        sv, order = torch.sort(cand_v, dim=1, descending=True, stable=True)
        vals = sv[:, :k]
        idx = torch.gather(cand_i, 1, order[:, :k])
    return _finish(vals, idx, k)


def fused_topk_partial_plain(qp, cp, cbp, mask, k: int, precision: str,
                             splits: int, tiles_per_split: int,
                             tiles: Optional[torch.Tensor] = None,
                             tn: int = 0, block_rows: int = 0):
    """Plain version of kernel A: (m, splits, k) top-k lists, split s
    covering corpus rows [s * rows, (s + 1) * rows) with rows =
    tiles_per_split * 64.  Scores whole splits, a few at a time.  With
    ``tiles``, the splits cut each list's rows (in list order) instead of
    the corpus, as ``fused_topk_plain`` reads them."""
    launches["fused_topk_partial_plain"] += 1
    if tiles is not None:
        return _per_list(
            lambda q, c, cb, mk: _partial_plain(q, c, cb, mk, k, precision,
                                                splits, tiles_per_split),
            qp, cp, cbp, mask, precision, tiles, tn, block_rows)
    return _partial_plain(qp, cp, cbp, mask, k, precision, splits,
                          tiles_per_split)


def _partial_plain(qp, cp, cbp, mask, k: int, precision: str, splits: int,
                   tiles_per_split: int):
    m, n = qp.shape[0], cp.shape[0]
    rows = tiles_per_split * _TN
    per = max(1, _plain_rows(qp) // rows)
    vals, idx = [], []
    for s0 in range(0, splits, per):
        s1 = min(splits, s0 + per)
        r1 = min(n, s1 * rows)
        r0 = min(s0 * rows, r1)
        s = _masked_scores(qp, cp, cbp, mask, precision, r0, r1)
        s = torch.nn.functional.pad(s, (0, (s1 - s0) * rows - (r1 - r0)),
                                    value=_NEG_INF)
        sv, order = torch.sort(s.reshape(m, s1 - s0, rows), dim=2,
                               descending=True, stable=True)
        base = torch.arange(s0, s1, device=qp.device)[None, :, None] * rows
        vals.append(sv[..., :k])
        idx.append(order[..., :k] + base)
    return _finish(torch.cat(vals, dim=1), torch.cat(idx, dim=1), k)


def topk_merge_plain(part_v: torch.Tensor, part_i: torch.Tensor, k: int):
    """Plain version of kernel B: top-k of the union of the split lists,
    ordered by the keys kernel B compares, (value desc, index asc), with
    INT32_MAX as the index of every -inf value.  A NaN value counts as
    -inf (kernel A never writes one).  The lists' indices need not ascend
    from list to list (the ring merge of sharded search hands it lists in
    visiting order).
    """
    launches["topk_merge_plain"] += 1
    m = part_v.shape[0]
    return _finish(*reference.topk_two_key(
        part_v.reshape(m, -1), part_i.reshape(m, -1), k), k)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def query_tile_rows(m: int, k: int) -> int:
    """Kernel A's query tile (16, 32 or 64 rows).  The carry takes
    tm * k * 8 bytes of shared memory, so the tile narrows as k grows
    (k=1024 -> 16 rows, 128 KB); a small batch takes the smallest tile
    that holds it, since rows past m are computed and thrown away."""
    by_k = 64 if k <= 128 else 32 if k <= 256 else 16
    by_m = 16 if m <= 16 else 32 if m <= 32 else 64
    return min(by_k, by_m)


def launch_geometry(m: int, n: int, k: int, sm_count: int,
                    blocks_per_sm: int = 2, tm: Optional[int] = None):
    """(tm, splits, tiles_per_split): enough blocks to give every SM
    ``blocks_per_sm``, no empty split, and at most _MAX_SPLITS lists for
    kernel B.  ``n`` is the rows a block may walk (a tile list's rows
    when kernel A walks one); ``tm`` defaults to ``query_tile_rows``."""
    tm = tm or query_tile_rows(m, k)
    grid_m = -(-m // tm)
    n_tiles = -(-n // _TN)
    want = max(1, -(-blocks_per_sm * sm_count // grid_m))
    splits = max(1, min(n_tiles, want, _MAX_SPLITS))
    tps = -(-n_tiles // splits)
    return tm, -(-n_tiles // tps), tps


# (device index, tm, k, core, listed, c_ld) -> blocks of kernel A one SM
# holds.
_occupancy = {}


@functools.lru_cache(maxsize=None)
def device_sms(device: torch.device) -> int:
    """The SMs of a CUDA ``device`` (cached: get_device_properties takes
    microseconds, and every request asks)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_geometry(m: int, n: int, k: int, precision: str,
                    device: torch.device, tm: Optional[int] = None,
                    listed: bool = False, *, dim: int):
    """The ``launch_geometry`` kernel A runs with on a CUDA ``device``:
    as many blocks as its SMs hold at once.  ``listed``: the
    instantiation that walks tile lists; ``dim``: the queries' features
    (a stored core's shared memory grows with them where its query tile
    stays resident)."""
    tm = tm or query_tile_rows(m, k)
    c_ld = _corpus_width(precision, dim)
    key = (device.index, tm, k, precision, listed, c_ld)
    if key not in _occupancy:
        from ._build import load_library

        with torch.cuda.device(device):
            blocks = load_library().pmm_fused_topk_blocks_per_sm(
                tm, k, CORES.index(precision), int(listed), c_ld)
        if blocks <= 0:
            raise RuntimeError(f"kernel A cannot run tm={tm} k={k} "
                               f"{precision}: error {blocks}")
        _occupancy[key] = blocks
    return launch_geometry(m, n, k, device_sms(device), _occupancy[key], tm)


# The H100's shared memory: a block's most, an SM's, and what each
# resident block reserves of it.
MAX_SMEM, _SMEM_PER_SM, _SMEM_PER_BLOCK = 232448, 233472, 1024


def _odd_units(nbytes: int, unit: int) -> int:
    """A row stride of an odd number of ``unit`` bytes (conflict-free
    fragment loads)."""
    return nbytes if (nbytes // unit) % 2 else nbytes + unit


def _packed(precision: str) -> bool:
    return precision.startswith("int4")


def ring_row_bytes(tm: int, precision: str) -> int:
    """Corpus bytes a row that one stage of the ring holds
    (``csrc/tile_scores.cuh``, ``ring_walk``): 256 at a 16-row query tile
    (int4: 128); taller ones carry their query columns in the stage and
    hold 32 (tm 32) or 16 (tm 64) bytes of int8, twice that of bf16, half
    of int4.  bf16x3 holds 32 features (4 bytes each, hi and lo), its
    wide form "bf16x3w" 64 (``ring_core``)."""
    if precision in _HILO:
        return 256 if precision == "bf16x3w" else 128
    if tm == 16:
        return 128 if _packed(precision) else 256
    per = 4 if precision == "bf16c" else 1 if _packed(precision) else 2
    return per * (32 if tm == 32 else 16)


def ring_stages(tm: int, precision: str) -> int:
    """The most stages of the ring: 4 at tm 16, 3 at tm 32, 2 at tm 64;
    4 at every tile for bf16x3."""
    return 4 if tm == 16 or precision in _HILO else 3 if tm == 32 else 2


def ring_cols(tm: int, precision: str) -> int:
    """Query columns (features) one position of the ring meets."""
    rb = ring_row_bytes(tm, precision)
    if precision in _HILO:
        return rb // 4
    return rb // 2 if precision == "bf16c" else (
        2 * rb if _packed(precision) else rb)


def ring_staging(tm: int, precision: str, c_ld: int, resident: bool,
                 stages: int):
    """(bytes a stage, staging bytes) of the ring of ``stages`` at query
    tile ``tm`` for corpus rows of ``c_ld`` elements (bf16 for bf16c and
    bf16x3's [hi | lo], bytes for int8 and the int4 forms): 64 corpus rows
    a stage, each with the query columns they meet unless the query tile
    is ``resident`` after the ring.  Rows are an odd number of 32-byte
    units apart for bf16c's 8-byte fragment loads, of 16-byte units for
    int8's 4-byte loads and bf16x3's 16-byte ldmatrix rows."""
    rb, cols = ring_row_bytes(tm, precision), ring_cols(tm, precision)
    elem = 2 if precision == "bf16c" or precision in _HILO else 1
    unit = 32 if precision == "bf16c" else 16
    chunks = -(-c_ld * elem // rb)

    def query(c):   # hi and lo rows of c bf16 columns
        return 2 * tm * _odd_units(2 * c, 16 if precision in _HILO else 32)

    stage = _TN * _odd_units(rb, unit) + (0 if resident else query(cols))
    return stage, stages * stage + (query(chunks * cols) if resident else 0)


def ring_plan(tm: int, precision: str, c_ld: int, rest: int):
    """(stages, bytes a stage, query resident, shared memory) of a stored
    core beside ``rest`` bytes of other shared memory (``ring_plan`` in
    the source): two blocks an SM where any plan keeps them, then the most
    stages, then the query tile resident where it fits (never at tm 64);
    stages 0 where no plan fits."""
    best, best_key = (0, 0, False, 0), -1
    for resident in ((False,) if tm == 64 else (True, False)):
        for stages in range(ring_stages(tm, precision), 1, -1):
            stage, staging = ring_staging(tm, precision, c_ld, resident,
                                          stages)
            nbytes = staging + rest
            if nbytes > MAX_SMEM:
                continue
            blocks = _SMEM_PER_SM // (nbytes + _SMEM_PER_BLOCK)
            key = 100 * min(blocks, 2) + 10 * stages + resident
            if key > best_key:
                best, best_key = (stages, stage, resident, nbytes), key
    return best


def tail_bytes(tm: int, k: int) -> int:
    """Kernel A's shared memory after its staging: the score tile, the
    carry, the merge lists (the mma.sync consumer's; the warpgroup
    consumer's is ``wg_tail_bytes``)."""
    return tm * (_TN + 1) * 4 + 2 * tm * k * 4 + 2 * 8 * _TN * 4


# Kernel A's selection (``csrc/fused_topk.cu``): k up to INSERT_MAX_K
# inserts each candidate into the row's sorted carry; k up to APPEND_MAX_K
# appends the candidates to a slack of ``slack_entries(k)`` entries a row
# (kept in the block's own k output slots) and compacts the slack into the
# carry when a tile's candidates do not fit, and at the end of the split;
# a larger k appends them to an unsorted buffer of ``radix_buffer(k)``
# entries (k in the carry's shared memory, k in the output slots) whose
# threshold a radix select on RADIX_BITS-bit digits raises when a tile's
# candidates do not fit, and sorts the k survivors at the split's end.
# The warpgroup consumer (``wgmma_core``) keeps the slack above k = 16.
INSERT_MAX_K, APPEND_MAX_K, SLACK_MAX, RADIX_BITS = 16, 128, 192, 7


def selection(k: int) -> str:
    """Kernel A's selection at k (``selection`` in the source; the
    warpgroup consumer appends where this says "radix")."""
    return ("insert" if k <= INSERT_MAX_K else
            "append" if k <= APPEND_MAX_K else "radix")


# Kernel A's bucket selection (the JAX kernel's ``_select_bucket``): per
# (query row, lane class) cells of the best two in registers, an overflow
# of ``bucket_overflow(tm)`` entries a row in the merge lists' place,
# windows that end when the overflow cannot take a tile's pushes, merged
# by k extraction steps (the JAX kernel's ``_merge_narrow``).  Built at
# k <= INSERT_MAX_K on the mma.sync ring at query tiles up to
# BUCKET_MAX_TM and on the f32 walk ("highest") at 16 (the cells take
# 4 tm / 8 registers a thread; ptxas spilled beyond).
BUCKET_MAX_TM, BUCKET_OVERFLOW = 32, 32


def bucket_built(tm: int, precision: str, k: int) -> bool:
    """Whether a launch of kernel A that asks for the bucket selection
    takes it (``pmm_fused_topk_bucket`` in the source); elsewhere it keeps
    ``selection(k)``."""
    top = 16 if precision == "highest" else BUCKET_MAX_TM
    return (k <= INSERT_MAX_K and tm <= top
            and not wgmma_core(tm, precision))


def bucket_overflow(tm: int) -> int:
    """Overflow entries a row of the bucket selection: the warp's 64 merge
    list entries shared by its tm / 8 rows, at most BUCKET_OVERFLOW (the
    merge reads one a lane)."""
    return min(_TN // (tm // 8), BUCKET_OVERFLOW)


def bucket_route(selection_cfg: str, k: int, tm: int, listed: bool,
                 precision: str) -> bool:
    """Whether kernel A is asked for the bucket selection, by (k, query
    tile, listed, core): always under ``selection="bucket"``; under "auto"
    nowhere, since on an NVIDIA H100 80GB HBM3 at 700 W no such class of
    cells showed it faster than the insertion beyond the spread
    (``ab_kernel_a.py --bucket --rounds 3``: 1 of 31 cells in each of two
    runs, a different one each time; 5-8 % slower in the bf16x3 core at
    query tile 16 on the canonical shape: PERF.md §6); every other value
    keeps ``selection(k)``.  The launch takes it where ``bucket_built``."""
    del k, tm, listed, precision   # "auto" takes it in no class measured
    return selection_cfg == "bucket"


# Kernel A's gstack selection (the JAX kernel's gstack build with its
# detector and pop finish, ``_gstack_update`` / ``_gstack_decode`` /
# ``_gpop_finish``): each (query row, column of the 64-column tile) cell
# keeps its best ``gstack_levels`` keys across the block's split, sorted,
# in shared memory; a score enters if it beats the row's bound (the k-th
# best entry of levels 0 .. (k - 1) // 64 of the row's cells) and then its
# cell's deepest entry; at the split's end k pops of the best cell head
# write the
# list, and a row fires when a pop takes a cell's deepest entry.  A block
# with a fired row is walked again by the exact selection's launch that
# follows on the same grid.  The depth keeps the union bound on a launch's
# fire probability (GSTACK_BLOCKS blocks: two an SM of an H100, the
# launches ``kernel_geometry`` makes) at most GSTACK_FIRE, up to
# GSTACK_MAX_LEVELS.
GSTACK_CELLS, GSTACK_MAX_LEVELS, GSTACK_FIRE = _TN, 16, 0.05
GSTACK_BLOCKS = 264


def gstack_fire_bound(k: int, tm: int, levels: int) -> float:
    """GSTACK_BLOCKS tm C(k, levels) / 64^(levels - 1): the union bound,
    over a launch's blocks, a block's tm rows and a row's 64 cells, on
    some cell holding ``levels`` of a row's top-k (uniformly spread
    winners), which a fire needs (``gstack_fire_bound`` in the source, the
    same arithmetic)."""
    b = float(GSTACK_BLOCKS) * tm
    for i in range(levels):
        b = b * (k - i) / (i + 1)
        if i > 0:
            b /= GSTACK_CELLS
        if b <= 0.0:
            return 0.0
    return b


def gstack_levels(k: int, tm: int) -> int:
    """The gstack selection's stack depth at k and query tile tm
    (``gstack_levels`` in the source).  A launch's expected cost is its
    build, about one level's work a level, plus the chance that any of
    its blocks fires times one exact walk of a split (the re-walk: the
    blocks run in one wave, so re-walking even one adds a whole split's
    walk; on an NVIDIA H100 80GB HBM3 at 700 W, 2M x 256 batch 8 k=10
    with two of 263 blocks fired took 1.41 against the insertion's
    0.82 ms, PERF.md §6); a further level saves less than it costs once
    the fire bound is under a level's share of the walk, taken as
    GSTACK_FIRE (kernel D's levels cost +0.01 to +0.24 ms over its
    product, PERF.md).  So: the least depth, from one below the bound's
    level up, whose ``gstack_fire_bound`` is at most GSTACK_FIRE, i.e. at
    most 5 % of the launches re-walk on uniformly spread data (k=10: 6
    levels at query tiles 16 to 64, bounds 0.08 / 0.17 / 0.33 %; k=16: 6;
    k=100: 13 at tile 16)."""
    levels = (k - 1) // GSTACK_CELLS + 2
    while (levels < GSTACK_MAX_LEVELS
           and gstack_fire_bound(k, tm, levels) > GSTACK_FIRE):
        levels += 1
    return levels


def gstack_tail_bytes(tm: int, levels: int) -> int:
    """The gstack instantiation's shared memory after its staging: the
    score tile, each row's bound, each row's 64 x levels 8-byte keys."""
    return tm * (_TN + 1) * 4 + tm * 4 + tm * GSTACK_CELLS * levels * 8


def gstack_built(tm: int, precision: str, k: int,
                 tps: Optional[int] = None) -> bool:
    """Whether a launch of kernel A that asks for the gstack selection
    takes it: k <= APPEND_MAX_K (``pmm_fused_topk_gstack`` in the source)
    on the mma.sync ring (bf16x3 on its 32-feature ring) and the f32 walk,
    where the stacks fit beside the ring's least plan (two stages, the
    query tile riding them); never on the warpgroup consumer (its 254-255
    registers; its four score tiles and three levels for 64 rows leave too
    little for its ring).  Above APPEND_MAX_K the split's ``tps`` tiles
    decide (``gstack_big_plan``; without them, False: the form of k <=
    APPEND_MAX_K is not built there).  Elsewhere the launch keeps
    ``selection(k)``."""
    if k > APPEND_MAX_K:
        return tps is not None and gstack_big_plan(tm, precision, k, tps)[1]
    if k < 1 or wgmma_core(tm, precision):
        return False
    return (_least_ring(tm, precision)
            + gstack_tail_bytes(tm, gstack_levels(k, tm)) <= MAX_SMEM)


def _least_ring(tm: int, precision: str) -> int:
    """The ring's least plan: two stages, the query tile riding them
    (bf16x3's 32-feature ring)."""
    return 2 * (f32_stage_bytes(tm, False) if precision == "highest"
                else ring_staging(tm, precision, 1, False, 2)[0])


def gstack_plan(tm: int, precision: str, c_ld: int, k: int):
    """(stages, bytes a stage, query resident, shared memory) of the
    gstack instantiation's ring beside its stacks (``gstack_plan`` in the
    source; bf16x3's 64-feature ring wherever that keeps two blocks an
    SM)."""
    rest = gstack_tail_bytes(tm, gstack_levels(k, tm))
    if precision == "highest":
        return f32_plan(tm, c_ld, k, rest=rest)
    return ring_plan(tm, ring_core(tm, precision, c_ld, k, rest), c_ld, rest)


def gstack_route(selection_cfg: str, k: int, tm: int, listed: bool,
                 precision: str) -> bool:
    """Whether kernel A is asked for the gstack selection, by (k, query
    tile, listed, core): always under ``selection="gstack"`` and
    ``"gpop"`` (the JAX package's gpop is its gstack build with an
    in-kernel pop finish, which this one always has); every other value
    keeps ``selection(k)``.  The launch takes it where ``gstack_built``.

    "auto" takes it nowhere: on an NVIDIA H100 80GB HBM3 at 700 W it was
    slower than the insertion or the slack beyond the spread in every
    cell where it is built (``ab_kernel_a.py --gstack --groups gstack
    --rounds 2``, medians of four turns, PERF.md §6): canonical bf16x3
    k=10 at query tiles 32 / 16 +70.7 / +38.2 %, k=100 at 16 +110 %;
    highest k=10 at 32 / 16 +45.2 / +12.3 %, k=100 at 16 +74.7 %; 2M x
    256 batch 8 k=10 / 100 +17.7 / +140 % (0.9203 against 0.7817 ms);
    10M x 768 int8 batch 8 k=10 +43.7 %; 2M x 256 clustered lists of 32
    queries k=10 +60.6 %.  Its stacks take the shared memory the ring's
    stages or a second block an SM would have, and more scores reach a
    cell than beat the insertion's k-th value.

    Above k = 128 "auto" takes it nowhere either: against the radix
    selection at its own geometry, kernel A alone and with kernel B
    (``ab_kernel_a.py --gstack --groups gstack-big --rounds 2``, medians of
    four turns, PERF.md §6), its lossless plans on two blocks an SM
    (``gstack_geometry``) were +8.5 % (canonical bf16x3 k=129) to +87 %
    (k=512: 1.3369 against 0.7134 ms), its lossy plan at 2M x 256 batch 8
    k=256 1.85 x, and the 2M x 256 clustered lists of 32 queries at k=256
    2.05 x.  So ``selection="gstack"`` asked for explicitly above k = 128
    is slower than the radix selection the parent ran for it.  The radix
    selection appends a candidate where the gstack shifts it into a sorted
    cell, and the gstack's finish pops k keys a row and split."""
    del k, tm, listed, precision
    return selection_cfg in ("gstack", "gpop")


def _gstack_walk(s: torch.Tensor, k: int, tps: int, levels: int):
    """The gstack walk of S splits of epilogue scores ``s`` (m, S, tps *
    64), NaN as -inf, columns in walk order: (values, indices within the
    split, fired) with fired (m, S) bool.  Above APPEND_MAX_K the form of
    ``gstack_big_tile`` / ``gstack_big_finish``: the bound is the weakest
    entry of level (k - 1) // 64 over the row's cells, and a row fires only
    where a pop takes the deepest entry of a lost cell (one that met a
    score beating the bound while full)."""
    m, S, _ = s.shape
    dev = s.device
    big = k > APPEND_MAX_K
    lvl = (k - 1) // GSTACK_CELLS
    stacks = torch.full((m, S, levels, _TN), EMPTY_KEY, dtype=torch.int64,
                        device=dev)
    lost = torch.zeros((m, S, _TN), dtype=torch.bool, device=dev)
    bound = torch.full((m, S), _NEG_INF, dtype=torch.float32, device=dev)
    col = torch.arange(_TN, dtype=torch.int32, device=dev)
    for t in range(tps):
        x = s[:, :, t * _TN:(t + 1) * _TN]
        keys = select_keys(x, (t * _TN + col).expand(m, S, _TN))
        beats = x > bound[..., None]
        lost |= beats & (stacks[:, :, -1] != EMPTY_KEY)
        put = beats & (keys > stacks[:, :, -1])
        if not bool(put.any()):
            continue
        both = torch.cat([stacks, torch.where(put, keys, EMPTY_KEY)[:, :, None]],
                         dim=2)
        stacks = torch.sort(both, dim=2, descending=True).values[:, :, :levels]
        if big:
            kth = stacks[:, :, lvl].amin(-1)
        else:
            kth = torch.sort(stacks[:, :, :lvl + 1].reshape(m, S, -1), dim=2,
                             descending=True).values[..., k - 1]
        bound = torch.where(put.any(-1), key_values(kth), bound)
    top = torch.sort(stacks.reshape(m, S, levels * _TN), dim=2,
                     descending=True).values[..., :k]
    deep = stacks[:, :, -1]
    popped = (deep != EMPTY_KEY) & (deep >= top[..., -1:])
    fired = (popped & lost if big else popped).any(-1)
    return key_values(top), key_indices(top), fired


def _walk_dense(walk, qp, cp, cbp, mask, k: int, precision: str,
                splits: int, tiles_per_split: int):
    """``walk(s, k, tiles_per_split)`` over the splits of a dense scan,
    about _PLAIN_CHUNK scores of them at once (each split's tiles walked
    together), scored in ``_plain_rows`` chunks.  ``walk`` takes (m, S,
    tps * 64) scores and returns (m, S, k) values and indices within the
    split, then any (m, S) tensors more (``_gstack_walk``'s fired), each
    of which is returned whole after the values and the indices."""
    m, n = qp.shape[0], cp.shape[0]
    rows = tiles_per_split * _TN
    per = max(1, _PLAIN_CHUNK // max(1, m * rows))
    step = _plain_rows(qp)
    vals, idx, more = [], [], []
    for s0 in range(0, splits, per):
        s1 = min(splits, s0 + per)
        r1 = min(n, s1 * rows)
        r0 = min(s0 * rows, r1)
        s = torch.cat([_masked_scores(qp, cp, cbp, mask, precision, a,
                                      min(r1, a + step))
                       for a in range(r0, r1, step)] or [
            torch.empty((m, 0), device=qp.device)], dim=1)
        s = torch.nn.functional.pad(s, (0, (s1 - s0) * rows - (r1 - r0)),
                                    value=_NEG_INF)
        v, i, *rest = walk(s.reshape(m, s1 - s0, rows), k, tiles_per_split)
        base = torch.arange(s0, s1, device=qp.device)[None, :, None] * rows
        vals.append(v)
        idx.append(torch.where(i == INT32_MAX, i, i + base.to(torch.int32)))
        more.append(rest)
    return (torch.cat(vals, 1), torch.cat(idx, 1),
            *(torch.cat(x, 1) for x in zip(*more)))


def gstack_partial_plain(qp, cp, cbp, mask, k: int, precision: str,
                         splits: int, tiles_per_split: int, tm: int,
                         tiles: Optional[torch.Tensor] = None, tn: int = 0,
                         block_rows: int = 0):
    """Plain version of kernel A's gstack walk before its re-walk:
    (part_v, part_i, fired), the split lists its pop finish writes and the
    (m, splits) rows its detector fires on.  Wherever a row does not
    fire, its list is ``fused_topk_partial_plain``'s; the re-walk rewrites
    the splits of every block (tm query rows) with a fired row.  Walks
    whole splits, a few at a time; with ``tiles``, each list's rows, as
    ``fused_topk_partial_plain`` reads them.  Above APPEND_MAX_K the depth
    is ``gstack_big_plan``'s at ``tiles_per_split``."""
    levels = (gstack_big_plan(tm, precision, k, tiles_per_split)[0]
              if k > APPEND_MAX_K else gstack_levels(k, tm))
    def walk(s, k_, tps):
        return _gstack_walk(s, k_, tps, levels)

    if tiles is None:
        return _walk_dense(walk, qp, cp, cbp, mask, k, precision, splits,
                           tiles_per_split)
    vals, idx, fired = [], [], []
    for b in range(tiles.shape[0]):
        r0, r1 = b * block_rows, min(qp.shape[0], (b + 1) * block_rows)
        gid, cp_b, cb_b, mk_b = _listed(cp, cbp, mask, tiles[b], tn,
                                        precision)
        v, i, f = _walk_dense(walk, qp[r0:r1], cp_b, cb_b, mk_b, k,
                              precision, splits, tiles_per_split)
        g = gid[torch.clamp(i.long(), max=gid.shape[0] - 1)]
        vals.append(v)
        idx.append(torch.where(i == INT32_MAX, i, g.to(torch.int32)))
        fired.append(f)
    return torch.cat(vals), torch.cat(idx), torch.cat(fired)


def gstack_fires(fired: torch.Tensor, tm: int) -> Tuple[int, int]:
    """The gstack counter's {rows fired, blocks fired} of ``fired`` (m,
    splits): a block is a split of tm query rows."""
    m, splits = fired.shape
    pad = torch.nn.functional.pad(fired, (0, 0, 0, -m % tm))
    blocks = pad.reshape(-1, tm, splits).any(1)
    return int(fired.sum()), int(blocks.sum())


# Kernel A's stack selection (the JAX kernel's ``_select_stack`` and its
# ``_stack_geometry``): a window of STACK_WINDOW consecutive tiles of a
# split stands for one JAX tile; each (query row, column of the 64-column
# tile) cell keeps the window's exact keys that beat the row's bound (the
# carry's k-th value when the window began); at the window's end the
# cells' entries that enter the carry are popped and merged into it, so
# the carry is the exact top k of carry and window.  A cell meets one score
# a tile, so cells STACK_WINDOW deep never drop a candidate: nothing is
# detected and nothing is walked again.  Its instantiations (dense, query
# tiles 16 and 32, the bf16x3 and highest cores) are compiled in
# ``csrc/fused_topk_stack.cu``.  The window (4 tiles) and the class
# ``stack_route`` takes it in were chosen by measurement on the card
# (PERF.md §6).
STACK_WINDOW = 4
# The stack's class: dense scans at STACK_MIN_K <= k <= STACK_MAX_K, query
# tiles up to STACK_MAX_TM, the "bf16x3" and "highest" cores, where its
# tail leaves two blocks an SM.  Its instantiations are the class's query
# tiles and cores.
STACK_MIN_K, STACK_MAX_K, STACK_MAX_TM = 17, 32, 32
STACK_CORES = ("bf16x3", "highest")


def stack_tail_bytes(tm: int, k: int) -> int:
    """The stack instantiation's shared memory after its staging: the
    score tile, each row's bound and 17 state words (whether the window
    put any, 64 count bytes), each row's carry of k 8-byte keys, each
    row's 64 x STACK_WINDOW keys, each warp's 2k keys of merge scratch."""
    return (tm * (_TN + 1) * 4 + tm * 4 + tm * (1 + GSTACK_CELLS // 4) * 4
            + tm * k * 8 + tm * GSTACK_CELLS * STACK_WINDOW * 8
            + 8 * 2 * k * 8)


def stack_built(tm: int, precision: str, k: int) -> bool:
    """Whether a dense launch that asks for the stack selection takes it
    (``pmm_fused_topk_stack`` in the source): k <= APPEND_MAX_K at query
    tiles 16 and 32 on the bf16x3 core's mma.sync ring and the highest
    core's f32 walk, where the tail fits beside the ring's least plan."""
    if (not 1 <= k <= APPEND_MAX_K or tm not in (16, STACK_MAX_TM)
            or precision not in STACK_CORES):
        return False
    return _least_ring(tm, precision) + stack_tail_bytes(tm, k) <= MAX_SMEM


def stack_two_blocks(tm: int, precision: str, k: int) -> bool:
    """Whether the stack instantiation's least plan (its tail beside a
    two-stage ring) leaves room for two blocks an SM, as kernel A's own
    selection keeps."""
    nbytes = _least_ring(tm, precision) + stack_tail_bytes(tm, k)
    return _SMEM_PER_SM // (nbytes + _SMEM_PER_BLOCK) >= 2


def stack_route(selection_cfg: str, k: int, tm: int, listed: bool,
                precision: str) -> bool:
    """Whether kernel A is asked for the stack selection, by (k, query
    tile, listed, core): under ``selection="stack"`` and "auto" in its
    class (dense, STACK_MIN_K <= k <= STACK_MAX_K, where ``stack_built``
    and ``stack_two_blocks``); every other value, and both outside the
    class, keep ``selection(k)``.

    On an NVIDIA H100 80GB HBM3 at 700 W (``ab_kernel_a.py --stack
    --groups stack --rounds 2``, medians of four turns, PERF.md §6),
    windows of 4 tiles were faster than the slack beyond the spread in
    that class at the canonical operands: k=17 / 24 / 32 at query tiles 16
    and 32 -15 % to -30 %; at 2M x 256 batch 8 (bytes-bound) within the
    spread or a few per cent faster.  Where the stack's tail costs the
    second block an SM it lost (bf16x3 at query tile 32, k=32: canonical
    +6.1 %, 2M x 256 batch 32 +33 %), and outside the class it was slower
    or level: canonical k=64 to 128 up to +92 %, 10M x 768 int8 batch 8
    k=32 / 100 +32 / +41 %, the 2M x 256 clustered lists at k=100 +6 % to
    +91 %.  So an explicit "stack" outside the class runs the slack, as
    before."""
    return (selection_cfg in ("stack", "auto") and not listed
            and STACK_MIN_K <= k <= STACK_MAX_K
            and stack_built(tm, precision, k)
            and stack_two_blocks(tm, precision, k))


def _stack_walk(s: torch.Tensor, k: int, tps: int):
    """The stack walk of S splits of epilogue scores ``s`` (m, S, tps *
    64), NaN as -inf, columns in walk order: (values, indices within the
    split), the form of ``stack_tile`` / ``stack_window_end``: each
    window's candidates beat the carry's k-th value, and the carry becomes
    the top k of carry and candidates (the cells hold them all)."""
    m, S, _ = s.shape
    dev = s.device
    carry = torch.full((m, S, k), EMPTY_KEY, dtype=torch.int64, device=dev)
    for t0 in range(0, tps, STACK_WINDOW):
        x = s[:, :, t0 * _TN:(t0 + STACK_WINDOW) * _TN]
        col = torch.arange(t0 * _TN, t0 * _TN + x.shape[2],
                           dtype=torch.int32, device=dev)
        cand = x > key_values(carry[..., -1])[..., None]
        if not bool(cand.any()):
            continue
        keys = torch.where(cand, select_keys(x, col.expand(m, S, -1)),
                           EMPTY_KEY)
        carry = torch.sort(torch.cat([carry, keys], 2), dim=2,
                           descending=True).values[..., :k]
    return key_values(carry), key_indices(carry)


def stack_partial_plain(qp, cp, cbp, mask, k: int, precision: str,
                        splits: int, tiles_per_split: int):
    """Plain version of kernel A's stack walk of a dense scan: (part_v,
    part_i), the split lists it writes, window by window.  Its cells are
    lossless, so they are ``fused_topk_partial_plain``'s bit for bit."""
    return _walk_dense(_stack_walk, qp, cp, cbp, mask, k, precision, splits,
                       tiles_per_split)


# Kernel A's gstack selection above APPEND_MAX_K (the JAX kernel's big-k
# gstack, ``_bigk_depth`` / ``_gstack_update`` / ``_gstack_decode`` /
# ``_chunked_top_k``), at query tile GSTACK_BIG_TM: a cell (a row's column
# of the 64-column tile) sees one score a tile, so stacks at least as deep
# as the split is long never drop one.  ``gstack_geometry`` cuts the splits
# to that depth where the raised grid stays within GSTACK_WAVES waves of
# two blocks an SM; ``gstack_big_plan`` then takes it (lossless: nothing
# fires and no re-walk is launched), or else the least depth whose
# ``gstack_fire_bound`` is at most GSTACK_FIRE (lossy, with the detector
# and the re-walk), up to GSTACK_BIG_MAX_LEVELS (the JAX kernel's cap),
# where its 8-byte keys fit beside the ring's least plan.  The row's bound
# is the weakest entry of level (k - 1) // 64 over its cells; a row fires
# only where a pop takes the deepest entry of a cell that met a score
# beating the bound while full.
GSTACK_BIG_TM, GSTACK_BIG_MAX_LEVELS = 16, 32
GSTACK_WAVES = 4


def gstack_big_tail_bytes(tm: int, levels: int) -> int:
    """The shared memory after the staging above APPEND_MAX_K: the score
    tile, each row's bound, its 64 x ``levels`` 8-byte keys, its 64 cell
    states (``gstack_big_tail_bytes`` in the source)."""
    return (tm * (_TN + 1) * 4 + tm * 4 + tm * GSTACK_CELLS * levels * 8
            + tm * GSTACK_CELLS)


def gstack_big_plan(tm: int, precision: str, k: int, tps: int
                    ) -> Tuple[int, bool]:
    """(levels, built) of the gstack selection above APPEND_MAX_K at query
    tile ``tm`` and splits of ``tps`` tiles (``gstack_big_plan`` in the
    source): levels = max(tps, (k - 1) // 64 + 1), lossless, where that is
    at most GSTACK_BIG_MAX_LEVELS; else the least depth from (k - 1) // 64
    + 1 whose fire bound is at most GSTACK_FIRE (searched up to twice the
    cap).  Built at GSTACK_BIG_TM, k <= _MAX_FUSED_K, within the cap, where
    the stacks fit beside the ring's least plan.  Not built: the depth it
    wanted."""
    least = (k - 1) // GSTACK_CELLS + 1
    levels = max(tps, least)
    if levels > GSTACK_BIG_MAX_LEVELS:
        levels = least
        while (levels < 2 * GSTACK_BIG_MAX_LEVELS
               and gstack_fire_bound(k, tm, levels) > GSTACK_FIRE):
            levels += 1
    ok = (APPEND_MAX_K < k <= _MAX_FUSED_K and tm == GSTACK_BIG_TM
          and not wgmma_core(tm, precision)
          and levels <= GSTACK_BIG_MAX_LEVELS)
    return levels, ok and gstack_big_bytes(tm, precision, levels) <= MAX_SMEM


def gstack_big_bytes(tm: int, precision: str, levels: int) -> int:
    """The stacks' tail of ``levels`` beside the ring's least plan, in
    bytes (what the source's ``pmm_fused_topk_gstack_big`` reports of a
    plan, built or not)."""
    return _least_ring(tm, precision) + gstack_big_tail_bytes(tm, levels)


def gstack_big_ring(tm: int, precision: str, c_ld: int, k: int, tps: int):
    """(stages, bytes a stage, query resident, shared memory) of the ring
    beside the stacks of ``gstack_big_plan`` (``gstack_big_ring`` in the
    source)."""
    rest = gstack_big_tail_bytes(tm, gstack_big_plan(tm, precision, k,
                                                     tps)[0])
    if precision == "highest":
        return f32_plan(tm, c_ld, k, rest=rest)
    return ring_plan(tm, ring_core(tm, precision, c_ld, k, rest), c_ld, rest)


def gstack_deepest(precision: str, k: int) -> int:
    """The deepest lossless stacks at GSTACK_BIG_TM, up to
    GSTACK_BIG_MAX_LEVELS, whose keys beside the ring's least plan leave
    two blocks an SM (kernel A's bound); 0 where not even (k - 1) // 64 + 1
    levels do."""
    for levels in range(GSTACK_BIG_MAX_LEVELS, (k - 1) // GSTACK_CELLS, -1):
        nbytes = gstack_big_bytes(GSTACK_BIG_TM, precision, levels)
        if _SMEM_PER_SM // (nbytes + _SMEM_PER_BLOCK) >= 2:
            return levels
    return 0


def gstack_geometry(m: int, n: int, k: int, precision: str, sm_count: int
                    ) -> Optional[Tuple[int, int, int]]:
    """(tm, splits, tiles_per_split) of kernel A asked for the gstack
    selection above APPEND_MAX_K over ``n`` rows (a tile list's when it
    walks one), or None where it is not built there: query tile
    GSTACK_BIG_TM; ``launch_geometry``'s splits at two blocks an SM raised
    to splits no longer than ``gstack_deepest`` (lossless) where the grid
    then runs in at most GSTACK_WAVES waves, and then to fill its last wave
    (shorter splits for the same waves): on an NVIDIA H100 80GB HBM3 at
    700 W these shallow stacks (10 levels in bf16x3 and highest) beat
    deeper ones at one block an SM at canonical k = 129 to 512 (0.6331
    against 0.8721 ms at k=129 bf16x3, PERF.md §6).  The finish pops k keys
    a row and split, so more waves of short splits pay it more often; past
    that ``launch_geometry``'s splits at one block an SM, whose stacks are
    lossy, where ``gstack_big_plan`` builds them."""
    tm = GSTACK_BIG_TM
    grid_m, n_tiles = -(-m // tm), -(-n // _TN)
    top = min(n_tiles, _MAX_SPLITS)
    deepest = gstack_deepest(precision, k)
    if deepest:
        _, splits, _ = launch_geometry(m, n, k, sm_count, 2, tm)
        slots = 2 * sm_count
        lossless = min(top, max(splits, -(-n_tiles // deepest)))
        if (-(-n_tiles // lossless) <= deepest
                and grid_m * lossless <= GSTACK_WAVES * slots):
            waves = -(-grid_m * lossless // slots)
            splits = max(lossless, min(top, waves * slots // grid_m))
            tps = -(-n_tiles // splits)
            return tm, -(-n_tiles // tps), tps
    _, splits, tps = launch_geometry(m, n, k, sm_count, 1, tm)
    return ((tm, splits, tps) if gstack_big_plan(tm, precision, k, tps)[1]
            else None)


def radix_buffer(k: int) -> int:
    """Entries a row of the radix selection buffers before a select: 2k,
    the carry's k places in shared memory and the row's k output slots."""
    return 2 * k


def compact_lanes(tm: int, precision: str) -> int:
    """Keys a lane of one compaction batch of kernel A (``compact_lanes``
    in the source): 4 (batches of 128 keys), 2 for the int4 core at query
    tile 32."""
    return 2 if precision == "int4c" and tm == 32 else 4


def slack_entries(k: int) -> int:
    """Slack entries a row of kernel A's appending selection: with a
    tile's 64 scores they fill 256 keys (k >= SLACK_MAX) or 128 (k >= 64),
    else the row's k output slots."""
    return SLACK_MAX if k >= SLACK_MAX else 64 if k >= 64 else k


_HI = 1 << 32


def select_keys(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Kernel A's order keys (``sel_key`` in the source) of f32 ``values``
    and int32 ``indices``, the greater the better: the high word the
    value's orderable bits with -0.0 taken as +0.0, the low word ~(2 index
    + [the value is -0.0]).  Returned as int64 less 2^63, so that int64
    order is the keys' unsigned order."""
    u = values.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & (_HI - 1)
    nz = u == 0x80000000
    u = torch.where(nz, torch.zeros_like(u), u)
    hi = torch.where(u >= 0x80000000, ~u & (_HI - 1), u | 0x80000000)
    lo = ~(2 * indices.to(torch.int64) + nz.to(torch.int64)) & (_HI - 1)
    return (hi - (1 << 31)) * _HI + lo


def key_values(keys: torch.Tensor) -> torch.Tensor:
    """The f32 values of ``select_keys`` keys, -0.0 included."""
    hi = (keys >> 32) + (1 << 31)
    lo = keys & (_HI - 1)
    u = torch.where(hi >= 0x80000000, hi & 0x7FFFFFFF, ~hi & (_HI - 1))
    u = torch.where((u == 0) & (lo & 1 == 0), torch.full_like(u, 0x80000000),
                    u)
    return u.to(torch.int32).view(torch.float32)


def key_indices(keys: torch.Tensor) -> torch.Tensor:
    """The int32 indices of ``select_keys`` keys."""
    return ((~(keys & (_HI - 1)) & (_HI - 1)) >> 1).to(torch.int32)


# The key of an empty slot (-inf, INT32_MAX), below every real key.
EMPTY_KEY = (0x007FFFFF - (1 << 31)) * _HI + 1


# Kernel A's warpgroup consumer (``csrc/ring_wgmma.cuh``): a ring filled
# by TMA loads, WG_TILES kernel tiles a step (WG_TPW for each of two
# warpgroups), one query box of 64 rows x 16 bf16 a k16 step, hi and lo, at
# most WG_STAGES stages, each 1024-byte aligned, a full and an empty
# mbarrier each, one block an SM.
WG_TM, WG_TPW, WG_STAGES = 64, 2, 8
WG_TILES = 2 * WG_TPW
WG_ALIGN, WG_BOX = 1024, 64 * 32


def wgmma_core(tm: int, precision: str) -> bool:
    """Whether kernel A's launch takes the warpgroup consumer
    (``wgmma_core`` in the source): the stored cores at query tile 64
    (bf16x3 keeps the mma.sync ring there, chosen by measurement)."""
    return precision in ("bf16c", "int8c", "int4c") and tm == WG_TM


def wg_cols(precision: str) -> int:
    """Query columns one stage meets: 64, bf16c 32 (its rows then take a
    swizzle's 64 bytes, and two of its stages at 64 columns would not fit
    beside the tallest carry, k = 128)."""
    return 32 if precision == "bf16c" else 64


def wg_row_bytes(precision: str) -> int:
    """Corpus bytes a row of one stage, its box width and its pitch in
    the stage: 2 a column for bf16c, 1 for int8, half for int4."""
    cols = wg_cols(precision)
    return 2 * cols if precision == "bf16c" else (
        cols // 2 if _packed(precision) else cols)


def wg_swizzle(span: int, row, byte):
    """Where byte ``byte`` of row ``row`` of a box with ``span``-byte rows
    (32, 64, 128) lands as a 2-D load with that span's swizzle writes it
    (``wg_swizzle`` in the source): the box's bytes in order, each 16-byte
    piece's index XORed with bits 7 and up of its offset."""
    return row * span + (byte ^ ((((row * span) >> 7) & (span // 16 - 1))
                                 << 4))


def wg_stage_bytes(precision: str) -> int:
    """The step's 256 corpus rows at their box pitch, then a hi and a lo
    query box (64 rows x 32 bytes) a k16 step."""
    return (WG_TILES * _TN * wg_row_bytes(precision)
            + 2 * (wg_cols(precision) // 16) * WG_BOX)


def wg_ring_bytes(precision: str, stages: int) -> int:
    """A ring of ``stages`` stages in shared memory (``wg_ring_bytes``):
    room to align its first stage to 1024 bytes, the stages, then a full
    and an empty mbarrier (8 bytes) for each of the most stages."""
    return WG_ALIGN + stages * wg_stage_bytes(precision) + 2 * WG_STAGES * 8


def wg_tail_bytes(k: int) -> int:
    """After the ring: a score tile a kernel tile of the step, the carry,
    the merge lists."""
    return (WG_TILES * WG_TM * (_TN + 1) * 4 + 2 * WG_TM * k * 4
            + 2 * 8 * _TN * 4)


def wg_plan(precision: str, k: int):
    """(stages, bytes a stage, query resident, shared memory) of the
    warpgroup consumer's ring (``wg_plan`` in the source): the most
    stages that fit beside the tail; the query tile is never resident;
    stages 0 where none fits."""
    stage = wg_stage_bytes(precision)
    for stages in range(WG_STAGES, 1, -1):
        nbytes = wg_ring_bytes(precision, stages) + wg_tail_bytes(k)
        if nbytes <= MAX_SMEM:
            return stages, stage, False, nbytes
    return 0, 0, False, 0


def wg_feature(precision: str, kc: int, col: int, ck: int) -> int:
    """The feature query column ``col`` of ring chunk ``kc`` holds
    (``wg_feature`` in the source): in order for bf16c and int8; for int4
    each 16 stored bytes meet 32 columns, their low nibbles' features then
    their high ones' (byte j of a ck-wide chunk holds feature j low and
    j + ck/2 high).  Column 16 s is where k16 step s's query box starts."""
    if not _packed(precision):
        return kc * wg_cols(precision) + col
    b, half = kc * wg_row_bytes(precision) + (col // 32) * 16, ck // 2
    t, w = b // half, col % 32
    return t * ck + (b - t * half) + (half + w - 16 if w >= 16 else w)


# Kernel A's highest core (``fused_topk_f32_kernel``): the ring carries
# raw f32 corpus rows, a step of 4096 / tm of them (4 x 4 scores a thread),
# at most F32_STAGES stages, two blocks an SM at most.
F32_STAGES = 4


def f32_step_rows(tm: int) -> int:
    """Corpus rows the f32 core scores a step: 4096 pairs a query tile."""
    return 4096 // tm


def f32_cols(tm: int) -> int:
    """Features a position of the f32 ring holds (``ring_row_bytes`` / 4
    in the source): 32 at tm 64, 16 at 32, 8 at 16."""
    return tm // 2


def f32_stage_bytes(tm: int, resident: bool) -> int:
    """The step's corpus rows, then, when the query tile rides, its rows
    of the same features; each row an odd number of 16-byte units."""
    rows = f32_step_rows(tm) + (0 if resident else tm)
    return rows * _odd_units(4 * f32_cols(tm), 16)


def f32_query_stride(tm: int, dim: int) -> int:
    """Bytes of a resident query row: every position's features."""
    cols = f32_cols(tm)
    return _odd_units(4 * cols * -(-dim // cols), 16)


def f32_plan(tm: int, dim: int, k: int, rest: Optional[int] = None):
    """(stages, bytes a stage, query resident, shared memory) of the f32
    ring (``f32_plan`` in the source) beside ``rest`` bytes of the
    selection's (``tail_bytes`` at k by default): the most blocks an SM
    (two at most), then the query tile resident wherever that keeps them,
    then the most stages; stages 0 where no plan fits."""
    rest = tail_bytes(tm, k) if rest is None else rest
    best, best_key = (0, 0, False, 0), -1
    for resident in (True, False):
        for stages in range(F32_STAGES, 1, -1):
            stage = f32_stage_bytes(tm, resident)
            nbytes = (stages * stage + rest
                      + (tm * f32_query_stride(tm, dim) if resident else 0))
            if nbytes > MAX_SMEM:
                continue
            blocks = _SMEM_PER_SM // (nbytes + _SMEM_PER_BLOCK)
            key = 100 * min(blocks, 2) + 10 * resident + stages
            if key > best_key:
                best, best_key = (stages, stage, resident, nbytes), key
    return best


def ring_core(tm: int, precision: str, c_ld: int, k: int,
              rest: Optional[int] = None) -> str:
    """The ring a launch streams beside ``rest`` bytes of its selection's
    (``tail_bytes`` at k by default; ``ring_core_beside`` in the source):
    bf16x3 takes 64 features a position ("bf16x3w") at query tiles 16 and
    64 wherever that ring keeps two blocks an SM, else 32; the other cores
    their own."""
    if precision == "bf16x3" and tm != 32:
        wide = ring_plan(tm, "bf16x3w", c_ld,
                         tail_bytes(tm, k) if rest is None else rest)
        if wide[0] and _SMEM_PER_SM // (wide[3] + _SMEM_PER_BLOCK) >= 2:
            return "bf16x3w"
    return precision


def stage_plan(tm: int, precision: str, c_ld: int, k: int):
    """Kernel A's staging (``pmm_fused_topk_ring``): the f32 ring of
    "highest" (``c_ld`` its dim); for the other cores the warpgroup
    consumer's ring where ``wgmma_core``, the mma.sync consumer's
    otherwise (bf16x3's of ``ring_core``)."""
    if precision == "highest":
        return f32_plan(tm, c_ld, k)
    if wgmma_core(tm, precision):
        return wg_plan(precision, k)
    return ring_plan(tm, ring_core(tm, precision, c_ld, k), c_ld,
                     tail_bytes(tm, k))


def prune_gate(prune: str) -> bool:
    """Whether kernel A runs with the carry gate: only under ``prune``
    "on".  "auto" is off on the card: there the gate was slower than off
    in 3 of the 12 cells where the JAX package's rule (16 or more corpus
    tiles, fused_topk.py:1995) turns it on (config.py and PERF.md give
    the times)."""
    return prune == "on"


def listed_tile_rows(m: int, k: int, block_rows: int) -> int:
    """Kernel A's query tile on a tile list: no taller than the rows that
    share a list."""
    return query_tile_rows(min(m, block_rows), k)


def _corpus_width(precision: str, dim: int) -> int:
    if precision == "bf16x3":
        return 2 * dim
    if precision == "int4c":
        return feature_geometry(dim)[1] // 2
    return dim


def _check_operands(qp, cp, cbp, mask, k: int, precision: str):
    if precision not in CORES:
        raise ValueError(f"no kernel core {precision!r}; cores: {CORES}")
    dev = qp.device
    for name, t in (("cp", cp), ("cbp", cbp)) + (
            (("mask", mask),) if mask is not None else ()):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
    want_q = torch.bfloat16 if precision in _SPLIT_QUERY else torch.float32
    want_c = _CORPUS_DTYPE[precision]
    if qp.dtype != want_q or cp.dtype != want_c:
        raise TypeError(f"precision={precision!r} takes {want_q} queries and "
                        f"a {want_c} corpus, got {qp.dtype} and {cp.dtype}")
    if precision in _SPLIT_QUERY and qp.ndim == 2 and qp.shape[1] % 2:
        raise ValueError(f"{precision} queries carry [hi | lo]: even width")
    if (qp.ndim != 2 or cp.ndim != 2 or cp.shape[1]
            != _corpus_width(precision, _query_dim(qp, precision))):
        raise ValueError(f"bad operand shapes {tuple(qp.shape)} and "
                         f"{tuple(cp.shape)} for precision={precision!r}")
    n = cp.shape[0]
    want_b = (2, n) if precision in _QUANT else (n,)
    if cbp.dtype != torch.float32 or tuple(cbp.shape) != want_b:
        raise ValueError(f"cbp must be {want_b} float32")
    if mask is not None and (mask.dtype != torch.uint8
                             or tuple(mask.shape) != (n,)):
        raise ValueError(f"mask must be ({n},) uint8")
    if not 1 <= k <= _MAX_FUSED_K:
        raise ValueError(f"k={k} outside [1, {_MAX_FUSED_K}]")
    for name, t in (("qp", qp), ("cp", cp), ("cbp", cbp), ("mask", mask)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_tiles(qp, tiles, tn: int, block_rows: int, tm: int) -> None:
    """A tile list kernel A can walk: (n_lists, P) int32 on the queries'
    device, ``tn`` a whole number of kernel tiles, every query row on a
    list, and, with several lists, whole query tiles per list."""
    if (tiles.dtype != torch.int32 or tiles.ndim != 2
            or tiles.shape[1] < 1 or tiles.device != qp.device
            or not tiles.is_contiguous()):
        raise ValueError("tiles must be a contiguous (n_lists, P >= 1) "
                         "int32 tensor on the queries' device")
    if tn <= 0 or tn % _TN:
        raise ValueError(f"tn={tn} must be a positive multiple of {_TN}")
    n_lists, m = tiles.shape[0], qp.shape[0]
    if block_rows <= 0 or not (n_lists - 1) * block_rows < m <= (
            n_lists * block_rows):
        raise ValueError(f"{n_lists} tile lists of {block_rows} query rows "
                         f"do not cover {m} queries")
    if n_lists > 1 and block_rows % tm:
        raise ValueError(f"block_rows={block_rows} is not a whole number of "
                         f"{tm}-row query tiles")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def fused_topk_partial(qp, cp, cbp, mask, k: int, precision: str,
                       splits: int, tiles_per_split: int, tm: int,
                       tiles: Optional[torch.Tensor] = None, tn: int = 0,
                       block_rows: int = 0, prune: bool = False,
                       gate_count: Optional[torch.Tensor] = None,
                       bucket: bool = False,
                       bucket_count: Optional[torch.Tensor] = None,
                       gstack: bool = False,
                       gstack_count: Optional[torch.Tensor] = None,
                       stack: bool = False):
    """Kernel A: (m, splits, k) f32 values and int32 indices.

    With ``tiles`` (n_lists, P), query rows [b * block_rows, (b + 1) *
    block_rows) walk only the ``tn``-row layout tiles that list row b
    names, in list order (ascending, distinct: then the splits cover
    ascending rows and kernel B's ties stay lowest-index first), and the
    splits cut the P * tn listed rows.

    ``prune`` runs the kernel with the carry gate on (the same lists, bit
    for bit).  ``gate_count``, a (2,) int32 tensor on the card, gains
    {tiles gated, tiles skipped} of a gated launch.  ``bucket`` asks for
    the bucket selection, which the launch takes where ``bucket_built``
    (the same lists, bit for bit); ``bucket_count``, a (2,) int32 tensor
    on the card, gains {windows ended, overflow entries} of such a launch.
    ``gstack`` asks for the gstack selection, which the launch takes where
    ``gstack_built`` (then a second launch walks again, exactly, the
    splits its detector flagged: the same lists, bit for bit; none after
    a lossless plan above APPEND_MAX_K, which cannot fire);
    ``gstack_count``, a (2,) int32 tensor on the card, gains {rows fired,
    blocks fired} of such a launch (a row: a query row's split; a block:
    a split of a query tile, which the second launch walks again).
    ``stack`` asks for the stack selection, which a dense launch takes
    where ``stack_built`` (the same lists, bit for bit, in one launch).
    On the CPU all seven change nothing."""
    _check_operands(qp, cp, cbp, mask, k, precision)
    if bucket and gstack:
        raise ValueError("ask for the bucket or the gstack selection, not "
                         "both")
    if stack and (bucket or gstack):
        raise ValueError("ask for the stack selection or another, not both")
    for name, count in (("gate_count", gate_count),
                        ("bucket_count", bucket_count),
                        ("gstack_count", gstack_count)):
        if count is not None and (
                count.dtype != torch.int32 or count.numel() != 2
                or count.device != qp.device or not count.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (2,) int32 "
                             "tensor on the queries' device")
    listed = tiles is not None
    if listed:
        _check_tiles(qp, tiles, tn, block_rows, tm)
    rows = tiles.shape[1] * tn if listed else cp.shape[0]
    if splits * tiles_per_split * _TN < rows:
        raise ValueError(f"{splits} splits of {tiles_per_split} tiles do "
                         f"not cover {rows} rows")
    if qp.device.type == "cpu":
        return fused_topk_partial_plain(qp, cp, cbp, mask, k, precision,
                                        splits, tiles_per_split, tiles, tn,
                                        block_rows)
    if qp.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {qp.device}")
    from ._build import load_library

    lib = load_library()
    m, n = qp.shape[0], cp.shape[0]
    dim = _query_dim(qp, precision)
    ck = feature_geometry(dim)[0] if precision == "int4c" else 0
    scale, bias = (cbp[0], cbp[1]) if precision in _QUANT else (None, cbp)
    n_lists, p = tuple(tiles.shape) if listed else (0, 0)
    part_v = torch.empty((m, splits, k), dtype=torch.float32,
                         device=qp.device)
    part_i = torch.empty((m, splits, k), dtype=torch.int32, device=qp.device)
    gstack = gstack and gstack_built(tm, precision, k, tiles_per_split)
    stack = stack and not listed and stack_built(tm, precision, k)
    # The gstack's block flags, one a (query tile, split), written by its
    # launch and read by the re-walk.
    flags = (torch.empty((-(-m // tm) * splits,), dtype=torch.int32,
                         device=qp.device) if gstack else None)
    alt, count = ((_ALT_GSTACK, gstack_count) if gstack
                  else (_ALT_STACK, None) if stack
                  else (_ALT_BUCKET, bucket_count) if bucket else (0, None))
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pmm_fused_topk_partial(
            _ptr(qp), _ptr(cp), _ptr(scale), _ptr(bias), _ptr(mask),
            _ptr(tiles), _ptr(part_v), _ptr(part_i), m, n, dim, cp.shape[1],
            ck, k, splits, tiles_per_split, tm, CORES.index(precision),
            n_lists, p, tn, block_rows, int(prune), _ptr(gate_count),
            alt, _ptr(count), _ptr(flags), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_topk_partial launch failed: error {rc}")
    launches["fused_topk_partial_tiles" if listed
             else "fused_topk_partial"] += 1
    if prune:
        launches["fused_topk_partial_gated"] += 1
    if wgmma_core(tm, precision):
        launches["fused_topk_partial_wgmma"] += 1
    elif gstack and k > APPEND_MAX_K:
        launches["fused_topk_partial_gstack_bigk"] += 1
    elif selection(k) == "radix":
        launches["fused_topk_partial_radix"] += 1
    elif bucket and bucket_built(tm, precision, k):
        launches["fused_topk_partial_bucket"] += 1
    elif gstack:
        launches["fused_topk_partial_gstack"] += 1
    elif stack:
        launches["fused_topk_partial_stack"] += 1
    core_launches[precision] += 1
    return part_v, part_i


# ``pmm_fused_topk_partial``'s alt: the source's Selection values of the
# bucket, the gstack and the stack selections.
_ALT_BUCKET, _ALT_GSTACK, _ALT_STACK = 3, 4, 6


@functools.lru_cache(maxsize=None)
def merge_plan(m: int, splits: int, k: int, sm_count: int
               ) -> Tuple[int, int]:
    """Kernel B's launch shape (csrc/topk_merge.cu): (blocks a query row,
    query rows a block), one of the two 1.

    k=1 takes one warp a row.  When the rows alone give about half the SMs
    a block, a block takes a row, or several rows of few entries (up to
    _MERGE_ROW_ENTRIES) as long as the blocks still give every SM two.
    Below that a row's lists split into groups of about sqrt(splits)
    lists, at least four, and few enough that the batch's groups stay
    within two blocks an SM: the groups run side by side, then the row's
    last block merges the group lists, so the two steps cost about the
    same.  No group is empty."""
    if k == 1:
        return 1, 1
    if 2 * m < sm_count and splits >= 2 * _MERGE_MIN_LISTS:
        per = max(_MERGE_MIN_LISTS, math.isqrt(splits - 1) + 1,
                  -(-splits // (2 * sm_count // m)))
        return -(-splits // per), 1
    return 1, max(1, min(_MERGE_ROW_ENTRIES // (splits * k),
                         m // (2 * sm_count)))


def merge_scratch_ints(m: int, groups: int, k: int) -> int:
    """int32 words of kernel B's scratch for ``groups`` blocks a row: the
    rows' arrival counters (rounded up to 16 bytes), then each group
    list's values and indices."""
    return _round_up(m, 4) + 2 * m * groups * k


def topk_merge(part_v: torch.Tensor, part_i: torch.Tensor, k: int):
    """Kernel B: (m, k) f32 values and int32 indices from the splits.  The
    kernel takes at most _MAX_SPLITS lists of k <= 4096 a row and refuses
    more (error -1)."""
    if (part_v.ndim != 3 or part_v.shape != part_i.shape
            or part_v.shape[2] != k or part_v.dtype != torch.float32
            or part_i.dtype != torch.int32 or part_v.device != part_i.device
            or not part_v.is_contiguous() or not part_i.is_contiguous()):
        raise ValueError("topk_merge takes contiguous (m, splits, k) f32 "
                         "values and int32 indices on one device")
    device = part_v.device
    if device.type == "cpu":
        return topk_merge_plain(part_v, part_i, k)
    if device.type != "cuda":
        raise RuntimeError(f"no kernel for device {device}")
    from ._build import load_library

    lib = load_library()
    m, splits = part_v.shape[0], part_v.shape[1]
    groups, rows = merge_plan(m, splits, k, device_sms(device))
    vals = torch.empty((m, k), dtype=torch.float32, device=device)
    idx = torch.empty((m, k), dtype=torch.int32, device=device)
    # Entering the device's context costs microseconds; skip it where the
    # device is current already.
    with (contextlib.nullcontext() if device.index == torch.cuda.
          current_device() else torch.cuda.device(device)):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        args = (_ptr(part_v), _ptr(part_i), _ptr(vals), _ptr(idx))
        if groups == rows == 1:
            rc = lib.pmm_topk_merge(*args, m, splits, k, stream)
        else:
            scratch = (torch.empty(merge_scratch_ints(m, groups, k),
                                   dtype=torch.int32, device=device)
                       if groups > 1 else None)
            rc = lib.pmm_topk_merge_plan(*args, _ptr(scratch), m, splits,
                                         k, groups, rows, stream)
    if rc != 0:
        raise RuntimeError(f"topk_merge launch failed: error {rc}")
    launches["topk_merge"] += 1
    return vals, idx


def _padded_rows(m: int, lists: int, block_rows: int, tm: int) -> int:
    """The query rows ``fused_select`` walks ``lists`` tile lists of
    ``block_rows`` rows each with at query tile ``tm``: each list's rows
    padded to a whole tile where there are several lists."""
    return (lists * _round_up(block_rows, tm) if lists > 1 and block_rows % tm
            else m)


def fused_select(qp, cp, cbp, mask, k: int, precision: str,
                 tiles: Optional[torch.Tensor] = None, tn: int = 0,
                 block_rows: int = 0, prune: bool = False,
                 selection: str = "auto"):
    """Top-k on prepared operands: kernels A + B for CUDA tensors, the
    plain version for CPU tensors, and an error for any other device.
    ``tiles`` / ``tn`` / ``block_rows``: the tile lists of probed search
    (see ``fused_topk_partial``); ``prune``: kernel A's carry gate;
    ``selection``: the config's, which ``bucket_route``,
    ``gstack_route`` and ``stack_route`` turn into kernel A's route at the
    launch's query tile (the stack's class is dense: a probed scan never
    takes it)."""
    _check_operands(qp, cp, cbp, mask, k, precision)
    m = qp.shape[0]
    if m == 0:
        return (torch.empty((0, k), device=qp.device),
                torch.empty((0, k), dtype=torch.int32, device=qp.device))
    if tiles is not None:
        _check_tiles(qp, tiles, tn, block_rows, 1)
    if qp.device.type == "cpu":
        return fused_topk_plain(qp, cp, cbp, mask, k, precision, tiles, tn,
                                block_rows)
    if qp.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {qp.device}")
    # Above APPEND_MAX_K the gstack runs at its own geometry where it is
    # built there; elsewhere the launch is the radix selection's at its own.
    big = k > APPEND_MAX_K and gstack_route(
        selection, k, GSTACK_BIG_TM, tiles is not None, precision)
    if tiles is None:
        geo = (gstack_geometry(m, cp.shape[0], k, precision,
                               device_sms(qp.device)) if big else None)
        tm, splits, tps = geo or kernel_geometry(
            m, cp.shape[0], k, precision, qp.device,
            dim=_query_dim(qp, precision))
        part_v, part_i = fused_topk_partial(
            qp, cp, cbp, mask, k, precision, splits, tps, tm, prune=prune,
            bucket=bucket_route(selection, k, tm, False, precision),
            gstack=gstack_route(selection, k, tm, False, precision)
            and (k <= APPEND_MAX_K or geo is not None),
            stack=stack_route(selection, k, tm, False, precision))
        return topk_merge(part_v, part_i, k)
    n_rows = tiles.shape[1] * tn
    geo = (gstack_geometry(_padded_rows(m, tiles.shape[0], block_rows,
                                        GSTACK_BIG_TM), n_rows, k,
                           precision, device_sms(qp.device)) if big else None)
    tm = GSTACK_BIG_TM if geo else listed_tile_rows(m, k, block_rows)
    rows = None
    if tiles.shape[0] > 1 and block_rows % tm:
        # Lists of fewer rows than a query tile (a small block_q): give each
        # list's rows a whole tile, padded with zero rows, and take the
        # real rows back after the merge.
        br = _round_up(block_rows, tm)
        rows = (torch.arange(m, device=qp.device) // block_rows * br
                + torch.arange(m, device=qp.device) % block_rows)
        padded = qp.new_zeros((tiles.shape[0] * br, qp.shape[1]))
        padded[rows] = qp
        qp, block_rows = padded, br
    tm, splits, tps = geo or kernel_geometry(
        qp.shape[0], n_rows, k, precision, qp.device, tm, listed=True,
        dim=_query_dim(qp, precision))
    part_v, part_i = fused_topk_partial(
        qp, cp, cbp, mask, k, precision, splits, tps, tm, tiles, tn,
        block_rows, prune=prune,
        bucket=bucket_route(selection, k, tm, True, precision),
        gstack=gstack_route(selection, k, tm, True, precision)
        and (k <= APPEND_MAX_K or geo is not None))
    vals, idx = topk_merge(part_v, part_i, k)
    return (vals, idx) if rows is None else (vals[rows], idx[rows])


# ---------------------------------------------------------------------------
# Dispatch.
# ---------------------------------------------------------------------------


def _finalize(q: torch.Tensor, vals: torch.Tensor, metric: Metric):
    """Euclidean: the kernels select on 2 q.c - |c|^2; recover the distance
    sqrt(max(|q|^2 - s, 0)).  A -inf sentinel becomes +inf whatever |q|^2
    is, and a NaN value (a voided query's) stays NaN."""
    if metric is not Metric.EUCLIDEAN:
        return vals
    qsq = torch.sum(q * q, dim=1, keepdim=True)
    dist = torch.sqrt(torch.clamp(qsq - vals, min=0.0))
    return torch.where(vals == _NEG_INF, float("inf"), dist)


def fused_topk_prepared(q: torch.Tensor, cp: torch.Tensor, cbp: torch.Tensor,
                        k: int, metric, *, mask=None,
                        config: Optional[SearchConfig] = None,
                        precision: Optional[str] = None,
                        tiles=None, tn: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``q`` against a corpus prepared by ``prepare_corpus``.

    Returns ((m, k) f32 scores best first, (m, k) int32 indices).  The
    core is ``precision``, else the config's; the prepared form must be
    that core's (bf16c and bf16x3 are both bf16, int8c and int4c both
    int8, so the dtype alone cannot tell).

    ``tiles`` (n_query_blocks, P) int32 opts into probed search: each
    block of ``probe_block_rows(m, dim, config, k)`` queries scans only
    its listed layout tiles of ``tn`` rows (default ``layout_tile_rows``;
    ascending, distinct, each below ceil(n / tn)).  Exact over the visited
    rows; slots a query cannot fill carry (-inf, INT32_MAX).

    Without ``tiles``, ``tn`` is the JAX package's corpus tile height for
    this call (default ``layout_tile_rows``, what its ``Corpus`` pads
    to); it sizes only the selection envelope (``check_selection``), which
    raises the JAX package's ValueError for an explicit selection outside
    it, dense and probed alike.
    """
    if q.dtype != torch.float32:
        # Half-precision queries: upcast on the device, so the kernels and
        # the euclidean finalize run f32.
        q = q.float()
    vals, idx = select_prepared(q, cp, cbp, k, metric, mask=mask,
                                config=config, precision=precision,
                                tiles=tiles, tn=tn)
    return _finalize(q, vals, Metric.parse(metric)), idx


def select_prepared(q: torch.Tensor, cp: torch.Tensor, cbp: torch.Tensor,
                    k: int, metric, *, mask=None,
                    config: Optional[SearchConfig] = None,
                    precision: Optional[str] = None,
                    tiles=None, tn: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_topk_prepared`` without the euclidean finalize: the
    kernels' own scores, higher is better (2 q.c - |c|^2 for euclidean),
    best first, -inf where a slot is unfilled, (NaN, INT32_MAX) in every
    slot of a query row holding NaN or +-inf.  Lists of these merge
    exactly by (score desc, index asc) before one finalize, which is how
    sharded search merges its shards."""
    cfg = resolve(config)
    metric = Metric.parse(metric)
    if k > max_fused_k(cfg):
        raise ValueError(
            f"k={k} exceeds the fused path's ceiling "
            f"{max_fused_k(cfg)}; "
            "use the unprepared/fallback path")
    precision = kernel_precision(cfg.precision if precision is None
                                 else precision)
    if cp.dtype != _CORPUS_DTYPE[precision]:
        raise ValueError(
            f"corpus was prepared as {cp.dtype}; precision {precision!r} "
            f"takes {_CORPUS_DTYPE[precision]}")
    if q.dtype != torch.float32:
        q = q.float()
    m, dim = q.shape
    tn = tn or layout_tile_rows(dim, cfg, k)
    n_layout = -(-cbp.shape[-1] // tn)
    block_rows = 0
    if tiles is not None:
        tiles = torch.as_tensor(tiles, device=q.device).to(
            torch.int32).contiguous()
        if tiles.shape[1] > n_layout:
            raise ValueError(
                f"tiles lists {tiles.shape[1]} tiles per query block; the "
                f"prepared corpus only has {n_layout} (repeating a tile "
                "would duplicate its rows in the result)")
        block_rows = probe_block_rows(m, dim, cfg, k)
        if tiles.shape[0] != -(-m // block_rows):
            raise ValueError(
                f"tiles has {tiles.shape[0]} rows; this problem runs "
                f"{-(-m // block_rows)} query blocks of {block_rows} rows")
    check_selection(cfg.selection, k, n_layout * tn // _LANES,
                    tiles is not None,
                    n_layout if tiles is None else tiles.shape[1],
                    effective_k_pad(k, cfg), tn // _LANES)
    qp = prepare_queries(q, metric, precision)
    mask_u8 = None if mask is None else pad_mask_row(
        torch.as_tensor(mask, device=q.device), cbp.shape[-1])
    prune = prune_gate(cfg.prune)
    with annotate(f"pmm.fused_topk.{metric.value}"):
        vals, idx = fused_select(qp, cp, cbp, mask_u8, k, precision, tiles,
                                 tn, block_rows, prune=prune,
                                 selection=cfg.selection)
    return reference.void_bad_queries(q, vals, idx)


def fused_topk(q: torch.Tensor, c: torch.Tensor, k: int,
               metric=Metric.COSINE, *, mask=None,
               config: Optional[SearchConfig] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k search: ((m, k) scores best first, (m, k) int32 indices).

    Runs the fused kernels when ``supports()`` and ``use_pallas`` allow,
    else ``ops.reference`` (float64, k > ``max_fused_k``, very wide dims),
    the same split as the JAX package; a quantized precision quantizes
    ``c`` on the way in.  ``k`` must already be clamped to
    ``c.shape[0]``.  ``mask`` (n,) bool excludes corpus rows, and so does
    a corpus row holding NaN or +-inf; unfilled slots carry (-inf
    similarity / +inf distance, INT32_MAX), and every slot of a query row
    holding NaN or +-inf (NaN, INT32_MAX).

    A config that leaves every tuning field at its default adopts the
    persisted ``autotune`` winner for this device kind and problem class
    (``_consult_autotune_cache``), as in the JAX package.
    """
    cfg = resolve(config)
    metric = Metric.parse(metric)
    cfg = _consult_autotune_cache(cfg, q.shape[1], k, c.shape[0], metric,
                                  q.device)
    if not cfg.use_pallas or not supports(q.shape, c.shape, q.dtype, k,
                                          cfg):
        mk = None if mask is None else torch.as_tensor(
            mask, device=q.device).to(torch.bool)
        return reference.topk_search(q, c, k, metric, mask=mk)
    precision = kernel_precision(cfg.precision)
    if c.is_floating_point() and c.dtype not in (torch.float32,
                                                 torch.bfloat16):
        # f32 queries take the fused path whatever the corpus's float
        # width, as in the JAX package: a float64 or float16 corpus is
        # rounded to f32 for the prep.
        c = c.to(torch.float32)
    cp, cbp = prepare_corpus(c, metric, precision=precision)
    # The JAX package's one-shot path pads the corpus to this tile height.
    bq, bn = effective_tiles(cfg, k)
    tn = _pick_block_n(q.shape[1], min(bq, _round_up(q.shape[0], 8)), bn,
                       effective_k_pad(k, cfg))
    return fused_topk_prepared(q, cp, cbp, k, metric, mask=mask, config=cfg,
                               precision=precision, tn=tn)


# Tuning fields a cached autotune winner may override on an all-defaults
# dispatch (``utils.autotune._CFG_FIELDS``).
_TUNED_FIELDS = ("block_q", "block_n", "k_pad", "selection", "auto_tile",
                 "precision", "prune")


def _consult_autotune_cache(cfg: SearchConfig, dim: int, k: int, n: int,
                            metric, device=None) -> SearchConfig:
    """Adopt the persisted autotune winner's tuning fields for this device
    kind when the caller left every one of them at its default; any
    explicit pin, or ``use_autotune_cache=False``, wins."""
    if not cfg.use_autotune_cache:
        return cfg
    base = SearchConfig()
    if any(getattr(cfg, f) != getattr(base, f) for f in _TUNED_FIELDS):
        return cfg
    from ..utils.autotune import cached_winner

    win = cached_winner(dim, k, n, metric, cfg.precision, device=device)
    if win is None:
        return cfg
    return cfg.with_updates(
        **{f: getattr(win, f) for f in _TUNED_FIELDS})


# ---------------------------------------------------------------------------
# State carried across from the JAX package.
# ---------------------------------------------------------------------------


def prepared_from_jax(cp, cbp, n: int, dim: int, *, device="cpu"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The port's (cp, cbp) from the JAX package's ``prepare_corpus``
    output, given as numpy arrays.

    ``cp`` is one of: bf16 [hi | lo] (bf16x3) or bf16 hi only (bf16c),
    either as raw ``uint16`` bits; f32 (highest); int8 codes (int8c) or
    nibble-packed int8 (int4c).  ``cbp`` is the (1, n_padded) bias row or,
    for int8c / int4c, the (2, n_padded) scale | bias rows.  Drops JAX's
    tile-padded rows and 128-padded feature columns (int4 keeps its packed
    width), and undoes the chunk-interleaved ``[hi_0 | lo_0 | hi_1 | lo_1
    ...]`` layout used above dim 4096.

    A row whose carried values are not all finite (a float form holding
    NaN or +-inf, or codes under a non-finite scale | bias column) is made
    bad as ``prepare_corpus`` makes it: a NaN bias, and for codes zero
    codes and a (NaN, NaN) column.  The JAX package's int8 / int4
    quantizers cast a NaN row to finite codes under scale 1, and give a
    +inf row zero codes whose cosine column is finite: those rows carry
    nothing that marks them.
    """
    cp = np.asarray(cp)
    if str(cp.dtype) == "bfloat16":
        cp = cp.view(np.uint16)
    cbp = np.asarray(cbp, dtype=np.float32)
    ck, dpp, nk = feature_geometry(dim)
    if cp.dtype == np.uint16 and cp.shape[1] == 2 * dpp:
        blocks = cp[:n].reshape(n, nk, 2, ck)
        hi = blocks[:, :, 0, :].reshape(n, dpp)[:, :dim]
        lo = blocks[:, :, 1, :].reshape(n, dpp)[:, :dim]
        bits = np.ascontiguousarray(np.concatenate([hi, lo], axis=1))
        cp_t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    elif cp.dtype == np.uint16 and cp.shape[1] == dpp:
        bits = np.ascontiguousarray(cp[:n, :dim])
        cp_t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    elif cp.dtype == np.float32 and cp.shape[1] == dpp:
        cp_t = torch.from_numpy(np.array(cp[:n, :dim]))
    elif cp.dtype == np.int8 and cp.shape[1] in (dpp, dpp // 2):
        width = dim if cp.shape[1] == dpp else dpp // 2
        if cbp.shape[0] != 2:
            raise ValueError("int8 / int4 codes need the (2, rows) cbp")
        cb = np.array(cbp[:, :n])   # a writable copy
        bad = ~np.isfinite(cb).all(axis=0)
        codes = np.where(bad[:, None], np.int8(0), cp[:n, :width])
        cb[:, bad] = np.nan
        return (torch.from_numpy(codes).to(device),
                torch.from_numpy(cb).to(device))
    else:
        raise ValueError(f"unsupported prepared corpus: {cp.dtype} of width "
                         f"{cp.shape[1]} for dim {dim} (padded {dpp})")
    cb = np.array(cbp.reshape(-1, cbp.shape[-1])[-1, :n])   # a writable copy
    cb[reference.bad_rows(cp_t).numpy()] = np.nan
    return cp_t.to(device), torch.from_numpy(cb).to(device)
