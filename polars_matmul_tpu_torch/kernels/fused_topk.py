"""Fused matmul -> metric epilogue -> top-k, on Hopper (port of
``polars_matmul_tpu.kernels.fused_topk``).

The JAX package runs one Pallas kernel (``_kernel``) whose grid walks the
corpus in order on one TPU core and carries a running top-k in VMEM.  Here
two hand-written CUDA kernels compute the same result:

- kernel A, ``csrc/fused_topk.cu`` (``fused_topk_partial``): per query
  tile and corpus split, the tiled Q.C^T (bf16x3 or f32 core), the bias
  row, the mask by select, and a running top-k carry per split;
- kernel B, ``csrc/topk_merge.cu`` (``topk_merge``): merges the splits
  into the final (m, k) result.

Both are exact, with lowest-index-wins ties, so every ``selection`` value
of ``SearchConfig`` runs them.  The (m, n) score matrix never reaches
device memory: kernel A writes m * splits * k candidates.

Metric handling is the JAX package's: cosine pre-scales queries and
corpus by their inverse norms (zero-norm rows scale by 0), euclidean
selects on 2 q.c - |c|^2 and the finalize sqrt(max(|q|^2 - s, 0)) runs
after the kernels, and dot is the plain product.

Every kernel wrapper takes CUDA tensors to its kernel and CPU tensors to
its plain PyTorch version in this module; any other device raises.  Each
counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
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
# Largest k the fused path serves, whatever the config's k_pad; beyond it
# dispatch uses the reference.
_MAX_FUSED_K = 1024
# The plain version builds its score matrix in chunks of about this many
# elements.
_PLAIN_CHUNK = 1 << 26
# Kernel A's corpus tile height and the most splits kernel B merges (both
# fixed in the CUDA sources).
_TN = 64
_MAX_SPLITS = 1024

# Launches per wrapper, for showing that a run went through the kernels.
launches = {
    "fused_topk_partial": 0,
    "topk_merge": 0,
    "fused_topk_plain": 0,
    "fused_topk_partial_plain": 0,
    "topk_merge_plain": 0,
}


def reset_launch_counts() -> None:
    for key in launches:
        launches[key] = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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
    """The fused core a config precision runs: "bf16x3" or "highest"."""
    if precision == "bf16x3":
        return "bf16x3"
    if precision in ("highest", "high", "default"):
        return "highest"
    raise NotImplementedError(
        f"precision={precision!r} is a quantized-storage kernel mode; the "
        "storage tiers are not ported yet (ROADMAP.md queue 1, item 2)"
    )


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


def _scale_rows(x: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Cosine: rows times 1/|row| (0 for norms <= eps)."""
    if metric is not Metric.COSINE:
        return x
    eps = cosine_eps(torch.float32)
    nrm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x * torch.where(nrm > eps, 1.0 / nrm, torch.zeros_like(nrm))


def prepare_queries(q: torch.Tensor, metric, precision: str) -> torch.Tensor:
    """Query prep: cosine normalises, euclidean doubles, then the bf16x3
    split.  Plain torch, as the JAX package does it in XLA."""
    metric = Metric.parse(metric)
    q = _scale_rows(q, metric)
    if metric is Metric.EUCLIDEAN:
        q = 2.0 * q
    q = q.contiguous()
    return split_hi_lo(q) if precision == "bf16x3" else q


def prepare_corpus(c: torch.Tensor, metric, *, precision: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corpus prep for the fused kernels: returns (cp, cbp).

    cp is (n, 2*dim) bf16 [hi | lo] for "bf16x3" or (n, dim) f32 for
    "highest"; cbp is the (n,) f32 epilogue bias, -|c|^2 for euclidean
    and 0 otherwise.  Nothing is padded: the kernel bounds its own edges.
    """
    metric = Metric.parse(metric)
    precision = kernel_precision(precision)
    if c.dtype != torch.float32:
        raise TypeError(f"prepare_corpus takes float32, got {c.dtype}")
    c = _scale_rows(c, metric)
    if metric is Metric.EUCLIDEAN:
        cb = -torch.sum(c * c, dim=1)
    else:
        cb = torch.zeros(c.shape[0], dtype=torch.float32, device=c.device)
    c = c.contiguous()
    cp = split_hi_lo(c) if precision == "bf16x3" else c
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


def _plain_scores(qp, cp, precision: str) -> torch.Tensor:
    if precision == "bf16x3":
        d = qp.shape[1] // 2
        qh, ql = qp[:, :d].float(), qp[:, d:].float()
        ch, cl = cp[:, :d].float(), cp[:, d:].float()
        with reference.exact_matmul():
            return qh @ ch.T + (qh @ cl.T + ql @ ch.T)
    with reference.exact_matmul():
        return qp @ cp.T


def _masked_scores(qp, cp, cbp, mask, precision: str, r0: int, r1: int):
    """Epilogue scores for corpus rows [r0, r1): product + bias, masked by
    select to -inf."""
    s = _plain_scores(qp, cp[r0:r1], precision) + cbp[r0:r1]
    if mask is not None:
        s = torch.where(mask[r0:r1].to(torch.bool), s,
                        torch.full_like(s, _NEG_INF))
    return s


def _finish(vals, idx, k: int):
    """Pad the last axis to k with -inf and give every -inf slot the index
    INT32_MAX."""
    if vals.shape[-1] < k:
        pad = k - vals.shape[-1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=_NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, pad))
    idx = torch.where(vals == _NEG_INF, torch.full_like(idx, INT32_MAX), idx)
    return vals.contiguous(), idx.to(torch.int32).contiguous()


def fused_topk_plain(qp: torch.Tensor, cp: torch.Tensor, cbp: torch.Tensor,
                     mask: Optional[torch.Tensor], k: int, precision: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernels A + B on prepared operands.

    Scores are the bf16x3 sum qh.ch + (qh.cl + ql.ch) of bf16 values
    upcast to f32 (or the f32 product for "highest"), plus the bias row,
    masked by select to -inf; returns the top-k by (value desc, index asc)
    with INT32_MAX wherever the value is -inf.  Builds the score matrix in
    corpus row chunks.
    """
    launches["fused_topk_plain"] += 1
    m, n = qp.shape[0], cp.shape[0]
    dev = qp.device
    vals = torch.empty((m, 0), dtype=torch.float32, device=dev)
    idx = torch.empty((m, 0), dtype=torch.int64, device=dev)
    step = max(1, _PLAIN_CHUNK // max(m, 1))
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
                             splits: int, tiles_per_split: int):
    """Plain version of kernel A: (m, splits, k) top-k lists, split s
    covering corpus rows [s * rows, (s + 1) * rows) with rows =
    tiles_per_split * 64.  Builds the whole score matrix."""
    launches["fused_topk_partial_plain"] += 1
    m, n = qp.shape[0], cp.shape[0]
    rows = tiles_per_split * _TN
    s = _masked_scores(qp, cp, cbp, mask, precision, 0, n)
    s = torch.nn.functional.pad(s, (0, splits * rows - n), value=_NEG_INF)
    sv, order = torch.sort(s.reshape(m, splits, rows), dim=2,
                           descending=True, stable=True)
    base = torch.arange(splits, device=qp.device)[None, :, None] * rows
    return _finish(sv[..., :k], order[..., :k] + base, k)


def topk_merge_plain(part_v: torch.Tensor, part_i: torch.Tensor, k: int):
    """Plain version of kernel B: top-k of the union of the split lists.

    Splits cover ascending corpus ranges and each list is ordered, so a
    stable sort of the concatenation keeps lowest-index-first ties.
    """
    launches["topk_merge_plain"] += 1
    m = part_v.shape[0]
    v = part_v.reshape(m, -1)
    i = part_i.reshape(m, -1)
    sv, order = torch.sort(v, dim=1, descending=True, stable=True)
    vals = sv[:, :k]
    return _finish(vals, torch.gather(i, 1, order[:, :k]), k)


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


def launch_geometry(m: int, n: int, k: int, sm_count: int):
    """(tm, splits, tiles_per_split): enough blocks for two per SM, no
    empty split, and at most _MAX_SPLITS lists for kernel B."""
    tm = query_tile_rows(m, k)
    grid_m = -(-m // tm)
    n_tiles = -(-n // _TN)
    want = max(1, -(-2 * sm_count // grid_m))
    splits = max(1, min(n_tiles, want, _MAX_SPLITS))
    tps = -(-n_tiles // splits)
    return tm, -(-n_tiles // tps), tps


def _check_operands(qp, cp, cbp, mask, k: int, precision: str):
    dev = qp.device
    for name, t in (("cp", cp), ("cbp", cbp)) + (
            (("mask", mask),) if mask is not None else ()):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
    want = torch.bfloat16 if precision == "bf16x3" else torch.float32
    if qp.dtype != want or cp.dtype != want:
        raise TypeError(f"precision={precision!r} takes {want} operands, "
                        f"got {qp.dtype} and {cp.dtype}")
    if qp.ndim != 2 or cp.ndim != 2 or qp.shape[1] != cp.shape[1]:
        raise ValueError(f"bad operand shapes {tuple(qp.shape)} and "
                         f"{tuple(cp.shape)}")
    if precision == "bf16x3" and qp.shape[1] % 2:
        raise ValueError("bf16x3 operands carry [hi | lo]: even width")
    n = cp.shape[0]
    if cbp.dtype != torch.float32 or tuple(cbp.shape) != (n,):
        raise ValueError(f"cbp must be ({n},) float32")
    if mask is not None and (mask.dtype != torch.uint8
                             or tuple(mask.shape) != (n,)):
        raise ValueError(f"mask must be ({n},) uint8")
    if not 1 <= k <= _MAX_FUSED_K:
        raise ValueError(f"k={k} outside [1, {_MAX_FUSED_K}]")
    for name, t in (("qp", qp), ("cp", cp), ("cbp", cbp), ("mask", mask)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def fused_topk_partial(qp, cp, cbp, mask, k: int, precision: str,
                       splits: int, tiles_per_split: int, tm: int):
    """Kernel A: (m, splits, k) f32 values and int32 indices."""
    _check_operands(qp, cp, cbp, mask, k, precision)
    if qp.device.type == "cpu":
        return fused_topk_partial_plain(qp, cp, cbp, mask, k, precision,
                                        splits, tiles_per_split)
    if qp.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {qp.device}")
    from ._build import load_library

    lib = load_library()
    m, n = qp.shape[0], cp.shape[0]
    dim = qp.shape[1] // 2 if precision == "bf16x3" else qp.shape[1]
    part_v = torch.empty((m, splits, k), dtype=torch.float32,
                         device=qp.device)
    part_i = torch.empty((m, splits, k), dtype=torch.int32, device=qp.device)
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pmm_fused_topk_partial(
            _ptr(qp), _ptr(cp), _ptr(cbp), _ptr(mask), _ptr(part_v),
            _ptr(part_i), m, n, dim, k, splits, tiles_per_split, tm,
            int(precision == "bf16x3"), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_topk_partial launch failed: error {rc}")
    launches["fused_topk_partial"] += 1
    return part_v, part_i


def topk_merge(part_v: torch.Tensor, part_i: torch.Tensor, k: int):
    """Kernel B: (m, k) f32 values and int32 indices from the splits."""
    if (part_v.ndim != 3 or part_v.shape != part_i.shape
            or part_v.shape[2] != k or part_v.dtype != torch.float32
            or part_i.dtype != torch.int32 or part_v.device != part_i.device
            or not part_v.is_contiguous() or not part_i.is_contiguous()):
        raise ValueError("topk_merge takes contiguous (m, splits, k) f32 "
                         "values and int32 indices on one device")
    if part_v.device.type == "cpu":
        return topk_merge_plain(part_v, part_i, k)
    if part_v.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {part_v.device}")
    from ._build import load_library

    lib = load_library()
    m, splits = part_v.shape[0], part_v.shape[1]
    vals = torch.empty((m, k), dtype=torch.float32, device=part_v.device)
    idx = torch.empty((m, k), dtype=torch.int32, device=part_v.device)
    with torch.cuda.device(part_v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pmm_topk_merge(_ptr(part_v), _ptr(part_i), _ptr(vals),
                                _ptr(idx), m, splits, k,
                                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"topk_merge launch failed: error {rc}")
    launches["topk_merge"] += 1
    return vals, idx


def fused_select(qp, cp, cbp, mask, k: int, precision: str):
    """Top-k on prepared operands: kernels A + B for CUDA tensors, the
    plain version for CPU tensors, and an error for any other device."""
    _check_operands(qp, cp, cbp, mask, k, precision)
    if qp.shape[0] == 0:
        return (torch.empty((0, k), device=qp.device),
                torch.empty((0, k), dtype=torch.int32, device=qp.device))
    if qp.device.type == "cpu":
        return fused_topk_plain(qp, cp, cbp, mask, k, precision)
    if qp.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {qp.device}")
    sms = torch.cuda.get_device_properties(qp.device).multi_processor_count
    tm, splits, tps = launch_geometry(qp.shape[0], cp.shape[0], k, sms)
    part_v, part_i = fused_topk_partial(qp, cp, cbp, mask, k, precision,
                                        splits, tps, tm)
    return topk_merge(part_v, part_i, k)


# ---------------------------------------------------------------------------
# Dispatch.
# ---------------------------------------------------------------------------


def _finalize(q: torch.Tensor, vals: torch.Tensor, metric: Metric):
    """Euclidean: the kernels select on 2 q.c - |c|^2; recover the distance
    (a -inf sentinel becomes +inf)."""
    if metric is not Metric.EUCLIDEAN:
        return vals
    qsq = torch.sum(q * q, dim=1, keepdim=True)
    return torch.sqrt(torch.clamp(qsq - vals, min=0.0))


def fused_topk_prepared(q: torch.Tensor, cp: torch.Tensor, cbp: torch.Tensor,
                        k: int, metric, *, mask=None,
                        config: Optional[SearchConfig] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``q`` against a corpus prepared by ``prepare_corpus``.

    Returns ((m, k) f32 scores best first, (m, k) int32 indices).  The
    prepared form's dtype gives the core (bf16 -> "bf16x3", f32 ->
    "highest") and must agree with the config's precision.
    """
    cfg = resolve(config)
    metric = Metric.parse(metric)
    if k > max_fused_k(cfg):
        raise ValueError(
            f"k={k} exceeds the fused path's ceiling "
            f"{max_fused_k(cfg)}; "
            "use the unprepared/fallback path")
    precision = "bf16x3" if cp.dtype == torch.bfloat16 else "highest"
    if kernel_precision(cfg.precision) != precision:
        raise ValueError(
            f"corpus was prepared for {precision!r}, config asks for "
            f"{cfg.precision!r}")
    if q.dtype != torch.float32:
        # Half-precision queries: upcast on the device, so the kernels and
        # the euclidean finalize run f32.
        q = q.float()
    qp = prepare_queries(q, metric, precision)
    mask_u8 = None if mask is None else pad_mask_row(
        torch.as_tensor(mask, device=q.device), cbp.shape[0])
    with annotate(f"pmm.fused_topk.{metric.value}"):
        vals, idx = fused_select(qp, cp, cbp, mask_u8, k, precision)
    return _finalize(q, vals, metric), idx


def fused_topk(q: torch.Tensor, c: torch.Tensor, k: int,
               metric=Metric.COSINE, *, mask=None,
               config: Optional[SearchConfig] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k search: ((m, k) scores best first, (m, k) int32 indices).

    Runs the fused kernels when ``supports()`` and ``use_pallas`` allow,
    else ``ops.reference`` (float64, k > ``max_fused_k``, very wide dims),
    the same split as the JAX package.  ``k`` must already be clamped to
    ``c.shape[0]``.  ``mask`` (n,) bool excludes corpus rows; unfilled
    slots carry (-inf similarity / +inf distance, INT32_MAX).
    """
    cfg = resolve(config)
    metric = Metric.parse(metric)
    if not cfg.use_pallas or not supports(q.shape, c.shape, q.dtype, k,
                                          cfg):
        mk = None if mask is None else torch.as_tensor(
            mask, device=q.device).to(torch.bool)
        return reference.topk_search(q, c, k, metric, mask=mk)
    precision = kernel_precision(cfg.precision)
    cp, cbp = prepare_corpus(c, metric, precision=precision)
    return fused_topk_prepared(q, cp, cbp, k, metric, mask=mask, config=cfg)


# ---------------------------------------------------------------------------
# State carried across from the JAX package.
# ---------------------------------------------------------------------------


def _jax_feature_geometry(dim: int):
    """(ck, dpp, nk) of the JAX package's prepared layout
    (``polars_matmul_tpu.kernels.fused_topk.feature_geometry``)."""
    dp = _round_up(dim, _LANES)
    ck = dp if dp <= 4096 else 2048
    dpp = _round_up(dp, ck)
    return ck, dpp, dpp // ck


def prepared_from_jax(cp, cbp, n: int, dim: int, *, device="cpu"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The port's (cp, cbp) from the JAX package's ``prepare_corpus``
    output, given as numpy arrays.

    ``cp`` is bf16 [hi | lo] as raw ``uint16`` bits (bf16x3) or f32
    (highest), ``cbp`` the (1, n_padded) bias row.  Drops JAX's tile-padded
    rows and 128-padded feature columns, and undoes the chunk-interleaved
    ``[hi_0 | lo_0 | hi_1 | lo_1 ...]`` layout used above dim 4096.
    """
    cp = np.asarray(cp)
    if str(cp.dtype) == "bfloat16":
        cp = cp.view(np.uint16)
    cbp = np.asarray(cbp, dtype=np.float32)
    ck, dpp, nk = _jax_feature_geometry(dim)
    if cp.dtype == np.uint16:
        if cp.shape[1] != 2 * dpp:
            raise ValueError(f"bf16x3 cp width {cp.shape[1]} != {2 * dpp}")
        blocks = cp[:n].reshape(n, nk, 2, ck)
        hi = blocks[:, :, 0, :].reshape(n, dpp)[:, :dim]
        lo = blocks[:, :, 1, :].reshape(n, dpp)[:, :dim]
        bits = np.ascontiguousarray(np.concatenate([hi, lo], axis=1))
        cp_t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    elif cp.dtype == np.float32:
        if cp.shape[1] != dpp:
            raise ValueError(f"f32 cp width {cp.shape[1]} != {dpp}")
        cp_t = torch.from_numpy(np.array(cp[:n, :dim]))
    else:
        raise TypeError(f"unsupported prepared corpus dtype {cp.dtype}")
    cb = np.array(cbp.reshape(-1, cbp.shape[-1])[-1, :n])   # a writable copy
    return cp_t.to(device), torch.from_numpy(cb).to(device)

