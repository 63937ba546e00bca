"""Corpus-sharded search on ``torch.distributed`` (port of
``polars_matmul_tpu.parallel.sharded``).

The corpus is block-partitioned over the mesh's ``corpus`` axis: shard s
holds global rows [s * ns, (s + 1) * ns).  Each mesh position searches its
shard with the port's fused top-k (kernel A, then kernel B) and offsets
the indices to global ones; the shards' lists are then merged exactly, and
every rank gets the whole (m, k) result.  Queries split into row blocks
over the ``data`` axis.

- ``merge="allgather"``: every position's list reaches every rank
  (``dist.all_gather`` across ranks), and each query block's S lists are
  re-selected by kernel B, one list a split.
- ``merge="ring"``: S - 1 steps around the corpus axis, each position
  merging the visiting list into its running one (kernel B on two lists),
  over ``ring_pipeline`` query chunks; across ranks the lists travel by
  ``dist.isend`` / ``dist.irecv`` to the next position's rank.

Kernel B orders by explicit (value desc, index asc) keys, so neither merge
relies on the order its lists arrive in (the JAX package's allgather
relies on ``lax.top_k``'s positional tie-break instead, its ring on a
two-key sort).  The per-shard lists carry the kernels' own scores, higher
is better; euclidean distances are finalised once, after the merge.

Padding rows (the global tail up to a multiple of the shard count, the
4096-row shard height of int8 / int4 shards, the rows ``capacity=``
reserves) are dead in every prepared form (bias -inf), so they never enter
a list and no shard widens its k as the JAX package's do.  The reference
path (float64, k > max_fused_k, ``use_pallas=False``) masks them, and
merges its finished scores by the same two keys in plain PyTorch.

Non-finite values: a shard's bad rows (NaN or +-inf) are dead through
their prepared bias as on one device; a query row holding NaN or +-inf
reaches the merges as sentinels (``_offset``), so kernel B never sees a
NaN, and gets (NaN, INT32_MAX) in every slot after them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import SearchConfig, resolve
from ..kernels.fused_topk import (INT32_MAX, _finalize, dequant_int4,
                                  fused_topk, kernel_precision,
                                  layout_tile_rows, max_fused_k,
                                  prepare_corpus, probe_block_rows,
                                  select_prepared, supports, topk_merge)
from ..kernels.matmul import pairwise_matmul
from ..kernels.storage import prepare_stored, quantize_stored
from ..ops.cluster import probe_tiles
from ..ops.metrics import Metric
from ..ops.reference import topk_two_key, void_bad_queries
from .mesh import Mesh

# A shard's rows on one device: (shard index, device).
Key = Tuple[int, torch.device]

_NEG_INF = float("-inf")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _as_tensor(x) -> torch.Tensor:
    """A torch tensor of ``x`` (NumPy arrays viewed on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.ascontiguousarray(x)
    if str(x.dtype) == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


@dataclasses.dataclass
class ShardedCorpus:
    """Device-resident corpus, block-partitioned over the corpus mesh axis.

    ``shards`` maps (shard, device) to that shard's ``ns`` rows on the
    device: this rank's positions only, one tensor for each device that
    holds the shard (a device named at several positions of a shard's
    column holds it once; shards on one device are views of one buffer).
    Rows past ``n_true`` are padding (zero rows, scale 1.0).
    """

    shards: Dict[Key, torch.Tensor]
    n_true: int
    n_shards: int
    ns: int
    width: int
    dtype: torch.dtype
    # int8 / int4 storage: each shard's (ns,) f32 dequant scales.
    scales: Optional[Dict[Key, torch.Tensor]] = None
    # The logical feature width of quantized shards (int4 rows are
    # nibble-packed).
    dim: Optional[int] = None
    storage: str = "f32"
    # Built with reserved growth rows (Corpus(capacity=, mesh=)).
    has_capacity: bool = False
    # (metric, core) -> {key: (cp, cbp)}: each shard's prepared form.
    _prepared: dict = dataclasses.field(default_factory=dict, repr=False)
    # {key: dense rows} of quantized / bf16 shards, for the reference path
    # and the matmul: built once.
    _f32_view: Optional[dict] = dataclasses.field(default=None, repr=False)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_shards * self.ns, self.width)

    def live_rows(self, s: int) -> int:
        """Rows of shard ``s`` below the live count."""
        return min(max(self.n_true - s * self.ns, 0), self.ns)

    def dense_f32(self) -> Dict[Key, torch.Tensor]:
        """Dense value shards (dequantised or upcast, cached) for the
        reference path and the matmul; f32 and f64 shards as they are."""
        if self.dtype in (torch.float32, torch.float64):
            return self.shards
        if self._f32_view is None:
            view = {}
            for key, rows in self.shards.items():
                if self.scales is None:
                    view[key] = rows.to(torch.float32)
                elif self.storage == "int4":
                    view[key] = dequant_int4(rows, self.scales[key],
                                             self.dim)
                else:
                    view[key] = (rows.to(torch.float32)
                                 * self.scales[key][:, None])
            self._f32_view = view
        return self._f32_view

    def prepared_for(self, metric: Metric, cfg: SearchConfig,
                     precision: str) -> Dict[Key, Tuple[torch.Tensor,
                                                       torch.Tensor]]:
        """Each shard's (cp, cbp) for kernel A's core ``precision``,
        prepared in row chunks of ``cfg.prep_chunk_bytes`` (cp is the
        shard itself where the prep keeps rows as stored: int8 / int4
        codes, bf16 rows for dot and euclidean).  Rows past the live
        count get bias -inf."""
        key = (metric.value, precision)
        if key not in self._prepared:
            chunk = max(1, cfg.prep_chunk_bytes // (4 * (self.dim
                                                          or self.width)))
            forms = {}
            for (s, dev), rows in self.shards.items():
                sc = None if self.scales is None else self.scales[(s, dev)]
                cp, cbp = prepare_stored(rows, sc, metric, precision, chunk)
                live = self.live_rows(s)
                if live < self.ns:
                    (cbp[-1] if cbp.ndim == 2 else cbp)[live:] = _NEG_INF
                forms[(s, dev)] = (cp, cbp)
            self._prepared[key] = forms
        return self._prepared[key]

    def scatter(self, pos: np.ndarray, rows, cfg: SearchConfig) -> None:
        """Write float rows ``rows`` (m, dim) at global array positions
        ``pos`` (unique, below the padded height), storage-native: into
        each shard that owns a position and into every cached prepared
        form of it, in place.  A prepared form whose cp is the shard
        itself takes only its bias rows."""
        pos = np.asarray(pos, np.int64)
        src = _as_tensor(rows)
        scales = None
        if self.scales is not None:
            chunk = max(1, cfg.prep_chunk_bytes // (4 * self.dim))
            codes, scales = quantize_stored(rows, self.storage, self.dim,
                                            src.device, chunk)
            stored = _as_tensor(codes)
            scales = _as_tensor(scales)
        else:
            stored = src.to(torch.float64 if self.dtype == torch.float64
                            else torch.float32)
        self._f32_view = None
        shard_of = pos // self.ns
        for (s, dev), piece in self.shards.items():
            sel = np.flatnonzero(shard_of == s)
            if sel.size == 0:
                continue
            loc = torch.from_numpy(pos[sel] - s * self.ns).to(dev)
            take = torch.from_numpy(sel).to(stored.device)
            vals = stored[take].to(device=dev, dtype=piece.dtype)
            piece[loc] = vals
            sc = None
            if scales is not None:
                sc = scales[take.to(scales.device)].to(dev)
                self.scales[(s, dev)][loc] = sc
                prep_src = vals
            else:
                # bf16: prepare from the stored (rounded) rows, so that a
                # write and a later prep from storage score the same bits.
                prep_src = (vals if self.dtype == torch.bfloat16
                            else stored[take].to(dev, torch.float32))
            for (metric_v, precision), forms in self._prepared.items():
                cp, cbp = forms[(s, dev)]
                cpc, cbc = prepare_corpus(prep_src, metric_v,
                                          precision=precision, scales=sc)
                if cp.data_ptr() != piece.data_ptr():
                    cp[loc] = cpc
                cbp[..., loc] = cbc

    def gather(self, mesh: Mesh, device=None):
        """Every shard's rows in order, and the scales, on ``device``
        (default the mesh's home device); every rank takes part."""
        device = mesh.home if device is None else torch.device(device)
        mine = {}
        for (s, _dev), piece in self.shards.items():
            if s not in mine:
                sc = None if self.scales is None else self.scales[(s, _dev)]
                mine[s] = (piece, sc)
        if mesh.distributed:
            theirs = [None] * mesh.world_size
            torch.distributed.all_gather_object(
                theirs, {s: (p.cpu(), None if sc is None else sc.cpu())
                         for s, (p, sc) in mine.items()})
            for got in theirs:
                for s, part in got.items():
                    mine.setdefault(s, part)
        data = torch.cat([mine[s][0].to(device)
                          for s in range(self.n_shards)])
        scales = (None if self.scales is None else
                  torch.cat([mine[s][1].to(device)
                             for s in range(self.n_shards)]))
        return data, scales


def place_shards(x, mesh: Mesh, axis: str, ns: int, fill: float = 0.0,
                 dtype: Optional[torch.dtype] = None
                 ) -> Dict[Key, torch.Tensor]:
    """Rows of ``x`` (NumPy or a tensor, n <= S * ns rows) split into S
    shards of ``ns`` rows on this rank's devices, ``fill`` past n.  Each
    device takes one buffer for the shards it holds (the shards are views
    of it); a tensor is copied from where it lies (a CUDA tensor on the
    card, never through the host), NumPy only row ranges a shard needs."""
    n_shards = mesh.shape[axis]
    n = x.shape[0]
    tail = tuple(x.shape[1:])
    if dtype is None:
        dtype = _as_tensor(x[:0]).dtype
    by_dev: Dict[torch.device, List[int]] = {}
    for s in range(n_shards):
        for dev in mesh.shard_devices(s):
            by_dev.setdefault(dev, []).append(s)
    out = {}
    for dev, held in by_dev.items():
        buf = torch.full((len(held) * ns,) + tail, fill, dtype=dtype,
                         device=dev)
        for j, s in enumerate(held):
            r0, r1 = s * ns, min(n, (s + 1) * ns)
            piece = buf[j * ns:(j + 1) * ns]
            if r1 > r0:
                piece[: r1 - r0].copy_(_as_tensor(x[r0:r1]))
            out[(s, dev)] = piece
    return out


def shard_corpus(c, mesh: Mesh, config: Optional[SearchConfig] = None,
                 scales=None, storage: str = "int8",
                 dim: Optional[int] = None,
                 capacity: Optional[int] = None) -> ShardedCorpus:
    """Block-partition a corpus (optionally int8 codes, or nibble-packed
    int4 codes with ``dim=``, and their per-row ``scales``) over the
    corpus mesh axis, with the JAX package's padding: float rows at the
    global tail to a multiple of the shard count; quantized shards each
    rounded up to a multiple of 4096 rows (scale 1.0 on pad rows), at the
    kernel's own feature width (int8 ``dim``, int4 packed).  ``capacity``
    reserves rows at the global tail for ``Corpus.add``."""
    cfg = resolve(config)
    axis = cfg.mesh_axes[1]
    n_shards = mesh.shape[axis]
    n = c.shape[0]
    cap = n if capacity is None else max(int(capacity), n)
    if scales is not None:
        if storage == "int4":
            if dim is None:
                raise ValueError(
                    "shard_corpus(storage='int4') requires dim= (the "
                    "packed width is ambiguous)"
                )
            orig_dim = int(dim)
        else:
            orig_dim = c.shape[1]
        ns = _round_up(-(-cap // n_shards), 4096)
        data = place_shards(c, mesh, axis, ns, 0, torch.int8)
        sh_scales = place_shards(scales, mesh, axis, ns, 1.0, torch.float32)
        return ShardedCorpus(data, n, n_shards, ns, c.shape[1], torch.int8,
                             scales=sh_scales, dim=orig_dim, storage=storage,
                             has_capacity=capacity is not None)
    ns = _round_up(cap, n_shards) // n_shards
    return ShardedCorpus(place_shards(c, mesh, axis, ns), n, n_shards, ns,
                         c.shape[1], _as_tensor(c[:0]).dtype,
                         has_capacity=capacity is not None)


# ---------------------------------------------------------------------------
# Merges and the exchange between ranks.
# ---------------------------------------------------------------------------


def _kernel_merge(lists, k: int):
    """Top-k of (m, k) lists of kernel scores by (value desc, index asc):
    kernel B on a CUDA device, its plain version on the CPU."""
    part_v = torch.stack([v for v, _ in lists], dim=1).contiguous()
    part_i = torch.stack([i for _, i in lists], dim=1).contiguous()
    if part_v.shape[0] == 0:
        return part_v[:, 0], part_i[:, 0]
    return topk_merge(part_v, part_i, k)


def _comm_device(mesh: Mesh) -> torch.device:
    """Where a collective's tensors must lie: the rank's card under NCCL,
    the CPU under gloo."""
    if torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _exchange(parts: dict, mesh: Mesh, rows: List[int], templates):
    """Every position's tensors on every rank.  ``parts`` maps this rank's
    positions (d, s) to tuples of tensors of ``rows[d]`` rows; each entry
    of ``templates`` is (trailing shape, dtype, fill) of one tuple slot.
    One ``all_gather`` a slot, over buffers padded to the most positions
    and rows any rank has."""
    if not mesh.distributed:
        return parts
    comm = _comm_device(mesh)
    owned = [mesh.positions(r) for r in range(mesh.world_size)]
    most = max(len(p) for p in owned)
    m_blk = max(rows) if rows else 0
    out = {}
    gathered = []
    for slot, (tail, dtype, fill) in enumerate(templates):
        buf = torch.full((most, m_blk) + tuple(tail), fill, dtype=dtype,
                         device=comm)
        for j, (d, s) in enumerate(owned[mesh.rank]):
            buf[j, :rows[d]] = parts[(d, s)][slot].to(comm)
        got = [torch.empty_like(buf) for _ in range(mesh.world_size)]
        torch.distributed.all_gather(got, buf)
        gathered.append(got)
    for r, positions in enumerate(owned):
        for j, (d, s) in enumerate(positions):
            out[(d, s)] = tuple(g[r][j, :rows[d]] for g in gathered)
    return out


def _ring_shift(buf: dict, mesh: Mesh, d: int, m_rows: int, k: int,
                vdtype: torch.dtype) -> dict:
    """One ring step along data row ``d``: position (d, s) receives the
    list that (d, s - 1) held, on its own device; lists whose two
    positions belong to different ranks travel by isend / irecv, posted
    in shard order on both sides."""
    n_shards = mesh.ranks.shape[1]
    me = mesh.rank
    new, recvs, reqs = {}, [], []
    comm = _comm_device(mesh) if mesh.distributed else None
    for s in range(n_shards):
        src = (s - 1) % n_shards
        r_dst, r_src = int(mesh.ranks[d, s]), int(mesh.ranks[d, src])
        dev = mesh.devices[d, s]
        if r_dst == me and r_src == me:
            new[s] = tuple(t.to(dev) for t in buf[src])
        elif r_dst == me:
            v = torch.empty((m_rows, k), dtype=vdtype, device=comm)
            i = torch.empty((m_rows, k), dtype=torch.int32, device=comm)
            reqs += [torch.distributed.irecv(v, r_src, tag=2 * s),
                     torch.distributed.irecv(i, r_src, tag=2 * s + 1)]
            recvs.append((s, v, i, dev))
        elif r_src == me:
            v, i = (t.to(comm).contiguous() for t in buf[src])
            reqs += [torch.distributed.isend(v, r_dst, tag=2 * s),
                     torch.distributed.isend(i, r_dst, tag=2 * s + 1)]
    for req in reqs:
        req.wait()
    for s, v, i, dev in recvs:
        new[s] = (v.to(dev), i.to(dev))
    return new


def _share_rows(results: dict, mesh: Mesh, bounds: List[int], k: int,
                vdtype: torch.dtype, worst: float) -> dict:
    """Give every rank each query block's result, where some rank owns no
    position of a data row (only the ring leaves a block where it ran)."""
    n_data = mesh.ranks.shape[0]
    lacking = any(not (mesh.ranks[d] == r).any()
                  for r in range(mesh.world_size) for d in range(n_data))
    if not (mesh.distributed and lacking):
        return results
    comm = _comm_device(mesh)
    m = bounds[-1]
    v = torch.full((m, k), worst, dtype=vdtype, device=comm)
    i = torch.full((m, k), INT32_MAX, dtype=torch.int32, device=comm)
    have = torch.zeros(n_data, dtype=torch.int32, device=comm)
    for d, res in results.items():
        if res is not None:
            v[bounds[d]:bounds[d + 1]] = res[0].to(comm)
            i[bounds[d]:bounds[d + 1]] = res[1].to(comm)
            have[d] = 1
    got = []
    for t in (v, i, have):
        parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
        torch.distributed.all_gather(parts, t)
        got.append(parts)
    out = {}
    for d in range(n_data):
        r = next(r for r in range(mesh.world_size) if got[2][r][d])
        out[d] = (got[0][r][bounds[d]:bounds[d + 1]].to(mesh.home),
                  got[1][r][bounds[d]:bounds[d + 1]].to(mesh.home))
    return out


# ---------------------------------------------------------------------------
# Search and product.
# ---------------------------------------------------------------------------


def _bounds(m: int, parts: int) -> List[int]:
    return [m * i // parts for i in range(parts + 1)]


def _grid(corpus: ShardedCorpus, mesh: Mesh, cfg: SearchConfig):
    """(query blocks, shards) of the mesh, which must shard this corpus."""
    d_axis, c_axis = cfg.mesh_axes
    n_data, n_shards = mesh.shape[d_axis], mesh.shape[c_axis]
    if n_shards != corpus.n_shards:
        raise ValueError(f"corpus has {corpus.n_shards} shards; the mesh's "
                         f"{c_axis!r} axis has {n_shards}")
    return n_data, n_shards


def _full_mask(mask, corpus: ShardedCorpus, live: bool):
    """The (padded rows,) bool mask over the whole corpus, or None: the
    user's mask, False past it; with ``live``, also False past the live
    count."""
    n_pad = corpus.shape[0]
    if mask is None:
        if not (live and corpus.n_true < n_pad):
            return None
        out = torch.zeros(n_pad, dtype=torch.bool)
        out[:corpus.n_true] = True
        return out
    m = _as_tensor(mask).to(torch.bool).reshape(-1)
    out = torch.zeros(n_pad, dtype=torch.bool, device=m.device)
    out[: m.shape[0]] = m
    if live:
        out[corpus.n_true:] = False
    return out


def distributed_topk(q, corpus: ShardedCorpus, k: int, metric, mesh: Mesh,
                     config: Optional[SearchConfig] = None, *, mask=None,
                     probe=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a sharded corpus: ((m, k) scores best first, (m, k)
    int32 global indices), on the mesh's home device, the same on every
    rank.

    ``q`` (NumPy or a tensor) is the whole batch on every rank; each data
    row of the mesh takes its block of rows.  ``mask`` (n,) bool excludes
    rows.  ``probe=(centroids, tile_cluster, p_local[, tn])`` opts into
    probed search on a cluster-contiguous layout: each shard ranks its
    own ``tn``-row tiles (its slice of ``tile_cluster``) against the
    centroids and visits its best ``p_local``; indices are positions in
    the sharded (permuted) rows.  Ignored on the reference path, which is
    exhaustive.  The storage policy, the k clamp, ``supports`` and the
    reference fallback are the JAX package's; ``config.merge`` picks the
    merge (see the module docstring).
    """
    cfg = resolve(config)
    metric = Metric.parse(metric)
    if corpus.dtype == torch.bfloat16 and cfg.precision != "bf16c":
        # bf16 storage runs the bf16c core, as Corpus does.
        cfg = cfg.with_updates(precision="bf16c")
    quant = corpus.scales is not None
    if quant:
        want = "int4c" if corpus.storage == "int4" else "int8c"
        if cfg.precision != want:
            cfg = cfg.with_updates(precision=want)
    n_data, n_shards = _grid(corpus, mesh, cfg)
    ns = corpus.ns
    k = min(int(k), corpus.n_true)
    k_local = min(k, ns)
    q = _as_tensor(q)
    m = q.shape[0]
    dim = corpus.dim or corpus.width
    if quant:
        dev_ok = cfg.precision in ("int8c", "int4c")
    elif corpus.dtype == torch.bfloat16:
        dev_ok = cfg.precision == "bf16c"
    else:
        dev_ok = corpus.dtype == torch.float32
    sup = supports((m, dim), (ns, dim), torch.float32, k_local, cfg)
    if not sup and quant and k_local <= max_fused_k(cfg):
        # Quantized storage above max_fused_dim stays on the kernel, as
        # on Corpus: no dense f32 shards for the speed policy.
        sup = True
    use_prepared = (cfg.use_pallas and dev_ok and q.dtype == torch.float32
                    and sup)
    full = _full_mask(mask, corpus, live=not use_prepared)
    bounds = _bounds(m, n_data)
    hib = metric.higher_is_better or use_prepared
    worst = _NEG_INF if hib else float("inf")

    def mask_of(s, dev):
        return None if full is None else full[s * ns:(s + 1) * ns].to(dev)

    if use_prepared:
        precision = kernel_precision(cfg.precision)
        forms = corpus.prepared_for(metric, cfg, precision)
        vdtype = torch.float32
        if probe is not None:
            cent, tc, p_local, *rest = probe
            tn = int(rest[0]) if rest else layout_tile_rows(dim, cfg, 1)
            tc = _as_tensor(tc)
            lt = ns // tn

        def local(d, s, r0, r1):
            dev = mesh.devices[d, s]
            qb = q[r0:r1].to(dev)
            cp, cbp = forms[(s, dev)]
            tiles, tn_k = None, None
            if probe is not None:
                kq = qb.float()
                tiles = probe_tiles(
                    kq, _as_tensor(cent).to(device=dev, dtype=torch.float32),
                    tc[s * lt:(s + 1) * lt].to(dev), p=int(p_local),
                    tm=probe_block_rows(r1 - r0, dim, cfg, k_local),
                    metric_v=metric.value)
                tn_k = tn
            v, i = select_prepared(qb, cp, cbp, k_local, metric,
                                   mask=mask_of(s, dev), config=cfg,
                                   precision=precision, tiles=tiles,
                                   tn=tn_k)
            return _offset(v, i, s * ns, k, _NEG_INF)

        def merge(lists):
            return _kernel_merge(lists, k)

        def finish(r0, r1, v):
            return _finalize(q[r0:r1].to(v.device, torch.float32), v,
                             metric)
    else:
        dense = corpus.dense_f32()
        vdtype = q.dtype if q.dtype in (torch.float32,
                                        torch.float64) else torch.float32

        def local(d, s, r0, r1):
            dev = mesh.devices[d, s]
            v, i = fused_topk(q[r0:r1].to(dev), dense[(s, dev)], k_local,
                              metric, mask=mask_of(s, dev), config=cfg)
            return _offset(v.to(vdtype), i, s * ns, k, worst)

        def merge(lists):
            v = torch.cat([x for x, _ in lists], dim=1)
            i = torch.cat([x for _, x in lists], dim=1)
            return topk_two_key(v, i, k, hib)

        def finish(r0, r1, v):
            return v

    if cfg.merge == "ring":
        results = _ring_merge(local, merge, mesh, bounds, k, vdtype,
                              cfg.ring_pipeline)
        results = _share_rows(results, mesh, bounds, k, vdtype, worst)
    else:
        panels = {(d, s): local(d, s, bounds[d], bounds[d + 1])
                  for d, s in mesh.positions()}
        rows = [bounds[d + 1] - bounds[d] for d in range(n_data)]
        panels = _exchange(panels, mesh, rows,
                           (((k,), vdtype, worst),
                            ((k,), torch.int32, INT32_MAX)))
        results = {d: merge([tuple(t.to(mesh.home) for t in panels[(d, s)])
                             for s in range(n_shards)])
                   for d in range(n_data)}
    vals = torch.cat([finish(bounds[d], bounds[d + 1],
                             results[d][0].to(mesh.home))
                      for d in range(n_data)])
    idx = torch.cat([results[d][1].to(mesh.home) for d in range(n_data)])
    return void_bad_queries(q, vals, idx)


def _offset(v: torch.Tensor, i: torch.Tensor, off: int, k: int,
            worst: float):
    """A shard's list in global indices, padded to k slots with (worst,
    INT32_MAX), a NaN value (a voided query's) made a sentinel too.
    Sentinel slots keep INT32_MAX: the offset would overflow int32."""
    i = i.to(torch.int32)
    nan = torch.isnan(v)
    v = torch.where(nan, worst, v)
    i = torch.where(nan | (i == INT32_MAX), INT32_MAX, i + off)
    if v.shape[1] < k:
        pad = k - v.shape[1]
        v = torch.nn.functional.pad(v, (0, pad), value=worst)
        i = torch.nn.functional.pad(i, (0, pad), value=INT32_MAX)
    return v.contiguous(), i.contiguous()


def _ring_merge(local, merge, mesh: Mesh, bounds: List[int], k: int,
                vdtype: torch.dtype, pipeline: int) -> dict:
    """The ring merge: per data row and query chunk, each position's own
    list, then S - 1 steps in which the visiting list is merged into the
    running one.  Returns {data row: (vals, idx)} for the rows this rank
    holds a position of (None for the others)."""
    n_data, n_shards = mesh.ranks.shape
    out = {}
    for d in range(n_data):
        mine = [s for s in range(n_shards) if mesh.ranks[d, s] == mesh.rank]
        r0, r1 = bounds[d], bounds[d + 1]
        n_chunks = max(1, min(pipeline, r1 - r0))
        cuts = [r0 + (r1 - r0) * c // n_chunks for c in range(n_chunks + 1)]
        chunks = []
        for c in range(n_chunks):
            a, b = cuts[c], cuts[c + 1]
            acc = {s: local(d, s, a, b) for s in mine}
            buf = dict(acc)
            for _ in range(n_shards - 1):
                buf = _ring_shift(buf, mesh, d, b - a, k, vdtype)
                acc = {s: merge([acc[s], buf[s]]) for s in mine}
            if mine:
                chunks.append(tuple(t.to(mesh.home) for t in acc[mine[0]]))
        out[d] = (tuple(torch.cat(x) for x in zip(*chunks)) if mine
                  else None)
    return out


def distributed_matmul(q, corpus: ShardedCorpus, mesh: Mesh,
                       config: Optional[SearchConfig] = None
                       ) -> torch.Tensor:
    """Dense Q . C^T (m, n) over a sharded corpus: each position's panel
    from ``pairwise_matmul`` on its shard's dense rows (cast to q's dtype,
    as the JAX package does), the panels joined along the corpus axis on
    the mesh's home device, the padding columns dropped."""
    cfg = resolve(config)
    n_data, n_shards = _grid(corpus, mesh, cfg)
    precision = ("bf16x3" if cfg.precision in ("int8c", "int4c", "bf16c")
                 else cfg.precision)
    q = _as_tensor(q)
    dense = corpus.dense_f32()
    bounds = _bounds(q.shape[0], n_data)
    panels = {}
    for d, s in mesh.positions():
        dev = mesh.devices[d, s]
        qb = q[bounds[d]:bounds[d + 1]].to(dev)
        panels[(d, s)] = (pairwise_matmul(qb, dense[(s, dev)].to(qb.dtype),
                                          precision=precision),)
    rows = [bounds[d + 1] - bounds[d] for d in range(n_data)]
    panels = _exchange(panels, mesh, rows, (((corpus.ns,), q.dtype, 0.0),))
    out = torch.cat([torch.cat([panels[(d, s)][0].to(mesh.home)
                                for s in range(n_shards)], dim=1)
                     for d in range(n_data)])
    return out[:, : corpus.n_true]
