"""ClusteredCorpus: a device-resident clustered corpus for probed search
(port of ``polars_matmul_tpu.api.clustered``, on one device).

Rows are k-means clustered at ingestion and laid out cluster-contiguous
in whole layout tiles; each query batch then visits only the ``probe=``
share of tiles ranked best by a small centroid product (kernel A walking
per-query-block tile lists: unvisited tiles are never read).  Search is
exact over the visited rows; recall against an exhaustive scan is set by
``probe`` and by how well the data clusters.  ``probe=None`` scans every
tile, with the same kernels as ``Corpus``.

The layout, the tile lists and the save format are the JAX package's, so
a file saved by either package loads in the other and gives the same
probed results; the k-means fit itself draws other random numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import SearchConfig, resolve
from ..kernels.fused_topk import (INT32_MAX, dequant_int4,
                                  fused_topk_prepared, kernel_precision,
                                  layout_tile_rows, max_fused_k,
                                  probe_block_rows, supports)
from ..kernels.matmul import pairwise_matmul
from ..kernels.storage import prepare_stored, quantize_stored
from ..ops import reference
from ..ops.cluster import (ClusterLayout, assign_rows, assign_rows_native,
                           centroid_scores, cluster_layout, kmeans,
                           permute_rows, probe_tiles, resolve_probe)
from ..ops.metrics import Metric
from ..parallel.sharded import (ShardedCorpus, distributed_matmul,
                                distributed_topk, place_shards)
from ..utils.profiling import annotate
from .search import (_F32, ArrayLike, DeviceLike, _as_input, _check_width,
                     _empty_topk, _host_ids, _is_half, _repeats, _to_host,
                     _to_torch, _torch_dtype, _validate_mask, compute_dtype,
                     resolve_device)

_TIER_CORE = {"bf16": "bf16c", "int8": "int8c", "int4": "int4c"}


def _is_float(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return np.issubdtype(dtype, np.floating)


def _gather_rows(c: ArrayLike, ids: np.ndarray) -> torch.Tensor:
    """Rows ``ids`` of ``c`` as f32, where ``c`` lies."""
    if isinstance(c, torch.Tensor):
        return c[torch.from_numpy(ids).to(c.device)].to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(c[ids], dtype=np.float32))


def _f32_rows(r: ArrayLike) -> ArrayLike:
    """Float rows as f32 where they lie (NumPy on the host, a tensor on
    its own device)."""
    if not _is_float(r.dtype):
        raise ValueError("ClusteredCorpus requires float embeddings")
    if isinstance(r, torch.Tensor):
        return r.to(torch.float32)
    return np.ascontiguousarray(r, dtype=np.float32)


class ClusteredCorpus:
    """K-means clustered, device-resident corpus for probed top-k search.

    ``clusters`` defaults to about one cluster per 4 layout tiles (the
    cluster-tail padding then costs about n/8 rows).  ``storage`` composes
    as on ``Corpus``: "bf16" (half the bytes), "int8" (a quarter), "int4"
    (an eighth); int8 / int4 rows are quantized before they are assigned.

    The layout tile (``layout_tile_rows``) and the query rows that share a
    tile list (``probe_block_rows``) follow the config's ``block_n`` and
    ``block_q`` as in the JAX package, so both packages list the same
    tiles; kernel A's own tiles do not depend on them.

    ``topk(..., probe=0.05)`` visits the best ~5 % of tiles per query
    block; ``probe=None`` is an exhaustive scan.  Probed results may hold
    fewer than k real matches; unfilled slots carry the sentinels
    (index INT32_MAX, score -inf similarity / +inf distance).

    ``device=`` as on ``Corpus``: a torch tensor is clustered and stored
    on its own device unless asked otherwise, NumPy goes to "cuda".

    ``add`` and ``update`` place rows by the fitted centroids (no refit;
    ``drift`` counts them) and ``rebuild`` refits on the live rows, all
    on the handle's device, with the JAX package's placement, so that the
    same steps from the same saved file give the same layout.

    ``mesh=`` (``parallel.make_mesh``) lays the tiles out for the mesh as
    the JAX package does (dead tiles so that every shard holds the same
    whole number of tiles, the reserve included, then a round-robin
    stripe of the tiles over the shards, so every shard holds a slice of
    every cluster) and serves requests by ``distributed_topk`` with an
    equal probe budget a shard.  On a mesh, ``add`` scatters in place
    while the rows fit slack or reserve tiles, else gathers, appends and
    re-shards; ``update`` writes rows in place at their current slots;
    ``rebuild`` re-shards the new layout.  The handle's device is the
    mesh's home device (``device=`` is not taken).
    """

    def __init__(self, embeddings: ArrayLike, *,
                 clusters: Optional[int] = None, storage: str = "f32",
                 mesh=None, config: Optional[SearchConfig] = None,
                 seed: int = 0, kmeans_iters: int = 8,
                 sample_rows: int = 131072, reserve_tiles: int = 0,
                 device: DeviceLike = None):
        cfg = resolve(config)
        c = _as_input(embeddings)
        if c.ndim != 2:
            raise ValueError("Embeddings must be 2-D (n_rows, dim) matrices")
        if c.shape[0] == 0:
            raise ValueError("Empty series")
        if c.shape[1] == 0:
            raise ValueError("Zero-dimensional vectors")
        if storage not in ("f32", "bf16", "int8", "int4"):
            raise ValueError(f"Unknown storage mode: {storage!r}")
        if not _is_float(c.dtype):
            raise ValueError(
                "ClusteredCorpus requires float embeddings (clustering "
                "needs the values; pre-quantized codes belong on Corpus)"
            )
        if mesh is not None and device is not None:
            raise ValueError("device= and mesh= are exclusive: a mesh "
                             "handle lives on the mesh's devices")
        if clusters is not None and int(clusters) < 1:
            raise ValueError(f"clusters must be >= 1, got {clusters}")
        if int(reserve_tiles) < 0:
            raise ValueError(
                f"reserve_tiles must be >= 0, got {reserve_tiles}")
        self.config = cfg
        self.storage = storage
        self.mesh = mesh
        self.n, self.dim = c.shape
        self.dtype = _F32   # f32 or quantized: the kernel path
        self.device = (mesh.home if mesh is not None
                       else resolve_device(device, c))
        # The tile stripe of a mesh layout (``_align_layout_for_mesh``).
        self._striped_for = self._stripe_lt = None
        self._tn = layout_tile_rows(self.dim, cfg, 1)
        self._chunk_rows = max(1, cfg.prep_chunk_bytes // (4 * self.dim))
        if clusters is None:
            clusters = self._default_clusters(self.n)

        # Cluster: sampled k-means, then the chunked assignment of all rows.
        cent = self._fit_sampled(lambda ids: _gather_rows(c, ids),
                                 np.arange(self.n),
                                 int(min(clusters, self.n)), sample_rows,
                                 kmeans_iters, seed)
        self._set_centroids(cent)
        scales = None
        if storage in ("int8", "int4"):
            # Quantize before the assignment, so that it reads the codes
            # (a host corpus uploads a quarter or an eighth of its f32
            # bytes) and places each row by the value it serves.
            src, scales = quantize_stored(c, storage, self.dim, self.device,
                                          self._chunk_rows)
            assign = assign_rows_native(src, scales, self.centroids, storage,
                                        self.dim)
        else:
            src = (np.ascontiguousarray(c, dtype=np.float32)
                   if isinstance(c, np.ndarray) else c.to(torch.float32))
            assign = assign_rows(src, self.centroids)
        self.layout: ClusterLayout = cluster_layout(assign, self.clusters,
                                                    self._tn)
        # Dead tiles (cluster -1) appended as the growth reserve of a later
        # add; kept so that save files carry it.  A mesh layout folds the
        # reserve into its alignment instead.
        self._reserve_tiles = int(reserve_tiles)
        if mesh is None:
            self._extend_dead_tiles(self._reserve_tiles)

        # The permuted storage-native rows: gathered where the source lies
        # (a NumPy source on the host, so only the result is uploaded).
        perm = torch.from_numpy(self.layout.perm)
        src = torch.as_tensor(src)
        base = permute_rows(src, perm.to(src.device))
        if storage == "bf16":
            base = base.to(torch.bfloat16)
        del src
        scales_p = None
        if scales is not None:
            scales = torch.as_tensor(scales)
            live = (perm >= 0).to(scales.device)
            scales_p = torch.where(live, permute_rows(scales, perm),
                                   torch.ones((), device=scales.device))
        self._install_payload(base, scales_p)
        self._tombstones: Optional[np.ndarray] = None
        self._drift_rows = 0

    # -- construction -----------------------------------------------------
    def _default_clusters(self, n: int) -> int:
        """Constructor default: about four layout tiles per cluster."""
        return max(1, -(-n // (4 * self._tn)))

    def _fit_sampled(self, get_rows, ids: np.ndarray, clusters: int,
                     sample_rows: int, kmeans_iters: int,
                     seed: int) -> torch.Tensor:
        """k-means on at most ``sample_rows`` of ``ids`` drawn from
        ``seed`` (the JAX package's draw; ``get_rows(ids)`` gives their
        values), on the handle's device.  kmeans clamps the cluster count
        to the sample size."""
        rng = np.random.default_rng(seed)
        if ids.size > sample_rows:
            ids = rng.choice(ids, sample_rows, replace=False)
        x = get_rows(ids).to(device=self.device, dtype=torch.float32)
        return kmeans(x, clusters, iters=kmeans_iters, seed=seed)[0]

    def _set_centroids(self, cent) -> None:
        self.centroids = torch.as_tensor(cent).to(device=self.device,
                                                  dtype=torch.float32)
        self.clusters = int(self.centroids.shape[0])

    def _extend_dead_tiles(self, r_tiles: int) -> None:
        """Append ``r_tiles`` dead tiles (cluster -1, all rows slack)."""
        if r_tiles <= 0:
            return
        lay, tn = self.layout, self._tn
        perm = np.concatenate([lay.perm, np.full(r_tiles * tn, -1, np.int32)])
        tcl = np.concatenate([lay.tile_cluster,
                              np.full(r_tiles, -1, np.int32)])
        self.layout = ClusterLayout(perm, lay.row_pos, tcl, lay.counts, tn)

    def _install_payload(self, base: torch.Tensor,
                         scales: Optional[torch.Tensor]) -> None:
        """Put a permuted payload matching ``self.layout`` on the device,
        or, on a mesh, align and stripe the layout for it and shard the
        payload re-ordered to match; drop every cache derived from the
        layout."""
        if self.mesh is not None:
            g = self._align_layout_for_mesh()
            if g is not None:
                # Position len(base) selects the appended zero row.
                gi = torch.from_numpy(g).to(base.device)
                base = torch.cat([base, base.new_zeros(
                    (1,) + tuple(base.shape[1:]))])[gi]
                if scales is not None:
                    scales = torch.cat([scales, scales.new_ones(1)])[gi]
            self._install_mesh_payload(base, scales)
            return
        dev = self.device
        self._base = base.to(dev)
        self._scales = None if scales is None else scales.to(
            device=dev, dtype=torch.float32)
        self._layout_changed()

    # -- mesh construction ------------------------------------------------
    def _align_layout_for_mesh(self) -> Optional[np.ndarray]:
        """Make the layout mesh-ready (the JAX package's, slot for slot):
        pad with dead tiles (cluster -1) so that every shard owns the same
        whole number of tiles, the ``reserve_tiles`` reserve included,
        then stripe the tiles round-robin over the shards, so that a
        cluster's consecutive tiles land on consecutive shards (the probe
        budget is a shard's: without the stripe a cluster-contiguous
        layout would put a query's tiles on one shard).  An existing
        stripe is undone first, and the dead tiles re-derived.  Returns
        the row gather (new padded position -> old one, the old height for
        a dead row), or None where the layout is already aligned and
        striped for this mesh."""
        lay = self.layout
        tn = self._tn
        n_shards = self.mesh.shape[self.config.mesh_axes[1]]
        n_t = lay.n_tiles
        old_rows = lay.perm.shape[0]
        src_tile = np.arange(n_t, dtype=np.int64)  # canonical -> current
        if self._striped_for and self._stripe_lt:
            s0, lt0 = self._striped_for, self._stripe_lt
            t0 = s0 * lt0
            if t0 <= n_t:
                t = np.arange(t0, dtype=np.int64)
                src_tile[:t0] = (t % s0) * lt0 + t // s0
        live_t = src_tile[lay.tile_cluster[src_tile] != -1]
        if live_t.size:
            src_tile = live_t
        tc = src_tile.size
        lt = max(1, -(-(tc + self._reserve_tiles) // n_shards))
        total = lt * n_shards
        self._lt = lt
        if n_t == total and (n_shards == 1
                             or (self._striped_for == n_shards
                                 and self._stripe_lt == lt)):
            return None
        self._striped_for = n_shards
        self._stripe_lt = lt
        # New position j (shard j // lt, slot j % lt) takes canonical tile
        # (j % lt) * n_shards + j // lt; past the live tiles, dead padding.
        j = np.arange(total, dtype=np.int64)
        ct = (j % lt) * n_shards + j // lt
        old_tile = np.where(ct >= tc, n_t, src_tile[np.minimum(ct, tc - 1)])
        gather = np.minimum(
            (old_tile[:, None] * tn
             + np.arange(tn, dtype=np.int64)).reshape(-1), old_rows)
        perm = np.concatenate(
            [lay.perm, np.full(1, -1, np.int32)])[gather]
        tcl = np.concatenate(
            [lay.tile_cluster, np.full(1, -1, np.int32)])[
                np.minimum(old_tile, n_t)]
        row_pos = lay.row_pos.copy()
        live = perm >= 0
        row_pos[perm[live]] = np.flatnonzero(live).astype(np.int32)
        self.layout = ClusterLayout(perm, row_pos, tcl, lay.counts, tn)
        return gather

    def _install_mesh_payload(self, base: torch.Tensor,
                              scales: Optional[torch.Tensor]) -> None:
        """Shard a permuted payload matching the aligned layout (its
        whole padded height) over the mesh's corpus axis."""
        axis = self.config.mesh_axes[1]
        n_padded = self.layout.n_padded
        n_shards = self.mesh.shape[axis]
        ns = n_padded // n_shards
        quant = self.storage in ("int8", "int4")
        self._sharded = ShardedCorpus(
            place_shards(base, self.mesh, axis, ns), n_padded, n_shards, ns,
            base.shape[1], base.dtype,
            scales=None if scales is None else place_shards(
                scales, self.mesh, axis, ns, 1.0, torch.float32),
            dim=self.dim if quant else None,
            storage=self.storage if quant else "f32")
        self._base = self._scales = None
        self._layout_changed()

    def _native(self, device=None):
        """(permuted storage-native rows, scales or None) of the current
        layout: the device payload, or the gathered shards of a mesh."""
        if self.mesh is not None:
            return self._sharded.gather(self.mesh, device)
        return self._base, self._scales

    def _layout_changed(self) -> None:
        """Refresh the device copies of ``self.layout`` and drop every
        cache derived from the layout or the payload."""
        dev = self.device
        self._perm_dev = torch.from_numpy(self.layout.perm).to(dev)
        self._tile_cluster_dev = torch.from_numpy(
            self.layout.tile_cluster).to(dev)
        self._live_dev = self._perm_dev >= 0
        self._prepared = {}   # (metric, core) -> (cp, cbp)
        self._dense = None
        self._perm_mask_dev = None

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        where = (f"shards={self.mesh.shape[self.config.mesh_axes[1]]}"
                 if self.mesh is not None
                 else f"device={str(self.device)!r}")
        return (f"ClusteredCorpus(n={self.n}, dim={self.dim}, "
                f"clusters={self.clusters}, tiles={self.layout.n_tiles}, "
                f"storage={self.storage!r}, {where})")

    @property
    def n_tiles(self) -> int:
        return self.layout.n_tiles

    @property
    def drift(self) -> float:
        """Rows added or updated since the centroids were last fit
        (construction, ``rebuild``, or the fit a loaded file carries),
        over the current row count: those rows were placed by stale
        centroids, so probed recall may decay as it grows.  Exhaustive
        search never degrades; ``rebuild()`` refits and resets it."""
        return self._drift_rows / max(1, self.n)

    @property
    def deleted_count(self) -> int:
        return 0 if self._tombstones is None else int(self._tombstones.sum())

    # -- mutation ---------------------------------------------------------
    def add(self, rows: ArrayLike) -> int:
        """Append rows; returns the new row count (ids ``n..n+m-1``).

        Each row joins its nearest centroid's cluster (no refit): it fills
        that cluster's tile-tail slack first, then a claimed dead tile
        (``reserve_tiles``, lowest id first), then whole tiles appended
        at the end of the layout.  The rows are scattered into the stored
        payload on the device; prepared forms rebuild on the next query.
        On a mesh, rows that fit slack or claimed dead tiles are
        scattered into their shards and the shards' prepared forms in
        place; appended tiles make it gather the payload, splice the rows
        in and re-shard (re-striping, so the new tiles spread too)."""
        r = _as_input(rows)
        _check_width(r, self.dim)
        cf = _f32_rows(r)
        m = r.shape[0]
        if m == 0:
            return self.n
        ids = np.arange(self.n, self.n + m, dtype=np.int64)
        assign = assign_rows(cf, self.centroids)
        if self.mesh is not None:
            self._mesh_add(ids, cf, assign)
        else:
            self._place_and_scatter(ids, cf, assign)
        if self._tombstones is not None:
            self._tombstones = np.concatenate(
                [self._tombstones, np.zeros(m, bool)])
        self.n += m
        self._drift_rows += m
        return self.n

    def update(self, indices, rows: ArrayLike) -> None:
        """Overwrite rows in place by original id (upsert).  Rows keep
        their ids but move to their new nearest cluster; the slots they
        leave become slack that later adds and updates refill.  Updating a
        tombstoned row revives it."""
        idx = _host_ids(indices)
        r = _as_input(rows)
        _check_width(r, self.dim)
        if idx.size != r.shape[0]:
            raise ValueError(f"got {idx.size} indices for {r.shape[0]} rows")
        if idx.size == 0:
            return
        if not np.issubdtype(idx.dtype, np.integer):
            raise ValueError(
                f"update indices must be integers, got dtype {idx.dtype}")
        if idx.min() < 0 or idx.max() >= self.n:
            raise ValueError(
                f"update indices must be in [0, {self.n}); got "
                f"[{idx.min()}, {idx.max()}]")
        if _repeats(idx):
            raise ValueError("update indices must be unique")
        cf = _f32_rows(r)
        if self.mesh is not None:
            # In place at the rows' current slots, without moving them:
            # exhaustive results are exact either way, and the stale
            # placement is what ``drift`` counts.
            self._sharded.scatter(self.layout.row_pos[idx].astype(np.int64),
                                  cf, self.config)
        else:
            self._place_and_scatter(idx.astype(np.int64), cf,
                                    assign_rows(cf, self.centroids),
                                    free_first=True)
        self._drift_rows += int(idx.size)
        if self._tombstones is not None and self._tombstones[idx].any():
            self._tombstones[idx] = False
            self._perm_mask_dev = None

    def _quantize_native(self, cf: ArrayLike):
        """f32 rows -> (storage-native rows, scales or None), quantized
        where they lie (see ``quantize_stored``)."""
        if self.storage in ("int8", "int4"):
            return quantize_stored(cf, self.storage, self.dim, self.device,
                                   self._chunk_rows)
        vals = torch.as_tensor(cf)
        return (vals.to(torch.bfloat16) if self.storage == "bf16"
                else vals), None

    def _mesh_add(self, ids: np.ndarray, cf: ArrayLike,
                  assign: np.ndarray) -> None:
        """``add`` on a mesh: place the rows, then scatter them in place
        where the padded height held, else gather, splice and re-shard."""
        n_old = self.layout.n_padded
        pos = self._place(ids, assign)
        if self.layout.n_padded == n_old:
            self._sharded.scatter(pos, cf, self.config)
            self._layout_changed()
            return
        base, scales = self._native()
        vals, vscales = self._quantize_native(cf)
        dev = base.device
        pos_d = torch.from_numpy(pos).to(dev)
        new_base = base.new_zeros((self.layout.n_padded,)
                                  + tuple(base.shape[1:]))
        new_base[:n_old] = base
        new_base[pos_d] = torch.as_tensor(vals).to(device=dev,
                                                   dtype=base.dtype)
        new_scales = None
        if scales is not None:
            new_scales = scales.new_ones(self.layout.n_padded)
            new_scales[:n_old] = scales
            new_scales[pos_d] = torch.as_tensor(vscales).to(dev)
        del base, scales
        self._install_payload(new_base, new_scales)

    def _place_and_scatter(self, ids: np.ndarray, cf: ArrayLike,
                           assign: np.ndarray,
                           free_first: bool = False) -> None:
        """Place rows ``ids`` in their assigned clusters (``_place``),
        grow the payload by the appended tiles, scatter the
        storage-native rows into it on the device, and refresh what hangs
        off the layout."""
        n_old = self.layout.n_padded
        pos = self._place(ids, assign, free_first=free_first)
        ext = self.layout.n_padded - n_old
        vals, scales = self._quantize_native(cf)
        dev = self.device
        if ext:
            self._base = torch.cat([self._base, self._base.new_zeros(
                (ext,) + tuple(self._base.shape[1:]))])
            if self._scales is not None:
                self._scales = torch.cat([self._scales,
                                          self._scales.new_ones(ext)])
        pos_d = torch.from_numpy(pos).to(dev)
        self._base[pos_d] = torch.as_tensor(vals).to(
            device=dev, dtype=self._base.dtype)
        if scales is not None:
            self._scales[pos_d] = torch.as_tensor(scales).to(dev)
        self._layout_changed()

    def _place(self, ids: np.ndarray, assign: np.ndarray,
               free_first: bool = False) -> np.ndarray:
        """Host placement (the JAX package's ``_place``, slot for slot):
        give each id a position in the layout, in its cluster's tile-tail
        slack first, then in claimed dead tiles (relabelled to the
        cluster, lowest id first), then in whole tiles appended at the
        end; install the grown ``self.layout`` and return the (m,)
        positions.  ``free_first`` first releases the ids' current
        positions to slack (update: a moved row's old slot can be reused
        within the same batch)."""
        lay, tn = self.layout, self._tn
        perm = lay.perm.copy()
        counts = lay.counts.copy()
        row_pos = lay.row_pos.copy()
        tile_cluster = lay.tile_cluster.copy()
        if free_first:
            old = row_pos[ids].astype(np.int64)
            perm[old] = -1
            np.subtract.at(counts, tile_cluster[old // tn], 1)
        n_old = perm.shape[0]
        # Slack positions grouped by their tile's cluster, ascending within
        # a cluster (a stable sort of ascending positions).
        slack_pos = np.flatnonzero(perm < 0)
        slack_cl = tile_cluster[slack_pos // tn]
        by_cl = np.argsort(slack_cl, kind="stable")
        slack_pos, slack_cl = slack_pos[by_cl], slack_cl[by_cl]
        dead_tiles = np.flatnonzero(tile_cluster == -1)
        next_dead = 0

        m = ids.shape[0]
        pos = np.full(m, -1, np.int64)
        append_tiles, ext_perm = [], []
        next_pos = n_old
        order = np.argsort(assign, kind="stable")
        a_sorted = assign[order]
        for cl in np.unique(assign):
            sel = order[np.searchsorted(a_sorted, cl):
                        np.searchsorted(a_sorted, cl, side="right")]
            sl = slack_pos[np.searchsorted(slack_cl, cl):
                           np.searchsorted(slack_cl, cl, side="right")]
            take = min(sl.size, sel.size)
            pos[sel[:take]] = sl[:take]
            over = sel[take:]
            while over.size and next_dead < dead_tiles.size:
                t = int(dead_tiles[next_dead])
                next_dead += 1
                tile_cluster[t] = cl
                take2 = min(tn, over.size)
                pos[over[:take2]] = t * tn + np.arange(take2,
                                                       dtype=np.int64)
                over = over[take2:]
            if over.size:
                nt = -(-over.size // tn)
                append_tiles.extend([int(cl)] * nt)
                pos[over] = next_pos + np.arange(over.size, dtype=np.int64)
                ep = np.full(nt * tn, -1, np.int32)
                ep[: over.size] = ids[over]
                ext_perm.append(ep)
                next_pos += nt * tn
            counts[cl] += sel.size
        infill = pos < n_old
        perm[pos[infill]] = ids[infill].astype(np.int32)
        if ext_perm:
            perm = np.concatenate([perm] + ext_perm)
        if append_tiles:
            tile_cluster = np.concatenate(
                [tile_cluster, np.array(append_tiles, np.int32)])
        top = int(ids.max()) + 1
        if top > row_pos.shape[0]:
            row_pos = np.concatenate([
                row_pos, np.empty(top - row_pos.shape[0], np.int32)])
        row_pos[ids] = pos.astype(np.int32)
        self.layout = ClusterLayout(perm, row_pos, tile_cluster, counts, tn)
        return pos

    def rebuild(self, *, clusters: Optional[int] = None, seed: int = 0,
                kmeans_iters: int = 8,
                sample_rows: int = 131072) -> "ClusteredCorpus":
        """Refit the centroids on the live rows and lay the corpus out
        anew, on the handle's device: drift recovery after heavy ``add``
        / ``update`` traffic.  The storage-native rows are permuted into
        the new layout, never quantized again, so exhaustive results are
        the same before and after; row ids and tombstones stay.
        ``clusters=None`` is the constructor's default for the current
        row count.  Resets ``drift``."""
        n = self.n
        if clusters is None:
            clusters = self._default_clusters(n)
        elif int(clusters) < 1:
            raise ValueError(f"clusters must be >= 1, got {clusters}")
        self._prepared, self._dense = {}, None
        dev = self.device
        # The stored rows in original row order.
        old_pos = torch.from_numpy(
            self.layout.row_pos[:n].astype(np.int64)).to(dev)
        base_all, scales_all = self._native()
        orig = base_all[old_pos]
        orig_scales = None if scales_all is None else scales_all[old_pos]
        del base_all, scales_all

        def values(ids: np.ndarray) -> torch.Tensor:
            """f32 values of rows ``ids`` (dequantized codes)."""
            sel = torch.from_numpy(ids.astype(np.int64)).to(dev)
            rows = orig[sel]
            if self.storage == "int8":
                return rows.to(torch.float32) * orig_scales[sel, None]
            if self.storage == "int4":
                return dequant_int4(rows, orig_scales[sel], self.dim)
            return rows.to(torch.float32)

        live_ids = (np.arange(n) if self._tombstones is None
                    else np.flatnonzero(~self._tombstones))
        if live_ids.size == 0:
            live_ids = np.arange(n)   # all tombstoned: fit on the bytes
        self._set_centroids(self._fit_sampled(
            values, live_ids, int(min(clusters, live_ids.size)),
            sample_rows, kmeans_iters, seed))
        if orig_scales is not None:
            assign = assign_rows_native(orig, orig_scales, self.centroids,
                                        self.storage, self.dim)
        else:
            assign = assign_rows(orig, self.centroids)
        self.layout = cluster_layout(assign, self.clusters, self._tn)
        perm = torch.from_numpy(self.layout.perm).to(dev)
        base = permute_rows(orig, perm)
        del orig
        scales = None
        if orig_scales is not None:
            scales = torch.where(perm >= 0, permute_rows(orig_scales, perm),
                                 torch.ones((), device=dev))
        self._striped_for = self._stripe_lt = None
        self._install_payload(base, scales)
        self._drift_rows = 0
        return self

    @classmethod
    def from_arrow(cls, column, **kwargs) -> "ClusteredCorpus":
        """A clustered corpus straight from an Arrow (or polars) embedding
        column or its buffers, with ``Corpus.from_arrow``'s extraction and
        the constructor's keywords (``clusters=``, ``storage=``,
        ``config=``, ``device=``, ...)."""
        from ..interop.arrow import extract_embedding_column

        return cls(extract_embedding_column(column), **kwargs)

    def delete(self, indices: ArrayLike) -> int:
        """Tombstone rows by original id; they stop matching at once
        (through the mask, no re-clustering).  Returns the number newly
        deleted."""
        idx = _host_ids(indices).astype(np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n):
            raise IndexError(
                f"delete index out of range for corpus of {self.n} rows")
        if self._tombstones is None:
            self._tombstones = np.zeros(self.n, bool)
        before = int(self._tombstones.sum())
        self._tombstones[idx] = True
        self._perm_mask_dev = None
        return int(self._tombstones.sum()) - before

    # -- search helpers ---------------------------------------------------
    def _effective_precision(self) -> str:
        """The kernel core: a quantized tier runs its own, f32 the
        config's."""
        return _TIER_CORE.get(self.storage,
                              kernel_precision(self.config.precision))

    def _prepared_for(self, metric: Metric):
        """(cp, cbp) for this metric with the slack rows dead (-inf bias):
        they sit inside the layout, so a suffix rule cannot see them.
        Codes (and rows the prep keeps as they are) are shared, not
        copied."""
        precision = self._effective_precision()
        key = (metric.value, precision)
        if key not in self._prepared:
            cp, cbp = prepare_stored(self._base, self._scales, metric,
                                     precision, self._chunk_rows)
            bias = cbp[-1] if cbp.ndim == 2 else cbp
            bias.masked_fill_(~self._live_dev, float("-inf"))
            self._prepared[key] = (cp, cbp)
        return self._prepared[key]

    def _permuted_mask(self, user_mk) -> Optional[torch.Tensor]:
        """(n_padded,) bool on the device in permuted space, or None: the
        user's mask and the tombstones; slack rows False (their bias is
        -inf anyway)."""
        if user_mk is None and self._tombstones is None:
            return None
        if user_mk is None and self._perm_mask_dev is not None:
            return self._perm_mask_dev
        if user_mk is None:
            combined = np.ones(self.n, bool)
        elif isinstance(user_mk, torch.Tensor):
            combined = user_mk.cpu().numpy().astype(bool)
        else:
            combined = user_mk.astype(bool)
        if self._tombstones is not None:
            combined = combined & ~self._tombstones
        perm = self.layout.perm
        pm = np.zeros(self.layout.n_padded, bool)
        live = perm >= 0
        pm[live] = combined[perm[live]]
        dev = torch.from_numpy(pm).to(self.device)
        if user_mk is None:
            self._perm_mask_dev = dev
        return dev

    def _route_order(self, q: ArrayLike, metric: Metric):
        """Stable query order grouping rows by their best cluster by
        ``centroid_scores`` (first index among equal scores); None when
        every query agrees on a cluster.  The JAX package scores on the
        host; here the scores run on the handle's device."""
        s = centroid_scores(_to_torch(q, _F32, self.device), self.centroids,
                            metric)
        best = torch.argmax(s, dim=1).cpu().numpy()
        if (best == best[0]).all():
            return None
        return np.argsort(best, kind="stable")

    def _dense_view(self) -> torch.Tensor:
        """(n_padded, dim) f32 rows in permuted space (slack rows zero),
        built once for matmul and the reference path."""
        if self._dense is None:
            base = self._base
            if self.storage == "int8":
                self._dense = base.to(torch.float32) * self._scales[:, None]
            elif self.storage == "int4":
                self._dense = dequant_int4(base, self._scales, self.dim)
            else:
                self._dense = base.to(torch.float32)
        return self._dense

    def _row_ids(self, idx: torch.Tensor) -> torch.Tensor:
        """Permuted positions -> original row ids, keeping the sentinel:
        an unfilled slot's INT32_MAX must not go through the permutation."""
        safe = torch.clamp(idx.long(), 0, self.layout.n_padded - 1)
        g = self._perm_dev[safe]
        return torch.where((idx == INT32_MAX) | (g < 0),
                           torch.full_like(g, INT32_MAX), g)

    def _fallback_topk(self, q: torch.Tensor, kk: int, metric: Metric,
                       user_mk) -> Tuple[np.ndarray, np.ndarray]:
        """The exhaustive reference path for problems the fused kernels
        decline (k > max_fused_k, use_pallas=False): probe= is ignored, the
        result is exact."""
        mk = self._permuted_mask(user_mk)
        mk = self._live_dev if mk is None else (mk & self._live_dev)
        vals, idx = reference.topk_search(q.to(torch.float32),
                                          self._dense_view(), kk, metric,
                                          mask=mk)
        return _to_host(vals, self._row_ids(idx))

    def _mesh_topk(self, q: ArrayLike, kk: int, metric: Metric, probe,
                   user_mk) -> Tuple[np.ndarray, np.ndarray]:
        """Sharded probed or exhaustive top-k: ``probe`` resolves against
        a shard's tile count (an equal budget a shard), the shards merge
        in permuted space, and the positions map back to row ids.  The
        mask is always given: it kills slack and dead-tile rows, whose
        prepared bias the sharded prep leaves finite."""
        p_local, exhaustive = resolve_probe(probe, self._lt)
        pr = (None if exhaustive else
              (self.centroids, self._tile_cluster_dev, int(p_local),
               self._tn))
        mk = self._permuted_mask(user_mk)
        vals, idx = distributed_topk(
            _to_torch(q, _F32, self.device), self._sharded, kk, metric,
            self.mesh, self.config,
            mask=self._live_dev if mk is None else mk, probe=pr)
        return _to_host(vals, self._row_ids(idx))

    # -- persistence ------------------------------------------------------
    def save(self, path) -> None:
        """Persist to ``path`` (.npz) in the JAX package's format, which its
        ``ClusteredCorpus.load`` reads: the storage-native permuted rows
        (slack rows included), the layout, the centroids and the
        tombstones.  A mesh handle gathers its shards (every rank takes
        part) and writes its stripe."""
        base, scales = self._native("cpu")
        base = base.cpu()
        arrays = {
            "n": np.int64(self.n),
            "dim": np.int64(self.dim),
            "storage": np.array(self.storage),
            "clusters": np.int64(self.clusters),
            "tn": np.int64(self._tn),
            "perm": self.layout.perm,
            "tile_cluster": self.layout.tile_cluster,
            "counts": self.layout.counts,
            "centroids": self.centroids.cpu().numpy(),
        }
        if self.storage == "bf16":
            arrays["data_u16"] = base.view(torch.int16).numpy().view(
                np.uint16)
        else:
            arrays["data"] = base.numpy()
        if scales is not None:
            arrays["scales"] = scales.cpu().numpy()
        if self._tombstones is not None:
            arrays["tombstones"] = self._tombstones
        if self._drift_rows:
            arrays["drift_rows"] = np.int64(self._drift_rows)
        if self._striped_for:
            arrays["striped_for"] = np.int64(self._striped_for)
            arrays["stripe_lt"] = np.int64(self._stripe_lt)
        if self._reserve_tiles:
            arrays["reserve_tiles"] = np.int64(self._reserve_tiles)
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, path, *, mesh=None, config: Optional[SearchConfig] = None,
             device: DeviceLike = None) -> "ClusteredCorpus":
        """Rebuild a corpus saved by either package's ``save``: the saved
        rows, layout and centroids are installed as they are (no
        clustering, no quantization), so probed results match the saved
        handle's.  ``config`` steers only the query side; the layout tile
        is the file's.  ``mesh=`` shards it (the layout gains dead
        alignment tiles and the stripe if the mesh needs them; results are
        unchanged: dead rows never match)."""
        if mesh is not None and device is not None:
            raise ValueError("device= and mesh= are exclusive: a mesh "
                             "handle lives on the mesh's devices")
        with np.load(path, allow_pickle=False) as z:
            storage = str(z["storage"])
            if storage == "bf16":
                base = torch.from_numpy(
                    z["data_u16"].view(np.int16)).view(torch.bfloat16)
            else:
                base = torch.from_numpy(np.array(z["data"]))
            scales = (torch.from_numpy(np.asarray(z["scales"], np.float32))
                      if "scales" in z else None)
            perm = z["perm"]
            tile_cluster = z["tile_cluster"]
            counts = z["counts"]
            centroids = z["centroids"]
            n, dim = int(z["n"]), int(z["dim"])
            tn = int(z["tn"])
            tomb = z["tombstones"] if "tombstones" in z else None
            drift_rows = int(z["drift_rows"]) if "drift_rows" in z else 0
            striped_for = (int(z["striped_for"])
                           if "striped_for" in z else None)
            stripe_lt = int(z["stripe_lt"]) if "stripe_lt" in z else None
            reserve_tiles = (int(z["reserve_tiles"])
                             if "reserve_tiles" in z else 0)
        self = cls.__new__(cls)
        self.config = resolve(config)
        self.storage = storage
        self.n, self.dim = n, dim
        self.dtype = _F32
        self.mesh = mesh
        self.device = mesh.home if mesh is not None else resolve_device(
            device)
        self._tn = tn
        self._chunk_rows = max(1, self.config.prep_chunk_bytes // (4 * dim))
        row_pos = np.empty(n, np.int32)
        live = perm >= 0
        row_pos[perm[live]] = np.flatnonzero(live).astype(np.int32)
        self.layout = ClusterLayout(perm, row_pos, tile_cluster, counts, tn)
        self._set_centroids(torch.from_numpy(np.asarray(centroids,
                                                        np.float32)))
        self._striped_for, self._stripe_lt = striped_for, stripe_lt
        self._reserve_tiles = reserve_tiles
        self._install_payload(base, scales)
        self._tombstones = (None if tomb is None or not tomb.any()
                            else tomb.astype(bool))
        self._drift_rows = drift_rows
        return self

    # -- operations -------------------------------------------------------
    def matmul(self, queries: ArrayLike) -> np.ndarray:
        """Raw pairwise Q . C^T (n_q, n) in original row order, on the
        stored (dequantized) rows; deleted rows still score, as on
        ``Corpus.matmul``."""
        q = _as_input(queries)
        dt = compute_dtype(q.dtype, self.dtype)
        if q.shape[0] == 0:
            return np.empty((0, self.n), dtype=dt)
        _check_width(q, self.dim)
        row_pos = torch.from_numpy(
            self.layout.row_pos[: self.n].astype(np.int64)).to(self.device)
        with annotate("pmm.clustered.matmul"):
            if self.mesh is not None:
                panel = distributed_matmul(_to_torch(q, dt, self.device),
                                           self._sharded, self.mesh,
                                           self.config)
            else:
                panel = pairwise_matmul(
                    _to_torch(q, dt, self.device),
                    self._dense_view().to(_torch_dtype(dt)),
                    precision=self.config.precision)
            return panel[:, row_pos].cpu().numpy()

    def topk(self, queries: ArrayLike, k: int,
             metric: Union[str, Metric] = "cosine", *,
             probe: Union[float, int, None] = None, mask=None,
             route: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the clustered corpus: ``(indices (m, k') u32, scores
        (m, k') f64)`` in original row ids, as ``Corpus.topk`` returns.

        ``probe`` bounds the layout tiles visited per query block: a float
        is a fraction of all tiles (the bytes-read budget), an int a tile
        count, None an exhaustive scan.  ``route`` (default True) reorders
        a probed batch of several blocks so that queries wanting the same
        cluster share a block (the budget is a per-block union); results
        come back in the caller's order.  Queries run in f32 (float64 ones
        are rounded; float16 / bfloat16 ones upload as they are).
        """
        metric = Metric.parse(metric)
        q = _as_input(queries)
        if q.shape[0] == 0:
            return np.empty((0, 0), np.uint32), np.empty((0, 0), np.float64)
        _check_width(q, self.dim)
        user_mk = _validate_mask(mask, self.n)
        kk = min(int(k), self.n)
        if kk <= 0:
            return _empty_topk(q.shape[0])
        cfg = self.config
        if route and probe is not None and q.shape[0] > probe_block_rows(
                q.shape[0], self.dim, cfg, kk):
            order = self._route_order(q, metric)
            if order is not None:
                sel = (torch.from_numpy(order).to(q.device)
                       if isinstance(q, torch.Tensor) else order)
                i_r, v_r = self.topk(q[sel], k, metric, probe=probe,
                                     mask=mask, route=False)
                inv = np.empty_like(order)
                inv[order] = np.arange(order.size)
                return (np.ascontiguousarray(i_r[inv]),
                        np.ascontiguousarray(v_r[inv]))
        if self.mesh is not None:
            with annotate(f"pmm.clustered.topk.{metric.value}"):
                return self._mesh_topk(q, kk, metric, probe, user_mk)
        p, exhaustive = resolve_probe(probe, self.layout.n_tiles)
        sup = supports(q.shape, (self.n, self.dim), torch.float32, kk, cfg)
        if not sup and self.storage != "f32" and kk <= max_fused_k(cfg):
            # Quantized storage above max_fused_dim stays on the kernel, as
            # on Corpus: the reference path would build the f32 rows.
            sup = True
        with annotate(f"pmm.clustered.topk.{metric.value}"):
            if not (cfg.use_pallas and sup):
                return self._fallback_topk(_to_torch(q, _F32, self.device),
                                           kk, metric, user_mk)
            qt = _to_torch(q, None if _is_half(q.dtype) else _F32,
                           self.device)
            cp, cbp = self._prepared_for(metric)
            tiles = None
            if not exhaustive:
                tiles = probe_tiles(
                    qt, self.centroids, self._tile_cluster_dev, p=p,
                    tm=probe_block_rows(q.shape[0], self.dim, cfg, kk),
                    metric_v=metric.value)
            vals, idx = fused_topk_prepared(
                qt, cp, cbp, kk, metric, mask=self._permuted_mask(user_mk),
                config=cfg, precision=self._effective_precision(),
                tiles=tiles, tn=self._tn)
            return _to_host(vals, self._row_ids(idx))

