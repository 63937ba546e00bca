"""Corpus clustering for probed (IVF-style) search (port of
``polars_matmul_tpu.ops.cluster``).

Corpus rows are k-means clustered and laid out so that each cluster owns
whole layout tiles; at query time a small (m x n_clusters) centroid
product ranks the tiles, and only the best ``P`` per query block are
visited by kernel A (``kernels.fused_topk`` with ``tiles=``): unlisted
tiles are never read.  Exact over the visited rows; recall against an
exhaustive scan is set by ``P`` and by how well the corpus clusters.

The layout builder is NumPy (host side, construction time) and gives the
JAX package's layouts bit for bit.  k-means, assignment and tile scoring
are plain torch on the tensors' device, with every float32 product exact
(TF32 off).  k-means draws from a ``torch.Generator`` seeded from
``seed``; its draws differ from ``jax.random``'s, so two packages give
different centroids from one seed.

A corpus row holding NaN or +-inf (a bad row, never returned by a search)
takes no part in a k-means fit, and every assignment places it in
cluster 0; a query row holding one ranks no tile for its block.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .metrics import Metric
from .reference import bad_rows, exact_matmul

# Rows each chunk of an assignment scores at once: the (chunk, clusters)
# distance panel is the only temporary.
CHUNK_ROWS = 65536


class ClusterLayout(NamedTuple):
    """Host-side description of a clustered corpus layout.

    perm       (n_padded,) int32: permuted position -> original row id,
               -1 on slack rows (cluster tails padded to whole tiles).
    row_pos    (n,) int32: original row id -> permuted position.
    tile_cluster (n_tiles,) int32: cluster id owning each layout tile
               (-1: a dead tile, all slack).
    counts     (n_clusters,) int64: rows per cluster.
    tn         tile height the layout is built for.
    """

    perm: np.ndarray
    row_pos: np.ndarray
    tile_cluster: np.ndarray
    counts: np.ndarray
    tn: int

    @property
    def n_tiles(self) -> int:
        return self.tile_cluster.shape[0]

    @property
    def n_padded(self) -> int:
        return self.perm.shape[0]


def _sq_dists(x: torch.Tensor, cent: torch.Tensor,
              csq: torch.Tensor) -> torch.Tensor:
    """-2 x.c + |c|^2: the squared distance less the row's own |x|^2."""
    with exact_matmul():
        return -2.0 * (x @ cent.T) + csq


def _kmeanspp_init(gen: torch.Generator, x: torch.Tensor,
                   n_clusters: int) -> torch.Tensor:
    """k-means++ D^2-weighted greedy seeding (a uniform start can put two
    seeds in one dense blob and none in a far one).  Each draw is a
    Gumbel-max sample of log(d2), as ``jax.random.categorical`` draws."""
    n, dev = x.shape[0], x.device
    xsq = torch.sum(x * x, dim=1)
    cents = torch.zeros((n_clusters, x.shape[1]), dtype=torch.float32,
                        device=dev)
    i0 = torch.randint(0, n, (), generator=gen, device=dev)
    cents[0] = x[i0]
    with exact_matmul():
        d2 = torch.clamp(xsq - 2.0 * (x @ x[i0]) + xsq[i0], min=0.0)
    tiny = torch.finfo(torch.float32).tiny
    for t in range(1, n_clusters):
        u = torch.rand(n, generator=gen, device=dev).clamp_(min=tiny)
        idx = torch.argmax(torch.log(d2 + 1e-30) - torch.log(-torch.log(u)))
        cnew = x[idx]
        cents[t] = cnew
        with exact_matmul():
            nd = torch.clamp(xsq - 2.0 * (x @ cnew) + torch.sum(cnew * cnew),
                             min=0.0)
        d2 = torch.minimum(d2, nd)
    return cents


def kmeans(x, n_clusters: int, *, iters: int = 8, seed: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means with k-means++ seeding, on ``x``'s device (euclidean
    geometry, the usual IVF coarse quantizer for every metric).

    Returns (centroids (C, dim) f32, assignments (n,) int32) with C =
    min(n_clusters, rows fitted).  A cluster that empties keeps its
    centroid.  Rows holding NaN or +-inf are left out of the fit (with
    none other, one zero centroid) and assigned to cluster 0.
    """
    whole = torch.as_tensor(x).to(torch.float32)
    x = whole[~bad_rows(whole)]
    n = x.shape[0]
    if n == 0:
        cent = whole.new_zeros((1, whole.shape[1]))
        return cent, _assign_tensor(whole, cent)
    n_clusters = int(min(n_clusters, n))
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    if n_clusters == 1:
        cent = torch.mean(x, dim=0, keepdim=True)
    else:
        cent = _kmeanspp_init(gen, x, n_clusters)
    for _ in range(int(iters)):
        a = _assign_tensor(x, cent).long()
        sums = torch.zeros_like(cent).index_add_(0, a, x)
        cnt = torch.bincount(a, minlength=n_clusters).to(torch.float32)
        cent = torch.where(cnt[:, None] > 0,
                           sums / torch.clamp(cnt, min=1.0)[:, None], cent)
    return cent, _assign_tensor(whole, cent)


def _assign_tensor(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row of a tensor on the centroids' device,
    in chunks of CHUNK_ROWS."""
    one = make_assigner(cent)
    return torch.cat([one(x[r0:r0 + CHUNK_ROWS])
                      for r0 in range(0, x.shape[0], CHUNK_ROWS)])


def _nearest(x: torch.Tensor, cent: torch.Tensor,
             csq: torch.Tensor) -> torch.Tensor:
    """(rows,) int32 nearest centroid of each row of ``x``, cluster 0 for a
    row holding NaN or +-inf (its distances are no order)."""
    near = torch.argmin(_sq_dists(x, cent, csq), dim=1)
    return torch.where(bad_rows(x), 0, near).to(torch.int32)


def make_assigner(centroids):
    """Nearest-centroid assigner of row chunks: (rows, dim) floats on any
    device -> (rows,) int32 on the centroids' device."""
    cent = torch.as_tensor(centroids).to(torch.float32)
    csq = torch.sum(cent * cent, dim=1)[None, :]

    def one(chunk) -> torch.Tensor:
        x = torch.as_tensor(chunk).to(device=cent.device,
                                      dtype=torch.float32)
        return _nearest(x, cent, csq)

    return one


def make_assigner_native(centroids, storage: str, dim: int):
    """Assigner over storage-native rows (int8 codes, or nibble-packed int4
    bytes) and their per-row scales, dequantized on the centroids'
    device, so that a host corpus uploads its codes rather than f32."""
    from ..kernels.fused_topk import dequant_int4

    cent = torch.as_tensor(centroids).to(torch.float32)
    csq = torch.sum(cent * cent, dim=1)[None, :]

    def one(rows, scales) -> torch.Tensor:
        rows = torch.as_tensor(rows).to(cent.device)
        scales = torch.as_tensor(scales).to(device=cent.device,
                                            dtype=torch.float32)
        if storage == "int4":
            x = dequant_int4(rows, scales, dim)
        else:
            x = rows.to(torch.float32) * scales[:, None]
        return _nearest(x, cent, csq)

    return one


def _chunk(x, r0: int, r1: int):
    if isinstance(x, torch.Tensor):
        return x[r0:r1]
    return torch.from_numpy(np.ascontiguousarray(x[r0:r1]))


def assign_rows(c, centroids, *, chunk_rows: int = CHUNK_ROWS) -> np.ndarray:
    """Nearest-centroid assignment of the whole corpus in row chunks (a
    NumPy corpus uploads one chunk at a time).  Returns host (n,) int32."""
    one = make_assigner(centroids)
    n = c.shape[0]
    parts = [one(_chunk(c, r0, min(n, r0 + chunk_rows)))
             for r0 in range(0, n, chunk_rows)]
    return torch.cat(parts).cpu().numpy()


def assign_rows_native(codes, scales, centroids, storage: str, dim: int,
                       *, chunk_rows: int = CHUNK_ROWS) -> np.ndarray:
    """``assign_rows`` over quantized rows: host or device chunks,
    dequantized and assigned on the centroids' device.  Returns host (n,)
    int32."""
    one = make_assigner_native(centroids, storage, dim)
    n = codes.shape[0]
    parts = [one(_chunk(codes, r0, min(n, r0 + chunk_rows)),
                 _chunk(scales, r0, min(n, r0 + chunk_rows)))
             for r0 in range(0, n, chunk_rows)]
    return torch.cat(parts).cpu().numpy()


def cluster_layout(assignments: np.ndarray, n_clusters: int,
                   tn: int) -> ClusterLayout:
    """Group rows by cluster and pad each cluster to whole ``tn``-row
    tiles, so a tile belongs to exactly one cluster and tile selection is
    a gather of cluster scores.  Empty clusters own zero tiles.  The JAX
    package's builder, line for line: both give the same layout.
    """
    assignments = np.asarray(assignments)
    n = assignments.shape[0]
    counts = np.bincount(assignments, minlength=n_clusters).astype(np.int64)
    cap = (counts + tn - 1) // tn * tn
    offsets = np.concatenate([[0], np.cumsum(cap)])
    n_padded = int(offsets[-1])

    order = np.argsort(assignments, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    a_sorted = assignments[order]
    pos_of_order = (offsets[a_sorted]
                    + np.arange(n, dtype=np.int64) - starts[a_sorted])

    perm = np.full(n_padded, -1, np.int32)
    perm[pos_of_order] = order
    row_pos = np.empty(n, np.int32)
    row_pos[order] = pos_of_order
    tile_cluster = np.repeat(
        np.arange(n_clusters, dtype=np.int32), cap // tn)
    return ClusterLayout(perm, row_pos, tile_cluster, counts, int(tn))


def permute_rows(c: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Gather into the clustered layout on ``c``'s device; slack rows (-1)
    are zero.  Works for float rows and int8 code rows alike."""
    perm = perm.to(c.device).long()
    out = c[torch.clamp(perm, 0, c.shape[0] - 1)]
    out[perm < 0] = 0
    return out


def centroid_scores(q: torch.Tensor, centroids: torch.Tensor,
                    metric) -> torch.Tensor:
    """(m, C) cluster relevance in maximize orientation for this metric.

    cosine:    normalized-q . normalized-centroid  (direction match)
    dot:       q . centroid  (magnitude-aware, like the metric itself)
    euclidean: 2 q.c - |c|^2  (= -|q - c|^2 up to the rank-invariant |q|^2)
    """
    metric = Metric.parse(metric)
    q = q.to(torch.float32)
    cent = centroids.to(torch.float32)
    with exact_matmul():
        if metric is Metric.COSINE:
            qn = torch.linalg.norm(q, dim=1, keepdim=True)
            cn = torch.linalg.norm(cent, dim=1, keepdim=True)
            return (q / torch.clamp(qn, min=1e-20)) @ (
                cent / torch.clamp(cn, min=1e-20)).T
        if metric is Metric.EUCLIDEAN:
            return 2.0 * (q @ cent.T) - torch.sum(cent * cent, dim=1)[None, :]
        return q @ cent.T


def probe_tiles(q: torch.Tensor, centroids: torch.Tensor,
                tile_cluster: torch.Tensor, *, p: int, tm: int,
                metric_v: str) -> torch.Tensor:
    """(n_query_blocks, p) ascending distinct layout-tile ids to visit.

    Ranks clusters per query by ``centroid_scores``, reduces to per-block
    scores with a max over the block's ``tm`` rows (a tile top-ranked for
    any query of the block is visited: the kernel scans per block), and
    takes the best ``p`` tiles.  Every tile of a cluster has the same
    score, so ties are the rule: a stable descending sort keeps lower tile
    ids first among equals, as ``jax.lax.top_k`` does, and the final
    ascending sort gives kernel A its ascending walk.  Dead tiles (cluster
    -1) rank -inf and are listed only once live tiles run out.  A query
    row holding NaN or +-inf scores -inf for every cluster, so it leaves
    its block's ranking to the other rows.
    """
    m = q.shape[0]
    mp = -(-m // tm) * tm
    s = centroid_scores(q, centroids, metric_v)                 # (m, C)
    s = torch.where(bad_rows(q)[:, None], float("-inf"), s)
    s = torch.nn.functional.pad(s, (0, 0, 0, mp - m),
                                value=float("-inf"))            # inert rows
    sb = torch.amax(s.reshape(mp // tm, tm, -1), dim=1)         # (QB, C)
    tcl = tile_cluster.to(device=sb.device, dtype=torch.long)
    ts = sb[:, torch.clamp(tcl, min=0)]                         # (QB, tiles)
    ts = torch.where(tcl[None, :] >= 0, ts,
                     torch.full_like(ts, float("-inf")))
    order = torch.sort(ts, dim=1, descending=True, stable=True).indices
    return torch.sort(order[:, :p], dim=1).values.to(torch.int32)


def resolve_probe(probe, n_tiles: int) -> Tuple[int, bool]:
    """User ``probe=`` -> (tile count P, is_exhaustive).

    float in (0, 1] = fraction of the corpus' tiles (bytes read scale
    with P / n_tiles); int >= 1 = explicit tile count.  None, or a value
    covering every tile, means an exhaustive dense scan.
    """
    if probe is None:
        return n_tiles, True
    if isinstance(probe, bool):
        raise TypeError("probe must be a float fraction, an int tile "
                        "count, or None")
    if isinstance(probe, float):
        if not 0.0 < probe <= 1.0:
            raise ValueError(f"probe fraction must be in (0, 1], "
                             f"got {probe}")
        p = max(1, int(np.ceil(probe * n_tiles)))
    else:
        p = int(probe)
        if p < 1:
            raise ValueError(f"probe tile count must be >= 1, got {p}")
    p = min(p, n_tiles)
    return p, p >= n_tiles
