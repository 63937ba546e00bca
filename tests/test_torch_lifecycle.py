"""Corpus mutation in the PyTorch port against the JAX package:
``Corpus(capacity=)`` / ``add`` / ``update`` / ``delete`` / ``save`` /
``load(capacity=)`` and ``ClusteredCorpus.add`` / ``update`` / ``delete``
/ ``rebuild``.

A JAX handle and a port handle (``device="cpu"``) go through the same
seeded steps.  The JAX side answers through its plain reference
(``SearchConfig(use_pallas=False)``) except in one short f32 sequence and
the probed requests, which run its Pallas kernel in interpret mode; the
port answers through its prepared forms and the kernels' plain versions,
so the in-place writes into those forms are what is held here.

Tolerances: scores agree within rtol 1e-4 / atol 5e-4 (the JAX package's
clustered tests against ``Corpus``), index differences only on tied
scores.  bf16 cosine allows atol 2^-8: the port's bf16c core scores rows
normalised and then rounded to bf16 (2^-9 relative a feature), the JAX
reference the unrounded quotient.  Against the float64 shadow oracle of
the stored values: index differences only among scores within 1e-2 of
each other (``tests/test_lifecycle_fuzz.py``'s rule), and no tombstoned
row ever returned.
"""

import zlib

import numpy as np
import pytest
import torch

import polars_matmul_tpu as pmt
import polars_matmul_tpu_torch as pt
from polars_matmul_tpu.config import SearchConfig as JConfig
from polars_matmul_tpu_torch import SearchConfig
from polars_matmul_tpu_torch.kernels import storage as pstorage
from polars_matmul_tpu_torch.kernels import fused_topk as F

from conftest import assert_topk_equivalent

torch.set_num_threads(2)

CPU = "cpu"
METRICS = ["cosine", "dot", "euclidean"]
STORAGES = ["f32", "bf16", "int8", "int4"]
PLAIN = JConfig(use_pallas=False)
JCL = JConfig(block_q=8, block_n=128)
PCL = SearchConfig(block_q=8, block_n=128)


def _same(got, want, storage="f32", metric="dot"):
    (gi, gs), (wi, ws) = got, want
    assert gi.dtype == wi.dtype == np.uint32
    assert gs.dtype == ws.dtype == np.float64
    atol = 2.0 ** -8 if (storage, metric) == ("bf16", "cosine") else 5e-4
    assert_topk_equivalent(gi.astype(np.int64), gs, wi.astype(np.int64), ws,
                           rtol=1e-4, atol=atol)


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except (ValueError, TypeError, IndexError) as e:
        return type(e).__name__, str(e)
    return None


def _served(shadow, storage):
    """The values a tier serves for f32 rows, as float64."""
    if storage == "bf16":
        return torch.from_numpy(shadow).to(torch.bfloat16).double().numpy()
    if storage == "int8":
        codes, scales = pstorage._quantize_rows_np(shadow)
        return codes.astype(np.float64) * scales[:, None]
    if storage == "int4":
        ck, dpp, _ = F.feature_geometry(shadow.shape[1])
        packed, scales = pstorage._quantize_rows_int4_np(shadow, ck, dpp)
        codes = pstorage._unpack_int4_np(packed, ck, shadow.shape[1])
        return codes.astype(np.float64) * scales[:, None]
    return shadow.astype(np.float64)


def _oracle_scores(q, c, alive, metric):
    """float64 (m, n) scores in maximize orientation, dead rows -inf."""
    q = q.astype(np.float64)
    if metric == "euclidean":
        s = -np.sqrt(np.maximum((q * q).sum(1)[:, None]
                                + (c * c).sum(1)[None, :] - 2.0 * q @ c.T,
                                0.0))
    elif metric == "cosine":
        qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        cn = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-30)
        s = qn @ cn.T
    else:
        s = q @ c.T
    return np.where(alive[None, :], s, -np.inf)


def _check_oracle(got, q, c, alive, metric, what):
    """Results against the float64 oracle: index differences only among
    near-tied scores, tombstones never returned."""
    idx = got[0].astype(np.int64)
    s = _oracle_scores(q, c, alive, metric)
    want = np.argsort(-s, axis=1, kind="stable")[:, : idx.shape[1]]
    rows = np.arange(idx.shape[0])[:, None]
    assert np.allclose(s[rows, idx], s[rows, want], rtol=1e-2, atol=1e-2), (
        f"{what}: non-tied index mismatch\n{idx}\nvs\n{want}")
    assert alive[idx].all(), f"{what}: a deleted row was returned"


def _same_files(pa, pb):
    with np.load(pa) as a, np.load(pb) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# ---------------------------------------------------------------------------
# Corpus: the same seeded steps on both packages.
# ---------------------------------------------------------------------------


def _run_corpus(label, storage, tmp_path, steps, jcfg):
    """Seeded add / update / delete / save-and-load steps (files saved by
    one package load in the other, with capacity for 4 more rows).
    Returns the port handle and the number of adds past capacity."""
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    dim, k = 24, 4
    c = rng.standard_normal((60, dim)).astype(np.float32)
    j = pmt.Corpus(c, storage=storage, capacity=100, config=jcfg)
    h = pt.Corpus(c, storage=storage, capacity=100, device=CPU)
    shadow, alive = c.copy(), np.ones(60, bool)
    grew = 0
    for step in range(steps):
        op = rng.integers(0, 6)
        n = shadow.shape[0]
        if op == 0 and n < 300:                       # add
            rows = rng.standard_normal((int(rng.integers(1, 12)), dim)
                                       ).astype(np.float32)
            cap = h._cap
            assert h.add(rows) == j.add(rows) == n + rows.shape[0]
            grew += h._cap > cap
            shadow = np.vstack([shadow, rows])
            alive = np.concatenate([alive, np.ones(rows.shape[0], bool)])
        elif op == 1:                                 # update, revives
            idx = rng.choice(n, size=int(rng.integers(1, 6)), replace=False)
            rows = rng.standard_normal((idx.size, dim)).astype(np.float32)
            h.update(idx, rows)
            j.update(idx, rows)
            shadow[idx] = rows
            alive[idx] = True
        elif op == 2 and alive.sum() > k + 2:         # delete
            idx = rng.choice(np.flatnonzero(alive), size=2, replace=False)
            assert h.delete(idx) == j.delete(idx) == (~alive).sum() + 2
            alive[idx] = False
        elif op == 3:                                 # save, load across
            ph, pj = tmp_path / f"p{step}.npz", tmp_path / f"j{step}.npz"
            h.save(ph)
            j.save(pj)
            _same_files(ph, pj)
            h = pt.Corpus.load(pj, capacity=n + 4, device=CPU)
            j = pmt.Corpus.load(ph, capacity=n + 4, config=jcfg)
        assert len(h) == len(j) and h.deleted_count == j.deleted_count
        q = rng.standard_normal((3, dim)).astype(np.float32)
        metric = METRICS[step % 3]
        got = h.topk(q, k, metric)
        _same(got, j.topk(q, k, metric), storage, metric)
        _check_oracle(got, q, _served(shadow, storage), alive, metric,
                      f"{storage} step {step} op {op} {metric}")
    return h, grew


@pytest.mark.parametrize("storage", STORAGES)
def test_corpus_mutation_side_by_side(storage, tmp_path):
    h, grew = _run_corpus("life" + storage, storage, tmp_path, 30, PLAIN)
    assert grew > 0 and h._cap >= h.n and len(h._prepared) > 0


def test_corpus_mutation_side_by_side_pallas(tmp_path):
    """A short f32 sequence (update, add, update, delete, save) against
    the JAX package's Pallas kernel in interpret mode, whose prepared
    forms take the same in-place writes."""
    h, _ = _run_corpus("pallas28", "f32", tmp_path, 6, JConfig())
    assert h.deleted_count == 2


# ---------------------------------------------------------------------------
# In place: writes into the stored buffer and the cached prepared forms.
# ---------------------------------------------------------------------------


def _fresh(h, cfg):
    """A new handle on ``h``'s stored rows (codes as they are)."""
    rows = h._device[: h.n].clone()
    if h.storage in ("int8", "int4"):
        return pt.Corpus(rows, storage=h.storage, config=cfg,
                         scales=h._scales[: h.n].clone(),
                         dim=h.dim if h.storage == "int4" else None)
    return pt.Corpus(rows, storage=h.storage, config=cfg)


def _ptrs(h):
    return [h._device.data_ptr()] + sorted(
        t.data_ptr() for pair in h._prepared.values() for t in pair)


@pytest.mark.parametrize("storage,precision,metrics,aliased", [
    ("int8", None, METRICS, True),            # codes are the prepared cp
    ("int4", None, ["euclidean"], True),
    ("f32", "highest", ["dot"], True),        # f32 rows kept as stored
    ("bf16", None, ["dot", "cosine"], None),  # one shared, one copied
    ("f32", "bf16x3", ["cosine"], False),     # [hi | lo] rows, a copy
])
def test_writes_land_in_place(storage, precision, metrics, aliased):
    rng = np.random.default_rng(7)
    c = rng.standard_normal((50, 40)).astype(np.float32)
    cfg = SearchConfig() if precision is None else SearchConfig(
        precision=precision)
    h = pt.Corpus(c, storage=storage, capacity=80, config=cfg, device=CPU)
    for metric in metrics:
        h.topk(c[:2], 3, metric)
    if aliased is not None:
        for cp, _ in h._prepared.values():
            assert (cp.data_ptr() == h._device.data_ptr()) == aliased
    before = _ptrs(h)
    h.add(rng.standard_normal((20, 40)).astype(np.float32))
    h.update([3, 55, 69], rng.standard_normal((3, 40)).astype(np.float32))
    h.add(torch.from_numpy(rng.standard_normal((10, 40)).astype(np.float32)))
    assert h.n == h._cap == 80 and _ptrs(h) == before
    # Each written form equals a prep of the stored rows, bit for bit, and
    # the prep of a fresh handle on those rows.
    for (metric, core), (cp, cbp) in h._prepared.items():
        fresh = pstorage.prepare_stored(h._device, h._scales,
                                       F.Metric.parse(metric), core, 10**6)
        assert torch.equal(cp, fresh[0]) and torch.equal(cbp, fresh[1])
    q = rng.standard_normal((4, 40)).astype(np.float32)
    fresh = _fresh(h, cfg)
    for metric in metrics:
        got, want = h.topk(q, 5, metric), fresh.topk(q, 5, metric)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # Past capacity: doubled, reallocated, prepared forms dropped.
    h.add(rng.standard_normal((1, 40)).astype(np.float32))
    assert (h.n, h._cap, h._prepared) == (81, 160, {})
    assert h._device.data_ptr() != before[0]
    _check_oracle(h.topk(q, 6, "dot"), q, h._dense_device().double().numpy(),
                  np.ones(81, bool), "dot", "after growth")


def test_borrowed_tensor_and_float64_rows():
    rng = np.random.default_rng(8)
    c = rng.standard_normal((30, 16))
    # A caller's tensor held as the storage is copied before the first
    # write, never written.
    mine = torch.from_numpy(c.astype(np.float32))
    h = pt.Corpus(mine)
    h.topk(c[:2].astype(np.float32), 3, "dot")
    assert h._device.data_ptr() == mine.data_ptr()
    h.update([0], np.ones((1, 16), np.float32))
    assert h._device.data_ptr() != mine.data_ptr()
    assert torch.equal(mine, torch.from_numpy(c.astype(np.float32)))
    assert float(h._device[0, 0]) == 1.0
    # float64 handles take rows at full precision, as in the JAX package.
    h64 = pt.Corpus(c, capacity=40, device=CPU)
    rows = rng.standard_normal((3, 16))
    h64.add(rows)
    h64.update([1], rows[:1] * np.pi)
    assert h64._device.dtype == torch.float64 and h64._cap == 40
    np.testing.assert_array_equal(h64._device[30:33].numpy(), rows)
    np.testing.assert_array_equal(h64._device[1].numpy(), rows[0] * np.pi)
    j64 = pmt.Corpus(c, capacity=40)
    j64.add(rows)
    j64.update([1], rows[:1] * np.pi)
    q = rng.standard_normal((2, 16))
    _same(h64.topk(q, 5, "euclidean"), j64.topk(q, 5, "euclidean"))


@pytest.mark.parametrize("dtype,writeable", [(np.float32, True),
                                             (np.float64, True),
                                             (np.float32, False)])
def test_update_never_writes_the_callers_array(dtype, writeable):
    """A CPU handle holds a NumPy corpus as a view (``torch.from_numpy``):
    ``update`` copies it first and leaves the caller's array, read-only
    or not, bit for bit as it was, as the JAX package (whose arrays are
    copies) does."""
    rng = np.random.default_rng(12)
    c = rng.standard_normal((40, 12)).astype(dtype)
    before = c.copy()
    c.flags.writeable = writeable
    rows = rng.standard_normal((2, 12)).astype(dtype)
    h = pt.Corpus(c, device=CPU)
    j = pmt.Corpus(c, config=PLAIN)
    for handle in (h, j):
        handle.update([0, 7], rows)
    assert c.tobytes() == before.tobytes()
    q = rng.standard_normal((3, 12)).astype(dtype)
    for metric in METRICS:
        _same(h.topk(q, 5, metric), j.topk(q, 5, metric))


def test_corpus_repr_and_counts_match_jax():
    rng = np.random.default_rng(9)
    c = rng.standard_normal((10, 8)).astype(np.float32)
    h = pt.Corpus(c, capacity=16, device=CPU)
    j = pmt.Corpus(c, capacity=16)
    assert repr(h) == ("Corpus(10x8, storage='f32', device='cpu', "
                       "capacity=16)")
    assert h.delete(np.array([1, 1, 4])) == j.delete(np.array([1, 1, 4])) == 2
    assert h.deleted_count == j.deleted_count == 2
    assert repr(h).endswith("capacity=16, deleted=2)")
    assert h.add(c[:0]) == j.add(c[:0]) == 10
    h.update([], c[:0])
    assert repr(pt.Corpus(c, device=CPU)) == (
        "Corpus(10x8, storage='f32', device='cpu')")


def test_corpus_mutation_errors_match_jax():
    rng = np.random.default_rng(10)
    c = rng.standard_normal((12, 8)).astype(np.float32)
    h = pt.Corpus(c, capacity=20, device=CPU)
    j = pmt.Corpus(c, capacity=20)
    calls = [
        lambda x: x.add(c[:, :5]),
        lambda x: x.add(c[0]),
        lambda x: x.update([0, 1], c[:2, :3]),
        lambda x: x.update([0, 1], c[:3]),
        lambda x: x.update([0.0, 1.0], c[:2]),
        lambda x: x.update([0, 12], c[:2]),
        lambda x: x.update([-1, 2], c[:2]),
        lambda x: x.update([3, 3], c[:2]),
        lambda x: x.delete([0.5]),
        lambda x: x.delete([12]),
        lambda x: x.delete([-2, 1]),
    ]
    for i, call in enumerate(calls):
        want = _error(call, j)
        assert want is not None and want[0] == "ValueError", i
        assert _error(call, h) == want, i
    assert _error(lambda: h.update(torch.tensor([3, 3]), c[:2])) == (
        "ValueError", "update indices must be unique")


# ---------------------------------------------------------------------------
# ClusteredCorpus: one JAX-saved handle loaded into both packages.
# ---------------------------------------------------------------------------


def _blob_rows(rng, centres, m):
    lab = rng.integers(0, centres.shape[0], m)
    return (centres[lab] + rng.standard_normal((m, centres.shape[1]))
            ).astype(np.float32)


def _layouts_equal(h, j, what):
    for name in ("perm", "row_pos", "tile_cluster", "counts"):
        np.testing.assert_array_equal(getattr(h.layout, name),
                                      getattr(j.layout, name),
                                      err_msg=f"{what}: {name}")


def _layout_invariants(h):
    lay = h.layout
    live = lay.perm >= 0
    assert np.array_equal(np.sort(lay.perm[live]), np.arange(h.n))
    assert np.array_equal(lay.perm[lay.row_pos[: h.n]], np.arange(h.n))
    assert int(lay.counts.sum()) == h.n
    assert h._base.shape[0] == lay.n_padded == lay.tile_cluster.size * lay.tn


def _placement(before, after, ids):
    """Rows ``ids`` placed in (tile-tail slack, claimed dead tiles,
    appended tiles)."""
    pos = after.row_pos[ids].astype(np.int64)
    old = pos < before.n_padded
    dead = np.zeros(pos.size, bool)
    dead[old] = before.tile_cluster[pos[old] // before.tn] == -1
    return np.array([(old & ~dead).sum(), dead.sum(), (~old).sum()])


def _stored_values(h):
    """float64 stored values in original row order."""
    pos = torch.from_numpy(h.layout.row_pos[: h.n].astype(np.int64))
    return h._dense_view()[pos].double().numpy()


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_clustered_mutation_side_by_side(storage, tmp_path):
    rng = np.random.default_rng(zlib.crc32(("clu" + storage).encode()))
    dim, k = 16, 4
    centres = rng.standard_normal((6, dim)) * 4.0
    c = _blob_rows(rng, centres, 500)
    jcfg = JCL.with_updates(use_pallas=False)
    saved = str(tmp_path / "saved.npz")
    pmt.ClusteredCorpus(c, clusters=5, storage=storage, config=JCL,
                        reserve_tiles=2).save(saved)
    j = pmt.ClusteredCorpus.load(saved, config=jcfg)
    h = pt.ClusteredCorpus.load(saved, config=PCL, device=CPU)
    _layouts_equal(h, j, "loaded")
    tiles0, dead0 = h.n_tiles, int((h.layout.tile_cluster == -1).sum())
    assert dead0 == 2
    alive = np.ones(500, bool)
    placed = np.zeros(3, np.int64)
    for step, (n_add, n_upd, n_del) in enumerate(
            ((20, 10, 3), (200, 30, 5), (150, 40, 4), (300, 25, 6))):
        n, before = h.n, h.layout
        rows = _blob_rows(rng, centres, n_add)
        # The port takes a tensor once; both quantize on the host otherwise.
        assert h.add(torch.from_numpy(rows) if step == 1 else rows) == \
            j.add(rows) == n + n_add
        placed += _placement(before, h.layout, np.arange(n, h.n))
        alive = np.concatenate([alive, np.ones(n_add, bool)])
        idx = rng.choice(h.n, n_upd, replace=False)
        rows = _blob_rows(rng, centres, n_upd)
        h.update(idx, rows)
        j.update(idx, rows)
        alive[idx] = True
        idx = rng.choice(np.flatnonzero(alive), n_del, replace=False)
        assert h.delete(idx) == j.delete(idx) == n_del
        alive[idx] = False
        _layouts_equal(h, j, f"step {step}")
        _layout_invariants(h)
        assert h.drift == j.drift and h.deleted_count == j.deleted_count
        q = _blob_rows(rng, centres, 5)
        metric = METRICS[step % 3]
        got = h.topk(q, k, metric)
        _same(got, j.topk(q, k, metric))
        _check_oracle(got, q, _stored_values(h), alive, metric,
                      f"clustered {storage} step {step}")
    # Placement reached the slack, both reserve tiles and appended tiles.
    assert (placed > 0).all(), placed
    assert int((h.layout.tile_cluster == -1).sum()) == 0
    assert h.n_tiles > tiles0
    # Probed requests against the JAX package's Pallas kernel.
    j.config = JCL
    q = _blob_rows(rng, centres, 12)
    for metric in ("cosine", "euclidean"):
        _same(h.topk(q, k, metric, probe=0.3), j.topk(q, k, metric,
                                                      probe=0.3))
    # Files saved after mutations load both ways.
    ph, pj = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    h.save(ph)
    j.save(pj)
    _same_files(ph, pj)
    h2 = pt.ClusteredCorpus.load(pj, config=PCL, device=CPU)
    j2 = pmt.ClusteredCorpus.load(ph, config=JCL)
    _layouts_equal(h2, j2, "reloaded")
    _same(h2.topk(q, k, "dot", probe=0.3), j2.topk(q, k, "dot", probe=0.3))

    # rebuild: exhaustive results kept, drift reset, the layout held to
    # the float64 nearest-centroid oracle (the k-means draws differ from
    # the JAX package's, a known difference).
    before = h.topk(q, 8, "dot")
    assert h.drift > 0
    h.rebuild(clusters=4, seed=3)
    assert h.drift == 0.0 and h.clusters == 4
    assert h.n_tiles <= h2.n_tiles
    _layout_invariants(h)
    after = h.topk(q, 8, "dot")
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_allclose(after[1], before[1], rtol=1e-6, atol=1e-6)
    vals = _stored_values(h)
    cent = h.centroids.double().numpy()
    d2 = ((vals[:, None, :] - cent[None]) ** 2).sum(-1)
    got_cl = h.layout.tile_cluster[h.layout.row_pos[: h.n] // h.layout.tn]
    best = d2[np.arange(h.n), got_cl]
    assert np.all(best <= d2.min(1) * (1 + 1e-5) + 1e-5)
    np.testing.assert_array_equal(
        h.layout.counts, np.bincount(got_cl, minlength=h.clusters))
    _check_oracle(h.topk(q, k, "cosine"), q, vals, alive, "cosine",
                  "after rebuild")
    _same(h.topk(q, k, "euclidean"), j.topk(q, k, "euclidean"))


def test_rebuild_fits_on_the_live_rows():
    rng = np.random.default_rng(11)
    centres = rng.standard_normal((4, 8)) * 6.0
    c = _blob_rows(rng, centres, 400)
    h = pt.ClusteredCorpus(c, clusters=3, config=PCL, device=CPU)
    drawn = []
    fit = h._fit_sampled

    def spy(get_rows, ids, *args):
        drawn.append(ids.copy())
        return fit(get_rows, ids, *args)
    h._fit_sampled = spy
    dead = np.arange(0, 400, 2)
    h.delete(dead)
    h.rebuild(sample_rows=100)
    assert drawn[0].size == 200 and not np.isin(drawn[0], dead).any()
    assert h.deleted_count == 200 and h.drift == 0.0
    got = h.topk(c[:3], 5, "dot")
    assert not np.isin(got[0], dead).any()


def test_clustered_mutation_errors_match_jax():
    rng = np.random.default_rng(12)
    c = _blob_rows(rng, rng.standard_normal((3, 8)) * 4, 300)
    h = pt.ClusteredCorpus(c, clusters=2, config=PCL, device=CPU)
    j = pmt.ClusteredCorpus(c, clusters=2, config=JCL)
    calls = [
        lambda x: x.add(c[:2, :5]),
        lambda x: x.add(np.ones((2, 8), np.int32)),
        lambda x: x.update([0], c[:1, :3]),
        lambda x: x.update([0, 1], c[:1]),
        lambda x: x.update([0.0], c[:1]),
        lambda x: x.update([300], c[:1]),
        lambda x: x.update([2, 2], c[:2]),
        lambda x: x.update([0], np.ones((1, 8), np.int8)),
        lambda x: x.delete([300]),
        lambda x: x.delete([-1]),
        lambda x: x.rebuild(clusters=0),
    ]
    for i, call in enumerate(calls):
        want = _error(call, j)
        assert want is not None, i
        assert _error(call, h) == want, i
    assert h.add(c[:0]) == j.add(c[:0]) == 300
    h.update([], c[:0])
    assert h.drift == 0.0
