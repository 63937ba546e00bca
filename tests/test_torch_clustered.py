"""Probed search in the PyTorch port: kernel A on tile lists
(``fused_topk_prepared(tiles=)``) and ``ClusteredCorpus``, against the JAX
package on the same NumPy inputs.

The port runs on ``device="cpu"``, where every kernel wrapper runs its
plain PyTorch version; the JAX package runs its Pallas kernel in
interpret mode.  Handles are compared through save files: a JAX
``ClusteredCorpus`` is saved and loaded into the port, so both search the
same layout, centroids and stored bytes.  Scores agree within the
tolerance the JAX package's own clustered tests use against ``Corpus``
(rtol 1e-4, atol 5e-4: its packed selections truncate scores by up to
127 ulps), index differences only on tied scores.
"""

import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import polars_matmul_tpu as pmt
import polars_matmul_tpu_torch as pt
from polars_matmul_tpu.config import SearchConfig as JConfig
from polars_matmul_tpu_torch import SearchConfig
from polars_matmul_tpu_torch.kernels import fused_topk as F

from conftest import assert_topk_equivalent

JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")

torch.set_num_threads(2)

METRICS = ["cosine", "dot", "euclidean"]
STORAGES = ["f32", "bf16", "int8", "int4"]
JCFG = JConfig(block_q=8, block_n=128)
PCFG = SearchConfig(block_q=8, block_n=128)
TOL = dict(rtol=1e-4, atol=5e-4)
CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def blobs(rng, n, m, dim, n_centers=20, spread=4.0):
    centers = rng.standard_normal((n_centers, dim)) * spread
    c = (centers[rng.integers(0, n_centers, n)]
         + rng.standard_normal((n, dim))).astype(np.float32)
    q = (centers[rng.integers(0, n_centers, m)]
         + rng.standard_normal((m, dim))).astype(np.float32)
    return q, c


def recall(approx_idx, exact_idx):
    k = exact_idx.shape[1]
    return np.mean([len(set(a) & set(b)) / k
                    for a, b in zip(approx_idx, exact_idx)])


def _same(got, want, **tol):
    (gi, gs), (wi, ws) = got, want
    assert gi.dtype == wi.dtype == np.uint32
    assert gs.dtype == ws.dtype == np.float64
    assert_topk_equivalent(gi.astype(np.int64), gs, wi.astype(np.int64), ws,
                           **(tol or TOL))


# ---------------------------------------------------------------------------
# Kernel A on tile lists: fused_topk_prepared(tiles=) against the JAX
# kernel's PrefetchScalarGridSpec call, on the JAX package's prepared
# operands.
# ---------------------------------------------------------------------------

CORES = ["bf16x3", "highest", "bf16c", "int8c", "int4c"]


def _kernel_data(seed=2):
    r = np.random.default_rng(seed)
    return (r.standard_normal((20, 32)).astype(np.float32),
            r.standard_normal((1000, 32)).astype(np.float32))


def _prepared(q, c, metric, precision, k):
    """JAX's prepared corpus and the port's view of it, with the layout
    tile and query block of JCFG."""
    jcfg = JCFG.with_updates(precision=precision)
    tn = JF.corpus_tile_rows(q.shape[1], jcfg, k)
    tm = JF.query_tile_rows(q.shape[0], q.shape[1], jcfg, k)
    jcp, jcbp = JF.prepare_corpus(jnp.asarray(c), metric, tn=tn,
                                  precision=precision)
    cp, cbp = F.prepared_from_jax(np.asarray(jcp), np.asarray(jcbp),
                                  c.shape[0], c.shape[1])
    return jcfg, tn, tm, (jcp, jcbp), (cp, cbp)


def _lists(seed, n_lists, n_layout, p):
    r = np.random.default_rng(seed)
    return np.stack([np.sort(r.choice(n_layout, p, replace=False))
                     for _ in range(n_lists)]).astype(np.int32)


# k = 20 > 16 runs the JAX package's probed gstack / stack selection.
@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("precision,metric", [
    ("bf16x3", "cosine"), ("highest", "dot"), ("bf16c", "euclidean"),
    ("int8c", "cosine"), ("int4c", "euclidean")])
def test_listed_kernel_matches_jax(precision, metric, k):
    q, c = _kernel_data()
    jcfg, tn, tm, (jcp, jcbp), (cp, cbp) = _prepared(q, c, metric,
                                                     precision, k)
    n_layout = -(-1000 // tn)
    tiles = _lists(k, -(-20 // tm), n_layout, 3)
    tiles[0] = [0, 1, n_layout - 1]   # the ragged last tile too
    jv, ji = JF.fused_topk_prepared(jnp.asarray(q), jcp, jcbp, k, metric,
                                    tn=tn, config=jcfg, interpret=True,
                                    tiles=jnp.asarray(tiles))
    before = dict(F.launches)
    pv, pi = F.fused_topk_prepared(_t(q), cp, cbp, k, metric, config=PCFG,
                                   precision=precision, tiles=tiles, tn=tn)
    assert F.launches["fused_topk_plain"] == before["fused_topk_plain"] + 1
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv))
    # Each block saw only its own list's rows.
    for b, row in enumerate(tiles):
        got = pi.numpy()[b * tm:(b + 1) * tm]
        assert np.isin(got // tn, row).all()


def _tie_data(m, n, dim, seed=5):
    """Rows of four +-1 entries, every row twinned: scores are exact in any
    summation order, with many exact ties."""
    r = np.random.default_rng(seed)
    c = np.zeros((n, dim), np.float32)
    for row in c:
        row[r.choice(dim, 4, replace=False)] = r.choice([-1.0, 1.0], 4)
    c[n // 2:] = c[: n - n // 2]
    return c[r.choice(n, m)].copy(), c


@pytest.mark.parametrize("precision", CORES)
def test_every_tile_listed_equals_the_dense_scan(precision):
    # Exact scores (integer data), so the listed walk and the dense scan
    # agree bit for bit, tie order included; and both agree with JAX's
    # extract selection.
    q, c = _tie_data(20, 1000, 32)
    _, tn, tm, (jcp, jcbp), (cp, cbp) = _prepared(q, c, "dot", precision,
                                                  10)
    every = np.tile(np.arange(-(-1000 // tn), dtype=np.int32),
                    (-(-20 // tm), 1))
    lv, li = F.fused_topk_prepared(_t(q), cp, cbp, 10, "dot", config=PCFG,
                                   precision=precision, tiles=every, tn=tn)
    dv, di = F.fused_topk_prepared(_t(q), cp, cbp, 10, "dot", config=PCFG,
                                   precision=precision)
    assert torch.equal(lv, dv) and torch.equal(li, di)
    jcfg = JCFG.with_updates(precision=precision, selection="extract")
    jv, ji = JF.fused_topk_prepared(jnp.asarray(q), jcp, jcbp, 10, "dot",
                                    tn=tn, config=jcfg, interpret=True,
                                    tiles=jnp.asarray(every))
    np.testing.assert_array_equal(li.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jv))


def _err(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_listed_kernel_errors_match_jax():
    q, c = _kernel_data(6)
    jcfg, tn, tm, (jcp, jcbp), (cp, cbp) = _prepared(q, c, "cosine",
                                                     "bf16x3", 5)
    n_layout = -(-1000 // tn)
    for tiles in (np.zeros((1, n_layout + 1), np.int32),   # too many tiles
                  np.zeros((99, 2), np.int32)):             # wrong blocks
        jmsg = _err(JF.fused_topk_prepared, jnp.asarray(q), jcp, jcbp, 5,
                    "cosine", tn=tn, config=jcfg, interpret=True,
                    tiles=jnp.asarray(tiles))
        pmsg = _err(F.fused_topk_prepared, _t(q), cp, cbp, 5, "cosine",
                    config=PCFG, tiles=tiles, tn=tn)
        assert pmsg == jmsg
    assert "repeating a tile" in _err(
        F.fused_topk_prepared, _t(q), cp, cbp, 5, "cosine", config=PCFG,
        tiles=np.zeros((1, n_layout + 1), np.int32), tn=tn)
    # The wrappers check what kernel A takes.
    qp = F.prepare_queries(_t(q), "cosine", "bf16x3")
    ok = _t(np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError, match="int32"):
        F.fused_select(qp, cp, cbp, None, 5, "bf16x3", ok.long(), tn, 8)
    with pytest.raises(ValueError, match="multiple of 64"):
        F.fused_select(qp, cp, cbp, None, 5, "bf16x3", ok, 100, 8)
    with pytest.raises(ValueError, match="do not cover"):
        F.fused_select(qp, cp, cbp, None, 5, "bf16x3", ok, tn, 4)
    with pytest.raises(ValueError, match="whole number"):
        F.fused_topk_partial(qp, cp, cbp, None, 5, "bf16x3", 1, 4, 16, ok,
                             tn, 8)
    with pytest.raises(ValueError, match="splits"):
        F.fused_topk_partial(qp, cp, cbp, None, 5, "bf16x3", 1, 3, 16,
                             ok[:1], tn, 32)


def test_listed_splits_merge_to_the_plain_result(monkeypatch):
    # Plain kernel A on tile lists, cut into several splits of the listed
    # rows, merged by plain kernel B: exactly the listed plain version,
    # mask and sentinels included (a list with a tile past the corpus
    # end, and one dead (-1) tile id).
    monkeypatch.setattr(F, "_PLAIN_CHUNK", 4096)
    q, c = _tie_data(24, 700, 32, seed=7)
    mask = F.pad_mask_row(_t(np.arange(700) % 3 != 0), 700)
    tiles = _t(np.array([[0, 2, 5], [1, 3, 9], [-1, 4, 5]], np.int32))
    for precision in CORES:
        qp = F.prepare_queries(_t(q), "euclidean", precision)
        cp, cbp = F.prepare_corpus(_t(c), "euclidean", precision=precision)
        tm, splits, tps = F.launch_geometry(24, 3 * 128, 10, sm_count=8,
                                            tm=8)
        assert splits > 1
        pv, pi = F.fused_topk_partial(qp, cp, cbp, mask, 10, precision,
                                      splits, tps, tm, tiles, 128, 8)
        v, i = F.topk_merge(pv, pi, 10)
        want = F.fused_topk_plain(qp, cp, cbp, mask, 10, precision, tiles,
                                  128, 8)
        assert torch.equal(v, want[0]) and torch.equal(i, want[1])
        live = i[i != F.INT32_MAX].numpy()
        assert (live < 700).all() and (live % 3 != 0).all()
        assert (i[16:].numpy() // 128 != 9).all()


# ---------------------------------------------------------------------------
# ClusteredCorpus: a JAX handle saved and loaded into the port.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Blobs, and per storage a JAX handle with its save file."""
    q, c = blobs(np.random.default_rng(7), 3000, 25, 24)
    d = tmp_path_factory.mktemp("clustered")
    handles = {}
    for storage in STORAGES:
        j = pmt.ClusteredCorpus(c, clusters=16, storage=storage, config=JCFG)
        path = str(d / f"{storage}.npz")
        j.save(path)
        handles[storage] = (j, path)
    return q, c, handles


def _pair(saved, storage, fresh=False, jcfg=JCFG, pcfg=PCFG):
    """(JAX handle, port handle) on the same save file; ``fresh`` loads
    the JAX side anew (for tests that delete)."""
    j, path = saved[2][storage]
    if fresh or jcfg is not JCFG:
        j = pmt.ClusteredCorpus.load(path, config=jcfg)
    return j, pt.ClusteredCorpus.load(path, config=pcfg, device=CPU)


@pytest.mark.parametrize("storage", STORAGES)
def test_load_installs_the_saved_layout(saved, storage):
    j, h = _pair(saved, storage)
    assert (h.n, h.dim, h.storage, h.clusters, h.n_tiles, len(h)) == (
        j.n, j.dim, j.storage, j.clusters, j.n_tiles, len(j))
    assert h.layout.tn == j.layout.tn == h._tn == 128
    for name in ("perm", "row_pos", "tile_cluster", "counts"):
        np.testing.assert_array_equal(getattr(h.layout, name),
                                      getattr(j.layout, name))
    np.testing.assert_array_equal(h.centroids.numpy(),
                                  np.asarray(j.centroids))
    with np.load(saved[2][storage][1]) as z:
        raw = z["data_u16"] if storage == "bf16" else z["data"]
        base = h._base.view(torch.int16).numpy().view(np.uint16) \
            if storage == "bf16" else h._base.numpy()
        np.testing.assert_array_equal(base, raw)
    assert h.device == torch.device("cpu") and "tiles=" in repr(h)


PROBES = [None, 0.25, 3]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("storage", STORAGES)
def test_topk_matches_jax(saved, storage, metric):
    # Every storage and every metric meets every probe form once.
    probe = PROBES[(STORAGES.index(storage) + METRICS.index(metric)) % 3]
    q = saved[0]
    j, h = _pair(saved, storage)
    before = dict(F.launches)
    _same(h.topk(q, 10, metric, probe=probe),
          j.topk(q, 10, metric, probe=probe))
    # 25 queries in blocks of 8: a probed request routes, one call a block
    # order; the plain version of kernels A + B ran once.
    assert F.launches["fused_topk_plain"] == before["fused_topk_plain"] + 1


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("k", [1, 24])
def test_k1_and_big_k_match_jax(saved, storage, k):
    q = saved[0]
    j, h = _pair(saved, storage)
    for probe in (0.25, None) if k == 24 else (2,):
        _same(h.topk(q, k, "cosine", probe=probe),
              j.topk(q, k, "cosine", probe=probe))


def test_mask_and_delete_match_jax(saved):
    q, c = saved[0], saved[1]
    j, h = _pair(saved, "f32", fresh=True)
    mask = np.random.default_rng(11).random(c.shape[0]) > 0.5
    for probe in (None, 0.5):
        got = h.topk(q, 6, "cosine", probe=probe, mask=mask)
        _same(got, j.topk(q, 6, "cosine", probe=probe, mask=mask))
        real = got[0][got[0] < c.shape[0]]
        assert mask[real].all()
    victims = got[0][:, 0]
    assert h.delete(victims) == j.delete(victims) == len(set(victims))
    assert h.deleted_count == j.deleted_count
    for probe in (None, 3):
        got = h.topk(q, 6, "dot", probe=probe)
        _same(got, j.topk(q, 6, "dot", probe=probe))
        assert not np.isin(victims, got[0]).any()
    # The cached permuted mask gives the same again; a torch mask works.
    _same(h.topk(q, 6, "dot", probe=3), j.topk(q, 6, "dot", probe=3))
    _same(h.topk(q, 6, "euclidean", probe=3, mask=_t(mask)),
          j.topk(q, 6, "euclidean", probe=3, mask=mask))
    with pytest.raises(IndexError):
        h.delete([c.shape[0]])


def test_routing_matches_jax_and_restores_caller_order(saved):
    q = saved[0]
    j, h = _pair(saved, "int8")
    assert h._route_order(q, F.Metric.COSINE) is not None
    for route in (True, False):
        _same(h.topk(q, 8, "cosine", probe=0.25, route=route),
              j.topk(q, 8, "cosine", probe=0.25, route=route))
    # A routed request is the unrouted one on the routed order, returned
    # in the caller's row order.
    order = h._route_order(q, F.Metric.COSINE)
    routed = h.topk(q[order], 8, "cosine", probe=0.25, route=False)
    got = h.topk(q, 8, "cosine", probe=0.25)
    np.testing.assert_array_equal(got[0][order], routed[0])
    np.testing.assert_array_equal(got[1][order], routed[1])


def test_half_and_f64_queries_match_jax(saved):
    q = saved[0]
    j, h = _pair(saved, "bf16")
    q16 = q.astype(np.float16)
    _same(h.topk(q16, 5, "cosine", probe=3),
          j.topk(q16, 5, "cosine", probe=3))
    _same(h.topk(_t(q16), 5, "cosine", probe=3),
          j.topk(q16, 5, "cosine", probe=3))
    qb = q.astype(ml_dtypes.bfloat16)
    _same(h.topk(qb, 5, "euclidean", probe=None),
          j.topk(qb, 5, "euclidean", probe=None))
    _same(h.topk(q.astype(np.float64), 5, "dot", probe=3),
          j.topk(q.astype(np.float64), 5, "dot", probe=3))


@pytest.mark.parametrize("storage", ["f32", "int4"])
def test_matmul_matches_jax(saved, storage):
    q, c = saved[0], saved[1]
    j, h = _pair(saved, storage)
    got, want = h.matmul(q), j.matmul(q)
    assert got.dtype == want.dtype == np.float32 and got.shape == (25, 3000)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    if storage == "f32":
        np.testing.assert_allclose(got, q @ c.T, rtol=1e-4, atol=1e-3)
    got64 = h.matmul(q.astype(np.float64))
    assert got64.dtype == np.float64
    np.testing.assert_allclose(got64, j.matmul(q.astype(np.float64)),
                               rtol=1e-6, atol=1e-6)
    assert h.matmul(q[:0]).shape == (0, 3000)
    with pytest.raises(ValueError, match="Dimension mismatch"):
        h.matmul(np.ones((2, 7), np.float32))


def test_reference_path_matches_jax(saved):
    # k > max_fused_k and use_pallas=False take the exhaustive reference
    # path over the dense rows (probe ignored), as in the JAX package.
    q = saved[0][:4]
    for storage in ("f32", "int8"):
        j, h = _pair(saved, storage)
        before = dict(F.launches)
        _same(h.topk(q, 1030, "cosine", probe=0.1),
              j.topk(q, 1030, "cosine", probe=0.1))
        assert F.launches == before
    off_j, off_p = JCFG.with_updates(use_pallas=False), \
        PCFG.with_updates(use_pallas=False)
    j, h = _pair(saved, "int4", jcfg=off_j, pcfg=off_p)
    _same(h.topk(q, 7, "euclidean", probe=2),
          j.topk(q, 7, "euclidean", probe=2))


def test_quantized_storage_above_max_fused_dim_stays_on_the_kernel(saved):
    q = saved[0]
    j, h = _pair(saved, "int8", jcfg=JCFG.with_updates(max_fused_dim=16),
                 pcfg=PCFG.with_updates(max_fused_dim=16))
    assert not F.supports(q.shape, (h.n, h.dim), torch.float32, 5, h.config)
    before = F.launches["fused_topk_plain"]
    _same(h.topk(q, 5, "cosine", probe=3), j.topk(q, 5, "cosine", probe=3))
    assert F.launches["fused_topk_plain"] == before + 1
    assert h._dense is None


def test_port_save_loads_in_jax(saved, tmp_path):
    q = saved[0]
    for storage in ("bf16", "int4"):
        j, h = _pair(saved, storage, fresh=True)
        j.delete([4, 9])
        h.delete([4, 9])
        pj, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
        j.save(pj)
        h.save(pp)
        with np.load(pj) as a, np.load(pp) as b:
            assert sorted(a.files) == sorted(b.files)
            for name in a.files:
                np.testing.assert_array_equal(a[name], b[name])
        back = pmt.ClusteredCorpus.load(pp, config=JCFG)
        _same(back.topk(q, 6, "cosine", probe=3),
              h.topk(q, 6, "cosine", probe=3))
        again = pt.ClusteredCorpus.load(pp, config=PCFG, device=CPU)
        assert again.deleted_count == 2
        np.testing.assert_array_equal(again.topk(q, 6, probe=3)[0],
                                      h.topk(q, 6, probe=3)[0])


# ---------------------------------------------------------------------------
# The port's own constructor.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage,metric", [
    ("f32", "cosine"), ("f32", "euclidean"), ("int8", "dot"),
    ("bf16", "cosine")])
def test_own_build_exhaustive_matches_jax_corpus(storage, metric):
    q, c = blobs(np.random.default_rng(7), 3000, 25, 24)
    h = pt.ClusteredCorpus(c, clusters=16, storage=storage, config=PCFG,
                           device=CPU)
    assert h.clusters == 16 and h.layout.tn == 128
    assert h.layout.n_padded % 128 == 0
    live = h.layout.perm >= 0
    np.testing.assert_array_equal(np.sort(h.layout.perm[live]),
                                  np.arange(3000))
    ref = pmt.Corpus(c, storage=storage, config=JCFG)
    _same(h.topk(q, 10, metric, probe=None), ref.topk(q, 10, metric))


def test_own_build_probed_recall_on_blobs():
    q, c = blobs(np.random.default_rng(8), 5000, 40, 32, n_centers=30)
    h = pt.ClusteredCorpus(_t(c), clusters=30, config=PCFG)
    assert h.device == torch.device("cpu")   # a tensor builds on its device
    ri, _ = pt.Corpus(c, config=PCFG, device=CPU).topk(q, 10, "cosine")
    pi, _ = h.topk(q, 10, "cosine", probe=0.25)
    assert recall(pi, ri) > 0.9


def test_own_build_defaults_reserve_and_save(tmp_path):
    q, c = blobs(np.random.default_rng(9), 1500, 10, 16)
    h = pt.ClusteredCorpus(c, storage="int4", reserve_tiles=2,
                           config=PCFG, device=CPU)
    # About four layout tiles a cluster, two dead tiles at the end.
    assert h.clusters == -(-1500 // (4 * 128))
    assert (h.layout.tile_cluster[-2:] == -1).all()
    assert h.drift == 0.0 and h.deleted_count == 0
    full = h.topk(q, 7, "cosine", probe=None)
    # Every tile, dead ones included, is the exhaustive scan.
    _same(h.topk(q, 7, "cosine", probe=h.n_tiles), full, rtol=0, atol=0)
    path = str(tmp_path / "own.npz")
    h.save(path)
    with np.load(path) as z:
        assert int(z["reserve_tiles"]) == 2 and int(z["tn"]) == 128
    j = pmt.ClusteredCorpus.load(path, config=JCFG)
    _same(j.topk(q, 7, "cosine", probe=2), h.topk(q, 7, "cosine", probe=2))


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except (ValueError, TypeError, IndexError) as e:
        return type(e).__name__, str(e)
    return None


def test_constructor_and_query_errors_match_jax():
    q, c = blobs(np.random.default_rng(12), 600, 8, 16)
    cases = [((c[:0],), {}), ((c[0],), {}), ((c[:, :0],), {}),
             ((c,), {"storage": "fp8"}), ((np.zeros((4, 4), np.int8),), {}),
             ((c,), {"clusters": 0}), ((c,), {"reserve_tiles": -1})]
    for args, kw in cases:
        want = _error(pmt.ClusteredCorpus, *args, config=JCFG, **kw)
        assert want is not None
        assert _error(pt.ClusteredCorpus, *args, config=PCFG, device=CPU,
                      **kw) == want, kw
    h = pt.ClusteredCorpus(c, clusters=4, config=PCFG, device=CPU)
    j = pmt.ClusteredCorpus(c, clusters=4, config=JCFG)
    for call in (lambda x: x.topk(q[:, :5], 3),
                 lambda x: x.topk(q, 3, probe=0.0),
                 lambda x: x.topk(q, 3, probe=True),
                 lambda x: x.topk(q, 3, mask=np.ones(5, bool))):
        assert _error(call, h) == _error(call, j)
    i0, v0 = h.topk(q[:0], 5)
    assert i0.shape == (0, 0) and v0.dtype == np.float64
    iz, _ = h.topk(q, 0)
    assert iz.shape == (8, 0)
    ic, _ = h.topk(q, 10_000)   # k clamps to n
    assert ic.shape == (8, 600)


def test_unported_features_raise(tmp_path):
    q, c = blobs(np.random.default_rng(13), 300, 2, 8)
    # mesh= is ported (tests/test_torch_clustered_mesh.py): the same
    # arguments build, save and load a sharded handle as in the JAX package;
    # only device= with a mesh is refused.
    import jax

    mesh = pt.make_mesh(1, 2, devices=[CPU] * 2)
    jmesh = pmt.make_mesh(1, 2, devices=jax.devices()[:2])
    j = pmt.ClusteredCorpus(c, clusters=2, mesh=jmesh)
    j.save(tmp_path / "jax.npz")
    h = pt.ClusteredCorpus.load(tmp_path / "jax.npz", mesh=mesh)
    assert repr(h) == repr(j)
    i, _ = h.topk(q, 4)
    np.testing.assert_array_equal(i, j.topk(q, 4)[0])
    assert repr(pt.ClusteredCorpus(c, clusters=2, mesh=mesh)).endswith(
        "shards=2)")
    with pytest.raises(ValueError, match="device= and mesh= are exclusive"):
        pt.ClusteredCorpus(c, mesh=mesh, device=CPU)
    # from_arrow is ported (tests/test_torch_interop.py).
    # add / update / rebuild are ported (tests/test_torch_lifecycle.py).
    h = pt.ClusteredCorpus(c, clusters=2, device=CPU)
    assert h.add(c[:2]) == c.shape[0] + 2
    h.update([0], c[1:2])
    assert h.rebuild().drift == 0.0
