"""``ClusteredCorpus(mesh=)`` of the PyTorch port against the JAX package.

One clustered corpus, fitted and saved by the JAX package, is loaded into
both packages on 4 shards (the port's mesh names the CPU 4 times, the JAX
package's takes 4 of its virtual CPU devices): the aligned and striped
layouts must be equal slot for slot, probed and exhaustive requests agree,
and ``add`` / ``update`` / ``delete`` / ``rebuild`` keep both the layouts
and the exhaustive oracle.  Small layout tiles (``block_n=128``,
``block_q=8``) give many tiles and several tile lists a request.

Tolerances: scores within ``assert_topk_equivalent``'s (rtol 2e-5, atol
8e-6; the bf16x3 core), index swaps only at ties; int8 / int4 storage
against a float64 oracle over the dequantised rows within rtol 2e-4 / atol
2e-4; products within rtol 1e-5 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import polars_matmul_tpu as pmt
import polars_matmul_tpu_torch as pt

from conftest import assert_topk_equivalent

torch.set_num_threads(2)

JCFG = pmt.SearchConfig(block_n=128, block_q=8)
TCFG = pt.SearchConfig(block_n=128, block_q=8)
SHARDS = 4


def _blobs(rng, n, centres=6, dim=32, spread=4.0):
    cent = rng.standard_normal((centres, dim)).astype(np.float32) * spread
    return (cent[rng.integers(0, centres, n)]
            + 0.3 * rng.standard_normal((n, dim))).astype(np.float32)


@pytest.fixture(scope="module")
def meshes():
    import jax

    if len(jax.devices()) < SHARDS:
        pytest.skip("needs 4 (virtual) devices")
    return (pt.make_mesh(1, SHARDS, devices=["cpu"] * SHARDS),
            pmt.make_mesh(1, SHARDS, devices=jax.devices()[:SHARDS]))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX-fitted clustered corpus with two reserve tiles, saved."""
    rng = np.random.default_rng(3)
    c = _blobs(rng, 1500)
    q = _blobs(np.random.default_rng(4), 16)
    path = tmp_path_factory.mktemp("clmesh") / "jax_clustered.npz"
    pmt.ClusteredCorpus(c, clusters=6, config=JCFG, reserve_tiles=2).save(
        path)
    return path, c, q


def _pair(saved, meshes):
    path = saved[0]
    tm, jm = meshes
    return (pt.ClusteredCorpus.load(path, mesh=tm, config=TCFG),
            pmt.ClusteredCorpus.load(path, mesh=jm, config=JCFG))


def _layouts_equal(t, j):
    for field in ("perm", "row_pos", "tile_cluster"):
        np.testing.assert_array_equal(getattr(t.layout, field),
                                      getattr(j.layout, field),
                                      err_msg=field)
    assert (t._lt, t._striped_for, t._stripe_lt) == (
        j._lt, j._striped_for, j._stripe_lt)


def _same(got, want, **tol):
    (gi, gs), (wi, ws) = got, want
    assert gi.dtype == wi.dtype == np.uint32
    assert gs.dtype == ws.dtype == np.float64
    assert_topk_equivalent(gi.astype(np.int64), gs, wi.astype(np.int64), ws,
                           **tol)


def _oracle(q, c, k, alive=None):
    """float64 cosine top-k over the rows ``alive`` keeps."""
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cn = c / np.linalg.norm(c, axis=1, keepdims=True)
    s = qn.astype(np.float64) @ cn.astype(np.float64).T
    if alive is not None:
        s[:, ~alive] = -np.inf
    i = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return i.astype(np.uint32), np.take_along_axis(s, i, 1)


def test_jax_file_loads_striped_alike(saved, meshes):
    t, j = _pair(saved, meshes)
    _layouts_equal(t, j)
    assert t.layout.n_tiles == SHARDS * t._lt
    assert repr(t) == repr(j)
    sc = t._sharded
    assert sc.n_shards == SHARDS and sc.ns == t._lt * t.layout.tn
    # Every shard holds a slice of every cluster (the stripe).
    per_shard = t.layout.tile_cluster.reshape(SHARDS, -1)
    live = set(t.layout.tile_cluster[t.layout.tile_cluster >= 0])
    assert all(live <= set(row) | {-1} or len(live) > t._lt
               for row in per_shard)


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("probe", [None, 0.3, 2])
def test_probed_and_exhaustive_agree(saved, meshes, probe, metric):
    t, j = _pair(saved, meshes)
    q = saved[2]
    _same(t.topk(q, 5, metric, probe=probe),
          j.topk(q, 5, metric, probe=probe))


def test_mutations_keep_layouts_and_the_oracle(saved, meshes):
    t, j = _pair(saved, meshes)
    _, c, q = saved
    new = _blobs(np.random.default_rng(5), 1300)
    upd = _blobs(np.random.default_rng(6), 5)
    rows = np.concatenate([c, new])
    for h in (t, j):
        h.add(new[:50])                   # slack and reserve: in place
        h.update(np.arange(5), upd)
        assert h.delete([7, 8, 9]) == 3
    _layouts_equal(t, j)
    rows[:5] = upd
    alive = np.ones(rows.shape[0], bool)
    alive[[7, 8, 9]] = False
    n = 1550
    _same(t.topk(q, 5), _oracle(q, rows[:n], 5, alive[:n]))
    _same(t.topk(q, 5, probe=0.3), j.topk(q, 5, probe=0.3))
    for h in (t, j):
        h.add(new[50:])                   # appended tiles: re-sharded
    _layouts_equal(t, j)
    assert t.n == rows.shape[0] and t.layout.n_tiles > 20
    _same(t.topk(q, 5), _oracle(q, rows, 5, alive))
    _same(t.topk(q, 5, probe=0.3), j.topk(q, 5, probe=0.3))
    before = t.topk(q, 5)
    t.rebuild(clusters=6)
    assert t.drift == 0.0 and t._striped_for == SHARDS
    assert (t.layout.tile_cluster.reshape(SHARDS, -1) >= 0).any(axis=1).all()
    _same(t.topk(q, 5), before)
    _same(t.topk(q, 5), _oracle(q, rows, 5, alive))
    np.testing.assert_allclose(t.matmul(q), j.matmul(q), rtol=1e-5,
                               atol=1e-5)


def test_mesh_save_load_across_packages(saved, meshes, tmp_path):
    t, j = _pair(saved, meshes)
    q = saved[2]
    t.delete([1, 2])
    pt_path, jax_path = tmp_path / "port.npz", tmp_path / "jax.npz"
    t.save(pt_path)
    j.delete([1, 2])
    j.save(jax_path)
    tm, jm = meshes
    for h in (pmt.ClusteredCorpus.load(pt_path, mesh=jm, config=JCFG),
              pt.ClusteredCorpus.load(jax_path, mesh=tm, config=TCFG)):
        for probe in (None, 0.3):
            _same(h.topk(q, 5, probe=probe), t.topk(q, 5, probe=probe))
    # On one device the probe budget is the whole layout's, not a shard's:
    # only the exhaustive results must agree.
    one = pt.ClusteredCorpus.load(pt_path, config=TCFG, device="cpu")
    _same(one.topk(q, 5), t.topk(q, 5))
    assert pt.ClusteredCorpus.load(pt_path, mesh=tm).deleted_count == 2


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
def test_built_on_the_mesh_scans_like_one_device(meshes, storage):
    """A handle built on the mesh: exhaustive requests equal the one-device
    handle's (the same stored rows, every row scanned), and the probed
    path lists tiles in every shard."""
    rng = np.random.default_rng(11)
    c = _blobs(rng, 900)
    q = _blobs(rng, 7)
    mesh = meshes[0]
    h = pt.ClusteredCorpus(c, clusters=4, storage=storage, mesh=mesh,
                           config=TCFG, reserve_tiles=1)
    one = pt.ClusteredCorpus(c, clusters=4, storage=storage, config=TCFG,
                             device="cpu")
    tol = ({} if storage in ("f32", "bf16")
           else {"rtol": 2e-4, "atol": 2e-4})
    for metric in ("cosine", "euclidean"):
        _same(h.topk(q, 6, metric), one.topk(q, 6, metric), **tol)
    i, _ = h.topk(q, 6, probe=0.5)
    assert i.shape == (7, 6) and (i < 900).all()
    assert repr(h).endswith(f"storage={storage!r}, shards={SHARDS})")
    np.testing.assert_allclose(h.matmul(q), one.matmul(q), rtol=1e-5,
                               atol=1e-5)
