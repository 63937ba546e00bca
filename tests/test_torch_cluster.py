"""ops.cluster of the PyTorch port (probed search's layout, probe and
k-means) and the probed-search geometry, against the JAX package.

The same NumPy inputs go to both.  The layout builder and the tile lists
must be identical; centroid scores agree within float32 rounding;
assignments are equal on well-separated data; k-means (whose random draws
differ between the packages) is held to the blob-purity property of the
JAX package's own test.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polars_matmul_tpu.config import SearchConfig as JConfig
from polars_matmul_tpu.ops import cluster as JC
from polars_matmul_tpu_torch import SearchConfig
from polars_matmul_tpu_torch.kernels import storage as pstorage
from polars_matmul_tpu_torch.kernels import fused_topk as F
from polars_matmul_tpu_torch.ops import cluster as PC

JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")

torch.set_num_threads(2)

METRICS = ["cosine", "dot", "euclidean"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n,clusters,tn,seed", [
    (900, 7, 128, 0), (5000, 40, 256, 1), (300, 12, 128, 2),
    (2048, 1, 1024, 3)])
def test_cluster_layout_identical_to_jax(n, clusters, tn, seed):
    r = np.random.default_rng(seed)
    # Skewed assignments with empty clusters (ids drawn from the lower
    # half more often, some never).
    a = np.minimum(r.geometric(0.15, n) - 1, clusters - 1).astype(np.int32)
    got, want = PC.cluster_layout(a, clusters, tn), JC.cluster_layout(
        a, clusters, tn)
    for name in ("perm", "row_pos", "tile_cluster", "counts"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.tn, got.n_tiles, got.n_padded) == (want.tn, want.n_tiles,
                                                   want.n_padded)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except (TypeError, ValueError) as e:
        return type(e), str(e)


@pytest.mark.parametrize("probe", [None, 0.25, 1.0, 0.001, 3, 40, 100,
                                   0.0, 1.5, -2, 0, True, np.int64(7)])
def test_resolve_probe_matches_jax(probe):
    assert _outcome(PC.resolve_probe, probe, 40) == _outcome(
        JC.resolve_probe, probe, 40)


def _scores_inputs(seed, m=20, clusters=9, dim=16):
    r = np.random.default_rng(seed)
    q = r.standard_normal((m, dim)).astype(np.float32)
    cent = (r.standard_normal((clusters, dim)) * 3).astype(np.float32)
    cent[2] = 0.0   # a zero centroid: the cosine guard
    return q, cent


@pytest.mark.parametrize("metric", METRICS)
def test_centroid_scores_match_jax(metric):
    q, cent = _scores_inputs(4)
    got = PC.centroid_scores(_t(q), _t(cent), metric).numpy()
    want = np.asarray(JC.centroid_scores(jnp.asarray(q), jnp.asarray(cent),
                                         metric))
    # float32 products summed in another order: a few ulps of the terms.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _tile_cluster(r, clusters, tiles, dead):
    tcl = np.sort(r.integers(0, clusters, tiles)).astype(np.int32)
    tcl[r.choice(tiles, dead, replace=False)] = -1
    return tcl


# Tie-heavy layouts: many tiles a cluster, so P cuts inside a cluster's
# run of equal scores; dead tiles (-1) rank last.
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("m,tm,p,tiles,dead", [
    (20, 8, 5, 40, 0), (20, 8, 13, 60, 7), (5, 8, 30, 33, 10),
    (37, 16, 33, 33, 3), (1, 8, 1, 12, 2)])
def test_probe_tiles_match_jax(metric, m, tm, p, tiles, dead):
    r = np.random.default_rng(m * 1000 + p)
    q, cent = _scores_inputs(p, m=m, clusters=6)
    tcl = _tile_cluster(r, 6, tiles, dead)
    got = PC.probe_tiles(_t(q), _t(cent), _t(tcl), p=p, tm=tm,
                         metric_v=metric)
    want = np.asarray(JC.probe_tiles(jnp.asarray(q), jnp.asarray(cent),
                                     jnp.asarray(tcl), p=p, tm=tm,
                                     metric_v=metric))
    assert got.dtype == torch.int32 and got.shape == (-(-m // tm), p)
    np.testing.assert_array_equal(got.numpy(), want)
    # Ascending and distinct: kernel A's walk.
    assert (np.diff(got.numpy(), axis=1) > 0).all()


def test_probe_tiles_prefer_lower_ids_among_ties():
    # One query, every tile of one cluster: the first p tile ids win.
    q = np.ones((1, 4), np.float32)
    cent = np.ones((1, 4), np.float32)
    tcl = np.zeros(10, np.int32)
    tcl[[0, 3]] = -1   # dead tiles rank after every live one
    got = PC.probe_tiles(_t(q), _t(cent), _t(tcl), p=4, tm=8,
                         metric_v="dot")
    np.testing.assert_array_equal(got.numpy(), [[1, 2, 4, 5]])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JC.probe_tiles(
            jnp.asarray(q), jnp.asarray(cent), jnp.asarray(tcl), p=4, tm=8,
            metric_v="dot")))


def _separated(seed, n=600, dim=8, blobs=5):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((blobs, dim)) * 10
    x = (centers[np.repeat(np.arange(blobs), n // blobs)]
         + 0.05 * r.standard_normal((n, dim))).astype(np.float32)
    return x, centers.astype(np.float32)


def test_assign_rows_match_jax():
    x, centers = _separated(5)
    got = PC.assign_rows(x, _t(centers), chunk_rows=128)
    want = JC.assign_rows(x, centers, chunk_rows=128)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # A tensor corpus assigns on its own device, the same ids.
    np.testing.assert_array_equal(
        PC.assign_rows(_t(x), _t(centers), chunk_rows=100), want)


@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_assign_rows_native_match_jax(storage):
    x, centers = _separated(6, dim=300)
    ck, dpp, _ = F.feature_geometry(300)
    codes, scales = (pstorage._quantize_rows_np(x) if storage == "int8"
                     else pstorage._quantize_rows_int4_np(x, ck, dpp))
    got = PC.assign_rows_native(codes, scales, _t(centers), storage, 300,
                                chunk_rows=128)
    want = JC.assign_rows_native(codes, scales, centers, storage, 300,
                                 chunk_rows=128)
    np.testing.assert_array_equal(got, want)
    # Device-resident codes give the same.
    np.testing.assert_array_equal(PC.assign_rows_native(
        _t(codes), _t(scales), _t(centers), storage, 300), want)


def test_kmeans_keeps_blobs_pure():
    # tests/test_clustered.py's property: with 10-sigma separation the
    # majority cluster of each tight blob holds no other blob's rows.
    r = np.random.default_rng(1)
    centers = r.standard_normal((5, 8)) * 10
    x = (centers[np.repeat(np.arange(5), 60)]
         + 0.05 * r.standard_normal((300, 8))).astype(np.float32)
    for seed in (0, 1, 2):
        cent, a = PC.kmeans(_t(x), 5, iters=10, seed=seed)
        assert cent.shape == (5, 8) and cent.dtype == torch.float32
        a = a.numpy()
        assert a.dtype == np.int32
        for b in range(5):
            maj = np.bincount(a[b * 60:(b + 1) * 60]).argmax()
            outside = np.delete(a, np.s_[b * 60:(b + 1) * 60])
            assert not (outside == maj).any()
        # The chunked full assignment is the fit's own.
        np.testing.assert_array_equal(
            PC.assign_rows(x, cent, chunk_rows=128), a)
    # Same seed, same centroids; the cluster count clamps to the rows.
    again, _ = PC.kmeans(_t(x), 5, iters=10, seed=2)
    assert torch.equal(again, cent)
    one, a1 = PC.kmeans(_t(x[:3]), 8, seed=0)
    assert one.shape == (3, 8) and set(a1.tolist()) == {0, 1, 2}
    mean, a0 = PC.kmeans(_t(x), 1)
    np.testing.assert_allclose(mean.numpy()[0], x.mean(0), rtol=1e-5,
                               atol=1e-5)
    assert (a0 == 0).all()


def test_permute_rows_matches_jax():
    r = np.random.default_rng(7)
    c = r.standard_normal((50, 6)).astype(np.float32)
    codes = r.integers(-127, 128, (50, 6)).astype(np.int8)
    perm = np.full(64, -1, np.int32)
    perm[r.choice(64, 50, replace=False)] = r.permutation(50)
    for x in (c, codes):
        got = PC.permute_rows(_t(x), _t(perm))
        want = np.asarray(JC.permute_rows(jnp.asarray(x), jnp.asarray(perm)))
        assert got.dtype == _t(x).dtype
        np.testing.assert_array_equal(got.numpy(), want)


CONFIGS = [dict(), dict(block_q=8, block_n=128), dict(block_n=512),
           dict(auto_tile=False), dict(k_pad=256), dict(block_q=64)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_layout_and_block_geometry_match_jax(kw):
    pcfg, jcfg = SearchConfig(**kw), JConfig(**kw)
    for dim in (24, 256, 300, 768, 4200, 9000):
        for k in (1, 10, 16, 17, 100, 129, 600):
            assert F.effective_tiles(pcfg, k) == JF.effective_tiles(jcfg, k)
            assert (F.layout_tile_rows(dim, pcfg, k)
                    == JF.corpus_tile_rows(dim, jcfg, k)), (dim, k)
            for m in (1, 7, 8, 9, 100, 256, 257, 1000):
                assert (F.probe_block_rows(m, dim, pcfg, k)
                        == JF.query_tile_rows(m, dim, jcfg, k)), (m, dim, k)
    # The sizes the port's documents quote, under the default config.
    dflt = SearchConfig()
    assert F.layout_tile_rows(256, dflt) == 2048
    assert F.layout_tile_rows(768, dflt) == 1024
    assert F.layout_tile_rows(24, SearchConfig(block_q=8,
                                               block_n=128)) == 128
    assert F.probe_block_rows(1000, 256, dflt, 10) == 256
    assert F.probe_block_rows(1000, 256, dflt, 100) == 128
    assert F.probe_block_rows(5, 256, dflt, 10) == 8
