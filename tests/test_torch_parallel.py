"""Sharded search of the PyTorch port against the JAX package
(tests/test_parallel.py's cases).

The port runs on meshes that name the CPU eight times (1 x 8 and 2 x 4),
with the plain versions of its kernels; the JAX package runs on its 8
virtual CPU devices (tests/conftest.py).  JAX's shard_map programs take
seconds to compile, so a few module-scoped fixtures hold JAX's distributed
results and the other cases compare with its single-device results.

Tolerances: scores of the default bf16x3 core within
``assert_topk_equivalent``'s (rtol 2e-5, atol 8e-6), index swaps only at
ties; int8 / int4 shards against the JAX package's quantized oracle within
rtol 2e-4 / atol 2e-4 (the JAX package's own bound for them); products
within rtol 1e-5 / atol 1e-5; float64 within rtol 1e-12.
"""

import numpy as np
import pytest
import torch

import polars_matmul_tpu as pmt
import polars_matmul_tpu_torch as pt
from polars_matmul_tpu.ops import topk_search
from polars_matmul_tpu_torch.kernels import fused_topk as F
from polars_matmul_tpu_torch.ops.reference import topk_two_key

from conftest import assert_topk_equivalent

torch.set_num_threads(2)

QUANT_TOL = {"rtol": 2e-4, "atol": 2e-4}
# The JAX handles that serve as oracles run XLA's exact path (Pallas in
# interpret mode would take seconds a request here).
JCFG = pmt.SearchConfig(use_pallas=False)


@pytest.fixture(scope="module")
def mesh8():
    return pt.make_mesh(1, 8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def mesh2x4():
    return pt.make_mesh(2, 4, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh8():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return pmt.make_mesh(1, 8)


@pytest.fixture(scope="module")
def jax_distributed(qc_f32, jmesh8):
    """The JAX package's distributed results on the shared problem:
    {(merge, metric): (vals, idx)}, k=10."""
    import jax.numpy as jnp

    q, c = qc_f32
    sharded = pmt.shard_corpus(jnp.asarray(c), jmesh8)
    out = {}
    for merge, metric in (("allgather", "cosine"), ("allgather", "euclidean"),
                          ("ring", "cosine")):
        cfg = pmt.SearchConfig(merge=merge)
        v, i = pmt.distributed_topk(jnp.asarray(q), sharded, 10, metric,
                                    jmesh8, cfg)
        out[(merge, metric)] = (np.asarray(v), np.asarray(i))
    return out


def _np(v, i):
    return v.numpy(), i.numpy()


def _single(q, c, k, metric, **kw):
    v, i = topk_search(q, c, k, metric, **kw)
    return np.asarray(v), np.asarray(i)


def _same(got, want, **tol):
    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape
    assert_topk_equivalent(gi.astype(np.int64), gv, wi.astype(np.int64), wv,
                           **tol)


def _same_handles(got, want, **tol):
    (gi, gs), (wi, ws) = got, want
    assert gi.dtype == wi.dtype == np.uint32
    assert gs.dtype == ws.dtype == np.float64
    assert_topk_equivalent(gi.astype(np.int64), gs, wi.astype(np.int64), ws,
                           **tol)


# -- the mesh ---------------------------------------------------------------

def test_make_mesh_shape_devices_and_errors():
    mesh = pt.make_mesh(2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "corpus": 4}
    assert mesh.shape[pt.SearchConfig().mesh_axes[1]] == 4
    assert mesh.devices.shape == (2, 4) and mesh.size == 8
    assert mesh.positions() == [(d, s) for d in range(2) for s in range(4)]
    assert mesh.shard_devices(0) == [torch.device("cpu")]
    assert mesh.home == torch.device("cpu") and not mesh.distributed
    # JAX's two errors, word for word.
    for args, jargs in (((3,), (3,)), ((2, 8), (2, 8))):
        with pytest.raises(ValueError) as got:
            pt.make_mesh(*args, devices=["cpu"] * 8)
        with pytest.raises(ValueError) as want:
            pmt.make_mesh(*jargs, devices=list(range(8)))
        assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.make_mesh(1, 2)


# -- distributed_topk ------------------------------------------------------

@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_distributed_topk_matches_jax(qc_f32, mesh8, jax_distributed,
                                      metric):
    q, c = qc_f32   # 203 rows: not a multiple of 8, so the tail pads
    sharded = pt.shard_corpus(c, mesh8)
    assert sharded.n_true == c.shape[0] and sharded.shape == (208, 56)
    got = _np(*pt.distributed_topk(q, sharded, 10, metric, mesh8))
    _same(got, jax_distributed[("allgather", metric)])
    _same(got, _single(q, c, 10, metric))


def test_distributed_topk_k_exceeds_shard(mesh8):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    c = rng.standard_normal((24, 16)).astype(np.float32)   # 3 rows a shard
    got = _np(*pt.distributed_topk(q, pt.shard_corpus(c, mesh8), 10,
                                   "cosine", mesh8))
    _same(got, _single(q, c, 10, "cosine"))


def test_distributed_matmul(qc_f32, mesh8, jmesh8):
    import jax.numpy as jnp

    q, c = qc_f32
    out = pt.distributed_matmul(q, pt.shard_corpus(c, mesh8), mesh8)
    want = np.asarray(pmt.distributed_matmul(
        jnp.asarray(q), pmt.shard_corpus(jnp.asarray(c), jmesh8), jmesh8))
    assert out.dtype == torch.float32 and out.shape == (37, 203)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_data_and_corpus_sharding(mesh2x4, merge):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((17, 32)).astype(np.float32)  # blocks of 8, 9
    c = rng.standard_normal((100, 32)).astype(np.float32)
    cfg = pt.SearchConfig(merge=merge)
    got = _np(*pt.distributed_topk(q, pt.shard_corpus(c, mesh2x4, cfg), 10,
                                   "cosine", mesh2x4, cfg))
    _same(got, _single(q, c, 10, "cosine"))


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_ring_merge_matches_single_device(qc_f32, mesh8, jax_distributed,
                                          metric):
    q, c = qc_f32
    cfg = pt.SearchConfig(merge="ring")
    got = _np(*pt.distributed_topk(q, pt.shard_corpus(c, mesh8, cfg), 10,
                                   metric, mesh8, cfg))
    _same(got, _single(q, c, 10, metric))
    if metric == "cosine":
        _same(got, jax_distributed[("ring", "cosine")])


@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_merge_cross_shard_ties(mesh8, merge):
    """Duplicated rows across shards: exact index parity under ties needs
    the (score, index) keys, whatever order the lists arrive in."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((13, 16)).astype(np.float32)
    cdup = np.concatenate([base] * 8)
    cfg = pt.SearchConfig(merge=merge)
    v, i = pt.distributed_topk(base[:3], pt.shard_corpus(cdup, mesh8), 16,
                               "dot", mesh8, cfg)
    np.testing.assert_array_equal(i.numpy(),
                                  _single(base[:3], cdup, 16, "dot")[1])


def test_corpus_handle_with_mesh(mesh8):
    rng = np.random.default_rng(13)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    c = rng.standard_normal((50, 16)).astype(np.float32)
    h = pt.Corpus(c, mesh=mesh8)
    assert repr(h) == repr(pmt.Corpus(c)).replace("device", "mesh")
    _same_handles(h.topk(q, 5), pmt.topk(q, c, 5))


def test_corpus_handle_matmul_with_mesh(mesh8):
    rng = np.random.default_rng(17)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    c = rng.standard_normal((50, 16)).astype(np.float32)
    out = pt.Corpus(c, mesh=mesh8).matmul(q)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, q @ c.T, rtol=1e-5, atol=1e-5)


def test_distributed_topk_pad_rows_cannot_evict_candidates(mesh8):
    """27 rows over 8 shards pad 5 zero rows into the last shard; with
    every dot score negative they would outrank the real rows unless the
    padding is dead."""
    rng = np.random.default_rng(21)
    q = -np.abs(rng.standard_normal((4, 8))).astype(np.float32)
    c = -np.abs(rng.standard_normal((27, 8))).astype(np.float32)
    sharded = pt.shard_corpus(c, mesh8)
    for merge in ("allgather", "ring"):
        cfg = pt.SearchConfig(merge=merge)
        got = _np(*pt.distributed_topk(q, sharded, 4, "dot", mesh8, cfg))
        _same(got, _single(q, c, 4, "dot"))


@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_ring_merge_query_pipelining(mesh8, pipeline):
    rng = np.random.default_rng(31)
    q = rng.standard_normal((7, 24)).astype(np.float32)
    c = rng.standard_normal((150, 24)).astype(np.float32)
    cfg = pt.SearchConfig(merge="ring", ring_pipeline=pipeline)
    got = _np(*pt.distributed_topk(q, pt.shard_corpus(c, mesh8), 6,
                                   "cosine", mesh8, cfg))
    _same(got, _single(q, c, 6, "cosine"))


def test_distributed_topk_masked(mesh8):
    import jax.numpy as jnp

    rng = np.random.default_rng(51)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    c = rng.standard_normal((100, 16)).astype(np.float32)
    mask = rng.random(100) < 0.4
    got = _np(*pt.distributed_topk(q, pt.shard_corpus(c, mesh8), 5,
                                   "cosine", mesh8, mask=mask))
    _same(got, _single(q, c, 5, "cosine", mask=jnp.asarray(mask)))
    assert mask[got[1].reshape(-1)].all()


def test_distributed_masked_fewer_matches_than_k(mesh8):
    """A shard with fewer matches than k gives sentinels; the offset must
    not be added to them."""
    rng = np.random.default_rng(71)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    c = rng.standard_normal((24, 8)).astype(np.float32)
    mask = np.zeros(24, bool)
    mask[7] = True
    sharded = pt.shard_corpus(c, mesh8)
    for merge in ("allgather", "ring"):
        cfg = pt.SearchConfig(merge=merge)
        v, i = _np(*pt.distributed_topk(q, sharded, 4, "dot", mesh8, cfg,
                                        mask=mask))
        assert (i[:, 0] == 7).all(), merge
        assert (i[:, 1:] == np.iinfo(np.int32).max).all(), merge
        assert np.isneginf(v[:, 1:]).all(), merge
    # Euclidean sentinels are +inf distances, as in the JAX package.
    v, i = _np(*pt.distributed_topk(q, sharded, 4, "euclidean", mesh8,
                                    mask=mask))
    assert np.isposinf(v[:, 1:]).all() and (i[:, 0] == 7).all()


def test_sharded_chunked_prep_matches_oneshot(mesh8):
    rng = np.random.default_rng(81)
    q = rng.standard_normal((5, 24)).astype(np.float32)
    c = rng.standard_normal((333, 24)).astype(np.float32)
    small_cfg = pt.SearchConfig(prep_chunk_bytes=1 << 12)   # 42-row chunks
    big = pt.shard_corpus(c, mesh8)
    small = pt.shard_corpus(c, mesh8, small_cfg)
    v1, i1 = pt.distributed_topk(q, big, 7, "cosine", mesh8)
    v2, i2 = pt.distributed_topk(q, small, 7, "cosine", mesh8, small_cfg)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)
    got = _np(*pt.distributed_topk(q, small, 4, "euclidean", mesh8,
                                   small_cfg))
    _same(got, _single(q, c, 4, "euclidean"))


# -- storage tiers on the mesh -----------------------------------------------

class TestShardedBf16Storage:
    def test_matches_jax(self, mesh8):
        rng = np.random.default_rng(91)
        q = rng.standard_normal((10, 48)).astype(np.float32)
        c = rng.standard_normal((333, 48)).astype(np.float32)
        h = pt.Corpus(c, storage="bf16", mesh=mesh8)
        _same_handles(h.topk(q, 6, "cosine"),
                      pmt.Corpus(c, storage="bf16").topk(q, 6, "cosine"))
        assert h._device.dtype == torch.bfloat16
        (forms,) = h._device._prepared.values()
        assert all(cp.dtype == torch.bfloat16 for cp, _ in forms.values())

    def test_ring_merge_and_mask(self, mesh8):
        rng = np.random.default_rng(92)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        c = rng.standard_normal((200, 32)).astype(np.float32)
        mask = rng.random(200) < 0.4
        mask[:8] = True
        h = pt.Corpus(c, storage="bf16", mesh=mesh8,
                      config=pt.SearchConfig(merge="ring"))
        got = h.topk(q, 5, "dot", mask=mask)
        assert mask[got[0].reshape(-1)].all()
        _same_handles(got, pmt.Corpus(c, storage="bf16").topk(
            q, 5, "dot", mask=mask))

    def test_fallback_path_upcasts_per_shard(self, mesh8):
        """A shard's k above max_fused_k (1100 of 1200 rows a shard) takes
        the reference path on the upcast bf16 shards."""
        rng = np.random.default_rng(93)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((9600, 16)).astype(np.float32)
        h = pt.Corpus(c, storage="bf16", mesh=mesh8)
        before = dict(F.launches)
        i, v = h.topk(q, 1100, "cosine")
        assert F.launches == before   # no kernel, no plain version
        assert i.shape == (4, 1100)
        cq = c.astype(np.float32)
        cq = torch.from_numpy(cq).to(torch.bfloat16).float().numpy()
        _same_handles((i, v), pmt.topk(q, cq, 1100, "cosine"))

    def test_matmul_upcasts_per_shard(self, mesh8):
        rng = np.random.default_rng(94)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((64, 16)).astype(np.float32)
        out = pt.Corpus(c, storage="bf16", mesh=mesh8).matmul(q)
        assert out.dtype == np.float32
        np.testing.assert_allclose(
            out, pmt.Corpus(c, storage="bf16").matmul(q), rtol=1e-5,
            atol=1e-5)


class TestShardedInt8Storage:
    @pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
    def test_matches_jax(self, mesh8, metric):
        rng = np.random.default_rng(96)
        q = rng.standard_normal((10, 48)).astype(np.float32)
        c = rng.standard_normal((333, 48)).astype(np.float32)
        h = pt.Corpus(c, storage="int8", mesh=mesh8)
        _same_handles(h.topk(q, 6, metric),
                      pmt.Corpus(c, storage="int8", config=JCFG).topk(q, 6, metric),
                      **QUANT_TOL)
        sc = h._device
        assert sc.dtype == torch.int8 and sc.scales is not None
        for forms in sc._prepared.values():
            for key, (cp, cb) in forms.items():
                assert cp.data_ptr() == sc.shards[key].data_ptr()
                assert cb.shape[0] == 2

    def test_ring_merge_and_mask(self, mesh8):
        rng = np.random.default_rng(97)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        c = rng.standard_normal((200, 32)).astype(np.float32)
        mask = rng.random(200) < 0.4
        mask[:8] = True
        h = pt.Corpus(c, storage="int8", mesh=mesh8,
                      config=pt.SearchConfig(merge="ring"))
        i, _ = h.topk(q, 5, "dot", mask=mask)
        assert mask[i.reshape(-1)].all()
        np.testing.assert_array_equal(
            i, pmt.Corpus(c, storage="int8").topk(q, 5, "dot",
                                                   mask=mask)[0])

    def test_fallback_path_dequantizes_per_shard(self, mesh8):
        rng = np.random.default_rng(98)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((9600, 16)).astype(np.float32)
        h = pt.Corpus(c, storage="int8", mesh=mesh8)
        i, v = h.topk(q, 1100, "cosine")
        assert i.shape == (4, 1100)
        _same_handles((i, v), pmt.Corpus(c, storage="int8").topk(
            q, 1100, "cosine"), **QUANT_TOL)

    def test_matmul_dequantizes_per_shard(self, mesh8):
        rng = np.random.default_rng(99)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((64, 16)).astype(np.float32)
        out = pt.Corpus(c, storage="int8", mesh=mesh8).matmul(q)
        assert out.dtype == np.float32
        np.testing.assert_allclose(
            out, pmt.Corpus(c, storage="int8").matmul(q), rtol=1e-5,
            atol=1e-5)

    def test_chunked_prep_and_save_load_across_packages(self, mesh8,
                                                        jmesh8, tmp_path):
        rng = np.random.default_rng(100)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        c = rng.standard_normal((900, 32)).astype(np.float32)
        h1 = pt.Corpus(c, storage="int8", mesh=mesh8)
        h2 = pt.Corpus(c, storage="int8", mesh=mesh8,
                       config=pt.SearchConfig(prep_chunk_bytes=8192))
        i1, v1 = h1.topk(q, 5, "euclidean")
        i2, v2 = h2.topk(q, 5, "euclidean")
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-6, atol=1e-6)
        # The mesh handle saves gathered shards; the JAX package loads
        # them, on one device and on its mesh.
        p = tmp_path / "mesh_i8.npz"
        h1.save(p)
        j = pmt.Corpus.load(p)
        assert j.n == 900 and j.storage == "int8"
        np.testing.assert_array_equal(i1, j.topk(q, 5, "euclidean")[0])
        jm = pmt.Corpus.load(p, mesh=jmesh8)
        np.testing.assert_array_equal(i1, jm.topk(q, 5, "euclidean")[0])


def test_mesh_save_load_f32(mesh8, tmp_path):
    rng = np.random.default_rng(101)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    c = rng.standard_normal((100, 16)).astype(np.float32)
    h = pt.Corpus(c, mesh=mesh8)
    i0, _ = h.topk(q, 3)
    p = tmp_path / "mesh_f32.npz"
    h.save(p)
    np.testing.assert_array_equal(i0, pt.Corpus.load(p, mesh=mesh8).topk(
        q, 3)[0])
    np.testing.assert_array_equal(i0, pt.Corpus.load(p, device="cpu").topk(
        q, 3)[0])
    np.testing.assert_array_equal(i0, pmt.Corpus.load(p).topk(q, 3)[0])
    # A JAX-saved file loads onto the port's mesh.
    pj = tmp_path / "jax_f32.npz"
    pmt.Corpus(c).save(pj)
    np.testing.assert_array_equal(i0, pt.Corpus.load(pj, mesh=mesh8).topk(
        q, 3)[0])


def test_sharded_int8_shared_storage(mesh8):
    """int8 shards keep the JAX package's 4096-row shard height and serve
    as their own prepared form (the codes once), at the kernel's width."""
    rng = np.random.default_rng(105)
    q = rng.standard_normal((6, 48)).astype(np.float32)
    c = rng.standard_normal((333, 48)).astype(np.float32)
    h = pt.Corpus(c, storage="int8", mesh=mesh8)
    j = pmt.Corpus(c, storage="int8", config=JCFG)
    assert h._device.shape == (8 * 4096, 48) and h._device.ns == 4096
    for metric in ("cosine", "dot", "euclidean"):
        i, v = h.topk(q, 5, metric)
        _same_handles((i, v), j.topk(q, 5, metric), **QUANT_TOL)
        assert (i < 333).all()
    for forms in h._device._prepared.values():
        for key, (cp, _) in forms.items():
            assert cp.data_ptr() == h._device.shards[key].data_ptr()
    mask = rng.random(333) < 0.3
    mask[:6] = True
    i2, _ = h.topk(q, 4, "euclidean", mask=mask)
    assert mask[i2.reshape(-1)].all()


def test_sharded_int4_storage(mesh8, tmp_path):
    rng = np.random.default_rng(107)
    q = rng.standard_normal((6, 48)).astype(np.float32)
    c = rng.standard_normal((333, 48)).astype(np.float32)
    h = pt.Corpus(c, storage="int4", mesh=mesh8)
    j = pmt.Corpus(c, storage="int4", config=JCFG)
    assert h._device.width == 64                  # packed width dpp / 2
    for metric in ("cosine", "dot", "euclidean"):
        i, v = h.topk(q, 5, metric)
        _same_handles((i, v), j.topk(q, 5, metric), **QUANT_TOL)
        assert (i < 333).all()
    for forms in h._device._prepared.values():
        for key, (cp, _) in forms.items():
            assert cp.data_ptr() == h._device.shards[key].data_ptr()
    _same_handles(h.topk(q, 200), j.topk(q, 200), **QUANT_TOL)
    np.testing.assert_allclose(h.matmul(q[:2]), j.matmul(q[:2]), rtol=1e-5,
                               atol=1e-5)
    p = tmp_path / "mesh_i4.npz"
    h.save(p)
    np.testing.assert_array_equal(pmt.Corpus.load(p).topk(q, 5)[0],
                                  h.topk(q, 5)[0])


# -- mutation on the mesh --------------------------------------------------

class TestShardedUpdate:
    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
    def test_update_matches_fresh_corpus(self, mesh8, storage):
        rng = np.random.default_rng(71)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        c = rng.standard_normal((500, 32)).astype(np.float32)
        h = pt.Corpus(c, mesh=mesh8, storage=storage)
        h.topk(q, 5, "cosine")      # prepared forms exist before the update
        h.topk(q, 5, "euclidean")
        idx = np.array([0, 7, 63, 64, 255, 499])   # several shards
        new = rng.standard_normal((6, 32)).astype(np.float32) * 2.0
        h.update(idx, new)
        c2 = c.copy()
        c2[idx] = new
        fresh = pt.Corpus(c2, mesh=mesh8, storage=storage)
        # bf16: cosine rounds the normalised rows, which only the
        # kernel path does.
        jax_fresh = pmt.Corpus(c2, storage=storage,
                               config=None if storage == "bf16" else JCFG)
        for metric in ("cosine", "dot", "euclidean"):
            i1, v1 = h.topk(q, 5, metric)
            i2, v2 = fresh.topk(q, 5, metric)
            np.testing.assert_array_equal(i1, i2, err_msg=metric)
            np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)
            _same_handles((i1, v1), jax_fresh.topk(q, 5, metric),
                          **QUANT_TOL)

    def test_update_matches_single_device(self, mesh8):
        rng = np.random.default_rng(72)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((200, 16)).astype(np.float32)
        hm = pt.Corpus(c, mesh=mesh8)
        hj = pmt.Corpus(c)
        idx = np.array([3, 100, 199])
        new = rng.standard_normal((3, 16)).astype(np.float32)
        hm.update(idx, new)
        hj.update(idx, new)
        _same_handles(hm.topk(q, 7), hj.topk(q, 7))
        np.testing.assert_allclose(hm.matmul(q), hj.matmul(q), rtol=1e-4,
                                   atol=1e-4)

    def test_update_revives_tombstoned_row_on_mesh(self, mesh8):
        rng = np.random.default_rng(73)
        c = rng.standard_normal((120, 16)).astype(np.float32)
        h = pt.Corpus(c, mesh=mesh8)
        target = c[44] + rng.standard_normal(16).astype(np.float32) * 1e-3
        h.delete([44])
        assert h.topk(target[None], 1)[0][0, 0] != 44
        h.update([44], c[44][None])
        assert h.topk(target[None], 1)[0][0, 0] == 44

    def test_int8_shared_prep_stays_aliased_after_update(self, mesh8):
        rng = np.random.default_rng(74)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c = rng.standard_normal((300, 16)).astype(np.float32)
        h = pt.Corpus(c, mesh=mesh8, storage="int8")
        h.topk(q, 4, "cosine")
        h.topk(q, 4, "dot")
        ptrs = {key: t.data_ptr() for key, t in h._device.shards.items()}
        h.update(np.arange(10), c[:10] * 3.0)
        for forms in h._device._prepared.values():
            for key, (cp, _) in forms.items():
                assert cp.data_ptr() == ptrs[key]
        c2 = c.copy()
        c2[:10] = c[:10] * 3.0
        fresh = pt.Corpus(c2, mesh=mesh8, storage="int8")
        for metric in ("cosine", "dot"):
            i1, v1 = h.topk(q, 4, metric)
            i2, v2 = fresh.topk(q, 4, metric)
            np.testing.assert_array_equal(i1, i2, err_msg=metric)
            np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)

    def test_update_validation_on_mesh(self, mesh8):
        rng = np.random.default_rng(75)
        c = rng.standard_normal((100, 16)).astype(np.float32)
        h = pt.Corpus(c, mesh=mesh8)
        with pytest.raises(ValueError, match="must be unique"):
            h.update([1, 1], np.ones((2, 16), np.float32))
        with pytest.raises(ValueError, match="Dimension mismatch"):
            h.update([1], np.ones((1, 8), np.float32))
        with pytest.raises(ValueError, match="in \\[0, 100\\)"):
            h.update([100], np.ones((1, 16), np.float32))
        h.update(np.empty(0, np.int64), np.empty((0, 16), np.float32))


class TestShardedAdd:
    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
    def test_add_matches_fresh_corpus(self, mesh8, storage):
        rng = np.random.default_rng(81)
        q = rng.standard_normal((5, 32)).astype(np.float32)
        c = rng.standard_normal((200, 32)).astype(np.float32)
        h = pt.Corpus(c, mesh=mesh8, storage=storage, capacity=400)
        h.topk(q, 5, "cosine")      # prep before the growth
        new = rng.standard_normal((57, 32)).astype(np.float32)
        assert h.add(new) == 257
        c2 = np.vstack([c, new])
        fresh = pt.Corpus(c2, mesh=mesh8, storage=storage, capacity=400)
        # bf16: cosine rounds the normalised rows, which only the
        # kernel path does.
        jax_fresh = pmt.Corpus(c2, storage=storage,
                               config=None if storage == "bf16" else JCFG)
        for metric in ("cosine", "dot", "euclidean"):
            i1, v1 = h.topk(q, 6, metric)
            i2, v2 = fresh.topk(q, 6, metric)
            np.testing.assert_array_equal(i1, i2, err_msg=metric)
            np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)
            _same_handles((i1, v1), jax_fresh.topk(q, 6, metric),
                          **QUANT_TOL)
        if storage in ("f32", "bf16"):
            assert h.topk(new[30][None], 1, "cosine")[0][0, 0] == 230

    def test_add_writes_in_place(self, mesh8):
        """The port's counterpart of JAX's no-recompile test: adds within
        capacity write into the shards and prepared forms where they are."""
        rng = np.random.default_rng(82)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c = rng.standard_normal((100, 16)).astype(np.float32)
        h = pt.Corpus(c, mesh=mesh8, capacity=300)
        h.topk(q, 4, "cosine")
        ((cp0, cb0),) = [(cp.data_ptr(), cb.data_ptr()) for forms in
                         h._device._prepared.values()
                         for key, (cp, cb) in forms.items() if key[0] == 0]
        ptrs = {key: t.data_ptr() for key, t in h._device.shards.items()}
        for _ in range(3):
            h.add(rng.standard_normal((10, 16)).astype(np.float32))
            h.topk(q, 4, "cosine")
        assert {key: t.data_ptr() for key, t in
                h._device.shards.items()} == ptrs
        forms = next(iter(h._device._prepared.values()))
        key0 = next(key for key in forms if key[0] == 0)
        assert (forms[key0][0].data_ptr(),
                forms[key0][1].data_ptr()) == (cp0, cb0)
        assert h.n == 130 and h._device.n_true == 130

    def test_add_then_update_delete_and_save_load(self, mesh8, jmesh8,
                                                  tmp_path):
        rng = np.random.default_rng(83)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c = rng.standard_normal((90, 16)).astype(np.float32)
        new = rng.standard_normal((30, 16)).astype(np.float32)
        upd = rng.standard_normal((1, 16)).astype(np.float32)
        h = pt.Corpus(c, mesh=mesh8, storage="int8", capacity=200)
        j = pmt.Corpus(c, mesh=jmesh8, storage="int8", capacity=200)
        for x in (h, j):
            x.add(new)
            x.update([100], upd)
            x.delete([5, 119])
        _same_handles(h.topk(q, 5), j.topk(q, 5), **QUANT_TOL)
        p = tmp_path / "mesh_add.npz"
        h.save(p)
        for h2 in (pt.Corpus.load(p, mesh=mesh8, capacity=200),
                   pmt.Corpus.load(p, mesh=jmesh8, capacity=200)):
            i1, v1 = h.topk(q, 5)
            i2, v2 = h2.topk(q, 5)
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_allclose(v1, v2, rtol=1e-5)
            assert h2.n == 120 and h2.deleted_count == 2
            h2.add(rng.standard_normal((10, 16)).astype(np.float32))
            assert h2.n == 130

    def test_add_requires_capacity_and_respects_it(self, mesh8, jmesh8):
        rng = np.random.default_rng(84)
        c = rng.standard_normal((50, 16)).astype(np.float32)
        cases = ((lambda mesh, cap: None, np.ones((1, 16), np.float32)),
                 (lambda mesh, cap: 60, np.ones((100, 16), np.float32)))
        for capacity, rows in cases:
            errors = []
            for lib, mesh in ((pt, mesh8), (pmt, jmesh8)):
                h = lib.Corpus(c, mesh=mesh, capacity=capacity(mesh, None))
                with pytest.raises(ValueError) as e:
                    h.add(rows)
                errors.append(str(e.value))
            assert errors[0] == errors[1]
        h = pt.Corpus(c, mesh=mesh8, capacity=60)
        assert h.add(np.empty((0, 16), np.float32)) == 50


class TestF64Mesh:
    def test_f64_mesh_matches_single_device(self, mesh8):
        rng = np.random.default_rng(85)
        base = rng.standard_normal((60, 16))
        c = np.repeat(base, 2, axis=0)
        c[1::2] *= 1.0 + 1e-12
        q = base[:6] + 1e-13
        hm = pt.Corpus(c, mesh=mesh8)
        hs = pt.Corpus(c, device="cpu")
        hj = pmt.Corpus(c)
        for metric in ("dot", "euclidean"):
            im, vm = hm.topk(q, 5, metric)
            # The same float64 arithmetic as the port's one-device handle.
            i1, v1 = hs.topk(q, 5, metric)
            np.testing.assert_array_equal(im, i1, err_msg=metric)
            np.testing.assert_array_equal(vm, v1, err_msg=metric)
            # The JAX package's: dot to rtol 1e-12 (an f32 corpus would be
            # 1e-7 off); euclidean also within the square root of 16 ulps
            # of |q|^2 + |c|^2 (4e-7 here): near a distance of 0 (the twin
            # rows) two float64 sums of |q|^2 + |c|^2 - 2 q.c cancel to
            # a few ulps, which the root lifts.
            sq = (q * q).sum(1).max() + (c * c).sum(1).max()
            tol = ({"rtol": 1e-12, "atol": 0.0} if metric == "dot" else
                   {"rtol": 1e-12,
                    "atol": float(np.sqrt(16 * np.finfo(np.float64).eps
                                          * sq))})
            _same_handles((im, vm), hj.topk(q, 5, metric), **tol)
        pm = hm.matmul(q)
        assert pm.dtype == np.float64
        np.testing.assert_allclose(pm, hj.matmul(q), rtol=1e-12)


# -- kernel B's plain version on lists out of index order ------------------

@pytest.mark.parametrize("splits", [2, 4, 33])
def test_merge_plain_orders_out_of_order_lists_by_keys(splits):
    """Lists in visiting order (index ranges not ascending from list to
    list, ties across lists): the merge orders by (value desc, index asc),
    as kernel B does, and as the JAX package's two-key merge does."""
    import importlib.util
    from pathlib import Path

    import jax.numpy as jnp
    from polars_matmul_tpu.parallel.sharded import _merge_sorted_2key

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator()
    gen.manual_seed(splits)
    for m, k in ((1, 10), (8, 16), (37, 100)):
        pv, pi = smoke.shuffled_lists(torch, gen, m, splits, k, device="cpu")
        v, i = F.topk_merge_plain(pv, pi, k)
        flat_v, flat_i = pv.reshape(m, -1).numpy(), pi.reshape(m, -1).numpy()
        flat_i = np.where(np.isneginf(flat_v), np.iinfo(np.int32).max,
                          flat_i)
        order = np.lexsort((flat_i, -flat_v), axis=1)[:, :k]
        np.testing.assert_array_equal(i.numpy(),
                                      np.take_along_axis(flat_i, order, 1))
        np.testing.assert_array_equal(v.numpy(),
                                      np.take_along_axis(flat_v, order, 1))
        jv, ji = _merge_sorted_2key(jnp.asarray(flat_v), jnp.asarray(flat_i),
                                    k, True)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        # A positional stable sort would break these ties by list order.
        assert topk_two_key(torch.from_numpy(flat_v),
                            torch.from_numpy(flat_i), k,
                            True)[1].tolist() == i.tolist()


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch):
    """With no --devices the dryrun takes the visible cards, and with none
    it raises: the CPU runs only when the caller names it."""
    from polars_matmul_tpu_torch.tools import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])


def test_dryrun_on_eight_cpu_positions():
    from polars_matmul_tpu_torch.tools.dryrun import dryrun_multichip

    before = F.launches["topk_merge_plain"]
    dryrun_multichip(["cpu"] * 8)
    assert F.launches["topk_merge_plain"] > before   # the merges ran
