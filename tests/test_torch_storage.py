"""``Corpus(storage="bf16" | "int8" | "int4")`` of the PyTorch port against
the JAX package's ``Corpus`` on the same NumPy inputs.

The port runs on ``device="cpu"``, where every kernel wrapper runs its
plain PyTorch version; the JAX package runs its Pallas kernel in
interpret mode.  Scores agree within ``assert_topk_equivalent``'s
defaults, index differences only on tied scores; stored codes are
bit-identical.
"""

import numpy as np
import pytest
import torch

import polars_matmul_tpu as pmt
import polars_matmul_tpu_torch as pt
from polars_matmul_tpu_torch.kernels import storage as pstorage
from polars_matmul_tpu_torch.kernels import fused_topk as F

from conftest import assert_topk_equivalent

torch.set_num_threads(2)

METRICS = ["cosine", "dot", "euclidean"]
TIERS = ["bf16", "int8", "int4"]
CPU = "cpu"


def _data(m=9, n=257, dim=48, seed=41, dtype=np.float32):
    r = np.random.default_rng(seed)
    c = r.standard_normal((n, dim)).astype(dtype)
    c[7] = 0.0
    return r.standard_normal((m, dim)).astype(dtype), c


def _same(got, want, **tol):
    (gi, gs), (wi, ws) = got, want
    assert gi.dtype == wi.dtype == np.uint32
    assert gs.dtype == ws.dtype == np.float64
    assert_topk_equivalent(gi.astype(np.int64), gs, wi.astype(np.int64), ws,
                           **tol)


def _stored(corpus):
    """The port's stored bytes as NumPy (bf16 as uint16 bits)."""
    d = corpus._device
    if d.dtype == torch.bfloat16:
        return d.view(torch.int16).numpy().view(np.uint16)
    return d.numpy()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("storage", TIERS)
def test_corpus_tiers_match_jax(storage, metric):
    q, c = _data()
    h = pt.Corpus(c, storage=storage, device=CPU)
    j = pmt.Corpus(c, storage=storage)
    assert h.dtype == np.float32 and len(h) == c.shape[0]
    before = F.launches["fused_topk_plain"]
    _same(h.topk(q, 12, metric), j.topk(q, 12, metric))
    assert F.launches["fused_topk_plain"] == before + 1


@pytest.mark.parametrize("storage", TIERS)
def test_corpus_tier_mask_and_half_queries_match_jax(storage):
    q, c = _data(seed=42)
    mask = np.arange(c.shape[0]) % 3 != 0
    h = pt.Corpus(c, storage=storage, device=CPU)
    j = pmt.Corpus(c, storage=storage)
    _same(h.topk(q, 9, "dot", mask=mask), j.topk(q, 9, "dot", mask=mask))
    q16 = q.astype(np.float16)
    _same(h.topk(q16, 5, "euclidean"), j.topk(q16, 5, "euclidean"))
    _same(h.topk(torch.from_numpy(q16), 5, "euclidean"),
          j.topk(q16, 5, "euclidean"))


def test_prequantized_int8_and_prepacked_int4_match_jax():
    q, c = _data(seed=43, dim=300)
    codes, scales = pstorage._quantize_rows_np(c)
    h = pt.Corpus(codes, storage="int8", scales=scales, device=CPU)
    j = pmt.Corpus(codes, storage="int8", scales=scales)
    np.testing.assert_array_equal(_stored(h), codes)
    _same(h.topk(q, 10, "cosine"), j.topk(q, 10, "cosine"))
    # Tensors in: held as they are, on their own device.
    ht = pt.Corpus(torch.from_numpy(codes), storage="int8",
                   scales=torch.from_numpy(scales))
    assert ht.device == torch.device("cpu")
    _same(ht.topk(q, 10, "cosine"), j.topk(q, 10, "cosine"))

    ck, dpp, _ = F.feature_geometry(300)
    packed, scales4 = pstorage._quantize_rows_int4_np(c, ck, dpp)
    h4 = pt.Corpus(packed, storage="int4", scales=scales4, dim=300,
                   device=CPU)
    j4 = pmt.Corpus(packed, storage="int4", scales=scales4, dim=300)
    assert (h4.n, h4.dim) == (c.shape[0], 300)
    np.testing.assert_array_equal(_stored(h4), packed)
    _same(h4.topk(q, 10, "euclidean"), j4.topk(q, 10, "euclidean"))
    # Floats quantized by the package itself give the same codes.
    np.testing.assert_array_equal(
        _stored(pt.Corpus(c, storage="int4", device=CPU)), packed)


def _err(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_constructor_errors_match_jax():
    _, c = _data(n=20, dim=48)
    codes, scales = pstorage._quantize_rows_np(c)
    packed, sc4 = pstorage._quantize_rows_int4_np(c, 128, 128)
    cases = [
        ((codes,), {}),
        ((codes,), {"storage": "bf16"}),
        ((codes,), {"storage": "int8"}),
        ((codes,), {"storage": "int8", "scales": scales[:5]}),
        ((packed,), {"storage": "int4", "scales": sc4}),
        ((packed,), {"storage": "int4", "dim": 48}),
        ((packed,), {"storage": "int4", "scales": sc4, "dim": 300}),
        ((packed,), {"storage": "int4", "scales": sc4[:3], "dim": 48}),
        ((c,), {"storage": "int8", "scales": scales}),
        ((c,), {"storage": "int4", "dim": 48}),
        ((c,), {"storage": "f16"}),
    ]
    for args, kw in cases:
        assert (_err(pt.Corpus, *args, device=CPU, **kw)
                == _err(pmt.Corpus, *args, **kw)), kw


def test_quantized_tiers_override_the_config_precision():
    q, c = _data(seed=44)
    for storage, core in (("bf16", "bf16c"), ("int8", "int8c"),
                          ("int4", "int4c")):
        cfg = pt.SearchConfig(precision="highest")
        h = pt.Corpus(c, storage=storage, config=cfg, device=CPU)
        assert h._effective_precision() == core
        got = h.topk(q, 6, "cosine")
        assert list(h._prepared) == [("cosine", core)]
        _same(got, pmt.Corpus(c, storage=storage,
                              config=pmt.SearchConfig(
                                  precision="highest")).topk(q, 6, "cosine"))
        # Equal to the tier's default config, bit for bit.
        base = pt.Corpus(c, storage=storage, device=CPU).topk(q, 6, "cosine")
        np.testing.assert_array_equal(got[1], base[1])


@pytest.mark.parametrize("precision", ["bf16c", "int8c", "int4c"])
def test_f32_corpus_runs_a_quantized_precision_like_jax(precision):
    q, c = _data(seed=45)
    h = pt.Corpus(c, config=pt.SearchConfig(precision=precision),
                  device=CPU)
    j = pmt.Corpus(c, config=pmt.SearchConfig(precision=precision))
    _same(h.topk(q, 8, "cosine"), j.topk(q, 8, "cosine"))
    _same(pt.topk(q, c, 8, "dot", config=pt.SearchConfig(precision=precision),
                  device=CPU),
          pmt.topk(q, c, 8, "dot",
                   config=pmt.SearchConfig(precision=precision)))


@pytest.mark.parametrize("storage", TIERS)
def test_f64_input_gives_f32_semantics_and_f32_matmul(storage):
    q, c = _data(seed=46, dtype=np.float64)
    h = pt.Corpus(c, storage=storage, device=CPU)
    j = pmt.Corpus(c, storage=storage)
    assert h.dtype == j.dtype == np.float32
    q32 = q.astype(np.float32)
    got, want = h.matmul(q32), j.matmul(q32)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    before = F.launches["fused_topk_plain"]
    _same(h.topk(q32, 5, "dot"), j.topk(q32, 5, "dot"))
    assert F.launches["fused_topk_plain"] == before + 1


@pytest.mark.parametrize("storage", TIERS)
def test_reference_paths_use_the_dense_view(storage):
    # k > 1024 and use_pallas=False score the dequantized rows on the
    # reference path, as in the JAX package; no kernel version runs.
    q, c = _data(m=3, n=1100, dim=16, seed=47)
    h = pt.Corpus(c, storage=storage, device=CPU)
    j = pmt.Corpus(c, storage=storage)
    before = dict(F.launches)
    _same(h.topk(q, 1050, "cosine"), j.topk(q, 1050, "cosine"))
    cfg = pt.SearchConfig(use_pallas=False)
    hr = pt.Corpus(c, storage=storage, config=cfg, device=CPU)
    jr = pmt.Corpus(c, storage=storage,
                    config=pmt.SearchConfig(use_pallas=False))
    _same(hr.topk(q, 7, "euclidean"), jr.topk(q, 7, "euclidean"))
    assert F.launches == before
    assert h._f32_view is not None and h._f32_view.dtype == torch.float32


def test_quantized_storage_above_max_fused_dim_stays_on_the_kernel():
    q, c = _data(m=4, n=300, dim=48, seed=48)
    cfg = pt.SearchConfig(max_fused_dim=32)
    jcfg = pmt.SearchConfig(max_fused_dim=32)
    assert not F.supports(q.shape, c.shape, np.float32, 5, cfg)
    for storage in TIERS:
        h = pt.Corpus(c, storage=storage, config=cfg, device=CPU)
        before = F.launches["fused_topk_plain"]
        _same(h.topk(q, 5, "cosine"),
              pmt.Corpus(c, storage=storage, config=jcfg).topk(q, 5,
                                                               "cosine"))
        assert F.launches["fused_topk_plain"] == before + 1
        assert h._f32_view is None
    before = F.launches["fused_topk_plain"]
    pt.Corpus(c, config=cfg, device=CPU).topk(q, 5, "cosine")
    assert F.launches["fused_topk_plain"] == before   # f32: the reference


def test_prepared_forms_share_the_stored_rows():
    q, c = _data(seed=49)
    for storage in ("int8", "int4"):
        h = pt.Corpus(c, storage=storage, device=CPU)
        for metric in METRICS:
            h.topk(q, 3, metric)
            cp, cbp = h._prepared_for(F.Metric.parse(metric))
            assert cp.data_ptr() == h._device.data_ptr()
            assert cbp.shape == (2, h.n)
    h = pt.Corpus(c, storage="bf16", device=CPU)
    h.topk(q, 3, "dot")
    h.topk(q, 3, "cosine")
    assert h._prepared_for(F.Metric.DOT)[0].data_ptr() == \
        h._device.data_ptr()
    assert h._prepared_for(F.Metric.COSINE)[0].data_ptr() != \
        h._device.data_ptr()


@pytest.mark.parametrize("storage", ["f32"] + TIERS)
def test_tiny_prep_chunks_give_the_same_results(storage):
    q, c = _data(seed=50)
    tiny = pt.SearchConfig(prep_chunk_bytes=48 * 4 * 10)   # 10 rows a chunk
    # A tensor input quantizes in chunks on its device; NumPy on the host.
    chunked = pt.Corpus(torch.from_numpy(c), storage=storage, config=tiny)
    whole = pt.Corpus(c, storage=storage, device=CPU)
    assert chunked._chunk_rows == 10
    np.testing.assert_array_equal(_stored(chunked), _stored(whole))
    if storage in ("int8", "int4"):
        assert torch.equal(chunked._scales, whole._scales)
    for metric in METRICS:
        got, want = chunked.topk(q, 7, metric), whole.topk(q, 7, metric)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("storage", TIERS)
def test_save_load_round_trips_with_jax(storage, tmp_path):
    q, c = _data(seed=51, dim=300)
    # JAX saves, the port loads: the stored bytes and tombstones carry over.
    j = pmt.Corpus(c, storage=storage)
    j.delete([2, 11])
    pj = str(tmp_path / "jax.npz")
    j.save(pj)
    h = pt.Corpus.load(pj, device=CPU)
    assert (h.storage, h.n, h.dim) == (storage, c.shape[0], 300)
    with np.load(pj) as z:
        raw = z["data_u16"] if storage == "bf16" else z["data"]
        np.testing.assert_array_equal(_stored(h), raw)
        if storage != "bf16":
            np.testing.assert_array_equal(h._scales.numpy(), z["scales"])
    got = h.topk(q, 6, "cosine")
    assert not np.isin(got[0], [2, 11]).any()
    _same(got, j.topk(q, 6, "cosine"))
    # The port saves, JAX loads, and the files hold the same arrays.
    pp = str(tmp_path / "port.npz")
    h.save(pp)
    with np.load(pj) as a, np.load(pp) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
    _same(pmt.Corpus.load(pp).topk(q, 6, "dot"), h.topk(q, 6, "dot"))
    _same(pt.Corpus.load(pp, device=CPU).topk(q, 6, "dot"),
          h.topk(q, 6, "dot"))
