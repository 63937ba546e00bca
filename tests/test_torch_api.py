"""The public surface of the PyTorch port against the JAX package: topk,
matmul and Corpus on the same NumPy inputs (the port on device="cpu",
through the plain versions of its kernels), the input contract, the
JAX .npz format, and import hygiene."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import polars_matmul_tpu as pmt
import polars_matmul_tpu_torch as pt
from polars_matmul_tpu_torch.kernels import fused_topk as F

from conftest import assert_topk_equivalent

torch.set_num_threads(2)

METRICS = ["cosine", "dot", "euclidean"]
CPU = "cpu"
_FIX = os.path.join(os.path.dirname(__file__), "fixtures",
                    "reference_topk.npz")


def _data(m=9, n=257, dim=48, seed=21, dtype=np.float32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, dim)).astype(dtype),
            r.standard_normal((n, dim)).astype(dtype))


def _same(got, want, **tol):
    (gi, gs), (wi, ws) = got, want
    assert gi.dtype == wi.dtype == np.uint32
    assert gs.dtype == ws.dtype == np.float64
    assert_topk_equivalent(gi.astype(np.int64), gs, wi.astype(np.int64), ws,
                           **tol)


@pytest.mark.parametrize("metric", METRICS)
def test_topk_matches_jax(metric):
    q, c = _data()
    _same(pt.topk(q, c, 10, metric, device=CPU), pmt.topk(q, c, 10, metric))


def test_topk_with_mask_matches_jax():
    q, c = _data()
    mask = np.arange(c.shape[0]) % 4 == 1
    _same(pt.topk(q, c, 7, "dot", mask=mask, device=CPU),
          pmt.topk(q, c, 7, "dot", mask=mask))


def test_topk_f64_path_matches_jax_and_skips_the_kernels():
    q, c = _data(dtype=np.float64)
    before = dict(F.launches)
    got = pt.topk(q.astype(np.float32), c, 6, "euclidean", device=CPU)
    assert F.launches == before   # both-f32 rule: f64 through the reference
    _same(got, pmt.topk(q.astype(np.float32), c, 6, "euclidean"),
          rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-12)])
def test_matmul_matches_jax(dtype, tol):
    q, c = _data(dtype=dtype)
    got = pt.matmul(q, c, device=CPU)
    want = pmt.matmul(q, c)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case,metric,k", [
    ("cosine_f32", "cosine", 7),
    ("dot_f32", "dot", 5),
    ("euclidean_f32", "euclidean", 5),
    ("cosine_f64", "cosine", 4),
])
def test_pinned_reference_outputs(case, metric, k):
    fx = np.load(_FIX)
    idx, scores = pt.topk(fx[f"{case}_q"], fx[f"{case}_c"], k, metric,
                          device=CPU)
    assert_topk_equivalent(idx.astype(np.int64), scores,
                           fx[f"{case}_idx"].astype(np.int64),
                           fx[f"{case}_scores"])


@pytest.mark.parametrize("metric", METRICS)
def test_corpus_topk_matches_jax(metric):
    q, c = _data(seed=22)
    mask = np.arange(c.shape[0]) % 3 != 0
    h = pt.Corpus(c, device=CPU)
    j = pmt.Corpus(c)
    _same(h.topk(q, 12, metric), j.topk(q, 12, metric))
    _same(h.topk(q, 12, metric, mask=mask), j.topk(q, 12, metric, mask=mask))


def test_corpus_half_queries_and_matmul_match_jax():
    q, c = _data(seed=23)
    h = pt.Corpus(c, device=CPU)
    j = pmt.Corpus(c)
    q16 = q.astype(np.float16)
    _same(h.topk(q16, 5, "dot"), j.topk(q16, 5, "dot"))
    _same(h.topk(torch.from_numpy(q16), 5, "dot"), j.topk(q16, 5, "dot"))
    np.testing.assert_allclose(h.matmul(q), j.matmul(q), rtol=1e-5,
                               atol=1e-5)
    assert h.matmul(q[:0]).shape == (0, c.shape[0])


def test_corpus_f64_and_reference_paths_match_jax():
    q, c = _data(seed=24)
    h = pt.Corpus(c.astype(np.float64), device=CPU)
    j = pmt.Corpus(c.astype(np.float64))
    _same(h.topk(q, 5, "cosine"), j.topk(q, 5, "cosine"),
          rtol=1e-12, atol=1e-12)
    cfg = pt.SearchConfig(use_pallas=False)
    _same(pt.Corpus(c, config=cfg, device=CPU).topk(q, 5, "dot"),
          pmt.Corpus(c).topk(q, 5, "dot"))


def test_corpus_load_of_a_jax_saved_file(tmp_path):
    q, c = _data(seed=25)
    j = pmt.Corpus(c)
    j.delete([3, 17, 40])
    p = str(tmp_path / "c.npz")
    j.save(p)
    h = pt.Corpus.load(p, device=CPU)
    assert (h.n, h.dim) == c.shape
    for metric in ("cosine", "euclidean"):
        got = h.topk(q, 8, metric)
        assert not np.isin(got[0], [3, 17, 40]).any()
        _same(got, j.topk(q, 8, metric))


def test_corpus_save_is_read_by_jax(tmp_path):
    q, c = _data(seed=26)
    p = str(tmp_path / "c.npz")
    pt.Corpus(c, device=CPU).save(p)
    _same(pt.Corpus.load(p, device=CPU).topk(q, 4, "dot"),
          pmt.Corpus.load(p).topk(q, 4, "dot"))


def _err(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_error_strings_match_jax():
    q, c = _data()
    cases = [
        ((q, c[:, :5], 3), {}),
        ((q, c[:0], 3), {}),
        ((q[:, :0], c[:, :0], 3), {}),
        ((q[0], c, 3), {}),
        ((q, c, 3, "hamming"), {}),
        ((q, c, 3), {"mask": np.ones(5, bool)}),
    ]
    for args, kw in cases:
        assert (_err(pt.topk, *args, device=CPU, **kw)
                == _err(pmt.topk, *args, **kw))
    assert (_err(pt.matmul, q, c[:, :5], device=CPU)
            == _err(pmt.matmul, q, c[:, :5]))
    h, j = pt.Corpus(c, device=CPU), pmt.Corpus(c)
    assert _err(h.topk, q[:, :5], 3) == _err(j.topk, q[:, :5], 3)
    assert _err(pt.Corpus, c[:0]) == _err(pmt.Corpus, c[:0])
    assert _err(pt.Corpus, c, storage="f16") == _err(pmt.Corpus, c,
                                                     storage="f16")
    with pytest.raises(ValueError) as got:
        pt.SearchConfig(selection="fastest")
    with pytest.raises(ValueError) as want:
        pmt.SearchConfig(selection="fastest")
    assert str(got.value) == str(want.value)


def test_k_clamp_k0_and_empty_queries_match_jax():
    q, c = _data(n=6)
    for args in ((q, c, 50), (q, c, 0), (q[:0], c, 3)):
        got = pt.topk(*args, device=CPU)
        want = pmt.topk(*args)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
    assert pt.topk(q, c, 50, device=CPU)[0].shape == (q.shape[0], 6)
    assert pt.matmul(q[:0], c, device=CPU).shape == (0, 6)
    h = pt.Corpus(c, device=CPU)
    assert h.topk(q, 0)[0].shape == (q.shape[0], 0)
    assert h.topk(q[:0], 3)[0].shape == (0, 0)


def test_unported_corpus_features_raise():
    q, c = _data()
    # The storage tiers are ported: they build and answer like the JAX
    # package.
    for storage in ("bf16", "int8", "int4"):
        h = pt.Corpus(c, device=CPU, storage=storage)
        assert h.storage == storage and h.dtype == np.float32
        _same(h.topk(q, 4, "dot"), pmt.Corpus(c, storage=storage).topk(
            q, 4, "dot"))
    # mesh= is ported: the same arguments build a sharded handle that
    # answers like the JAX package's on its mesh (tests/test_torch_parallel.py
    # holds the rest); only device= with a mesh is refused.
    import jax

    meshes = (pt.make_mesh(1, 8, devices=["cpu"] * 8),
              pmt.make_mesh(1, 8, devices=jax.devices()[:8]))
    for kw in ({}, {"storage": "int8"}, {"capacity": 1000}):
        h, j = (lib.Corpus(c, mesh=mesh, **kw)
                for lib, mesh in zip((pt, pmt), meshes))
        assert repr(h) == repr(j)
        _same(h.topk(q, 4, "dot"), j.topk(q, 4, "dot"),
              **({"rtol": 2e-4, "atol": 2e-4} if kw else {}))
    with pytest.raises(ValueError, match="device= and mesh= are exclusive"):
        pt.Corpus(c, device=CPU, mesh=meshes[0])
    # Capacity and the mutations are ported: they answer like the JAX
    # package.
    h = pt.Corpus(c, device=CPU, capacity=1000)
    j = pmt.Corpus(c, capacity=1000)
    for x in (h, j):
        assert x.add(c[:2]) == c.shape[0] + 2
        x.update([0], c[1:2])
        assert x.delete([1]) == 1
    _same(h.topk(q, 4, "dot"), j.topk(q, 4, "dot"))


def test_search_config_fields_match_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(pt.SearchConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(pmt.SearchConfig)]
    assert ours == theirs
    cfg = pt.SearchConfig().with_updates(precision="highest")
    old = pt.default_config()
    try:
        pt.set_default_config(cfg)
        assert pt.default_config() is cfg
    finally:
        pt.set_default_config(old)


def test_numpy_inputs_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, c = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.topk(q, c, 3, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.topk(q, c, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Corpus(c)


def test_torch_inputs_keep_their_device():
    q, c = _data()
    idx, _ = pt.topk(torch.from_numpy(q), torch.from_numpy(c), 3)
    assert idx.shape == (q.shape[0], 3)
    h = pt.Corpus(torch.from_numpy(c))
    assert h.device == torch.device("cpu")


def test_import_pulls_in_neither_jax_nor_pyarrow():
    code = ("import polars_matmul_tpu_torch, sys; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert 'pyarrow' not in sys.modules, 'pyarrow'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
