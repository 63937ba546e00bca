"""The port's ``.pmm`` namespace closures beside the JAX package's.

polars is not installed here, so ``tests/test_namespace_stub.py``'s fake
``polars`` (Arrow-backed: a Series wraps an Arrow array, ``map_batches``
records the closure, its flags and its declared dtype) is put in
``sys.modules`` for each test, and both packages' ``api.namespace`` are
imported against it afresh.  The closures then run on the same columns:
declared dtypes, elementwise flags, ``flatten=``, resident handles and
the ``Expr``-as-corpus ``TypeError`` must be the JAX package's, and the
results equal them (top-k by ``assert_topk_equivalent``, matmul panels
within 1e-5).  The port's closures run on ``device="cpu"`` (a handle on
its own device).  Every module and attribute the injection adds is taken
away after each test, so no other file sees the fake.
"""

import importlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

import polars_matmul_tpu as pmt
import polars_matmul_tpu.api as japi
import polars_matmul_tpu_torch as pt
import polars_matmul_tpu_torch.api as papi
from polars_matmul_tpu_torch.api.arrow_ops import matmul_arrow, topk_arrow

from conftest import assert_topk_equivalent
from test_namespace_stub import _make_fake_polars

CPU = "cpu"
NAMES = {"jax": "polars_matmul_tpu.api.namespace",
         "port": "polars_matmul_tpu_torch.api.namespace"}


def _vec(a: np.ndarray) -> pa.Array:
    return pa.FixedSizeListArray.from_arrays(pa.array(a.reshape(-1)),
                                             a.shape[1])


@pytest.fixture()
def ns(monkeypatch):
    """(JAX namespace module, port namespace module, fake polars),
    imported in that order against the fake."""
    fake = _make_fake_polars()
    monkeypatch.setitem(sys.modules, "polars", fake)
    mods = {}
    for key, pkg in (("jax", japi), ("port", papi)):
        monkeypatch.delitem(sys.modules, NAMES[key], raising=False)
        # Absent before: monkeypatch deletes the attribute again after.
        monkeypatch.setattr(pkg, "namespace", None, raising=False)
        mods[key] = importlib.import_module(NAMES[key])
    yield mods["jax"], mods["port"], fake
    # The modules are bound to the fake: never leave them importable.
    for name in NAMES.values():
        sys.modules.pop(name, None)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    c = rng.standard_normal((20, 8)).astype(np.float32)
    return q, c


def _rows(arr):
    rows = arr.to_pylist()
    return (np.array([[e["index"] for e in r] for r in rows], np.int64),
            np.array([[e["score"] for e in r] for r in rows], np.float64))


def _same_topk(got, want):
    assert got.type == want.type
    assert_topk_equivalent(*_rows(got), *_rows(want))


def _closure(mod, fake, method, *args, **kw):
    expr = fake.Expr()
    out = getattr(mod.PmmNamespace(expr), method)(*args, **kw)
    assert out is expr
    return expr.calls[-1]


def test_both_register_and_the_later_import_wins(ns):
    jmod, pmod, fake = ns
    assert fake._registered["pmm"] is pmod.PmmNamespace
    assert pmod.PmmNamespace is not jmod.PmmNamespace
    # Imported the other way round, the JAX package's namespace wins.
    sys.modules.pop(NAMES["jax"])
    again = importlib.import_module(NAMES["jax"])
    assert fake._registered["pmm"] is again.PmmNamespace


def test_topk_closure_matches_jax(ns, data):
    jmod, pmod, fake = ns
    q, c = data
    assert pmod._TOPK_DTYPE == jmod._TOPK_DTYPE == fake.List(
        fake.Struct({"index": fake.UInt32, "score": fake.Float64}))
    corpus = fake.Series(_vec(c), "emb", fake.Array(fake.Float32, 8))
    for metric in ("cosine", "euclidean"):
        mine = _closure(pmod, fake, "topk", corpus, 3, metric, device=CPU)
        theirs = _closure(jmod, fake, "topk", corpus, 3, metric)
        for key in ("is_elementwise", "return_dtype"):
            assert mine[key] == theirs[key]
        assert mine["is_elementwise"] is True
        out = mine["fn"](fake.Series(_vec(q)))
        assert out.name == "topk"
        assert out.to_arrow().equals(
            topk_arrow(_vec(q), _vec(c), 3, metric, device=CPU))
        _same_topk(out.to_arrow(),
                   theirs["fn"](fake.Series(_vec(q))).to_arrow())


def test_corpus_as_expr_raises_as_jax(ns):
    jmod, pmod, fake = ns
    for method in ("topk", "matmul"):
        args = (fake.Expr(), 3) if method == "topk" else (fake.Expr(),)
        errors = []
        for mod in (pmod, jmod):
            with pytest.raises(TypeError) as e:
                getattr(mod.PmmNamespace(fake.Expr()), method)(*args)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
        assert errors[0].startswith("corpus must be a Polars Series")


def test_topk_closure_with_mask_and_handles(ns, data, tmp_path):
    jmod, pmod, fake = ns
    q, c = data
    mask = fake.Series(pa.array([None if i == 2 else i < 9
                                 for i in range(len(c))]))
    mine = _closure(pmod, fake, "topk", fake.Series(_vec(c)), 4,
                    "euclidean", mask=mask, device=CPU)
    theirs = _closure(jmod, fake, "topk", fake.Series(_vec(c)), 4,
                      "euclidean", mask=mask)
    got = mine["fn"](fake.Series(_vec(q))).to_arrow()
    _same_topk(got, theirs["fn"](fake.Series(_vec(q))).to_arrow())
    assert set(_rows(got)[0].ravel()) <= set(range(9)) - {2}

    # Resident handles ride the closure untouched (serving mode).
    h, j = pt.Corpus(c, device=CPU), pmt.Corpus(c)
    mine = _closure(pmod, fake, "topk", h, 3)
    got = mine["fn"](fake.Series(_vec(q))).to_arrow()
    assert got.equals(topk_arrow(_vec(q), h, 3, "cosine"))
    _same_topk(got, _closure(jmod, fake, "topk", j, 3)["fn"](
        fake.Series(_vec(q))).to_arrow())
    path = str(tmp_path / "clustered.npz")
    pmt.ClusteredCorpus(c, clusters=2).save(path)
    jc = pmt.ClusteredCorpus.load(path)
    hc = pt.ClusteredCorpus.load(path, device=CPU)
    mine = _closure(pmod, fake, "topk", hc, 3, "dot", probe=1)
    theirs = _closure(jmod, fake, "topk", jc, 3, "dot", probe=1)
    _same_topk(mine["fn"](fake.Series(_vec(q))).to_arrow(),
               theirs["fn"](fake.Series(_vec(q))).to_arrow())


def test_matmul_closure_dtypes_and_values_match_jax(ns, data):
    jmod, pmod, fake = ns
    q, c = data
    h, j = pt.Corpus(c, device=CPU), pmt.Corpus(c)
    c64 = c.astype(np.float64)
    cases = [
        (fake.Series(_vec(c), "emb", fake.Array(fake.Float32, 8)),) * 2,
        (fake.Series(_vec(c64), "emb", fake.Array(fake.Float64, 8)),) * 2,
        (fake.Series(_vec(c), "emb", None),) * 2,   # no inner: Float64
        (h, j),
    ]
    for mine_corpus, their_corpus in cases:
        kw = {} if mine_corpus is h else {"device": CPU}
        mine = _closure(pmod, fake, "matmul", mine_corpus, **kw)
        theirs = _closure(jmod, fake, "matmul", their_corpus)
        assert mine["is_elementwise"] is theirs["is_elementwise"] is True
        assert mine["return_dtype"] == theirs["return_dtype"]
        out = mine["fn"](fake.Series(_vec(q)))
        want = theirs["fn"](fake.Series(_vec(q)))
        assert out.cast_target == want.cast_target == mine["return_dtype"]
        assert out.to_arrow().type == want.to_arrow().type
        np.testing.assert_allclose(np.asarray(out.to_arrow().flatten()),
                                   np.asarray(want.to_arrow().flatten()),
                                   rtol=1e-5, atol=1e-5)
    assert _closure(pmod, fake, "matmul", h)["return_dtype"] == fake.Array(
        fake.Float32, 20)


def test_matmul_flatten_closure_matches_jax(ns, data):
    jmod, pmod, fake = ns
    q, c = data
    corpus = fake.Series(_vec(c), "emb", fake.Array(fake.Float32, 8))
    mine = _closure(pmod, fake, "matmul", corpus, flatten=True, device=CPU)
    theirs = _closure(jmod, fake, "matmul", corpus, flatten=True)
    assert mine["is_elementwise"] is theirs["is_elementwise"] is False
    assert mine["return_dtype"] == theirs["return_dtype"] == fake.Float32
    out = mine["fn"](fake.Series(_vec(q))).to_arrow()
    want = theirs["fn"](fake.Series(_vec(q))).to_arrow()
    assert len(out) == len(q) * len(c) and out.type == want.type
    assert out.equals(matmul_arrow(_vec(q), _vec(c), flatten=True,
                                   device=CPU))
    np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_import_registers_when_polars_imports(tmp_path):
    """``import polars_matmul_tpu_torch`` registers ``.pmm`` on whatever
    ``polars`` imports (the fake here), and still imports neither ``jax``
    nor ``pyarrow``."""
    fake_src = inspect.getsource(_make_fake_polars)
    (tmp_path / "polars.py").write_text(
        "import sys\nimport types\n\n" + fake_src
        + "\nsys.modules[__name__] = _make_fake_polars()\n")
    code = ("import sys, polars_matmul_tpu_torch as p; "
            "reg = sys.modules['polars']._registered; "
            "assert reg['pmm'] is p.PmmNamespace, reg; "
            "assert 'PmmNamespace' in p.__all__; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert 'pyarrow' not in sys.modules, 'pyarrow'")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(papi.__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), root]))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
