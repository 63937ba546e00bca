"""The Arrow surface of the PyTorch port against the JAX package: the
buffer layer (``interop.buffers``) and its ``pyarrow`` adapter, the native
List packer, ``topk_arrow`` / ``matmul_arrow`` and ``from_arrow``.

Extraction must equal the JAX package's ``extract_matrix`` bit for bit, in
values and dtype, with the same error types and messages, through the
native packer and through the plain one (each package's packer taken out
in turn).  Top-k results are held to the JAX package's (Pallas in
interpret mode) by ``assert_topk_equivalent``, matmul panels by the
tolerance of ``tests/test_torch_api.py`` (1e-5 in f32, 1e-12 in f64), and
the results' Arrow types must be equal.  The port runs on
``device="cpu"``, through the plain versions of its kernels.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import polars_matmul_tpu as pmt
import polars_matmul_tpu_torch as pt
from polars_matmul_tpu import interop as jinterop
from polars_matmul_tpu.config import SearchConfig as JConfig
from polars_matmul_tpu.interop import arrow as jarrow
from polars_matmul_tpu_torch import SearchConfig, interop
from polars_matmul_tpu_torch.interop import arrow as parrow
from polars_matmul_tpu_torch.interop import buffers as B
from polars_matmul_tpu_torch.interop import native
from polars_matmul_tpu_torch.kernels import fused_topk as F

from conftest import assert_topk_equivalent

torch.set_num_threads(2)

CPU = "cpu"
METRICS = ["cosine", "dot", "euclidean"]


def _fsl(a: np.ndarray) -> pa.Array:
    return pa.FixedSizeListArray.from_arrays(pa.array(a.reshape(-1)),
                                             a.shape[1])


def _rows(n, dim, seed=0):
    return np.random.default_rng(seed).standard_normal((n, dim))


def _child_offset_fsl():
    """A FixedSizeList over a child that has its own offset (3) and a
    parent sliced at 1."""
    child = pa.array(np.arange(30, dtype=np.float32)).slice(3, 24)
    return pa.FixedSizeListArray.from_arrays(child, 4).slice(1, 4)


def _listed(n, dim, off, nulls, dtype=np.float32, seed=1):
    """A List<dtype> over raw buffers: rows before ``off`` are empty lists,
    the column is sliced at ``off``; ``nulls`` are null rows (bits
    ``off + i``, most not at bit 0 of a byte)."""
    vals = _rows(n, dim, seed).astype(dtype)
    offsets = np.zeros(off + n + 1, np.int32)
    offsets[off:] = np.arange(n + 1, dtype=np.int32) * dim
    valid = np.ones(off + n, bool)
    valid[off + np.asarray(nulls, int)] = False
    bitmap = np.packbits(valid, bitorder="little")
    arr = pa.Array.from_buffers(
        pa.list_(pa.from_numpy_dtype(dtype)), off + n,
        [pa.py_buffer(bitmap), pa.py_buffer(offsets)],
        children=[pa.array(vals.reshape(-1))]).slice(off, n)
    col = B.EmbeddingColumn(length=n, values=vals.reshape(-1),
                            offsets=offsets, offset=off, validity=bitmap)
    return arr, col, vals


def _nested(rows, t=None):
    return pa.array(rows, type=t)


# Each case: a pyarrow column (and the dtype extraction is asked for).
EXTRACT_CASES = {
    # tests/test_interop.py TestExtract
    "fsl_f64": lambda: _fsl(np.arange(12, dtype=np.float64).reshape(4, 3)),
    "fsl_f32": lambda: _fsl(np.arange(6, dtype=np.float32).reshape(2, 3)),
    "list_regular": lambda: _nested([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]),
    "list_null_row": lambda: _nested([[1.0, 2.0], None, [5.0, 6.0]]),
    "fsl_null_row": lambda: _nested([[1.0, 2.0], None, [5.0, 6.0]],
                                    pa.list_(pa.float64(), 2)),
    "ragged": lambda: _nested([[1.0, 2.0], [3.0]]),
    "empty": lambda: pa.array([], type=pa.list_(pa.float64())),
    "f16": lambda: _fsl(np.array([[1.0, 2.0], [3.0, 4.0]], np.float16)),
    "int64": lambda: _nested([[1, 2], [3, 4]]),
    "fsl_sliced": lambda: _fsl(np.arange(12, dtype=np.float64).reshape(
        4, 3)).slice(1, 2),
    "chunked": lambda: pa.chunked_array([_nested([[1.0, 2.0]]),
                                         _nested([[3.0, 4.0]])]),
    # TestArrowAdversarial
    "fsl_f32_sliced": lambda: _fsl(np.arange(24, dtype=np.float32).reshape(
        8, 3)).slice(2, 4),
    "list_sliced": lambda: _nested(
        [[3.0 * i, 3.0 * i + 1, 3.0 * i + 2] for i in range(8)],
        pa.list_(pa.float64())).slice(3, 4),
    "chunked_3": lambda: pa.chunked_array([
        _nested([[1.0, 2.0], [3.0, 4.0]]), _nested([[5.0, 6.0]])]),
    "inner_nulls": lambda: _nested([[1.0, None], [None, 4.0]]),
    "ragged_long": lambda: _nested([[1.0, 2.0], [3.0, 4.0, 5.0]]),
    "large_list": lambda: _nested([[1.0, 2.0], [3.0, 4.0]],
                                  pa.large_list(pa.float64())),
    "int32": lambda: _nested([[1, 2], [3, 4]], pa.list_(pa.int32())),
    "f16_fsl": lambda: _fsl(np.asarray([1.5, -2.25, 0.5, 4.0],
                                       np.float16).reshape(2, 2)),
    "null_first": lambda: _nested([None, [1.0, 2.0]]),
    "sliced_null_query": lambda: _nested(
        [None, [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]).slice(1, 3),
    # Offsets the buffer layer handles itself.
    "fsl_child_offset": _child_offset_fsl,
    "fsl_inner_null_sliced": lambda: _nested(
        [[1.0, 2.0], [None, 4.0], [5.0, 6.0], [7.0, None]],
        pa.list_(pa.float32(), 2)).slice(1, 3),
    "list_null_bits": lambda: _listed(40, 3, 5, [2, 9, 30])[0],
    "list_null_at_bit0": lambda: _listed(20, 3, 5, [3, 11])[0],
    "large_list_sliced_nulls": lambda: _nested(
        [[1.0, 2.0], None, [3.0, 4.0], [5.0, None], None],
        pa.large_list(pa.float32())).slice(2, 3),
    "list_sliced_child": lambda: pa.ListArray.from_arrays(
        pa.array([0, 2, 4, 6], pa.int32()),
        pa.array(np.arange(10, dtype=np.float32)).slice(4, 6)),
    "int_with_nulls": lambda: _nested([[1, 2], None, [5, None]],
                                      pa.list_(pa.int16())),
    "uint8_fsl": lambda: _fsl(np.arange(6, dtype=np.uint8).reshape(3, 2)),
    "zero_dim_list": lambda: _nested([[], []], pa.list_(pa.float32())),
    "zero_dim_fsl": lambda: pa.array([[], []], pa.list_(pa.float32(), 0)),
    "bool_values": lambda: _nested([[True, False]]),
    "string_values": lambda: _nested([["a", "b"]]),
    "not_a_list": lambda: pa.array([1.0, 2.0]),
    "all_null_list": lambda: _nested([None, None], pa.list_(pa.float64())),
}
# Cases also run with an explicit compute dtype.
DTYPED = ["fsl_f64", "fsl_f32", "list_null_bits", "inner_nulls", "f16",
          "int32", "list_sliced", "fsl_child_offset"]


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except ValueError as e:
        return ("raised", type(e).__name__, str(e))
    return ("ok", out.dtype, out.shape, out.tobytes())


@pytest.fixture(params=["native", "plain"])
def route(request, monkeypatch):
    """Each package's List packer: the native one, or (taken out) the
    plain NumPy loop."""
    if request.param == "plain":
        monkeypatch.setattr(jarrow, "native_pack_list", lambda *a: None)
        monkeypatch.setattr(B, "native_pack_list", lambda *a: None)
    return request.param


@pytest.mark.parametrize("case,dtype", [(c, None) for c in EXTRACT_CASES]
                         + [(c, d) for c in DTYPED
                            for d in (np.float32, np.float64)])
def test_extract_matches_jax(case, dtype, route):
    arr = EXTRACT_CASES[case]()
    args = (arr,) if dtype is None else (arr, dtype)
    got = _outcome(interop.extract_matrix, *args)
    assert got == _outcome(jinterop.extract_matrix, *args)
    # The buffer layer itself, on the adapter's buffers.
    col = parrow.to_column(arr)
    assert _outcome(B.extract_matrix, col, dtype) == got


@pytest.mark.parametrize("case", ["fsl_f64", "fsl_f32", "fsl_f32_sliced",
                                  "fsl_child_offset", "list_regular",
                                  "list_sliced", "f16", "list_null_row"])
def test_zero_copy_exactly_where_jax_is(case):
    """A FixedSizeList of the target dtype with no nulls (or a List of
    equal rows) is a read-only view of Arrow's values buffer, in both
    packages; every other column is a fresh writeable array."""
    arr = EXTRACT_CASES[case]()
    got, want = interop.extract_matrix(arr), jinterop.extract_matrix(arr)
    child = arr.values.buffers()[1]
    base = np.frombuffer(child, np.uint8)
    assert np.shares_memory(got, base) == np.shares_memory(want, base)
    assert got.flags.writeable == want.flags.writeable
    assert got.flags.c_contiguous


@pytest.mark.parametrize("case", ["list_regular", "chunked", "fsl_f32",
                                  "empty", "large_list", "not_a_list"])
def test_column_dim_and_embedding_column_match_jax(case):
    arr = EXTRACT_CASES[case]()
    got = _outcome(parrow.extract_embedding_column, arr)
    assert got == _outcome(jarrow.extract_embedding_column, arr)
    if case != "not_a_list":
        assert interop.column_dim(arr) == jinterop.column_dim(arr)


@pytest.mark.parametrize("left,right", [
    (pa.float32(), pa.float32()), (pa.float32(), pa.float64()),
    (pa.float64(), pa.float32()), (pa.float64(), pa.float64()),
    (pa.float16(), pa.float32()), (pa.float16(), pa.float16()),
    (pa.int32(), pa.float32()), (pa.float32(), pa.int8())])
def test_promote_pair_matches_jax(left, right):
    assert interop.promote_pair(left, right) == \
        jinterop.promote_pair(left, right)
    # The buffer layer's rule, on Arrow names and NumPy dtypes alike.
    assert B.promote_pair(str(left), right.to_pandas_dtype()) == \
        jinterop.promote_pair(left, right)


def _outputs(pkg):
    idx = np.array([[1, 0], [2, 1]], dtype=np.uint32)
    scr = np.array([[0.9, 0.5], [0.8, 0.2]])
    m32 = np.array([[1.0, 2.0], [3.0, 4.0]], dtype=np.float32)
    return [pkg.topk_to_arrow(idx, scr), pkg.matrix_to_arrow(m32),
            pkg.matrix_to_arrow(m32.astype(np.float64)),
            pkg.empty_topk_arrow(), pkg.empty_matrix_arrow(np.float32),
            pkg.empty_matrix_arrow(np.float64),
            pkg.topk_to_arrow(idx[:, :0], scr[:, :0])]


def test_output_assembly_matches_jax():
    for got, want in zip(_outputs(interop), _outputs(jinterop)):
        assert got.type == want.type
        assert got.equals(want)
        assert got.to_pylist() == want.to_pylist()


def test_native_packer_builds_and_matches_its_plain_version():
    assert interop.native_available() and jinterop.native_available()
    assert "library" in native.build_info
    rng = np.random.default_rng(5)
    for dtype in (np.float32, np.float64):
        for n, dim, head in ((1, 1, 0), (37, 5, 3), (300, 16, 7), (64, 3, 8)):
            values = rng.standard_normal(n * dim + 11).astype(dtype)
            offsets = np.arange(n + 1, dtype=np.int64) * dim + 4
            bitmap = rng.integers(0, 256, (head + n + 7) // 8 + 1,
                                  dtype=np.uint8)
            for validity in (None, bitmap):
                got = native.native_pack_list(values, offsets, validity,
                                              head, n, dim)
                want = B.pack_list_plain(values, offsets, validity, head, n,
                                         dim)
                assert got.dtype == want.dtype
                assert got.tobytes() == want.tobytes()


def test_packer_errors_match_jax():
    values = np.arange(5, dtype=np.float64)
    offsets = np.array([0, 2, 5], dtype=np.int64)
    with pytest.raises(ValueError) as mine:
        native.native_pack_list(values, offsets, None, 0, 2, 2)
    with pytest.raises(ValueError) as theirs:
        jinterop.native.native_pack_list(values, offsets, None, 2, 2)
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(B.ExtractError, match="row 1 has 3 dimensional"):
        B.pack_list_plain(values, offsets, None, 0, 2, 2)
    with pytest.raises(ValueError, match="outside the values buffer"):
        native.native_pack_list(values, offsets + 1, None, 0, 2, 2)
    # A null row's length is never read.
    ok = native.native_pack_list(values, offsets, np.array([1], np.uint8),
                                 0, 2, 2)
    np.testing.assert_array_equal(ok, [[0.0, 1.0], [0.0, 0.0]])


@pytest.mark.parametrize("off,nulls", [(3, [1, 4, 12, 77]), (8, [7, 8]),
                                       (0, [])])
def test_hand_made_buffers(off, nulls):
    """What the card's smoke run feeds the buffer layer, small: one values
    buffer as a FixedSizeList (a view) and as a List with int32 offsets
    ``i * dim`` after ``off`` empty rows, sliced at ``off``, some rows
    null (packed by the native packer)."""
    arr, col, vals = _listed(100, 6, off, nulls)
    before = dict(B.packs)
    got = B.extract_matrix(col)
    want = vals.copy()
    want[nulls] = 0.0
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == jinterop.extract_matrix(arr).tobytes()
    assert B.packs["native"] == before["native"] + (1 if nulls else 0)
    fsl = B.matrix_column(vals)
    view = B.extract_matrix(fsl)
    assert np.shares_memory(view, vals) and view.tobytes() == vals.tobytes()
    assert B.extract_embedding(col).dtype == np.float32
    assert B.column_dim(col) == B.column_dim(fsl) == 6
    # A boolean column's nulls exclude, at any bit offset.
    data = np.packbits(np.arange(off + 20) % 3 != 0, bitorder="little")
    valid = np.packbits(np.arange(off + 20) % 5 != 0, bitorder="little")
    mask = B.mask_values(B.BoolColumn(data, 20, off, valid))
    np.testing.assert_array_equal(
        mask, (np.arange(off, off + 20) % 3 != 0)
        & (np.arange(off, off + 20) % 5 != 0))


def test_all_set_counts_every_bit():
    rng = np.random.default_rng(3)
    bitmap = np.full(20, 0xFF, np.uint8)
    for offset, length in ((0, 0), (0, 160), (3, 100), (7, 1), (9, 150)):
        assert B.all_set(bitmap, offset, length)
        if length:
            b = bitmap.copy()
            bit = offset + int(rng.integers(length))
            b[bit >> 3] &= ~np.uint8(1 << (bit & 7))
            assert not B.all_set(b, offset, length)
            assert B.all_set(b, offset, bit - offset)


# ---------------------------------------------------------------------------
# topk_arrow / matmul_arrow / from_arrow against the JAX package.
# ---------------------------------------------------------------------------


def _pairs(a):
    rows = a.to_pylist()
    idx = np.array([[e["index"] for e in r] for r in rows], np.int64)
    scr = np.array([[e["score"] for e in r] for r in rows], np.float64)
    return idx, scr


def _same(got, want, **tol):
    assert got.type == want.type
    assert len(got) == len(want)
    assert_topk_equivalent(*_pairs(got), *_pairs(want),
                           **(tol or dict(rtol=1e-4, atol=5e-4)))


@pytest.fixture(scope="module")
def qc():
    rng = np.random.default_rng(21)
    return (rng.standard_normal((9, 24)).astype(np.float32),
            rng.standard_normal((300, 24)).astype(np.float32))


@pytest.mark.parametrize("metric", METRICS)
def test_topk_arrow_columns_match_jax(qc, metric):
    q, c = qc
    arr_q = _nested([None, *q.tolist()], pa.list_(pa.float32())).slice(1)
    _same(pt.topk_arrow(arr_q, _fsl(c), 7, metric, device=CPU),
          pmt.topk_arrow(arr_q, _fsl(c), 7, metric), rtol=2e-5, atol=8e-6)


def test_topk_arrow_mask_nulls_and_f64_match_jax(qc):
    q, c = qc
    mask = pa.array([None if i % 7 == 0 else i % 3 != 0
                     for i in range(c.shape[0])])
    got = pt.topk_arrow(_fsl(q), _fsl(c.astype(np.float64)), 5, "dot",
                        mask=mask, device=CPU)
    want = pmt.topk_arrow(_fsl(q), _fsl(c.astype(np.float64)), 5, "dot",
                          mask=mask)
    _same(got, want, rtol=1e-12, atol=1e-12)
    idx, _ = _pairs(got)
    assert not np.isin(idx, [i for i in range(c.shape[0])
                             if i % 7 == 0 or i % 3 == 0]).any()
    # tests/test_interop.py's cases, both packages.
    q2 = pa.array([[1.0, 0.0], [0.0, 1.0]])
    c2 = pa.array([[1.0, 0.0], [0.9, 0.1], [0.0, 1.0], [0.1, 0.9]])
    m2 = pa.array([False, True, None, True])
    assert (pt.topk_arrow(q2, c2, k=1, metric="dot", mask=m2,
                          device=CPU).to_pylist()
            == pmt.topk_arrow(q2, c2, k=1, metric="dot", mask=m2).to_pylist())
    q3 = _nested([None, [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]).slice(1, 3)
    c3 = _nested([[1.0, 0.0], [0.0, 1.0], None, [0.5, 0.5]])
    _same(pt.topk_arrow(q3, c3, 2, "dot", device=CPU),
          pmt.topk_arrow(q3, c3, 2, "dot"))


def test_arrow_contract_matches_jax(qc):
    """Empty left, empty corpus, the k clamp, k=0, bad metric, probe
    without a ClusteredCorpus, config with a handle: same results and
    errors."""
    q, c = qc
    empty = pa.array([], type=pa.list_(pa.float32()))
    h = pt.Corpus(c, device=CPU)
    j = pmt.Corpus(c)

    def outcome(fn):
        try:
            out = fn()
        except (ValueError, TypeError) as e:
            return type(e).__name__, str(e)
        return out.type, out.to_pylist()

    calls = [
        lambda m, hh, **kw: m.topk_arrow(empty, _fsl(c), 3, **kw),
        lambda m, hh, **kw: m.topk_arrow(_fsl(q), empty, 3, **kw),
        lambda m, hh, **kw: m.topk_arrow(empty, hh, 3),
        lambda m, hh, **kw: m.topk_arrow(_fsl(q), _fsl(c), 3, "manhattan",
                                         **kw),
        lambda m, hh, **kw: m.topk_arrow(_fsl(q), _fsl(c), 3, probe=0.5,
                                         **kw),
        lambda m, hh, **kw: m.topk_arrow(_fsl(q), hh, 3,
                                         config=m.SearchConfig()),
        lambda m, hh, **kw: m.topk_arrow(_fsl(q[:2]), _fsl(c[:4]), 0, **kw),
        lambda m, hh, **kw: m.topk_arrow(_fsl(q[:2, :5]), _fsl(c[:4]), 2,
                                         **kw),
        lambda m, hh, **kw: m.matmul_arrow(empty, _fsl(c), **kw),
        lambda m, hh, **kw: m.matmul_arrow(empty, empty, **kw),
        lambda m, hh, **kw: m.matmul_arrow(_fsl(q), empty, **kw),
        lambda m, hh, **kw: m.matmul_arrow(empty, hh),
        lambda m, hh, **kw: m.matmul_arrow(_fsl(q), hh,
                                           config=m.SearchConfig()),
        lambda m, hh, **kw: m.matmul_arrow(_fsl(q[:, :3]), _fsl(c), **kw),
    ]
    for call in calls:
        assert outcome(lambda: call(pt, h, device=CPU)) == \
            outcome(lambda: call(pmt, j))
    got = pt.topk_arrow(_fsl(q[:2]), _fsl(c[:4]), 50, device=CPU)
    _same(got, pmt.topk_arrow(_fsl(q[:2]), _fsl(c[:4]), 50),
          rtol=2e-5, atol=8e-6)
    assert len(got.to_pylist()[0]) == 4
    with pytest.raises(ValueError, match="device= has no effect"):
        pt.topk_arrow(_fsl(q), h, 3, device=CPU)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_topk_arrow_corpus_handle_matches_jax(qc, storage):
    q, c = qc
    col = _listed(300, 24, 2, [5, 77])[0]
    rows = jinterop.extract_matrix(col)
    h = pt.Corpus.from_arrow(col, storage=storage, device=CPU)
    j = pmt.Corpus.from_arrow(col, storage=storage)
    assert (h.n, h.dim, h.dtype) == (j.n, j.dim, j.dtype)
    mask = np.arange(300) % 4 != 1
    for metric in ("cosine", "euclidean"):
        _same(pt.topk_arrow(_fsl(q), h, 6, metric, mask=mask),
              pmt.topk_arrow(_fsl(q), j, 6, metric, mask=mask))
    # The handle holds the packed rows (null rows as zeros).
    np.testing.assert_array_equal(h._dense_device().numpy(),
                                  np.asarray(j._dense_device()))
    assert not rows[5].any()


def test_matmul_arrow_matches_jax(qc):
    q, c = qc
    for dtype, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        got = pt.matmul_arrow(_fsl(q), _fsl(c.astype(dtype)), device=CPU)
        want = pmt.matmul_arrow(_fsl(q), _fsl(c.astype(dtype)))
        assert got.type == want.type
        np.testing.assert_allclose(np.asarray(got.flatten()),
                                   np.asarray(want.flatten()),
                                   rtol=tol, atol=tol)
    flat = pt.matmul_arrow(_fsl(q), _fsl(c), flatten=True, device=CPU)
    want = pmt.matmul_arrow(_fsl(q), _fsl(c), flatten=True)
    assert flat.type == want.type and len(flat) == q.shape[0] * c.shape[0]
    np.testing.assert_allclose(np.asarray(flat), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    h = pt.Corpus.from_arrow(_fsl(c), storage="bf16", device=CPU)
    j = pmt.Corpus.from_arrow(_fsl(c), storage="bf16")
    got, want = pt.matmul_arrow(_fsl(q), h), pmt.matmul_arrow(_fsl(q), j)
    assert got.type == want.type
    np.testing.assert_allclose(np.asarray(got.flatten()),
                               np.asarray(want.flatten()),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    """A JAX ClusteredCorpus built from an Arrow column, saved, and the
    port's handle on the same file (both then search one layout)."""
    rng = np.random.default_rng(7)
    centres = rng.standard_normal((12, 16)) * 4
    c = (centres[rng.integers(0, 12, 1500)]
         + rng.standard_normal((1500, 16))).astype(np.float32)
    q = (centres[rng.integers(0, 12, 12)]
         + rng.standard_normal((12, 16))).astype(np.float32)
    j = pmt.ClusteredCorpus.from_arrow(
        _fsl(c), clusters=8, config=JConfig(block_q=8, block_n=128))
    path = str(tmp_path_factory.mktemp("arrow") / "clustered.npz")
    j.save(path)
    h = pt.ClusteredCorpus.load(
        path, config=SearchConfig(block_q=8, block_n=128), device=CPU)
    return q, c, j, h


@pytest.mark.parametrize("probe", [0.25, None])
def test_topk_arrow_clustered_probe_matches_jax(clustered, probe):
    q, c, j, h = clustered
    mask = pa.array(np.arange(c.shape[0]) % 5 != 0)
    before = F.launches["fused_topk_plain"]
    _same(pt.topk_arrow(_fsl(q), h, 5, "dot", mask=mask, probe=probe),
          pmt.topk_arrow(_fsl(q), j, 5, "dot", mask=mask, probe=probe))
    assert F.launches["fused_topk_plain"] > before
    got = pt.matmul_arrow(_fsl(q), h)
    want = pmt.matmul_arrow(_fsl(q), j)
    assert got.type == want.type
    np.testing.assert_allclose(np.asarray(got.flatten()),
                               np.asarray(want.flatten()),
                               rtol=1e-5, atol=1e-5)


def test_from_arrow_without_pyarrow_and_never_writing_arrow_memory():
    """``from_arrow`` of a column's buffers equals that of the ``pa``
    array; the handle's first write copies the zero-copy view first, and
    the Arrow buffer stays bit for bit as it was."""
    c = _rows(120, 10, 4).astype(np.float32)
    arr = _fsl(c)
    held = pt.Corpus.from_arrow(arr, device=CPU)
    from_buffers = pt.Corpus.from_arrow(parrow.to_column(arr), device=CPU)
    assert held._device.data_ptr() == from_buffers._device.data_ptr()
    held.update([0, 3], np.ones((2, 10), np.float32))
    assert np.asarray(arr.values).tobytes() == c.tobytes()
    assert float(held._device[3, 0]) == 1.0

    class Series:   # a polars Series's one method used here
        def to_arrow(self):
            return arr

    j = pmt.Corpus.from_arrow(arr)
    q = _rows(4, 10, 5).astype(np.float32)
    for handle in (pt.Corpus.from_arrow(Series(), device=CPU),
                   pt.Corpus.from_arrow(B.matrix_column(c), device=CPU)):
        _same(pt.topk_arrow(_fsl(q), handle, 4), pmt.topk_arrow(_fsl(q), j, 4))
    with pytest.raises(B.ExtractError, match="Empty series"):
        pt.Corpus.from_arrow(pa.array([], pa.list_(pa.float32())))
    with pytest.raises(B.ExtractError, match="Expected a List"):
        pt.ClusteredCorpus.from_arrow(pa.array([1.0]))


def test_clustered_from_arrow_equals_its_constructor_and_jax_exhaustive():
    rng = np.random.default_rng(8)
    c = rng.standard_normal((600, 12)).astype(np.float32)
    col = _listed(600, 12, 1, [4, 300])[0]
    rows = jinterop.extract_matrix(col)
    h = pt.ClusteredCorpus.from_arrow(col, clusters=4, seed=3, device=CPU)
    again = pt.ClusteredCorpus(rows, clusters=4, seed=3, device=CPU)
    np.testing.assert_array_equal(h.layout.perm, again.layout.perm)
    assert torch.equal(h._base, again._base)
    q = c[:5]
    j = pmt.Corpus(rows)
    _same(pt.topk_arrow(_fsl(q), h, 6, "euclidean"),
          pmt.topk_arrow(_fsl(q), j, 6, "euclidean"))
