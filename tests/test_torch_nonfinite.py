"""The port's one rule for non-finite values, on the CPU (plain versions).

(a) A corpus row holding a NaN or +-inf is never returned; slots past the
    rows left carry the sentinels (-inf similarity / +inf distance, index
    INT32_MAX).
(b) A query row holding a NaN or +-inf gets (NaN, INT32_MAX) in every slot.
(c) No selection takes a NaN score.
(d) Masked rows behave as before, bad or not.
(e) Clustering leaves bad rows out of its fit and places them in cluster
    0; a probed request equals the exhaustive scan over the tiles it
    visits.
(f) ``add`` / ``update`` keep the rule, and ``prepared_from_jax`` applies
    it to the rows it carries.

Every tier (f32 with the bf16x3 and highest cores, bf16, int8, int4, and
float64 on the reference path), metric, k regime (insertion at k <= 16,
appending above) and path (a device handle, a clustered handle probed, a
two-position CPU mesh) runs the contract test.  Finite rows and queries
are held to the JAX package on the same NumPy inputs, and where the JAX
package meets the rule (an f32 +inf row, the indices of an f32 NaN query)
the port equals it.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polars_matmul_tpu as pmt
import polars_matmul_tpu_torch as pt
from polars_matmul_tpu_torch import SearchConfig
from polars_matmul_tpu_torch.api.arrow_ops import topk_buffers
from polars_matmul_tpu_torch.interop import buffers as B
from polars_matmul_tpu_torch.kernels import fused_topk as F
from polars_matmul_tpu_torch.kernels import storage as S
from polars_matmul_tpu_torch.ops import cluster as C
from polars_matmul_tpu_torch.ops import reference as R

from conftest import assert_topk_equivalent

JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")

torch.set_num_threads(2)

CPU = "cpu"
INT32_MAX = 2 ** 31 - 1
METRICS = ["cosine", "dot", "euclidean"]
TIERS = ["f32", "bf16", "int8", "int4"]
# (storage, kernel core): f32 runs the config's core, f64 the reference.
CORES = [("f32", "bf16x3"), ("f32", "highest"), ("bf16", "bf16c"),
         ("int8", "int8c"), ("int4", "int4c"), ("f64", None)]
M, N, DIM = 4, 600, 16
# Each case: {row: value} written into one feature of corpus rows, and
# {row: value} into one feature of query rows; "masked" also masks its
# bad rows and a fifth of the others.
CASES = {
    "nan_row": ({5: np.nan}, {}),
    "pinf_row": ({7: np.inf}, {}),
    "ninf_row": ({9: -np.inf}, {}),
    "nan_query": ({}, {1: np.nan}),
    "pinf_query": ({}, {2: np.inf}),
    "masked": ({5: np.nan, 7: np.inf, 9: -np.inf}, {}),
}
PATHS = ["dense", "probed", "mesh"]


def _case(name, m=M, n=N, dim=DIM, seed=0):
    """(q, c, mask or None, bad corpus rows, bad query rows)."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((m, dim)).astype(np.float32)
    c = r.standard_normal((n, dim)).astype(np.float32)
    rows, queries = CASES[name]
    for i, x in rows.items():
        c[i, (3 * i) % dim] = x
    for i, x in queries.items():
        q[i, (5 * i) % dim] = x
    mask = None
    if name == "masked":
        mask = r.random(n) > 0.2
        mask[list(rows)] = False
    return q, c, mask, sorted(rows), sorted(queries)


def _config(core):
    return SearchConfig() if core is None else SearchConfig(precision=core)


def _source(c, storage):
    return c.astype(np.float64) if storage == "f64" else c


def _tier(storage):
    return "f32" if storage == "f64" else storage


@functools.lru_cache(maxsize=None)
def _handle(storage, core, case, path):
    _, c, _, _, _ = _case(case)
    cfg, src, tier = _config(core), _source(c, storage), _tier(storage)
    if path == "probed":
        return pt.ClusteredCorpus(src, clusters=4, storage=tier, config=cfg,
                                  device=CPU)
    if path == "mesh":
        return pt.Corpus(src, storage=tier, config=cfg,
                         mesh=pt.make_mesh(1, 2, devices=[CPU] * 2))
    return pt.Corpus(src, storage=tier, config=cfg, device=CPU)


@functools.lru_cache(maxsize=None)
def _clean_handle(storage, core, case):
    """A device handle of the case's corpus with its bad rows zeroed."""
    _, c, _, bad_r, _ = _case(case)
    c = c.copy()
    c[bad_r] = 0.0
    return pt.Corpus(_source(c, storage), storage=_tier(storage),
                     config=_config(core), device=CPU)


def _worst(metric):
    return np.inf if metric == "euclidean" else -np.inf


def _same(got, want, exact=False):
    """Top-k results equal: NaN slots to NaN slots, indices exact there
    and at the sentinels; elsewhere scores within tolerance and indices
    equal up to tied scores (``exact``: every bit)."""
    (gi, gv), (wi, wv) = got, want
    assert gi.shape == wi.shape
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))
    if exact:
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
        return
    assert_topk_equivalent(gi.astype(np.int64), gv, wi.astype(np.int64), wv)
    odd = np.isnan(wv) | np.isinf(wv)
    np.testing.assert_array_equal(gi[odd], wi[odd])


def _void(i, v, bad_q):
    i, v = i.copy(), v.copy()
    i[bad_q], v[bad_q] = INT32_MAX, np.nan
    return i, v


def _check_rule(i, v, metric, k, bad_q, excluded, live, exhaustive=True):
    """(a)-(d) on one result."""
    assert i.shape == v.shape == (M, k)
    for r in bad_q:
        assert (i[r] == INT32_MAX).all() and np.isnan(v[r]).all()
    good = [r for r in range(M) if r not in bad_q]
    gi, gv = i[good], v[good]
    assert not np.isnan(gv).any()
    assert not np.isin(gi, excluded).any()
    sent = gi == INT32_MAX
    assert (gv[sent] == _worst(metric)).all()
    assert np.isfinite(gv[~sent]).all()
    if exhaustive:
        real = min(k, live)
        assert not sent[:, :real].any() and sent[:, real:].all()


def _visited_rows(h, q, k, metric, probe):
    """The original ids of the rows in the tiles a probed request of the
    clustered handle ``h`` visits (one query block)."""
    p, _ = C.resolve_probe(probe, h.layout.n_tiles)
    tm = F.probe_block_rows(q.shape[0], h.dim, h.config, k)
    assert q.shape[0] <= tm
    tiles = C.probe_tiles(torch.from_numpy(q), h.centroids,
                          h._tile_cluster_dev, p=p, tm=tm, metric_v=metric)
    tn = h.layout.tn
    pos = (tiles[0].numpy()[:, None] * tn + np.arange(tn)).reshape(-1)
    ids = h.layout.perm[pos]
    return ids[ids >= 0]


def _contract_params():
    out = []
    for storage, core in CORES:
        for path in PATHS:
            if storage == "f64" and path == "probed":
                continue   # a clustered handle rounds its rows to f32
            for case in CASES:
                out.append(pytest.param(storage, core, case, path,
                                        id=f"{storage}-{core}-{case}-{path}"))
    return out


@pytest.mark.parametrize("k", [3, 40])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("storage, core, case, path", _contract_params())
def test_contract(storage, core, case, path, metric, k):
    q, c, mask, bad_r, bad_q = _case(case)
    q = _source(q, storage)
    h = _handle(storage, core, case, path)
    excluded = sorted(set(bad_r) | set(np.flatnonzero(
        ~mask) if mask is not None else ()))
    i, v = h.topk(q, k, metric, mask=mask)
    _check_rule(i, v, metric, k, bad_q, excluded, N - len(excluded))
    # The same result as the handle of the cleaned corpus, its bad rows
    # masked, for the cleaned queries, then voided.
    qc = q.copy()
    qc[bad_q] = 0.0
    keep = np.ones(N, bool) if mask is None else mask.copy()
    keep[bad_r] = False
    clean = _clean_handle(storage, core, case).topk(qc, k, metric, mask=keep)
    want = _void(*clean, bad_q)
    _same((i, v), want, exact=path == "dense")
    if path == "dense" and storage in ("f32", "f64"):
        _same(pt.topk(q, _source(c, storage), k, metric, mask=mask,
                      config=_config(core), device=CPU), want, exact=True)
    if path == "probed":
        # Bad rows sit in cluster 0, the centroids are finite, and a probe
        # of half the tiles equals the exhaustive scan over those tiles.
        assert torch.isfinite(h.centroids).all()
        pos = h.layout.row_pos[bad_r] // h.layout.tn
        assert (h.layout.tile_cluster[pos] == 0).all()
        ip, vp = h.topk(q, k, metric, mask=mask, probe=0.5)
        seen = np.zeros(N, bool)
        seen[_visited_rows(h, q, k, metric, 0.5)] = True
        live = int((seen & keep).sum())
        _check_rule(ip, vp, metric, k, bad_q, excluded, live)
        _same((ip, vp), h.topk(q, k, metric, mask=seen & (
            mask if mask is not None else True)), exact=True)


def _bad_data(seed=0, n=40):
    """(3, 16) queries against an (n, 16) corpus from ``seed``; row 5
    holds a NaN, row 7 a +inf, row 9 a -inf, query 1 a NaN."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((3, 16)).astype(np.float32)
    c = r.standard_normal((n, 16)).astype(np.float32)
    c[5, 2], c[7, 4], c[9, 6] = np.nan, np.inf, -np.inf
    q[1, 3] = np.nan
    return q, c


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("storage", TIERS)
def test_finite_rows_and_queries_match_jax(storage, metric):
    """The port on bad data, its good queries against the JAX package
    given the bad rows masked and the bad query zeroed."""
    q, c = _bad_data()
    good = np.ones(40, bool)
    good[[5, 7, 9]] = False
    i, v = pt.Corpus(c, storage=storage, device=CPU).topk(q, 40, metric)
    qz = q.copy()
    qz[1] = 0.0
    ji, jv = pmt.Corpus(c, storage=storage).topk(qz, 40, metric, mask=good)
    rows = [0, 2]
    _same((i[rows], v[rows]), (ji[rows], jv[rows]))
    assert (i[1] == INT32_MAX).all() and np.isnan(v[1]).all()


@pytest.mark.parametrize("metric", METRICS)
def test_f32_inf_row_and_nan_query_equal_jax(metric):
    """Where the JAX package's f32 fused path meets the rule, the port
    equals it: a +inf row dropped (the last slot a sentinel), a NaN
    query's slots all index 2147483647.  (The JAX package gives every
    other query of the NaN query's batch the same slots: only the NaN
    query's are compared.)"""
    q, c = _bad_data()
    c[5, 2], c[9, 6] = 0.5, -0.5   # only the +inf row stays bad
    rows = [0, 2]
    got = pt.topk(q[rows], c, 40, metric, device=CPU)
    _same(got, pmt.topk(q[rows], c, 40, metric))
    assert (got[0][:, -1] == INT32_MAX).all()
    got = pt.topk(q, c, 40, metric, device=CPU)
    np.testing.assert_array_equal(got[0][1], pmt.topk(q, c, 40, metric)[0][1])
    assert (got[0][1] == INT32_MAX).all() and np.isnan(got[1][1]).all()


SURFACES = ["topk", "f32", "bf16", "int8", "int4", "buffers"]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("surface", SURFACES)
def test_masked_nan_rows_are_excluded(surface, metric):
    """The JAX package's ``test_masked_nan_rows_are_excluded`` through
    ``topk``, ``Corpus.topk`` at every tier and ``topk_buffers``: masked
    rows holding NaN / inf never reach a result, nor poison it."""
    rng = np.random.default_rng(61)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    c = rng.standard_normal((40, 8)).astype(np.float32)
    c[5] = np.nan
    c[11] = np.inf
    mask = np.ones(40, bool)
    mask[[5, 11]] = False
    if surface == "topk":
        i, v = pt.topk(q, c, 3, metric, mask=mask, device=CPU)
    elif surface == "buffers":
        out = topk_buffers(B.matrix_column(q), B.matrix_column(c), 3,
                           metric, mask=mask, device=CPU)
        i, v = out.index.reshape(4, 3), out.score.reshape(4, 3)
    else:
        h = pt.Corpus(c, storage=surface, device=CPU)
        i, v = h.topk(q, 3, metric, mask=mask)
    assert np.isfinite(v).all(), metric
    assert not np.isin(i, [5, 11]).any(), metric
    ji, jv = pmt.topk(q, c, 3, metric, mask=mask)
    if surface in ("topk", "f32", "buffers"):
        _same((i, v), (ji, jv))


def test_arrow_buffers_keep_nan_and_pack_nulls_as_zero():
    """The Arrow path needs no rule of its own: a null row packs as 0.0 (a
    zero row, scored 0 under cosine) and a NaN value passes through to
    the rule."""
    r = np.random.default_rng(3)
    n, dim = 30, 8
    vals = r.standard_normal((n, dim)).astype(np.float32)
    vals[4, 1] = np.nan
    valid = np.ones(n, bool)
    valid[6] = False
    col = B.EmbeddingColumn(length=n, values=vals.reshape(-1),
                            offsets=np.arange(n + 1, dtype=np.int32) * dim,
                            validity=np.packbits(valid, bitorder="little"))
    q = r.standard_normal((3, dim)).astype(np.float32)
    out = topk_buffers(B.matrix_column(q), col, n, "cosine", device=CPU)
    i, v = out.index.reshape(3, n), out.score.reshape(3, n)
    assert not np.isin(i, [4]).any()
    assert (i[:, -1] == INT32_MAX).all() and (v[:, -1] == -np.inf).all()
    np.testing.assert_array_equal(v[i == 6], 0.0)


def _quantizer_rows(dim, seed=4):
    """Rows with NaN, +-inf and out-of-range entries beside them, a zero
    row, and finite rows."""
    r = np.random.default_rng(seed)
    c = (r.standard_normal((12, dim)) * 3).astype(np.float32)
    c[1, 0], c[1, 1], c[1, 2] = np.nan, 300.0, -300.0
    c[2, 5], c[2, 6] = np.inf, 200.0
    c[3, dim - 1] = -np.inf
    c[4] = 0.0
    c[5] = np.nan
    c[6, :3] = [np.inf, -np.inf, 9.0]
    c[7, 0], c[7, 1] = -8.5, np.nan
    return c, [1, 2, 3, 5, 6, 7]


@pytest.mark.parametrize("dim", [48, 4200])
def test_four_quantizers_agree_on_bad_rows(dim):
    """The torch and host int8 / int4 quantizers: codes 0 and a NaN scale
    for every bad row, bit for bit alike; finite rows bit-identical to the
    JAX package's quantizers."""
    c, bad = _quantizer_rows(dim)
    ok = [i for i in range(c.shape[0]) if i not in bad]
    ck, dpp, _ = F.feature_geometry(dim)
    t8, ts8 = F.quantize_int8(torch.from_numpy(c))
    h8, hs8 = S._quantize_rows_np(c)
    t4, ts4 = F.quantize_int4(torch.from_numpy(c), ck)
    h4, hs4 = S._quantize_rows_int4_np(c, ck, dpp)
    for tc, ts, hc, hs in ((t8, ts8, h8, hs8), (t4, ts4, h4, hs4)):
        np.testing.assert_array_equal(tc.numpy(), hc)
        np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                      hs.view(np.int32))
        assert (hc[bad] == 0).all() and np.isnan(hs[bad]).all()
        assert np.isfinite(hs[ok]).all()
    j8, js8 = JF.quantize_int8(jnp.asarray(c[ok]))
    j4, js4 = JF.quantize_int4(jnp.asarray(c[ok]), ck)
    np.testing.assert_array_equal(h8[ok], np.asarray(j8))
    np.testing.assert_array_equal(hs8[ok], np.asarray(js8))
    np.testing.assert_array_equal(h4[ok], np.asarray(j4))
    np.testing.assert_array_equal(hs4[ok], np.asarray(js4))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("core", F.CORES)
def test_prepared_forms_mark_bad_rows_and_keep_finite_ones(core, metric):
    """A bad row's bias is NaN in every prepared form (codes: zero codes,
    a (NaN, NaN) scale | bias column), and each finite row's forms are
    those of the corpus without the bad rows, bit for bit."""
    c, bad = _quantizer_rows(40)
    ok = [i for i in range(c.shape[0]) if i not in bad]
    src = torch.from_numpy(c)
    if core == "bf16c":
        src = src.to(torch.bfloat16)
    cp, cbp = F.prepare_corpus(src, metric, precision=core)
    ocp, ocbp = F.prepare_corpus(src[ok], metric, precision=core)
    bias = cbp[-1] if cbp.ndim == 2 else cbp
    assert torch.isnan(bias[bad]).all()
    if cbp.ndim == 2:
        assert torch.isnan(cbp[:, bad]).all() and (cp[bad] == 0).all()
    bits = (lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32) if t.dtype == torch.float32 else t)
    assert torch.equal(bits(cp[ok]), bits(ocp))
    assert torch.equal(bits(cbp[..., ok]), bits(ocbp))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("core", F.CORES)
def test_plain_versions_never_select_nan(core, metric):
    """Kernel A's plain versions (dense, split, listed) and kernel B's on
    a corpus with bad rows and a bad query: no bad row, NaN taken as -inf
    (the carry's rule), INT32_MAX on every -inf slot."""
    q, c, _, bad_r, _ = _case("masked", n=300)
    q[1, 2] = np.nan
    qp = F.prepare_queries(torch.from_numpy(q), metric, core)
    src = torch.from_numpy(c)
    cp, cbp = F.prepare_corpus(src.to(torch.bfloat16) if core == "bf16c"
                               else src, metric, precision=core)
    for k in (3, 40):
        v, i = F.fused_topk_plain(qp, cp, cbp, None, k, core)
        pv, pi = F.fused_topk_partial_plain(qp, cp, cbp, None, k, core, 3, 2)
        lv, li = F.fused_topk_plain(
            qp, cp, cbp, None, k, core,
            torch.tensor([[0, 1, 2]], dtype=torch.int32), 128, 4)
        mv, mi = F.topk_merge_plain(pv, pi, k)
        for vals, idx in ((v, i), (pv, pi), (lv, li), (mv, mi)):
            assert not torch.isnan(vals).any()
            assert not torch.isin(idx, torch.tensor(bad_r)).any()
            assert torch.equal(vals == -np.inf, idx == INT32_MAX)
        # The bad query selects nothing, the others every good row first.
        assert (i[1] == INT32_MAX).all()
        assert torch.equal(v, mv) and torch.equal(i, mi)
        assert torch.equal(v, lv) and torch.equal(i, li)


def test_selections_take_nan_as_the_worst_value():
    """The reference's selections: NaN after every real value (as -inf for
    similarity, +inf for distance), INT32_MAX on every worst slot; kernel
    B's plain version the same on NaN-bearing lists."""
    s = torch.tensor([[1.0, np.nan, 3.0, -np.inf, 2.0, np.nan]])
    v, i = R.topk_from_scores(s, 6, True)
    assert i.tolist() == [[2, 4, 0, INT32_MAX, INT32_MAX, INT32_MAX]]
    assert v[0, 3:].eq(-np.inf).all()
    v, i = R.topk_from_scores(s, 6, False)
    assert i.tolist() == [[3, 0, 4, 2, INT32_MAX, INT32_MAX]]
    assert v[0, 4:].eq(np.inf).all()
    idx = torch.arange(6, dtype=torch.int32)[None, :]
    v, i = R.topk_two_key(s, idx, 4, True)
    assert i.tolist() == [[2, 4, 0, INT32_MAX]]
    v, i = F.topk_merge_plain(s.reshape(1, 2, 3), idx.reshape(1, 2, 3), 4)
    assert i.tolist() == [[2, 4, 0, INT32_MAX]] and v[0, 3] == -np.inf


def test_finalize_sentinels_and_nan():
    """Euclidean finish: a -inf sentinel is +inf whatever |q|^2 is (an
    overflowing one included), a NaN value stays NaN."""
    q = torch.tensor([[1.0, 2.0], [3e38, 3e38]])
    vals = torch.tensor([[4.0, -np.inf], [-np.inf, np.nan]])
    out = F._finalize(q, vals, F.Metric.EUCLIDEAN)
    assert out[0, 0] == 1.0 and out[0, 1] == np.inf
    assert out[1, 0] == np.inf and torch.isnan(out[1, 1])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", F.CORES)
def test_prepared_from_jax_applies_the_rule(precision, metric):
    """JAX-prepared forms carried across: a row that carries non-finite
    values (every float form; codes under a +inf scale, but for cosine,
    whose column the JAX package leaves finite) is never returned."""
    q, c = _bad_data(n=300)
    c[5, 2], c[9, 6], q[1, 3] = 0.5, -0.5, 0.5   # only row 7 stays bad
    c = np.ascontiguousarray(np.tile(c, (1, 8)))   # dim 128
    q = np.ascontiguousarray(np.tile(q, (1, 8)))
    jcp, jcbp = JF.prepare_corpus(jnp.asarray(c), metric, tn=128,
                                  precision=precision)
    jcp = np.asarray(jcp)
    if str(jcp.dtype) == "bfloat16":
        jcp = jcp.view(np.uint16)
    cp, cbp = F.prepared_from_jax(jcp, np.asarray(jcbp), n=300, dim=128)
    marks = precision not in ("int8c", "int4c") or metric != "cosine"
    if marks:
        bias = cbp[-1] if cbp.ndim == 2 else cbp
        assert torch.isnan(bias[7])
        if cbp.ndim == 2:
            assert (cp[7] == 0).all()
    v, i = F.fused_topk_prepared(torch.from_numpy(q), cp, cbp, 300, metric,
                                 precision=precision)
    assert (7 in i.numpy()) != marks
    assert not torch.isnan(v).any()


@pytest.mark.parametrize("storage", TIERS)
def test_add_and_update_keep_the_rule(storage):
    """``add`` of a bad row makes it bad; ``update`` back to finite values
    makes it selectable with the forms a fresh build gives; ``update`` of
    a finite row to a bad one makes it bad.  In place, within capacity, on
    the prepared forms cached before."""
    q, c, _, _, _ = _case("nan_row", n=60)
    c[5, 15] = 0.25
    h = pt.Corpus(c[:50], storage=storage, capacity=64, device=CPU)
    for metric in METRICS:
        h.topk(q, 3, metric)
    extra = c[50:].copy()
    extra[2, 1] = np.nan
    extra[4, 0] = -np.inf
    h.add(extra)
    for metric in METRICS:
        i, _ = h.topk(q, 60, metric)
        assert not np.isin(i, [52, 54]).any()
    h.update([52, 10], np.stack([c[52], c[10]]))
    h.update([20], np.full((1, DIM), np.inf, np.float32))
    want = c.copy()
    want[54, 0] = -np.inf
    want[20] = np.inf
    fresh = pt.Corpus(want, storage=storage, device=CPU)
    for metric in METRICS:
        i, v = h.topk(q, 60, metric)
        assert 52 in i and not np.isin(i, [20, 54]).any()
        _same((i, v), fresh.topk(q, 60, metric), exact=True)
        cp, cbp = h._prepared_for(F.Metric.parse(metric))
        fcp, fcbp = fresh._prepared_for(F.Metric.parse(metric))
        if cp.dtype == torch.bfloat16:
            cp, fcp = cp.view(torch.int16), fcp.view(torch.int16)
        assert torch.equal(cp[:60], fcp)
        np.testing.assert_array_equal(cbp[..., :60].numpy().view(np.int32),
                                      fcbp.numpy().view(np.int32))


@pytest.mark.parametrize("storage", TIERS)
def test_clustered_mutation_and_rebuild_keep_the_rule(storage):
    """``ClusteredCorpus.add`` / ``update`` / ``rebuild`` with bad rows:
    each bad row in cluster 0, none returned, and a probe of half the
    tiles equal to the exhaustive scan over the tiles it visits."""
    q, c, _, _, _ = _case("masked", n=N)
    q[0] = c[11]   # row 7 takes these values below: a top match
    h = pt.ClusteredCorpus(c[:500], clusters=4, storage=storage,
                           reserve_tiles=1, device=CPU)
    extra = c[500:].copy()
    extra[3, 2] = np.nan
    h.add(extra)
    h.update([11, 7], np.stack([np.full(DIM, -np.inf, np.float32), c[11]]))
    bad = [5, 9, 11, 503]

    def check():
        assert torch.isfinite(h.centroids).all()
        tiles = h.layout.row_pos[bad] // h.layout.tn
        assert (h.layout.tile_cluster[tiles] == 0).all()
        for metric in METRICS:
            i, v = h.topk(q, 40, metric)
            _check_rule(i, v, metric, 40, [], bad, N - len(bad))
            ip, vp = h.topk(q, 40, metric, probe=0.5)
            seen = np.zeros(N, bool)
            seen[_visited_rows(h, q, 40, metric, 0.5)] = True
            _same((ip, vp), h.topk(q, 40, metric, mask=seen), exact=True)
            assert 7 in i

    check()
    h.rebuild(clusters=4)
    check()


def test_kmeans_leaves_bad_rows_out():
    """k-means fits the finite rows alone (the same draws and centroids
    as without the bad rows) and assigns each bad row to cluster 0; with
    no finite row, one zero centroid."""
    r = np.random.default_rng(8)
    x = r.standard_normal((200, 6)).astype(np.float32)
    x[[3, 50, 199], [0, 1, 2]] = [np.nan, np.inf, -np.inf]
    ok = np.isfinite(x).all(axis=1)
    cent, a = C.kmeans(torch.from_numpy(x), 5, seed=2)
    want, wa = C.kmeans(torch.from_numpy(x[ok]), 5, seed=2)
    assert torch.equal(cent, want)
    assert torch.equal(a[torch.from_numpy(ok)], wa)
    assert (a[torch.from_numpy(~ok)] == 0).all()
    for assign in (C.assign_rows(x, cent),
                   C.assign_rows_native(*S._quantize_rows_np(x), cent,
                                        "int8", 6)):
        assert (assign[~ok] == 0).all()
    cent, a = C.kmeans(torch.full((4, 3), np.nan), 3)
    assert torch.equal(cent, torch.zeros(1, 3)) and (a == 0).all()
