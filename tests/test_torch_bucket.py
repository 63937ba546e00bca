"""Kernel A's bucket selection (``selection="bucket"``, k <= 16): a step
model of its walk, its routing, and the port against the JAX package's
bucket selection.

Kernel A cannot run here.  The model below repeats the walk of
``csrc/fused_topk.cu``'s ``bucket_tile`` / ``bucket_flush`` in NumPy, one
query row at a time: each lane's cell (the best two (value, index) of the
row's scores in columns lane and 32 + lane of every tile that beat the
row's threshold, strict >), the threshold held for the window (the
carry's k-th value when it began), the pushes a cell makes counted before
any is made, the overflow of ``bucket_overflow(tm)`` entries a row that
ends the window when it cannot take a tile's pushes (then the tile is
filtered again against the raised threshold), the appends in lane order
(a tile's first column's pushes, then its second's), and the merge of the
cells and the overflow into the carry at a window's end and at the
split's end.  It must give ``fused_topk_partial_plain``'s split lists bit
for bit, at k = 1, 2, 5, 10 and 16 and both query tiles the bucket is
built at (overflows of 32 and 16 entries): on seeded random scores and
integer tie data, in one-tile splits and in splits whose windows end
mid-split, with zero query rows, masked rows and wholly masked splits,
corpus rows and queries holding NaN and +-inf, tile lists, and data that
puts three or more of a row's top-k in one class of one window (its
counters must show the overflow and the early window ends).

Then the routing (``bucket_built``, ``bucket_route``; ``check_selection``
is the JAX package's, unchanged), and the same seeded NumPy inputs through
the JAX package with ``SearchConfig(selection="bucket")`` (its Pallas
kernel in interpret mode, as its own tests run it) and through the port's
``fused_topk`` / ``fused_topk_prepared`` on the CPU with the same config,
dense and probed, cosine, dot and euclidean, held to
``assert_topk_equivalent``'s tolerance (rtol 2e-5, atol 8e-6: both sides
sum the three bf16 products in f32, in their own order).
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polars_matmul_tpu.config import SearchConfig as JConfig
from polars_matmul_tpu_torch import SearchConfig
from polars_matmul_tpu_torch.kernels import fused_topk as F

from conftest import assert_topk_equivalent

JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")

KS = (1, 2, 5, 10, 16)
TMS = (16, 32)
INT32_MAX = 2 ** 31 - 1
NEG_INF = np.float32(-np.inf)


# ---------------------------------------------------------------------------
# The step model.
# ---------------------------------------------------------------------------


def _merge(carry, entries, k):
    """The carry's top k of carry + entries by (value desc, index asc), as
    bucket_merge's sel_keys order them (-0.0 ties +0.0)."""
    both = [e for e in carry if e[0] > NEG_INF] + entries
    both.sort(key=lambda e: (-float(e[0]), e[1]))
    best = both[:k]
    return best + [(NEG_INF, INT32_MAX)] * (k - len(best))


def _put(take, s, idx, v1, i1, v2, i2):
    """bucket_put on the lanes where ``take``: returns the pushed-out
    (value, index) of each lane, -inf where the cell had room."""
    pv = np.full(32, NEG_INF, np.float32)
    pi = np.full(32, INT32_MAX, np.int64)
    a = take & (s > v1)
    b = take & ~a & (s > v2)
    c = take & ~a & ~b
    pv[a], pi[a] = v2[a], i2[a]
    v2[a], i2[a] = v1[a], i1[a]
    v1[a], i1[a] = s[a], idx[a]
    pv[b], pi[b] = v2[b], i2[b]
    v2[b], i2[b] = s[b], idx[b]
    pv[c], pi[c] = s[c], idx[c]
    return pv, pi


def bucket_row(row, k, cap):
    """One query row's split: ``row`` its raw scores (float32, a multiple
    of 64 of them, NaN kept), ``cap`` the overflow's entries.  Returns the
    carry (k (value, index) pairs), windows ended and overflow entries."""
    carry = [(NEG_INF, INT32_MAX)] * k
    v1 = np.full(32, NEG_INF, np.float32)
    v2 = v1.copy()
    i1 = np.full(32, INT32_MAX, np.int64)
    i2 = i1.copy()
    over, windows, appended = [], 0, 0
    lane = np.arange(32)

    def end_window():
        nonlocal carry, windows, over
        cells = [(v1[x], int(i1[x])) for x in lane if v1[x] > NEG_INF]
        cells += [(v2[x], int(i2[x])) for x in lane if v2[x] > NEG_INF]
        carry = _merge(carry, cells + over, k)
        v1[:], v2[:], i1[:], i2[:] = NEG_INF, NEG_INF, INT32_MAX, INT32_MAX
        over = []
        windows += 1

    for n0 in range(0, row.shape[0], 64):
        s0, s1 = row[n0:n0 + 32], row[n0 + 32:n0 + 64]
        with np.errstate(invalid="ignore"):
            thr = carry[k - 1][0]
            c0, c1 = s0 > thr, s1 > thr
            if not (c0 | c1).any():
                continue
            held = (v1 > NEG_INF).astype(int) + (v2 > NEG_INF)
            push = held + c0 + c1 - 2
            if (push > 0).any() and (len(over) + (push > 0).sum()
                                     + (push > 1).sum() > cap):
                end_window()
                thr = carry[k - 1][0]
                c0, c1 = s0 > thr, s1 > thr
            p0 = _put(c0, s0, n0 + lane, v1, i1, v2, i2)
            p1 = _put(c1, s1, n0 + 32 + lane, v1, i1, v2, i2)
        for pv, pi in (p0, p1):
            got = [(pv[x], int(pi[x])) for x in lane if pv[x] > NEG_INF]
            over += got
            appended += len(got)
        assert len(over) <= cap
    if (v1 > NEG_INF).any() or over:
        end_window()
    return carry, windows, appended


def bucket_partial(scores, k, splits, tps, tm):
    """The bucket walk of every split: (m, splits, k) values and indices
    (global), windows ended and overflow entries in all."""
    m = scores.shape[0]
    rows = tps * 64
    pad = np.full((m, splits * rows), NEG_INF, np.float32)
    pad[:, :scores.shape[1]] = scores
    cap = F.bucket_overflow(tm)
    v = np.empty((m, splits, k), np.float32)
    i = np.empty((m, splits, k), np.int32)
    windows = appended = 0
    for r in range(m):
        for s in range(splits):
            carry, w, a = bucket_row(pad[r, s * rows:(s + 1) * rows], k, cap)
            windows, appended = windows + w, appended + a
            v[r, s] = [e[0] for e in carry]
            i[r, s] = [e[1] + s * rows if e[1] != INT32_MAX else INT32_MAX
                       for e in carry]
    return v, i, windows, appended


# ---------------------------------------------------------------------------
# Operands and the model against the plain version.
# ---------------------------------------------------------------------------


def _raw_scores(qp, cp, cbp, mask, precision):
    """The epilogue's scores as kernel A holds them: NaN kept (its strict
    > drops it), masked and past-the-end rows -inf."""
    d = F._plain_scores(qp, cp, precision)
    if precision in F._QUANT:
        s = d * cbp[0] + cbp[1]
    else:
        s = d + cbp
    if mask is not None:
        s = torch.where(mask.to(torch.bool), s, torch.full_like(s, NEG_INF))
    return s.numpy()


def _operands(kind, m, n, dim, seed, precision):
    r = np.random.default_rng(seed)
    metric = "cosine" if kind in ("random", "nonfinite") else "dot"
    if metric == "dot":   # integer entries, every corpus row twinned
        q = r.integers(-2, 3, (m, dim)).astype(np.float32)
        c = r.integers(-2, 3, (n, dim)).astype(np.float32)
    else:
        q = r.standard_normal((m, dim)).astype(np.float32)
        c = r.standard_normal((n, dim)).astype(np.float32)
    if kind == "heavy":
        # Columns 0, 5, 32 and 37 of every tile (the classes of lanes 0
        # and 5) score highest: a row's top-k crowd one or two cells.
        q = np.abs(q)
        lanes = np.arange(n) % 64 % 32
        c[(lanes == 0) | (lanes == 5)] += 2.0
    if metric == "dot":
        c[n // 2:] = c[: n - n // 2]
    if kind == "zero":
        q[::2] = 0.0
    if kind == "nonfinite":
        c[3::41, 1] = np.nan
        c[5::41, 2] = np.inf
        c[7::41, 0] = -np.inf
        q[1, 0], q[3 % m, 1] = np.nan, np.inf
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    qp = F.prepare_queries(qt, metric, precision)
    cp, cbp = F.prepare_corpus(ct, metric, precision=precision)
    mask = None
    if kind == "masked":   # random rows, and the middle splits wholly
        keep = r.random(n) < 0.6
        keep[n // 3: 2 * n // 3] = False
        mask = F.pad_mask_row(torch.from_numpy(keep), n)
    return qp, cp, cbp, mask


def _check(kind, k, tm, splits, tps, n, precision="highest", m=3, dim=8,
           seed=None):
    qp, cp, cbp, mask = _operands(kind, m, n, dim,
                                  seed=k + tm + n if seed is None else seed,
                                  precision=precision)
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, mask, k,
                                                precision, splits, tps)
    v, i, windows, appended = bucket_partial(
        _raw_scores(qp, cp, cbp, mask, precision), k, splits, tps, tm)
    np.testing.assert_array_equal(v.view(np.int32),
                                  want_v.numpy().view(np.int32))
    np.testing.assert_array_equal(i, want_i.numpy())
    return windows, appended


@pytest.mark.parametrize("tm", TMS)
@pytest.mark.parametrize("k", KS)
def test_walk_equals_the_plain_version(k, tm):
    """Seeded random scores and integer tie data: splits of one tile (a
    window of one tile each), of 3 and of 17 (windows ending mid-split)."""
    for kind, precision in (("random", "highest"), ("ties", "bf16x3")):
        _check(kind, k, tm, splits=30, tps=1, n=1900, precision=precision)
        _check(kind, k, tm, splits=10, tps=3, n=1900, precision=precision)
        windows, _ = _check(kind, k, tm, splits=2, tps=17, n=2100,
                            precision=precision)
        assert windows > 2 * 3   # more than one a (row, split)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["zero", "masked", "nonfinite"])
def test_walk_on_zero_rows_masks_and_nonfinite_values(kind, k):
    """All-tied zero query rows, masked rows and wholly masked splits,
    corpus rows and queries holding NaN and +-inf (a NaN score never
    passes; a query's NaN row fills nothing)."""
    for tm, precision in ((16, "highest"), (32, "bf16x3"), (16, "int8c")):
        _check(kind, k, tm, splits=4, tps=6, n=1400, precision=precision,
               m=6)


@pytest.mark.parametrize("k", (3, 10, 16))
@pytest.mark.parametrize("tm", TMS)
def test_three_of_a_rows_topk_in_one_class_fill_the_overflow(tm, k):
    """Data that puts a row's whole top-k in one or two classes: the
    cells push out, the overflow fills and windows end early, and the
    lists stay the plain version's."""
    windows, appended = _check("heavy", k, tm, splits=2, tps=20, n=2500,
                               precision="bf16x3", m=4)
    assert appended > F.bucket_overflow(tm)
    assert windows > 2 * 4 * 2


def test_walk_with_no_query_rows():
    qp, cp, cbp, mask = _operands("random", 0, 300, 8, 1, "highest")
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, mask, 5,
                                                "highest", 5, 1)
    v, i, windows, appended = bucket_partial(
        _raw_scores(qp, cp, cbp, mask, "highest"), 5, 5, 1, 16)
    assert v.shape == tuple(want_v.shape) == (0, 5, 5)
    assert windows == appended == 0


@pytest.mark.parametrize("k", (1, 10, 16))
def test_walk_on_tile_lists(k):
    """A list's rows in list order (its last id past the corpus), the
    splits cutting them, indices mapped back to the corpus."""
    n, tn = 1500, 128
    qp, cp, cbp, mask = _operands("ties", 4, n, 8, k, "bf16x3")
    tiles = torch.tensor([[0, 2, 3, 7, 11, 12]], dtype=torch.int32)
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, mask, k,
                                                "bf16x3", 3, 4, tiles, tn, 4)
    gid, cp_b, cb_b, _ = F._listed(cp, cbp, None, tiles[0], tn, "bf16x3")
    v, i, _, _ = bucket_partial(_raw_scores(qp, cp_b, cb_b, None, "bf16x3"),
                                k, 3, 4, 16)
    g = gid.numpy()
    i = np.where(i == INT32_MAX, i, g[np.minimum(i, g.size - 1)])
    np.testing.assert_array_equal(v.view(np.int32),
                                  want_v.numpy().view(np.int32))
    np.testing.assert_array_equal(i, want_i.numpy())


def test_overflow_fits_the_merge_lists():
    """A row's overflow is its share of its warp's 64 merge-list entries,
    and bucket_merge reads it one entry a lane."""
    for tm in TMS:
        rows_a_warp = tm // 8
        assert F.bucket_overflow(tm) * rows_a_warp == 64
        assert F.bucket_overflow(tm) <= 32


# ---------------------------------------------------------------------------
# Routing.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", F.CORES)
def test_bucket_built_where_its_cells_fit(precision):
    """k <= 16 at query tile 16, and at 32 on the mma.sync ring (the f32
    walk spilled there); never at 64 (both walks spilled, and the
    warpgroup consumer's accumulators leave no room)."""
    top = 16 if precision == "highest" else 32
    for k in range(1, 40):
        for tm in (16, 32, 64):
            assert F.bucket_built(tm, precision, k) == (k <= 16
                                                        and tm <= top)


def test_bucket_route_takes_the_config():
    for sel in ("bucket", "auto", "insert", "extract", "stack", "gstack",
                "gpop"):
        for k, tm, listed in ((1, 16, False), (10, 32, True),
                              (16, 16, True), (100, 64, False)):
            for precision in F.CORES:
                want = sel == "bucket"
                assert F.bucket_route(sel, k, tm, listed, precision) == want


def test_check_selection_is_the_jax_envelope():
    """An explicit "bucket" above k = 128 raises the JAX package's error;
    at k <= 128 it passes (above 16 kernel A keeps its own selection)."""
    for k in (1, 16, 17, 128):
        F.check_selection("bucket", k, 8, False, 8)
    with pytest.raises(ValueError, match="supports k <= 128"):
        F.check_selection("bucket", 129, 8, False, 8)
    with pytest.raises(ValueError, match="supports k <= 128"):
        JF._resolve_selection("bucket", 129, 8, False, 8, 128, 1)


def test_cpu_launch_is_the_plain_version():
    """On the CPU the bucket route is the plain version: the lists are the
    insertion's, no bucket launch is counted, and a bad counter raises."""
    qp, cp, cbp, mask = _operands("ties", 5, 700, 8, 3, "bf16x3")
    before = dict(F.launches)
    got = F.fused_topk_partial(qp, cp, cbp, mask, 10, "bf16x3", 3, 4, 16,
                               bucket=True)
    want = F.fused_topk_partial(qp, cp, cbp, mask, 10, "bf16x3", 3, 4, 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert F.launches["fused_topk_partial_bucket"] == before[
        "fused_topk_partial_bucket"]
    with pytest.raises(ValueError, match="bucket_count"):
        F.fused_topk_partial(qp, cp, cbp, mask, 10, "bf16x3", 3, 4, 16,
                             bucket=True,
                             bucket_count=torch.zeros(3, dtype=torch.int32))
    sv, si = F.fused_select(qp, cp, cbp, mask, 10, "bf16x3",
                            selection="bucket")
    assert torch.equal(si, F.fused_select(qp, cp, cbp, mask, 10,
                                          "bf16x3")[1])


# ---------------------------------------------------------------------------
# The port against the JAX package's selection="bucket".
# ---------------------------------------------------------------------------


def _data(m, n, dim, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, dim)).astype(np.float32),
            r.standard_normal((n, dim)).astype(np.float32))


@pytest.mark.parametrize("metric,k", [("cosine", 1), ("dot", 10),
                                      ("euclidean", 16)])
def test_fused_topk_matches_jax_bucket(metric, k):
    q, c = _data(20, 900, 40, seed=k + 7)
    pv, pi = F.fused_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                          metric, config=SearchConfig(selection="bucket"))
    jv, ji = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, metric,
                           config=JConfig(block_n=256, precision="bf16x3",
                                          selection="bucket"),
                           interpret=True)
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv))


@pytest.mark.parametrize("metric,k", [("cosine", 10), ("euclidean", 5)])
def test_probed_matches_jax_bucket(metric, k):
    """Tile lists of fewer than 16 tiles, where the JAX package's "auto"
    picks its bucket selection too."""
    q, c = _data(20, 1000, 32, seed=k + 11)
    jcfg = JConfig(block_q=8, block_n=128, selection="bucket")
    pcfg = SearchConfig(block_q=8, block_n=128, selection="bucket")
    tn = JF.corpus_tile_rows(q.shape[1], jcfg, k)
    tm = JF.query_tile_rows(q.shape[0], q.shape[1], jcfg, k)
    jcp, jcbp = JF.prepare_corpus(jnp.asarray(c), metric, tn=tn,
                                  precision="bf16x3")
    cp, cbp = F.prepared_from_jax(np.asarray(jcp), np.asarray(jcbp),
                                  c.shape[0], c.shape[1])
    n_layout = -(-1000 // tn)
    r = np.random.default_rng(k)
    tiles = np.stack([np.sort(r.choice(n_layout, 3, replace=False))
                      for _ in range(-(-20 // tm))]).astype(np.int32)
    jv, ji = JF.fused_topk_prepared(jnp.asarray(q), jcp, jcbp, k, metric,
                                    tn=tn, config=jcfg, interpret=True,
                                    tiles=jnp.asarray(tiles))
    pv, pi = F.fused_topk_prepared(torch.from_numpy(q), cp, cbp, k, metric,
                                   config=pcfg, precision="bf16x3",
                                   tiles=tiles, tn=tn)
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv))
